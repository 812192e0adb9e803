"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on first
use into its own shared library under ``build/repro_torch_kernels/`` at the
root of the checkout, named by the hash of its source, so an edited source
never loads a stale library.  The compiler's ``-Xptxas -v`` report (each
kernel's registers, shared memory and spills) is kept beside the library.

Nothing here runs when a module is imported: a kernel is built by the
first wrapper call that launches it.  A build that fails raises
:class:`repro_torch.DeviceError`; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from .. import DeviceError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: Hopper only: keep the ``a`` so later kernels may use wgmma / setmaxnreg.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: Per source: ``{"seconds": build wall time (0.0 when the library was
#: already on disk), "ptxas": the compiler's resource report, "path": ...}``.
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``PATH``, or the
    toolkit's usual place."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise DeviceError("nvcc was not found (looked in $CUDA_HOME/bin, PATH "
                      "and /usr/local/cuda/bin); the CUDA kernels cannot "
                      "be built")


def _ptxas_lines(log: str) -> str:
    """The register/shared-memory/spill lines of an ``-Xptxas -v`` log."""
    return "\n".join(line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        src = CSRC / source
        try:
            text = src.read_bytes()
        except OSError as exc:
            raise DeviceError(f"kernel source {src} is unreadable: {exc}") \
                from exc
        digest = hashlib.sha256(text + repr(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise DeviceError(f"nvcc failed to run on {src.name}: "
                                  f"{exc!r}") from exc
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise DeviceError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)        # atomic: concurrent builds agree
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as exc:
            raise DeviceError(f"cannot load {out}: {exc}") from exc
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO[source] = {"seconds": seconds, "path": str(out),
                              "ptxas": _ptxas_lines(log)}
        _LIBS[source] = lib
        return lib
