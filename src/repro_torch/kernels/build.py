"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on first
use into its own shared library under ``build/repro_torch_kernels/`` at the
root of the checkout, named by the hash of its source and ``-D`` defines,
so an edited source never loads a stale library.  The compiler's
``-Xptxas -v`` report (each kernel's registers, shared memory and spills)
is kept beside the library.  Different sources build concurrently: each
has its own lock.

:func:`fresh` is the uncached counterpart: it compiles a source with its
defines into a new library under ``build/repro_torch_kernels/fresh/``
every time, and deletes the file when the caller is done — the
"hardware generation" step of the paper's traditional flow.

Nothing here runs when a module is imported: a kernel is built by the
first wrapper call that launches it.  A build that fails raises
:class:`repro_torch.DeviceError`; nothing falls back to another path.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

from .. import DeviceError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FRESH_DIR = BUILD_DIR / "fresh"

#: Hopper only: keep the ``a`` so later kernels may use wgmma / setmaxnreg.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Defines = Optional[Mapping[str, int]]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()

#: Held by every wrapper module's ``bind`` while it declares a library's
#: entry points and checks them, so that threads which load one library
#: at once bind it once: the first binds and marks it, the rest find it
#: marked.
BIND_LOCK = threading.Lock()
_FRESH_IDS = itertools.count()

#: Per :func:`label`: ``{"seconds": build wall time (0.0 when the library
#: was already on disk), "ptxas": the compiler's resource report, "path"}``.
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


def define_flags(defines: Defines) -> List[str]:
    """``-DNAME=value`` flags, sorted by name so equal sets hash equal."""
    return [f"-D{k}={int(v)}" for k, v in sorted((defines or {}).items())]


def label(source: str, defines: Defines = None) -> str:
    """``tiles.cu`` or ``tiles.cu[TILE=128]``: the key of a build."""
    flags = ",".join(f[2:] for f in define_flags(defines))
    return f"{source}[{flags}]" if flags else source


def _ptxas_lines(log: str) -> str:
    """The entry-function, register/shared-memory and spill lines of an
    ``-Xptxas -v`` log."""
    return "\n".join(line.strip() for line in log.splitlines()
                     if "entry function" in line or "registers" in line
                     or "spill" in line)


def _compile(src: Path, out: Path, defines: Defines) -> Tuple[float, str]:
    """Run ``nvcc`` into ``out``; returns (seconds, compiler log)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS,
                               *define_flags(defines), "-o", str(out),
                               str(src)],
                              capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise DeviceError(f"nvcc failed to run on {src.name}: {exc!r}") \
            from exc
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        out.unlink(missing_ok=True)
        raise DeviceError(f"nvcc failed on {src.name} "
                          f"{define_flags(defines)} (exit {proc.returncode}):"
                          f"\n{proc.stdout}{proc.stderr}")
    return seconds, proc.stdout + proc.stderr


def _cdll(path: Path) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise DeviceError(f"cannot load {path}: {exc}") from exc


def load(source: str, defines: Defines = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` built with ``defines``,
    building it if needed."""
    key = label(source, defines)
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        src = CSRC / source
        try:
            text = src.read_bytes()
        except OSError as exc:
            raise DeviceError(f"kernel source {src} is unreadable: {exc}") \
                from exc
        digest = hashlib.sha256(
            text + repr((NVCC_FLAGS, define_flags(defines))).encode())
        out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            seconds, log = _compile(src, tmp, defines)
            log_path.write_text(log)
            os.replace(tmp, out)        # atomic: concurrent builds agree
        lib = _cdll(out)
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO[key] = {"seconds": seconds, "path": str(out),
                           "ptxas": _ptxas_lines(log)}
        _LIBS[key] = lib
        return lib


@dataclasses.dataclass
class FreshBuild:
    """One uncached build: the loaded library and its ``-Xptxas -v``
    report."""

    lib: ctypes.CDLL
    ptxas: str


@contextlib.contextmanager
def fresh(source: str, defines: Defines = None) -> Iterator[FreshBuild]:
    """Compile ``csrc/<source>`` with ``defines`` into a new library, never
    reusing an earlier build, and delete the file on exit.

    Each build gets a path of its own: the dynamic loader hands back an
    already loaded library for a path it has seen, which would skip the
    new build.  The loaded code stays mapped after the file is deleted,
    so the library is not unloaded."""
    src = CSRC / source
    FRESH_DIR.mkdir(parents=True, exist_ok=True)
    tag = "".join(f"-{f[2:].replace('=', '')}" for f in define_flags(defines))
    out = FRESH_DIR / f"{src.stem}-{os.getpid()}-{next(_FRESH_IDS)}{tag}.so"
    try:
        _, log = _compile(src, out, defines)
        yield FreshBuild(_cdll(out), _ptxas_lines(log))
    finally:
        out.unlink(missing_ok=True)
