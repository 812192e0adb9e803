"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on first
use into its own shared library in a *store*: ``build/repro_torch_kernels/``
at the root of the checkout, or the directory a caller names (the
Explorer's ``cache_dir`` gives ``<cache_dir>/kernels``).  The store keeps
the reference compile cache's safety properties
(``repro/core/xlacache.py``):

* **Environment-keyed.**  A library is named by the hash of its source,
  :data:`NVCC_FLAGS` and ``-D`` defines *and* of :func:`environment` —
  torch's version and CUDA version, ``nvcc --version``'s release line and
  the card's compute capability — so an edited source, another toolkit or
  another card never loads a stale library; it misses and builds.
* **Corruption-checked.**  A stored library that fails to ``dlopen`` or
  fails its wrapper's bind check (``load(..., bind=)``: entry points and
  packed-argument sizes) is counted in :data:`REBUILDS`, removed and built
  once more; a second failure raises :class:`repro_torch.DeviceError`.

The compiler's ``-Xptxas -v`` report (each kernel's registers, shared
memory and spills) is kept beside the library.  Different sources build
concurrently: each has its own lock.  A process loads each library once
(the first store it is asked for wins) and copies it into any other store
it is asked for, so each store serves later processes on its own.

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
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

from .. import DeviceError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FRESH_DIR = BUILD_DIR / "fresh"

#: Hopper only: keep the ``a`` so later kernels may use wgmma / setmaxnreg.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Defines = Optional[Mapping[str, int]]
Bind = Optional[Callable[[ctypes.CDLL], ctypes.CDLL]]

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

#: ``nvcc`` runs of this process (:func:`load` and :func:`fresh`): a warm
#: store keeps it at 0.
BUILDS = 0

#: Stored libraries that failed to load or bind and were built anew.
REBUILDS = 0

#: Makes each update of ``BUILDS`` and ``REBUILDS`` one step for threads
#: that build at once.
_COUNT_LOCK = threading.Lock()

_ENV: Optional[Tuple[str, ...]] = None
_ENV_LOCK = threading.Lock()


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


def environment() -> Tuple[str, ...]:
    """What a built library is valid for, part of its name: torch's
    version and CUDA version, ``nvcc --version``'s release line and the
    current card's compute capability.  Read once per process."""
    global _ENV
    with _ENV_LOCK:
        if _ENV is None:
            import torch
            try:
                proc = subprocess.run([nvcc_path(), "--version"],
                                      capture_output=True, text=True,
                                      timeout=60)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise DeviceError(f"nvcc --version failed: {exc!r}") \
                    from exc
            release = next((line.strip() for line in proc.stdout.splitlines()
                            if "release" in line), proc.stdout.strip())
            if not torch.cuda.is_available():
                raise DeviceError("no CUDA device: a kernel library has "
                                  "no compute capability to be built for")
            major, minor = torch.cuda.get_device_capability()
            _ENV = (torch.__version__, str(torch.version.cuda), release,
                    f"sm_{major}{minor}")
        return _ENV


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
    global BUILDS
    with _COUNT_LOCK:
        BUILDS += 1
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


def _open(path: Path, bind: Bind) -> ctypes.CDLL:
    """``path`` loaded and put through ``bind``; DeviceError if either
    fails."""
    lib = _cdll(path)
    return lib if bind is None else bind(lib)


def library_path(source: str, defines: Defines = None,
                 store: Optional[Path] = None) -> Path:
    """Where the library of ``csrc/<source>`` with ``defines`` lies in
    ``store`` (default :data:`BUILD_DIR`): named by the hash of the
    source, the flags and :func:`environment`."""
    src = CSRC / source
    try:
        text = src.read_bytes()
    except OSError as exc:
        raise DeviceError(f"kernel source {src} is unreadable: {exc}") \
            from exc
    digest = hashlib.sha256(text + repr(
        (NVCC_FLAGS, define_flags(defines), environment())).encode())
    root = BUILD_DIR if store is None else Path(store)
    return root / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _keep_copy(key: str, out: Path) -> None:
    """Copy the loaded library of ``key`` to ``out`` when that store
    lacks it (atomically: concurrent copies agree)."""
    if out.exists():
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{next(_FRESH_IDS)}.tmp.so")
    shutil.copyfile(BUILD_INFO[key]["path"], tmp)
    os.replace(tmp, out)


def load(source: str, defines: Defines = None, *, bind: Bind = None,
         store: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` built with ``defines``,
    put through ``bind`` (the wrapper's entry-point declarations and
    checks), from ``store`` (default :data:`BUILD_DIR`), building it if
    needed.  A stored library that fails to load or bind is counted in
    :data:`REBUILDS`, removed and built once more."""
    global REBUILDS
    key = label(source, defines)
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LIBS.get(key)
        if lib is not None:
            if store is not None:
                _keep_copy(key, library_path(source, defines, store))
            return lib if bind is None else bind(lib)
        out = library_path(source, defines, store)
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if out.exists():
            try:
                lib = _open(out, bind)
            except DeviceError:
                with _COUNT_LOCK:
                    REBUILDS += 1
                out.unlink(missing_ok=True)
        if lib is None:
            out.parent.mkdir(parents=True, exist_ok=True)
            # a path of its own: the dynamic loader would hand back a
            # library it has loaded from ``out`` before the rebuild
            tmp = out.with_suffix(f".{os.getpid()}.{next(_FRESH_IDS)}"
                                  f".tmp.so")
            seconds, log = _compile(CSRC / source, tmp, defines)
            log_path.write_text(log)
            try:
                lib = _open(tmp, bind)
            except DeviceError:
                tmp.unlink(missing_ok=True)
                raise
            os.replace(tmp, out)        # atomic: concurrent builds agree
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
