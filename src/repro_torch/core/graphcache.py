"""Compile cache of the port: captured CUDA graphs per shape signature.

The port of ``repro/core/xlacache.py``.  The JAX package never runs its
step loop one operation at a time: it compiles the whole scan into one XLA
executable per shape signature and keeps the executables in a two-tier
cache.  The port's counterpart of a compiled executable is a *runner*: on
the card, a captured ``torch.cuda.CUDAGraph`` with its static buffers, so
that one host call replays a fixed sequence of kernels; on the CPU, the
same object running its eager body, so that the cache's behaviour is
tested there.  :class:`CompileCache` holds runners under their signature
with the reference's interface (``get``, ``put``, ``load_or_compile``,
``as_dict``) and counters (``mem_hits``, ``disk_hits``, ``compiles``,
``failures``).

**What the disk tier holds.**  A CUDA graph does not outlive its process,
so nothing of a runner can be serialized.  The disk tier persists what
can be: the kernel libraries a runner needs, in :mod:`repro_torch.kernels.
build`'s store under ``<DiskCache root>/kernels`` (the counterpart of a
serialized executable), and per signature an entry naming them.  A later
process whose memory tier misses finds the entry and its libraries,
captures afresh without running ``nvcc``, and counts a disk hit; only a
signature never seen counts a compile.

Safety properties, as the reference's:

* **Environment-keyed.**  Keys embed torch's version and CUDA version
  beside the caller's signature, and the libraries' own names embed the
  toolkit and the card (:func:`repro_torch.kernels.build.environment`):
  another installation misses and builds, never loads a stale library.
* **Corruption-checked.**  Entries ride the DiskCache digest check; an
  entry of another shape is a plain miss; one whose libraries are missing
  from the store is counted in ``failures`` and degrades to a compile,
  never to a crash.  A stored library that fails to load or bind is built
  anew by the store itself (``build.REBUILDS``).
* **Two-tier.**  The memory tier (LRU, :data:`MEM_CAP`) serves repeat
  lookups in-process; ``disk=None`` keeps it alone.

:func:`capture` is the one way the port captures a graph: warm-up runs on
a side stream first (so that nothing builds, binds or allocates a library
handle during capture), then the capture, in ``thread_local`` error mode
so that other threads may use the card meanwhile.  A capture or replay
that fails is a :class:`repro_torch.DeviceError`: it never falls back to
the eager loop.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from .. import DeviceError
from ..kernels import build as kbuild
from ..testing import faults
from .diskcache import DiskCache

#: Runners kept per cache (LRU).  A runner holds a graph of a few thousand
#: nodes and buffers of a slice's state; a sweep touches a handful of
#: signatures, so this is a backstop against shape churn, not a tuning
#: knob.
MEM_CAP = 64


class CompileCache:
    """Two-tier (memory + :class:`DiskCache`) store of runners.

    ``get``/``put`` speak runners; what reaches the disk is the list of
    kernel libraries a runner names in its ``libraries`` attribute
    (``(source, defines)`` pairs).  Counters: ``mem_hits`` / ``disk_hits``
    (where lookups were served), ``compiles`` (misses that had to capture
    with nothing on disk — the number a warm store drives to zero),
    ``failures`` (disk entries whose libraries the store could not serve;
    each one degrades to a compile).  ``captures``, ``capture_s`` and
    ``replays`` count the CUDA graphs its runners captured and replayed
    (0 on the CPU, where runners run their eager body)."""

    def __init__(self, disk: Optional[DiskCache] = None):
        self.disk = disk
        self._mem: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._building: Dict[str, threading.Lock] = {}
        self.mem_hits = 0
        self.disk_hits = 0
        self.compiles = 0
        self.failures = 0
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    # ------------------------------------------------------------------
    @property
    def kernel_store(self) -> Optional[Path]:
        """The kernel library store of this cache's disk tier, or None
        (the default store, ``build.BUILD_DIR``)."""
        return None if self.disk is None else Path(self.disk.root) / "kernels"

    @staticmethod
    def _env() -> list:
        """Everything a runner's entry is only valid for."""
        return [torch.__version__, str(torch.version.cuda)]

    def _key_text(self, signature: Any) -> str:
        """The ``graph`` DiskCache namespace key."""
        return json.dumps(["graph", 1, *self._env(), repr(signature)])

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return {"mem_hits": self.mem_hits, "disk_hits": self.disk_hits,
                    "compiles": self.compiles, "failures": self.failures,
                    "captures": self.captures, "capture_s": self.capture_s,
                    "replays": self.replays}

    def note_capture(self, seconds: float) -> None:
        with self._lock:
            self.captures += 1
            self.capture_s += seconds

    def note_replays(self, n: int) -> None:
        with self._lock:
            self.replays += n

    # ------------------------------------------------------------------
    def get(self, signature: Any) -> Optional[Any]:
        """The runner for ``signature`` in memory, or ``None`` on miss."""
        text = self._key_text(signature)
        with self._lock:
            runner = self._mem.get(text)
            if runner is not None:
                self._mem.move_to_end(text)
                self.mem_hits += 1
            return runner

    def put(self, signature: Any, runner: Any) -> None:
        """Store a freshly built runner in memory and name its libraries
        on disk."""
        text = self._key_text(signature)
        with self._lock:
            self.compiles += 1
            self._remember(text, runner)
        if self.disk is not None:
            libs = [[src, dict(defs) if defs else None]
                    for src, defs in getattr(runner, "libraries", ())]
            self.disk.put(text, ("graph-runner", 1, libs))

    def _on_disk(self, text: str) -> bool:
        """The disk names this signature and the store holds every
        library it lists (so a capture needs no ``nvcc``).  An entry of
        another shape is a plain miss; one whose libraries are missing is
        counted in ``failures``."""
        if self.disk is None:
            return False
        got = self.disk.get(text)
        if not (isinstance(got, tuple) and len(got) == 3
                and got[0] == "graph-runner" and got[1] == 1
                and isinstance(got[2], list)):
            return False
        try:
            ok = all(kbuild.library_path(src, defs, self.kernel_store)
                     .exists() for src, defs in got[2])
        except (DeviceError, TypeError, ValueError):
            ok = False
        if not ok:
            with self._lock:
                self.failures += 1
        return ok

    def load_or_compile(self, signature: Any,
                        build: Callable[[], Any]) -> Any:
        """``get``, or else ``build()`` and store it — the one-call form
        the engines use.  ``build`` makes the runner (loading its kernel
        libraries from :attr:`kernel_store`, capturing its graph).
        Concurrent misses on one signature build it once."""
        if faults.fire("fail_compile"):
            # ahead of the memory tier, so that a warm cache cannot mask
            # the injected failure; the Explorer demotes on it
            raise faults.InjectedFault("injected fault: fail_compile")
        runner = self.get(signature)
        if runner is not None:
            return runner
        text = self._key_text(signature)
        with self._lock:
            lock = self._building.setdefault(text, threading.Lock())
        with lock:
            with self._lock:
                runner = self._mem.get(text)
                if runner is not None:
                    self._mem.move_to_end(text)
                    self.mem_hits += 1
                    return runner
            warm = self._on_disk(text)
            runner = build()
            if warm:
                with self._lock:
                    self.disk_hits += 1
                    self._remember(text, runner)
            else:
                self.put(signature, runner)
        return runner

    def _remember(self, text: str, runner: Any) -> None:
        # caller holds the lock
        self._mem[text] = runner
        self._mem.move_to_end(text)
        while len(self._mem) > MEM_CAP:
            self._mem.popitem(last=False)


def capture(body: Callable[[], None], cache: Optional[CompileCache] = None
            ) -> "torch.cuda.CUDAGraph":
    """``body`` captured into a CUDA graph on the current card.

    ``body`` runs once on a side stream first: that first call builds and
    binds every kernel library, creates library handles and fills the
    allocator, none of which may happen during capture.  ``body`` must
    leave only buffers that its caller overwrites before the first
    replay.  The capture runs in ``thread_local`` error mode (other
    threads may use the card meanwhile) on a stream of its own, so kernels
    launched by ``ctypes`` on the current raw stream land in the graph.  A
    failure of the capture is a :class:`DeviceError`; the warm-up's own
    errors pass as they are."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"):
            body()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        raise DeviceError(f"CUDA graph capture failed: {exc}") from exc
    if cache is not None:
        cache.note_capture(time.perf_counter() - t0)
    return graph


def replay(graph: "torch.cuda.CUDAGraph") -> None:
    """One replay of ``graph`` on the current stream; a failure is a
    :class:`DeviceError`."""
    try:
        graph.replay()
    except RuntimeError as exc:
        raise DeviceError(f"CUDA graph replay failed: {exc}") from exc
