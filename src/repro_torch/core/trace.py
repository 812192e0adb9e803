"""Instrumented sequential execution → task trace (the toolchain's step 1).

The paper's source-to-source compiler turns an OmpSs program into a
*sequential instrumented* binary whose single run emits, per task instance:
task name, creation time, elapsed CPU time, and each dependence
(address + direction).  Here the ``@task`` decorator plays that role for
Python/JAX kernels: outside a :class:`Tracer` context it simply calls the
function; inside one, it records a :class:`TraceEvent` (measuring real wall
time of the sequential execution — the "CPU cycles" of the paper) and still
executes the body, so tracing a program also validates its numerics.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .regions import Access, Direction, Region, region_of

# ----------------------------------------------------------------------------
# Trace records
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class TraceEvent:
    """One task instance observed during the instrumented sequential run."""

    index: int                    # creation order
    name: str                     # kernel name (groups instances)
    created_at: float             # seconds since trace start
    elapsed_smp: float            # measured sequential execution seconds
    accesses: List[Tuple[Any, str, int]]  # (region key, direction, nbytes)
    devices: Tuple[str, ...]      # programmer annotation, e.g. ("smp","fpga")
    flops: float = 0.0            # task work, from the @task 'work' model
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["accesses"] = [[_jsonable_key(k), dirn, n] for (k, dirn, n) in self.accesses]
        d["devices"] = list(self.devices)
        return json.dumps(d)

    @staticmethod
    def from_json(line: str) -> "TraceEvent":
        d = json.loads(line)
        d["accesses"] = [(_unjsonable_key(k), dirn, n) for (k, dirn, n) in d["accesses"]]
        d["devices"] = tuple(d["devices"])
        return TraceEvent(**d)


def _jsonable_key(key: Any) -> Any:
    if isinstance(key, tuple):
        return ["__tuple__", *[_jsonable_key(k) for k in key]]
    return key


def _unjsonable_key(key: Any) -> Any:
    if isinstance(key, list) and key and key[0] == "__tuple__":
        return tuple(_unjsonable_key(k) for k in key[1:])
    return key


@dataclasses.dataclass
class Trace:
    """A whole instrumented run: ordered task events + wall-time metadata."""

    events: List[TraceEvent] = dataclasses.field(default_factory=list)
    wall_seconds: float = 0.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    def names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.name)
        return list(seen)

    def mean_smp_cost(self) -> Dict[str, float]:
        """Per-kernel mean measured SMP seconds (the estimator's CPU cost)."""
        tot: Dict[str, float] = {}
        cnt: Dict[str, int] = {}
        for e in self.events:
            tot[e.name] = tot.get(e.name, 0.0) + e.elapsed_smp
            cnt[e.name] = cnt.get(e.name, 0) + 1
        return {k: tot[k] / cnt[k] for k in tot}

    # -------------------------------------------------------------- JSONL IO
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"wall_seconds": self.wall_seconds, "meta": self.meta}) + "\n")
            for e in self.events:
                f.write(e.to_json() + "\n")

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            header = json.loads(f.readline())
            events = [TraceEvent.from_json(line) for line in f if line.strip()]
        return Trace(events=events, wall_seconds=header["wall_seconds"],
                     meta=header.get("meta", {}))


# ----------------------------------------------------------------------------
# The @task decorator + Tracer (instrumented sequential execution)
# ----------------------------------------------------------------------------

_ACTIVE_TRACER: Optional["Tracer"] = None


@dataclasses.dataclass
class TaskSpec:
    """Static annotation of a kernel — the OmpSs pragma equivalent."""

    name: str
    devices: Tuple[str, ...]
    ins: Sequence[str]
    outs: Sequence[str]
    inouts: Sequence[str]
    fn: Callable[..., Any]
    work: Optional[Callable[..., float]] = None   # args -> FLOPs


class task:  # noqa: N801 — decorator, lowercase like the pragma
    """``#pragma omp task in(...) inout(...)`` + ``target device(...)``.

    Parameters name the *function arguments* that carry each dependence;
    sizes are taken from the argument arrays.  Example::

        @task(devices=("fpga", "smp"), ins=("A", "B"), inouts=("C",))
        def mxm_block(A, B, C):
            C += A @ B
    """

    def __init__(self, devices: Sequence[str] = ("smp",), ins: Sequence[str] = (),
                 outs: Sequence[str] = (), inouts: Sequence[str] = (),
                 name: Optional[str] = None,
                 work: Optional[Callable[..., float]] = None):
        self.devices = tuple(devices)
        self.ins, self.outs, self.inouts = tuple(ins), tuple(outs), tuple(inouts)
        self.name = name
        self.work = work

    def __call__(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        spec = TaskSpec(self.name or fn.__name__, self.devices,
                        self.ins, self.outs, self.inouts, fn, self.work)

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            tracer = _ACTIVE_TRACER
            if tracer is None:
                return fn(*args, **kwargs)
            return tracer.record_call(spec, args, kwargs)

        wrapper.task_spec = spec  # type: ignore[attr-defined]
        return wrapper


class Tracer:
    """Context manager: run the (sequential) program and collect its trace."""

    def __init__(self, time_fn: Callable[[], float] = time.perf_counter,
                 synchronize: Optional[Callable[[Any], Any]] = None):
        self.trace = Trace()
        self._time = time_fn
        self._t0 = 0.0
        self._sync = synchronize or _default_sync

    def __enter__(self) -> "Tracer":
        global _ACTIVE_TRACER
        if _ACTIVE_TRACER is not None:
            raise RuntimeError("nested Tracer contexts are not supported")
        _ACTIVE_TRACER = self
        self._t0 = self._time()
        return self

    def __exit__(self, *exc: Any) -> None:
        global _ACTIVE_TRACER
        _ACTIVE_TRACER = None
        self.trace.wall_seconds = self._time() - self._t0

    # ------------------------------------------------------------------
    def record_call(self, spec: TaskSpec, args: Tuple[Any, ...],
                    kwargs: Dict[str, Any]) -> Any:
        import inspect
        bound = inspect.signature(spec.fn).bind(*args, **kwargs)
        bound.apply_defaults()
        accesses: List[Tuple[Any, str, int]] = []
        for names, dirn in ((spec.ins, "in"), (spec.outs, "out"), (spec.inouts, "inout")):
            for argname in names:
                if argname not in bound.arguments:
                    raise KeyError(f"task {spec.name}: no argument named {argname!r}")
                region = region_of(bound.arguments[argname])
                accesses.append((region.key, dirn, region.nbytes))
        created = self._time() - self._t0
        t1 = self._time()
        result = spec.fn(*args, **kwargs)
        self._sync(result)
        elapsed = self._time() - t1
        flops = float(spec.work(**bound.arguments)) if spec.work else 0.0
        self.trace.events.append(TraceEvent(
            index=len(self.trace.events), name=spec.name, created_at=created,
            elapsed_smp=elapsed, accesses=accesses, devices=spec.devices,
            flops=flops))
        return result


def _default_sync(result: Any) -> None:
    """Block on async JAX results so measured time covers the compute."""
    try:
        if hasattr(result, "block_until_ready"):
            result.block_until_ready()
    except Exception:
        pass


def accesses_of(event: TraceEvent) -> Tuple[Access, ...]:
    return tuple(Access(Region(k, n), Direction(dirn)) for (k, dirn, n) in event.accesses)
