"""Spans inside the port, off unless a caller turns them on.

    from repro_torch import tracing
    tracing.enable()
    ...                                  # sweeps, on any thread
    records = tracing.snapshot()
    tracing.disable()

A record is ``(name, attrs, t0_ns, t1_ns, thread_id, parent)``.  Times
are ``time.time_ns()``, the clock ``torch.profiler`` converts its device
events to, so that a span and a kernel on the card can be laid side by
side.  ``parent`` is the index, in the same snapshot, of the span that
was innermost on the same thread when this one began, or -1.  A span
still open at the snapshot has ``t1_ns`` None.

Off (the default), :func:`span` returns one shared no-op object after a
single flag check: nothing is allocated and no clock is read.  On,
records are appended under a lock, since the sweep service runs sweeps
on several threads; nesting follows a per-thread stack.  Spans inside
the workers of a process pool are not collected.

The spans the port takes: ``sweep`` (``Explorer._explore``) with its
children ``sweep.prepare``, ``sweep.assemble``, ``sweep.schedules`` and
``sweep.save_orders``; ``graph.build``, each graph-cache miss of
``Explorer._graph_for`` (the disk tier, else the build), inside
``sweep.prepare``; ``replay.exact``, one lane's exact serial run,
with ``cause`` one of ``discover``, ``pinned``, ``small_group`` and
``fallback`` (the :class:`~repro_torch.core.replay.BatchStats` counter
that counts the lane; a run the pruning cutoff retired has none, but in
a small group, which ``small_group_lanes`` counts whole);
``step_loop`` (``torchsim._scan_cohorts``) with ``step.tables`` (one
own-order cohort's tables, staged on the host), ``step.stage``,
``step.run`` (its ``step.readback``) and ``step.classify``.  Every span
is the host's wall time: ``step.run`` includes the wait for the card,
not the card's busy time, which only a device trace gives.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

Record = Tuple[str, Dict, int, Optional[int], int, int]

_on = False
_lock = threading.Lock()
_records: List["_Span"] = []
_local = threading.local()


class _Noop:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "t0", "t1", "tid", "parent")

    def __init__(self, name: str, attrs: Dict) -> None:
        self.name, self.attrs = name, attrs
        self.t1: Optional[int] = None

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.tid = threading.get_ident()
        with _lock:
            _records.append(self)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.time_ns()
        _local.stack.pop()

    def set(self, **attrs) -> None:
        """Attributes known only once the span has begun (until the
        snapshot that takes the record)."""
        self.attrs.update(attrs)

    def record(self, index: Dict[int, int]) -> Record:
        parent = -1 if self.parent is None else index.get(id(self.parent),
                                                          -1)
        return (self.name, dict(self.attrs), self.t0, self.t1, self.tid,
                parent)


def span(name: str, **attrs):
    """A context manager timing its block as span ``name`` with
    ``attrs``; the no-op while off."""
    if not _on:
        return NOOP
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return traced
    return wrap


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def reset() -> None:
    """Forget every record."""
    with _lock:
        _records.clear()


def snapshot() -> List[Record]:
    """The records so far, in the order the spans began."""
    with _lock:
        spans = list(_records)
    index = {id(s): i for i, s in enumerate(spans)}
    return [s.record(index) for s in spans]
