"""The port's own spans in a traced run's record.

``repro_torch.tracing`` records spans inside the program (off unless
turned on): ``(name, attrs, t0_ns, t1_ns, thread_id, parent)``, in
``time.time_ns()``, the clock :mod:`portbench.devtrace` converts the
profiler's device events to.  A run's record carries the window's as
``run["spans"].program``.  Where it has none (a program without the
tracer, or spans that took none), every function here finds nothing and
the metrics that read them return None.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence


def records(run: Mapping) -> List:
    """The window's program records, or an empty list."""
    return list(getattr(run.get("spans"), "program", None) or ())


def seconds(recs: Sequence, name: str, **attrs) -> float:
    """The seconds of the closed spans ``name`` whose attributes hold
    ``attrs``."""
    return sum(t1 - t0 for n, a, t0, t1, *_ in recs
               if n == name and t1 is not None
               and all(a.get(k) == v for k, v in attrs.items())) * 1e-9


def share(run: Mapping, part: str, whole: str, **attrs) -> Optional[float]:
    """100 × the seconds of spans ``part`` (with ``attrs``) over those of
    spans ``whole``; None where there is no ``whole`` span."""
    recs = records(run)
    total = seconds(recs, whole)
    if total <= 0:
        return None
    return 100.0 * seconds(recs, part, **attrs) / total


def innermost_at(recs: Sequence, t_ns: int) -> Optional[str]:
    """The name of the innermost program span open at ``t_ns`` (the
    latest begun of those that cover it), or None."""
    best = None
    for n, _, t0, t1, *_ in recs:
        if t1 is not None and t0 <= t_ns < t1 \
                and (best is None or t0 >= best[1]):
            best = (n, t0)
    return best[0] if best else None
