"""The device trace of a run: ``torch.profiler`` over a slice of the
window, reduced to what the metrics read.

Only the device's activity is recorded (CUPTI sees the kernels inside
replayed CUDA graphs, whatever thread launched them).  The reduction
keeps: the union of the device's busy intervals, each operation's count
and seconds by name, and the gaps between busy intervals, each labelled
by what the host was doing (:meth:`portbench.spans.Spans.label_at`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

#: Operation names are cut to this many characters (templated kernels'
#: names run to thousands).
NAME_CHARS = 120


def start():
    """A profiler recording the device, started now."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof, time.time_ns(), time.perf_counter()


def warm() -> None:
    """Start and stop the profiler once on a trivial kernel: the first
    start in a process initialises CUPTI, which takes seconds (about 10 on
    an H100 host), so set-up pays it and not the traced slice."""
    import torch
    prof, _, _ = start()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.stop()


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every device operation."""
    from torch.autograd import DeviceType
    out = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        for e in results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    return out


def stop(handle):
    """Stop the profiler of :func:`start` (it waits for the device
    first); returns what :func:`reduce` takes."""
    prof, t0_ns, _ = handle
    t1_ns = time.time_ns()
    prof.stop()
    return prof, t0_ns, t1_ns


def reduce(prof, t0_ns: int, t1_ns: int) -> Optional[Dict]:
    """The trace reduced to the slice ``[t0_ns, t1_ns]``; None when it
    recorded no device operation.  ``gaps`` are the ten longest idle
    gaps, ``(start_ns, end_ns)``, for :func:`label_gaps`."""
    # the slice is [start returned, stop called]; stopping drains the
    # device and the profiler's buffers, which takes seconds and is not
    # part of it
    raw = _device_events(prof)
    events = [(n, max(s, t0_ns), min(e, t1_ns))
              for n, s, e in raw if e > t0_ns and s < t1_ns]
    if not events:
        return None
    # the profiler's buffers hold a bounded number of records (on an H100
    # host, some 0.5 s of the step loop's kernels): a trace that stops
    # short of the slice's end shows it
    last_end = max(e for _, _, e in raw)
    window_s = (t1_ns - t0_ns) * 1e-9
    events.sort(key=lambda e: e[1])
    by_name: Dict[str, List[float]] = {}
    for name, s, e in events:
        row = by_name.setdefault(name[:NAME_CHARS], [0, 0.0])
        row[0] += 1
        row[1] += (e - s) * 1e-9
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s, cur_e = events[0][1], events[0][2]
    for _, s, e in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    busy += cur_e - cur_s
    # the events are clipped to the host's slice by time.time_ns(), the
    # clock the profiler converts its events to: its trace starts within
    # the start call
    start_ns = getattr(getattr(prof.profiler, "kineto_results", None),
                       "trace_start_ns", lambda: t0_ns)()
    aligned = abs(start_ns - t0_ns) < 10**9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"window_s": window_s, "busy_s": busy * 1e-9,
            "events": len(events), "aligned": aligned,
            "covered_s": (min(last_end, t1_ns) - t0_ns) * 1e-9,
            "ops": {k: (v[0], v[1]) for k, v in by_name.items()},
            "gaps": longest}


def label_gaps(dev: Dict, spans) -> List[List]:
    """``[what the host was doing, seconds]`` of each of ``dev``'s gaps,
    once every span of the window is complete."""
    return [[spans.label_at((a + b) // 2) if dev["aligned"]
             else "host_unknown", (b - a) * 1e-9] for a, b in dev["gaps"]]
