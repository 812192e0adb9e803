"""Host spans the benchmark takes around calls into the port's layers.

With ``--trace 1`` the harness wraps two calls, process-wide, for the
window: ``Explorer.explore`` (a sweep: the explorer and the replay
protocol, with everything under them) and ``torchsim._scan_cohorts``
(the torch engine's step loop: staging, the graph replays, the copy-out;
the cut ``chip_smoke.py``'s ``[graph sweep]`` lines make).  Each span is
``(start, end)`` in ``time.time_ns()``, the clock the profiler's events
are converted to, so that a device gap can be matched to what the host
was doing.

It also gates ``StepRunner.run`` (a slice of the step loop: staging, the
CUDA graph replays, the copy-out) so that the device profiler is started
and stopped only while no thread is inside one: stopping the profiler
while another thread replays a CUDA graph can deadlock the two.  On the
card, each ``StepRunner.run`` is bracketed by two CUDA events on the
current stream, the stream its copies and replays run on: the device's
own clock of the time the slice held it (:meth:`Spans.device_seconds`),
taken without the profiler, whose callbacks slow the host's launches.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Tuple


class Spans:
    def __init__(self, device: str = "cpu") -> None:
        self.lock = threading.Lock()
        self.spans: Dict[str, List[Tuple[int, int]]] = {
            "explore": [], "step_loop": []}
        self.device = device
        self.events: List[Tuple[object, object]] = []
        self.gate = threading.Lock()
        self._undo = []

    def _wrap(self, owner, attr: str, label: str) -> None:
        inner = getattr(owner, attr)
        spans = self.spans[label]

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return inner(*args, **kwargs)
            finally:
                t1 = time.time_ns()
                with self.lock:
                    spans.append((t0, t1))

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, inner))

    def _gate(self, owner, attr: str) -> None:
        inner = getattr(owner, attr)

        on_card = self.device == "cuda"

        @functools.wraps(inner)
        def gated(*args, **kwargs):
            with self.gate:
                if not on_card:
                    return inner(*args, **kwargs)
                import torch
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                try:
                    return inner(*args, **kwargs)
                finally:
                    t1.record()
                    with self.lock:
                        self.events.append((t0, t1))

        setattr(owner, attr, gated)
        self._undo.append((owner, attr, inner))

    def install(self) -> "Spans":
        from repro_torch.core import torchsim
        from repro_torch.core.explore import Explorer
        self._wrap(Explorer, "explore", "explore")
        self._wrap(torchsim, "_scan_cohorts", "step_loop")
        self._gate(torchsim.StepRunner, "run")
        return self

    def remove(self) -> None:
        while self._undo:
            owner, attr, inner = self._undo.pop()
            setattr(owner, attr, inner)

    def snapshot(self) -> "Spans":
        """A copy of the spans taken so far (the window's), which later
        spans do not change."""
        out = Spans(self.device)
        with self.lock:
            out.spans = {k: list(v) for k, v in self.spans.items()}
            out.events = list(self.events)
        return out

    def device_seconds(self):
        """The seconds between each ``StepRunner.run``'s two events,
        summed (the device's clock; the events must have completed), or
        None where none was recorded."""
        with self.lock:
            pairs = list(self.events)
        if not pairs:
            return None
        return sum(a.elapsed_time(b) for a, b in pairs) * 1e-3

    def seconds(self, label: str) -> float:
        with self.lock:
            return sum(b - a for a, b in self.spans[label]) * 1e-9

    def label_at(self, t_ns: int) -> str:
        """What the host was doing at ``t_ns``: in the step loop, in a
        sweep outside it, or outside any sweep."""
        with self.lock:
            if any(a <= t_ns < b for a, b in self.spans["step_loop"]):
                return "step_loop"
            if any(a <= t_ns < b for a, b in self.spans["explore"]):
                return "explore_outside_step_loop"
        return "outside_sweeps"
