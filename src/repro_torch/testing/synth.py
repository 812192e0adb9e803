"""Deterministic synthetic workloads for tests, docs and smoke runs.

One canonical place for the tiny trace / report / candidate fixtures the
engine test-suites (``tests/test_batchsim.py``, ``tests/test_torch_torchsim.py``)
and the README quickstart doctest share, so every consumer exercises the
same shapes: a single-kernel trace with a rolling region-reuse dependence
pattern, an HLS-analogue report for one accelerator kind, and a
slot-count × ±SMP candidate ramp (the CEDR-style grid the candidate-axis
engines group into one `FrozenGraph` family per eligibility).

Everything here is pure and deterministic — no randomness, no wall-clock —
so doctests can pin exact outputs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from repro_torch.core.augment import Eligibility, build_graph
from repro_torch.core.devices import zynq_system
from repro_torch.core.explore import Candidate
from repro_torch.core.fastsim import FrozenGraph
from repro_torch.core.hlsreport import KernelReport
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.core.trace import Trace, TraceEvent

#: The synthetic accelerator kind every helper here wires up.
KIND = "fpga:k"
KERNEL = "k"


def synth_report(kernel: str = KERNEL, kind: str = KIND) -> KernelReport:
    """An HLS-analogue cost report for one accelerated kernel."""
    return KernelReport(
        kernel=kernel, device_kind=kind, compute_s=1e-4,
        dma_in_s=1e-5, dma_out_s=2e-5,
        resources={"dsp": 100.0, "bram_kb": 10.0, "lut": 1000.0})


def synth_reports(kernel: str = KERNEL, kind: str = KIND
                  ) -> Dict[Tuple[str, str], KernelReport]:
    """The ``ReportMap`` holding :func:`synth_report`."""
    rep = synth_report(kernel, kind)
    return {(kernel, kind): rep}


def synth_trace(n: int = 24, n_regions: int = 4) -> Trace:
    """``n`` events of one kernel over ``n_regions`` rolling inout regions
    — consecutive events reusing a region become dependence chains, so the
    graph has both parallel width and serial depth."""
    events = [TraceEvent(index=i, name=KERNEL, created_at=i * 1e-6,
                         elapsed_smp=1e-3 * (1 + (i % 3)),
                         accesses=[((i % n_regions,), "inout", 1024)],
                         devices=("fpga", "smp"))
              for i in range(n)]
    return Trace(events=events, wall_seconds=1.0)


def synth_candidates(accs: Iterable[int],
                     rep: KernelReport = None) -> List[Candidate]:
    """The slot-count × ±SMP ramp: one candidate per (n_acc, smp) pair.

    With ``rep`` supplied the candidates carry a fabric payload (so the
    feasibility filter sees them); without it the sweep benchmarks the
    evaluation engines only.
    """
    out: List[Candidate] = []
    for n_acc in accs:
        for smp in (False, True):
            name = f"{n_acc}acc" + ("+smp" if smp else "")
            kinds = (KIND, "smp") if smp else (KIND,)
            out.append(Candidate(
                name=name, system=zynq_system(name, {KIND: n_acc}),
                eligibility=Eligibility({KERNEL: kinds}),
                fabric=[(rep, n_acc)] if rep is not None else ()))
    return out


def frozen_for(trace: Trace, smp: bool) -> Tuple[FrozenGraph, TaskGraph]:
    """One augmented graph of ``trace`` (±SMP eligibility), frozen."""
    kinds = (KIND, "smp") if smp else (KIND,)
    graph = build_graph(trace, zynq_system("g", {KIND: 1}), synth_reports(),
                        Eligibility({KERNEL: kinds}), smp_cost="mean")
    return FrozenGraph.freeze(graph), graph
