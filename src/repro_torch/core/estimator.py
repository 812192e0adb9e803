"""The coarse-grain performance estimator — the paper's toolchain, end to end.

``estimate()`` = (trace × system candidate × kernel reports) → augmented task
graph → dataflow simulation → :class:`PerfEstimate`.  One call takes
milliseconds-to-seconds; the alternative it replaces (generate a bitstream /
retune a full-scale pod run per candidate) takes hours — that ratio is the
paper's headline result (Fig. 6) and is measured by
``benchmarks/fig6_analysis_time.py``.

``reference_run()`` is the "real board" stand-in used for validation: the
same runtime semantics, but per-instance *measured* task times plus a
fine-grain time model (bus/memory contention, cache state, jitter) — the
effects the paper lists as deliberately outside its coarse model.  The
estimator must reproduce the *speedup trends* of the reference (Fig. 5/9),
not its absolute times.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .augment import Eligibility, build_graph
from .devices import SystemConfig
from .hlsreport import ReportMap
from .simulator import SimResult, TimeModel, simulate
from .taskgraph import TaskGraph
from .trace import Trace


@dataclasses.dataclass
class PerfEstimate:
    """Output of one estimator run for one candidate configuration."""

    candidate: str
    makespan_s: float
    sim: SimResult
    graph_stats: Dict[str, object]
    critical_path_s: float
    analysis_seconds: float          # how long the estimation itself took

    @property
    def speedup_vs(self) -> Callable[["PerfEstimate"], float]:
        return lambda other: other.makespan_s / self.makespan_s

    def summary(self) -> Dict[str, object]:
        d = self.sim.summary()
        d.update(candidate=self.candidate,
                 critical_path_s=self.critical_path_s,
                 analysis_seconds=round(self.analysis_seconds, 6),
                 n_tasks=self.graph_stats["n_tasks"])
        return d


def estimate(trace: Trace, system: SystemConfig, reports: ReportMap,
             eligibility: Eligibility, policy: str = "availability",
             smp_scale: float = 1.0, smp_seconds_fn=None) -> PerfEstimate:
    """Coarse-grain estimate: static mean costs, no contention model."""
    t0 = time.perf_counter()
    graph = build_graph(trace, system, reports, eligibility,
                        smp_scale=smp_scale, smp_cost="mean",
                        smp_seconds_fn=smp_seconds_fn)
    sim = simulate(graph, system, policy=policy)
    dt = time.perf_counter() - t0
    return PerfEstimate(candidate=system.name, makespan_s=sim.makespan,
                        sim=sim, graph_stats=graph.subgraph_stats(),
                        critical_path_s=graph.critical_path(),
                        analysis_seconds=dt)


# ---------------------------------------------------------------------------
# Reference executor — the "real system" stand-in for trend validation
# ---------------------------------------------------------------------------


def contention_time_model(seed: int = 0, jitter: float = 0.08,
                          bus_penalty: float = 0.25,
                          cold_start_penalty: float = 0.3) -> TimeModel:
    """Fine-grain effects the coarse estimator ignores (paper §VI):

    * measurement **jitter** — lognormal-ish multiplicative noise;
    * **bus/memory contention** — DMA-bearing tasks slow down while other
      traffic is in flight (approximated by a stateful penalty on transfer
      and accelerator tasks);
    * **cache cold-start** — the first instances of each kernel on the SMP
      run slower (page pinning, cache warm-up).
    """
    import random
    rng = random.Random(seed)
    seen: Dict[str, int] = {}

    def model(task, kind, base, start):  # noqa: ANN001 — TimeModel signature
        f = 1.0 + rng.gauss(0.0, jitter)
        f = max(f, 0.75)
        n = seen.get(task.name, 0)
        seen[task.name] = n + 1
        if kind == "smp" and n < 2:
            f *= 1.0 + cold_start_penalty
        if task.role in ("xfer_out",) or kind.startswith("fpga:"):
            f *= 1.0 + bus_penalty * rng.random()
        return base * f

    return model


def reference_run(trace: Trace, system: SystemConfig, reports: ReportMap,
                  eligibility: Eligibility, policy: str = "availability",
                  smp_scale: float = 1.0, seed: int = 0,
                  smp_seconds_fn=None) -> PerfEstimate:
    """High-fidelity execution model: per-instance measured times + contention."""
    t0 = time.perf_counter()
    graph = build_graph(trace, system, reports, eligibility,
                        smp_scale=smp_scale, smp_cost="per_instance",
                        smp_seconds_fn=smp_seconds_fn)
    sim = simulate(graph, system, policy=policy,
                   time_model=contention_time_model(seed=seed))
    dt = time.perf_counter() - t0
    return PerfEstimate(candidate=system.name, makespan_s=sim.makespan,
                        sim=sim, graph_stats=graph.subgraph_stats(),
                        critical_path_s=graph.critical_path(),
                        analysis_seconds=dt)


# ---------------------------------------------------------------------------
# Trend agreement metrics (the paper's Fig. 5/9 claim, quantified)
# ---------------------------------------------------------------------------


def speedup_table(results: Sequence[PerfEstimate],
                  baseline: Optional[str] = None) -> Dict[str, float]:
    """Normalise makespans to the slowest (or a named) configuration."""
    by_name = {r.candidate: r.makespan_s for r in results}
    ref = by_name[baseline] if baseline else max(by_name.values())
    return {name: ref / t for name, t in by_name.items()}


def spearman_rank_correlation(a: Mapping[str, float],
                              b: Mapping[str, float],
                              tie_rtol: float = 0.02) -> float:
    """Rank agreement between two speedup tables over the same candidates.

    Values within ``tie_rtol`` of each other share an average rank — two
    configurations whose estimated times differ by less than the estimator's
    own fidelity are *the same* design point, not an ordering claim.
    """
    keys = sorted(a)
    if sorted(b) != keys:
        raise ValueError("speedup tables cover different candidates")
    n = len(keys)
    if n < 2:
        return 1.0

    def ranks(m: Mapping[str, float]) -> Dict[str, float]:
        ordered = sorted(keys, key=lambda k: m[k])
        out: Dict[str, float] = {}
        i = 0
        while i < n:
            j = i
            while (j + 1 < n and
                   abs(m[ordered[j + 1]] - m[ordered[i]])
                   <= tie_rtol * max(abs(m[ordered[i]]), 1e-30)):
                j += 1
            avg = (i + j) / 2.0
            for k in range(i, j + 1):
                out[ordered[k]] = avg
            i = j + 1
        return out

    ra, rb = ranks(a), ranks(b)
    d2 = sum((ra[k] - rb[k]) ** 2 for k in keys)
    return 1.0 - 6.0 * d2 / (n * (n * n - 1))


def same_best(a: Mapping[str, float], b: Mapping[str, float],
              rtol: float = 0.02) -> bool:
    """Does a's chosen-best configuration perform within ``rtol`` of b's
    actual best?  (The decision the programmer takes from the estimate.)"""
    best_a = max(a, key=lambda k: a[k])
    return b[best_a] >= max(b.values()) * (1.0 - rtol)
