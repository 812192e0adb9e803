"""Trace augmentation — §IV of the paper.

The basic trace (one event per task instance) is completed with the runtime
effects a sequential run cannot observe:

1. **Creation-cost tasks** — every task instance is preceded by a task that
   models the runtime's task-creation overhead.  Creation always happens on
   the SMP, by the master thread, *in program order* → creation tasks form a
   chain and each feeds its task instance.
2. **DMA submit tasks** — programming a DMA descriptor is software on the SMP
   using shared registers → one ``submit`` task per input and per output
   transfer, all competing for the single shared ``submit`` resource.  The
   original task depends on its input submits; output submits depend on it.
3. **Output DMA transfer tasks** — the Zynq-706 measurement (Fig. 3) shows
   output transfers do not scale with the number of accelerators → one
   ``xfer_out`` task per written region, serialised on the shared ``dma_out``
   resource.  Consumers of the data wait for the transfer, not just for the
   producing task.  Input transfers DO scale → their latency is *folded into*
   the accelerator task occupancy (``KernelReport.folded_cost``).

All augmentation tasks are **conditional** on the placement of their compute
task: if the runtime puts the task on the SMP, no DMA happens — the simulator
zero-costs them (meta ``conditional_on``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .devices import SystemConfig
from .hlsreport import KernelReport, ReportMap
from .regions import Access, Direction, Region
from .taskgraph import Task, TaskGraph
from .trace import Trace, TraceEvent, accesses_of


@dataclasses.dataclass
class Eligibility:
    """Co-design decision: final device kinds per kernel name.

    Example — run 64×64 mxm blocks on two accelerators *and* the SMP::

        Eligibility({"mxm_block": ("fpga:mxm64", "smp")})

    Kinds not present in the system config are dropped at build time (e.g. a
    kernel annotated for the FPGA in a configuration with no such slot).
    """

    kinds_by_kernel: Mapping[str, Tuple[str, ...]]
    default: Tuple[str, ...] = ("smp",)

    def kinds_for(self, kernel: str) -> Tuple[str, ...]:
        return tuple(self.kinds_by_kernel.get(kernel, self.default))


def build_graph(trace: Trace,
                system: SystemConfig,
                reports: ReportMap,
                eligibility: Eligibility,
                smp_scale: float = 1.0,
                smp_cost: str = "per_instance",
                include_creation: bool = True,
                smp_seconds_fn=None) -> TaskGraph:
    """Augmented task graph for one (trace × system × eligibility) candidate.

    ``smp_cost`` — ``per_instance`` uses each event's measured time (the
    reference executor / fine-grain mode); ``mean`` uses the per-kernel mean
    (what the coarse estimator does).

    ``smp_seconds_fn`` — optional ``TraceEvent -> seconds`` override for the
    SMP cost.  Used to emulate the *target* SMP (the paper instruments the
    ARM A9 directly; on a foreign build host the per-kernel relative costs
    of tiny BLAS calls do not transfer, so we map each event's recorded work
    to target throughput instead).
    """
    g = TaskGraph()
    available = set(system.all_kinds()) | {r.name for r in system.shared}
    mean_cost = trace.mean_smp_cost()

    # ---- pass 1: main compute tasks with OmpSs dependence inference -------
    main: List[Task] = []
    for ev in trace.events:
        kinds = [k for k in eligibility.kinds_for(ev.name) if k in available]
        if not kinds:
            raise ValueError(
                f"task {ev.name!r}: no eligible device kind present in system "
                f"{system.name!r} (wanted {eligibility.kinds_for(ev.name)})")
        costs: Dict[str, float] = {}
        for k in kinds:
            if k == "smp":
                if smp_seconds_fn is not None:
                    costs["smp"] = float(smp_seconds_fn(ev))
                else:
                    base = (ev.elapsed_smp if smp_cost == "per_instance"
                            else mean_cost[ev.name])
                    costs["smp"] = base * smp_scale
            else:
                rep = reports.get((ev.name, k))
                if rep is None:
                    raise KeyError(f"no KernelReport for ({ev.name!r}, {k!r})")
                costs[k] = rep.folded_cost if system.overlap_inputs else rep.compute_s
        t = Task(uid=g.new_uid(), name=ev.name, accesses=accesses_of(ev),
                 devices=tuple(kinds), costs=costs, creation_index=ev.index,
                 meta={"role": "compute", "event_index": ev.index})
        g.add_task(t, infer_deps=True)
        main.append(t)

    # snapshot data edges before augmentation mutates succ/pred
    data_succ = {t.uid: set(g.succ.get(t.uid, ())) for t in main}
    data_pred = {t.uid: set(g.pred.get(t.uid, ())) for t in main}

    # ---- pass 2: augmentation tasks ---------------------------------------
    prev_create: Optional[int] = None
    for t in main:
        accel_kinds = tuple(k for k in t.devices if k != "smp")
        # (1) creation-cost task, chained in program order on the SMP
        if include_creation:
            c = Task(uid=g.new_uid(), name=f"create:{t.name}",
                     devices=("smp",), costs={"smp": system.task_creation_cost},
                     creation_index=t.creation_index,
                     meta={"role": "create", "for": t.uid})
            g.add_task(c, infer_deps=False)
            if prev_create is not None:
                g.add_edge(prev_create, c.uid)
            g.add_edge(c.uid, t.uid)
            prev_create = c.uid
        else:
            c = None

        if not accel_kinds:
            continue  # SMP-only task: no DMA machinery

        rep0 = _first_report(reports, t.name, accel_kinds)
        conditional = {"role": "", "conditional_on": t.uid,
                       "active_kinds": accel_kinds}

        # (2) input submit tasks — one per read region
        for acc in t.accesses:
            if not acc.reads:
                continue
            s = Task(uid=g.new_uid(), name=f"submit_in:{t.name}",
                     devices=("submit",),
                     costs={"submit": system.dma_submit_cost},
                     creation_index=t.creation_index,
                     meta={**conditional, "role": "submit_in",
                           "region": acc.region.key})
            g.add_task(s, infer_deps=False)
            if c is not None:
                g.add_edge(c.uid, s.uid)
            # producers of this region feed the transfer
            for p in data_pred[t.uid]:
                if _writes_region(g.tasks[p], acc.region.key):
                    g.add_edge(p, s.uid)
            g.add_edge(s.uid, t.uid)

        # (2b + 3) output submit + serialised output transfer per written region
        if not system.overlap_outputs:
            for acc in t.accesses:
                if not acc.writes:
                    continue
                so = Task(uid=g.new_uid(), name=f"submit_out:{t.name}",
                          devices=("submit",),
                          costs={"submit": system.dma_submit_cost},
                          creation_index=t.creation_index,
                          meta={**conditional, "role": "submit_out",
                                "region": acc.region.key})
                g.add_task(so, infer_deps=False)
                g.add_edge(t.uid, so.uid)
                xo = Task(uid=g.new_uid(), name=f"xfer_out:{t.name}",
                          devices=("dma_out",),
                          costs={"dma_out": rep0.dma_out_s},
                          creation_index=t.creation_index,
                          meta={**conditional, "role": "xfer_out",
                                "region": acc.region.key,
                                "nbytes": acc.region.nbytes})
                g.add_task(xo, infer_deps=False)
                g.add_edge(so.uid, xo.uid)
                # consumers of the written data wait for the transfer
                for snext in data_succ[t.uid]:
                    if _touches_region(g.tasks[snext], acc.region.key):
                        g.add_edge(xo.uid, snext)

    g.validate_acyclic()
    return g


def lower_bound_cost(task: Task) -> float:
    """Per-task cost for the exact makespan lower bound.

    Conditional augmentation tasks (DMA submits/transfers that vanish when
    the compute task lands on the SMP) count zero — the simulator may
    zero-cost them, so charging them would overestimate and make pruning
    unsafe.  The single source of truth for both the reference engine's
    ``lower_bound_seconds`` and ``FrozenGraph.freeze``.
    """
    if task.meta.get("conditional_on") is not None:
        return 0.0
    return min(task.costs.values()) if task.costs else 0.0


def _first_report(reports: ReportMap, kernel: str,
                  kinds: Sequence[str]) -> KernelReport:
    for k in kinds:
        rep = reports.get((kernel, k))
        if rep is not None:
            return rep
    raise KeyError(f"no KernelReport for kernel {kernel!r} among kinds {kinds}")


def _writes_region(t: Task, key: object) -> bool:
    return any(a.writes and a.region.key == key for a in t.accesses)


def _touches_region(t: Task, key: object) -> bool:
    return any(a.region.key == key for a in t.accesses)
