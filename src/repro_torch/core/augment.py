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
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .devices import SystemConfig
from .fastsim import FrozenGraph
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
    # (mirrored as arrays by _Structure and TraceAnalysis.frozen_graph, held
    # to this bit for bit by tests/test_torch_graphbuild.py)
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
    unsafe.  The single source of truth for the reference engine's
    ``lower_bound_seconds`` and ``FrozenGraph.freeze``;
    ``TraceAnalysis.frozen_graph`` applies the same rule to its rows.
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


# ---------------------------------------------------------------------------
# Direct assembly of FrozenGraph payloads
# ---------------------------------------------------------------------------


class TraceAnalysis:
    """Everything :func:`build_graph` derives from the trace alone, once.

    A co-design sweep builds one augmented graph per graph key (available
    kinds × eligibility × the system's cost knobs), and every one of them
    re-derives the same trace facts: each event's accesses, pass 1's
    OmpSs edges, the producers of each read region and the consumers of
    each written region, each event's SMP cost.  This holds them, and
    :meth:`frozen_graph` assembles a key's :class:`FrozenGraph` arrays
    straight from them, with no :class:`Task` or :class:`TaskGraph` on the
    way.  The payload equals ``FrozenGraph.freeze(build_graph(...))`` with
    the same arguments bit for bit, errors included; ``build_graph`` and
    ``freeze`` stay the definition it is tested against.

    The row structure (rows, edges, topological order) depends only on
    which kernels have an accelerator kind and ``overlap_outputs``, so it
    is kept per structure; a key adds its kinds and costs, filled by
    array operations per (kernel, kind), and the two longest paths, which
    depend only on the structure and the rows' least costs, so each
    structure walks them once per distinct cost vector.  An
    :class:`Explorer` holds one analysis for its lifetime and nothing
    outlives it.
    """

    def __init__(self, trace: Trace, *, smp_scale: float = 1.0,
                 smp_cost: str = "per_instance", smp_seconds_fn=None):
        events = trace.events
        n_ev = len(events)
        self.trace = trace
        self.smp_scale = smp_scale
        self.smp_cost = smp_cost
        self.events = events
        self.names = [ev.name for ev in events]
        self.kernels = trace.names()
        kidx = {k: i for i, k in enumerate(self.kernels)}
        self.kernel_of = np.asarray([kidx[name] for name in self.names],
                                    dtype=np.int64)
        # the event rows of each kernel, in event order
        self.rows_of = [np.flatnonzero(self.kernel_of == k)
                        for k in range(len(self.kernels))]

        # pass 1 of build_graph, through the same TaskGraph inference
        g = TaskGraph()
        for ev in events:
            g.add_task(Task(uid=g.new_uid(), name=ev.name,
                            accesses=accesses_of(ev)), infer_deps=True)
        tasks = g.tasks
        self.data_succ = [frozenset(g.succ.get(e, ())) for e in range(n_ev)]
        # (producers per read access, consumers per write access), in
        # access order: what pass 2 links each DMA task to
        self.reads: List[List[Tuple[int, ...]]] = []
        self.writes: List[List[Tuple[int, ...]]] = []
        for e in range(n_ev):
            accs = tasks[e].accesses
            pred = g.pred.get(e, ())
            succ = self.data_succ[e]
            self.reads.append([
                tuple(p for p in pred
                      if _writes_region(tasks[p], a.region.key))
                for a in accs if a.reads])
            self.writes.append([
                tuple(s for s in succ
                      if _touches_region(tasks[s], a.region.key))
                for a in accs if a.writes])

        # each event's SMP cost; where smp_seconds_fn raised, NaN and a
        # mark, and the model is called again where build_graph would ask
        # for it, to raise afresh there
        self.smp_seconds_fn = smp_seconds_fn
        self.smp = np.empty(n_ev, dtype=np.float64)
        self.smp_raised = np.zeros(n_ev, dtype=bool)
        mean_cost = trace.mean_smp_cost()
        for e, ev in enumerate(events):
            if smp_seconds_fn is not None:
                try:
                    self.smp[e] = float(smp_seconds_fn(ev))
                except Exception:           # noqa: BLE001 — deferred
                    self.smp[e] = math.nan
                    self.smp_raised[e] = True
            else:
                base = (ev.elapsed_smp if smp_cost == "per_instance"
                        else mean_cost[ev.name])
                self.smp[e] = base * smp_scale
        # per kernel: its first event whose model raised (n_ev where none
        # did)
        self.first_raised = [int(r[self.smp_raised[r]][0])
                             if self.smp_raised[r].any() else n_ev
                             for r in self.rows_of]
        self._structures: Dict[Tuple, "_Structure"] = {}

    def frozen_graph(self, system: SystemConfig, reports: ReportMap,
                     eligibility: Eligibility) -> FrozenGraph:
        """``FrozenGraph.freeze(build_graph(trace, system, reports,
        eligibility, ...))`` with this analysis's trace and SMP model."""
        return self.assemble(system, reports, eligibility)[0]

    def assemble(self, system: SystemConfig, reports: ReportMap,
                 eligibility: Eligibility) -> Tuple[FrozenGraph, bool]:
        """:meth:`frozen_graph`, and whether its longest paths came from
        its structure's memo (an earlier key with the same row costs)."""
        available = set(system.all_kinds()) | {r.name for r in system.shared}
        kinds_of = [tuple(k for k in eligibility.kinds_for(name)
                          if k in available) for name in self.kernels]
        accel_cost: List[Dict[str, float]] = []
        for name, kinds in zip(self.kernels, kinds_of):
            got = {}
            for k in kinds:
                rep = reports.get((name, k)) if k != "smp" else None
                if rep is not None:
                    got[k] = (rep.folded_cost if system.overlap_inputs
                              else rep.compute_s)
            accel_cost.append(got)

        # pass 1 raises at the first event that fails: every event of a
        # kernel with no kind present or a report missing, else an event
        # whose SMP model raised; that event is costed as pass 1 costs it
        n_ev = len(self.events)
        first = n_ev
        for ki, kinds in enumerate(kinds_of):
            if not kinds or any(k != "smp" and k not in accel_cost[ki]
                                for k in kinds):
                first = min(first, int(self.rows_of[ki][0]))
            elif "smp" in kinds:
                first = min(first, self.first_raised[ki])
        if first < n_ev:
            self._event_costs(first, kinds_of, accel_cost, system,
                              eligibility)
            raise AssertionError(f"event {first} did not fail")

        accel_of = [tuple(k for k in ks if k != "smp") for ks in kinds_of]
        skey = (tuple(bool(a) for a in accel_of), system.overlap_outputs)
        st = self._structures.get(skey)
        if st is None:
            st = self._structures.setdefault(skey, _Structure(self, *skey))
        n = st.n

        kinds: List[str] = []
        kind_id: Dict[str, int] = {}
        for k in [k for ks in kinds_of for k in ks] + list(st.aug_kinds):
            if k not in kind_id:
                kind_id[k] = len(kinds)
                kinds.append(k)
        ids_of = [[kind_id[k] for k in ks] for ks in kinds_of]
        act_of = [[kind_id[k] for k in ks] for ks in accel_of]

        # the compute rows, kernel by kernel and kind by kind; a row's
        # least cost is min() of its costs in kind order, where a NaN
        # counts only if it comes first
        cost = np.full((n, len(kinds)), np.nan, dtype=np.float64)
        cmin = np.empty(n, dtype=np.float64)
        for ki, ks in enumerate(kinds_of):
            rows = self.rows_of[ki]
            low = None
            for k in ks:
                v = self.smp[rows] if k == "smp" else accel_cost[ki][k]
                cost[rows, kind_id[k]] = v
                low = v if low is None else np.where(v < low, v, low)
            cmin[rows] = low
        # one cost per augmentation row: create → task_creation_cost,
        # submit → dma_submit_cost, xfer_out → its kernel's first report's
        # dma_out_s (build_graph's rep0)
        aug_kid = np.asarray([kind_id.get(k, -1)
                              for k in ("smp", "submit", "dma_out")],
                             dtype=np.int64)
        if n > n_ev:
            aug_val = np.empty((3, len(self.kernels)), dtype=np.float64)
            aug_val[0] = system.task_creation_cost
            aug_val[1] = system.dma_submit_cost
            aug_val[2] = [reports[(name, acc[0])].dma_out_s if acc
                          else math.nan
                          for name, acc in zip(self.kernels, accel_of)]
            aug_cost = aug_val[st.aug_type, st.aug_kernel]
            cost[st.aug_rows, aug_kid[st.aug_type]] = aug_cost
            cmin[n_ev:] = aug_cost
        # lower_bound_cost: conditional rows count zero
        lmin = np.where(st.cond >= 0, 0.0, cmin)

        # each row's device options, then its activated kinds, from the
        # per-kernel lists
        dev_len = np.ones(n, dtype=np.int64)
        dev_len[:n_ev] = np.asarray([len(ids) for ids in ids_of],
                                    dtype=np.int64)[self.kernel_of]
        dev_indptr = _indptr(dev_len)
        dev_kids = np.empty(int(dev_indptr[-1]), dtype=np.int64)
        for ki, ids in enumerate(ids_of):
            at = dev_indptr[self.rows_of[ki]]
            for j, kid in enumerate(ids):
                dev_kids[at + j] = kid
        dev_kids[dev_indptr[n_ev:n]] = aug_kid[st.aug_type]
        act_len = np.zeros(n, dtype=np.int64)
        act_len[st.cond_rows] = np.asarray(
            [len(ids) for ids in act_of], dtype=np.int64)[st.cond_kernel]
        act_indptr = _indptr(act_len)
        act_kids = np.empty(int(act_indptr[-1]), dtype=np.int64)
        for ki, ids in enumerate(act_of):
            at = act_indptr[st.cond_rows_of[ki]]
            for j, kid in enumerate(ids):
                act_kids[at + j] = kid

        if np.isfinite(cmin).all():
            # lmin follows from cmin within a structure, so cmin keys both
            memo = cmin.tobytes()
            paths = st.paths.get(memo)
            reused = paths is not None
            if not reused:
                paths = st.paths.setdefault(
                    memo, st.longest_paths(cmin.tolist(), lmin.tolist()))
            crit, lb = paths
        else:
            # a cost that is not finite (NaN, or ±inf, which can sum to
            # NaN) makes a longest path depend on the order in which the
            # definition visits each row's predecessors: take its walk
            reused = False
            crit, lb = build_graph(
                self.trace, system, reports, eligibility,
                smp_scale=self.smp_scale, smp_cost=self.smp_cost,
                smp_seconds_fn=self.smp_seconds_fn,
            ).critical_paths([None, lower_bound_cost])

        return FrozenGraph(
            n=n, uid=np.arange(n, dtype=np.int64), names=st.names,
            roles=st.roles, is_compute=st.is_compute.copy(),
            creation_index=st.creation_index.copy(), cond=st.cond.copy(),
            act_indptr=act_indptr, act_kids=act_kids,
            dev_indptr=dev_indptr, dev_kids=dev_kids,
            cost=cost, succ_indptr=st.succ_indptr.copy(),
            succ_rows=st.succ_rows.copy(), n_pred=st.n_pred.copy(),
            kinds=tuple(kinds),
            stats={"n_tasks": n, "n_edges": st.n_edges,
                   "per_name": dict(st.per_name), "n_roots": st.n_roots},
            critical_path_s=crit, lower_bound_s=lb), reused

    def _event_costs(self, e: int, kinds_of: List[Tuple[str, ...]],
                     accel_cost: List[Dict[str, float]],
                     system: SystemConfig,
                     eligibility: Eligibility) -> Dict[str, float]:
        """Event ``e``'s costs as pass 1 of :func:`build_graph` takes them,
        raising as it raises."""
        ki = self.kernel_of[e]
        kinds = kinds_of[ki]
        name = self.names[e]
        if not kinds:
            raise ValueError(
                f"task {name!r}: no eligible device kind present in "
                f"system {system.name!r} (wanted "
                f"{eligibility.kinds_for(name)})")
        costs: Dict[str, float] = {}
        for k in kinds:
            if k == "smp":
                costs["smp"] = float(self.smp[e]) if not self.smp_raised[e] \
                    else float(self.smp_seconds_fn(self.events[e]))
            else:
                v = accel_cost[ki].get(k)
                if v is None:
                    raise KeyError(f"no KernelReport for ({name!r}, {k!r})")
                costs[k] = v
        return costs


def _indptr(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


class _Structure:
    """The rows and edges of every graph whose kernels with an accelerator
    kind and ``overlap_outputs`` are ``accel`` and ``overlap_outputs``:
    pass 2 of :func:`build_graph` in the same row order, as indices.
    Augmentation rows carry a type (0 create, 1 submit, 2 xfer_out) and
    their kernel.  ``paths`` memoises the two longest paths by the rows'
    least costs."""

    def __init__(self, an: TraceAnalysis, accel: Tuple[bool, ...],
                 overlap_outputs: bool):
        n_ev = len(an.events)
        kernel_of = an.kernel_of.tolist()
        names = list(an.names)
        roles = ["compute"] * n_ev
        owner = list(range(n_ev))
        cond = [-1] * n_ev
        succ = [set(s) for s in an.data_succ]
        aug_type: List[int] = []
        seen_kinds: List[str] = []

        def row(role: str, typ: int, of: int, c: int) -> int:
            names.append(f"{role}:{an.names[of]}")
            roles.append(role)
            owner.append(of)
            cond.append(c)
            succ.append(set())
            aug_type.append(typ)
            kind = ("smp", "submit", "dma_out")[typ]
            if kind not in seen_kinds:
                seen_kinds.append(kind)
            return len(names) - 1

        prev = None
        for t in range(n_ev):
            c = row("create", 0, t, -1)
            if prev is not None:
                succ[prev].add(c)
            succ[c].add(t)
            prev = c
            if not accel[kernel_of[t]]:
                continue
            for producers in an.reads[t]:
                s = row("submit_in", 1, t, t)
                succ[c].add(s)
                for p in producers:
                    succ[p].add(s)
                succ[s].add(t)
            if not overlap_outputs:
                for consumers in an.writes[t]:
                    so = row("submit_out", 1, t, t)
                    succ[t].add(so)
                    xo = row("xfer_out", 2, t, t)
                    succ[so].add(xo)
                    for q in consumers:
                        succ[xo].add(q)

        n = len(names)
        self.n = n
        self.names = tuple(names)
        self.roles = tuple(roles)
        self.is_compute = np.zeros(n, dtype=bool)
        self.is_compute[:n_ev] = True
        owner_arr = np.asarray(owner, dtype=np.int64)
        self.creation_index = np.asarray(
            [ev.index for ev in an.events], dtype=np.int64)[owner_arr]
        self.cond = np.asarray(cond, dtype=np.int64)
        self.aug_rows = np.arange(n_ev, n, dtype=np.int64)
        self.aug_type = np.asarray(aug_type, dtype=np.int64)
        self.aug_kernel = an.kernel_of[owner_arr[n_ev:]]
        self.aug_kinds = tuple(seen_kinds)
        self.cond_rows = np.flatnonzero(self.cond >= 0)
        self.cond_kernel = an.kernel_of[self.cond[self.cond_rows]]
        self.cond_rows_of = [self.cond_rows[self.cond_kernel == k]
                             for k in range(len(an.kernels))]

        rows = [sorted(s) for s in succ]
        self.succ = rows
        self.succ_indptr = _indptr([len(s) for s in rows])
        self.succ_rows = np.asarray([v for s in rows for v in s],
                                    dtype=np.int64)
        indeg = [0] * n
        for v in self.succ_rows.tolist():
            indeg[v] += 1
        self.n_pred = np.asarray(indeg, dtype=np.int64)
        self.n_edges = int(self.succ_rows.size)
        self.n_roots = indeg.count(0)
        self.entry = [-math.inf if d else 0.0 for d in indeg]
        per_name: Dict[str, int] = {}
        for name in names:
            per_name[name] = per_name.get(name, 0) + 1
        self.per_name = per_name

        order = [u for u in range(n) if not indeg[u]]
        for u in order:             # grows while it is walked (Kahn)
            for v in rows[u]:
                indeg[v] -= 1
                if not indeg[v]:
                    order.append(v)
        if len(order) != n:
            raise ValueError("task graph has a cycle")
        self.order = order
        self.paths: Dict[bytes, Tuple[float, float]] = {}

    def longest_paths(self, cmin: List[float], lmin: List[float]
                      ) -> Tuple[float, float]:
        """The critical path under ``cmin`` and the lower bound under
        ``lmin``, in one pass over one topological order: a row's entry is
        the max over its predecessors (0.0 at a root), then its own cost
        is added."""
        dc = list(self.entry)
        dl = list(self.entry)
        succ = self.succ
        for u in self.order:
            a = dc[u] = dc[u] + cmin[u]
            b = dl[u] = dl[u] + lmin[u]
            for v in succ[u]:
                if a > dc[v]:
                    dc[v] = a
                if b > dl[v]:
                    dl[v] = b
        return max(dc, default=0.0), max(dl, default=0.0)
