"""The plain reference: augmented task graph and exact list scheduling.

A frozen copy, in plain Python and NumPy scalars, of the port's exact
estimator path at commit e803567 (``src/repro_torch/core/taskgraph.py``:
OmpSs dependence inference; ``core/augment.py::build_graph``: creation,
DMA-submit and output-transfer tasks; ``core/devices.py::zynq_system``;
``core/simulator.py::Simulator`` under the ``availability`` policy).  It
imports nothing of the program: it takes the benchmark's plain inputs
(:mod:`portbench.apps`) and works everything out again.

``dtype`` is the arithmetic of every cost, clock and sum: ``float`` (IEEE
double, what the program states) or ``numpy.float32`` (the control, one
precision below).
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

Number = Callable[[float], object]


class Graph:
    """The augmented task graph of one (trace, available kinds,
    eligibility): per task its kinds, costs by kind, creation index,
    and, for DMA tasks, the compute task it is conditional on."""

    def __init__(self) -> None:
        self.kinds: List[Tuple[str, ...]] = []
        self.costs: List[Dict[str, object]] = []
        self.cidx: List[int] = []
        self.compute: List[bool] = []
        self.cond: List[int] = []                 # -1: unconditional
        self.active: List[Tuple[str, ...]] = []
        self.succ: List[set] = []
        self.pred: List[set] = []

    def add(self, kinds, costs, cidx, compute, cond=-1, active=()) -> int:
        self.kinds.append(tuple(kinds))
        self.costs.append(costs)
        self.cidx.append(cidx)
        self.compute.append(compute)
        self.cond.append(cond)
        self.active.append(tuple(active))
        self.succ.append(set())
        self.pred.append(set())
        return len(self.kinds) - 1

    def edge(self, a: int, b: int) -> None:
        if a != b:
            self.succ[a].add(b)
            self.pred[b].add(a)


def pools_of(accelerators: Mapping[str, int], smp_cores: int
             ) -> List[Tuple[str, Tuple[str, ...], int]]:
    """``zynq_system``'s pools: the SMP, one pool per accelerator kind
    with slots, then the shared ``submit`` and ``dma_out`` resources."""
    pools = [("smp", ("smp",), smp_cores)]
    for kind, n in accelerators.items():
        if n > 0:
            pools.append((kind.replace("fpga:", "acc_"), (kind,), n))
    return pools + [("submit", ("submit",), 1), ("dma_out", ("dma_out",), 1)]


def smp_costs(events: Sequence[dict], smp: Mapping) -> Dict[int, float]:
    """Each event's SMP seconds: ``flops / (gflops * 1e9)`` (``{"model":
    "a9", "gflops": g}``, the examples' ``a9_smp_seconds``)."""
    if smp["model"] != "a9":
        raise ValueError(f"unknown SMP model {smp['model']!r}")
    g = smp["gflops"]
    return {e["index"]: e["flops"] / (g * 1e9) for e in events}


def build_graph(events: Sequence[dict], available: set,
                eligibility: Mapping[str, Sequence[str]],
                reports: Mapping[Tuple[str, str], dict],
                smp_cost: Mapping[int, float], system: Mapping,
                num: Number = float) -> Graph:
    """``augment.build_graph`` with inputs overlapped and outputs not
    (``zynq_system``): compute tasks with RAW/WAW/WAR edges in creation
    order, then per compute task a creation task chained on the SMP and,
    where it may run on an accelerator, one input submit per read region
    and an output submit and serialised transfer per written region."""
    g = Graph()
    main: List[int] = []
    last_writer: Dict[object, int] = {}
    readers: Dict[object, List[int]] = defaultdict(list)
    acc_of: Dict[int, list] = {}
    for ev in events:
        kinds = [k for k in eligibility.get(ev["name"], ("smp",))
                 if k in available]
        if not kinds:
            raise ValueError(f"task {ev['name']!r}: no eligible kind")
        costs = {}
        for k in kinds:
            if k == "smp":
                costs[k] = num(smp_cost[ev["index"]])
            else:
                rep = reports[(ev["name"], k)]
                costs[k] = num(rep["dma_in_s"] + rep["compute_s"])
        u = g.add(kinds, costs, ev["index"], True)
        accesses = [(tuple(key) if isinstance(key, list) else key, d)
                    for key, d, _ in ev["accesses"]]
        acc_of[u] = accesses
        for key, d in accesses:
            reads, writes = d in ("in", "inout"), d in ("out", "inout")
            if reads and key in last_writer:
                g.edge(last_writer[key], u)
            if writes:
                if key in last_writer:
                    g.edge(last_writer[key], u)
                for r in readers[key]:
                    g.edge(r, u)
        for key, d in accesses:
            if d in ("out", "inout"):
                last_writer[key] = u
                readers[key] = []
        for key, d in accesses:
            if d == "in":
                readers[key].append(u)
        main.append(u)

    data_succ = {u: set(g.succ[u]) for u in main}
    data_pred = {u: set(g.pred[u]) for u in main}
    create_cost = num(system["task_creation_cost"])
    submit_cost = num(system["dma_submit_cost"])
    prev = -1
    for u in main:
        accel = tuple(k for k in g.kinds[u] if k != "smp")
        c = g.add(("smp",), {"smp": create_cost}, g.cidx[u], False)
        if prev >= 0:
            g.edge(prev, c)
        g.edge(c, u)
        prev = c
        if not accel:
            continue
        name = events[g.cidx[u]]["name"]
        rep0 = next(reports[(name, k)] for k in accel
                    if (name, k) in reports)
        for key, d in acc_of[u]:
            if d not in ("in", "inout"):
                continue
            s = g.add(("submit",), {"submit": submit_cost}, g.cidx[u],
                      False, u, accel)
            g.edge(c, s)
            for p in data_pred[u]:
                if any(k2 == key and d2 in ("out", "inout")
                       for k2, d2 in acc_of[p]):
                    g.edge(p, s)
            g.edge(s, u)
        for key, d in acc_of[u]:
            if d not in ("out", "inout"):
                continue
            so = g.add(("submit",), {"submit": submit_cost}, g.cidx[u],
                       False, u, accel)
            g.edge(u, so)
            xo = g.add(("dma_out",), {"dma_out": num(rep0["dma_out_s"])},
                       g.cidx[u], False, u, accel)
            g.edge(so, xo)
            for v in data_succ[u]:
                if any(k2 == key for k2, _ in acc_of[v]):
                    g.edge(xo, v)
    return g


def simulate(g: Graph, pools: Sequence[Tuple[str, Tuple[str, ...], int]],
             num: Number = float) -> object:
    """``Simulator.run`` under ``availability``: pop the ready task of the
    least ``(ready time, creation index, uid)``; a compute task, or the
    first DMA task of its unit to wake, picks the kind whose pool can
    start it first (an accelerator on ties, then annotation order); DMA
    tasks of a compute task placed on the SMP cost nothing.  Returns the
    makespan in ``num``'s arithmetic."""
    zero = num(0.0)
    clocks = {name: [zero] * count for name, _, count in pools}
    kind_pool: Dict[str, str] = {}
    for name, kinds, _ in pools:
        for k in kinds:
            kind_pool.setdefault(k, name)
    n = len(g.kinds)
    npred = [len(p) for p in g.pred]
    ready = [zero] * n
    placed: Dict[int, str] = {}
    heap = [(zero, g.cidx[u], u) for u in range(n) if npred[u] == 0]
    heapq.heapify(heap)
    makespan = zero
    done = 0

    def earliest(pool: str):
        cl = clocks[pool]
        t = min(cl)
        return t, cl.index(t)

    def choose(u: int, rt) -> str:
        opts = []
        for idx, kind in enumerate(g.kinds[u]):
            pool = kind_pool.get(kind)
            if pool is None:
                continue
            t, _ = earliest(pool)
            opts.append((max(rt, t), 1 if kind == "smp" else 0, idx, kind))
        opts.sort()
        return opts[0][3]

    while heap:
        rt, _, u = heapq.heappop(heap)
        end = None
        cond = g.cond[u]
        if cond >= 0:
            pk = placed.get(cond)
            if pk is None:
                pk = choose(cond, rt)
                placed[cond] = pk
            if pk not in g.active[u]:
                end = rt
        if end is None:
            if g.compute[u]:
                kind = placed.get(u) or choose(u, rt)
                placed[u] = kind
            else:
                kind = g.kinds[u][0]
            pool = kind_pool[kind]
            t, slot = earliest(pool)
            end = max(rt, t) + g.costs[u][kind]
            clocks[pool][slot] = end
        if end > makespan:
            makespan = end
        done += 1
        for v in g.succ[u]:
            if end > ready[v]:
                ready[v] = end
            npred[v] -= 1
            if npred[v] == 0:
                heapq.heappush(heap, (ready[v], g.cidx[v], v))
    if done != n:
        raise RuntimeError(f"deadlock: {done} of {n} tasks ran")
    return makespan


class Reference:
    """Makespans of candidates of one application, each graph built once
    per (available kinds, eligibility) and each candidate simulated once.

    ``inputs`` is :class:`portbench.apps.Inputs`' plain form: ``events``,
    ``reports`` (a list of dicts keyed by kernel and device kind),
    ``system`` (SMP cores, creation and submit costs) and ``smp`` (the SMP
    cost model)."""

    def __init__(self, inputs: Mapping, num: Number = float):
        self.inputs = inputs
        self.num = num
        self.reports = {(r["kernel"], r["device_kind"]): r
                        for r in inputs["reports"]}
        self.smp = smp_costs(inputs["events"], inputs["smp"])
        self._graphs: Dict[Tuple, Graph] = {}
        self._spans: Dict[Tuple, float] = {}

    def makespan(self, cand: Mapping) -> float:
        """The makespan of ``cand`` (``accelerators``: kind -> slots,
        ``eligibility``: kernel -> kinds), as a Python float."""
        acc = cand["accelerators"]
        elig = {k: tuple(v) for k, v in cand["eligibility"].items()}
        key = (tuple(sorted(acc.items())), tuple(sorted(elig.items())))
        if key not in self._spans:
            pools = pools_of(acc, self.inputs["system"]["smp_cores"])
            available = {k for _, kinds, _ in pools for k in kinds}
            gkey = (tuple(sorted(available)), key[1])
            if gkey not in self._graphs:
                self._graphs[gkey] = build_graph(
                    self.inputs["events"], available, elig, self.reports,
                    self.smp, self.inputs["system"], self.num)
            self._spans[key] = float(simulate(self._graphs[gkey], pools,
                                              self.num))
        return self._spans[key]


def reference_f32(inputs: Mapping) -> Reference:
    """The control: the reference with every cost, clock and sum in
    float32."""
    return Reference(inputs, np.float32)
