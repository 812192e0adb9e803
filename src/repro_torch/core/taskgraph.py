"""Task instances and the dataflow task graph.

Dependence inference follows the Nanos++ (OmpSs runtime) rules over the
sequential program order of task creation:

* RAW — a reader depends on the *last previous writer* of each region it reads.
* WAW — a writer depends on the last previous writer of each region it writes.
* WAR — a writer depends on every reader of the region since that last writer.

Edges therefore encode exactly the partial order the real runtime would
enforce; the simulator is free to execute any linear extension of it.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Hashable, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from .regions import Access, Direction, Region


@dataclasses.dataclass
class Task:
    """One task *instance* (a node of the dataflow graph).

    ``costs`` maps device-kind → estimated seconds on that kind.  ``devices``
    is the programmer annotation (``target device(fpga,smp)``): the set of
    device kinds this instance is allowed to run on.  Augmentation tasks
    (creation / submit / output-DMA) set ``meta['role']`` accordingly and may
    carry ``meta['conditional_on']`` — see ``augment.py``.
    """

    uid: int
    name: str
    accesses: Tuple[Access, ...] = ()
    devices: Tuple[str, ...] = ("smp",)
    costs: Dict[str, float] = dataclasses.field(default_factory=dict)
    creation_index: int = 0
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def cost_on(self, kind: str) -> float:
        if kind in self.costs:
            return self.costs[kind]
        raise KeyError(f"task {self.name}#{self.uid} has no cost for device kind {kind!r};"
                       f" known kinds: {sorted(self.costs)}")

    @property
    def reads(self) -> List[Region]:
        return [a.region for a in self.accesses if a.reads]

    @property
    def writes(self) -> List[Region]:
        return [a.region for a in self.accesses if a.writes]

    @property
    def role(self) -> str:
        return str(self.meta.get("role", "compute"))


class TaskGraph:
    """A DAG of :class:`Task` with OmpSs dependence semantics."""

    def __init__(self) -> None:
        self.tasks: Dict[int, Task] = {}
        self.succ: Dict[int, Set[int]] = defaultdict(set)
        self.pred: Dict[int, Set[int]] = defaultdict(set)
        self._next_uid = 0
        # dependence-inference state (per region key)
        self._last_writer: Dict[Hashable, int] = {}
        self._readers_since_write: Dict[Hashable, List[int]] = defaultdict(list)

    # ------------------------------------------------------------------ build
    def new_uid(self) -> int:
        uid = self._next_uid
        self._next_uid += 1
        return uid

    def add_task(self, task: Task, infer_deps: bool = True) -> Task:
        if task.uid in self.tasks:
            raise ValueError(f"duplicate task uid {task.uid}")
        self.tasks[task.uid] = task
        if infer_deps:
            self._infer_edges(task)
        return task

    def add_edge(self, src: int, dst: int) -> None:
        if src == dst:
            return
        if src not in self.tasks or dst not in self.tasks:
            raise KeyError(f"edge ({src}->{dst}) references unknown task")
        self.succ[src].add(dst)
        self.pred[dst].add(src)

    def _infer_edges(self, task: Task) -> None:
        """Apply RAW/WAR/WAW rules in sequential creation order."""
        for acc in task.accesses:
            key = acc.region.key
            if acc.reads:
                w = self._last_writer.get(key)
                if w is not None:
                    self.add_edge(w, task.uid)  # RAW
            if acc.writes:
                w = self._last_writer.get(key)
                if w is not None:
                    self.add_edge(w, task.uid)  # WAW
                for r in self._readers_since_write[key]:
                    self.add_edge(r, task.uid)  # WAR
        # update state *after* all edges (a task never depends on itself)
        for acc in task.accesses:
            key = acc.region.key
            if acc.writes:
                self._last_writer[key] = task.uid
                self._readers_since_write[key] = []
        for acc in task.accesses:
            if acc.reads and not acc.writes:
                self._readers_since_write[acc.region.key].append(task.uid)

    # ------------------------------------------------------------------ query
    def __len__(self) -> int:
        return len(self.tasks)

    def roots(self) -> List[int]:
        return [uid for uid in self.tasks if not self.pred.get(uid)]

    def topological_order(self) -> List[int]:
        indeg = {uid: len(self.pred.get(uid, ())) for uid in self.tasks}
        stack = sorted([u for u, d in indeg.items() if d == 0])
        out: List[int] = []
        i = 0
        from heapq import heapify, heappop, heappush
        heapify(stack)
        while stack:
            u = heappop(stack)
            out.append(u)
            for v in sorted(self.succ.get(u, ())):
                indeg[v] -= 1
                if indeg[v] == 0:
                    heappush(stack, v)
        if len(out) != len(self.tasks):
            raise ValueError("task graph has a cycle")
        return out

    def validate_acyclic(self) -> None:
        self.topological_order()

    def critical_path(self, cost_fn: Optional[Callable[[Task], float]] = None) -> float:
        """Length of the longest path using ``cost_fn`` (default: min over kinds).

        This is a *lower bound* on any schedule's makespan when ``cost_fn``
        returns the per-task minimum cost across eligible devices.
        """
        return self.critical_paths([cost_fn])[0]

    def critical_paths(self, cost_fns: Sequence[
            Optional[Callable[[Task], float]]]) -> List[float]:
        """Longest-path length per cost function over a *single* topological
        pass — ``FrozenGraph.freeze`` needs both the critical path and the
        pruning lower bound, and the sort dominates the evaluation.  A
        ``None`` entry means the default min-over-kinds cost."""
        order = self.topological_order()
        out: List[float] = []
        for cost_fn in cost_fns:
            if cost_fn is None:
                cost_fn = lambda t: min(t.costs.values()) if t.costs else 0.0
            dist: Dict[int, float] = {}
            for uid in order:
                base = max((dist[p] for p in self.pred.get(uid, ())),
                           default=0.0)
                dist[uid] = base + cost_fn(self.tasks[uid])
            out.append(max(dist.values(), default=0.0))
        return out

    def total_work(self, cost_fn: Optional[Callable[[Task], float]] = None) -> float:
        if cost_fn is None:
            cost_fn = lambda t: min(t.costs.values()) if t.costs else 0.0
        return sum(cost_fn(t) for t in self.tasks.values())

    def by_name(self) -> Mapping[str, List[Task]]:
        out: Dict[str, List[Task]] = defaultdict(list)
        for t in self.tasks.values():
            out[t.name].append(t)
        return out

    def subgraph_stats(self) -> Dict[str, object]:
        names = {n: len(v) for n, v in self.by_name().items()}
        return {
            "n_tasks": len(self.tasks),
            "n_edges": sum(len(s) for s in self.succ.values()),
            "per_name": names,
            "n_roots": len(self.roots()),
        }
