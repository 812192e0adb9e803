"""Framework-level estimator: a training or serving step as a coarse task
graph, the JAX package's ``repro/core/steptask.py`` on the card's
hardware record.

This is the paper's methodology applied to the framework itself.  The
correspondence:

  Vivado HLS report   →  probe records (per-layer FLOPs / bytes /
                          collective wire bytes at two depths; on the card
                          :class:`~repro_torch.core.hlsreport.TorchCostModel`
                          counts them on ``meta`` tensors)
  OmpSs task trace    →  the layer structure of the step (embed → L×block →
                          head/optimizer), known statically from the config
  accelerator slots   →  the per-GPU tensor-core + HBM timeline ("gpu" pool)
  shared output-DMA   →  the GPU's NVLink ("nvlink"), and the link between
                          nodes ("internode") for runs over several pods
  task creation cost  →  host dispatch of the step ("smp")

One :func:`estimate_step` call builds the graph and runs the port's
discrete-event simulator, giving a predicted step time and a
per-resource utilization/bottleneck breakdown.  :func:`codesign_sweep`
ranks candidates exactly the way the paper ranks accelerator
configurations.  ``hw=`` defaults to :data:`~repro_torch.roofline.H100`,
whose pod is one HGX node of 8 GPUs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..roofline.model import H100, HW, _terms_of
from .devices import DevicePool, SharedResource, SystemConfig
from .fastsim import freeze_graph, simulate_fast
from .simulator import SimResult, simulate
from .taskgraph import Task, TaskGraph


@dataclasses.dataclass(frozen=True)
class LayerCosts:
    """Per-layer and outside-loop (head: embed/logits/optimizer) costs, in
    seconds, derived from two probes."""

    n_layers: int
    layer_compute: float          # flops/peak per layer
    layer_collective: float       # ring wire time per layer on the link
    head_compute: float
    head_collective: float
    internode_collective: float = 0.0   # gradient reduction between pods

    @staticmethod
    def from_probes(probe1: Mapping, probe2: Mapping, full_layers: int,
                    hw: HW = H100, pods: int = 1,
                    params: Optional[int] = None) -> "LayerCosts":
        l1, l2 = probe1["n_layers"], probe2["n_layers"]
        t1, t2 = _terms_of(probe1), _terms_of(probe2)
        slope = {k: (t2[k] - t1[k]) / max(l2 - l1, 1) for k in t1}
        # negative slope = strategy flip at the smallest depth; fall back
        # to proportional from the larger probe
        slope = {k: (s if s >= 0 else t2[k] / l2) for k, s in slope.items()}
        icept = {k: max(t1[k] - slope[k] * l1, 0.0) for k in t1}
        # layer cost = tensor-core time.  The counted bytes are an unfused
        # upper bound — folding them in would make every estimate
        # spuriously memory-bound, so the HBM floor is the roofline
        # table's, not double-counted here.
        per_unit = lambda s: s["flops"] / hw.peak_flops
        internode = 0.0
        if pods > 1 and params is not None:
            # hierarchical gradient reduction: the hop between pods moves
            # each chip's grad shard once up + once down
            n_chips = hw.chips_per_pod * pods
            internode = 2.0 * (params * 2 / n_chips) / hw.internode_bw
        return LayerCosts(
            n_layers=full_layers,
            layer_compute=per_unit(slope),
            layer_collective=slope["wire"] / hw.link_bw,
            head_compute=per_unit(icept),
            head_collective=icept["wire"] / hw.link_bw,
            internode_collective=internode)


def pod_chip_system(name: str = "h100-gpu", pods: int = 1,
                    dispatch_cost: float = 10e-6) -> SystemConfig:
    """The per-GPU resource model: one tensor-core+HBM slot, its NVLink,
    the link between nodes (several pods), and the host dispatch
    queue."""
    pools = [DevicePool("host", ("smp",), 1),
             DevicePool("gpu", ("gpu",), 1)]
    shared = [SharedResource("nvlink", 1)]
    if pods > 1:
        shared.append(SharedResource("internode", 1))
    return SystemConfig(name=name, pools=pools, shared=shared,
                        overlap_inputs=True, overlap_outputs=True,
                        task_creation_cost=dispatch_cost,
                        meta={"pods": pods})


def build_step_graph(costs: LayerCosts, *, overlap: bool = True,
                     pods: int = 1) -> TaskGraph:
    """Layer chain with per-layer collectives on the link.

    ``overlap=False`` — blocking collectives: layer l+1 waits for layer l's
    collective.  ``overlap=True`` — each collective only blocks the layer
    *after* the next (double-buffered prefetch), the paper's "input
    transfers overlap" behaviour mapped to the link.
    """
    g = TaskGraph()

    def add(name: str, kind: str, cost: float, deps: Sequence[int]) -> int:
        uid = g.new_uid()
        t = Task(uid=uid, name=name, devices=(kind,), costs={kind: cost},
                 creation_index=uid, meta={"role": "compute"})
        g.add_task(t, infer_deps=False)
        for d in deps:
            g.add_edge(d, uid)
        return uid

    dispatch = add("dispatch", "smp", 10e-6, [])
    prev_layer = dispatch
    prev_coll: Optional[int] = None
    prev_prev_coll: Optional[int] = None
    for l in range(costs.n_layers):
        deps = [prev_layer]
        gate = prev_coll if not overlap else prev_prev_coll
        if gate is not None:
            deps.append(gate)
        layer = add(f"layer{l}", "gpu", costs.layer_compute, deps)
        coll = None
        if costs.layer_collective > 0:
            coll = add(f"coll{l}", "nvlink", costs.layer_collective, [layer])
        prev_layer = layer
        prev_prev_coll = prev_coll
        prev_coll = coll

    head_deps = [prev_layer] + ([prev_coll] if prev_coll else [])
    head = add("head", "gpu", costs.head_compute, head_deps)
    if costs.head_collective > 0:
        head = add("head_coll", "nvlink", costs.head_collective, [head])
    if pods > 1 and costs.internode_collective > 0:
        add("grad_xpod", "internode", costs.internode_collective, [head])
    return g


@dataclasses.dataclass
class StepEstimate:
    arch: str
    shape: str
    variant: str
    makespan_s: float
    sim: SimResult
    costs: LayerCosts

    def summary(self) -> Dict[str, object]:
        d = self.sim.summary()
        d.update(arch=self.arch, shape=self.shape, variant=self.variant,
                 predicted_step_s=self.makespan_s)
        return d


def estimate_step(arch: str, shape: str, probe1: Mapping, probe2: Mapping,
                  full_layers: int, *, overlap: bool = True, pods: int = 1,
                  params: Optional[int] = None, hw: HW = H100,
                  variant: str = "", engine: str = "fast") -> StepEstimate:
    """``engine="fast"`` routes through the array-compiled simulator
    (bit-identical results); ``"reference"`` keeps the object engine."""
    costs = LayerCosts.from_probes(probe1, probe2, full_layers, hw,
                                   pods=pods, params=params)
    g = build_step_graph(costs, overlap=overlap, pods=pods)
    system = pod_chip_system(pods=pods)
    if engine == "fast":
        sim = simulate_fast(freeze_graph(g), system, "eft",
                            with_schedule=True)
    else:
        sim = simulate(g, system, policy="eft")
    return StepEstimate(arch=arch, shape=shape, variant=variant,
                        makespan_s=sim.makespan, sim=sim, costs=costs)


def codesign_sweep(candidates: Mapping[str, Tuple[Mapping, Mapping, int]],
                   arch: str, shape: str, **kw) -> List[StepEstimate]:
    """Rank candidates by predicted step time — the paper's co-design
    loop with "regenerate bitstream" replaced by "re-count"."""
    out = [estimate_step(arch, shape, p1, p2, nl, variant=name, **kw)
           for name, (p1, p2, nl) in candidates.items()]
    out.sort(key=lambda e: e.makespan_s)
    return out
