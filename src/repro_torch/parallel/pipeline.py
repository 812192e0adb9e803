"""Pipeline parallelism as a co-design candidate, evaluated through the
paper's estimator — the JAX package's ``repro/parallel/pipeline.py`` on
the port's own simulator.

Rather than hand-rolling a bubble-time formula, PP schedules are expressed
as *task graphs* and run through :mod:`repro_torch.core.simulator` — the
same machinery that schedules the Zynq accelerator tasks schedules
pipeline stages here (stages = device pools, microbatch fwd/bwd chunks =
tasks, P2P transfers = shared-resource tasks).  ``evaluate_pp`` returns the
simulated step time and bubble fraction for GPipe and 1F1B schedules.

``stage_slices`` also does the real thing: the JAX package splits its
layer-stacked leaves over the period axis; the port holds its layers in
order, so it splits a sequence of periods (or of layers, ``period`` of
them a period) into contiguous stage ranges, and :func:`staged_prefill`
runs a model's prefill stage by stage over microbatches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from ..core.devices import DevicePool, SharedResource, SystemConfig
from ..core.simulator import simulate
from ..core.taskgraph import Task, TaskGraph

# --------------------------------------------------------------------------
# Real stage partitioning (the layer sequence → per-stage slices)
# --------------------------------------------------------------------------


def stage_bounds(n_periods: int, n_stages: int) -> List[int]:
    """Stage ``i`` holds periods ``[b[i], b[i+1])``: ``round(i·L/S)`` with
    Python's ``round`` (half to even) as in JAX, so 5 periods over 2
    stages split 2 + 3."""
    return [round(i * n_periods / n_stages) for i in range(n_stages + 1)]


def stage_slices(seq: Sequence, n_stages: int, period: int = 1) -> List:
    """Split ``seq`` (the model's layers, ``period`` of them a period, or
    any sequence of periods) into ``n_stages`` contiguous slices of whole
    periods."""
    if len(seq) % period:
        raise ValueError(f"{len(seq)} layers are not whole periods of "
                         f"{period}")
    b = stage_bounds(len(seq) // period, n_stages)
    return [seq[b[i] * period:b[i + 1] * period] for i in range(n_stages)]


def staged_prefill(model, batch: Dict[str, torch.Tensor], max_len: int,
                   n_stages: int, n_micro: int
                   ) -> Tuple[torch.Tensor, list]:
    """``transformer.prefill`` run as a pipeline would: the batch split
    into ``n_micro`` microbatches along its rows, each through stage 0,
    then stage 1, … (each stage a :func:`stage_slices` range of periods);
    returns the same ``(last-position logits, cache)``, rows in order.
    For stacks of plain periods (no shared block, no encoder)."""
    from ..models import transformer as T
    cfg = model.cfg
    if cfg.shared_every or cfg.is_enc_dec:
        raise ValueError(f"{cfg.name}: staged_prefill takes a stack of "
                         f"plain periods (no shared block, no encoder)")
    stages = stage_slices(range(cfg.n_periods), n_stages)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"{b} rows do not split into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    logits, caches = [], []
    for m in range(n_micro):
        part = {k: v[m * mb:(m + 1) * mb] for k, v in batch.items()}
        x = T._embed_inputs(model, part)
        positions = T._positions(x.shape[0], x.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        cache: list = []
        for stage in stages:
            for p in stage:
                x, aux, c = T._period(model, p, x, aux, positions, None,
                                      None, None)
                cache += c
        t = x.shape[1]
        cache = [{k: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, max_len - t))
                  for k, a in c.items()} if "k" in c else c for c in cache]
        logits.append(T._logits(model, x[:, -1:]))
        caches.append(cache)
    return (torch.cat(logits), [
        {k: torch.cat([c[i][k] for c in caches]) for k in caches[0][i]}
        for i in range(len(caches[0]))])


# --------------------------------------------------------------------------
# Schedule → task graph
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPConfig:
    n_stages: int
    n_micro: int
    fwd_cost: float               # per stage per microbatch, seconds
    bwd_cost: float               # usually ≈ 2× fwd
    p2p_cost: float = 0.0         # activation send between stages
    schedule: str = "1f1b"        # gpipe | 1f1b


def pp_taskgraph(cfg: PPConfig) -> Tuple[TaskGraph, SystemConfig]:
    g = TaskGraph()

    def add(name, kind, cost, deps):
        uid = g.new_uid()
        g.add_task(Task(uid=uid, name=name, devices=(kind,),
                        costs={kind: cost}, creation_index=uid,
                        meta={"role": "compute"}), infer_deps=False)
        for d in deps:
            g.add_edge(d, uid)
        return uid

    S, M = cfg.n_stages, cfg.n_micro
    fwd: Dict[Tuple[int, int], int] = {}
    bwd: Dict[Tuple[int, int], int] = {}
    # forward lattice: fwd(s, m) needs fwd(s-1, m) (+ p2p)
    for m in range(M):
        for s in range(S):
            deps = []
            if s > 0:
                src = fwd[(s - 1, m)]
                if cfg.p2p_cost > 0:
                    src = add(f"p2p_f{s}_{m}", "link", cfg.p2p_cost, [src])
                deps.append(src)
            fwd[(s, m)] = add(f"fwd{s}_{m}", f"stage{s}", cfg.fwd_cost, deps)
    # backward lattice: bwd(s, m) needs bwd(s+1, m) and fwd(s, m)
    for m in range(M):
        for s in reversed(range(S)):
            deps = [fwd[(s, m)]]
            if s < S - 1:
                src = bwd[(s + 1, m)]
                if cfg.p2p_cost > 0:
                    src = add(f"p2p_b{s}_{m}", "link", cfg.p2p_cost, [src])
                deps.append(src)
            if cfg.schedule == "gpipe" and m == 0:
                deps += [fwd[(s2, M - 1)] for s2 in range(S)]  # flush first
            bwd[(s, m)] = add(f"bwd{s}_{m}", f"stage{s}", cfg.bwd_cost, deps)

    pools = [DevicePool(f"stage{s}", (f"stage{s}",), 1) for s in range(S)]
    shared = [SharedResource("link", max(S - 1, 1))]
    sysc = SystemConfig(name=f"pp{S}x{M}-{cfg.schedule}", pools=pools,
                        shared=shared, task_creation_cost=0.0)
    return g, sysc


@dataclasses.dataclass
class PPEstimate:
    schedule: str
    step_s: float
    ideal_s: float
    bubble_fraction: float


def evaluate_pp(cfg: PPConfig) -> PPEstimate:
    g, sysc = pp_taskgraph(cfg)
    sim = simulate(g, sysc, policy="availability")
    ideal = cfg.n_micro * (cfg.fwd_cost + cfg.bwd_cost)
    return PPEstimate(schedule=cfg.schedule, step_s=sim.makespan,
                      ideal_s=ideal,
                      bubble_fraction=1.0 - ideal / sim.makespan)
