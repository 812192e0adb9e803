"""Closed-loop sweeps from one client: back-to-back ``Explorer.explore``
calls, each a fresh ``Explorer(engine="torch")`` ranking the whole design
space of the configuration in an order drawn from the seed.

Traffic keys: ``library`` (``"warm"``: every sweep shares one order
library, filled in set-up; ``"cold"``: each sweep starts from an empty
one), ``top_k``, ``prune`` (false where absent: ``explore(prune=True)``,
the branch-and-bound top-k sweep), ``warmup_sweeps``, and
``min_lockstep_share``: the percentage of a sweep's candidates that the
replay protocol has to finish in lockstep on the card
(``batch_stats.lockstep_lanes``).  A sweep below it is failed: the cell
measures the card's step loop, and lanes moved to the host's exact path
would no longer be measured there.  A sweep with an outcome neither
``ok`` nor, under ``prune``, ``pruned`` is failed too; a pruned sweep's
answer carries ``top_k`` and the names it reported ``pruned``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from portbench import port


def setup(ctx) -> None:
    from repro_torch.core.replay import ReplayLibrary
    inp = ctx.inputs
    ctx.trace = port.trace(inp["events"])
    ctx.reports = port.reports(inp["reports"])
    ctx.space = inp["design_space"]
    ctx.cands = port.candidates(ctx.space, inp["system"], ctx.reports)
    ctx.smp_fn = port.smp_seconds_fn(inp["smp"])
    ctx.library = ReplayLibrary() if ctx.traffic["library"] == "warm" \
        else None
    for _ in range(ctx.traffic["warmup_sweeps"]):
        # the warm-up discovers the orders: it is held to no lockstep share
        ans = sweep(ctx, list(range(len(ctx.cands))), 0.0, min_share=0.0)
        if not ans["ok"]:
            raise RuntimeError(f"warm-up sweep failed: {ans['error']}")


def sweep(ctx, order: List[int], t_origin: float,
          min_share: Optional[float] = None) -> Dict:
    from repro_torch.core.explore import Explorer
    from repro_torch.core.replay import ReplayLibrary
    lib = ctx.library if ctx.library is not None else ReplayLibrary()
    t0 = time.perf_counter()
    ans = {"t0": t0 - t_origin, "expected": [ctx.space[i] for i in order],
           "ok": False, "error": None, "makespans": {}, "ranked": []}
    try:
        ex = Explorer(ctx.trace, ctx.reports, engine="torch",
                      device=ctx.device, smp_seconds_fn=ctx.smp_fn,
                      order_library=lib,
                      budget=ctx.config["fabric_budget"])
        prune = ctx.traffic.get("prune", False)
        res = ex.explore([ctx.cands[i] for i in order],
                         top_k=ctx.traffic["top_k"], prune=prune)
        ranked = res.ranked
        ans["makespans"] = {o.name: o.makespan_s for o in ranked}
        ans["ranked"] = [o.name for o in ranked]
        ans["batch_stats"] = ex.batch_stats.as_dict()
        if prune:
            ans["top_k"], ans["pruned"] = ctx.traffic["top_k"], res.pruned
        done = ("ok", "pruned") if prune else ("ok",)
        bad = [o.name for o in res.outcomes if o.status not in done]
        share = 100.0 * ans["batch_stats"]["lockstep_lanes"] / len(order)
        ans["ok"] = not bad and ex.engine == "torch" \
            and share >= (ctx.traffic["min_lockstep_share"]
                          if min_share is None else min_share)
        if not ans["ok"]:
            ans["error"] = (f"not ranked: {bad[:5]}, engine {ex.engine}, "
                            f"{share:.1f} % of the lanes in lockstep")
    except Exception as exc:    # noqa: BLE001 — a failed sweep is counted
        ans["error"] = f"{type(exc).__name__}: {exc}"
    ctx.synchronize()
    ans["t1"] = time.perf_counter() - t_origin
    return ans


def window(ctx, seconds: float, t0: float) -> List[Dict]:
    answers = []
    while time.perf_counter() - t0 < seconds:
        order = [int(i) for i in ctx.rng.permutation(len(ctx.cands))]
        answers.append(sweep(ctx, order, t0))
    return answers


def close(ctx) -> None:
    ctx.library = ctx.cands = ctx.trace = None
