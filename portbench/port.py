"""The program's side of a run: the port's objects built from the
benchmark's plain inputs, and the port's counters.

Only this module and the drivers import ``repro_torch``; the reference
(:mod:`portbench.reference`) never does.
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Sequence


def trace(events: Sequence[Mapping]):
    from repro_torch.core.trace import Trace, TraceEvent
    return Trace(events=[TraceEvent.from_json(json.dumps(e))
                         for e in events])


def reports(entries: Sequence[Mapping]) -> Dict:
    from repro_torch.core.hlsreport import KernelReport
    return {(r["kernel"], r["device_kind"]):
            KernelReport(kernel=r["kernel"], device_kind=r["device_kind"],
                         compute_s=r["compute_s"], dma_in_s=r["dma_in_s"],
                         dma_out_s=r["dma_out_s"],
                         resources=dict(r["resources"]))
            for r in entries}


def candidates(space: Sequence[Mapping], system: Mapping,
               reports_by_key: Mapping) -> List:
    """The port's candidates; each carries its ``fabric`` as (report of
    the kind, slots), so that the Explorer's feasibility filter runs."""
    from repro_torch.core.augment import Eligibility
    from repro_torch.core.devices import zynq_system
    from repro_torch.core.explore import Candidate
    by_kind = {kind: rep for (_, kind), rep in reports_by_key.items()}
    return [Candidate(
        name=c["name"],
        system=zynq_system(c["name"], dict(c["accelerators"]),
                           smp_cores=system["smp_cores"],
                           task_creation_cost=system["task_creation_cost"],
                           dma_submit_cost=system["dma_submit_cost"]),
        eligibility=Eligibility({k: tuple(v) for k, v
                                 in c["eligibility"].items()}),
        fabric=[(by_kind[k], n) for k, n in c["fabric"].items()])
            for c in space]


def smp_seconds_fn(smp: Mapping):
    """The configuration's SMP model as the Explorer's
    ``smp_seconds_fn``: each event's work at the target's rate (the
    examples pass ``a9_smp_seconds``, the same arithmetic)."""
    g = smp["gflops"]

    def fn(event) -> float:
        return event.flops / (g * 1e9)

    return fn


def counters() -> Dict:
    """The port's own counters: step-commit launches (credited at every
    graph replay) in all and by ``(P, S, B)``, and the process-wide
    compile cache's counts."""
    from repro_torch.core import torchsim
    from repro_torch.kernels import lockstep_step as ls
    with ls.COUNT_LOCK:
        launches, shapes = ls.LAUNCHES, dict(ls.SHAPES)
    return {"launches": launches, "shapes": shapes,
            "cache": torchsim._DEFAULT_CACHE.as_dict()}


def counters_delta(before: Mapping, after: Mapping) -> Dict:
    shapes = {k: n - before["shapes"].get(k, 0)
              for k, n in after["shapes"].items()}
    return {"launches": after["launches"] - before["launches"],
            "shapes": {k: n for k, n in shapes.items() if n},
            "cache": {k: after["cache"][k] - before["cache"][k]
                      for k in after["cache"]}}
