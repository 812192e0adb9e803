"""The blocked matrix multiply of the paper's Fig. 1.

A frozen copy of ``src/repro_torch/apps/matmul.py`` at commit 6950fd3
(``matmul``'s loop nest and ``mxm_block``'s accesses and work model), with
a design space of every combination of the configuration's accelerator
kinds that fits the fabric (the check of ``core/hlsreport.py::fits``),
each with and without the SMP (the paper's ``+smp`` axis).

The deployment needs a port whose torch engine steps lanes through their
own heap orders on the card (:func:`require_own_order_lanes`): the one
import of the program outside ``port.py`` and the drivers.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping

from . import event

#: Bytes of one element of the matrices, by the configuration's dtype.
ITEMSIZE = {"float32": 4, "float64": 8}


def require_own_order_lanes() -> None:
    """Raise unless the port counts own-order lanes
    (``BatchStats.own_order_lanes``).

    The graph is 64 independent chains of 8 blocks, so each slot count
    of a design dispatches in an order of its own, and lanes share an
    order only once the slots outnumber the graph's width.  A port that
    steps lanes only through shared, replayed orders finishes most of
    this design space on the host's exact path: its sweeps last some
    3 s on an H100 host, of which a fraction on the card, so a traced
    run's profiled slice (``trace_at`` 1 s, ``trace_seconds`` 0.5 s of
    the ``sweep_warm`` mix) can hold no device work, and the cell
    cannot report.  Such a port stops here, before set-up."""
    import dataclasses

    from repro_torch.core.replay import BatchStats
    if "own_order_lanes" not in {f.name
                                 for f in dataclasses.fields(BatchStats)}:
        raise RuntimeError(
            "matmul: this deployment needs own-order lanes in the torch "
            "engine (BatchStats.own_order_lanes); this port has none")


def events(config: Mapping) -> List[Dict]:
    """One ``mxm_block`` (``C[i][j] += A[i][k] @ B[k][j]``, in ``A``,
    ``B``, inout ``C``) per ``(k, i, j)``, ``k`` outermost.  Checks
    :func:`require_own_order_lanes` first."""
    require_own_order_lanes()
    n, bs = config["n"], config["bs"]
    nb = n // bs
    nbytes = bs * bs * ITEMSIZE[config["dtype"]]
    work = 2.0 * bs ** 3
    out: List[Dict] = []
    for k in range(nb):
        for i in range(nb):
            for j in range(nb):
                out.append(event(len(out), "mxm_block",
                                 [(("A", i, k), "in", nbytes),
                                  (("B", k, j), "in", nbytes),
                                  (("C", i, j), "inout", nbytes)],
                                 ("fpga", "smp"), work, config["smp"]))
    return out


def design_space(config: Mapping) -> List[Dict]:
    """Every multiset of the configuration's accelerator kinds (all serve
    ``mxm_block``) whose summed resources fit ``config["fabric_budget"]``,
    once per entry of ``config["smp_axis"]``: with the SMP also eligible,
    or FPGA only.  Each candidate carries its ``fabric`` (kind -> slots)."""
    budget = config["fabric_budget"]
    kinds = [r["device_kind"] for r in config["reports"]]
    use = {r["device_kind"]: r["resources"] for r in config["reports"]}

    def fits(counts) -> bool:
        return all(sum(use[k].get(res, 0.0) * n for k, n in counts.items())
                   <= cap for res, cap in budget.items())

    most = {}
    for k in kinds:
        n = 0
        while fits({k: n + 1}):
            n += 1
        most[k] = n
    out = []
    for combo in itertools.product(*(range(most[k] + 1) for k in kinds)):
        counts = {k: n for k, n in zip(kinds, combo) if n}
        if not counts or not fits(counts):
            continue
        name = "+".join(f"{k.split(':', 1)[1]}x{n}" for k, n in counts.items())
        for smp in config["smp_axis"]:
            elig = list(counts) + ["smp"] if smp else list(counts)
            out.append({"name": name + ("+smp" if smp else ""),
                        "accelerators": dict(counts),
                        "eligibility": {"mxm_block": elig},
                        "fabric": dict(counts)})
    return out
