"""The tiled Cholesky factorisation of the paper's Fig. 4.

A frozen copy of ``src/repro_torch/apps/cholesky.py`` at commit e803567
(``chol_ll``'s left-looking loop nest, each kernel's dependences and work
model, and the accelerator kinds of the six Fig. 9 designs of
``candidates``), with the design space widened to every combination of
those kinds that fits the fabric (the check of
``core/hlsreport.py::fits``).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping

from . import event


def events(config: Mapping) -> List[Dict]:
    n, bs = config["n"], config["bs"]
    nb = n // bs
    nbytes = bs * bs * 8
    b = float(bs)
    work = {"dsyrk": b ** 3 + b ** 2, "dpotrf": b ** 3 / 3.0,
            "dgemm": 2.0 * b ** 3, "dtrsm": b ** 3 + b ** 2}
    smp = config["smp"]
    out: List[Dict] = []

    def task(name, acc, devices):
        out.append(event(len(out), name, acc, devices, work[name], smp))

    fs = ("fpga", "smp")
    for k in range(nb):
        for j in range(k):
            task("dsyrk", [(("A", j, k), "in", nbytes),
                           (("A", k, k), "inout", nbytes)], fs)
        task("dpotrf", [(("A", k, k), "inout", nbytes)], ("smp",))
        for i in range(k + 1, nb):
            for j in range(k):
                task("dgemm", [(("A", j, i), "in", nbytes),
                               (("A", j, k), "in", nbytes),
                               (("A", k, i), "inout", nbytes)], fs)
        for i in range(k + 1, nb):
            task("dtrsm", [(("A", k, k), "in", nbytes),
                           (("A", k, i), "inout", nbytes)], fs)
    return out


def design_space(config: Mapping) -> List[Dict]:
    """Every multiset of the configuration's accelerator kinds (one a
    report; each serves its report's kernel) whose summed resources fit
    ``config["fabric_budget"]``, once per entry of ``config["smp_axis"]``:
    with the SMP also eligible for the accelerated kernels, or not.  A
    kernel that no kind of the design serves runs on the SMP, ``dpotrf``
    only there.  Each candidate carries its ``fabric`` (kind -> slots)."""
    budget = config["fabric_budget"]
    reports = config["reports"]
    kinds = [r["device_kind"] for r in reports]
    serves = {r["device_kind"]: r["kernel"] for r in reports}
    use = {r["device_kind"]: r["resources"] for r in reports}

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
            elig = {"dpotrf": ["smp"]}
            for kernel in ("dgemm", "dsyrk", "dtrsm"):
                mine = [k for k in counts if serves[k] == kernel]
                elig[kernel] = mine + ["smp"] if smp or not mine else mine
            out.append({"name": name + ("+smp" if smp else ""),
                        "accelerators": dict(counts),
                        "eligibility": elig, "fabric": dict(counts)})
    return out
