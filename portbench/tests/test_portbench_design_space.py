"""The configuration's design space is every design of its accelerator
kinds that fits the fabric, the paper's six among them, and the port's
own feasibility filter agrees with it."""
from __future__ import annotations

import itertools
import json

import pytest

from portbench.tests.helpers import CONFIGS, ROOT

#: The six Fig. 9 designs (``apps/cholesky.py::candidates``), as slots by
#: kind.
FIG9 = {"FR-dgemm": {"fpga:dgemmFR": 1}, "FR-dsyrk": {"fpga:dsyrkFR": 1},
        "FR-dtrsm": {"fpga:dtrsmFR": 1},
        "dgemm+dgemm": {"fpga:dgemm64": 2},
        "dgemm+dsyrk": {"fpga:dgemm64": 1, "fpga:dsyrk64": 1},
        "dgemm+dtrsm": {"fpga:dgemm64": 1, "fpga:dtrsm64": 1}}


def config(name="cholesky512_bs64"):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def space(conf):
    from portbench import apps
    return apps.load(conf).design_space(conf)


def usage(conf, counts):
    res = {r["device_kind"]: r["resources"] for r in conf["reports"]}
    return {k: sum(res[kind].get(k, 0.0) * n for kind, n in counts.items())
            for k in conf["fabric_budget"]}


def fits(conf, counts):
    use = usage(conf, counts)
    return all(use[k] <= cap for k, cap in conf["fabric_budget"].items())


@pytest.mark.parametrize("name", CONFIGS)
def test_every_candidate_fits_the_fabric(name):
    conf = config(name)
    for c in space(conf):
        assert c["fabric"] == c["accelerators"] and fits(conf, c["fabric"])


@pytest.mark.parametrize("name", CONFIGS)
def test_every_combination_left_out_overflows(name):
    conf = config(name)
    kinds = [r["device_kind"] for r in conf["reports"]]
    got = {tuple(sorted(c["fabric"].items())) for c in space(conf)}
    for combo in itertools.product(range(6), repeat=len(kinds)):
        counts = {k: n for k, n in zip(kinds, combo) if n}
        if counts and tuple(sorted(counts.items())) not in got:
            assert not fits(conf, counts), counts


def test_the_space_counts_37_designs_twice():
    conf = config()
    s = space(conf)
    assert len(s) == 74 == 2 * len({tuple(sorted(c["fabric"].items()))
                                    for c in s})
    assert len({c["name"] for c in s}) == len(s)


@pytest.mark.parametrize("design", sorted(FIG9))
def test_the_papers_designs_are_in_the_space(design):
    s = space(config())
    want = FIG9[design]
    hits = [c for c in s if c["fabric"] == want]
    assert len(hits) == 2
    with_smp = [c for c in hits if c["name"].endswith("+smp")]
    assert len(with_smp) == 1
    for kernel, kinds in with_smp[0]["eligibility"].items():
        assert kinds[-1] == "smp", kernel


@pytest.mark.parametrize("smp", [True, False])
def test_eligibility_follows_the_smp_axis(smp):
    conf = dict(config(), smp_axis=[smp])
    for c in space(conf):
        assert c["eligibility"]["dpotrf"] == ["smp"]
        served = {r["kernel"] for r in conf["reports"]
                  if r["device_kind"] in c["fabric"]}
        for kernel in ("dgemm", "dsyrk", "dtrsm"):
            kinds = c["eligibility"][kernel]
            if kernel not in served:
                assert kinds == ["smp"]
            else:
                assert ("smp" in kinds) is smp and len(kinds) >= 1


@pytest.mark.parametrize("counts", [{"fpga:dgemm64": 5},
                                    {"fpga:dgemmFR": 1, "fpga:dsyrk64": 1}],
                         ids=["five_dgemm64", "fr_and_dsyrk64"])
def test_the_ports_filter_rejects_what_overflows(counts):
    """A design over the budget, carried with its fabric, comes back
    ``infeasible`` from the port's Explorer, and the benchmark's own
    arithmetic agrees."""
    from portbench import apps, port
    from repro_torch.core.explore import Explorer
    conf = config()
    assert not fits(conf, counts)
    inp = apps.inputs(conf)
    reports = port.reports(inp["reports"])
    elig = {"dpotrf": ["smp"], "dgemm": ["smp"], "dsyrk": ["smp"],
            "dtrsm": ["smp"]}
    cand = {"name": "over", "accelerators": counts, "eligibility": elig,
            "fabric": counts}
    ex = Explorer(port.trace(inp["events"]), reports, engine="reference",
                  smp_seconds_fn=port.smp_seconds_fn(inp["smp"]),
                  budget=conf["fabric_budget"])
    res = ex.explore(port.candidates([cand], inp["system"], reports))
    assert [o.status for o in res.outcomes] == ["infeasible"]
