"""The reference against the port on the CPU, the comparison's verdict on
a perturbed makespan, and the float32 control failing it."""
from __future__ import annotations

import copy
import json

import pytest

from portbench.tests.helpers import CONFIGS, ROOT


def inputs(name):
    from portbench import apps
    conf = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    return conf, apps.inputs(conf)


def port_spans(inp, space, engine, budget):
    from portbench import port
    from repro_torch.core.explore import Explorer
    kw = {"device": "cpu"} if engine == "torch" else {}
    reports = port.reports(inp["reports"])
    ex = Explorer(port.trace(inp["events"]), reports, engine=engine,
                  smp_seconds_fn=port.smp_seconds_fn(inp["smp"]),
                  budget=budget, **kw)
    res = ex.explore(port.candidates(space, inp["system"], reports))
    assert all(o.status == "ok" for o in res.outcomes)
    return {o.name: o.makespan_s for o in res.outcomes}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("engine", ["reference", "torch"])
def test_reference_equals_the_port(name, engine):
    from portbench.reference.sim import Reference
    conf, inp = inputs(name)
    got = port_spans(inp, inp["design_space"], engine, conf["fabric_budget"])
    ref = Reference(inp)
    for c in inp["design_space"]:
        assert got[c["name"]] == ref.makespan(c), c["name"]


def answers_of(inp):
    from portbench.reference.compare import control_answers
    from portbench.reference.sim import Reference
    return control_answers([{"expected": inp["design_space"]}],
                           Reference(inp))


@pytest.mark.parametrize("name", CONFIGS)
def test_judge_flags_a_perturbed_makespan(name):
    from portbench.reference.compare import judge, verdict
    from portbench.reference.sim import Reference
    conf, inp = inputs(name)
    ref = Reference(inp)
    good = answers_of(inp)
    nums = judge(good, ref, conf["makespan_rtol"])
    assert nums == {"gap": 0.0, "rank_errors": 0.0, "missing": 0.0}
    assert verdict(nums, conf["limits"])
    bad = copy.deepcopy(good)
    n = bad[0]["ranked"][0]
    bad[0]["makespans"][n] *= 1 + 10 * conf["limits"]["gap"]
    assert not verdict(judge(bad, ref, conf["makespan_rtol"]),
                       conf["limits"])
    gone = copy.deepcopy(good)
    del gone[0]["makespans"][n]
    assert judge(gone, ref, conf["makespan_rtol"])["missing"] == 1


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_control_fails(name):
    """The control (the reference in float32 in the program's place) at
    the cells' own design spaces comes out not correct."""
    from portbench.reference.compare import control_answers, judge, verdict
    from portbench.reference.sim import Reference, reference_f32
    conf, inp = inputs(name)
    ref = Reference(inp)
    ctl = control_answers([{"expected": inp["design_space"]}],
                          reference_f32(inp))
    nums = judge(ctl, ref, conf["makespan_rtol"])
    assert not verdict(nums, conf["limits"]), nums
