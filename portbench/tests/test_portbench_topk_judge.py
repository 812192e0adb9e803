"""The judgment of top-k answers (``compare.judge`` on answers that carry
``top_k`` and ``pruned``), and the ``sweep`` driver's ``prune`` key.

An answer without ``pruned`` is judged as before this branch existed:
``judge_unpruned`` below is a frozen copy of the judgment as it stood,
held equal to ``judge`` on seeded random answers."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.reference.compare import control_answers, judge, verdict
from portbench.tests.helpers import cpu_run, small_cell

RTOL = 1e-6
LIMITS = {"gap": 1e-6, "rank_errors": 0, "missing": 0}
CELL = "cholesky512_sweep_top5_prune"


def judge_unpruned(answers, ref, rtol):
    """A frozen copy of ``judge`` before top-k answers were judged."""
    gap, rank_errors, missing = 0.0, 0, 0
    for a in answers:
        names = [c["name"] for c in a["expected"]]
        if not a.get("ok"):
            missing += len(names)
            continue
        want = {c["name"]: ref.makespan(c) for c in a["expected"]}
        got = a["makespans"]
        missing += sum(1 for n in names if n not in got)
        for n in names:
            if n in got:
                gap = max(gap, abs(got[n] - want[n]) / want[n])
        ref_rank = sorted(names, key=lambda n: want[n])
        for x, y in zip(a["ranked"], ref_rank):
            if x != y and x in want and \
                    abs(want[x] - want[y]) > rtol * max(abs(want[x]),
                                                        abs(want[y])):
                rank_errors += 1
    return {"gap": gap, "rank_errors": float(rank_errors),
            "missing": float(missing)}


class Ref:
    """A reference that reads each candidate's makespan off the
    candidate."""

    def makespan(self, cand):
        return cand["span"]


def cands(spans):
    return [{"name": f"c{i}", "span": float(s)} for i, s in enumerate(spans)]


def answer(expected, ranked, pruned=None, top_k=None, scale=None):
    """An ok answer ranking ``ranked`` (names) with the reference's
    makespans (times ``scale[name]`` where given)."""
    span = {c["name"]: c["span"] for c in expected}
    scale = scale or {}
    a = {"ok": True, "expected": expected, "ranked": list(ranked),
         "makespans": {n: span[n] * scale.get(n, 1.0) for n in ranked}}
    if pruned is not None:
        a.update(pruned=list(pruned), top_k=top_k)
    return a


def random_answer(rng):
    """An unpruned answer with ties, perturbed makespans, shuffled
    stretches of the ranking, unranked candidates, or no answer."""
    n = int(rng.integers(1, 30))
    base = rng.choice([1.0, 2.0, 3.0], n) if rng.random() < 0.3 \
        else rng.uniform(1e-3, 1.0, n)
    expected = cands(base * (1 + rng.choice([0, 1e-7, 1e-3], n)))
    if rng.random() < 0.1:
        return {"ok": False, "expected": expected}
    names = [c["name"] for c in expected]
    ranked = [names[i] for i in np.argsort(base, kind="stable")]
    if rng.random() < 0.5:
        i = int(rng.integers(0, n))
        j = min(n, i + int(rng.integers(1, 5)))
        ranked[i:j] = list(rng.permutation(ranked[i:j]))
    if rng.random() < 0.3:
        ranked = [x for x in ranked if rng.random() > 0.2]
    scale = {x: 1 + float(rng.choice([0.0, 1e-9, 1e-5])) for x in ranked}
    return answer(expected, ranked, scale=scale)


@pytest.mark.parametrize("seed", range(8))
def test_unpruned_answers_are_judged_as_before(seed):
    rng = np.random.default_rng(seed)
    answers = [random_answer(rng) for _ in range(12)]
    assert judge(answers, Ref(), RTOL) == judge_unpruned(answers, Ref(),
                                                         RTOL)


SPANS = [5.0, 1.0, 4.0, 2.0, 3.0, 6.0, 7.0, 8.0]    # c1 c3 c4 c2 c0 c5 ...
TOP3 = ["c1", "c3", "c4"]


def test_correct_pruned_answer():
    ex = cands(SPANS)
    a = answer(ex, TOP3 + ["c0"], pruned=["c2", "c5", "c6", "c7"], top_k=3)
    assert judge([a], Ref(), RTOL) == {"gap": 0.0, "rank_errors": 0.0,
                                       "missing": 0.0}


def test_retired_top_k_member_is_missing():
    ex = cands(SPANS)
    a = answer(ex, ["c1", "c4", "c2"], pruned=["c3", "c0", "c5", "c6",
                                               "c7"], top_k=3)
    got = judge([a], Ref(), RTOL)
    assert got["missing"] == 1.0 and not verdict(got, LIMITS)


def test_neither_ranked_nor_pruned_is_missing():
    ex = cands(SPANS)
    a = answer(ex, TOP3, pruned=["c0", "c2", "c5", "c6"], top_k=3)
    got = judge([a], Ref(), RTOL)
    assert got["missing"] == 1.0 and got["rank_errors"] == 0.0


def test_swapped_pair_inside_the_top_k_is_a_rank_error():
    ex = cands(SPANS)
    a = answer(ex, ["c3", "c1", "c4"], pruned=["c0", "c2", "c5", "c6",
                                               "c7"], top_k=3)
    assert judge([a], Ref(), RTOL)["rank_errors"] == 2.0


def test_survivor_past_the_kth_place_is_no_error():
    """A lane that survived retirement is ranked after the k-th place,
    here out of the reference's order past it: no error."""
    ex = cands(SPANS)
    a = answer(ex, TOP3 + ["c5", "c0"], pruned=["c2", "c6", "c7"], top_k=3)
    assert judge([a], Ref(), RTOL) == {"gap": 0.0, "rank_errors": 0.0,
                                       "missing": 0.0}


def test_tie_at_the_kth_best_may_be_pruned():
    ex = cands([1.0, 2.0, 3.0, 3.0 * (1 + 1e-7), 9.0])
    a = answer(ex, ["c0", "c1", "c2"], pruned=["c3", "c4"], top_k=3)
    b = answer(ex, ["c0", "c1", "c3"], pruned=["c2", "c4"], top_k=3)
    for x in (a, b):
        assert judge([x], Ref(), RTOL) == {"gap": 0.0, "rank_errors": 0.0,
                                           "missing": 0.0}
    # apart by more than a tie, the k-th best pruned and the next ranked
    # in its place is a rank error
    c = answer(cands([1.0, 2.0, 3.0, 3.0 * (1 + 1e-5), 9.0]),
               ["c0", "c1", "c3"], pruned=["c2", "c4"], top_k=3)
    got = judge([c], Ref(), RTOL)
    assert got["rank_errors"] == 1.0 and not verdict(got, LIMITS)


def test_ranked_makespan_gap_counts_in_a_pruned_answer():
    ex = cands(SPANS)
    a = answer(ex, TOP3 + ["c0"], pruned=["c2", "c5", "c6", "c7"], top_k=3,
               scale={"c0": 1 + 1e-4})
    assert judge([a], Ref(), RTOL)["gap"] == pytest.approx(1e-4)


def test_control_of_a_pruned_answer_is_a_top_k_answer():
    ex = cands(SPANS)
    a = answer(ex, TOP3, pruned=["c0", "c2", "c5", "c6", "c7"], top_k=3)
    (ctl,) = control_answers([a], Ref())
    assert ctl["top_k"] == 3 and ctl["pruned"] == []
    assert len(ctl["ranked"]) == len(ex)
    assert judge([ctl], Ref(), RTOL) == {"gap": 0.0, "rank_errors": 0.0,
                                         "missing": 0.0}
    (plain,) = control_answers([answer(ex, TOP3)], Ref())
    assert "pruned" not in plain and "top_k" not in plain


@pytest.fixture(scope="module")
def prune_ctx():
    """The pruned top-k cell's driver set up on the CPU (one warm-up
    sweep)."""
    from portbench import harness, registry
    cell = small_cell(CELL)
    ctx = harness.context(cell, 2 ** 31 + 5, "cpu")
    drv = registry.driver(ctx.traffic)
    drv.setup(ctx)
    yield ctx, drv
    drv.close(ctx)


def test_cpu_prune_sweep_is_judged_correct(prune_ctx):
    from portbench.reference.sim import Reference
    ctx, drv = prune_ctx
    order = [int(i) for i in ctx.rng.permutation(len(ctx.cands))]
    a = drv.sweep(ctx, order, 0.0)
    assert a["ok"], a["error"]
    assert a["top_k"] == 5 and a["pruned"]
    assert len(a["ranked"]) + len(a["pruned"]) == len(order)
    numbers = judge([a], Reference(ctx.inputs), ctx.config["makespan_rtol"])
    assert verdict(numbers, ctx.config["limits"]), numbers


def test_cpu_sweep_without_prune_has_no_pruned_key(prune_ctx):
    from portbench.reference.sim import Reference
    ctx, drv = prune_ctx
    traffic = ctx.traffic
    ctx.traffic = {k: v for k, v in traffic.items() if k != "prune"}
    try:
        order = [int(i) for i in ctx.rng.permutation(len(ctx.cands))]
        a = drv.sweep(ctx, order, 0.0)
    finally:
        ctx.traffic = traffic
    assert a["ok"], a["error"]
    assert "pruned" not in a and "top_k" not in a
    assert len(a["ranked"]) == len(order)
    numbers = judge([a], Reference(ctx.inputs), ctx.config["makespan_rtol"])
    assert verdict(numbers, ctx.config["limits"]), numbers


def test_retired_top_k_member_fails_the_run(monkeypatch):
    """A planted fault in the program: each sweep reports its best
    candidate pruned.  The run is not correct, by ``missing``."""
    import dataclasses

    from repro_torch.core.explore import Explorer
    inner = Explorer.explore

    def retire_best(self, candidates, **kwargs):
        res = inner(self, candidates, **kwargs)
        best = res.ranked[0].name
        res.outcomes = [dataclasses.replace(o, status="pruned")
                        if o.name == best else o for o in res.outcomes]
        return res

    monkeypatch.setattr(Explorer, "explore", retire_best)
    r = cpu_run(small_cell(CELL), seed=79)
    assert not r["correct"]
    miss = r["checks"]["missing"]
    assert miss["value"] > miss["limit"] and miss["value"] == r["attempted"]
