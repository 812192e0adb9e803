"""The port's sweep service against the JAX package's.

``repro_torch.serve.sweepd`` mirrors ``tests/test_sweepd.py`` case by
case on the CPU (``device="cpu"``): protocol validation, admission
control, deadline propagation, cross-request coalescing, the engine
circuit breaker, HTTP round trips and concurrent DiskCache writers.  On
the same request bodies the port's ``batch`` answers equal the
reference service's (``top``, ``best`` and the Pareto fields), and its
``torch`` answers are ``rankings_equivalent`` to ``batch`` at the torch
engine's tier.  Where the reference meets two threads inside a timed
window, the port's copies meet them by events.  The ``gpu`` cases serve
torch requests on the card and decide inside the test whether one exists.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path

import pytest
import torch

from repro.serve.sweepd import SweepService as RefSweepService

from repro_torch.core.diskcache import DiskCache
from repro_torch.core.replay import TORCH_RTOL, rankings_equivalent
from repro_torch.kernels import lockstep_step
from repro_torch.serve import coalesce as coalesce_mod
from repro_torch.serve import sweepd as sweepd_mod
from repro_torch.serve.coalesce import Coalescer
from repro_torch.serve.protocol import (ProtocolError, SweepRequest,
                                        get_json, parse_accs, post_json)
from repro_torch.serve.sweepd import CircuitBreaker, SweepService, serve
from repro_torch.core import torchsim
from repro_torch.testing import faults, synth

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 30.0           # bound on every wait for another thread


def body(**kw):
    doc = {"trace": "synth:24", "engine": "batch", "top_k": 3}
    doc.update(kw)
    return json.dumps(doc)


def cpu_service(**kw):
    kw.setdefault("device", "cpu")
    return SweepService(**kw)


def ranked(doc):
    return [t["name"] for t in doc["top"]]


def assert_equivalent(doc, want):
    """``doc`` (a torch answer) ranks as ``want`` (a batch answer) does at
    the torch engine's tier, with the same best."""
    spans = {t["name"]: t["makespan_s"] for t in want["top"]}
    assert doc["best"] == want["best"]
    assert rankings_equivalent(ranked(doc), ranked(want), spans, TORCH_RTOL)


def wait_until(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def inline_body(n=16, **kw):
    """A synth trace sent inline, events and reports as a client sends a
    file trace."""
    import dataclasses
    events = [json.loads(e.to_json()) for e in synth.synth_trace(n).events]
    reports = [dataclasses.asdict(r) for r in synth.synth_reports().values()]
    return body(trace="inline", events=events, reports=reports, **kw)


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [
    "not json at all",
    json.dumps(["a", "list"]),
    body(engine="gpu"),
    body(engine="jax"),                     # the port has no jax engine
    body(policy="fifo"),
    body(trace="trace.jsonl"),              # server takes no paths
    body(trace="synth:nope"),
    body(trace="synth:0"),
    body(trace="inline"),                   # inline needs events
    body(accs="0"),
    body(accs="1-99999999999"),             # OOM lever: capped pre-range
    body(accs="2048"),                      # above MAX_ACC_SLOTS
    body(accs="5,1-99999999999"),
    body(top_k=0),
    body(budget_s=-1),
    body(budget_s="soon"),
    body(candidate_timeout_s=0),
    body(surprise_field=1),
    body(device="cuda"),                    # the device is the server's
    body(objectives="area_mm2"),            # must be a list
    body(objectives=["nope"]),              # unknown axis
    body(objectives=[1, 2]),
    body(budgets={"bogus": 1.0}),           # unknown budget axis
    body(budgets={"power_w": -1}),          # no negative budgets
    body(budgets={"area_mm2": 0}),
    body(budgets={"energy_j": "lots"}),
    body(budgets=["power_w"]),              # must be a mapping
])
def test_request_validation_rejects(raw):
    with pytest.raises(ProtocolError):
        SweepRequest.from_json(raw)


def test_request_defaults_and_parse():
    req = SweepRequest.from_json(body())
    assert (req.engine, req.policy, req.top_k) == ("batch",
                                                   "availability", 3)
    assert req.budget_s > 0 and req.smp
    assert parse_accs(req.accs) == list(range(1, 9))
    trace, reports, cands = req.materialize()
    assert len(cands) == 16 and len(trace.events) == 24 and reports
    # a body without an engine means batch, as on the reference's server
    assert SweepRequest.from_json('{"trace": "synth:8"}').engine == "batch"


@pytest.mark.parametrize("engine", ["batch", "torch"])
def test_bad_request_is_400_not_500(engine):
    svc = cpu_service()
    status, doc = svc.submit(b'{"trace": "synth:8", "engine": "warp"}')
    assert status == 400 and "error" in doc
    # the server survives and still serves
    status, doc = svc.submit(body(trace="synth:8", engine=engine))
    assert status == 200 and doc["engine_final"] == engine


# ---------------------------------------------------------------------------
# Service vs the reference service and the one-shot CLI
# ---------------------------------------------------------------------------


REF_BODIES = {
    "scalar": body(),
    "eft_prune": body(policy="eft", prune=True, accs="1-6"),
    "pareto": body(objectives=["area_mm2", "energy_j"],
                   budgets={"power_w": 5.0}),
    "inline": inline_body(20),
}
PARETO_KEYS = ("objectives", "budgets", "frontier", "dominated")


@pytest.mark.parametrize("name", sorted(REF_BODIES))
def test_batch_answers_equal_the_reference_service(name):
    raw = REF_BODIES[name]
    status, doc = cpu_service(coalesce_window=0.0).submit(raw)
    ref_status, ref = RefSweepService(coalesce_window=0.0).submit(raw)
    assert status == ref_status == 200
    assert doc["top"] == ref["top"] and doc["best"] == ref["best"]
    assert doc["infeasible"] == ref["infeasible"]
    assert doc["pruned"] == ref["pruned"]
    for key in PARETO_KEYS:
        assert (key in doc) == (key in ref), key
        if key in ref:
            assert doc[key] == ref[key], key
    assert doc["engine_final"] == doc["engine_granted"] == "batch"


@pytest.mark.parametrize("name", ["scalar", "eft_prune", "inline"])
def test_torch_answers_rank_as_batch(name):
    raw = json.loads(REF_BODIES[name])
    svc = cpu_service(coalesce_window=0.0)
    status, want = svc.submit(json.dumps(raw))
    status_t, got = svc.submit(json.dumps(dict(raw, engine="torch")))
    assert status == status_t == 200
    assert got["engine_granted"] == got["engine_final"] == "torch"
    assert got["coalesce"]["lanes"] == 0        # torch never coalesces
    assert_equivalent(got, want)


def one_shot_doc(*args):
    from repro_torch.explore import main as cli_main
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli_main(["synth:24", "--top-k", "3", *args]) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("engine", ["batch", "torch"])
def test_service_matches_one_shot_ranking(engine):
    svc = cpu_service(coalesce_window=0.0)
    status, doc = svc.submit(body(engine=engine))
    assert status == 200
    extra = ("--device", "cpu") if engine == "torch" else ()
    ref = one_shot_doc("--engine", engine, *extra)
    # same engine, same request -> identical ranking and makespans
    assert doc["top"] == ref["top"] and doc["best"] == ref["best"]
    assert doc["engine_final"] == engine and not doc["failed"]
    t = doc["timings"]
    assert 0.0 <= t["queue_s"] and 0.0 < t["sweep_s"] <= t["total_s"]
    assert doc["engine_granted"] == engine
    assert svc.health_doc()["requests"]["done"] == 1


def test_budgeted_pareto_matches_one_shot_cli():
    svc = cpu_service(coalesce_window=0.0)
    status, doc = svc.submit(body(objectives=["area_mm2", "energy_j"],
                                  budgets={"power_w": 5.0}))
    assert status == 200
    ref = one_shot_doc("--engine", "batch", "--objectives",
                       "area_mm2,energy_j", "--budget", "power_w=5.0")
    for key in PARETO_KEYS + ("top", "best"):
        assert doc[key] == ref[key], key
    assert doc["objectives"] == ["makespan_s", "area_mm2", "power_w",
                                 "energy_j"]
    assert doc["frontier"], "budgeted sweep produced an empty frontier"
    for entry in doc["frontier"]:
        assert set(entry) == {"rank", "name", "makespan_s", "objectives",
                              "ppa"}
    # scalar responses keep the pre-PPA document shape
    s2, scalar = svc.submit(body())
    assert s2 == 200
    assert "frontier" not in scalar and "objectives" not in scalar


@pytest.mark.parametrize("engine", ["batch", "torch"])
def test_repeat_requests_reuse_warm_library(engine):
    svc = cpu_service(coalesce_window=0.0)
    assert svc.submit(body(engine=engine))[0] == 200
    orders_after_first = svc.library.counts()["orders"]
    assert orders_after_first > 0              # first sweep discovered
    s, doc = svc.submit(body(engine=engine))
    assert s == 200
    if engine == "torch":
        # a torch sweep's replay counters are its own document's.  From
        # an empty library it records one order a group (the rest of the
        # group steps its own orders); the next records one more for
        # each group whose lanes diverged from it, and the third none
        assert doc["replay"]["order_hits"] > 0
        assert doc["replay"]["own_order_lanes"] > 0
        orders_after_first = svc.library.counts()["orders"]
        s, doc = svc.submit(body(engine=engine))
        assert s == 200
        assert doc["replay"]["reference_lanes"] == 0
    assert svc.library.counts()["orders"] == orders_after_first
    if engine == "batch":
        # coalesced batches own the replay counters service-wide
        assert svc.coalescer.replay_stats()["order_hits"] > 0
        assert svc.health_doc()["replay"]["order_hits"] > 0


def test_concurrent_torch_requests_share_the_engine(monkeypatch):
    """Four torch requests at once in one service (``max_concurrent=4``),
    over four graphs, with the engine's device-block cache held at one
    entry so they evict each other's: every answer ranks as its batch
    answer, and ``/healthz`` counts them with no error or demotion."""
    svc = cpu_service(max_concurrent=4)
    sizes = (16, 20, 24, 28)
    want = {n: svc.submit(body(trace=f"synth:{n}"))[1] for n in sizes}
    results = {}
    start = threading.Barrier(len(sizes))

    def go(n):
        start.wait(timeout=WAIT_S)
        results[n] = svc.submit(body(trace=f"synth:{n}", engine="torch"))

    monkeypatch.setattr(torchsim, "_DEV_XS_CACHE_CAP", 1)
    threads = [threading.Thread(target=go, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for n in sizes:
        status, doc = results[n]
        assert status == 200 and doc["engine_final"] == "torch"
        assert_equivalent(doc, want[n])
    health = svc.health_doc()
    assert health["requests"]["done"] == 2 * len(sizes)
    assert health["requests"]["errors"] == 0
    assert health["faults"]["engine_demotions"] == 0


def test_torch_requests_take_the_engine_one_at_a_time(monkeypatch):
    """Two torch requests admitted together sweep one after another (the
    second waits for the engine, and its wait counts as queue time),
    while a batch request runs beside them."""
    svc = cpu_service(max_concurrent=4, coalesce_window=0.0)
    real_explorer = sweepd_mod.Explorer
    entered, release = threading.Semaphore(0), threading.Event()
    active, most = [0], [0]

    class Held(real_explorer):
        def explore(self, *a, **kw):
            if self.engine != "torch":
                return super().explore(*a, **kw)
            active[0] += 1
            most[0] = max(most[0], active[0])
            entered.release()
            assert release.wait(timeout=WAIT_S)
            try:
                return super().explore(*a, **kw)
            finally:
                active[0] -= 1

    monkeypatch.setattr(sweepd_mod, "Explorer", Held)
    results = {}

    def go(name, **kw):
        results[name] = svc.submit(body(**kw))

    threads = [threading.Thread(target=go, args=(f"t{i}",),
                                kwargs={"engine": "torch"})
               for i in range(2)]
    for t in threads:
        t.start()
    assert entered.acquire(timeout=WAIT_S)      # one sweeps, one waits
    wait_until(lambda: svc.health_doc()["requests"]["running"] == 2,
               "both torch requests admitted")
    assert not entered.acquire(timeout=0.2)
    go("batch")                                 # not held by the engine
    assert results["batch"][0] == 200
    release.set()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1
    docs = [results[f"t{i}"][1] for i in range(2)]
    assert all(results[f"t{i}"][0] == 200 for i in range(2))
    waited = max(docs, key=lambda d: d["timings"]["queue_s"])
    assert waited["timings"]["queue_s"] >= 0.2
    for doc in docs:
        assert_equivalent(doc, results["batch"][1])


def test_budget_expiring_while_waiting_for_the_engine_is_504():
    svc = cpu_service(breaker_threshold=1, breaker_reset_s=0.0,
                      coalesce_window=0.0)
    with faults.install("fail_torch_import:*"):
        assert svc.submit(body(engine="torch"))[0] == 200
    assert svc.breaker.as_dict()["state"] == "open"
    svc._torch_lock.acquire()               # another sweep holds it
    try:
        status, doc = svc.submit(body(engine="torch", budget_s=0.2))
    finally:
        svc._torch_lock.release()
    assert status == 504 and "torch engine" in doc["error"]
    assert doc["timings"]["queue_s"] >= 0.2
    assert doc["timings"]["sweep_s"] == 0.0
    # the request was the half-open probe: its slot is released
    d = svc.breaker.as_dict()
    assert d["state"] == "open" and not d["probe_in_flight"]
    assert svc.submit(body(engine="torch"))[0] == 200


def test_batch_with_processes_after_a_torch_request(monkeypatch):
    """A torch request, then a process-parallel batch request, in one
    service: the batch request fans out (no device, no coalescer) and
    answers as the in-process batch request does."""
    monkeypatch.setenv("REPRO_POOL_START", "forkserver")
    svc = cpu_service(processes=2, coalesce_window=0.0)
    s1, d1 = svc.submit(body(engine="torch"))
    s2, d2 = svc.submit(body())
    ref = cpu_service(coalesce_window=0.0).submit(body())[1]
    assert s1 == s2 == 200
    assert d2["top"] == ref["top"] and d2["coalesce"]["lanes"] == 0
    assert_equivalent(d1, d2)


# ---------------------------------------------------------------------------
# Coalescing
# ---------------------------------------------------------------------------


def test_concurrent_same_graph_requests_coalesce_bit_identical(monkeypatch):
    """Two batch requests over one graph merge into one batch.  They meet
    by an event, not by a timed window: the coalescer's ``load_fn``
    reports one request in flight until the second has entered, and the
    leader then holds its batch open (a one-minute window) until the
    second has joined it."""
    ref = cpu_service(coalesce_window=0.0).submit(body())[1]
    svc = cpu_service(max_concurrent=4, coalesce_window=60.0)
    both_in = threading.Event()
    real_run = svc._run

    def run_when_both_in(*args):
        with svc._cond:
            if svc.running == 2:
                both_in.set()
        assert both_in.wait(timeout=WAIT_S)
        return real_run(*args)

    monkeypatch.setattr(svc, "_run", run_when_both_in)
    results = [None, None]

    def go(i):
        results[i] = svc.submit(body())

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for status, doc in results:
        assert status == 200
        assert doc["top"] == ref["top"] and doc["best"] == ref["best"]
    st = svc.coalescer.stats
    assert st.coalesced_lanes > 0, "no lanes were merged"
    assert st.batches < st.requests        # fewer dispatches than queries
    assert any(doc["coalesce"]["coalesced_lanes"] > 0
               for _s, doc in results)
    assert svc.health_doc()["coalesce"]["hit_rate"] > 0


class _FakeGraph:
    def content_hash(self):
        return "g0"


def held_coalescer(monkeypatch, participants, batch_fn):
    """A coalescer whose leader holds its batch open until
    ``participants`` requests have joined (``load_fn``; a one-minute
    window), running ``batch_fn`` in place of ``simulate_batch``."""
    monkeypatch.setattr(coalesce_mod, "simulate_batch", batch_fn)
    return Coalescer(window_s=60.0, load_fn=lambda: participants)


def start_leader(co, target):
    """Start ``target`` in a thread and wait until its batch is open."""
    t = threading.Thread(target=target)
    t.start()
    wait_until(lambda: co._open, "the leader's open batch")
    return t


def test_coalescer_follower_deadline_raises_timeout(monkeypatch):
    follower_gave_up = threading.Event()

    def slow_batch(fg, systems, policy, **kw):
        assert follower_gave_up.wait(timeout=WAIT_S)
        return ["r"] * len(systems)

    co = held_coalescer(monkeypatch, 2, slow_batch)
    fg = _FakeGraph()
    out = {}

    def lead():
        out["lead"] = co.run_family(fg, ["a", "b"], "availability", None)

    t = start_leader(co, lead)
    try:
        with pytest.raises(FuturesTimeout):
            co.run_family(fg, ["c"], "availability", 0.05)
    finally:
        follower_gave_up.set()
        t.join(timeout=WAIT_S)
    # the follower's missed deadline never hurt the leader
    assert out["lead"] == ["r", "r"]
    with pytest.raises(FuturesTimeout):
        co.run_family(fg, ["d"], "availability", 0.0)   # spent budget


def test_coalescer_error_broadcasts_to_all_participants(monkeypatch):
    def broken_batch(fg, systems, policy, **kw):
        raise ValueError("engine exploded")

    co = held_coalescer(monkeypatch, 2, broken_batch)
    fg = _FakeGraph()
    errors = []

    def run(systems):
        try:
            co.run_family(fg, systems, "availability", None)
        except RuntimeError as exc:
            errors.append(str(exc))

    t = start_leader(co, lambda: run(["a"]))
    run(["b"])
    t.join(timeout=WAIT_S)
    assert len(errors) == 2
    assert all("engine exploded" in e for e in errors)


def test_coalescer_fans_slices_back_correctly(monkeypatch):
    def echo_batch(fg, systems, policy, **kw):
        return [f"sim:{s}" for s in systems]

    co = held_coalescer(monkeypatch, 2, echo_batch)
    fg = _FakeGraph()
    got = {}

    def run(name, systems):
        got[name] = co.run_family(fg, systems, "availability", None)

    a = start_leader(co, lambda: run("a", ["s1", "s2"]))
    run("b", ["s3"])
    a.join(timeout=WAIT_S)
    assert got["a"] == ["sim:s1", "sim:s2"]
    assert got["b"] == ["sim:s3"]
    assert co.stats.batches == 1 and co.stats.coalesced_lanes == 1


def test_coalescer_dedups_identical_lanes(monkeypatch):
    evaluated = []

    def echo_batch(fg, systems, policy, **kw):
        evaluated.append(list(systems))
        return [f"sim:{s}" for s in systems]

    co = held_coalescer(monkeypatch, 3, echo_batch)
    fg = _FakeGraph()
    got = {}

    def run(name):
        got[name] = co.run_family(fg, ["s1", "s2", "s3"], "availability",
                                  None)

    lead = start_leader(co, lambda: run("r0"))
    followers = [threading.Thread(target=run, args=(f"r{i}",))
                 for i in (1, 2)]
    for t in followers:
        t.start()
    for t in [lead] + followers:
        t.join(timeout=WAIT_S)
    assert evaluated == [["s1", "s2", "s3"]]        # one deduped lane set
    for name in got:
        assert got[name] == ["sim:s1", "sim:s2", "sim:s3"]
    assert co.stats.batches == 1
    assert co.stats.dedup_lanes == 6                # 2 followers x 3 lanes
    assert co.stats.lanes == 9 and co.stats.coalesced_lanes == 6


# ---------------------------------------------------------------------------
# Admission control and deadlines
# ---------------------------------------------------------------------------


def test_queue_full_sheds_with_retry_after():
    svc = cpu_service(queue_limit=0, max_concurrent=1, coalesce_window=0.0)
    # queue_limit=0 means "never wait" — an idle server still serves
    assert svc.ready()
    assert svc.submit(body(trace="synth:8"))[0] == 200
    with svc._cond:
        svc.running = 1                     # saturate without a real sweep
    try:
        assert not svc.ready()
        status, doc = svc.submit(body(engine="torch"))
    finally:
        with svc._cond:
            svc.running = 0
            svc._cond.notify_all()
    assert status == 429
    assert doc["retry_after_s"] > 0
    assert svc.health_doc()["requests"]["shed"] == 1
    assert svc.ready()


def test_budget_expiring_in_queue_is_504():
    svc = cpu_service(max_concurrent=1, queue_limit=4)
    with svc._cond:
        svc.running = 1                     # saturate without a real sweep
    try:
        t0 = time.perf_counter()
        status, doc = svc.submit(body(budget_s=0.2, engine="torch"))
        waited = time.perf_counter() - t0
    finally:
        with svc._cond:
            svc.running = 0
            svc._cond.notify_all()
    assert status == 504
    assert waited >= 0.2
    assert doc["timings"]["queue_s"] >= 0.2
    assert doc["timings"]["sweep_s"] == 0.0


def test_draining_rejects_and_unreadies():
    svc = cpu_service()
    assert svc.ready()
    svc.begin_drain()
    assert not svc.ready()
    assert svc.submit(body())[0] == 503
    assert svc.submit(body(engine="torch"))[0] == 503
    assert svc.health_doc()["status"] == "draining"
    assert svc.drained(timeout=0.5)         # nothing in flight


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_unit_trip_cap_probe_close():
    br = CircuitBreaker(threshold=2, reset_s=60.0)
    assert br.admit("torch") == ("torch", None)
    br.observe("torch", "torch", "batch")       # demotion 1
    br.observe("torch", "torch", "batch")       # demotion 2 -> open
    assert br.as_dict()["state"] == "open" and br.pinned == "batch"
    assert br.admit("torch") == ("batch", None)     # capped
    assert br.admit("fast") == ("fast", None)       # below the pin
    # capped requests finishing clean must not close an open breaker
    br.observe("torch", "batch", "batch")
    assert br.as_dict()["state"] == "open"
    # cool-down elapses -> one probe at full fidelity
    br._opened_at -= 120.0
    granted, probe = br.admit("torch")
    assert granted == "torch" and probe is not None
    assert br.admit("torch") == ("batch", None)     # second: capped
    # a stale request granted the same engine carries no token
    br.observe("torch", "torch", "torch")
    assert br.as_dict()["state"] == "half_open"
    br.observe("torch", "batch", "batch")
    assert br.as_dict()["state"] == "half_open"
    assert br.as_dict()["probe_in_flight"]
    br.observe("torch", "torch", "torch", token=probe)  # clean -> closed
    assert br.as_dict()["state"] == "closed" and br.pinned is None
    assert not br.as_dict()["probe_in_flight"]
    assert br.admit("torch") == ("torch", None)


def test_breaker_probe_failure_reopens():
    br = CircuitBreaker(threshold=1, reset_s=60.0)
    br.observe("torch", "torch", "batch")
    assert br.as_dict()["state"] == "open" and br.trips == 1
    br._opened_at -= 120.0
    granted, probe = br.admit("torch")      # probe
    assert granted == "torch" and probe is not None
    br.observe("torch", "torch", "fast", token=probe)   # deeper -> reopen
    d = br.as_dict()
    assert d["state"] == "open" and d["trips"] == 2 and br.pinned == "fast"


def test_breaker_probe_crash_releases_and_reopens():
    br = CircuitBreaker(threshold=1, reset_s=60.0)
    br.observe("torch", "torch", "batch")
    br._opened_at -= 120.0
    granted, probe = br.admit("torch")
    assert granted == "torch" and probe is not None
    br.release_probe(probe)
    d = br.as_dict()
    assert d["state"] == "open" and not d["probe_in_flight"]
    br._opened_at -= 120.0
    granted2, probe2 = br.admit("torch")
    assert granted2 == "torch" and probe2 is not None
    # stale/None tokens are no-ops (non-probe failure paths call this)
    br.release_probe(probe)
    br.release_probe(None)
    assert br.as_dict()["state"] == "half_open"
    assert br.as_dict()["probe_in_flight"]


@pytest.mark.parametrize("engine,fault,demoted", [
    ("batch", "fail_lockstep:*", "fast"),
    ("torch", "fail_torch_import:*", "batch")])
def test_breaker_pins_engine_after_repeated_demotions(engine, fault,
                                                      demoted):
    svc = cpu_service(breaker_threshold=2, breaker_reset_s=600.0,
                      coalesce_window=0.0)
    with faults.install(fault):
        s1, d1 = svc.submit(body(engine=engine))
        s2, d2 = svc.submit(body(engine=engine))
        s3, d3 = svc.submit(body(engine=engine))
    assert (s1, s2, s3) == (200, 200, 200)
    assert d1["engine_final"] == demoted and d2["engine_final"] == demoted
    assert d1["faults"]["engine_demotions"] == 1
    # the third is granted the demoted tier up front
    assert d3["breaker"]["state"] == "open"
    assert d3["engine_granted"] == demoted
    assert d3["faults"]["engine_demotions"] == 0
    assert d3["top"] == d1["top"]
    # cool-down passed + fault gone -> probe succeeds, the breaker closes
    svc.breaker._opened_at -= 1200.0
    s4, d4 = svc.submit(body(engine=engine))
    assert s4 == 200 and d4["engine_granted"] == engine
    assert d4["engine_final"] == engine
    assert d4["breaker"]["state"] == "closed"
    if engine == "batch":
        assert d4["top"] == d1["top"]
    else:
        assert_equivalent(d4, d1)


def test_breaker_cap_to_batch_passes_no_device(monkeypatch):
    """A torch request capped to batch by the breaker runs a batch
    Explorer with no device (the port's Explorer refuses one), through
    the coalescer; an uncapped torch request gets the server's device."""
    made = []
    real_explorer = sweepd_mod.Explorer

    class Recording(real_explorer):
        def __init__(self, *a, **kw):
            made.append((kw["engine"], kw.get("device"),
                         kw.get("family_runner") is not None))
            super().__init__(*a, **kw)

    monkeypatch.setattr(sweepd_mod, "Explorer", Recording)
    svc = cpu_service(breaker_threshold=1, breaker_reset_s=600.0,
                      coalesce_window=0.0)
    with faults.install("fail_torch_import:*"):
        s1, d1 = svc.submit(body(engine="torch"))
    s2, d2 = svc.submit(body(engine="torch"))
    assert s1 == s2 == 200
    assert d1["engine_final"] == "batch"
    assert d2["engine_granted"] == d2["engine_final"] == "batch"
    assert made == [("torch", "cpu", False), ("batch", None, True)]
    assert d2["top"] == d1["top"]


def test_service_probe_crash_reopens_breaker(monkeypatch):
    svc = cpu_service(breaker_threshold=1, breaker_reset_s=0.0,
                      coalesce_window=0.0)
    with faults.install("fail_torch_import:*"):
        s1, d1 = svc.submit(body(engine="torch"))
    assert s1 == 200 and d1["engine_final"] == "batch"
    assert svc.breaker.as_dict()["state"] == "open"

    real_explorer = sweepd_mod.Explorer

    class Boom(real_explorer):
        def explore(self, *a, **kw):
            raise RuntimeError("probe exploded")

    monkeypatch.setattr(sweepd_mod, "Explorer", Boom)
    s2, d2 = svc.submit(body(engine="torch"))   # the half-open probe: 500
    assert s2 == 500 and "probe exploded" in d2["error"]
    d = svc.breaker.as_dict()
    assert d["state"] == "open" and not d["probe_in_flight"]

    monkeypatch.setattr(sweepd_mod, "Explorer", real_explorer)
    s3, d3 = svc.submit(body(engine="torch"))
    assert s3 == 200 and d3["engine_granted"] == "torch"
    assert d3["breaker"]["state"] == "closed"


def test_device_error_answers_500_and_never_batch(monkeypatch):
    """A torch request whose kernel launch fails (the wrapper's
    DeviceError, injected at the engine's call of it) answers 500 with
    the error's text: no demotion, no batch answer, no breaker trip."""
    from repro_torch import DeviceError

    def broken(*args):
        raise DeviceError("injected: step_commit kernel launch failed")

    monkeypatch.setattr(torchsim, "step_commit", broken)
    svc = cpu_service(breaker_threshold=1, coalesce_window=0.0)
    status, doc = svc.submit(body(engine="torch"))
    assert status == 500 and "DeviceError" in doc["error"]
    assert "step_commit kernel launch failed" in doc["error"]
    health = svc.health_doc()
    assert health["breaker"]["state"] == "closed"
    assert health["faults"]["engine_demotions"] == 0
    assert health["requests"]["errors"] == 1


def test_bad_request_never_consumes_probe():
    svc = cpu_service(breaker_threshold=1, breaker_reset_s=0.0,
                      coalesce_window=0.0)
    with faults.install("fail_lockstep:*"):
        assert svc.submit(body())[0] == 200
    assert svc.breaker.as_dict()["state"] == "open"
    # passes validate() (non-empty events) but dies in materialize()
    s, _doc = svc.submit(body(trace="inline", events=[{"bogus": 1}]))
    assert s == 400
    assert not svc.breaker.as_dict()["probe_in_flight"]


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def test_http_roundtrip_health_drain():
    svc = cpu_service(coalesce_window=0.0)
    httpd = serve(svc, port=0)
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert get_json(base + "/readyz") == (200, {"ready": True})
        status, doc = post_json(base + "/sweep",
                                {"trace": "synth:24", "top_k": 3,
                                 "engine": "torch"})
        assert status == 200 and doc["best"] == doc["top"][0]["name"]
        assert doc["engine_final"] == "torch"
        assert doc["timings"]["total_s"] > 0
        status, health = get_json(base + "/healthz")
        assert status == 200 and health["requests"]["done"] == 1
        assert set(health["faults"]) == {
            "worker_retries", "pool_respawns", "chunk_timeouts",
            "quarantined", "engine_demotions", "cache_quarantined"}
        assert get_json(base + "/nope")[0] == 404
        assert post_json(base + "/sweep", {"trace": "x"})[0] == 400
        svc.begin_drain()
        assert get_json(base + "/readyz")[0] == 503
        assert post_json(base + "/sweep", {"trace": "synth:8"})[0] == 503
        assert svc.drained(timeout=2.0)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_drain_timeout_abandons_wedged_handlers():
    svc = cpu_service(coalesce_window=0.0)
    release = threading.Event()
    wedged_in = threading.Event()

    def wedged(_body):
        wedged_in.set()
        release.wait(10.0)
        return 503, {"error": "wedged"}

    svc.submit = wedged
    httpd = serve(svc, port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    client = threading.Thread(
        target=post_json,
        args=(f"http://127.0.0.1:{port}/sweep", {"trace": "synth:8"}),
        daemon=True)
    client.start()
    try:
        assert wedged_in.wait(timeout=WAIT_S)   # the handler is wedged
        httpd.abandon_in_flight()
        httpd.shutdown()
        t0 = time.perf_counter()
        httpd.server_close()        # must NOT join the wedged handler
        assert time.perf_counter() - t0 < 2.0
    finally:
        release.set()


@pytest.mark.parametrize("engine", ["batch", "torch"])
def test_drain_flushes_dirty_orders(tmp_path, engine):
    cache = str(tmp_path / "store")
    svc = cpu_service(cache_dir=cache, coalesce_window=0.0)
    assert svc.submit(body(engine=engine))[0] == 200
    store = DiskCache(cache)
    assert len(store.entries()) > 0         # orders + graphs + sims landed
    svc.begin_drain()
    assert svc.drained(timeout=2.0)
    svc.flush_orders()                      # idempotent when nothing dirty
    warm = cpu_service(cache_dir=cache, coalesce_window=0.0)
    s, doc = warm.submit(body(engine=engine))
    assert s == 200 and doc["cache"]["disk_hits"] > 0


def run_cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.explore",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(REPO))


def test_cli_serves_and_drains_on_the_cpu(tmp_path):
    """``serve --device cpu`` in its own process: ``client`` sends a
    synth trace and a trace file inline (torch, the client's default
    engine), and SIGTERM drains the server to exit 0."""
    import dataclasses
    trace_path, reports_path = tmp_path / "t.jsonl", tmp_path / "r.json"
    synth.synth_trace(16).save(str(trace_path))
    reports_path.write_text(json.dumps(
        [dataclasses.asdict(r) for r in synth.synth_reports().values()]))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.explore", "serve", "--port",
         "0", "--device", "cpu"], stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(REPO))
    try:
        seen = []
        while not seen or "sweepd listening on" not in seen[-1]:
            seen.append(server.stderr.readline())
            assert seen[-1], "".join(seen)      # the server exited
        url = seen[-1].split()[-1]
        for trace_args in (["synth:16"],
                           [str(trace_path), "--reports",
                            str(reports_path)]):
            out = run_cli("client", "--url", url, *trace_args,
                          "--top-k", "3")
            assert out.returncode == 0, out.stderr
            doc = json.loads(out.stdout)
            assert doc["engine_final"] == "torch" and len(doc["top"]) == 3
            if trace_args[0] == "synth:16":
                first = doc
            else:
                assert doc["top"] == first["top"]
        health = json.loads(run_cli("client", "--url", url, "synth:1",
                                    "--health").stdout)
        assert health["requests"]["done"] == 2
        server.send_signal(signal.SIGTERM)
        assert server.wait(timeout=60) == 0
        assert "sweepd: drained (2 request(s) served" in server.stderr.read()
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        server.stderr.close()


# ---------------------------------------------------------------------------
# Concurrent DiskCache writers
# ---------------------------------------------------------------------------


def test_diskcache_concurrent_writers_race_free(tmp_path):
    with faults.install("delay_put:*:0.002"):
        dc = DiskCache(tmp_path)
        keys = [f"key-{i}" for i in range(4)]
        stop = threading.Event()
        failures = []

        def writer(wid):
            try:
                for i in range(25):
                    k = keys[(wid + i) % len(keys)]
                    dc.put(k, {"writer": wid, "i": i, "key": k})
            except Exception as exc:        # noqa: BLE001
                failures.append(f"writer {wid}: {exc!r}")

        def reader(rid):
            try:
                while not stop.is_set():
                    for k in keys:
                        got = dc.get(k)
                        if got is not None and got["key"] != k:
                            failures.append(f"reader {rid}: "
                                            f"cross-key value {got}")
            except Exception as exc:        # noqa: BLE001
                failures.append(f"reader {rid}: {exc!r}")

        writers = [threading.Thread(target=writer, args=(w,))
                   for w in range(8)]
        readers = [threading.Thread(target=reader, args=(r,))
                   for r in range(4)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in readers + writers)
    assert not failures, failures
    assert dc.quarantined == 0
    for k in keys:                          # last writer won, intact
        got = dc.get(k)
        assert got is not None and got["key"] == k
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_diskcache_corruption_amid_writers_quarantines_only_victim(
        tmp_path):
    with faults.install("corrupt_cache:5"):
        dc = DiskCache(tmp_path)
        for i in range(10):
            dc.put(f"k{i}", i)
        hits = sum(dc.get(f"k{i}") == i for i in range(10))
    assert hits == 9
    assert dc.quarantined == 1
    qdir = tmp_path / "quarantine"
    assert qdir.is_dir() and len(list(qdir.iterdir())) == 1


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_torch_request_served_on_the_card():
    needs_card()
    svc = SweepService(device="cuda", coalesce_window=0.0)
    want = svc.submit(body(trace="synth:40"))[1]
    lockstep_step.LAUNCHES = 0
    status, doc = svc.submit(body(trace="synth:40", engine="torch"))
    assert status == 200 and doc["engine_final"] == "torch"
    assert lockstep_step.LAUNCHES > 0
    assert_equivalent(doc, want)


@pytest.mark.gpu
def test_four_concurrent_torch_requests_on_the_card():
    needs_card()
    svc = SweepService(device="cuda", max_concurrent=4)
    sizes = (24, 32, 40, 48)
    want = {n: svc.submit(body(trace=f"synth:{n}"))[1] for n in sizes}
    results = {}
    start = threading.Barrier(len(sizes))

    def go(n):
        start.wait(timeout=WAIT_S)
        results[n] = svc.submit(body(trace=f"synth:{n}", engine="torch"))

    lockstep_step.LAUNCHES = 0
    threads = [threading.Thread(target=go, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert lockstep_step.LAUNCHES > 0
    for n in sizes:
        status, doc = results[n]
        assert status == 200 and doc["engine_final"] == "torch"
        assert_equivalent(doc, want[n])
    assert svc.health_doc()["requests"]["errors"] == 0


class FailingLaunches:
    """A bound build of ``lockstep_step.cu`` whose launches all fail."""

    def step_commit_launch(self, packed):
        return 1

    def step_fused_launch(self, packed):
        return 1

    def step_commit_error_string(self, rc):
        return b"injected launch failure"


@pytest.mark.gpu
def test_failed_kernel_launch_on_the_card_answers_500(monkeypatch):
    needs_card()
    monkeypatch.setattr(lockstep_step, "_CACHED", FailingLaunches())
    # the wrapper launches when a step graph is captured (a graph captured
    # earlier in the process replays without it): start from an empty
    # compile cache, so that the sweep captures and its launch fails
    monkeypatch.setattr(torchsim, "_DEFAULT_CACHE", torchsim.CompileCache())
    svc = SweepService(device="cuda", breaker_threshold=1,
                       coalesce_window=0.0)
    status, doc = svc.submit(body(trace="synth:40", engine="torch"))
    assert status == 500 and "injected launch failure" in doc["error"]
    assert "DeviceError" in doc["error"]
    health = svc.health_doc()
    assert health["faults"]["engine_demotions"] == 0
    assert health["breaker"]["state"] == "closed"
