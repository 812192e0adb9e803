"""The port's compile cache against the JAX package's.

``repro_torch.core.graphcache.CompileCache`` (runners: captured CUDA
graphs on the card, eager bodies on the CPU) and
``repro.core.xlacache.CompileCache`` (XLA executables) run the same
memory-tier protocol: repeat signatures dedup, LRU eviction at
``MEM_CAP``, the four counters, and ``fail_compile`` firing ahead of a
warm memory hit.  Then the port's own disk tier (an environment-keyed
miss, corrupt and wrongly shaped entries, a second process served from
disk), the kernel store of ``repro_torch.kernels.build`` (keyed by
environment, a corrupt library rebuilt once) and the Explorer's wiring
(``fail_compile`` demotes ``torch -> batch``, one cache per cache root).
Every comparison here is exact: counters are integers and the sweeps are
the same engine on the same inputs.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro.core import xlacache as ref_xlacache
from repro.testing import faults as ref_faults

from repro_torch import DeviceError
from repro_torch.core import Explorer, graphcache, torchsim
from repro_torch.core.diskcache import DiskCache
from repro_torch.kernels import build
from repro_torch.testing import faults, synth

ROOT = Path(__file__).resolve().parents[1]


class Lowered:
    """What the reference's ``load_or_compile`` takes from its ``lower``:
    an object whose ``compile()`` gives the executable."""

    def __init__(self, value):
        self.value = value

    def compile(self):
        return self.value


#: Per implementation: its cache class, its fault switchboard, its
#: memory cap, and ``load(cache, signature, value)``.
IMPLS = {
    "port": (graphcache.CompileCache, faults, graphcache.MEM_CAP,
             lambda cc, sig, value: cc.load_or_compile(sig, lambda: value)),
    "reference": (ref_xlacache.CompileCache, ref_faults,
                  ref_xlacache.MEM_CAP,
                  lambda cc, sig, value: cc.load_or_compile(
                      sig, lambda: Lowered(value))),
}


def counters(cc):
    got = cc.as_dict()
    return {k: got[k] for k in ("mem_hits", "disk_hits", "compiles",
                                "failures")}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_memory_tier_protocol_matches_the_reference(impl):
    """Both caches, memory tier only, through one sequence of lookups:
    the same runners served and the same counters at every step."""
    Cache, fault_mod, cap, load = IMPLS[impl]
    assert cap == 64
    cc = Cache()
    a, b = object(), object()
    assert load(cc, ("a", 1), a) is a
    assert counters(cc) == {"mem_hits": 0, "disk_hits": 0, "compiles": 1,
                            "failures": 0}
    assert load(cc, ("a", 1), b) is a                   # deduplicated
    assert cc.get(("a", 1)) is a
    assert cc.get(("b",)) is None
    cc.put(("b",), b)
    assert cc.get(("b",)) is b
    assert counters(cc) == {"mem_hits": 3, "disk_hits": 0, "compiles": 2,
                            "failures": 0}
    # LRU: touch "a", then fill to one past the cap; "b" is the oldest
    assert cc.get(("a", 1)) is a
    for i in range(cap - 1):
        load(cc, ("fill", i), object())
    assert cc.get(("b",)) is None
    assert cc.get(("a", 1)) is a
    assert counters(cc) == {"mem_hits": 5, "disk_hits": 0,
                            "compiles": 2 + cap - 1, "failures": 0}
    # the injected fault fires ahead of a warm memory hit, once
    with fault_mod.install("fail_compile:1"):
        with pytest.raises(RuntimeError, match="fail_compile"):
            load(cc, ("a", 1), b)
        assert load(cc, ("a", 1), b) is a
    assert counters(cc)["mem_hits"] == 6


class Runner:
    """A runner that names the kernel libraries it needs."""

    def __init__(self, libraries=()):
        self.libraries = libraries


def test_disk_tier_serves_a_second_cache_and_misses_on_another_env(
        tmp_path, monkeypatch):
    """A signature stored by one cache is a disk hit for a fresh cache on
    the same root (its runner is built anew: graphs do not persist), and
    a plain miss once the environment differs."""
    sig = ("step", 3)
    first = graphcache.CompileCache(DiskCache(str(tmp_path)))
    first.load_or_compile(sig, Runner)
    assert counters(first)["compiles"] == 1
    second = graphcache.CompileCache(DiskCache(str(tmp_path)))
    built = []
    second.load_or_compile(sig, lambda: built.append(1) or Runner())
    assert built == [1]
    assert counters(second) == {"mem_hits": 0, "disk_hits": 1,
                                "compiles": 0, "failures": 0}
    monkeypatch.setattr(graphcache.CompileCache, "_env",
                        staticmethod(lambda: ["another torch", "12.0"]))
    third = graphcache.CompileCache(DiskCache(str(tmp_path)))
    third.load_or_compile(sig, Runner)
    assert counters(third) == {"mem_hits": 0, "disk_hits": 0,
                               "compiles": 1, "failures": 0}


def test_corrupt_or_misshapen_disk_entries_never_crash(tmp_path):
    """A garbled entry (quarantined by the DiskCache) and an entry of
    another shape are plain misses; an entry naming a kernel library the
    store lacks is counted in ``failures``; each degrades to a compile."""
    disk = DiskCache(str(tmp_path))
    cc = graphcache.CompileCache(disk)
    sig = ("probe", 1)
    text = cc._key_text(sig)
    with faults.install("corrupt_cache:1"):
        disk.put(text, ("graph-runner", 1, []))
    cc.load_or_compile(sig, Runner)
    assert disk.quarantined == 1
    assert counters(cc) == {"mem_hits": 0, "disk_hits": 0, "compiles": 1,
                            "failures": 0}
    for n, payload in enumerate([{"wrong": "shape"},
                                 ("graph-runner", 2, []),
                                 ("graph-runner", 1, "not a list")]):
        disk.put(text, payload)
        fresh = graphcache.CompileCache(disk)
        fresh.load_or_compile(sig, Runner)
        assert counters(fresh) == {"mem_hits": 0, "disk_hits": 0,
                                   "compiles": 1, "failures": 0}, n
    disk.put(text, ("graph-runner", 1, [["lockstep_step.cu", None]]))
    fresh = graphcache.CompileCache(disk)
    fresh.load_or_compile(sig, Runner)
    assert counters(fresh) == {"mem_hits": 0, "disk_hits": 0, "compiles": 1,
                               "failures": 1}


def test_concurrent_misses_build_once():
    """Threads that miss on one signature at once build its runner once;
    the others are served from memory."""
    import threading
    cc = graphcache.CompileCache()
    gate = threading.Event()
    builds = []

    def slow():
        gate.wait(timeout=10)
        builds.append(1)
        return Runner()

    got = []
    threads = [threading.Thread(target=lambda: got.append(
        cc.load_or_compile(("one",), slow))) for _ in range(6)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1] and len({id(r) for r in got}) == 1
    assert counters(cc)["compiles"] == 1 and counters(cc)["mem_hits"] == 5


# ----------------------------------------------------- the kernel store ---

@pytest.fixture
def stub_store(monkeypatch, tmp_path):
    """``build.load`` with ``nvcc`` and ``dlopen`` stubbed: a "library"
    is a file whose text a bind check reads; the environment is fixed and
    the process has loaded nothing."""
    monkeypatch.setattr(build, "_ENV", ("torch-x", "cuda-y", "release z",
                                        "sm_90"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_INFO", {})
    monkeypatch.setattr(build, "BUILDS", 0)
    monkeypatch.setattr(build, "REBUILDS", 0)
    output = {"text": "good"}

    def compile_(src, out, defines):
        build.BUILDS += 1
        Path(out).write_text(output["text"])
        return 0.5, "ptxas info    : Used 10 registers"

    class Lib:
        def __init__(self, path):
            self.text = Path(path).read_text()

    monkeypatch.setattr(build, "_compile", compile_)
    monkeypatch.setattr(build, "_cdll", Lib)
    return output


def check(lib):
    if lib.text != "good":
        raise DeviceError(f"bind check failed on {lib.text!r}")
    return lib


def test_kernel_store_is_keyed_by_environment(stub_store, monkeypatch,
                                              tmp_path):
    a = build.library_path("lockstep_step.cu", None, tmp_path)
    assert a.parent == tmp_path and a.name.startswith("lockstep_step-")
    assert build.library_path("lockstep_step.cu", None, tmp_path) == a
    assert build.library_path("tiles.cu", {"TILE": 128}, tmp_path) \
        != build.library_path("tiles.cu", None, tmp_path)
    monkeypatch.setattr(build, "_ENV", ("torch-x", "cuda-y", "release z",
                                        "sm_100"))
    assert build.library_path("lockstep_step.cu", None, tmp_path) != a


def test_kernel_store_rebuilds_a_corrupt_library_once(stub_store,
                                                      monkeypatch, tmp_path):
    """A stored library that fails its bind check is counted, removed and
    built once more; a warm store then serves a fresh process with no
    build; a rebuild that fails too raises DeviceError."""
    out = build.library_path("lockstep_step.cu", None, tmp_path)
    out.write_text("corrupt")
    lib = build.load("lockstep_step.cu", bind=check, store=tmp_path)
    assert lib.text == "good" and out.read_text() == "good"
    assert build.BUILDS == 1 and build.REBUILDS == 1
    assert not list(tmp_path.glob("*.tmp.so"))

    monkeypatch.setattr(build, "_LIBS", {})          # a fresh process
    assert build.load("lockstep_step.cu", bind=check,
                      store=tmp_path).text == "good"
    assert build.BUILDS == 1 and build.REBUILDS == 1

    monkeypatch.setattr(build, "_LIBS", {})
    out.write_text("corrupt")
    stub_store["text"] = "still corrupt"
    with pytest.raises(DeviceError, match="bind check failed"):
        build.load("lockstep_step.cu", bind=check, store=tmp_path)
    assert build.BUILDS == 2 and build.REBUILDS == 2
    assert not out.exists() and not list(tmp_path.glob("*.tmp.so"))


def test_a_loaded_library_is_copied_into_another_store(stub_store,
                                                       tmp_path):
    """A process loads each library once; another store it is asked for
    gets a copy, so that store serves later processes on its own."""
    first, second = tmp_path / "a", tmp_path / "b"
    lib = build.load("lockstep_step.cu", bind=check, store=first)
    assert build.load("lockstep_step.cu", bind=check, store=second) is lib
    assert build.BUILDS == 1
    assert build.library_path("lockstep_step.cu", None, second).read_text() \
        == "good"


# ------------------------------------------------------ Explorer wiring ---

def ranking(res):
    return [(o.name, o.makespan_s) for o in res.ranked]


def test_compile_fault_demotes_torch_to_batch():
    """``fail_compile`` fires in the compile cache mid-sweep: the Explorer
    demotes ``torch -> batch`` once, and the demoted sweep is exact."""
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    cands = synth.synth_candidates(range(1, 8))
    clean = Explorer(tr, rep, engine="batch").explore(cands)
    with faults.install("fail_compile:1"):
        ex = Explorer(tr, rep, engine="torch", device="cpu")
        with pytest.warns(UserWarning, match="degraded to 'batch'"):
            res = ex.explore(cands)
    assert ex.engine == "batch" and ex.stats.engine_demotions == 1
    assert ranking(res) == ranking(clean)


@pytest.mark.parametrize("megabatch", [True, False])
def test_on_the_card_an_injected_compile_fault_demotes(monkeypatch,
                                                       megabatch):
    """Told it is on the card, the Explorer still demotes on an injected
    compile fault, where a real fault of the runner re-raises."""
    monkeypatch.setattr(Explorer, "_on_card", lambda self: True)
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    cands = synth.synth_candidates(range(1, 8))
    with faults.install("fail_compile:1"):
        ex = Explorer(tr, rep, engine="torch", device="cpu",
                      torch_megabatch=megabatch)
        with pytest.warns(UserWarning, match="fail_compile"):
            ex.explore(cands)
    assert ex.engine == "batch" and ex.stats.engine_demotions == 1

    def broken(*args):
        raise RuntimeError("runner bug")

    monkeypatch.setattr(torchsim, "_load_runner", broken)
    ex = Explorer(tr, rep, engine="torch", device="cpu",
                  torch_megabatch=megabatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="runner bug"):
            ex.explore(cands)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0


def test_explorers_share_a_compile_cache(tmp_path):
    """Explorers of one cache root share one compile cache, and a repeat
    sweep through a shared cache captures nothing new.  ``compile_cache=``
    and ``torch_graphs=`` only apply to the torch engine."""
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    cands = synth.synth_candidates(range(1, 9))
    store = str(tmp_path / "store")
    one = Explorer(tr, rep, engine="torch", device="cpu", cache_dir=store)
    two = Explorer(tr, rep, engine="torch", device="cpu", cache_dir=store)
    assert one.compile_cache is two.compile_cache is not None
    assert one.compile_cache.kernel_store == Path(store) / "kernels"
    assert Explorer(tr, rep, engine="torch", device="cpu").compile_cache \
        is None                         # torchsim's process-wide cache

    cc = graphcache.CompileCache()
    first = Explorer(tr, rep, engine="torch", device="cpu",
                     compile_cache=cc).explore(cands)
    compiles = counters(cc)["compiles"]
    assert compiles >= 1
    again = Explorer(tr, rep, engine="torch", device="cpu",
                     compile_cache=cc).explore(cands)
    assert counters(cc)["compiles"] == compiles
    assert counters(cc)["mem_hits"] >= 1
    assert ranking(again) == ranking(first)
    eager = Explorer(tr, rep, engine="torch", device="cpu",
                     torch_graphs=False).explore(cands)
    assert ranking(eager) == ranking(first)
    assert Explorer(tr, rep, engine="batch").compile_cache is None
    for kw in ({"compile_cache": cc}, {"torch_graphs": False}):
        with pytest.raises(ValueError, match="only applies to engine='torch'"):
            Explorer(tr, rep, engine="batch", **kw)


SECOND_PROCESS = """
import json, sys
from repro_torch.core import Explorer
from repro_torch.core.diskcache import DiskCache
from repro_torch.core.graphcache import CompileCache
from repro_torch.kernels import build
from repro_torch.testing import synth
cc = CompileCache(DiskCache(sys.argv[1]))
ex = Explorer(synth.synth_trace(24), synth.synth_reports(), engine="torch",
              device=sys.argv[2], compile_cache=cc)
res = ex.explore(synth.synth_candidates(range(1, 9)))
print(json.dumps({"cc": cc.as_dict(), "nvcc": build.BUILDS,
                  "ranked": [[o.name, o.makespan_s] for o in res.ranked]}))
"""


def second_process(store, device):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", SECOND_PROCESS, store,
                          device], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_second_process_is_served_from_disk(tmp_path):
    """A fresh process on a warm store compiles nothing: every signature
    it needs is a disk hit (the CPU's runners name no kernel library)."""
    store = str(tmp_path / "store")
    cold = second_process(store, "cpu")
    assert cold["cc"]["compiles"] >= 1
    warm = second_process(store, "cpu")
    assert warm["cc"]["compiles"] == 0, warm["cc"]
    assert warm["cc"]["disk_hits"] >= 1 and warm["cc"]["failures"] == 0
    assert warm["ranked"] == cold["ranked"]


@pytest.mark.gpu
def test_a_second_process_on_the_card_builds_nothing(tmp_path):
    """On the card the first process builds ``lockstep_step.cu`` into the
    store beside the cache's entries; a second process runs ``nvcc`` 0 times
    and finds every runner's libraries there (``disk_hits >= 1``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    store = str(tmp_path / "store")
    cold = second_process(store, "cuda")
    assert cold["cc"]["captures"] >= 1
    warm = second_process(store, "cuda")
    assert warm["nvcc"] == 0, warm
    assert warm["cc"]["compiles"] == 0 and warm["cc"]["disk_hits"] >= 1
    assert warm["ranked"] == cold["ranked"]


@pytest.mark.gpu
def test_a_failed_capture_raises_device_error(monkeypatch):
    """A capture the card refuses is a DeviceError out of the sweep: no
    demotion, no eager fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    class Refused:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "graph", Refused)
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    ex = Explorer(tr, rep, engine="torch", device="cuda",
                  compile_cache=graphcache.CompileCache())
    with pytest.raises(DeviceError, match="capture failed"):
        ex.explore(synth.synth_candidates(range(1, 9)))
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0
