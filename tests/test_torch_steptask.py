"""The port's step estimator (``repro_torch.core.steptask``) and roofline
(``repro_torch.roofline.model``) against the JAX package's.

On every probe of ``tests/test_steptask.py``, with the reference's TPU
figures passed in as a port ``HW`` record (the port keeps no TPU record;
its pod size, 256 chips, is a field there), the layer costs, the
simulated steps (both engines, blocking and overlapped, one pod and two)
and the co-design ranking are the reference's bit for bit: both run the
same numpy engines.  ``model_flops``, ``extrapolate_terms`` and
``roofline_table`` are held the same way.  At the port's default
``H100`` record the simulated step is at least every single-resource
total, and the resources carry the card's names.
"""
import pytest

from repro.core import steptask as R
from repro.roofline import model as RM
from repro_torch.core import steptask as S
from repro_torch.core.simulator import simulate
from repro_torch.roofline import model as PM


def _probe(l, flops, bts, wire):
    return {"n_layers": l,
            "cost_analysis": {"flops": flops, "bytes accessed": bts},
            "collectives": {"wire_bytes": wire}}


P1 = _probe(1, 2e12, 1e11, 5e9)
P2 = _probe(2, 3e12, 1.5e11, 7.5e9)   # slope: 1e12 flops, 2.5e9 wire /layer
#: a negative wire slope (a strategy flip at the smallest depth)
P2_FLIP = _probe(2, 3e12, 1.5e11, 4e9)

#: The reference's TPU figures as a port record (256 chips a pod).
V5E = PM.HW(name=RM.V5E.name, peak_flops=RM.V5E.peak_flops,
            hbm_bw=RM.V5E.hbm_bw, link_bw=RM.V5E.link_bw,
            hbm_bytes=RM.V5E.hbm_bytes, internode_bw=RM.V5E.dci_bw,
            chips_per_pod=256)

PROBES = [(P1, P2), (P1, P2_FLIP)]


def costs_tuple(c, internode):
    return (c.n_layers, c.layer_compute, c.layer_collective, c.head_compute,
            c.head_collective, internode)


@pytest.mark.parametrize("pods,params", [(1, None), (2, 4_000_000_000),
                                         (3, 7_000_000_000)])
@pytest.mark.parametrize("probes", PROBES, ids=["slope", "flip"])
@pytest.mark.parametrize("layers", [8, 16, 32, 64])
def test_layer_costs_are_the_reference(layers, probes, pods, params):
    p1, p2 = probes
    got = S.LayerCosts.from_probes(p1, p2, layers, V5E, pods=pods,
                                   params=params)
    want = R.LayerCosts.from_probes(p1, p2, layers, RM.V5E, pods=pods,
                                    params=params)
    assert costs_tuple(got, got.internode_collective) == \
        costs_tuple(want, want.dci_collective)


@pytest.mark.parametrize("engine", ["fast", "reference"])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("pods,params", [(1, None), (2, 4_000_000_000)])
@pytest.mark.parametrize("probes", PROBES, ids=["slope", "flip"])
def test_estimate_step_is_the_reference_bit_for_bit(probes, pods, params,
                                                    overlap, engine):
    p1, p2 = probes
    got = S.estimate_step("a", "s", p1, p2, 16, overlap=overlap, pods=pods,
                          params=params, hw=V5E, engine=engine)
    want = R.estimate_step("a", "s", p1, p2, 16, overlap=overlap, pods=pods,
                           params=params, hw=RM.V5E, engine=engine)
    assert got.makespan_s == want.makespan_s
    assert got.sim.makespan == want.sim.makespan
    g, w = got.sim.summary(), want.sim.summary()
    assert g["makespan_s"] == w["makespan_s"]
    # the same utilizations, under the card's resource names
    assert sorted(g["utilization"].values()) == \
        sorted(w["utilization"].values())


@pytest.mark.parametrize("overlap", [True, False])
def test_blocking_and_overlap_graphs_simulate_as_the_reference(overlap):
    c = S.LayerCosts.from_probes(P1, P2, 32, V5E)
    rc = R.LayerCosts.from_probes(P1, P2, 32, RM.V5E)
    got = simulate(S.build_step_graph(c, overlap=overlap),
                   S.pod_chip_system(), policy="eft").makespan
    from repro.core.simulator import simulate as rsimulate
    want = rsimulate(R.build_step_graph(rc, overlap=overlap),
                     R.pod_chip_system(), policy="eft").makespan
    assert got == want


def test_codesign_sweep_ranks_as_the_reference():
    cands = {"shallow": (P1, P2, 8), "deep": (P1, P2, 64),
             "mid": (P1, P2_FLIP, 24)}
    got = S.codesign_sweep(cands, "a", "s", hw=V5E)
    want = R.codesign_sweep(cands, "a", "s")
    assert [e.variant for e in got] == [e.variant for e in want]
    assert [e.makespan_s for e in got] == [e.makespan_s for e in want]


def test_makespan_at_least_max_term_on_the_h100():
    """Simulated step ≥ every single-resource total (roofline bound), at
    the card's record."""
    for layers in (4, 16, 56):
        c = S.LayerCosts.from_probes(P1, P2, layers)
        est = S.estimate_step("a", "s", P1, P2, layers, overlap=True)
        gpu_total = layers * c.layer_compute + c.head_compute
        link_total = layers * c.layer_collective + c.head_collective
        assert est.makespan_s >= max(gpu_total, link_total) - 1e-12
        assert c.layer_compute == 1e12 / PM.H100.peak_flops
        assert c.layer_collective == 2.5e9 / PM.H100.link_bw


def test_blocking_is_no_faster_than_overlap_on_the_h100():
    c = S.LayerCosts.from_probes(P1, P2, 32)
    block = simulate(S.build_step_graph(c, overlap=False),
                     S.pod_chip_system(), policy="eft").makespan
    ovl = simulate(S.build_step_graph(c, overlap=True),
                   S.pod_chip_system(), policy="eft").makespan
    assert ovl <= block
    assert block >= 32 * (c.layer_compute + c.layer_collective) * 0.99


def test_pods_of_the_h100_are_hgx_nodes():
    """Two pods of 8 GPUs: the gradient hop between nodes moves each
    GPU's shard of 2-byte gradients up and down over one NDR port."""
    one = S.estimate_step("a", "s", P1, P2, 16, pods=1, params=8_000_000_000)
    two = S.estimate_step("a", "s", P1, P2, 16, pods=2, params=8_000_000_000)
    assert two.costs.internode_collective == \
        2.0 * (8e9 * 2 / 16) / PM.H100.internode_bw
    assert two.makespan_s >= one.makespan_s
    system = S.pod_chip_system(pods=2)
    assert [p.name for p in system.pools] == ["host", "gpu"]
    assert [r.name for r in system.shared] == ["nvlink", "internode"]
    kinds = {t.devices[0] for t in S.build_step_graph(two.costs,
                                                      pods=2).tasks.values()}
    assert kinds == {"smp", "gpu", "nvlink", "internode"}


# -------------------------------------------------------------- roofline ---

RECORDS = [
    {"params": 1_000_000, "kind": "train", "global_batch": 8,
     "seq_len": 128},
    {"params": 1_000_000, "active_params": 250_000, "kind": "prefill",
     "global_batch": 4, "seq_len": 512},
    {"params": 3_000_000, "kind": "decode", "global_batch": 16,
     "seq_len": 4096},
]


@pytest.mark.parametrize("record", RECORDS, ids=lambda r: r["kind"])
def test_model_flops_is_the_reference(record):
    assert PM.model_flops(record) == RM.model_flops(record)


@pytest.mark.parametrize("probes", PROBES, ids=["slope", "flip"])
@pytest.mark.parametrize("layers", [2, 7, 56])
def test_extrapolate_terms_is_the_reference(probes, layers):
    assert PM.extrapolate_terms(*probes, layers) == \
        RM.extrapolate_terms(*probes, layers)
    assert PM._terms_of(probes[1]) == RM._terms_of(probes[1])


def test_roofline_table_is_the_reference():
    fields = dict(arch="mixtral-8x22b", shape="prefill_32k", mesh="1x1",
                  kind="prefill", tag="", n_devices=1, compute_s=0.25,
                  memory_s=0.5, collective_s=0.0, memory_hlo_s=0.75,
                  model_flops=1e15, hlo_flops_global=2e15, useful_ratio=0.5,
                  ideal_s=0.2, roofline_fraction=0.4, peak_mem_gb=None,
                  fits=None)
    cells = [PM.CellRoofline(**fields),
             PM.CellRoofline(**{**fields, "peak_mem_gb": 12.5,
                                "fits": True, "collective_s": 0.9})]
    rcells = [RM.CellRoofline(**fields),
              RM.CellRoofline(**{**fields, "peak_mem_gb": 12.5,
                                 "fits": True, "collective_s": 0.9})]
    assert PM.roofline_table(cells) == RM.roofline_table(rcells)
    assert [c.row() for c in cells] == [c.row() for c in rcells]
    assert [c.dominant for c in cells] == ["memory", "collective"]
    assert cells[1].bound_s == rcells[1].bound_s == 0.9
