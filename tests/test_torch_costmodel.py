"""The port's cost model (``repro_torch.core.hlsreport.TorchCostModel``)
against the JAX package's ``XLACostModel`` and the roofline's
``model_flops``.

* A GEMM's FLOPs are 2mnk and equal ``XLACostModel``'s count of the same
  product on the CPU, and so do its bytes (inputs read once, the output
  written once); an elementwise op's bytes are its inputs and output,
  again XLA's count; views move nothing; transcendentals are the output
  elements of ``exp``-like ops.
* A qwen3 smoke forward on ``meta`` makes no tensor anywhere else, and
  its FLOPs are ``model_flops``' 2·N·D (N the parameters that take part
  in products, D the tokens) plus the attention term that 2·N·D leaves
  out: the scores and the weighted values, a full T x S rectangle each
  (4·B·H·T·S·hd a layer), because the kernel route runs its plain
  version on meta.
* A probe record built from the counts has the keys
  ``LayerCosts.from_probes`` reads, and two probes extrapolate exactly to
  a deeper stack's count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import H100_SXM, GPUConstants, TorchCostModel
from repro_torch.core.steptask import LayerCosts
from repro_torch.models import transformer as T
from repro_torch.roofline import H100, extrapolate_terms, model_flops


@pytest.fixture(scope="module")
def xla():
    import jax.numpy as jnp
    from repro.core import XLACostModel
    return XLACostModel(), jnp


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (128, 128, 128),
                                   (3, 200, 7)])
def test_gemm_flops_are_2mnk_and_xlas(m, k, n, xla):
    model, jnp = xla
    got = TorchCostModel().analyze(torch.matmul, meta(m, k), meta(k, n))
    want = model.analyze(lambda a, b: a @ b, jnp.zeros((m, k)),
                         jnp.zeros((k, n)))
    assert got["flops"] == 2 * m * n * k == want["flops"]
    assert got["bytes"] == 4 * (m * k + k * n + m * n) == want["bytes"]
    assert got["flops_by_dtype"] == {"float32": 2 * m * n * k}


def test_batched_einsum_flops_equal_xlas(xla):
    model, jnp = xla
    got = TorchCostModel().analyze(
        lambda a, b: torch.einsum("bij,bjk->bik", a, b), meta(3, 64, 32),
        meta(3, 32, 16))
    want = model.analyze(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                         jnp.zeros((3, 64, 32)), jnp.zeros((3, 32, 16)))
    assert got["flops"] == want["flops"] == 2 * 3 * 64 * 32 * 16


def test_elementwise_bytes_are_in_plus_out(xla):
    model, jnp = xla
    cm = TorchCostModel()
    got = cm.analyze(torch.add, meta(64, 32), meta(64, 32))
    want = model.analyze(lambda a, b: a + b, jnp.zeros((64, 32)),
                         jnp.zeros((64, 32)))
    assert got["bytes"] == 3 * 64 * 32 * 4 == want["bytes"]
    assert got["flops"] == 0.0          # products only
    cast = cm.analyze(lambda x: x.to(torch.bfloat16), meta(10, 10))
    assert cast["bytes"] == 100 * 4 + 100 * 2


def test_views_and_allocations_move_nothing():
    cm = TorchCostModel()
    got = cm.analyze(lambda x: x.reshape(-1)[:5].unsqueeze(0).t(),
                     meta(8, 4))
    assert got["bytes"] == 0.0 and got["ops"] >= 4
    # a reshape that must copy moves the tensor once each way
    assert cm.analyze(lambda x: x.t().reshape(-1),
                      meta(8, 4))["bytes"] == 2 * 32 * 4
    assert cm.analyze(lambda: torch.empty(100, device="meta"))["bytes"] == 0


def test_transcendentals_are_output_elements():
    cm = TorchCostModel()
    x = meta(8, 16)
    assert cm.analyze(torch.exp, x)["transcendentals"] == 128
    assert cm.analyze(lambda t: torch.softmax(t, -1),
                      x)["transcendentals"] == 128
    assert cm.analyze(lambda t: t * 2, x)["transcendentals"] == 0


def test_a_tensor_off_meta_raises():
    with pytest.raises(ValueError, match="meta"):
        TorchCostModel().analyze(torch.exp, torch.zeros(3))


def test_flops_split_by_operand_type():
    got = TorchCostModel().analyze(
        lambda a, b, c, d: (a @ b, c @ d), meta(8, 8),
        meta(8, 8), meta(8, 8, dtype=torch.bfloat16),
        meta(8, 8, dtype=torch.bfloat16))
    assert got["flops_by_dtype"] == {"float32": 1024.0, "bfloat16": 1024.0}
    assert got["flops"] == 2048.0


def qwen3_smoke_flops(b, t):
    cfg = configs.get_smoke("qwen3-0.6b")
    model = T.Transformer(cfg, device="meta")
    toks = torch.zeros((b, t), dtype=torch.int32, device="meta")
    return cfg, model, TorchCostModel().analyze(T.forward, model,
                                                {"tokens": toks})


def test_qwen3_smoke_forward_on_meta_is_2ND_plus_attention():
    """model_flops' 2·N·D counts each parameter once a token; the count
    adds the attention products, a full T x S rectangle in the plain
    version the kernel route runs on meta; norm scales take part in no
    product."""
    b, t = 2, 24
    cfg, model, got = qwen3_smoke_flops(b, t)
    n = cfg.param_count()
    norm = sum(p.numel() for name, p in model.named_parameters()
               if name.rsplit(".", 2)[-2] in
               ("ln1", "ln2", "final_norm", "q_norm", "k_norm"))
    attention = cfg.n_layers * 4 * b * cfg.n_heads * t * t * cfg.hd
    record = {"params": n, "kind": "prefill", "global_batch": b,
              "seq_len": t}
    assert model_flops(record) == 2.0 * n * b * t
    assert got["flops"] == model_flops(record) - 2.0 * norm * b * t \
        + attention
    assert set(got["flops_by_dtype"]) == {"float32"}


def test_cost_model_allocates_nothing():
    """Every op of a qwen3 smoke forward ran on meta (any other device
    would have raised), and the model's weights were never drawn."""
    _, model, got = qwen3_smoke_flops(1, 16)
    assert got["ops"] > 100 and got["bytes"] > 0
    assert all(p.is_meta for p in model.parameters())


def probe(arch, n_layers, t=16):
    """A probe record of ``arch``'s smoke config cut to ``n_layers``: the
    counted FLOPs and bytes of a ``t``-token prefill on meta, no
    collectives (one card)."""
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=n_layers)
    model = T.Transformer(cfg, device="meta")
    toks = torch.zeros((1, t), dtype=torch.int32, device="meta")
    a = TorchCostModel().analyze(T.prefill, model, {"tokens": toks}, t + 1)
    return {"n_layers": n_layers,
            "cost_analysis": {"flops": a["flops"],
                              "bytes accessed": a["bytes"]},
            "collectives": {"wire_bytes": 0}}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-0.6b"])
def test_probe_records_extrapolate_exactly(arch):
    p1, p2, p4 = probe(arch, 1), probe(arch, 2), probe(arch, 4)
    terms = extrapolate_terms(p1, p2, 4)
    assert terms["flops"] == p4["cost_analysis"]["flops"]
    assert terms["bytes"] == p4["cost_analysis"]["bytes accessed"]
    assert terms["wire"] == 0
    costs = LayerCosts.from_probes(p1, p2, 4)
    slope = p2["cost_analysis"]["flops"] - p1["cost_analysis"]["flops"]
    assert costs.layer_compute == slope / H100.peak_flops
    assert costs.head_compute == (p1["cost_analysis"]["flops"] - slope) \
        / H100.peak_flops
    assert costs.layer_collective == 0.0 and costs.n_layers == 4


def test_report_is_the_reference_formula():
    c = dataclasses.replace(H100_SXM, matmul_efficiency=0.5,
                            matmul_efficiency_f32=0.25)
    cm = TorchCostModel(c)
    a, bm = meta(256, 512), meta(512, 128)
    got = cm.analyze(torch.matmul, a, bm)
    rep = cm.report("mm", torch.matmul, a, bm, in_bytes=9e9, out_bytes=4.5e9)
    flops_s = got["flops"] / (c.peak_flops_f32 * 0.25)
    assert rep.compute_s == max(flops_s, got["bytes"] / c.hbm_bw)
    assert rep.dma_in_s == 9e9 / c.link_bw == 0.02
    assert rep.dma_out_s == 0.01
    assert rep.device_kind == "gpu" and rep.meta["flops"] == got["flops"]


def test_h100_records_agree():
    """The roofline's ``H100`` is the constants' card: bf16 peak, HBM3,
    one NVLink direction (half the datasheet's 900 GB/s), 80 GB, one NDR
    port between nodes, eight GPUs a node."""
    c = GPUConstants()
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw, H100.hbm_bytes,
            H100.internode_bw) == (c.peak_flops, c.hbm_bw, c.link_bw,
                                   c.hbm_bytes, c.internode_bw)
    assert c.link_bw * 2 == 900e9 and H100.chips_per_pod == 8
    assert c.peak("bfloat16") == 989e12 and c.peak("float32") == 67e12
    assert 0 < c.matmul_efficiency <= 1 and 0 < c.matmul_efficiency_f32 <= 1
    assert np.isclose(c.flops_seconds({"float32": 67e12, "bfloat16": 989e12}),
                      1 / c.matmul_efficiency_f32 + 1 / c.matmul_efficiency)
