"""Analytic per-device HBM-traffic floor — the JAX package's
``repro/roofline/analytic.py``, arithmetic for arithmetic.

The counted ``bytes accessed`` charges every op's operands as memory
traffic; a fused execution keeps most of it in registers and shared
memory, so that count overstates HBM traffic (kept in the table as
``memory_hlo_s``, a diagnostic upper bound).  The *floor* model below
counts the traffic a perfectly-fused execution cannot avoid:

  train   — weights read twice (fwd+bwd), gradient write+read, parameter
            read+write and two moments read+write at the optimizer;
            layer-boundary activations (saved + reread + remat recompute
            reread); logits write+read (f32).
  prefill — weights read once, layer-boundary activations, KV-cache write.
  decode  — weights read once, full cache read + new-token write.

All quantities are per device under the cell's sharding: resident
parameter bytes divide by the axes that shard them (TP, ×DP when FSDP);
activations/tokens divide by the batch-sharding axes; caches divide by
(batch × sequence/head) sharding.

Copied with the reference's fixed model axis, ``tp = 16``
(``analytic.py:58-60``): right for JAX's 16×16 and 2×16×16 meshes, wrong
for ``mesh_variant(32, 8)``, whose model axis is 8.  Under 16 devices
``n_dev // 16`` is 0 and the reference divides by zero; the port raises a
``ValueError`` that says so instead (ROADMAP §3, standing).
"""
from __future__ import annotations

import math
from typing import Dict

from .model import H100, HW

#: The reference's fixed model-axis width.
TP = 16


def _cfg_of(record: Dict):
    from .. import configs
    return configs.get_config(record["arch"])


def _plan_of(cfg):
    from ..parallel.sharding import plan_for
    return plan_for(cfg)


def cache_bytes_global(cfg, batch: int, seq: int) -> int:
    """Total decode-cache bytes (KV or recurrent state), all devices."""
    from ..models.transformer import init_cache
    return sum(int(math.prod(t.shape)) * t.element_size()
               for entry in init_cache(cfg, batch, seq, device="meta")
               for t in entry.values())


def min_traffic_bytes(record: Dict, hw: HW = H100) -> float:
    """Per-device HBM-traffic floor for this cell, in bytes."""
    cfg = _cfg_of(record)
    plan = _plan_of(cfg)
    kind = record["kind"]
    n_dev = int(record["n_devices"])
    tp = TP
    dp = n_dev // tp
    if dp == 0:
        raise ValueError(f"{record['arch']} on {n_dev} devices: the traffic "
                         f"floor fixes a model axis of {tp}, so it needs at "
                         f"least {tp} devices (the JAX package divides by "
                         f"zero here)")
    b, s = record["global_batch"], record["seq_len"]

    p_bytes = record["params"] * 2                       # bf16 weights
    w_shards = n_dev if plan.fsdp else tp                # FSDP vs TP-resident
    p_loc = p_bytes / w_shards

    tokens_dev = b * s / min(dp, b)          # batch shards over ≤ b rows
    act_loc = tokens_dev * cfg.d_model * 2               # one residual, bf16

    if kind == "train":
        weights = 2 * p_loc                              # fwd + bwd reads
        grads = 2 * p_loc                                # write + opt read
        m_itemsize = 2 if "bfloat16" in str(plan.moment_dtype) else 4
        opt = (2 + 4) * record["params"] * m_itemsize / w_shards  # p rw, 2m rw
        n_saved = cfg.n_layers * (2 if plan.remat == "full" else 1)
        acts = act_loc * n_saved * 2                     # write + read
        logits = tokens_dev * cfg.vocab / tp * 4 * 2     # f32 write + read
        return weights + grads + opt + acts + logits
    if kind == "prefill":
        cache = cache_bytes_global(cfg, b, s) / n_dev
        return p_loc + act_loc * cfg.n_layers * 2 + cache
    # decode: read every weight + the whole cache once per token
    cache_shards = min(dp, b) * tp
    cache = cache_bytes_global(cfg, b, s) / cache_shards
    return p_loc + cache


def min_traffic_seconds(record: Dict, hw: HW = H100) -> float:
    return min_traffic_bytes(record, hw) / hw.hbm_bw
