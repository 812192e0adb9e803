"""Attention: GQA with qk-norm / rotary / sliding-window / soft-capping.

Three interchangeable inner implementations, as in the JAX package
(``repro/models/attention.py``), all on ``q (B, T, H, Dh)`` against
``k``/``v`` ``(B, S, Hkv, Dh)``:

* ``impl="naive"``   — materialises the ``(T, S)`` logits; the plain route.
* ``impl="chunked"`` — online softmax over key chunks, a Python loop.
* ``impl="kernel"``  — :func:`repro_torch.kernels.ops.attention`: the
  hand-written Hopper flash kernel for CUDA tensors, its plain version
  for CPU tensors.  The port's default route.  On ``meta`` tensors (the
  cost model's, :class:`repro_torch.core.hlsreport.TorchCostModel`) it
  runs the plain version, which computes nothing there and gives the
  output's shape; its operations are the plain version's, a full
  ``T x S`` rectangle of scores.

Decode (one query against a KV cache) uses :func:`attention_decode`, plain
PyTorch: the JAX package runs it as an einsum too, outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import ops, ref
from . import layers
from .layers import Dense, RMSNorm, rotary

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


def _mask(t: int, s: int, offset: int, causal: bool, window: int,
          device) -> torch.Tensor:
    q_pos = offset + torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    m = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        m &= k_pos <= q_pos
    if window > 0:
        m &= k_pos > q_pos - window
    return m


def attention_naive(q, k, v, *, causal=True, window=0, cap=0.0, offset=0):
    """q: (B, T, H, Dh); k/v: (B, S, Hkv, Dh)."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qf = q.float() * (dh ** -0.5)
    logits = torch.einsum("bthd,bshd->bhts", qf,
                          k.float().repeat_interleave(group, dim=2))
    logits = layers.softcap(logits, cap)
    logits = torch.where(
        _mask(t, s, offset, causal, window, q.device)[None, None], logits,
        NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs,
                       v.float().repeat_interleave(group, dim=2))
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=0, cap=0.0, offset=0,
                      chunk: int = 512):
    """Flash-style online softmax over key chunks."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    chunk = min(chunk, s)
    qf = (q.float() * (dh ** -0.5)).reshape(b, t, hkv, group, dh)
    q_pos = offset + torch.arange(t, device=q.device)
    m_run = torch.full((b, hkv, group, t, 1), NEG_INF, device=q.device)
    l_run = torch.zeros((b, hkv, group, t, 1), device=q.device)
    acc = torch.zeros((b, hkv, group, t, dh), device=q.device)
    for j0 in range(0, s, chunk):
        kf = k[:, j0:j0 + chunk].float()
        vf = v[:, j0:j0 + chunk].float()
        logits = torch.einsum("bthgd,bshd->bhgts", qf, kf)
        logits = layers.softcap(logits, cap)          # (b,hkv,g,t,chunk)
        k_pos = j0 + torch.arange(kf.shape[1], device=q.device)
        mask = torch.ones((t, kf.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m_run, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgts,bshd->bhgtd", p, vf)
        m_run = m_new
    l_run = torch.where(l_run == 0.0, 1.0, l_run)
    out = (acc / l_run).permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)
    return out.to(q.dtype)


def attention_kernel(q, k, v, *, causal=True, window=0, cap=0.0, offset=0):
    """The flash kernel; only valid for ``offset == 0`` (prefill)."""
    if offset != 0:
        raise ValueError("kernel path expects offset=0")
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    # heads flattened as (B, H): the kernel's GQA index h // group relies
    # on each batch's query heads following its own KV heads
    qh = q.transpose(1, 2).reshape(b * h, t, dh).contiguous()
    kh = k.transpose(1, 2).reshape(b * hkv, s, dh).contiguous()
    vh = v.transpose(1, 2).reshape(b * hkv, s, dh).contiguous()
    if qh.is_meta:
        out = ref.attention(qh, kh, vh, causal=causal, window=window,
                            softcap=cap)
    else:
        out = ops.attention(qh, kh, vh, causal=causal, window=window,
                            softcap=cap)
    return out.reshape(b, h, t, dh).transpose(1, 2)


def attention_decode(q, k_cache, v_cache, *,
                     length: Union[int, torch.Tensor], window=0, cap=0.0):
    """One-token decode: q (B, 1, H, Dh) vs cache (B, S, Hkv, Dh).

    ``length`` — number of valid cache positions (the new token is at
    ``length - 1``), a Python int or a 0-d tensor on the cache's device
    (the mask is then built on the device)."""
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    qf = (q.float() * (dh ** -0.5)).reshape(b, hkv, group, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    logits = layers.softcap(logits, cap)
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos < length
    if window > 0:
        valid &= k_pos > (length - 1) - window
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def write_cache(cache: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new (B, t, Hkv, Dh)`` into ``cache (B, S, Hkv, Dh)`` at the
    positions ``idx (t,)``, in place.  A DTensor cache sharded along S (the
    dry-run's sequence-sharded decode cache) has no sharding strategy for
    ``index_copy_``, so it takes the write as a select over every position
    (what a partitioned dynamic update of a sharded dim does); a plain
    cache is written by ``index_copy_``."""
    new = new.to(cache.dtype)
    if not hasattr(cache, "placements"):
        cache.index_copy_(1, idx, new)
        return
    pos = torch.arange(cache.shape[1], device=idx.device)
    hit = (pos[:, None] == idx[None, :]).to(cache.dtype)      # (S, t)
    cache.copy_(torch.where(hit.amax(dim=1)[None, :, None, None] > 0,
                            torch.einsum("st,bthd->bshd", hit, new), cache))


IMPLS = {"naive": attention_naive, "chunked": attention_chunked,
         "kernel": attention_kernel}


class Attention(nn.Module):
    """The attention sub-layer (``attn_apply``): projections ``wq``,
    ``wk``, ``wv``, ``wo``, optional ``q_norm``/``k_norm``, rotary, and
    one of :data:`IMPLS` for prefill or :func:`attention_decode` against
    a cache."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, *,
                 dtype, device, generator: Optional[torch.Generator],
                 qk_norm: bool = False, qkv_bias: bool = False):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = Dense(d, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = Dense(d, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = Dense(d, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = Dense(n_heads * head_dim, d, **kw)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, dtype=dtype, device=device)
            self.k_norm = RMSNorm(head_dim, dtype=dtype, device=device)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float = 1e4, causal: bool = True,
                window: int = 0, cap: float = 0.0, impl: str = "kernel",
                kv_cache: Optional[Cache] = None,
                cache_length: Union[int, torch.Tensor, None] = None,
                use_rope: bool = True
                ) -> Tuple[torch.Tensor, Cache]:
        """Returns ``(output, cache)``.

        Prefill: ``kv_cache=None`` runs q against this segment's own k/v
        and returns them as a fresh cache ``{k, v}``.  Decode: ``kv_cache``
        given and ``x`` is ``(B, t, d)``; the new k/v are written in place
        into the cache at ``cache_length - t``, and the cache returned.
        ``cache_length`` may be a device tensor: decode reads nothing on
        the host, so that a decode step can be captured in a CUDA
        graph."""
        b, t, _ = x.shape
        q = self.wq(x).reshape(b, t, self.n_heads, self.head_dim)
        k = self.wk(x).reshape(b, t, self.n_kv, self.head_dim)
        v = self.wv(x).reshape(b, t, self.n_kv, self.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if use_rope:
            q = rotary(q, positions, rope_theta)
            k = rotary(k, positions, rope_theta)

        if kv_cache is None:
            out = IMPLS[impl](q, k, v, causal=causal, window=window, cap=cap)
            new_cache = {"k": k, "v": v}
        else:
            length = torch.as_tensor(cache_length, device=x.device)
            idx = length - t + torch.arange(t, device=x.device)
            write_cache(kv_cache["k"], idx, k)
            write_cache(kv_cache["v"], idx, v)
            out = attention_decode(q, kv_cache["k"], kv_cache["v"],
                                   length=length, window=window, cap=cap)
            new_cache = kv_cache
        out = out.reshape(b, t, self.n_heads * self.head_dim)
        return self.wo(out), new_cache
