"""Model assembly for every architecture of the JAX package — the dense
attention LMs, the MoE LMs (mixtral, llama4), RWKV6, zamba2 (Mamba2 with
a weight-shared attention block), whisper (an encoder-decoder with
cross-attention) and pixtral (patch embeddings fused before the text) —
and their serving paths.

:class:`ModelConfig` and :class:`BlockSpec` are the JAX package's
(``repro/models/transformer.py``), field for field, so its config modules
copy verbatim; two defaults differ: ``param_dtype`` is
``torch.bfloat16``, and ``attn_impl`` is ``"kernel"`` — the flash kernel
for attention and the linear-attention kernel for the prefill of RWKV6
and Mamba2 (the JAX package's own accelerator hot paths); on a CPU
tensor that route runs the kernels' plain versions.

:class:`Transformer` holds the layers in a ``ModuleList`` in layer order:
layer ``period * len(pattern) + i`` is the JAX package's stacked
``blocks{i}[period]``.  With ``shared_every`` (zamba2) it also holds one
``shared`` attention block, applied after every segment of
``shared_every`` layers that :meth:`ModelConfig.segments` marks, with
the same weights at each of its ``n_shared_sites`` sites
(``_walk_stack``).  With ``encoder_layers`` (whisper) it holds the
:class:`Encoder` and one :class:`CrossAttention` a period (``cross``),
applied after that period's pattern elements against the encoder's k/v.
:func:`forward`, :func:`prefill`, :func:`decode_step` and
:func:`init_cache` are the train and serving paths of
``transformer.py:513-586``, taking the model where the JAX functions
take ``(cfg, params)``; a batch carries ``tokens`` and, for pixtral,
``patches`` (prepended to the token embeddings: positions run over the
fused sequence, and :func:`forward` returns the text positions' logits)
or, for whisper, ``frames`` (the encoder's input).

A cache is a list of dicts: entry ``n < n_layers`` is layer ``n``'s —
``{k, v}`` ``(B, max_len, Hkv, hd)`` for an attention layer, ``{wkv,
shift1, shift2}`` for RWKV6, ``{ssm, conv}`` for Mamba2 — entry
``n_layers + s`` is shared site ``s``'s ``{k, v}`` (the JAX package's
``cache["shared"][s]``), and entry ``n_layers + n_shared_sites + p`` is
period ``p``'s cross-attention ``{k, v}`` ``(B, encoder_seq, Hkv, hd)``
over the encoder's output (``cache["enc_kv"]``).  Decode updates every
entry in place except the cross-attention entries, which it only reads.
:func:`forward` returns the MoE layers' auxiliary losses summed, as the
JAX package's does, and :func:`lm_loss` is the training loss over it.
Where autograd records the forward, each period of the walk runs under
``cfg.remat`` (``"none"``, ``"full"`` or ``"dots"``), as the JAX package
checkpoints its scan body (:func:`_walk_aux`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import Attention, Cache, attention_chunked
from .layers import (MLP, Dense, Embedding, RMSNorm, resolve_device,
                     resolve_dtype, softcap)
from .linear_blocks import (RWKV6, Mamba2, mamba2_state_init,
                            rwkv6_state_init)
from .moe import MoE, moe_apply

#: Mamba2's head width: the JAX package's ``mamba2_init`` /
#: ``mamba2_block`` default, which its model never overrides (so it is not
#: ``cfg.hd``).
MAMBA2_HEAD_DIM = 64

# --------------------------------------------------------------------------
# Configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static settings of one sub-block of the layer pattern."""

    kind: str = "attn"                # attn | moe_attn | rwkv6 | mamba2
    window: int = 0                   # sliding-window size; 0 = full attention
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    # ---- attention features ----
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    attn_softcap: float = 0.0         # gemma2 attention-logit soft-capping
    final_softcap: float = 0.0        # gemma2 final-logit soft-capping
    post_norms: bool = False          # gemma2 sandwich norms
    zero_centered_norm: bool = False  # gemma-style (1 + scale) RMSNorm
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    mlp: str = "swiglu"               # swiglu | geglu | gelu
    tie_embeddings: bool = True
    # ---- layer pattern (cycled) ----
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False       # llama4: shared expert beside routed
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_dispatch: str = "einsum"      # einsum | scatter
    # ---- SSM / RWKV ----
    ssm_state: int = 64
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    scan_chunk: int = 64              # linear-attention chunk length
    # ---- hybrid (zamba2): weight-shared attn block every k layers ----
    shared_every: int = 0
    # ---- encoder-decoder (whisper) ----
    encoder_layers: int = 0
    encoder_seq: int = 1500           # frontend stub: #frames after conv
    # ---- multimodal frontend stub (pixtral) ----
    patch_tokens: int = 0
    # ---- numerics ----
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    attn_impl: str = "kernel"         # naive | chunked | kernel
    # ---- training-time activation checkpointing over the layer scan ----
    remat: str = "none"               # none | full | dots
    unroll_scan: bool = False

    # ------------------------------------------------------------- derived --
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern length "
                             f"{len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def n_shared_sites(self) -> int:
        return self.n_layers // self.shared_every if self.shared_every else 0

    def segments(self) -> List[Tuple[int, int, bool]]:
        """Stack walk plan: ``[(period_start, period_end, shared_after)]``."""
        if not self.shared_every:
            return [(0, self.n_periods, False)]
        if self.shared_every % len(self.pattern):
            raise ValueError(f"{self.name}: shared_every {self.shared_every} "
                             f"not a multiple of pattern length "
                             f"{len(self.pattern)}")
        seg_p = self.shared_every // len(self.pattern)
        out: List[Tuple[int, int, bool]] = []
        start = 0
        while start < self.n_periods:
            end = min(start + seg_p, self.n_periods)
            out.append((start, end, end - start == seg_p))
            start = end
        return out

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    def param_count(self) -> int:
        """Exact parameter count, from a model built on the ``meta``
        device (nothing is allocated)."""
        return Transformer(self, device="meta").param_count()

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: ``top_k`` of ``n_experts``
        routed), the JAX package's formula."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        moe_blocks = sum(1 for b in self.pattern if b.kind == "moe_attn")
        per_expert = 3 * self.d_model * self.d_ff
        n_moe_layers = self.n_periods * moe_blocks
        routed = n_moe_layers * self.n_experts * per_expert
        active = n_moe_layers * self.top_k * per_expert
        return total - routed + active


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------


class Block(nn.Module):
    """One attention block (``_block_apply`` for ``kind="attn"`` and
    ``"moe_attn"``): pre-norm attention, then the MLP or, for
    ``moe_attn``, the routed experts (``moe``) plus the shared MLP
    (``shared_mlp``, with ``shared_expert``), each with an optional
    post-norm (gemma2's sandwich), each added to the residual.  The
    attention runs ``impl`` (default: ``cfg.attn_impl``)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, *, device,
                 generator: Optional[torch.Generator],
                 impl: Optional[str] = None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.impl = cfg.attn_impl if impl is None else impl
        dtype = cfg.dtype
        norm = dict(d=cfg.d_model, dtype=dtype, device=device,
                    eps=cfg.norm_eps, zero_centered=cfg.zero_centered_norm)
        self.ln1 = RMSNorm(**norm)
        self.ln2 = RMSNorm(**norm)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              dtype=dtype, device=device, generator=generator,
                              qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias)
        if cfg.post_norms:
            self.post_ln1 = RMSNorm(**norm)
            self.post_ln2 = RMSNorm(**norm)
        else:
            self.post_ln1 = self.post_ln2 = None
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.mlp = self.moe = self.shared_mlp = None
        if spec.kind == "moe_attn":
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, **kw)
            if cfg.shared_expert:
                self.shared_mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache] = None,
                cache_length: Union[int, torch.Tensor, None] = None
                ) -> Tuple[torch.Tensor, Cache, Optional[torch.Tensor]]:
        """Returns ``(x, cache, aux)``: ``aux`` is the MoE's auxiliary
        loss (f32 scalar), None for a dense block."""
        cfg, spec = self.cfg, self.spec
        h, new_cache = self.attn(
            self.ln1(x), positions, rope_theta=cfg.rope_theta,
            causal=spec.causal, window=spec.window, cap=cfg.attn_softcap,
            impl=self.impl, kv_cache=cache, cache_length=cache_length)
        if self.post_ln1 is not None:
            h = self.post_ln1(h)
        x = x + h
        h = self.ln2(x)
        aux = None
        if self.moe is not None:
            out, aux = moe_apply(
                self.moe, h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                group_size=cfg.moe_group_size, dispatch=cfg.moe_dispatch)
            if self.shared_mlp is not None:
                out = out + self.shared_mlp(h)
            h = out
        else:
            h = self.mlp(h)
        if self.post_ln2 is not None:
            h = self.post_ln2(h)
        return x + h, new_cache, aux


#: The attention route of whisper's encoder and of every cross-attention,
#: whatever ``cfg.attn_impl`` says.
ENCODER_IMPL = "chunked"


class Encoder(nn.Module):
    """whisper's encoder (``_run_encoder``): ``encoder_layers``
    non-causal attention blocks (``layers``) over the frames, then a
    final ``norm``.

    Its attention runs :func:`~.attention.attention_chunked`
    (``ENCODER_IMPL``) whatever ``cfg.attn_impl`` says, a route fixed in
    the code: the JAX package's default arithmetic.  The kernel route
    cannot take it, because ``ops.attention`` pads whisper's 1500 frames
    to the kernels' 128-row blocks and refuses padded keys without the
    causal mask that hides them (as the JAX package's ``ops.attention``
    does); the flash kernels do not mask padded keys.  A departure from
    a model built with ``attn_impl="kernel"`` in the JAX package, which
    sends the encoder to its kernel (ROADMAP §3)."""

    def __init__(self, cfg: ModelConfig, *, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        spec = BlockSpec(kind="attn", causal=False)
        self.layers = nn.ModuleList(
            Block(cfg, spec, device=device, generator=generator,
                  impl=ENCODER_IMPL) for _ in range(cfg.encoder_layers))
        self.norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device,
                            eps=cfg.norm_eps,
                            zero_centered=cfg.zero_centered_norm)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """``frames (B, S, d)`` (cast to the weights' type) through the
        blocks at rope positions ``0..S-1``, then the norm."""
        x = frames.to(self.cfg.dtype)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for layer in self.layers:
            x, _, _ = layer(x, positions)
        return self.norm(x)


class CrossAttention(nn.Module):
    """One period's cross-attention (``_cross_attn_init``/``_apply``): a
    pre-norm ``ln`` and an ``attn`` whose ``wq``/``wo`` apply to the
    decoder and ``wk``/``wv`` to the encoder's output
    (:meth:`encoder_kv`).  No rope; non-causal over every frame, through
    :func:`~.attention.attention_chunked` always, as in the JAX
    package."""

    def __init__(self, cfg: ModelConfig, *, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device,
                          eps=cfg.norm_eps,
                          zero_centered=cfg.zero_centered_norm)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              dtype=cfg.dtype, device=device,
                              generator=generator)

    def encoder_kv(self, enc_out: torch.Tensor) -> Cache:
        """``{k, v}`` ``(B, S, n_kv, hd)`` over ``enc_out (B, S, d)``
        (``_encoder_kv``, one period)."""
        b, s, _ = enc_out.shape
        cfg = self.cfg
        return {"k": self.attn.wk(enc_out).reshape(b, s, cfg.n_kv, cfg.hd),
                "v": self.attn.wv(enc_out).reshape(b, s, cfg.n_kv, cfg.hd)}

    def forward(self, x: torch.Tensor, enc_kv: Cache) -> torch.Tensor:
        b, t, _ = x.shape
        cfg = self.cfg
        q = self.attn.wq(self.ln(x)).reshape(b, t, cfg.n_heads, cfg.hd)
        out = attention_chunked(q, enc_kv["k"], enc_kv["v"], causal=False)
        return x + self.attn.wo(out.reshape(b, t, cfg.n_heads * cfg.hd))


def _layer(cfg: ModelConfig, spec: BlockSpec, *, device,
           generator: Optional[torch.Generator]) -> nn.Module:
    """One layer of ``spec``'s kind (``_block_init``)."""
    if spec.kind == "rwkv6":
        return RWKV6(cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim,
                     chunk=cfg.scan_chunk, impl=cfg.attn_impl,
                     dtype=cfg.dtype, device=device, generator=generator)
    if spec.kind == "mamba2":
        return Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                      expand=cfg.ssm_expand, head_dim=MAMBA2_HEAD_DIM,
                      chunk=cfg.scan_chunk, impl=cfg.attn_impl,
                      dtype=cfg.dtype, device=device, generator=generator)
    return Block(cfg, spec, device=device, generator=generator)


class Transformer(nn.Module):
    """Embedding, the layers in layer order, the final norm, the head
    (tied to the embedding unless ``tie_embeddings`` is false), with
    ``shared_every`` the ``shared`` attention block, and with
    ``encoder_layers`` the ``encoder`` and the ``cross`` attentions, one
    a period (each None otherwise).

    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when none is given) in construction order; on the
    ``meta`` device nothing is allocated or drawn."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype, **kw)
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device,
                                  eps=cfg.norm_eps,
                                  zero_centered=cfg.zero_centered_norm)
        self.layers = nn.ModuleList(
            _layer(cfg, cfg.pattern[n % len(cfg.pattern)], **kw)
            for n in range(cfg.n_periods * len(cfg.pattern)))
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab, dtype=cfg.dtype, **kw))
        self.shared = (Block(cfg, BlockSpec(kind="attn"), **kw)
                       if cfg.shared_every else None)
        self.encoder = Encoder(cfg, **kw) if cfg.is_enc_dec else None
        self.cross = (nn.ModuleList(CrossAttention(cfg, **kw)
                                    for _ in range(cfg.n_periods))
                      if cfg.is_enc_dec else None)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self, batch)


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------


def _scale_embeddings(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.embed_scale:     # the factor rounded to the weights' type first
        # (a host scalar: no copy to the device, so that a decode step
        # can be captured in a CUDA graph)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    return x


def _embed_inputs(model: Transformer,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings, with pixtral's ``patches`` prepended (cast to the
    weights' type) before ``embed_scale``, as in the JAX package."""
    cfg = model.cfg
    x = model.embed(batch["tokens"]).to(cfg.dtype)
    if cfg.patch_tokens and "patches" in batch:
        x = torch.cat([batch["patches"].to(cfg.dtype), x], dim=1)
    return _scale_embeddings(cfg, x)


def _encoder_kv(model: Transformer,
                batch: Dict[str, torch.Tensor]) -> Optional[List[Cache]]:
    """Each period's cross-attention ``{k, v}`` over the encoder's output
    of ``batch["frames"]`` (``_run_encoder`` then ``_encoder_kv``); None
    for a decoder-only model."""
    if not model.cfg.is_enc_dec:
        return None
    enc_out = model.encoder(batch["frames"])
    return [cross.encoder_kv(enc_out) for cross in model.cross]


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x)
    out = (model.embed.unembed(x) if model.lm_head is None
           else model.lm_head(x))
    return softcap(out.float(), model.cfg.final_softcap)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None, :].expand(b, t)


def _period(model: Transformer, p: int, x: torch.Tensor, aux: torch.Tensor,
            positions: torch.Tensor, cache: Optional[List[Cache]],
            length: Union[int, torch.Tensor, None],
            enc_kv: Optional[List[Cache]]
            ) -> Tuple[torch.Tensor, torch.Tensor, List[Cache]]:
    """Period ``p`` of the stack, the body of the JAX package's layer
    scan: its pattern elements in order, then its cross-attention (against
    ``enc_kv``) when there is one.  Returns ``(x, aux, caches)``, ``aux``
    with the period's MoE losses added one at a time.  A block returns
    ``(x, cache, aux)``, a recurrent layer ``(x, state)``."""
    n_pat = len(model.cfg.pattern)
    caches: List[Cache] = []
    for n in range(p * n_pat, (p + 1) * n_pat):
        c = None if cache is None else cache[n]
        x, c, *extra = model.layers[n](x, positions, c, length)
        if extra and extra[0] is not None:
            aux = aux + extra[0]
        caches.append(c)
    if enc_kv is not None:
        x = model.cross[p](x, enc_kv[p])
    return x, aux, caches


#: The matmul operators whose outputs ``remat="dots"`` keeps (JAX's
#: ``checkpoint_dots``: every dot product's result).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: ``"full"`` keeps nothing of it
    for the backward pass and recomputes it there, ``"dots"`` keeps the
    matmuls' outputs only (:func:`_save_dots`)."""
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _walk_aux(model: Transformer, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[List[Cache]] = None,
              length: Union[int, torch.Tensor, None] = None,
              enc_kv: Optional[List[Cache]] = None
              ) -> Tuple[torch.Tensor, List[Cache], torch.Tensor]:
    """Apply the stack as ``_walk_stack`` does: the periods
    (:func:`_period`) segment by segment (:meth:`ModelConfig.segments`),
    each period's cross-attention after its pattern elements (against
    ``enc_kv``, or in decode the cache's cross entries), the shared block
    after each segment whose ``shared_after`` is true.  Without ``cache``
    every layer starts fresh; with it (decode) each continues its entry
    in place.  Returns ``(x, caches, aux)``: the layers' and sites'
    caches in the layout of the module docstring (no cross entries),
    ``aux`` the layers' MoE losses summed from an f32 zero (the shared
    block's is dropped, as in JAX).

    Where autograd records the forward (grad mode on and the model's
    parameters requiring grad), each period runs under ``cfg.remat``
    (:func:`_remat`), as the JAX package checkpoints its scan body; the
    periods' caches are then not kept, and the list holds the shared
    sites' alone.  Serving (frozen weights) never remats."""
    cfg = model.cfg
    if cfg.is_enc_dec and enc_kv is None:
        enc_kv = cache[cfg.n_layers + cfg.n_shared_sites:]
    remat = (cfg.remat != "none" and cache is None and torch.is_grad_enabled()
             and model.embed.table.requires_grad)
    layer_caches: List[Cache] = []
    site_caches: List[Cache] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p0, p1, shared_after in cfg.segments():
        for p in range(p0, p1):
            if remat:
                x, aux = _remat(
                    cfg, lambda x, aux, p=p: _period(
                        model, p, x, aux, positions, None, None, enc_kv)[:2],
                    x, aux)
            else:
                x, aux, caches = _period(model, p, x, aux, positions, cache,
                                         length, enc_kv)
                layer_caches += caches
        if shared_after:
            c = (None if cache is None
                 else cache[cfg.n_layers + len(site_caches)])
            x, c, *_ = model.shared(x, positions, c, length)
            site_caches.append(c)
    return x, layer_caches + site_caches, aux


def _walk(model: Transformer, x: torch.Tensor, positions: torch.Tensor,
          cache: Optional[List[Cache]] = None,
          length: Union[int, torch.Tensor, None] = None,
          enc_kv: Optional[List[Cache]] = None
          ) -> Tuple[torch.Tensor, List[Cache]]:
    """:func:`_walk_aux` without the auxiliary loss: ``(x, caches)``."""
    x, caches, _ = _walk_aux(model, x, positions, cache, length, enc_kv)
    return x, caches


def forward(model: Transformer, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns ``(logits (B, T, V) f32, aux)``,
    the logits of the text positions alone when ``patches`` are fused;
    ``aux`` is the MoE layers' auxiliary loss summed (f32 scalar; 0 for a
    model without MoE layers)."""
    x = _embed_inputs(model, batch)
    x, _, aux = _walk_aux(model, x,
                          _positions(x.shape[0], x.shape[1], x.device),
                          enc_kv=_encoder_kv(model, batch))
    logits = _logits(model, x)
    if model.cfg.patch_tokens and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    return logits, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> List[Cache]:
    """Zeroed decode cache in the layout of the module docstring:
    ``{k, v}``, each ``(batch, max_len, n_kv, hd)`` in the weights' type,
    for attention layers and shared sites;
    :func:`~.linear_blocks.rwkv6_state_init` for RWKV6 and
    :func:`~.linear_blocks.mamba2_state_init` for Mamba2; and ``{k, v}``,
    each ``(batch, encoder_seq, n_kv, hd)``, for each period's
    cross-attention."""
    device = resolve_device(device)

    def kv(length: int = max_len) -> Cache:
        shape = (batch, length, cfg.n_kv, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    cache = []
    for n in range(cfg.n_periods * len(cfg.pattern)):
        kind = cfg.pattern[n % len(cfg.pattern)].kind
        if kind == "rwkv6":
            cache.append(rwkv6_state_init(batch, cfg.d_model,
                                          cfg.rwkv_head_dim, dtype=cfg.dtype,
                                          device=device))
        elif kind == "mamba2":
            cache.append(mamba2_state_init(
                batch, cfg.d_model, d_state=cfg.ssm_state,
                expand=cfg.ssm_expand, head_dim=MAMBA2_HEAD_DIM,
                dtype=cfg.dtype, device=device))
        else:
            cache.append(kv())
    cache += [kv() for _ in range(cfg.n_shared_sites)]
    if cfg.is_enc_dec:
        cache += [kv(cfg.encoder_seq) for _ in range(cfg.n_periods)]
    return cache


def prefill(model: Transformer, batch: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, List[Cache]]:
    """Run the full prompt (``patch_tokens + T`` positions with fused
    patches); return ``(last-position logits (B, 1, V), cache)`` with the
    k/v of each attention layer and shared site zero-padded to
    ``max_len`` (``pad_kv``), each recurrent layer's state as it stands
    after the prompt, and each period's cross-attention k/v over the
    encoder's output of ``frames``."""
    x = _embed_inputs(model, batch)
    b, t, _ = x.shape
    enc_kv = _encoder_kv(model, batch)
    x, cache = _walk(model, x, _positions(b, t, x.device), enc_kv=enc_kv)
    cache = [{name: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, max_len - t))
              for name, a in c.items()} if "k" in c else c for c in cache]
    return _logits(model, x[:, -1:]), cache + (enc_kv or [])


def decode_step(model: Transformer, tokens: torch.Tensor, cache: List[Cache],
                length: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """One serving step: ``tokens (B, 1)`` against a cache whose first
    ``length`` positions are valid (an attention layer or shared site
    writes the new token, in place, at ``length - 1``; an RWKV6 or Mamba2
    layer advances its state in place; the cross-attention entries are
    read, never written).  Returns ``(logits (B, 1, V), cache)``.
    ``length`` may be a 0-d device tensor: the step then reads nothing on
    the host, which is what lets the serve engine capture it in a CUDA
    graph."""
    x = _scale_embeddings(model.cfg, model.embed(tokens).to(model.cfg.dtype))
    b, t, _ = x.shape
    length = torch.as_tensor(length, device=x.device)
    positions = (length - 1).reshape(1, 1).expand(b, t)
    x, _ = _walk(model, x, positions, cache, length)
    return _logits(model, x), cache


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


def lm_loss(model: Transformer, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over the f32 logits plus ``aux_weight``
    times the MoE auxiliary loss (``transformer.py:594-609``): labels
    below 0 are masked out, and the mean runs over the labels kept.
    Returns ``(total, {"loss", "aux"})``, ``loss`` the cross entropy
    alone."""
    logits, aux = forward(model, batch)
    labels = batch["labels"]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}
