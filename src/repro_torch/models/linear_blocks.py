"""Attention-free blocks: RWKV6 ("Finch") time and channel mix, and
Mamba2 (SSD), zamba2's backbone.

The JAX package's ``repro/models/linear_blocks.py``.  Both blocks share
one core, decayed linear attention,

    o_t = r_t S_{t-1} + ((r_t ⊙ u)·k_t) v_t
    S_t = diag(w_t) S_{t-1} + kᵀ_t v_t

with a per-channel data-dependent decay ``w`` (RWKV6) or one decay a
step and head broadcast over the state's rows, with ``u = 0`` (Mamba2:
``r = C``, ``k = B``, ``v = dt·x``).  Prefill routes on the model's
``attn_impl``, the field that routes attention too:

* ``"kernel"`` (the port's default) —
  :func:`repro_torch.kernels.ops.linear_attn`: the hand-written Hopper
  kernels (``csrc/linear_attn_tc.cu``, ``csrc/linear_attn.cu``) for CUDA
  tensors, the exact per-step recurrence for CPU tensors;
* ``"chunked"`` or ``"naive"`` — :func:`linear_attention_chunked`, the
  JAX package's pure-jnp production path in plain PyTorch (a loop over
  chunks, the same closed form as the kernel).

Mamba2's operands reach the kernel in f32: its ``v = dt·x`` is f32 in
the JAX package (a bf16 ``x`` times an f32 ``dt``), and ``r``/``k`` are
lifted to f32 to match, which is exact; the output is cast to the
model's type, as ``linear_attention_chunked`` casts to ``r``'s.

Decode carries the ``(dk, dv)`` state explicitly through
:func:`linear_attention_decode`, plain PyTorch as in the JAX package,
and updates the state's tensors in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops, ref
from .layers import Dense, RMSNorm, _param

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Decayed linear attention
# ---------------------------------------------------------------------------

def linear_attention_chunked(r, k, v, w, u, *, chunk: int = 64
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk).

    Returns ``(out (B, H, T, dv) in r's dtype, final state (B, H, dk, dv)
    f32)`` from a zero state.  Padded steps have ``w = 1`` and ``k = v =
    0``, so the state passes through them unchanged; every decay exponent
    is ≤ 0."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    t0 = t
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, pad), value=1.0)
        t = t + pad
    n = t // chunk
    rc, kc, vc, wc = (x.reshape(b, h, n, chunk, -1) for x in (r, k, v, w))
    uf = u.float()[None, :, None, :]                           # (1, H, 1, dk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    eye = torch.eye(chunk, device=r.device)
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for j in range(n):
        rj, kj, vj, wj = (x[:, :, j].float() for x in (rc, kc, vc, wc))
        logw = torch.log(torch.clamp_min(wj, 1e-30))
        a_inc = torch.cumsum(logw, dim=2)
        a_exc = a_inc - logw
        a_end = a_inc[:, :, -1:, :]
        inter = torch.einsum("bhtk,bhkv->bhtv", rj * torch.exp(a_exc), state)
        diff = torch.clamp_max(a_exc[:, :, :, None, :]
                               - a_inc[:, :, None, :, :], 0.0)  # (b,h,C,C,dk)
        dec = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
        scores = torch.einsum("bhtk,bhsk,bhtsk->bhts", rj, kj, dec)
        bonus = torch.sum(rj * uf * kj, dim=-1)                 # (b,h,C)
        scores = scores + eye[None, None] * bonus[:, :, :, None]
        intra = torch.einsum("bhts,bhsv->bhtv", scores, vj)
        k_dec = kj * torch.exp(a_end - a_inc)
        state = (torch.exp(a_end).transpose(2, 3) * state
                 + torch.einsum("bhtk,bhtv->bhkv", k_dec, vj))
        outs.append(inter + intra)
    out = torch.stack(outs, dim=2).reshape(b, h, t, dv)[:, :, :t0]
    return out.to(r.dtype), state


def linear_attention_decode(r, k, v, w, u, state
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: r/k/w (B, H, dk), v (B, H, dv), state (B, H, dk, dv)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    bonus = torch.sum(rf * u[None].float() * kf, dim=-1)
    out = torch.einsum("bhk,bhkv->bhv", rf, state) + bonus[..., None] * vf
    state = wf[..., None] * state + kf[..., None] * vf[..., None, :]
    return out.to(r.dtype), state


def linear_attention_kernel(r, k, v, w, u, *, chunk: int = 64
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`linear_attention_chunked`'s contract through
    :func:`repro_torch.kernels.ops.linear_attn`, with the heads flattened
    as ``(B, H)`` so that row ``b·H + h`` takes ``u[h]``.  On ``meta``
    tensors (the cost model's) it runs the plain version, which computes
    nothing there and gives the outputs' shapes."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    flat = [x.reshape(b * h, t, x.shape[-1]).contiguous()
            for x in (r, k, v, w)]
    if r.is_meta:
        out, state = ref.linear_attention_state(*flat, u.contiguous())
    else:
        out, state = ops.linear_attn_state(*flat, u.contiguous(),
                                           chunk=chunk)
    return out.reshape(b, h, t, dv), state.reshape(b, h, dk, dv)


# ---------------------------------------------------------------------------
# RWKV6 block (time mix + channel mix)
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x: (B, T, d) → x shifted right by one; ``last`` supplies position
    -1 (zeros when it is None)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``a·m + b·(1 - m)`` in f32, cast to ``dtype``."""
    return (a.float() * m + b.float() * (1 - m)).to(dtype)


class RWKV6(nn.Module):
    """One RWKV6 layer (``rwkv6_init`` / ``rwkv6_block``).  Its attributes
    are the JAX parameter keys (``ln1, ln2, mix, wr, wk, wv, wg, ww,
    w_bias, bonus, gn, wo, cmix, ck, cv, cr``), drawn in that order from
    the JAX package's distributions.

    ``impl`` routes prefill's linear attention: ``"kernel"`` through
    :func:`linear_attention_kernel`, anything else (``"chunked"``,
    ``"naive"``) through :func:`linear_attention_chunked`."""

    def __init__(self, d: int, d_ff: int, head_dim: int = 64, *,
                 chunk: int = 64, impl: str = "kernel", dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.head_dim, self.chunk, self.impl = head_dim, chunk, impl
        h = d // head_dim
        kw = dict(dtype=dtype, device=device, generator=generator)

        def uniform_mix(t):
            nn.init.uniform_(t, 0.0, 1.0, generator=generator)
            t.mul_(0.5).add_(0.25)

        self.ln1 = RMSNorm(d, dtype=dtype, device=device)
        self.ln2 = RMSNorm(d, dtype=dtype, device=device)
        self.mix = _param((5, d), dtype, device, uniform_mix)
        self.wr = Dense(d, d, **kw)
        self.wk = Dense(d, d, **kw)
        self.wv = Dense(d, d, **kw)
        self.wg = Dense(d, d, **kw)
        self.ww = Dense(d, d, scale=0.01, **kw)
        # base decay ≈ e^{-e^{-4}}
        self.w_bias = _param((d,), dtype, device, lambda t: t.fill_(-4.0))
        self.bonus = _param(
            (h, head_dim), dtype, device,
            lambda t: nn.init.normal_(t, 0.0, 1.0,
                                      generator=generator).mul_(0.1))
        self.gn = RMSNorm(d, dtype=dtype, device=device)
        self.wo = Dense(d, d, **kw)
        self.cmix = _param((2, d), dtype, device, uniform_mix)
        self.ck = Dense(d, d_ff, **kw)
        self.cv = Dense(d_ff, d, **kw)
        self.cr = Dense(d, d, **kw)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[State] = None,
                cache_length: Union[int, torch.Tensor, None] = None
                ) -> Tuple[torch.Tensor, State]:
        """Returns ``(x, state)``.  Prefill (``cache`` None, or more than
        one token) starts from a zero state and returns a fresh one;
        decode (``cache`` given, one token) continues ``cache`` and updates
        its tensors in place.  ``positions`` and ``cache_length`` are not
        used: the state carries no positions."""
        b, t, d = x.shape
        hd = self.head_dim
        h = d // hd
        decoding = cache is not None and t == 1

        # ---- time mix ------------------------------------------------------
        xn = self.ln1(x)
        shifted = _token_shift(xn, cache["shift1"] if decoding else None)
        mix = self.mix.float()
        r = self.wr(_lerp(xn, shifted, mix[0], x.dtype)).reshape(b, t, h, hd)
        k = self.wk(_lerp(xn, shifted, mix[1], x.dtype)).reshape(b, t, h, hd)
        v = self.wv(_lerp(xn, shifted, mix[2], x.dtype)).reshape(b, t, h, hd)
        g = self.wg(_lerp(xn, shifted, mix[3], x.dtype))
        w_log = (self.ww(_lerp(xn, shifted, mix[4], x.dtype)).float()
                 + self.w_bias.float())
        w = torch.exp(-torch.exp(w_log)).reshape(b, t, h, hd)   # (0, 1)

        rt, kt, vt, wt = (a.transpose(1, 2) for a in (r, k, v, w))
        if decoding:
            o1, wkv = linear_attention_decode(
                rt[:, :, 0], kt[:, :, 0], vt[:, :, 0], wt[:, :, 0],
                self.bonus, cache["wkv"])
            o = o1[:, None]                                     # (b,1,h,hd)
        else:
            attend = (linear_attention_kernel if self.impl == "kernel"
                      else linear_attention_chunked)
            o, wkv = attend(rt, kt, vt, wt, self.bonus,
                            chunk=min(self.chunk, t))
            o = o.transpose(1, 2)
        o = o.reshape(b, t, d)
        o = self.gn(o) * F.silu(g)
        x = x + self.wo(o)

        # ---- channel mix ---------------------------------------------------
        xn2 = self.ln2(x)
        shifted2 = _token_shift(xn2, cache["shift2"] if decoding else None)
        cm = self.cmix.float()
        xk = _lerp(xn2, shifted2, cm[0], x.dtype)
        xr = _lerp(xn2, shifted2, cm[1], x.dtype)
        kk = torch.square(F.relu(self.ck(xk)))
        x = x + self.cv(kk) * torch.sigmoid(self.cr(xr))

        new_state = {"wkv": wkv, "shift1": xn[:, -1, :],
                     "shift2": xn2[:, -1, :]}
        if decoding:
            # into the state's own buffers, so that a decode step captured
            # in a CUDA graph advances the buffers it was captured on
            for name, value in new_state.items():
                cache[name].copy_(value)
            return x, cache
        return x, new_state


def rwkv6_state_init(batch: int, d: int, head_dim: int = 64, *,
                     dtype=torch.float32, device=None) -> State:
    """A zero decode state: ``wkv (B, H, hd, hd)`` f32, ``shift1`` and
    ``shift2`` ``(B, d)`` in ``dtype``."""
    h = d // head_dim
    return {"wkv": torch.zeros((batch, h, head_dim, head_dim),
                               dtype=torch.float32, device=device),
            "shift1": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift2": torch.zeros((batch, d), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  ``x (B, T, C)``, ``kernel (W, C)``;
    ``cache (B, W-1, C)`` supplies the inputs before ``x`` (zeros when it
    is None).  Returns ``(y, new cache)``, the cache being the last
    ``W-1`` inputs.  The taps are summed in the JAX package's order and
    type (``x``'s times the kernel's)."""
    w = kernel.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # (B, T+W-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(w))
    return y, xp[:, -(w - 1):, :]


class Mamba2(nn.Module):
    """One Mamba2 layer (``mamba2_init`` / ``mamba2_block``).  Its
    attributes are the JAX parameter keys (``ln, in_proj, conv, a_log,
    dt_bias, d_skip, out_norm, out_proj``); ``a_log``, ``dt_bias`` and
    ``d_skip`` are f32 whatever the model's type, as in the JAX package.

    ``impl`` routes prefill's linear attention as :class:`RWKV6`'s does.
    On a CUDA tensor a call the kernel refuses raises
    :class:`repro_torch.DeviceError`; nothing falls back to the chunked
    form."""

    def __init__(self, d: int, *, d_state: int = 64, expand: int = 2,
                 head_dim: int = 64, conv_width: int = 4, chunk: int = 64,
                 impl: str = "kernel", dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d_inner = expand * d
        h = d_inner // head_dim
        self.d_state, self.d_inner, self.head_dim = d_state, d_inner, head_dim
        self.chunk, self.impl = chunk, impl
        kw = dict(dtype=dtype, device=device, generator=generator)
        f32 = torch.float32
        self.ln = RMSNorm(d, dtype=dtype, device=device)
        # in_proj -> [z (d_inner), x (d_inner), B (d_state), C (d_state),
        # dt (h)]
        self.in_proj = Dense(d, 2 * d_inner + 2 * d_state + h, **kw)
        self.conv = _param(
            (conv_width, d_inner + 2 * d_state), dtype, device,
            lambda t: nn.init.normal_(t, 0.0, 1.0,
                                      generator=generator).mul_(0.1))
        self.a_log = _param((h,), f32, device, lambda t: t.copy_(torch.log(
            torch.linspace(1.0, 16.0, h, device=t.device))))
        self.dt_bias = _param((h,), f32, device, nn.init.zeros_)
        self.d_skip = _param((h,), f32, device, nn.init.ones_)
        self.out_norm = RMSNorm(d_inner, dtype=dtype, device=device)
        self.out_proj = Dense(d_inner, d, **kw)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[State] = None,
                cache_length: Union[int, torch.Tensor, None] = None
                ) -> Tuple[torch.Tensor, State]:
        """Returns ``(x, state)``, as :meth:`RWKV6.forward`: prefill
        (``cache`` None, or more than one token) starts from a zero state
        and returns a fresh ``{ssm, conv}``; decode (one token) continues
        ``cache`` and updates its tensors in place."""
        b, t, _ = x.shape
        d_inner, ds, hd = self.d_inner, self.d_state, self.head_dim
        h = d_inner // hd
        decoding = cache is not None and t == 1

        zxbcdt = self.in_proj(self.ln(x))
        z, xin, bc, dt = torch.split(zxbcdt, [d_inner, d_inner, 2 * ds, h],
                                     dim=-1)
        conv_out, conv_cache = _causal_conv(
            torch.cat([xin, bc], dim=-1), self.conv,
            cache["conv"] if decoding else None)
        conv_out = F.silu(conv_out)
        xs, b_in, c_in = torch.split(conv_out, [d_inner, ds, ds], dim=-1)

        dt_f = F.softplus(dt.float() + self.dt_bias)              # (B,T,h)
        a = torch.exp(-dt_f * torch.exp(self.a_log))              # (B,T,h)
        xh = xs.reshape(b, t, h, hd)
        # r = C, k = B (shared across heads), v = dt·x; one decay a head
        rt = c_in.float()[:, None].expand(b, h, t, ds)
        kt = b_in.float()[:, None].expand(b, h, t, ds)
        vt = (xh * dt_f[..., None]).transpose(1, 2)               # f32
        wt = a.transpose(1, 2)[..., None].expand(b, h, t, ds)
        u0 = torch.zeros((h, ds), dtype=torch.float32, device=x.device)
        if decoding:
            o1, ssm = linear_attention_decode(
                rt[:, :, 0], kt[:, :, 0], vt[:, :, 0], wt[:, :, 0], u0,
                cache["ssm"])
            y = o1[:, None]                                      # (B,1,h,hd)
        else:
            attend = (linear_attention_kernel if self.impl == "kernel"
                      else linear_attention_chunked)
            o, ssm = attend(rt, kt, vt, wt, u0, chunk=min(self.chunk, t))
            y = o.transpose(1, 2)                                # (B,T,h,hd)
        y = y.to(c_in.dtype) + xh * self.d_skip.to(xh.dtype)[None, None, :,
                                                              None]
        y = y.reshape(b, t, d_inner)
        y = self.out_norm(y) * F.silu(z)
        out = x + self.out_proj(y)
        if decoding:
            # into the state's own buffers (a captured decode step
            # advances the buffers it was captured on)
            cache["ssm"].copy_(ssm)
            cache["conv"].copy_(conv_cache)
            return out, cache
        return out, {"ssm": ssm, "conv": conv_cache}


def mamba2_state_init(batch: int, d: int, *, d_state: int = 64,
                      expand: int = 2, head_dim: int = 64,
                      conv_width: int = 4, dtype=torch.float32,
                      device=None) -> State:
    """A zero decode state: ``ssm (B, h, d_state, head_dim)`` f32 and
    ``conv (B, conv_width - 1, expand·d + 2·d_state)`` in ``dtype``."""
    d_inner = expand * d
    h = d_inner // head_dim
    return {"ssm": torch.zeros((batch, h, d_state, head_dim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_inner + 2 * d_state),
                                dtype=dtype, device=device)}
