"""Shared layer primitives: norms, projections, rotary, MLPs, embeddings.

Each primitive is a plain function on tensors, with the JAX package's
arithmetic (``repro/models/layers.py``), and, where it holds weights, an
``nn.Module`` whose parameters carry the JAX package's names (``w``,
``b``, ``scale``, ``table``), so the state dict of a model is the JAX
parameter tree flattened.  Dense weights are ``(d_in, d_out)`` and apply
as ``x @ w``: carrying JAX weights over is a copy, not a transpose.

Initialisers take an explicit ``torch.Generator``; a module built on the
``meta`` device allocates and initialises nothing.  All products accept
bf16 activations; norms and rotary run in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device, require_cuda


def resolve_device(device=None) -> torch.device:
    """``device`` (default: the card) as a ``torch.device``; a CUDA device
    must exist (:class:`repro_torch.DeviceError`)."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"float32"``)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _param(shape, dtype, device, fill) -> nn.Parameter:
    """A parameter of ``shape``; ``fill(tensor)`` initialises an f32
    tensor in place unless the device is ``meta``, and the result is cast
    to ``dtype`` (the JAX initialisers draw in f32 and cast)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        fill(t)
    return nn.Parameter(t.to(dtype), requires_grad=False)


# ------------------------------------------------------------- functions --

def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:                      # gemma-style (1 + scale)
        s = 1.0 + s
    return (y * s).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding (logits against the embedding table)."""
    return x @ table.T


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float = 1e4) -> torch.Tensor:
    """x: ``(..., T, H, Dh)`` or ``(..., T, Dh)``; positions: ``(..., T)``.
    The angles are f32; the result is cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., T, half)
    if x.dim() == angles.dim() + 1:                        # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, gate: "Dense", up: "Dense", down: "Dense") -> torch.Tensor:
    return down(F.silu(gate(x)) * up(x))


def geglu(x, gate: "Dense", up: "Dense", down: "Dense") -> torch.Tensor:
    """gemma-style GeGLU (gate/up/down shapes as swiglu)."""
    return down(gelu(gate(x)) * up(x))


def gelu_mlp(x, up: "Dense", down: "Dense") -> torch.Tensor:
    return down(gelu(up(x)))


# --------------------------------------------------------------- modules --

class Dense(nn.Module):
    """``x @ w (+ b)``; ``w`` truncated-normal in [-2, 2] times ``scale``
    (default ``1/sqrt(d_in)``), ``b`` zeros."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 generator: Optional[torch.Generator], bias: bool = False,
                 scale: Optional[float] = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)

        def fill(t):
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            t.mul_(scale)

        self.w = _param((d_in, d_out), dtype, device, fill)
        self.b = (_param((d_out,), dtype, device, nn.init.zeros_)
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class RMSNorm(nn.Module):
    """``scale`` starts at ones."""

    def __init__(self, d: int, *, dtype, device, eps: float = 1e-6,
                 zero_centered: bool = False):
        super().__init__()
        self.eps, self.zero_centered = eps, zero_centered
        self.scale = _param((d,), dtype, device, nn.init.ones_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps, self.zero_centered)


class Embedding(nn.Module):
    """``table`` normal times 0.02; :meth:`unembed` is the tied head."""

    def __init__(self, vocab: int, d: int, *, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.table = _param(
            (vocab, d), dtype, device,
            lambda t: nn.init.normal_(t, 0.0, 1.0,
                                      generator=generator).mul_(0.02))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.table, tokens)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.table, x)


class MLP(nn.Module):
    """``kind`` is ``"swiglu"`` or ``"geglu"`` (gate, up, down) or
    ``"gelu"`` (up, down)."""

    def __init__(self, d: int, ff: int, kind: str, *, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if kind not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp {kind!r}")
        self.kind = kind
        kw = dict(dtype=dtype, device=device, generator=generator)
        if kind == "gelu":
            self.up = Dense(d, ff, **kw)
            self.down = Dense(ff, d, **kw)
        else:
            self.gate = Dense(d, ff, **kw)
            self.up = Dense(d, ff, **kw)
            self.down = Dense(ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "swiglu":
            return swiglu(x, self.gate, self.up, self.down)
        if self.kind == "geglu":
            return geglu(x, self.gate, self.up, self.down)
        return gelu_mlp(x, self.up, self.down)
