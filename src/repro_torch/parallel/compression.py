"""Gradient compression for the slow inter-pod hop: int8 linear
quantization with error feedback, and top-k sparsification — the JAX
package's ``repro/parallel/compression.py`` on tensors.

A tree is a tensor or a (nested) mapping of tensors, such as a dict of
gradients keyed by parameter name.  ``fake_quant_int8`` applies the
quantize→dequantize round trip inside the train step, so the numerical
effect of the wire format is exercised end to end
(``TrainConfig(compression="int8_ef")``); ``compress``/``decompress``
are the wire encoding itself.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the same leaves of each of
    ``rest``), keeping its nested mappings."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns ``(q int8, scale f32)``."""
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def fake_quant_int8(tree: Tree) -> Tree:
    """Quantize→dequantize every leaf (emulates the wire format)."""
    def one(g):
        q, s = compress(g)
        return decompress(q, s, g.dtype)
    return tree_map(one, tree)


# ---------------------------------------------------------------- error FB --


def ef_init(tree: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def ef_compress(tree: Tree, residual: Tree) -> Tuple[Tree, Tree]:
    """Error-feedback int8: compress ``(g + residual)``; the quantization
    error becomes the next step's residual.  Returns ``(dequantized tree,
    residual)``."""
    def one(g, r):
        corrected = g.float() + r
        q, s = compress(corrected)
        deq = decompress(q, s)
        return deq.to(g.dtype), corrected - deq
    pairs = tree_map(one, tree, residual)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def topk_sparsify(x: torch.Tensor, k_fraction: float = 0.01) -> torch.Tensor:
    """Keep the top-|k| fraction of entries (magnitude), zero the rest."""
    flat = torch.abs(x.reshape(-1)).float()
    k = max(int(flat.numel() * k_fraction), 1)
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))
