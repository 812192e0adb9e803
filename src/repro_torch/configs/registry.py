"""Architecture registry and the assigned input-shape cells.

The JAX package's registry (``repro/configs/registry.py``) without
``input_specs``: the dry-run's ``ShapeDtypeStruct`` stand-ins wait for the
port's dry-run (ROADMAP).  Every registered architecture provides its
published full-size config and a reduced smoke config of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..models.layers import resolve_device
from ..models.transformer import ModelConfig

# --------------------------------------------------------------------------
# Shape cells
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k":    Shape("train_4k",    4_096,   256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  Shape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   Shape("long_500k",  524_288,    1, "decode"),
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid/linear-attn
# (and SWA-bounded mixtral); skip for pure full-attention archs.
LONG_OK = ("rwkv6-1.6b", "zamba2-1.2b", "mixtral-8x22b")


def runnable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "full-attention arch: long_500k skipped"
    return True, ""


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Arch:
    id: str
    family: str
    config: Callable[[], ModelConfig]
    smoke: Callable[[], ModelConfig]
    notes: str = ""


_REGISTRY: Dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    _REGISTRY[arch.id] = arch
    return arch


def get_arch(arch_id: str) -> Arch:
    if arch_id not in _REGISTRY:
        from . import _load_all   # lazy: populate on first use
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"{arch_id!r} is not ported (the port has "
                       f"{', '.join(arch_ids())}, as the JAX package has)")
    return _REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return get_arch(arch_id).config()


def get_smoke(arch_id: str) -> ModelConfig:
    return get_arch(arch_id).smoke()


def arch_ids() -> Tuple[str, ...]:
    from . import _load_all
    _load_all()
    return tuple(_REGISTRY)


def smoke_batch(cfg: ModelConfig, batch: int = 2, seq: int = 32,
                train: bool = True, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """A concrete small batch with the JAX package's keys, drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, so every device gets the
    same values: int32 ``tokens`` ``(batch, seq - patch_tokens)``; with
    ``patch_tokens``, ``patches`` ``(batch, patch_tokens, d_model)``; for
    an encoder-decoder, ``frames`` ``(batch, encoder_seq, d_model)`` (both
    standard normal in the weights' type); and ``labels`` like ``tokens``
    when ``train``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    t_text = seq - (cfg.patch_tokens or 0)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, t_text),
                                   generator=gen, dtype=torch.int32)}
    if cfg.patch_tokens:
        out["patches"] = torch.randn((batch, cfg.patch_tokens, cfg.d_model),
                                     generator=gen).to(cfg.dtype)
    if cfg.is_enc_dec:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen).to(cfg.dtype)
    if train:
        out["labels"] = torch.randint(0, cfg.vocab, (batch, t_text),
                                      generator=gen, dtype=torch.int32)
    return {k: v.to(device) for k, v in out.items()}
