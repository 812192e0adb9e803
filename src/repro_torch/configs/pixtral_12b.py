"""pixtral-12b [vlm] — 40L d5120 32H (GQA kv=8) ff14336 vocab131072.

Mistral-NeMo-style dense backbone (head_dim 128) with early-fusion image
patches.  The pixtral-ViT frontend is a STUB per the brief:
``input_specs()`` supplies 256 precomputed patch embeddings per sequence;
the backbone prepends them to the token embeddings.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
        vocab=131_072, head_dim=128,
        rope_theta=1e6, tie_embeddings=False, patch_tokens=256,
        pattern=(BlockSpec(kind="attn"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        head_dim=16, tie_embeddings=False, patch_tokens=8,
        pattern=(BlockSpec(kind="attn"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("pixtral-12b", "vlm", config, smoke,
              notes="pixtral-ViT stub + mistral-nemo backbone"))
