"""qwen3-4b [dense] — 36L d2560 32H (GQA kv=8) ff9728 vocab151936.

qk_norm + GQA, head_dim 128 (decoupled from d_model, as published), tied
embeddings, RoPE θ=1e6.  [hf:Qwen/Qwen3-8B; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_ff=9728,
        vocab=151_936, head_dim=128,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        head_dim=16, qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("qwen3-4b", "dense", config, smoke,
              notes="qk_norm GQA dense LM"))
