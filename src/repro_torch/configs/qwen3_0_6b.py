"""qwen3-0.6b [dense] — 28L d1024 16H (GQA kv=8) ff3072 vocab151936.

qk_norm + GQA, head_dim 128, tied embeddings.  [hf:Qwen/Qwen3-8B; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
        vocab=151_936, head_dim=128,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv=2, d_ff=96, vocab=256,
        head_dim=16, qk_norm=True, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("qwen3-0.6b", "dense", config, smoke,
              notes="qk_norm GQA dense LM (small)"))
