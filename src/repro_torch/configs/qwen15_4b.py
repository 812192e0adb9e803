"""qwen1.5-4b [dense] — 40L d2560 20H (GQA kv=20 = MHA) ff6912 vocab151936.

QKV bias (the Qwen1.5 signature), head_dim 128 = d/H, untied embeddings.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv=20, d_ff=6912,
        vocab=151_936, head_dim=128,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
        pattern=(BlockSpec(kind="attn"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        head_dim=16, qkv_bias=True, tie_embeddings=False,
        pattern=(BlockSpec(kind="attn"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("qwen1.5-4b", "dense", config, smoke, notes="QKV bias, MHA"))
