"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) ff16384 vocab32768.

8 experts, top-2 routing, sliding-window attention (4096, per the assigned
spec), head_dim 128, untied.  SWA bounds the KV working set ⇒ this arch
runs the long_500k cell.  [arXiv:2401.04088; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
        vocab=32_768, head_dim=128,
        rope_theta=1e6, tie_embeddings=False,
        n_experts=8, top_k=2,
        pattern=(BlockSpec(kind="moe_attn", window=4096),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        head_dim=16, tie_embeddings=False, n_experts=4, top_k=2,
        moe_group_size=16, capacity_factor=4.0,
        pattern=(BlockSpec(kind="moe_attn", window=8),),
        param_dtype="float32", scan_chunk=16)


register(Arch("mixtral-8x22b", "moe", config, smoke,
              notes="8 experts top-2, SWA"))
