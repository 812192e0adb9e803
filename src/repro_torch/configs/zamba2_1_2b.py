"""zamba2-1.2b [hybrid] — 38L d2048 32H (GQA kv=32) ff8192 ssm_state=64
vocab32000: Mamba2 backbone + one weight-SHARED attention block.

The shared transformer block is applied every 6 Mamba2 layers (6 sites for
38 layers; its KV cache is per-site, the weights are shared — exactly the
Zamba2 parameter-sharing idea).  Simplifications recorded in DESIGN.md §4:
the published concat-with-embedding input and per-site LoRA deltas on the
shared block are omitted.  O(1) Mamba state ⇒ runs long_500k.
[arXiv:2411.15242; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
        vocab=32_000, head_dim=64, ssm_state=64, ssm_expand=2,
        tie_embeddings=True, shared_every=6,
        pattern=(BlockSpec(kind="mamba2"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        head_dim=16, ssm_state=16, ssm_expand=2, tie_embeddings=True,
        shared_every=2,
        pattern=(BlockSpec(kind="mamba2"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("zamba2-1.2b", "hybrid", config, smoke,
              notes="Mamba2 + shared attn block every 6 layers"))
