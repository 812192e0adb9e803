"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) ff8192
vocab202048, MoE 128 experts top-1 + shared expert, early fusion.

Published interleave: MoE every other layer (dense/MoE alternating), one
shared expert beside the 128 routed ones.  The multimodal early-fusion
frontend is a stub per the brief (text tokens only in the shape cells).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
        vocab=202_048, head_dim=128,
        rope_theta=5e5, tie_embeddings=False,
        n_experts=128, top_k=1, shared_expert=True,
        pattern=(BlockSpec(kind="attn"), BlockSpec(kind="moe_attn")))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        head_dim=16, tie_embeddings=False, n_experts=4, top_k=1,
        shared_expert=True, moe_group_size=16, capacity_factor=8.0,
        pattern=(BlockSpec(kind="attn"), BlockSpec(kind="moe_attn")),
        param_dtype="float32", scan_chunk=16)


register(Arch("llama4-maverick-400b-a17b", "moe", config, smoke,
              notes="MoE 128e top-1 + shared expert, dense/MoE interleave"))
