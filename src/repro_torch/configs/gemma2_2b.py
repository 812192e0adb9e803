"""gemma2-2b [dense] — 26L d2304 8H (GQA kv=4) ff9216 vocab256000.

Local(4096-window)/global alternating attention, attention-logit softcap 50
and final-logit softcap 30, sandwich (pre+post) zero-centred RMSNorm, GeGLU,
sqrt(d) embedding scaling, head_dim 256.  [arXiv:2408.00118; hf]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216,
        vocab=256_000, head_dim=256,
        rope_theta=1e4, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, zero_centered_norm=True, embed_scale=True,
        mlp="geglu", tie_embeddings=True,
        pattern=(BlockSpec(kind="attn", window=4096),   # local
                 BlockSpec(kind="attn")))               # global


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        head_dim=16, rope_theta=1e4, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, zero_centered_norm=True, embed_scale=True,
        mlp="geglu", tie_embeddings=True,
        pattern=(BlockSpec(kind="attn", window=8), BlockSpec(kind="attn")),
        param_dtype="float32", scan_chunk=16)


register(Arch("gemma2-2b", "dense", config, smoke,
              notes="local+global alternating, logit softcap"))
