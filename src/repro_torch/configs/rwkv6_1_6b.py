"""rwkv6-1.6b [ssm] — Finch: 24L d2048 (attention-free) ff7168 vocab65536.

Data-dependent per-channel decay, token-shift time/channel mixing,
head_dim 64.  O(1) decode state ⇒ runs the long_500k cell.
[arXiv:2404.05892; unverified]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168,
        vocab=65_536, rwkv_head_dim=64, tie_embeddings=False,
        pattern=(BlockSpec(kind="rwkv6"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        rwkv_head_dim=16, tie_embeddings=False,
        pattern=(BlockSpec(kind="rwkv6"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("rwkv6-1.6b", "ssm", config, smoke,
              notes="Finch — data-dependent decay, attention-free"))
