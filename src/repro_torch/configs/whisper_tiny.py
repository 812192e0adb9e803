"""whisper-tiny [audio] — enc-dec, 4L d384 6H ff1536 vocab51865.

4 encoder + 4 decoder layers, GELU MLPs, cross-attention per decoder layer.
The conv audio frontend is a STUB per the brief: ``input_specs()`` supplies
1500 precomputed frame embeddings (the post-conv mel sequence length).
Adaptation note (DESIGN.md §4): learned absolute positions → RoPE.
[arXiv:2212.04356; unverified]
"""
from ..models.transformer import BlockSpec, ModelConfig
from .registry import Arch, register


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536,
        vocab=51_865, head_dim=64,
        mlp="gelu", tie_embeddings=True,
        encoder_layers=4, encoder_seq=1500,
        pattern=(BlockSpec(kind="attn"),))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        head_dim=16, mlp="gelu", tie_embeddings=True,
        encoder_layers=2, encoder_seq=24,
        pattern=(BlockSpec(kind="attn"),), param_dtype="float32",
        scan_chunk=16)


register(Arch("whisper-tiny", "audio", config, smoke,
              notes="enc-dec, conv frontend stub"))
