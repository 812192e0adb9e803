# Architecture configs of the port (one module per arch, copied from the
# JAX package's configs): `get_config("<id>")` returns the published
# full-size ModelConfig, `get_smoke("<id>")` a reduced one of the same
# family for CPU tests.  The port carries all ten of the JAX package's
# archs: the four dense attention archs, the two MoE archs (mixtral-8x22b,
# llama4-maverick), rwkv6-1.6b, zamba2-1.2b, whisper-tiny (encoder-decoder)
# and pixtral-12b (patch tokens).
from .registry import (SHAPES, Arch, Shape, arch_ids, get_arch, get_config,
                       get_smoke, input_specs, runnable, smoke_batch)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (gemma2_2b, llama4_maverick, mixtral_8x22b,  # noqa: F401
                   pixtral_12b, qwen3_0_6b, qwen3_4b, qwen15_4b, rwkv6_1_6b,
                   whisper_tiny, zamba2_1_2b)


__all__ = ["SHAPES", "Arch", "Shape", "arch_ids", "get_arch", "get_config",
           "get_smoke", "input_specs", "runnable", "smoke_batch"]
