# Architecture configs of the port (one module per arch, copied from the
# JAX package's configs): `get_config("<id>")` returns the published
# full-size ModelConfig, `get_smoke("<id>")` a reduced one of the same
# family for CPU tests.  The port carries the four dense attention archs,
# the two MoE archs (mixtral-8x22b, llama4-maverick), rwkv6-1.6b and
# zamba2-1.2b; whisper and pixtral wait for their blocks (ROADMAP).
from .registry import (SHAPES, Arch, Shape, arch_ids, get_arch, get_config,
                       get_smoke, runnable, smoke_batch)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (gemma2_2b, llama4_maverick,  # noqa: F401
                   mixtral_8x22b, qwen3_0_6b, qwen3_4b, qwen15_4b,
                   rwkv6_1_6b, zamba2_1_2b)


__all__ = ["SHAPES", "Arch", "Shape", "arch_ids", "get_arch", "get_config",
           "get_smoke", "runnable", "smoke_batch"]
