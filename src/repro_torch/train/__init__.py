# Training substrate of the port (the JAX package's repro/train): the
# AdamW optimizer, the train step (remat / accumulation / compression),
# the synthetic data pipeline, checkpointing, and the fault-tolerant
# supervisor loop.
from . import optimizer, step

__all__ = ["optimizer", "step"]
