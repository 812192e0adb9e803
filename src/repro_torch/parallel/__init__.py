# Distribution layer of the port (the JAX package's repro/parallel):
# sharding rules (DP/TP/EP/SP/FSDP + pod axis) as DTensor specs,
# overlap-friendly collectives, gradient compression, pipeline schedules.
from . import collectives, compression, pipeline, sharding

__all__ = ["collectives", "compression", "pipeline", "sharding"]
