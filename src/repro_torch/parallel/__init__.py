# Distribution layer of the port.  So far gradient compression alone
# (compression.py, the JAX package's repro/parallel/compression.py); the
# sharding rules, collectives and pipeline schedules are still to come.
from . import compression

__all__ = ["compression"]
