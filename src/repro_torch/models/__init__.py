# The LM substrate of the port: dense attention models as nn.Modules whose
# state dicts are the JAX package's parameter trees flattened
# (repro_torch.carry.import_lm_params), serving through the flash kernel.
from . import attention, layers, transformer

__all__ = ["attention", "layers", "transformer"]
