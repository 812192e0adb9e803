"""PyTorch/CUDA port of the coarse-grain performance estimator.

A second package beside the JAX one: the same trace -> augmented task
graph -> ``FrozenGraph`` -> candidate-axis lockstep replay -> ranked
``ExplorationResult`` chain, with the accelerator-resident engine
(:mod:`repro_torch.core.torchsim`) running on an NVIDIA card through the
hand-written fused step kernel of :mod:`repro_torch.kernels.lockstep_step`.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  A missing card is an error, never a silent switch to
the CPU: :func:`require_cuda` raises :class:`DeviceError`.
"""
from __future__ import annotations


class DeviceError(RuntimeError):
    """The CUDA device, the kernel build or a kernel launch failed.

    Never demoted to another engine or device: a sweep asked to run on the
    card either runs there or stops with this error."""


def default_device() -> str:
    """The device every entry point uses unless told otherwise."""
    return "cuda"


def require_cuda() -> None:
    """Raise :class:`DeviceError` unless a CUDA device is usable here."""
    import torch
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device is available (torch.cuda.is_available() is "
            f"False; torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device='cpu' to run the torch "
            "engine on the host")


__all__ = ["DeviceError", "default_device", "require_cuda"]
