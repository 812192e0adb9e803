# Hand-written Hopper kernels of the port, one per TPU kernel on the path:
#
#   lockstep_step — step-commit of the torchsim candidate-axis scan
#                   (replaces repro/kernels/lockstep_step.py::step_commit)
#
# Each wrapper launches its CUDA kernel for a CUDA tensor and runs its
# plain PyTorch version, in the same module, for a CPU tensor.  Sources
# live in csrc/ and are built by build.py at first use, never on import.
