# Hand-written Hopper kernels of the port, one per TPU kernel on the path:
#
#   lockstep_step  — step-commit of the torchsim candidate-axis scan
#                    (replaces repro/kernels/lockstep_step.py::step_commit)
#   block_matmul   — the paper's mxmBlock tile, and the Cholesky dgemm tile
#                    (gemm_update_tile) through the same kernel
#                    (replaces repro/kernels/block_matmul.py::block_matmul)
#   cholesky_tiles — the dsyrk and dtrsm tiles of the Fig. 4 Cholesky
#                    (replace repro/kernels/cholesky_tiles.py::syrk_tile
#                    and ::trsm_tile)
#   flash_attention — online-softmax GQA attention with causal, window and
#                    softcap, the LM serve path's prefill
#                    (replaces repro/kernels/flash_attention.py::
#                    flash_attention)
#   linear_attn    — chunked decayed linear attention, RWKV6's prefill
#                    (replaces repro/kernels/linear_attn.py::
#                    linear_attention)
#
# ops holds the public wrappers with the JAX package's padding and shape
# contracts, ref the plain PyTorch versions.  Each wrapper launches its
# CUDA kernel for a CUDA tensor and runs its plain version for a CPU
# tensor.  Sources live in csrc/ (lockstep_step.cu, tiles.cu,
# flash_attention.cu and flash_attention_wgmma.cu, linear_attn.cu and
# linear_attn_tc.cu) and are built by build.py at first use, never on
# import.
