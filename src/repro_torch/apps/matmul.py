"""Blocked matrix multiplication — the paper's Fig. 1, in the @task API.

::

    #pragma omp target device(fpga,smp)
    #pragma omp task in([BS*BS]A,[BS*BS]B) inout([BS*BS]C)
    void mxmBlock(REAL *A, REAL *B, REAL *C)

Blocks are independent numpy buffers mutated in place, so region identity
(data pointer) is stable across the run — the same address-based dependence
tracking Nanos++ performs on the C pointers.

The co-design questions evaluated in §VI: block size 64 vs 128, one vs two
accelerators, FPGA-only vs heterogeneous (``+smp``) execution.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.augment import Eligibility
from ..core.codesign import Candidate
from ..core.devices import zynq_system
from ..core.hlsreport import HLSSynthesisModel, KernelReport, ReportMap
from ..core.trace import Trace, Tracer, task


@task(devices=("fpga", "smp"), ins=("A", "B"), inouts=("C",), name="mxm_block",
      work=lambda A, B, C: 2.0 * A.shape[0] * A.shape[1] * B.shape[1])
def mxm_block(A: np.ndarray, B: np.ndarray, C: np.ndarray) -> np.ndarray:
    """One BS×BS block update C += A @ B (the FPGA/SMP kernel)."""
    C += A @ B
    return C


@dataclasses.dataclass
class BlockedMatrices:
    """NB×NB grid of BS×BS blocks, each its own buffer (paper's REAL**)."""

    nb: int
    bs: int
    blocks: List[List[np.ndarray]]

    @staticmethod
    def create(nb: int, bs: int, dtype: str = "float32",
               seed: int = 0) -> "BlockedMatrices":
        rng = np.random.default_rng(seed)
        blocks = [[np.asarray(rng.standard_normal((bs, bs)), dtype=dtype)
                   for _ in range(nb)] for _ in range(nb)]
        return BlockedMatrices(nb, bs, blocks)

    @staticmethod
    def zeros(nb: int, bs: int, dtype: str = "float32") -> "BlockedMatrices":
        blocks = [[np.zeros((bs, bs), dtype=dtype) for _ in range(nb)]
                  for _ in range(nb)]
        return BlockedMatrices(nb, bs, blocks)

    def dense(self) -> np.ndarray:
        return np.block(self.blocks)


def matmul(AA: BlockedMatrices, BB: BlockedMatrices,
           CC: BlockedMatrices) -> None:
    """The Fig. 1 driver: every mxm_block call is one task instance."""
    nb = AA.nb
    for k in range(nb):
        for i in range(nb):
            for j in range(nb):
                mxm_block(AA.blocks[i][k], BB.blocks[k][j], CC.blocks[i][j])


def trace_matmul(n: int = 512, bs: int = 64, dtype: str = "float32",
                 seed: int = 0, verify: bool = True) -> Trace:
    """Instrumented sequential run (toolchain step 1) → task trace."""
    nb = n // bs
    AA = BlockedMatrices.create(nb, bs, dtype, seed)
    BB = BlockedMatrices.create(nb, bs, dtype, seed + 1)
    CC = BlockedMatrices.zeros(nb, bs, dtype)
    with Tracer() as tr:
        matmul(AA, BB, CC)
    if verify:
        ref = AA.dense() @ BB.dense()
        np.testing.assert_allclose(CC.dense(), ref, rtol=2e-3, atol=2e-3)
    tr.trace.meta.update(app="matmul", n=n, bs=bs, dtype=dtype)
    return tr.trace


# ---------------------------------------------------------------------------
# The six §VI candidates (Fig. 5): {1,2}×acc64 / 1×acc128, each ±SMP
# ---------------------------------------------------------------------------


def hls_reports(hls: HLSSynthesisModel | None = None,
                dtype: str = "float32") -> Dict[int, KernelReport]:
    hls = hls or HLSSynthesisModel()
    return {bs: hls.matmul_block(bs, dtype=dtype, kind=f"fpga:mxm{bs}")
            for bs in (64, 128)}


def report_map(dtype: str = "float32") -> ReportMap:
    reps = hls_reports(dtype=dtype)
    return {("mxm_block", r.device_kind): r for r in reps.values()}


def candidates(dtype: str = "float32") -> Dict[int, List[Candidate]]:
    """Per block size, the Fig. 5 configurations (plus the infeasible one).

    Returns {64: [...], 128: [...]} — the caller pairs each list with the
    trace of the matching granularity.
    """
    reps = hls_reports(dtype=dtype)
    out: Dict[int, List[Candidate]] = {64: [], 128: []}
    for bs in (64, 128):
        kind = f"fpga:mxm{bs}"
        for n_acc in (1, 2):
            for smp in (False, True):
                name = f"{n_acc}acc{bs}" + ("+smp" if smp else "")
                kinds = (kind, "smp") if smp else (kind,)
                out[bs].append(Candidate(
                    name=name,
                    system=zynq_system(name, {kind: n_acc}),
                    eligibility=Eligibility({"mxm_block": kinds}),
                    fabric=[(reps[bs], n_acc)]))
    return out
