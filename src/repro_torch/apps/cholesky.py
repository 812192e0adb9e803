"""Tiled Cholesky factorisation — the paper's Fig. 4, in the @task API.

Upper-triangular left-looking tile algorithm (A = Uᵀ U), matching the Fig. 4
loop nest and its annotations exactly:

* ``dsyrk``  — ``in(A_jk) inout(A_kk)``, target ``device(fpga,smp)``
* ``dpotrf`` — ``inout(A_kk)``,          target SMP **only**
* ``dgemm``  — ``in(A_ji, A_jk) inout(A_ki)``, target ``device(fpga,smp)``
* ``dtrsm``  — ``in(A_kk) inout(A_ki)``, target ``device(fpga,smp)``

The complex interleaved dynamic dependency graph (paper Fig. 8) is exactly
what makes the co-design non-obvious: which 1–2 kernels deserve the fabric?
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.linalg import solve_triangular

from ..core.augment import Eligibility
from ..core.codesign import Candidate
from ..core.devices import zynq_system
from ..core.hlsreport import HLSSynthesisModel, KernelReport, ReportMap
from ..core.trace import Trace, Tracer, task


@task(devices=("fpga", "smp"), ins=("A",), inouts=("C",), name="dsyrk",
      work=lambda A, C: float(A.shape[0]) ** 3 + float(A.shape[0]) ** 2)
def dsyrk(A: np.ndarray, C: np.ndarray) -> np.ndarray:
    """C -= Aᵀ A (diagonal-block update)."""
    C -= A.T @ A
    return C


@task(devices=("smp",), inouts=("A",), name="dpotrf",
      work=lambda A: float(A.shape[0]) ** 3 / 3.0)
def dpotrf(A: np.ndarray) -> np.ndarray:
    """A ← chol_upper(A); the paper keeps this kernel on the SMP."""
    A[...] = np.linalg.cholesky(A).T
    return A


@task(devices=("fpga", "smp"), ins=("A", "B"), inouts=("C",), name="dgemm",
      work=lambda A, B, C: 2.0 * float(A.shape[0]) ** 3)
def dgemm(A: np.ndarray, B: np.ndarray, C: np.ndarray) -> np.ndarray:
    """C -= Bᵀ A (panel update)."""
    C -= B.T @ A
    return C


@task(devices=("fpga", "smp"), ins=("A",), inouts=("B",), name="dtrsm",
      work=lambda A, B: float(A.shape[0]) ** 3 + float(A.shape[0]) ** 2)
def dtrsm(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """B ← A⁻ᵀ B with A upper-triangular (panel solve)."""
    B[...] = solve_triangular(A, B, trans="T", lower=False)
    return B


def chol_ll(AA: List[List[np.ndarray]], nb: int) -> None:
    """The Fig. 4 driver (left-looking, by block column k)."""
    for k in range(nb):
        for j in range(k):
            dsyrk(AA[j][k], AA[k][k])
        dpotrf(AA[k][k])
        for i in range(k + 1, nb):
            for j in range(k):
                dgemm(AA[j][i], AA[j][k], AA[k][i])
        for i in range(k + 1, nb):
            dtrsm(AA[k][k], AA[k][i])


def make_spd_blocks(n: int, bs: int, seed: int = 0
                    ) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """Blocked SPD matrix (upper blocks used; lower mirrors for reference)."""
    rng = np.random.default_rng(seed)
    m = np.asarray(rng.standard_normal((n, n)), dtype=np.float64)
    a = m @ m.T + n * np.eye(n)
    nb = n // bs
    blocks = [[np.ascontiguousarray(a[j * bs:(j + 1) * bs, k * bs:(k + 1) * bs])
               for k in range(nb)] for j in range(nb)]
    return blocks, a


def trace_cholesky(n: int = 512, bs: int = 64, seed: int = 0,
                   verify: bool = True) -> Trace:
    """Instrumented sequential run → task trace (validates numerics too)."""
    nb = n // bs
    AA, a = make_spd_blocks(n, bs, seed)
    with Tracer() as tr:
        chol_ll(AA, nb)
    if verify:
        u = np.zeros_like(a)
        for j in range(nb):
            for k in range(j, nb):
                u[j * bs:(j + 1) * bs, k * bs:(k + 1) * bs] = AA[j][k]
        ref = np.linalg.cholesky(a).T
        np.testing.assert_allclose(u, ref, rtol=1e-8, atol=1e-8)
    tr.trace.meta.update(app="cholesky", n=n, bs=bs)
    return tr.trace


# ---------------------------------------------------------------------------
# The six §VI candidates (Fig. 9)
# ---------------------------------------------------------------------------

KERNELS = ("dgemm", "dsyrk", "dtrsm")


def hls_reports(bs: int = 64, hls: HLSSynthesisModel | None = None
                ) -> Dict[str, Dict[bool, KernelReport]]:
    """reports[kernel][full_resources] for the three FPGA-able kernels."""
    hls = hls or HLSSynthesisModel()
    return {op: {fr: hls.cholesky_tile(op, bs, full_resources=fr)
                 for fr in (False, True)} for op in KERNELS}


def report_map(bs: int = 64) -> ReportMap:
    out: ReportMap = {}
    for op, by_fr in hls_reports(bs).items():
        for rep in by_fr.values():
            out[(op, rep.device_kind)] = rep
    return out


def candidates(bs: int = 64) -> List[Candidate]:
    """Fig. 9: three FR-<kernel> configs + the three two-accelerator combos."""
    reps = hls_reports(bs)
    cands: List[Candidate] = []

    def elig(accel_for: Dict[str, str]) -> Eligibility:
        m: Dict[str, Tuple[str, ...]] = {"dpotrf": ("smp",)}
        for op in KERNELS:
            m[op] = (accel_for[op], "smp") if op in accel_for else ("smp",)
        return Eligibility(m)

    # FR-<kernel>: one full-resources accelerator, everything else on SMP
    for op in KERNELS:
        rep = reps[op][True]
        name = f"FR-{op}"
        cands.append(Candidate(
            name=name,
            system=zynq_system(name, {rep.device_kind: 1}),
            eligibility=elig({op: rep.device_kind}),
            fabric=[(rep, 1)]))

    # two-accelerator combos involving dgemm (the paper's three)
    for combo in (("dgemm", "dgemm"), ("dgemm", "dsyrk"), ("dgemm", "dtrsm")):
        name = "+".join(combo)
        counts: Dict[str, int] = {}
        for op in combo:
            counts[op] = counts.get(op, 0) + 1
        accel_for = {op: reps[op][False].device_kind for op in counts}
        cands.append(Candidate(
            name=name,
            system=zynq_system(
                name, {reps[op][False].device_kind: c for op, c in counts.items()}),
            eligibility=elig(accel_for),
            fabric=[(reps[op][False], c) for op, c in counts.items()]))
    return cands
