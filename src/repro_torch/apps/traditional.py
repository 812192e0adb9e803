"""The paper's tile accelerators run for real: Fig. 6's traditional flow
and the Fig. 4 Cholesky, on the card.

* :func:`traditional_candidate` answers one co-design candidate the way
  the estimator replaces (paper §VI, Fig. 6): build the granularity's
  ``mxmBlock`` accelerator afresh — a new ``nvcc`` build of the tile GEMM
  kernel with ``TILE = min(bs, 128)``, the bitstream-generation analogue —
  then run the whole Fig. 1 blocked matmul with its FPGA tasks through
  that build.  With ``heterogeneous``, the tasks with
  ``(i + j + kk) % 7 == 0`` run on the host, as the SMP share.
* :func:`cholesky_via_tiles` runs the Fig. 4 left-looking loop with the
  dsyrk, dgemm and dtrsm tiles of :mod:`repro_torch.kernels.ops` on the
  card; dpotrf stays outside any kernel (``torch.linalg.cholesky``).

Both run on the card unless the caller passes ``device="cpu"``, where the
kernels' plain versions run and nothing is built; they never pick the CPU
on their own.  The inputs are made with numpy from a seed, as in the JAX
package (``benchmarks/fig6_analysis_time.py``, ``tests/test_kernels.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import require_cuda
from ..kernels import block_matmul as bm
from ..kernels import build, ops

#: Fig. 6's traditional-flow candidates, ``(bs, heterogeneous, n_acc)``:
#: 1 and 2 accelerators at bs 64, 1 at bs 128, each ±SMP.  The slot count
#: changes nothing in a build-and-run (each candidate is built and run
#: anew), as in ``fig6_analysis_time.py``.
FIG6_CANDIDATES: Tuple[Tuple[int, bool, int], ...] = tuple(
    (bs, het, n_acc) for bs in (64, 128) for het in (False, True)
    for n_acc in ((1, 2) if bs == 64 else (1,)))


def candidate_name(bs: int, heterogeneous: bool, n_acc: int) -> str:
    """The name :func:`repro_torch.apps.matmul.candidates` gives it."""
    return f"{n_acc}acc{bs}" + ("+smp" if heterogeneous else "")


@dataclasses.dataclass
class TraditionalRun:
    """One candidate built and run: ``build_s`` is the fresh ``nvcc``
    build (0 on the CPU), ``run_s`` the blocked matmul until its product
    is back on the host."""

    build_s: float
    run_s: float
    product: np.ndarray
    fpga_tasks: int
    smp_tasks: int
    tile: int
    ptxas: str = ""


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda":
        require_cuda()
    return dev


@contextlib.contextmanager
def _fresh_accelerator(dev: torch.device,
                       tile: int) -> Iterator[Optional[build.FreshBuild]]:
    """A fresh build of the tile kernel on the card; nothing on the CPU."""
    if dev.type == "cpu":
        yield None
        return
    with build.fresh(bm.SOURCE, {"TILE": tile}) as fresh:
        yield fresh


def matmul_blocks(n: int, bs: int):
    """Fig. 6's seeded ``nb × nb`` grids of ``bs × bs`` f32 blocks, A then
    B, drawn as ``fig6_analysis_time._traditional_candidate`` draws them
    (seed 0)."""
    nb = n // bs
    rng = np.random.default_rng(0)
    aa = [[rng.standard_normal((bs, bs), dtype=np.float32) for _ in range(nb)]
          for _ in range(nb)]
    bb = [[rng.standard_normal((bs, bs), dtype=np.float32) for _ in range(nb)]
          for _ in range(nb)]
    return aa, bb


def traditional_candidate(n: int, bs: int, heterogeneous: bool, *,
                          device: str = "cuda") -> TraditionalRun:
    """Build and run one candidate the traditional way (Fig. 6)."""
    dev = _device(device)
    tile = min(bs, 128)
    t0 = time.perf_counter()
    with _fresh_accelerator(dev, tile) as fresh:
        build_s = 0.0 if fresh is None else time.perf_counter() - t0
        t1 = time.perf_counter()
        nb = n // bs
        aa, bb = matmul_blocks(n, bs)
        a_dev = [[torch.from_numpy(x).to(dev) for x in row] for row in aa]
        b_dev = [[torch.from_numpy(x).to(dev) for x in row] for row in bb]
        cc = [[torch.zeros((bs, bs), dtype=torch.float32, device=dev)
               for _ in range(nb)] for _ in range(nb)]
        lib = None if fresh is None else fresh.lib
        fpga = smp = 0
        for kk in range(nb):
            for i in range(nb):
                for j in range(nb):
                    if heterogeneous and (i + j + kk) % 7 == 0:
                        # the SMP share: the host's cores, on host memory
                        host = cc[i][j].cpu().numpy()
                        host += aa[i][kk] @ bb[kk][j]
                        cc[i][j].copy_(torch.from_numpy(host))
                        smp += 1
                    else:
                        cc[i][j] += bm.block_matmul(
                            a_dev[i][kk], b_dev[kk][j], block_m=tile,
                            block_n=tile, block_k=tile, library=lib)
                        fpga += 1
        product = torch.cat([torch.cat(row, dim=1) for row in cc]).cpu()
        run_s = time.perf_counter() - t1
    return TraditionalRun(build_s=build_s, run_s=run_s,
                          product=product.numpy(), fpga_tasks=fpga,
                          smp_tasks=smp, tile=tile,
                          ptxas="" if fresh is None else fresh.ptxas)


def spd_matrix(n: int, seed: int) -> np.ndarray:
    """The SPD f32 matrix ``m mᵀ + n I`` of ``tests/test_kernels.py``'s
    blocked Cholesky, ``m`` standard normal from ``seed``."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


def cholesky_via_tiles(n: int, bs: int, panel: int, *, seed: int,
                       device: str = "cuda") -> torch.Tensor:
    """The upper factor ``U`` (``Uᵀ U = A``) of :func:`spd_matrix`
    ``(n, seed)``, by the Fig. 4 left-looking tile loop: dsyrk, dgemm and
    dtrsm through the tile kernels, dpotrf by ``torch.linalg.cholesky``.
    Returns ``U`` on ``device``."""
    dev = _device(device)
    a_full = torch.from_numpy(spd_matrix(n, seed)).to(dev)
    nb = n // bs
    blocks = {(j, kk): a_full[j * bs:(j + 1) * bs,
                              kk * bs:(kk + 1) * bs].contiguous()
              for j in range(nb) for kk in range(nb)}
    for kk in range(nb):
        for j in range(kk):
            blocks[(kk, kk)] = ops.syrk(blocks[(j, kk)], blocks[(kk, kk)])
        blocks[(kk, kk)] = torch.linalg.cholesky(
            blocks[(kk, kk)]).mT.contiguous()                  # dpotrf
        for i in range(kk + 1, nb):
            for j in range(kk):
                blocks[(kk, i)] = ops.gemm_update(
                    blocks[(j, i)], blocks[(j, kk)], blocks[(kk, i)])
        for i in range(kk + 1, nb):
            blocks[(kk, i)] = ops.trsm(blocks[(kk, kk)], blocks[(kk, i)],
                                       panel=panel)
    u = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for j in range(nb):
        for kk in range(j, nb):
            u[j * bs:(j + 1) * bs, kk * bs:(kk + 1) * bs] = blocks[(j, kk)]
    return u
