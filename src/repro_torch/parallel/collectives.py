"""Compute/communication overlap: ring all-gather matmul — the JAX
package's ``repro/parallel/collectives.py`` on a ``torch.distributed``
process group.

The FSDP pattern ``y = x @ all_gather(w)`` serializes a full weight
all-gather before the matmul.  The ring version decomposes the matmul over
the weight shards: at ring step s each rank multiplies with the shard it
currently holds while that shard travels on to rank ``i+1`` (one
``batch_isend_irecv`` pair a step), so the transfer of shard s+1 hides
under the product of shard s.  Exposed collective time drops from
``(n-1)/n · |W| / bw`` to ~one shard, provided per-shard matmul time ≥
per-shard transfer time.

``ring_allgather_matmul`` runs on the ranks of a group (the FSDP axis of a
mesh); ``reference_allgather_matmul`` is the oracle; on a world of one the
ring is a plain matmul.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def reference_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                               group: Optional[dist.ProcessGroup] = None
                               ) -> torch.Tensor:
    """Oracle: gather the full weight (``all_gather_into_tensor``, the
    shards in rank order along dim 0), then one big matmul."""
    n = dist.get_world_size(group)
    w = torch.empty((n * w_shard.shape[0],) + tuple(w_shard.shape[1:]),
                    dtype=w_shard.dtype, device=w_shard.device)
    dist.all_gather_into_tensor(w, w_shard.contiguous(), group=group)
    return x @ w


def ring_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                          group: Optional[dist.ProcessGroup] = None
                          ) -> torch.Tensor:
    """x: (..., d), the same on every rank of ``group``; w_shard:
    (d/n, f) — this rank's shard of the d-sharded weight.  Returns x @ W
    (full), accumulated in the promoted type and cast to ``x``'s, as
    JAX's.  At step s the shard held started at rank ``(idx − s) mod n``;
    it is sent on to rank ``idx+1`` while this step's product runs (no
    send after the last step, whose shard would only return home)."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    rows = w_shard.shape[0]
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],),
                      dtype=torch.promote_types(x.dtype, w_shard.dtype),
                      device=x.device)
    w_cur = w_shard.contiguous()
    for s in range(n):
        src = (idx - s) % n
        reqs = []
        if s < n - 1:
            w_nxt = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_cur, nxt, group),
                dist.P2POp(dist.irecv, w_nxt, prv, group)])
        acc = acc + x[..., src * rows:(src + 1) * rows] @ w_cur
        for r in reqs:
            r.wait()
        if reqs:
            w_cur = w_nxt
    return acc.to(x.dtype)


def make_overlapped_matmul(mesh, axis: str = "data"):
    """``f(x, w)``: ``x`` replicated (a DTensor or the local tensor),
    ``w`` a DTensor sharded ``Shard(0)`` over the mesh axis ``axis``;
    returns ``x @ W`` as a DTensor replicated over the mesh (JAX's
    ``shard_map`` with ``in_specs=(P(), P(axis, None))``,
    ``out_specs=P()``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(axis)

    def f(x, w):
        # over one rank "sharded" is the whole weight, which the sharding
        # rules lay out as Replicate()
        if not (isinstance(w, DTensor) and (w.placements[dim] == Shard(0)
                                            or mesh.size(dim) == 1)):
            raise ValueError(f"w must be a DTensor sharded Shard(0) over "
                             f"mesh axis {axis!r}")
        xl = x.to_local() if isinstance(x, DTensor) else x
        out = ring_allgather_matmul(xl, w.to_local(), group)
        return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return f
