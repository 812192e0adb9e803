"""Production mesh construction — the JAX package's
``repro/launch/mesh.py`` as ``torch.distributed`` device meshes.
Importing this module touches no device and no process group.

The shapes are JAX's, so that records and their artifact names
(:func:`describe`: ``data=16×model=16``) compare with JAX's one to one:
single-pod ``(data=16, model=16)`` and multi-pod ``(pod=2, data=16,
model=16)``, the "pod" axis composing with "data" for the gradient
reduction.  On H100s a pod is an 8-card NVLink node
(``roofline.model.H100.chips_per_pod``), so a model axis of 16 spans two
nodes and its collectives cross the inter-node link;
``mesh_variant(32, 8)`` is the node-shaped factorisation (the model axis
inside one node).

A mesh needs a process group of its size: a 256- or 512-rank mesh exists
only over a ``fake`` group (:mod:`repro_torch.launch.dryrun`); a machine
with one card has a world of one.
"""
from __future__ import annotations

from typing import Optional

from .. import default_device


def _mesh(shape, names, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or default_device(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def mesh_variant(data: int, model: int, pods: int = 1,
                 device_type: Optional[str] = None):
    """Alternative (data, model) factorization at the same chip count."""
    if pods > 1:
        return _mesh((pods, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def smoke_mesh(data: Optional[int] = None, model: int = 1,
               device_type: Optional[str] = None):
    """Tiny mesh over the ranks of the open process group (tests: a few
    ``gloo`` ranks; the card: a world of one)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    data = data or (n // model)
    return _mesh((data, model), ("data", "model"), device_type)


def describe(mesh) -> str:
    """``data=16×model=16``: each axis and its size, in mesh order (a
    ``DeviceMesh`` or a :class:`~repro_torch.parallel.sharding.AbstractMesh`)."""
    from ..parallel.sharding import as_abstract
    m = as_abstract(mesh)
    return "×".join(f"{a}={s}" for a, s in zip(m.axis_names, m.axis_sizes))
