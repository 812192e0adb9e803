"""Sharding rules: parameter / optimizer / batch / cache specs — the JAX
package's ``repro/parallel/sharding.py`` on ``DeviceMesh`` and ``DTensor``.

Mesh axes (launch/mesh.py): ``("data", "model")`` single-pod 16×16, or
``("pod", "data", "model")`` = (2, 16, 16) multi-pod.  The mapping:

* **DP**   — batch over ``("pod", "data")`` (the gradient reduction
  composes over both).
* **TP**   — attention heads / FFN hidden / vocab over ``"model"``.
* **EP**   — MoE experts over ``"model"`` when the expert count divides it
  (llama4's 128); otherwise per-expert FFN TP (mixtral's 8 over 16).
* **SP**   — decode KV caches sequence-sharded over ``"model"``.
* **FSDP** — for models whose params+moments exceed per-chip HBM under pure
  TP (>8B by default), the non-TP weight dim is additionally sharded over
  ``"data"`` (ZeRO-3); optimizer moments inherit it since they are
  param-shaped.

A rule's result is a *spec*: a tuple with one entry per tensor dim, each
entry an axis name, a tuple of names (a dim split over several axes,
major first) or None — what JAX's ``PartitionSpec`` holds.  Rules read only
the mesh's axis names and sizes, so they take an :class:`AbstractMesh`
(no process group) as well as a ``DeviceMesh``; :func:`placements` turns a
spec into DTensor placements on a ``DeviceMesh``, and a
:class:`NamedSharding` pairs the two.  Every rule guards divisibility (a
dim that does not divide its mesh axes stays unsharded rather than
silently padding).

The JAX package stacks each layer's leaves over the periods
(``blocks{i}``, ``cross``, ``encoder``) and its rules strip that leading
dim; the port holds one tensor a layer (``layers.{n}.…``, ``cross.{p}.…``,
``encoder.layers.{n}.…``), so its rules read the same key tail on the
unstacked shape, and a port spec is JAX's with the stack dim's leading
None dropped.  Likewise the port's decode cache is a list (one entry a
layer, then the shared sites, then whisper's cross-attention entries,
recognised by index), whose leaves lack JAX's stack dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

import torch
from torch import nn

from ..models.transformer import ModelConfig

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

# --------------------------------------------------------------------------
# Parallel plan (per-arch knobs the dry-run sweeps)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    fsdp: bool = False                 # shard non-TP weight dim over "data"
    moment_dtype: Any = torch.float32  # bf16 halves optimizer HBM (100B+)
    remat: str = "none"                # none | full | dots
    accum_steps: int = 1
    seq_shard_cache: bool = True       # SP decode caches over "model"
    notes: str = ""


def plan_for(cfg: ModelConfig) -> ParallelPlan:
    """Default plan: FSDP + remat above 8B params; bf16 moments above 100B."""
    n = cfg.param_count()
    return ParallelPlan(
        fsdp=n > 8e9,
        moment_dtype=torch.bfloat16 if n > 100e9 else torch.float32,
        remat="full" if n > 2e9 else "none",
        notes=f"params={n / 1e9:.2f}B")


# --------------------------------------------------------------------------
# meshes and helpers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes only, as JAX's ``AbstractMesh``: what
    the rules read, with no process group behind it."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def as_abstract(mesh) -> AbstractMesh:
    """``mesh`` (an :class:`AbstractMesh` or a ``DeviceMesh``) as an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def dp_axes(mesh) -> Tuple[str, ...]:
    names = as_abstract(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = as_abstract(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _maybe(mesh, axes: Axes, dim: int) -> Axes:
    """Use ``axes`` for a dim only if it divides evenly (no padding); a
    tuple of one name is that name, as JAX's ``PartitionSpec`` keeps
    it."""
    if axes is None or dim % axis_size(mesh, axes) != 0:
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


# --------------------------------------------------------------------------
# Specs as DTensor placements
# --------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh`` (one a mesh dim):
    ``Shard(d)`` on every mesh dim that an entry ``d`` names, else
    ``Replicate()``.  A dim split over several axes (``("pod", "data")``)
    is ``Shard(d)`` on each; DTensor splits it over the mesh dims in mesh
    order, so the axes must come in mesh order (JAX's pod-major order,
    which :func:`dp_axes` gives).  A shard over a mesh dim of one rank is
    the whole tensor, so it is ``Replicate()`` there (DTensor then never
    meets a view of a dim "sharded" one way)."""
    from torch.distributed.tensor import Replicate, Shard
    m = as_abstract(mesh)
    names = m.axis_names
    out: List[Any] = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} of dim {d} is not in the "
                             f"mesh's order {names}: DTensor shards a dim "
                             f"over mesh dims major first")
        for i in idx:
            if m.axis_sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` (the whole value, the same on every rank) laid out
        as a DTensor on this sharding."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, self.placements)


# --------------------------------------------------------------------------
# Parameter rules
# --------------------------------------------------------------------------

#: The name prefixes of the leaves the JAX package stacks over a layer
#: axis (``blocks{i}``, ``cross``, ``encoder.blocks``).
STACKED = ("layers.", "cross.", "encoder.layers.")


def _param_spec(cfg: ModelConfig, mesh, plan: ParallelPlan,
                keys: Tuple[str, ...], core: Tuple[int, ...]) -> Spec:
    """The JAX package's ``_param_spec`` on the unstacked shape ``core``
    of the leaf named ``keys`` (its ``.``-separated name)."""
    tp = "model"
    fs = "data" if (plan.fsdp and "data" in as_abstract(mesh).axis_names) \
        else None

    def spec(*axes) -> Spec:
        return tuple(_maybe(mesh, a, d) for a, d in zip(axes, core))

    ks = set(keys)
    last2 = keys[-2:]

    # ---- embeddings / head -------------------------------------------------
    if last2 == ("embed", "table"):
        return (_maybe(mesh, tp, core[0]), _maybe(mesh, fs, core[1]))
    if keys[-2] == "lm_head":
        return (_maybe(mesh, fs, core[0]), _maybe(mesh, tp, core[1]))

    # ---- MoE ----------------------------------------------------------------
    if "moe" in ks:
        if keys[-1] in ("gate", "up") and len(core) == 3:   # (E, d, ff)
            if core[0] % axis_size(mesh, tp) == 0:          # EP
                return spec(tp, fs, None)
            return spec(None, fs, tp)                       # per-expert TP
        if keys[-1] == "down" and len(core) == 3:           # (E, ff, d)
            if core[0] % axis_size(mesh, tp) == 0:
                return spec(tp, None, fs)
            return spec(None, tp, fs)
        if "router" in ks:
            return spec(*(None,) * len(core))

    # ---- norms / small vectors ---------------------------------------------
    if keys[-1] in ("scale", "b", "w_bias", "mix", "cmix", "a_log",
                    "dt_bias", "d_skip", "conv"):
        if keys[-1] == "b" and len(core) == 1:              # projection bias
            return spec(tp)
        return spec(*(None,) * len(core))
    if keys[-1] == "bonus":                                 # (H, hd)
        return spec(tp, None)

    # ---- projections --------------------------------------------------------
    if len(core) == 2:
        # "write back to residual" projections: shard the input dim over TP
        if keys[-2] in ("wo", "down", "cv", "out_proj"):
            return spec(tp, fs)
        # everything else reads the residual: shard the output dim over TP
        return spec(fs, tp)

    return (None,) * len(core)


def _named(params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, Any]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg: ModelConfig, mesh, plan: ParallelPlan,
                params: Union[nn.Module, Mapping[str, Any]]
                ) -> Dict[str, Spec]:
    """A spec for each parameter of ``params`` (a model, or a mapping of
    parameter names to tensors or shapes' holders), by name."""
    return {name: _param_spec(cfg, mesh, plan, tuple(name.split(".")),
                              tuple(p.shape))
            for name, p in _named(params).items()}


def set_parameters(model: nn.Module, tensors: Mapping[str, Any]) -> None:
    """Replace ``model``'s parameters by ``tensors`` (by parameter name;
    DTensors laid out by :func:`param_shardings`, for instance), in place,
    frozen as the model was built (a train step turns grad on)."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            t, requires_grad=False)


def param_shardings(cfg: ModelConfig, mesh, plan: ParallelPlan,
                    params: Union[nn.Module, Mapping[str, Any]]
                    ) -> Dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, s)
            for name, s in param_specs(cfg, mesh, plan, params).items()}


def opt_shardings(cfg: ModelConfig, mesh, plan: ParallelPlan, opt_state):
    """OptState(step, mu, nu): moments shard exactly like the params."""
    return type(opt_state)(step=NamedSharding(mesh, ()),
                           mu=param_shardings(cfg, mesh, plan, opt_state.mu),
                           nu=param_shardings(cfg, mesh, plan, opt_state.nu))


# --------------------------------------------------------------------------
# Batch / cache rules
# --------------------------------------------------------------------------


def _batch_spec(mesh, shape: Tuple[int, ...]) -> Spec:
    b = shape[0] if shape else 1
    return (_maybe(mesh, dp_axes(mesh), b),) + (None,) * (len(shape) - 1)


def batch_specs(cfg: ModelConfig, mesh, batch) -> Any:
    """Data batch (a mapping of tensors, or one tensor): leading (global
    batch) dim over (pod, data)."""
    if isinstance(batch, Mapping):
        return {k: _batch_spec(mesh, tuple(v.shape)) for k, v in batch.items()}
    return _batch_spec(mesh, tuple(batch.shape))


def batch_shardings(cfg: ModelConfig, mesh, batch) -> Any:
    specs = batch_specs(cfg, mesh, batch)
    if isinstance(specs, dict):
        return {k: NamedSharding(mesh, s) for k, s in specs.items()}
    return NamedSharding(mesh, specs)


def _cache_spec(mesh, plan: ParallelPlan, name: str, shape: Tuple[int, ...],
                cross: bool) -> Spec:
    """JAX's ``cache_shardings`` rule on a leaf without the stack dim:
    B over (pod, data); attention k/v sequence-sharded over "model" (not
    whisper's cross k/v); recurrent-state head dim over "model"."""
    nd = len(shape)
    if nd < 1:
        return ()
    tp = "model" if plan.seq_shard_cache else None
    b_ax = _maybe(mesh, dp_axes(mesh), shape[0])
    rest: Spec = (None,) * (nd - 1)
    if name in ("k", "v") and nd == 4:
        if not cross:                                  # (B,S,kv,hd): SP on S
            rest = (_maybe(mesh, tp, shape[1]), None, None)
    elif name in ("wkv", "ssm") and nd == 4:           # (B,H,dk,dv)
        rest = (_maybe(mesh, tp, shape[1]), None, None)
    elif name == "conv" and nd == 3:                   # (B,W-1,C)
        rest = (None, _maybe(mesh, tp, shape[2]))
    return (b_ax,) + rest


def cache_specs(cfg: ModelConfig, mesh, plan: ParallelPlan,
                cache: Sequence[Mapping[str, Any]]) -> List[Dict[str, Spec]]:
    """A spec for each leaf of a cache in the port's layout
    (``transformer.init_cache``): entries from ``n_layers +
    n_shared_sites`` on are whisper's cross-attention k/v."""
    first_cross = cfg.n_layers + cfg.n_shared_sites
    return [{name: _cache_spec(mesh, plan, name, tuple(leaf.shape),
                               i >= first_cross and cfg.is_enc_dec)
             for name, leaf in entry.items()}
            for i, entry in enumerate(cache)]


def cache_shardings(cfg: ModelConfig, mesh, plan: ParallelPlan,
                    cache: Sequence[Mapping[str, Any]]
                    ) -> List[Dict[str, NamedSharding]]:
    return [{name: NamedSharding(mesh, s) for name, s in entry.items()}
            for entry in cache_specs(cfg, mesh, plan, cache)]


# --------------------------------------------------------------------------
# Convenience: everything the dry-run needs for one cell
# --------------------------------------------------------------------------


def shardings_for_cell(cfg: ModelConfig, mesh, plan: ParallelPlan,
                       kind: str, specs: Dict[str, Any], params,
                       opt_state=None) -> Tuple:
    """The shardings of a step's inputs, in its argument order: train
    ``(params, opt_state, batch)``, prefill ``(params, batch)``, decode
    ``(params, tokens, cache, length)``; ``specs`` is
    :func:`repro_torch.configs.input_specs`' result."""
    p_sh = param_shardings(cfg, mesh, plan, params)
    if kind == "train":
        return (p_sh, opt_shardings(cfg, mesh, plan, opt_state),
                batch_shardings(cfg, mesh, specs["batch"]))
    if kind == "prefill":
        return (p_sh, batch_shardings(cfg, mesh, specs["batch"]))
    return (p_sh, batch_shardings(cfg, mesh, specs["tokens"]),
            cache_shardings(cfg, mesh, plan, specs["cache"]),
            NamedSharding(mesh, ()))
