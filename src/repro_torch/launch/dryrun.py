"""Multi-pod dry-run: prove the distribution config is coherent without
the hardware — the JAX package's ``repro/launch/dryrun.py`` on
``torch.distributed``.

For every (architecture × input shape × mesh) cell this module:

  1. builds the exact published config + its :class:`ParallelPlan`;
  2. opens a ``fake`` process group at the mesh's size (unless one is
     open), builds the mesh, and lays the model's parameters, the
     optimizer moments, the batch and the cache out as DTensors by
     :mod:`repro_torch.parallel.sharding`'s rules, over ``meta`` local
     tensors (nothing is allocated, no rank exists but this one);
  3. runs one ``train`` / ``prefill`` / ``decode`` step eagerly, with the
     collectives DTensor's sharding propagation issues (the fake group
     completes them without moving anything);
  4. records one device's FLOPs and bytes (``TorchCostModel`` on the
     local ops), the collectives (:func:`collective_bytes`) and the peak
     of live local tensors (:func:`peak_memory`), with the JAX record's keys,
     into a JSON artifact under ``build/dryrun/``.

Where XLA takes its collectives from the shardings, the port takes them
from DTensor's sharding propagation, with two explicit layouts: each
weight gradient is reduced once into its parameter's placements
(``train.step.laid_out_like``), and a prefill's cache is laid out by
``cache_shardings`` (JAX's ``out_shardings``); ROADMAP §3 lists both.
Steps run the JAX package's default attention route,
``attn_impl="chunked"`` (the kernels take plain local tensors, and the
train step refuses them), so a record prices JAX's arithmetic, not the
port's serving route.  DTensor propagates shardings op by op and caches
what it learns, running ops of its own the first time; the step is
therefore run once unrecorded, then once more under the counters.
``lower_s`` is that second, counted run's seconds; nothing is compiled,
so ``compile_s`` is 0.0.  Fields with no counterpart here
(``generated_code_size_in_bytes``) are None, as JAX writes a field its
backend lacks.

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
All cells:      python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

ARTIFACTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ``_c10d_functional`` ops → JAX's collective kinds.
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}

#: ``_c10d_functional`` ops that move nothing between ranks.
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")

Event = Tuple[str, int, int]       # (kind, operand bytes, group size)


def collective_bytes(events: Iterable[Event]) -> dict:
    """Per-device collective traffic from the collectives a step issued:
    each ``(kind, operand bytes, group size g)``, ``kind`` one of JAX's
    five.  The operand is what the rank hands the collective (all-gather:
    its shard; reduce-scatter: the whole tensor).  ``wire_bytes`` applies
    the JAX package's ring cost model (AR 2·o·(g-1)/g, AG o·(g-1), RS/A2A
    o·(g-1)/g, CP o), which the roofline's collective term uses."""
    out = {k: 0 for k in _COLLECTIVES}
    wire = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for op_hit, operand, g in events:
        g = max(g, 1)
        if op_hit == "all-gather":
            w = operand * (g - 1)
        elif op_hit == "reduce-scatter":
            w = operand * (g - 1) / g
        elif op_hit == "all-reduce":
            w = 2 * operand * (g - 1) / g
        elif op_hit == "all-to-all":
            w = operand * (g - 1) / g
        elif op_hit == "collective-permute":
            w = operand
        else:
            raise ValueError(f"unknown collective kind {op_hit!r}")
        out[op_hit] += operand
        wire[op_hit] += w
        counts[op_hit] += 1
    return {"per_op_bytes": out, "per_op_counts": counts,
            "per_op_wire_bytes": {k: int(v) for k, v in wire.items()},
            "total_bytes": sum(out.values()),
            "wire_bytes": int(sum(wire.values()))}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_counter():
    """A ``TorchDispatchMode`` that records each ``_c10d_functional``
    collective a rank issues as an :data:`Event`, in ``events`` (DTensor
    ops are left to DTensor, whose collectives it then sees).  A
    collective it cannot map to JAX's kinds raises."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.events = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            name = func.__name__.split(".")[0]
            if func.namespace == "_c10d_functional" and \
                    name not in _NOT_COLLECTIVES:
                if name not in _FUNCOL:
                    raise ValueError(f"dry-run: collective {func} has no "
                                     f"counterpart among {_COLLECTIVES}")
                group = _resolve_process_group(args[-1]).size()
                ins = args[0] if isinstance(args[0], (list, tuple)) \
                    else [args[0]]
                self.events.append((_FUNCOL[name],
                                    sum(_nbytes(t) for t in ins), group))
            return func(*args, **kwargs)

    return CollectiveCounter()


def peak_memory(device_type: str = "meta"):
    """A ``TorchDispatchMode`` that follows the bytes of the storages live
    on ``device_type`` (one rank's local tensors; DTensor ops are left to
    DTensor): :meth:`track` adds the tensors that exist before the step
    (its arguments), each op's outputs add theirs, a storage's bytes leave
    when it is freed; ``peak`` is the most ever live at once."""
    import weakref

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class PeakMemory(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live, self.peak = 0, 0
            self._sizes = {}

        def _free(self, key):
            self.live -= self._sizes.pop(key)

        def track(self, tensors):
            for t in tensors:
                if isinstance(t, DTensor):
                    t = t._local_tensor
                if t.device.type != device_type:
                    continue
                st = t.untyped_storage()
                if st._cdata in self._sizes:
                    continue
                self._sizes[st._cdata] = st.nbytes()
                self.live += st.nbytes()
                weakref.finalize(st, self._free, st._cdata)
            self.peak = max(self.peak, self.live)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            self.track(_tensors(out))
            return out

    return PeakMemory()


def reshard_on_error(counter):
    """A ``TorchDispatchMode`` for the ops DTensor has no sharding strategy
    for.  Where an aten op on DTensors fails — a view that would split or
    merge a sharded dim off its head boundaries (GQA with fewer kv heads
    than the model axis, whisper's 6 heads over 16), forward or backward,
    or a local view that a permuted local tensor cannot take — it calls
    again on contiguous copies of the DTensor inputs, then all-gathers
    (or, for a partial sum, all-reduces) the DTensor inputs that are not
    replicated over one mesh dim at a time, the last first, until the
    call goes through.  Each retry is listed in ``done`` with the bytes
    its collectives added to ``counter``.  DTensor versions differ in the
    views they can shard (and some raise ``IndexError`` inside a
    redistribute), so both errors are retried; an op that writes one of
    its inputs is not (a copy of that input would take the write)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_unflatten

    class ReshardOnError(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.done = []

        def _note(self, func, error, mesh_dim, before):
            self.done.append({
                "op": str(func), "error": str(error).splitlines()[0][:160],
                "mesh_dim": mesh_dim,
                "operand_bytes": sum(e[1] for e in counter.events[before:])})

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            try:
                return func(*args, **kwargs)
            except (RuntimeError, IndexError) as err:
                first = err
                flat, spec = tree_flatten((args, kwargs))
                dts = [i for i, a in enumerate(flat)
                       if isinstance(a, DTensor)
                       and not all(p.is_replicate() for p in a.placements)]
                if not dts or func._schema.is_mutable:
                    raise
            error = first
            mesh = flat[dts[0]].device_mesh
            for dim in [None] + list(reversed(range(mesh.ndim))):
                before = len(counter.events)
                for i in dts:
                    if dim is not None and \
                            not flat[i].placements[dim].is_replicate():
                        pl = list(flat[i].placements)
                        pl[dim] = Replicate()
                        flat[i] = flat[i].redistribute(placements=pl)
                    flat[i] = flat[i].contiguous()
                self._note(func, error, None if dim is None
                           else mesh.mesh_dim_names[dim], before)
                a, k = tree_unflatten(flat, spec)
                try:
                    return func(*a, **k)
                except (RuntimeError, IndexError) as again:
                    error = again
            raise error from first

    return ReshardOnError()


def probe_unit(cfg) -> int:
    """Depth quantum for the linear roofline probes (one repeating unit)."""
    return cfg.shared_every if cfg.shared_every else len(cfg.pattern)


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks (this process is rank 0)
    for the duration, unless a group is open already; torn down after."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is open; the mesh needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def _dtensor(t, sharding):
    """A DTensor over a ``meta`` local tensor of ``t``'s shape and type
    laid out by ``sharding`` (the sharding rules divide evenly)."""
    import torch
    from torch.distributed.tensor import DTensor
    pl = sharding.placements
    local = torch.empty(_local_shape(t.shape, sharding.mesh, pl),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=t.shape, stride=torch.empty(
                                  t.shape, device="meta").stride())


def shard_model(model, shardings: Dict[str, object]) -> None:
    """Replace each parameter of ``model`` (built on ``meta``) by a DTensor
    laid out by its sharding (``param_shardings``), in place."""
    from ..parallel.sharding import set_parameters
    params = dict(model.named_parameters())
    set_parameters(model, {name: _dtensor(params[name], sh)
                           for name, sh in shardings.items()})


def _local_bytes(tree) -> int:
    """Bytes of one rank's share of every tensor in ``tree``."""
    return sum(_nbytes(getattr(t, "_local_tensor", t))
               for t in _tensors(tree))


def _tensors(tree):
    import torch
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_overrides: dict | None = None,
             cfg_overrides: dict | None = None,
             mesh_override=None, save: bool = True,
             tag: str = "", probe_layers: int | None = None,
             device: Optional[str] = None, smoke: bool = False,
             shape_override=None) -> dict:
    """One cell's record (JAX's keys).  ``mesh_override`` is a
    ``(sizes, names)`` pair in place of the production mesh; ``device``
    is the mesh's device type (default: the card); ``smoke``
    takes the arch's smoke config in place of the published one (tests),
    and ``shape_override`` a :class:`~repro_torch.configs.Shape` in place
    of ``SHAPES[shape_name]``."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from .. import configs, default_device
    from ..core.hlsreport import TorchCostModel
    from ..models import transformer as T
    from ..models.layers import resolve_device
    from ..parallel import sharding as sh
    from ..serve import engine
    from ..train import optimizer as opt_mod
    from ..train import step as step_mod
    from . import mesh as mesh_mod

    shape = shape_override or configs.SHAPES[shape_name]
    ok, why = configs.runnable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    plan = sh.plan_for(cfg)          # plan from the FULL config, always
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    cfg = dataclasses.replace(cfg, attn_impl="chunked",
                              **(cfg_overrides or {}))
    full_layers = cfg.n_layers
    full_params = cfg.param_count()
    full_active = cfg.active_param_count()
    if probe_layers is not None:
        # reduced-depth probe, extrapolated linearly in depth
        # (roofline/model.py); the port traces eagerly, so a full-depth
        # count is already exact and the probes are kept for parity
        cfg = dataclasses.replace(cfg, n_layers=probe_layers,
                                  unroll_scan=True)
        tag = tag or f"probe{probe_layers}"
    if shape.kind == "train" and plan.remat != "none":
        cfg = dataclasses.replace(cfg, remat=plan.remat)

    device_type = resolve_device(device or default_device()).type
    if mesh_override is not None:
        sizes, names = mesh_override
    else:
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n_dev = 1
    for s in sizes:
        n_dev *= s

    with fake_world(n_dev), implicit_replication():
        mesh = mesh_mod._mesh(sizes, names, device_type)
        mesh_name = mesh_mod.describe(mesh)
        specs = configs.input_specs(cfg, shape)
        model = T.Transformer(cfg, device="meta")
        shard_model(model, sh.param_shardings(cfg, mesh, plan, model))

        def lay_out(tree, shardings):
            if isinstance(tree, dict):
                return {k: lay_out(v, shardings[k]) for k, v in tree.items()}
            if isinstance(tree, list):
                return [lay_out(v, s) for v, s in zip(tree, shardings)]
            return _dtensor(tree, shardings)

        out_layout = None
        if shape.kind == "train":
            tcfg = step_mod.TrainConfig(
                opt=opt_mod.OptConfig(moment_dtype=plan.moment_dtype),
                accum_steps=plan.accum_steps)
            fn = step_mod.make_train_step(cfg, tcfg)
            state = opt_mod.init(tcfg.opt, step_mod.trainable(model))
            batch = lay_out(specs["batch"],
                            sh.batch_shardings(cfg, mesh, specs["batch"]))
            args = (model, state, batch)
            donated = (dict(model.named_parameters()), state)
        elif shape.kind == "prefill":
            fn = engine.make_prefill_step(model, max_len=shape.seq_len)
            batch = lay_out(specs["batch"],
                            sh.batch_shardings(cfg, mesh, specs["batch"]))
            args = (batch,)
            donated = ()
            # the produced cache laid out by the cache rules (JAX's
            # out_shardings), so that it never materializes replicated
            cache_like = T.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device="meta")
            out_layout = sh.cache_shardings(cfg, mesh, plan, cache_like)
        else:
            fn = engine.make_serve_step(model)
            tokens = lay_out(specs["tokens"],
                             sh.batch_shardings(cfg, mesh, specs["tokens"]))
            cache = lay_out(specs["cache"], sh.cache_shardings(
                cfg, mesh, plan, specs["cache"]))
            args = (tokens, cache, specs["length"])
            donated = (cache,)
        arguments = (dict(model.named_parameters()),) + args[1:] \
            if shape.kind == "train" else (dict(model.named_parameters()),) \
            + args

        def step():
            if shape.kind == "train":
                return fn(*args)
            with torch.no_grad():       # serving records no autograd graph
                out = fn(*args)
            if out_layout is not None:
                nxt, cache = out
                out = (nxt, [{k: c[k].redistribute(mesh, s[k].placements)
                              for k in c} for c, s in zip(cache, out_layout)])
            return out

        with reshard_on_error(collective_counter()):
            step()      # DTensor learns the shardings (ops of its own)
        counter = collective_counter()
        reshard = reshard_on_error(counter)
        memory = peak_memory()
        memory.track(_tensors(arguments))
        holder = {}

        def counted():
            with counter, reshard:
                holder["out"] = step()

        t0 = time.perf_counter()
        with memory:
            cost = TorchCostModel().analyze_sharded(counted)
        t_lower = time.perf_counter() - t0
        peak_bytes = memory.peak
        arg_b = _local_bytes(arguments)
        out = holder["out"]
        if shape.kind == "train":       # (params, opt state, metrics)
            out = (dict(out[0].named_parameters()),) + tuple(out[1:])
        out_b = _local_bytes(out)
        alias_b = _local_bytes(donated)

    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "n_devices": n_dev,
        "plan": {"fsdp": plan.fsdp, "remat": plan.remat,
                 "moment_dtype": str(plan.moment_dtype).replace("torch.", ""),
                 "accum_steps": plan.accum_steps,
                 "seq_shard_cache": plan.seq_shard_cache,
                 "notes": plan.notes},
        "tag": tag,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers, "full_n_layers": full_layers,
        "params": full_params,          # FULL config (probes are reduced)
        "active_params": full_active,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "cost_analysis": {"flops": cost["flops"],
                          "bytes accessed": cost["bytes"],
                          "transcendentals": cost["transcendentals"]},
        "collectives": collective_bytes(counter.events),
        "memory": {
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b,
            "temp_size_in_bytes": max(peak_bytes - arg_b - out_b + alias_b,
                                      0),
            "alias_size_in_bytes": alias_b,
            "peak_memory_in_bytes": peak_bytes,
            "generated_code_size_in_bytes": None},
        "explicit_redistributes": reshard.done,
        "device_type": device_type,
        "attn_impl": cfg.attn_impl,
    }
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn_ = ARTIFACTS / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
        fn_.write_text(json.dumps(record, indent=1))
        record["artifact"] = str(fn_)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="run the two reduced-depth roofline probes per cell")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape filter (e.g. train_4k)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: cuda)")
    args = ap.parse_args(argv)

    from .. import configs

    shape_filter = {x for x in args.shapes.split(",") if x}
    cells = []
    if args.all:
        for a in configs.arch_ids():
            for s in configs.SHAPES:
                if not shape_filter or s in shape_filter:
                    cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    mesh_name = "pod=2×data=16×model=16" if args.multi_pod \
        else "data=16×model=16"

    jobs = []
    for arch, shape in cells:
        if args.probes:
            unit = probe_unit(configs.get_config(arch))
            jobs.append((arch, shape, unit))
            jobs.append((arch, shape, 2 * unit))
        else:
            jobs.append((arch, shape, None))

    failures = 0
    for arch, shape, probe in jobs:
        suffix = f"__probe{probe}" if probe else ""
        if args.skip_existing:
            fn = ARTIFACTS / f"{arch}__{shape}__{mesh_name}{suffix}.json"
            if fn.exists():
                print(f"[skip existing] {arch} × {shape}{suffix}")
                continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, probe_layers=probe,
                           device=args.device)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures += 1
            print(f"[FAIL] {arch} × {shape}{suffix}: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        if "skipped" in rec:
            print(f"[skip] {arch} × {shape}: {rec['skipped']}")
            continue
        c = rec["cost_analysis"]
        peak = rec["memory"]["peak_memory_in_bytes"] or 0
        print(f"[ok] {arch} × {shape} × {rec['mesh']}: "
              f"lower {rec['lower_s']}s compile {rec['compile_s']}s "
              f"flops/dev={c.get('flops', 0):.3e} "
              f"wire/dev={rec['collectives']['wire_bytes']:.3e}B "
              f"peak/dev={peak / 1e9:.2f}GB", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
