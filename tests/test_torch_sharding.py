"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the JAX package's (``repro.parallel.sharding``), on the CPU, exactly:

* for every arch at 16×16 and 2×16×16 (JAX's ``abstract_mesh``, the
  port's :class:`AbstractMesh`; neither needs a device): the spec of every
  parameter (and so every moment), and of every batch and cache leaf of
  ``input_specs`` for the four shapes, equals JAX's with the stack dim's
  leading None dropped for the leaves JAX stacks over layers; the leaves
  are matched through ``carry.import_lm_params``'s naming, and every leaf
  of the port is matched;
* ``plan_for`` equals JAX's on every arch, ``input_specs`` has JAX's keys,
  shapes and types;
* ``placements`` turns a spec into DTensor placements (a dim over
  ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, in mesh order;
  that DTensor then gives rank (p, d) block p·D + d, JAX's pod-major
  order, is checked on real ranks in ``test_torch_collectives.py``).
"""
import jax
import jax.numpy as jnp
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel import sharding as jsh

from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt_mod

ARCHS = sorted(jconfigs.arch_ids())
MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("params", "opt", "batch", "cache")


def _entry(e):
    """A JAX ``PartitionSpec`` entry as the port writes it."""
    return tuple(e) if isinstance(e, (list, tuple)) else e


def jax_spec(spec):
    return tuple(_entry(e) for e in spec)


def jax_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(jsh._path_keys(p), leaf) for p, leaf in flat]


def port_param_names(cfg, keys):
    """``(port names, stacked)`` of the JAX parameter leaf at ``keys``."""
    rest = ".".join(keys[1:])
    n_pat = len(cfg.pattern)
    if keys[0].startswith("blocks"):
        i = int(keys[0][len("blocks"):])
        return [f"layers.{p * n_pat + i}.{rest}"
                for p in range(cfg.n_periods)], True
    if keys[0] == "cross":
        return [f"cross.{p}.{rest}" for p in range(cfg.n_periods)], True
    if keys[0] == "encoder" and keys[1] == "blocks":
        return [f"encoder.layers.{n}." + ".".join(keys[2:])
                for n in range(cfg.encoder_layers)], True
    return [".".join(keys)], False


def port_cache_entries(cfg, keys):
    """``(indices of the port's cache list, leaf name)`` of the JAX cache
    leaf at ``keys``; every one is stacked."""
    name = keys[-1]
    if keys[0].startswith("blocks"):
        i = int(keys[0][len("blocks"):])
        n_pat = len(cfg.pattern)
        return [p * n_pat + i for p in range(cfg.n_periods)], name
    if keys[0] == "shared":
        return [cfg.n_layers + s for s in range(cfg.n_shared_sites)], name
    assert keys[0] == "enc_kv", keys
    first = cfg.n_layers + cfg.n_shared_sites
    return [first + p for p in range(cfg.n_periods)], name


def is_pspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def check_params(arch, jcfg, cfg, jmesh, mesh, kind):
    plan, jplan = sh.plan_for(cfg), jsh.plan_for(jcfg)
    shapes = jax.eval_shape(lambda: JT.init(jcfg, jax.random.PRNGKey(0)))
    jspecs = jsh.param_specs(jcfg, jmesh, jplan, shapes)
    model = T.Transformer(cfg, device="meta")
    if kind == "params":
        port = sh.param_specs(cfg, mesh, plan, model)
    else:      # the moments shard exactly like the params, in both packages
        state = opt_mod.init(opt_mod.OptConfig(moment_dtype=plan.moment_dtype),
                             dict(model.named_parameters()))
        osh = sh.opt_shardings(cfg, mesh, plan, state)
        assert osh.step.spec == ()
        assert osh.mu.keys() == osh.nu.keys()
        port = {k: v.spec for k, v in osh.mu.items()}
        assert port == {k: v.spec for k, v in osh.nu.items()}
    seen = set()
    for keys, jspec in jax_leaves(jspecs, is_pspec):
        names, stacked = port_param_names(cfg, keys)
        want = jax_spec(jspec)[1:] if stacked else jax_spec(jspec)
        for name in names:
            assert port[name] == want, (arch, name, port[name], jspec)
            seen.add(name)
    assert seen == set(port), sorted(set(port) ^ seen)[:5]


def check_batch(arch, jcfg, cfg, jmesh, mesh):
    for shape_name, jshape in jconfigs.SHAPES.items():
        jspecs = jconfigs.input_specs(jcfg, jshape)
        specs = configs.input_specs(cfg, configs.SHAPES[shape_name])
        if "batch" in jspecs:
            jb = jsh.batch_shardings(jcfg, jmesh, jspecs["batch"])
            pb = sh.batch_specs(cfg, mesh, specs["batch"])
            assert set(pb) == set(jb)
            for k, s in jb.items():
                assert pb[k] == jax_spec(s.spec), (arch, shape_name, k)
        else:
            jt = jsh.batch_shardings(jcfg, jmesh, jspecs["tokens"])
            assert sh.batch_specs(cfg, mesh, specs["tokens"]) == \
                jax_spec(jt.spec)


def check_cache(arch, jcfg, cfg, jmesh, mesh):
    plan, jplan = sh.plan_for(cfg), jsh.plan_for(jcfg)
    for shape_name in ("decode_32k", "long_500k"):
        jspecs = jconfigs.input_specs(jcfg, jconfigs.SHAPES[shape_name])
        specs = configs.input_specs(cfg, configs.SHAPES[shape_name])
        jc = jsh.cache_shardings(jcfg, jmesh, jplan, jspecs["cache"])
        pc = sh.cache_specs(cfg, mesh, plan, specs["cache"])
        seen = set()
        for keys, ns in jax_leaves(jc):
            idx, name = port_cache_entries(cfg, keys)
            for i in idx:
                assert pc[i][name] == jax_spec(ns.spec)[1:], \
                    (arch, shape_name, i, name)
                seen.add((i, name))
        assert seen == {(i, n) for i, e in enumerate(pc) for n in e}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, mesh_name, kind):
    sizes, names = MESHES[mesh_name]
    jmesh = jsh.abstract_mesh(sizes, names)
    mesh = sh.abstract_mesh(sizes, names)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    if kind in ("params", "opt"):
        check_params(arch, jcfg, cfg, jmesh, mesh, kind)
    elif kind == "batch":
        check_batch(arch, jcfg, cfg, jmesh, mesh)
    else:
        check_cache(arch, jcfg, cfg, jmesh, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_for_equals_jax(arch):
    plan = sh.plan_for(configs.get_config(arch))
    jplan = jsh.plan_for(jconfigs.get_config(arch))
    assert (plan.fsdp, plan.remat, plan.accum_steps, plan.seq_shard_cache,
            plan.notes) == (jplan.fsdp, jplan.remat, jplan.accum_steps,
                            jplan.seq_shard_cache, jplan.notes)
    assert str(plan.moment_dtype).replace("torch.", "") == \
        jnp.dtype(jplan.moment_dtype).name


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name, jshape in jconfigs.SHAPES.items():
        jspecs = jconfigs.input_specs(jcfg, jshape)
        specs = configs.input_specs(cfg, configs.SHAPES[name])
        assert set(specs) == set(jspecs)
        if "batch" in jspecs:
            assert set(specs["batch"]) == set(jspecs["batch"])
            for k, j in jspecs["batch"].items():
                p = specs["batch"][k]
                assert p.is_meta and tuple(p.shape) == j.shape
                assert _dtype_name(p) == jnp.dtype(j.dtype).name
            continue
        for k in ("tokens", "length"):
            assert tuple(specs[k].shape) == jspecs[k].shape
            assert _dtype_name(specs[k]) == jnp.dtype(jspecs[k].dtype).name
        for keys, leaf in jax_leaves(jspecs["cache"]):
            idx, leaf_name = port_cache_entries(cfg, keys)
            for i in idx:
                p = specs["cache"][i][leaf_name]
                assert p.is_meta and tuple(p.shape) == leaf.shape[1:]
                assert _dtype_name(p) == jnp.dtype(leaf.dtype).name


def test_placements_nest_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert sh.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements((("data", "pod"),), mesh)
