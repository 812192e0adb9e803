"""The port's collectives, sharded train step and sharded restore on real
ranks: ``gloo`` processes on the CPU (``torch_dist_common.run_ranks``,
a ``FileStore`` under ``tmp_path``, collectives timed out after 60 s),
held to the JAX package:

* ``ring_allgather_matmul`` on 4 ranks equals ``reference_allgather_matmul``
  and JAX's single-device ``make_overlapped_matmul`` (rtol 1e-5, f32), and
  ``make_overlapped_matmul`` over a mesh's ``data`` axis gives the same,
  replicated;
* a dim split over ``("pod", "data")`` gives rank (p, d) block p·D + d,
  JAX's pod-major order; ``write_cache`` into a decode cache laid out by
  the cache rules (sequence over "model") writes what ``index_copy_``
  writes, exactly;
* one train step of the f32 qwen3-0.6b smoke config on a ``(2, 2)`` mesh
  with FSDP forced on (every parameter, moment and batch leaf laid out
  by the sharding rules) equals the unsharded step: loss within 1e-5
  relative, parameters at JAX's rtol 2e-3 / atol 2e-5, each parameter
  still in its placements;
* ``restore(shardings=)`` of a checkpoint JAX's ``checkpoint.save`` wrote,
  with JAX's own specs at (2, 2) with FSDP, gives DTensors in those
  placements whose ``full_tensor()`` equals the saved leaves exactly.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jsh
from repro.train import checkpoint as jckpt

from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as S

from torch_dist_common import numpy_state, run_ranks


def test_ring_allgather_matmul_on_four_ranks(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 12)).astype(np.float32)
    f = jcoll.make_overlapped_matmul(jax.make_mesh((1,), ("data",)), "data")
    want = np.asarray(f(x, w))
    for ring, ref, over in run_ranks("ring", 4, tmp_path, x, w):
        np.testing.assert_allclose(ring, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ring, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(over, want, rtol=1e-5, atol=1e-5)


def test_pod_major_split_and_sharded_cache_write(tmp_path):
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((4, 8, 2, 16)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 16)).astype(np.float32)
    idx = np.array([5])
    want = torch.from_numpy(cache.copy())
    want.index_copy_(1, torch.from_numpy(idx), torch.from_numpy(new))
    from torch.distributed.tensor import Shard
    for (p, d), local, placements, written in run_ranks(
            "layouts", 4, tmp_path, cache, new, idx):
        block = p * 2 + d
        np.testing.assert_array_equal(local, np.arange(4 * block,
                                                       4 * block + 4))
        assert placements == (Shard(0), Shard(1))
        np.testing.assert_array_equal(written, want.numpy())


def test_sharded_train_step_equals_unsharded(tmp_path):
    arch = "qwen3-0.6b"
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32",
                              attn_impl="chunked")
    model = T.Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    state = numpy_state(model)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 24), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 24), dtype=np.int32)}
    tcfg = S.TrainConfig(opt=opt_mod.OptConfig(lr=1e-2))
    st = opt_mod.init(tcfg.opt, S.trainable(model))
    model, st, m = S.make_train_step(cfg, tcfg)(
        model, st, {k: torch.from_numpy(v) for k, v in batch.items()})
    want_loss = float(m["loss"])
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    results = run_ranks("train", 4, tmp_path, arch, state, batch, True)
    for loss, laid_out, params in results:
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), \
            (loss, want_loss)
        assert laid_out
        assert params.keys() == want.keys()
        for n, p in params.items():
            np.testing.assert_allclose(p, want[n], rtol=2e-3, atol=2e-5,
                                       err_msg=n)


def test_restore_with_shardings_of_a_jax_checkpoint(tmp_path):
    jcfg = jconfigs.get_smoke("qwen3-0.6b")
    jparams = JT.init(jcfg, jax.random.PRNGKey(5))
    jckpt.save(tmp_path / "ckpt", 2, {"params": jparams})
    like = {"params": jax.tree.map(np.asarray, jparams)}
    plan = dataclasses.replace(jsh.plan_for(jcfg), fsdp=True)
    jspecs = jsh.param_specs(jcfg, jsh.abstract_mesh((2, 2), ("data",
                                                              "model")),
                             plan, jparams)
    specs = {"params": jax.tree.map(
        lambda s: tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                        for e in s), jspecs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    flat_like = {}

    def walk(t, s, prefix):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], f"{prefix}{k}/")
        else:
            flat_like[prefix[:-1]] = (t, s)
    walk(like, specs, "")
    from torch.distributed.tensor import Shard
    mesh = sh.abstract_mesh((2, 2), ("data", "model"))
    sharded = 0
    for flat in run_ranks("restore", 4, tmp_path, str(tmp_path / "ckpt"), 2,
                          like, specs):
        assert flat.keys() == flat_like.keys()
        for key, (placements, value) in flat.items():
            leaf, spec = flat_like[key]
            assert placements == sh.placements(spec, mesh), key
            sharded += any(isinstance(p, Shard) for p in placements)
            np.testing.assert_array_equal(value, leaf, err_msg=key)
    assert sharded > 0
