"""The port's training loop (``repro_torch.train.data``, ``.checkpoint``,
``.supervisor`` and ``python -m repro_torch.launch.train``) against the
JAX package's, on the CPU:

* ``SyntheticLM`` batches bit for bit equal to JAX's, also after
  ``rebalance``; the prefetcher streams in order;
* checkpoints: round trip, keep-k retention, corruption detected, ``tmp``
  directories ignored; an asynchronous save taken before an in-place
  update restores the state before it; a checkpoint JAX's
  ``checkpoint.save`` wrote restores through the port and
  ``import_lm_params`` into the same model; a bf16 leaf's manifest entry
  (dtype name and hash) and stored 2-byte words equal JAX's;
* the supervisor recovers from injected failures into the same
  parameters as an uninterrupted run (rtol 1e-5 / atol 1e-6, as JAX's
  test); a failure before the first checkpoint restarts from step 0 with
  the parameters as they stand, in both packages, and the port ends
  where JAX ends (rtol 1e-4 / atol 1e-5 after 6 AdamW steps of f32
  noise; not the uninterrupted run's parameters); a straggler triggers a
  rebalance;
* the launcher trains on the CPU and leaves ``jax`` and ``repro``
  unimported.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the JAX package is the reference; a card without it skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro.train import supervisor as jsup

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import step as S
from repro_torch.train.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.train.supervisor import (FailureInjector, StragglerWatch,
                                          Supervisor)

REPO = Path(__file__).resolve().parents[1]


def tiny(lr=1e-3, seed=0):
    """qwen3-0.6b's smoke config in f32 on the chunked route, trainable,
    its AdamW state and step."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              attn_impl="chunked")
    tcfg = S.TrainConfig(opt=opt.OptConfig(lr=lr, warmup_steps=2))
    model, state = S.init_train_state(cfg, tcfg, seed, device="cpu")
    return cfg, model, state, S.make_train_step(cfg, tcfg)


def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ------------------------------------------------------------------- data --

@pytest.mark.parametrize("n_hosts", [1, 3, 4])
def test_batches_bit_equal_to_jax_also_after_rebalance(n_hosts):
    dcfg = dict(seq_len=16, global_batch=8, vocab=101, seed=5,
                n_hosts=n_hosts)
    ds, jds = SyntheticLM(DataConfig(**dcfg)), jdata.SyntheticLM(
        jdata.DataConfig(**dcfg))
    for step in (0, 3, 17):
        for h in range(n_hosts):
            for k, v in ds.host_batch(step, h).items():
                np.testing.assert_array_equal(v, jds.host_batch(step, h)[k])
    before = ds.global_batch(3)
    assert ds.rebalance(slow_host=n_hosts - 1) == jds.rebalance(
        slow_host=n_hosts - 1)
    for k, v in ds.global_batch(3).items():
        np.testing.assert_array_equal(v, jds.global_batch(3)[k])
        np.testing.assert_array_equal(v, before[k])
    assert sum(ds.shares) == 8


def test_prefetcher_streams_in_order():
    ds = SyntheticLM(DataConfig(seq_len=8, global_batch=4, vocab=50))
    pf = Prefetcher(ds, start_step=5)
    it = iter(pf)
    got = [next(it) for _ in range(3)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7]
    np.testing.assert_array_equal(got[1][1]["tokens"],
                                  ds.global_batch(6)["tokens"])


# ------------------------------------------------------------- checkpoint --

def test_checkpoint_roundtrip_and_retention(tmp_path):
    _, model, state, _ = tiny()
    tree = {"params": model, "opt": state}
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        "step_000000003", "step_000000004"]
    manifest = json.loads(
        (tmp_path / "step_000000004" / "manifest.json").read_text())
    keys = [e["key"] for e in manifest["leaves"]]
    assert "params/layers.0.attn.wq.w" in keys and "opt/step" in keys
    assert "opt/mu/embed.table" in keys
    assert set(manifest["leaves"][0]) == {"key", "file", "shape", "dtype",
                                          "sha256"}
    restored = ckpt.restore(tmp_path, 4, tree)
    assert isinstance(restored["opt"], opt.OptState)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(restored["params"][name], t, rtol=0,
                                   atol=0)
    for name, t in state.mu.items():
        torch.testing.assert_close(restored["opt"].mu[name], t, rtol=0,
                                   atol=0)


def test_checkpoint_detects_corruption(tmp_path):
    _, model, _, _ = tiny()
    ckpt.save(tmp_path, 7, {"params": model})
    leaf = next((tmp_path / "step_000000007").glob("leaf_*.npy"))
    np.save(leaf, np.load(leaf) + 1)
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore(tmp_path, 7, {"params": model})
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore_into(tmp_path, 7, {"params": model})


def test_checkpoint_incomplete_tmp_ignored(tmp_path):
    _, model, _, _ = tiny()
    ckpt.save(tmp_path, 3, {"params": model})
    (tmp_path / "step_000000009.tmp-123").mkdir()
    assert ckpt.latest_step(tmp_path) == 3
    ckpt.save(tmp_path, 4, {"params": model}, keep=1)
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        "step_000000004", "step_000000009.tmp-123"]


def test_async_save_before_in_place_update_restores_pre_update(tmp_path):
    cfg, model, state, step = tiny()
    before = params_of(model)
    t = ckpt.save(tmp_path, 1, {"params": model, "opt": state},
                  asynchronous=True)
    ds = SyntheticLM(DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab))
    model, state, _ = step(model, state, ds.global_batch(0))   # in place
    t.join()
    assert ckpt.latest_step(tmp_path) == 1
    assert not torch.equal(model.embed.table.detach(), before["embed.table"])
    ckpt.restore_into(tmp_path, 1, {"params": model, "opt": state})
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, before[name], rtol=0, atol=0)
    assert int(state.step) == 0


def test_jax_checkpoint_restores_through_the_port(tmp_path):
    """JAX's ``checkpoint.save`` of its f32 smoke parameters, read by the
    port into JAX's tree structure and carried by ``import_lm_params``,
    loads into the port's model as the same weights."""
    jcfg = jconfigs.get_smoke("qwen3-0.6b")
    jparams = JT.init(jcfg, jax.random.PRNGKey(3))
    jckpt.save(tmp_path, 2, {"params": jparams})
    like = {"params": jax.tree.map(np.asarray, jparams)}
    tree = ckpt.restore(tmp_path, 2, like)
    cfg = configs.get_smoke("qwen3-0.6b")
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, jax.tree.map(
        lambda t: t.numpy(), tree["params"])), strict=True)
    want = import_lm_params(cfg, like["params"])
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0)


def test_bf16_leaf_bytes_and_hash_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    ckpt.save(tmp_path / "port", 1, {"w": torch.from_numpy(x).to(
        torch.bfloat16)})
    jckpt.save(tmp_path / "jax", 1, {"w": jnp.asarray(x, jnp.bfloat16)})
    entries = [json.loads((tmp_path / side / "step_000000001" /
                           "manifest.json").read_text())["leaves"][0]
               for side in ("port", "jax")]
    assert entries[0] == entries[1]
    assert entries[0]["dtype"] == "bfloat16"
    words = [np.load(tmp_path / side / "step_000000001" / "leaf_00000.npy")
             for side in ("port", "jax")]
    assert words[0].dtype.itemsize == words[1].dtype.itemsize == 2
    assert words[0].tobytes() == words[1].tobytes()
    got = ckpt.restore(tmp_path / "jax", 1,
                       {"w": torch.zeros(6, 10, dtype=torch.bfloat16)})
    torch.testing.assert_close(got["w"], torch.from_numpy(x).to(
        torch.bfloat16), rtol=0, atol=0)


# ------------------------------------------------------- supervisor loop --

def test_supervisor_recovers_from_failures(tmp_path):
    cfg, model, state, step = tiny()
    ds = SyntheticLM(DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab))
    sup = Supervisor(step, ds, str(tmp_path), ckpt_every=4,
                     injector=FailureInjector(at_steps=(6, 11)))
    model, state, report = sup.run(model, state, n_steps=14)
    assert (report.restarts, report.steps_done) == (2, 14)
    assert report.steps_replayed == 2 + 3
    assert int(state.step) == 14
    _, ref, ref_state, ref_step = tiny()
    for s in range(14):
        ref, ref_state, _ = ref_step(ref, ref_state, ds.global_batch(s))
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 ref.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_failure_before_first_checkpoint_matches_jax(tmp_path):
    """Finding copied on purpose: with no checkpoint yet, both supervisors
    restart at step 0 with the parameters already updated."""
    jcfg = jconfigs.get_smoke("qwen3-0.6b")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    okw = dict(lr=1e-3, warmup_steps=2)
    jtcfg = jstep.TrainConfig(opt=jopt.OptConfig(**okw))
    dcfg = dict(seq_len=16, global_batch=4, vocab=jcfg.vocab)
    jrun = jsup.Supervisor(jax.jit(jstep.make_train_step(jcfg, jtcfg)),
                           jdata.SyntheticLM(jdata.DataConfig(**dcfg)),
                           str(tmp_path / "jax"), ckpt_every=10,
                           injector=jsup.FailureInjector(at_steps=(2,)))
    jp, jstate, jrep = jrun.run(jparams, jopt.init(jtcfg.opt, jparams), 4)

    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              attn_impl="chunked")
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(
        cfg, jax.tree.map(np.asarray, jparams)))
    tcfg = S.TrainConfig(opt=opt.OptConfig(**okw))
    sup = Supervisor(S.make_train_step(cfg, tcfg),
                     SyntheticLM(DataConfig(**dcfg)), str(tmp_path / "port"),
                     ckpt_every=10, injector=FailureInjector(at_steps=(2,)))
    model, state, rep = sup.run(model, opt.init(tcfg.opt,
                                                S.trainable(model)), 4)
    assert (rep.restarts, rep.steps_replayed, rep.steps_done) == (
        jrep.restarts, jrep.steps_replayed, jrep.steps_done) == (1, 2, 4)
    assert int(state.step) == int(jstate.step) == 6
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-5)
    want = import_lm_params(cfg, jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_straggler_triggers_rebalance(tmp_path):
    cfg, model, state, step = tiny()
    ds = SyntheticLM(DataConfig(seq_len=16, global_batch=8, vocab=cfg.vocab,
                                n_hosts=4))
    times = np.ones(4)
    times[1] = 3.0                           # host 1 is chronically slow
    sup = Supervisor(step, ds, str(tmp_path), ckpt_every=50,
                     straggler=StragglerWatch(n_hosts=4))
    _, _, report = sup.run(model, state, n_steps=4,
                           host_time_fn=lambda s: times)
    assert report.rebalances and report.rebalances[0][1] == 1
    assert ds.shares[1] < 2


def test_launcher_trains_on_cpu_without_jax():
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        "assert train.main(['--device', 'cpu', '--steps', '20',\n"
        "                   '--inject-failures', '12']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "steps=20 restarts=1" in out.stdout


def test_launcher_module_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "20"], capture_output=True, text=True, timeout=120,
        env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch=qwen3-0.6b-smoke" in out.stdout
