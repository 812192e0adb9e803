"""Shared set-up of the train tests (``test_torch_train_step.py``,
``test_torch_train_update.py``): the JAX package's smoke weights and the
port's model carrying them, numpy-seeded batches, a tolerance check, and
one port train step.  JAX is imported where it is used, so that a card
without it still collects the ``gpu`` tests."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import step as S


def pair(arch, **replace):
    """JAX's smoke config and weights (numpy leaves), and the port's
    config and model with the same weights, f32, chunked."""
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    kw = dict(param_dtype="float32", attn_impl="chunked", **replace)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(configs.get_smoke(arch), **kw)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, params), strict=True)
    return jcfg, params, cfg, model


def batch_for(cfg, seed, b=2, t=24, masked=True):
    """Tokens, labels (some below 0 when ``masked``), and the patches or
    frames the arch takes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tt = t - (cfg.patch_tokens or 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, tt), dtype=np.int32),
           "labels": rng.integers(-1 if masked else 0, cfg.vocab, (b, tt),
                                  dtype=np.int32)}
    if cfg.patch_tokens:
        out["patches"] = rng.standard_normal(
            (b, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, rtol=1e-4, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def port_step(cfg, model, tcfg_kw, batch):
    tcfg = S.TrainConfig(**{k: v for k, v in tcfg_kw.items()
                            if k != "opt"},
                         opt=opt.OptConfig(**tcfg_kw["opt"]))
    step = S.make_train_step(cfg, tcfg)
    state = opt.init(tcfg.opt, S.trainable(model))
    return step(model, state, batch)
