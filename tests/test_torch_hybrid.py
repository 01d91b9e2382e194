"""The hybrid branch of the port (zamba2: a Mamba2 trunk with one shared
attention + MLP block) against the JAX package, on the CPU.

Two reduced zamba2-1.2b configs (f32, d_model 64, four heads MHA, SSM
N 16, P 32, chunk 32): ``reduced``'s own ``shared_every=1`` on 2 layers
(the shared block before every layer, no remainder), and
``shared_every=2`` on 5 layers (2 macro groups of 2 Mamba2 layers, then
the shared block once more and 1 remainder layer in ``layers_rem``), where
a decode that indexed the KV cache by layer, or the SSM state by
application, would read and write the wrong slots.

The same numpy inputs go through both packages; the JAX side runs its
Pallas kernels (flash attention, the SSD scan) in interpret mode
(``dispatch.forced("pallas")``). Tolerances are ``test_torch_ssm.py``'s:
the backbone, prefill, every cache slot, decode and the sampler rtol/atol
1e-4, tokens identical; one train step's loss and metrics rtol 1e-4 /
atol 1e-5, each micro-batch's grads 1e-5 + 1e-4 * max|g| per leaf.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RLConfig as JRLConfig
from repro.data.trajectory import dummy_batch as jdummy_batch
from repro.kernels import dispatch as jdispatch
from repro.models import policy as jpolicy
from repro.models import transformer as jtransformer
from repro_torch.bridge import batch_from_numpy, params_from_numpy
from repro_torch.configs import RLConfig, get_config, reduced
from repro_torch.core import advnorm
from repro_torch.data.trajectory import dummy_batch
from repro_torch.models import policy as tpolicy
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path

jts = importlib.import_module("repro.core.train_step")
tts = importlib.import_module("repro_torch.core.train_step")

ARCH = "zamba2-1.2b"
# (layers, shared_every): (n_macro, group, rem) = (2, 1, 0) and (2, 2, 1)
LAYOUTS = [(2, 1), (5, 2)]


def _cfgs(layers, every, **kw):
    def one(get, red):
        cfg = red(get(ARCH), layers=layers, d_model=64)
        return dataclasses.replace(
            cfg, hybrid=dataclasses.replace(cfg.hybrid, shared_every=every),
            **kw)
    return one(jget_config, jreduced), one(get_config, reduced)


@functools.lru_cache(maxsize=None)
def _model(layers, every):
    jcfg, tcfg = _cfgs(layers, every)
    jparams = jpolicy.init_policy_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, exp, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _obs(cfg, b=3, t_obs=64):
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg.vocab_size, (b, t_obs)).astype(np.int32),
            np.array([0, 5, 63][:b], np.int32))


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().numpy() for path, x in
            tree_leaves_with_path(tree)}


@pytest.mark.parametrize("layers,every", LAYOUTS + [(38, 6), (7, 3)])
def test_layout_matches_reference(layers, every):
    jcfg, tcfg = _cfgs(layers, every)
    assert ttransformer.hybrid_layout(tcfg) \
        == jtransformer.hybrid_layout(jcfg)
    assert ttransformer.num_shared_applications(tcfg) \
        == jtransformer.num_shared_applications(jcfg)


def test_zamba2_layout_at_full_depth():
    cfg = get_config(ARCH)
    assert ttransformer.hybrid_layout(cfg) == (6, 6, 2)
    assert ttransformer.num_shared_applications(cfg) == 7


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_init_params_draws_the_reference_tree(layers, every):
    """The port's own random init has the reference's tree, shapes and
    dtypes: the shared block un-stacked, ``layers_rem`` only with a
    remainder."""
    jcfg, tcfg = _cfgs(layers, every, param_dtype="bfloat16")
    jshapes = {path: (v.shape, str(v.dtype)) for path, v in _jflat(
        jpolicy.init_policy_params(jcfg, jax.random.PRNGKey(0))).items()}
    tp = tpolicy.init_policy_params(tcfg, 0, device="cpu")
    tshapes = {path: (tuple(v.shape), str(v.dtype)[6:])
               for path, v in tree_leaves_with_path(tp)}
    assert tshapes == jshapes
    n_macro, g, rem = ttransformer.hybrid_layout(tcfg)
    assert tp["layers"]["ssm"]["in_proj"].shape[0] == n_macro * g
    assert ("layers_rem" in tp) == bool(rem)
    assert tp["shared_attn"]["attn"]["wq"].ndim == 3
    assert tp["shared_attn"]["mlp"]["w_up"].shape == (
        64, tcfg.hybrid.shared_d_ff)
    assert bool((tp["shared_attn"]["attn_norm"]["scale"] == 1).all())


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_backbone_forward_matches_reference(layers, every):
    jcfg, tcfg, jp, tp = _model(layers, every)
    obs, _ = _obs(jcfg)
    with jdispatch.forced("pallas"):
        jout = jtransformer.forward(jcfg, jp, jnp.asarray(obs))
    tout = ttransformer.forward(tcfg, tp, torch.from_numpy(obs))
    _close(tout["hidden"], jout["hidden"])
    _close(tout["logits"], jout["logits"])
    remat = ttransformer.forward(tcfg, tp, torch.from_numpy(obs), remat=True)
    np.testing.assert_array_equal(remat["logits"].numpy(),
                                  tout["logits"].numpy())


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_prefill_and_decode_match_reference(layers, every):
    """Prefill, then two decode steps, comparing every KV slot (one per
    application) and every layer's SSM state after each."""
    jcfg, tcfg, jp, tp = _model(layers, every)
    obs, _ = _obs(jcfg)
    n_app = ttransformer.num_shared_applications(tcfg)
    with jdispatch.forced("pallas"):
        j_out, j_cache = jtransformer.prefill(jcfg, jp, jnp.asarray(obs),
                                              cache_len=71)
    t_out, t_cache = ttransformer.prefill(tcfg, tp, torch.from_numpy(obs),
                                          cache_len=71)
    _close(t_out["logits"], j_out["logits"])

    def same_cache(t, j, when):
        assert t.attn.k.shape[0] == n_app == j.attn.k.shape[0]
        assert t.ssm.ssm.shape[0] == layers == j.ssm.ssm.shape[0]
        for a in range(n_app):
            for name in ("k", "v"):
                _close(getattr(t.attn, name)[a], getattr(j.attn, name)[a],
                       msg=f"{when} attn.{name}[{a}]")
            for name in ("positions", "length"):
                np.testing.assert_array_equal(
                    getattr(t.attn, name)[a],
                    np.asarray(getattr(j.attn, name)[a]),
                    err_msg=f"{when} attn.{name}[{a}]")
        for i in range(layers):
            for name in ("ssm", "conv"):
                _close(getattr(t.ssm, name)[i], getattr(j.ssm, name)[i],
                       msg=f"{when} ssm.{name}[{i}]")
            np.testing.assert_array_equal(t.ssm.length[i],
                                          np.asarray(j.ssm.length[i]))
    same_cache(t_cache, j_cache, "prefill")
    for step, tok in enumerate(([1, 2, 3], [40, 0, 7])):
        tok = np.array(tok, np.int32)
        with jdispatch.forced("pallas"):
            j_dec, j_cache = jtransformer.decode(jcfg, jp, jnp.asarray(tok),
                                                 j_cache)
        t_dec, t_cache = ttransformer.decode(tcfg, tp, torch.from_numpy(tok),
                                             t_cache)
        _close(t_dec["logits"], j_dec["logits"])
        same_cache(t_cache, j_cache, f"decode {step}")


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_init_decode_cache_is_the_reference_state(layers, every):
    jcfg, tcfg, _, _ = _model(layers, every)
    j = jtransformer.init_decode_cache(jcfg, 3, 10)
    t = ttransformer.init_decode_cache(tcfg, 3, 10, device="cpu")
    for part, names in (("attn", ("k", "v", "positions", "length")),
                        ("ssm", ("conv", "ssm", "length"))):
        for name in names:
            a = getattr(getattr(t, part), name)
            b = np.asarray(getattr(getattr(j, part), name))
            assert tuple(a.shape) == b.shape, (part, name)
            assert str(a.dtype)[6:] == str(b.dtype), (part, name)
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_sample_action_sequence_matches_reference(layers, every):
    jcfg, tcfg, jp, tp = _model(layers, every)
    obs, step = _obs(jcfg)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, jcfg.action_dim)
    shape = (obs.shape[0], jcfg.action_vocab_size)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, shape))
                       for k in keys])
    with jdispatch.forced("pallas"):
        j_tok, j_logp, j_val = jpolicy.sample_action_sequence(
            jcfg, jp, key, jnp.asarray(obs), jnp.asarray(step))
    t_tok, t_logp, t_val = tpolicy.sample_action_sequence(
        tcfg, tp, None, torch.from_numpy(obs), torch.from_numpy(step),
        gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    _close(t_logp, j_logp)
    _close(t_val, j_val)


def _batch_args(cfg):
    # 57 observation + 7 action tokens: T = 64, two chunks of 32
    return (4, 3, 57, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
            cfg.num_prefix_tokens)


@functools.lru_cache(maxsize=None)
def _step(layers, every):
    kw = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
              entropy_coef=0.01)
    jcfg, tcfg, _, _ = _model(layers, every)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                device="cpu")
    tstate = tts.TrainState(tparams, adamw.init(tparams),
                            advnorm.init_adv_state(device="cpu"),
                            torch.zeros((), dtype=torch.int32))
    jbatch = jdummy_batch(*_batch_args(jcfg))
    tbatch = batch_from_numpy(dummy_batch(*_batch_args(tcfg)), device="cpu")
    jslice, _ = jts._microbatches(jbatch, 2)
    tslice, _ = tts._microbatches(tbatch, 2)
    jgrads, tgrads = [], []
    with jdispatch.forced("pallas"):
        for i in range(2):
            g, _ = jts.microbatch_grads(jstate.params, jslice(i),
                                        jstate.adv_norm, cfg=jcfg, rl=jrl)
            jgrads.append(_jflat(g))
            g, _ = tts.microbatch_grads(tstate.params, tslice(i),
                                        tstate.adv_norm, cfg=tcfg, rl=trl,
                                        remat=True)
            tgrads.append(_tflat(g))
        jstate, jm = jts.train_step(jstate, jbatch, cfg=jcfg, rl=jrl)
    tstate, tm = tts.make_train_step(tcfg, trl, device="cpu")(
        tstate, dummy_batch(*_batch_args(tcfg)))
    return jm, tm, jgrads, tgrads, _jflat(jstate.params), \
        _tflat(tstate.params)


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_train_step_loss_and_metrics_match(layers, every):
    jm, tm, _, _, jp, tp = _step(layers, every)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the shared block's tied weights take one AdamW update, like any leaf
    for path in (("shared_attn", "attn", "wq"),
                 ("shared_attn", "mlp", "w_down")):
        _close(tp[path], jp[path], 1e-4, 1e-6, str(path))


@pytest.mark.parametrize("layers,every", LAYOUTS)
def test_microbatch_grads_match(layers, every):
    """Per-leaf gradients of each micro-batch (the port checkpointing each
    block), the shared block's summed over its applications."""
    _, _, jgrads, tgrads, _, _ = _step(layers, every)
    for got, exp in zip(tgrads, jgrads):
        assert got.keys() == exp.keys()
        assert ("shared_attn", "attn", "wq") in got
        assert (("layers_rem", "ssm", "A_log") in got) == (layers == 5)
        for path, e in exp.items():
            scale = float(np.abs(e).max())
            diff = float(np.abs(got[path] - e).max())
            assert diff <= 1e-5 + 1e-4 * scale, (path, diff, scale)
        assert np.abs(got[("shared_attn", "attn", "wq")]).max() > 0
