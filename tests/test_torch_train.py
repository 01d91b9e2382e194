"""The training slice of the port against the JAX package, on the CPU:
JIT-GAE, the Welford merge, AdamW, one whole ``train_step`` (grad_accum 2)
from the same bridged params and the same ``dummy_batch``, and three steps
at the card run's step size.

Tolerances (f32 throughout):
  * loss and every metric: rtol 1e-4 / atol 1e-5;
  * each micro-batch's grads: 1e-5 + 1e-4 * max|g| per leaf (the bar of
    the reference's own fused-vs-reference test);
  * AdamW moments: the grads' bar, relative to each leaf's largest moment;
  * updated params: at step 1 AdamW moves an element by lr * g / (|g| +
    eps), i.e. by about lr whatever |g| is, so a grad within the noise of 0
    may move the two sides apart by up to 2 lr. Each leaf is held within
    0.1 lr, and no more than 0.1% of its elements beyond 0.01 lr
    (measured: at most 0.04 lr and 0.003%).
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
from repro.core import advnorm as jadvnorm
from repro.core import gae as jgae
from repro.data.trajectory import dummy_batch as jdummy_batch
from repro.optim import adamw as jadamw
from repro_torch.bridge import batch_from_numpy, params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core import advnorm, gae
from repro_torch.data.trajectory import dummy_batch
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path

jts = importlib.import_module("repro.core.train_step")
tts = importlib.import_module("repro_torch.core.train_step")

RL_KW = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
             entropy_coef=0.01)
ARCHS = ["deepseek-7b", "openvla-7b"]
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().numpy() for path, x in
            tree_leaves_with_path(tree)}


def _grad_close(got, exp):
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        scale = float(np.abs(e).max())
        diff = float(np.abs(got[path] - e).max())
        assert diff <= 1e-5 + 1e-4 * scale, (path, diff, scale)


def _batch_args(cfg):
    return (4, 3, 6, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
            cfg.num_prefix_tokens)


@functools.lru_cache(maxsize=None)
def _step(arch):
    """One train step on both sides, plus each side's micro-batch grads."""
    jcfg = jreduced(jget_config(arch), layers=2, d_model=64)
    tcfg = reduced(get_config(arch), layers=2, d_model=64)
    jrl, trl = JRLConfig(**RL_KW), RLConfig(**RL_KW)
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
    for i in range(2):
        g, _ = jts.microbatch_grads(jstate.params, jslice(i),
                                    jstate.adv_norm, cfg=jcfg, rl=jrl)
        jgrads.append(_jflat(g))
        g, _ = tts.microbatch_grads(tstate.params, tslice(i),
                                    tstate.adv_norm, cfg=tcfg, rl=trl)
        tgrads.append(_tflat(g))

    js, jm = jts.train_step(jstate, jbatch, cfg=jcfg, rl=jrl)
    step = tts.make_train_step(tcfg, trl, device="cpu")
    ts, tm = step(tstate, dummy_batch(*_batch_args(tcfg)))   # numpy in
    return dict(jm=jm, tm=tm, jgrads=jgrads, tgrads=tgrads, js=js, ts=ts,
                lrs=(RL_KW["lr_policy"] / 2, RL_KW["lr_value"] / 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_metrics_match(arch):
    r = _step(arch)
    assert set(r["tm"]) == set(r["jm"])
    for k in r["jm"]:
        np.testing.assert_allclose(float(r["tm"][k]), float(r["jm"][k]),
                                   err_msg=k, **METRIC_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_grads_match(arch):
    r = _step(arch)
    for got, exp in zip(r["tgrads"], r["jgrads"]):
        _grad_close(got, exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_updated_params_match(arch):
    r = _step(arch)
    lr_p, lr_v = r["lrs"]
    got, exp = _tflat(r["ts"].params), _jflat(r["js"].params)
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        lr = lr_v if path[0] == "value_head" else lr_p
        diff = np.abs(got[path] - e)
        assert diff.max() <= 0.1 * lr, (path, diff.max() / lr)
        assert (diff > 0.01 * lr).mean() <= 1e-3, path


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_and_welford_state_match(arch):
    r = _step(arch)
    js, ts = r["js"], r["ts"]
    assert int(ts.opt.step) == int(js.opt.step) == 1
    assert int(ts.version) == int(js.version) == 1
    for t_tree, j_tree in ((ts.opt.mu, js.opt.mu), (ts.opt.nu, js.opt.nu)):
        _grad_close(_tflat(t_tree), _jflat(j_tree))
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(float(getattr(ts.adv_norm, f)),
                                   float(getattr(js.adv_norm, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


# Three steps at the card run's step size (chip_smoke.py: RLConfig with
# warmup_steps=1, lr_policy=1e-4), so that later steps run with a non-empty
# lagged-norm state and AdamW step > 1. The first AdamW step moves each
# weight by about lr whatever its gradient, so a matrix's output moves in
# proportion to lr x width: the 8-layer case keeps the card run's
# lr x d_model (1e-4 x 4096 = 8e-4 x 512).
# Tolerances: loss and metrics at every step as above; AdamW moments as
# above; Welford state rtol 1e-5 / atol 1e-6; params held within 0.5 lr per
# leaf (three steps, each of which may move a grad within noise of 0 by up
# to 2 lr) and no more than 0.1% of a leaf's elements beyond 0.01 lr
# (measured: at most 0.12 lr and 0.003%).
SMOKE_CASES = [("deepseek-7b", 2, 64, 1e-4), ("openvla-7b", 2, 64, 1e-4),
               ("openvla-7b", 8, 512, 8e-4)]


@functools.lru_cache(maxsize=None)
def _three_steps(arch, layers, d_model, lr):
    kw = dict(warmup_steps=1, lr_policy=lr)
    jcfg = jreduced(jget_config(arch), layers=layers, d_model=d_model)
    tcfg = reduced(get_config(arch), layers=layers, d_model=d_model)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    js = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, js.params),
                                device="cpu")
    ts = tts.TrainState(tparams, adamw.init(tparams),
                        advnorm.init_adv_state(device="cpu"),
                        torch.zeros((), dtype=torch.int32))
    step = tts.make_train_step(tcfg, trl, device="cpu")
    jms, tms = [], []
    for _ in range(3):
        js, jm = jts.train_step(js, jdummy_batch(*_batch_args(jcfg)),
                                cfg=jcfg, rl=jrl)
        ts, tm = step(ts, dummy_batch(*_batch_args(tcfg)))
        jms.append({k: float(v) for k, v in jm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    return dict(js=js, ts=ts, jms=jms, tms=tms, lrs=(lr, trl.lr_value))


@pytest.mark.parametrize("case", SMOKE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_three_steps_at_the_card_step_size_match(case):
    r = _three_steps(*case)
    for i, (tm, jm) in enumerate(zip(r["tms"], r["jms"])):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], err_msg=f"step {i + 1} "
                                       f"{k}", **METRIC_TOL)
    js, ts = r["js"], r["ts"]
    assert int(ts.opt.step) == int(js.opt.step) == 3
    assert int(ts.version) == int(js.version) == 3
    for t_tree, j_tree in ((ts.opt.mu, js.opt.mu), (ts.opt.nu, js.opt.nu)):
        _grad_close(_tflat(t_tree), _jflat(j_tree))
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(float(getattr(ts.adv_norm, f)),
                                   float(getattr(js.adv_norm, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    lr_p, lr_v = r["lrs"]
    got, exp = _tflat(ts.params), _jflat(js.params)
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        lr = lr_v if path[0] == "value_head" else lr_p
        diff = np.abs(got[path] - e)
        assert diff.max() <= 0.5 * lr, (path, diff.max() / lr)
        assert (diff > 0.01 * lr).mean() <= 1e-3, path


def test_the_card_step_size_collapses_entropy_on_both_sides():
    """At 8 layers and the card run's lr x width, step 2 shows the
    signature of the card run's jump (there: entropy 5.2 -> 0.6, grad norm
    x1e7) in the reference and the port alike: entropy below half of step
    1's and the grad norm above 5x step 1's (measured 3.83 -> 1.41 and
    65 -> 537 on both sides)."""
    r = _three_steps(*SMOKE_CASES[2])
    for ms in (r["jms"], r["tms"]):
        assert ms[1]["entropy"] < 0.5 * ms[0]["entropy"], ms
        assert ms[1]["grad_norm"] > 5 * ms[0]["grad_norm"], ms


def _loss_and_grads(cfg, rl, params, micro, remat=False):
    grads, (metrics, _) = tts.microbatch_grads(
        params, micro, advnorm.init_adv_state(device="cpu"), cfg=cfg, rl=rl,
        remat=remat)
    return metrics, _tflat(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_agrees_with_no_remat(arch):
    cfg = reduced(get_config(arch), layers=2, d_model=64)
    rl = RLConfig(**RL_KW)
    state = tts.init_train_state(cfg, 0, device="cpu")
    micro = batch_from_numpy(dummy_batch(*_batch_args(cfg)), device="cpu")
    m0, g0 = _loss_and_grads(cfg, rl, state.params, micro)
    m1, g1 = _loss_and_grads(cfg, rl, state.params, micro, remat=True)
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for path in g0:
        np.testing.assert_allclose(g1[path], g0[path], rtol=1e-5, atol=1e-7,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_path_agrees_with_reference_path(arch):
    cfg = reduced(get_config(arch), layers=2, d_model=64)
    rl = RLConfig(**RL_KW)
    state = tts.init_train_state(cfg, 1, device="cpu")
    micro = batch_from_numpy(dummy_batch(*_batch_args(cfg), seed=3),
                             device="cpu")
    mf, gf = _loss_and_grads(cfg, rl, state.params, micro)
    mr, gr = _loss_and_grads(cfg, dataclasses.replace(rl, fused_loss=False),
                             state.params, micro)
    np.testing.assert_allclose(float(mf["loss"]), float(mr["loss"]),
                               rtol=1e-5, atol=1e-6)
    for k in ("pg_loss", "value_loss", "kl", "entropy", "ratio_mean",
              "omega_mean", "stale_frac"):
        np.testing.assert_allclose(float(mf[k]), float(mr[k]), err_msg=k,
                                   **METRIC_TOL)
    _grad_close(gf, gr)


def test_every_leaf_gets_a_gradient_on_the_cpu_route():
    cfg = reduced(get_config("openvla-7b"), layers=2, d_model=64)
    state = tts.init_train_state(cfg, 0, device="cpu")
    micro = batch_from_numpy(dummy_batch(*_batch_args(cfg)), device="cpu")
    _, grads = _loss_and_grads(cfg, RLConfig(**RL_KW), state.params, micro)
    for path, g in grads.items():
        assert np.abs(g).max() > 0, path


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 5, 16])
def test_gae_matches_the_numpy_oracle_and_jax(t):
    rng = np.random.default_rng(t)
    values = rng.standard_normal((6, t + 1)).astype(np.float32)
    rewards = rng.uniform(-1, 1, (6, t)).astype(np.float32)
    dones = (rng.random((6, t)) < 0.2).astype(np.float32)
    adv, ret = gae.gae(*map(torch.from_numpy, (values, rewards, dones)),
                       0.99, 0.95)
    exp_adv, exp_ret = gae.gae_reference(values, rewards, dones, 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), exp_adv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), exp_ret, rtol=1e-5, atol=1e-5)
    j_adv, j_ret = jgae.gae(*map(jnp.asarray, (values, rewards, dones)),
                            0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), rtol=1e-6,
                               atol=1e-6)


def test_jit_gae_detaches_the_values():
    v = torch.randn(2, 4, requires_grad=True)
    adv, _ = gae.jit_gae_from_forward(v, torch.zeros(2, 3),
                                      torch.zeros(2, 3), 0.99, 0.95)
    assert not adv.requires_grad


def test_welford_update_and_lagged_norm_match_jax():
    rng = np.random.default_rng(0)
    jstate = jadvnorm.init_adv_state()
    tstate = advnorm.init_adv_state(device="cpu")
    seen = []
    for i in range(3):
        adv = rng.standard_normal((4, 5)).astype(np.float32) * (i + 1)
        mask = (rng.random((4, 5)) > 0.2).astype(np.float32)
        seen.append(adv[mask > 0])
        np.testing.assert_allclose(
            advnorm.normalize_lagged(torch.from_numpy(adv), tstate).numpy(),
            np.asarray(jadvnorm.normalize_lagged(jnp.asarray(adv), jstate)),
            rtol=1e-6, atol=1e-6)
        js = jadvnorm.local_stats(jnp.asarray(adv), jnp.asarray(mask))
        ts = advnorm.local_stats(torch.from_numpy(adv),
                                 torch.from_numpy(mask))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        jstate = jadvnorm.welford_update(jstate, js)
        tstate = advnorm.welford_update(tstate, ts)
        for f in ("count", "mean", "m2"):
            np.testing.assert_allclose(float(getattr(tstate, f)),
                                       float(getattr(jstate, f)),
                                       rtol=1e-6, atol=1e-6)
    allv = np.concatenate(seen).astype(np.float64)
    np.testing.assert_allclose(float(tstate.mean), allv.mean(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tstate.std), allv.std(), rtol=1e-5)


def test_adamw_three_steps_with_clipping_and_an_lr_tree_match_jax():
    rng = np.random.default_rng(1)
    shapes = {"a": {"w": (8, 5), "b": (5,)}, "value_head": {"w": (5, 1)}}
    params = {k: {n: rng.standard_normal(s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    jstate, tstate = jadamw.init(jparams), adamw.init(tparams)
    lr_j = {"a": {"w": 1e-2, "b": 1e-2}, "value_head": {"w": 1e-1}}
    for step in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32),
            params)
        jparams, jstate, jn = jadamw.update(
            jax.tree.map(jnp.asarray, grads), jstate, jparams, lr_j,
            max_grad_norm=1.0, weight_decay=0.01)
        tparams, tstate, tn = adamw.update(
            params_from_numpy(grads, device="cpu"), tstate, tparams,
            lr_j, max_grad_norm=1.0, weight_decay=0.01)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for got, exp in ((tparams, jparams), (tstate.mu, jstate.mu),
                         (tstate.nu, jstate.nu)):
            g, e = _tflat(got), _jflat(exp)
            for path in e:
                np.testing.assert_allclose(g[path], e[path], rtol=2e-6,
                                           atol=1e-7, err_msg=str(path))


def test_warmup_schedule_and_lr_tree():
    lr = adamw.warmup_schedule(1e-3, 4)
    got = [float(lr(torch.tensor(s, dtype=torch.int32))) for s in range(6)]
    np.testing.assert_allclose(got, [2.5e-4, 5e-4, 7.5e-4, 1e-3, 1e-3, 1e-3],
                               rtol=1e-6)
    tree = tts._lr_tree({"layers": {"w": 0}, "value_head": {"a": 0,
                                                            "b": {"c": 0}}},
                        1.0, 10.0)
    assert tree == {"layers": {"w": 1.0}, "value_head": {"a": 10.0,
                                                         "b": {"c": 10.0}}}
