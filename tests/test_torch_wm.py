"""The world model of the port (``repro_torch.wm``) against the JAX
package's (``repro.wm``) on the CPU: the EDM denoiser, its loss, gradients,
train step and sampler; the reward model; ``imagine_rollout`` on reduced
deepseek-7b; ``pretrain_world_model``; ``AcceRLWMSystem`` and ``run_wm``
end to end; and the WM trainer's rebinding, which must never write a tree
that an imagination call may be reading.

Inputs come from numpy seeds, the weights from the JAX side through
``wm_params_from_numpy`` / ``params_from_numpy``, and the noise is the
reference's own draws, derived from its keys as it derives them. The JAX
side runs as ``tests/test_wm.py`` runs it.

Tolerances: the f32 MLPs (denoiser, reward model, their losses, gradients
and one AdamW step) within rtol 1e-5 / atol 1e-6 (``MLP_TOL``). One
exception, from AdamW's arithmetic: the first step moves a parameter by
lr·g/(|g| + eps), eps 1e-8, so where the reference's gradient is below the
gradients' atol (1e-6) the two updates may differ by up to 2·lr; such
parameters are held to that, and must be at most ``TINY_SHARE`` of each
leaf, while a parameter whose reference gradient is exactly zero must come
out unchanged, as the reference's does (``_close_step``). The
imagined rollout, which runs the policy, within ``tests/test_torch_policy``'s
bars, rtol 1e-4 / atol 1e-4 (``POLICY_TOL``), with identical actions and
dones.
"""
import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.envs.toy_manipulation import FRAME_DIM
from repro.models import policy as jpolicy
from repro.optim import adamw as jadamw
from repro.wm import denoiser as jdn
from repro.wm import imagination as jimag
from repro.wm import reward as jrw
from repro.wm import wm_system as jwm
from repro_torch.bridge import params_from_numpy, wm_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime.experience import MixedExperienceSource, RingChannel
from repro_torch.runtime.orchestrator import AcceRLSystem
from repro_torch.tree import tree_leaves_with_path
from repro_torch.wm import denoiser as tdn
from repro_torch.wm import imagination as timag
from repro_torch.wm import reward as trw
from repro_torch.wm import wm_system as twm

MLP_TOL = dict(rtol=1e-5, atol=1e-6)
# the largest share of a leaf whose reference gradient is nonzero but below
# MLP_TOL's atol (read at most 22 of 16384, 0.13%, in the reward model's w2)
TINY_SHARE = 1e-2
POLICY_TOL = dict(rtol=1e-4, atol=1e-4)
WM_KW = dict(imagine_horizon=3, history_frames=2, diffusion_steps=4)
KEY = jax.random.PRNGKey(0)
F, A, VA, B = 16, 3, 8, 4           # the MLP tests' frame, action, vocab, batch
# the reference's policy init, jitted: eager, it takes seconds a call
_jit_policy_init = jax.jit(jpolicy.init_policy_params, static_argnums=0)


def _np(x):
    return np.asarray(x)


def _wm(cfgs, **kw):
    return cfgs.WMConfig(**{**WM_KW, **kw})


@pytest.fixture(scope="module")
def mlp():
    """Both packages' denoiser and reward model on the same weights, and a
    seeded batch."""
    jwm_cfg = _wm(jconfigs)
    k1, k2 = jax.random.split(KEY)
    jp = {"obs": jax.jit(jdn.denoiser_init, static_argnums=(1, 2, 3, 4))(
              k1, F, A, VA, jwm_cfg),
          "reward": jax.jit(jrw.reward_init, static_argnums=1)(k2, F)}
    tp = wm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    data = dict(
        frames=rng.standard_normal((B, F)).astype(np.float32),
        hist=rng.standard_normal((B, 2, F)).astype(np.float32),
        acts=rng.integers(0, VA, (B, A)).astype(np.int32),
        success=(rng.random(B) > 0.5).astype(np.float32))
    return jwm_cfg, jp, tp, data


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_tree(got, exp, tol, what):
    for path, x in tree_leaves_with_path(got):
        e = exp
        for k in path:
            e = e[k]
        np.testing.assert_allclose(x.detach().numpy(), _np(e),
                                   err_msg=f"{what} {path}", **tol)


def _close_step(got, exp, exp_grads, lr, what):
    """One AdamW step's parameters: MLP_TOL where the reference gradient
    is at least the gradients' atol; bit-equal where it is zero; within
    2·lr elsewhere, on at most TINY_SHARE of the leaf (see the module
    docstring)."""
    for k, x in got.items():
        x, e, g = x.numpy(), _np(exp[k]), np.abs(_np(exp_grads[k]))
        sure, zero = g >= MLP_TOL["atol"], g == 0
        tiny = ~sure & ~zero
        np.testing.assert_allclose(x[sure], e[sure], err_msg=f"{what} {k}",
                                   **MLP_TOL)
        np.testing.assert_array_equal(x[zero], e[zero], f"{what} {k}")
        assert tiny.mean() <= TINY_SHARE, (what, k, int(tiny.sum()))
        assert np.all(np.abs(x - e)[tiny] <= 2 * lr), (what, k)


def _grads(loss_fn, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    loss = loss_fn(leaves)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# M_obs: the EDM denoiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [2e-3, 0.5, 80.0])
def test_denoiser_apply_matches_reference(mlp, sigma):
    _, jp, tp, d = mlp
    x = d["frames"] * 2.0
    exp = jdn.denoiser_apply(jp["obs"], jnp.asarray(x),
                             jnp.full((B,), sigma, jnp.float32),
                             jnp.asarray(d["hist"]), jnp.asarray(d["acts"]),
                             0.5)
    got = tdn.denoiser_apply(tp["obs"], _t(x),
                             torch.full((B,), sigma), _t(d["hist"]),
                             _t(d["acts"]), 0.5)
    np.testing.assert_allclose(got.numpy(), _np(exp), **MLP_TOL)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_karras_schedule_matches_reference(n):
    got = tdn.karras_schedule(n)
    assert got.dtype == torch.float32 and got.shape == (n + 1,)
    np.testing.assert_allclose(got.numpy(), _np(jdn.karras_schedule(n)),
                               **MLP_TOL)


def _loss_noise(key, shape):
    """The reference's own z_sigma / z_noise: ``denoiser_loss`` splits its
    key in two and draws one normal from each."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.normal(k1, (shape[0],))),
            _t(jax.random.normal(k2, shape)))


def test_denoiser_loss_and_gradients_match_reference(mlp):
    jwm_cfg, jp, tp, d = mlp
    key = jax.random.PRNGKey(5)
    args = [jnp.asarray(d[k]) for k in ("frames", "hist", "acts")]
    exp_loss, exp_grads = jax.value_and_grad(jdn.denoiser_loss)(
        jp["obs"], key, *args, jwm_cfg)
    z_sigma, z_noise = _loss_noise(key, d["frames"].shape)
    wm = _wm(tconfigs)
    loss, grads = _grads(lambda p: tdn.denoiser_loss(
        p, None, _t(d["frames"]), _t(d["hist"]), _t(d["acts"]), wm,
        z_sigma=z_sigma, z_noise=z_noise), tp["obs"])
    np.testing.assert_allclose(loss.numpy(), _np(exp_loss), **MLP_TOL)
    assert set(grads) == set(exp_grads)
    _close_tree(grads, exp_grads, MLP_TOL, "grad")


def test_denoiser_train_step_matches_reference(mlp):
    jwm_cfg, jp, _, d = mlp
    key = jax.random.PRNGKey(6)
    args = [jnp.asarray(d[k]) for k in ("frames", "hist", "acts")]
    exp_grads = jax.grad(jdn.denoiser_loss)(jp["obs"], key, *args, jwm_cfg)
    exp_p, exp_opt, exp_loss = jdn.make_denoiser_train_step(jwm_cfg)(
        jp["obs"], jadamw.init(jp["obs"]), key, *args)
    tp = wm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    z_sigma, z_noise = _loss_noise(key, d["frames"].shape)
    got_p, got_opt, loss = tdn.make_denoiser_train_step(_wm(tconfigs))(
        tp["obs"], tp["obs_opt"], None, _t(d["frames"]), _t(d["hist"]),
        _t(d["acts"]), z_sigma=z_sigma, z_noise=z_noise)
    np.testing.assert_allclose(loss.numpy(), _np(exp_loss), **MLP_TOL)
    assert int(got_opt.step) == int(exp_opt.step) == 1
    _close_step(got_p, exp_p, exp_grads, 1e-4, "params")
    _close_tree(got_opt.mu, exp_opt.mu, MLP_TOL, "mu")
    _close_tree(got_opt.nu, exp_opt.nu, MLP_TOL, "nu")


def test_sample_next_frame_matches_reference(mlp):
    jwm_cfg, jp, tp, d = mlp
    key = jax.random.PRNGKey(7)
    exp = jdn.sample_next_frame(jp["obs"], key, jnp.asarray(d["hist"]),
                                jnp.asarray(d["acts"]), jwm_cfg)
    x0 = _t(jax.random.normal(key, (B, F)))
    got = tdn.sample_next_frame(tp["obs"], None, _t(d["hist"]),
                                _t(d["acts"]), _wm(tconfigs), x0=x0)
    np.testing.assert_allclose(got.numpy(), _np(exp), **MLP_TOL)
    # without x0 it draws from its generator: same seed, same frame
    outs = [tdn.sample_next_frame(tp["obs"],
                                  torch.Generator().manual_seed(1),
                                  _t(d["hist"]), _t(d["acts"]),
                                  _wm(tconfigs)) for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# M_reward
# ---------------------------------------------------------------------------

def test_reward_model_matches_reference(mlp):
    _, jp, tp, d = mlp
    frames = d["frames"] * 3.0
    np.testing.assert_allclose(
        trw.reward_apply(tp["reward"], _t(frames)).numpy(),
        _np(jrw.reward_apply(jp["reward"], jnp.asarray(frames))), **MLP_TOL)
    exp_loss, exp_grads = jax.value_and_grad(jrw.reward_loss)(
        jp["reward"], jnp.asarray(frames), jnp.asarray(d["success"]))
    loss, grads = _grads(lambda p: trw.reward_loss(
        p, _t(frames), _t(d["success"])), tp["reward"])
    np.testing.assert_allclose(loss.numpy(), _np(exp_loss), **MLP_TOL)
    _close_tree(grads, exp_grads, MLP_TOL, "grad")


def test_reward_train_step_matches_reference(mlp):
    _, jp, _, d = mlp
    args = (jnp.asarray(d["frames"]), jnp.asarray(d["success"]))
    exp_grads = jax.grad(jrw.reward_loss)(jp["reward"], *args)
    exp_p, exp_opt, exp_loss = jrw.make_reward_train_step()(
        jp["reward"], jadamw.init(jp["reward"]), *args)
    tp = wm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got_p, got_opt, loss = trw.make_reward_train_step()(
        tp["reward"], tp["reward_opt"], _t(d["frames"]), _t(d["success"]))
    np.testing.assert_allclose(loss.numpy(), _np(exp_loss), **MLP_TOL)
    _close_step(got_p, exp_p, exp_grads, 1e-4, "params")
    _close_tree(got_opt.mu, exp_opt.mu, MLP_TOL, "mu")
    _close_tree(got_opt.nu, exp_opt.nu, MLP_TOL, "nu")


def test_bridge_carries_given_moments(mlp):
    _, jp, _, _ = mlp
    opt = jadamw.init(jp["reward"])
    opt = opt._replace(step=jnp.asarray(3, jnp.int32),
                       mu=jax.tree.map(lambda m: m + 1.5, opt.mu))
    tree = jax.tree.map(np.asarray, dict(jp, reward_opt=opt))
    got = wm_params_from_numpy(tree, device="cpu")
    assert int(got["reward_opt"].step) == 3
    assert all(bool((m == 1.5).all()) for m in got["reward_opt"].mu.values())
    assert int(got["obs_opt"].step) == 0          # not given: fresh
    assert all(x.dtype == torch.float32 for x in got["obs"].values())


# ---------------------------------------------------------------------------
# imagination (eqs. 3-4)
# ---------------------------------------------------------------------------

def _policy_cfg(cfgs):
    return dataclasses.replace(
        cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64),
        num_prefix_tokens=1)


def _imagination_noise(key, b, cfg, wm):
    """The reference's draws inside ``imagine_rollout``: one key per step,
    split into the sampler's and the denoiser's; the sampler splits its
    key per action token and draws Gumbel noise from each."""
    gumbel, x0 = [], []
    for key_t in jax.random.split(key, wm.imagine_horizon):
        k_act, k_obs = jax.random.split(key_t)
        gumbel.append(np.stack([
            _np(jax.random.gumbel(k, (b, cfg.action_vocab_size)))
            for k in jax.random.split(k_act, cfg.action_dim)]))
        x0.append(_np(jax.random.normal(k_obs, (b, FRAME_DIM))))
    return {"gumbel": _t(np.stack(gumbel)), "x0": _t(np.stack(x0))}


def test_imagine_rollout_matches_reference():
    jcfg, tcfg = _policy_cfg(jconfigs), _policy_cfg(tconfigs)
    jwm_cfg, wm = _wm(jconfigs), _wm(tconfigs)
    k_pol, k_obs, k_rew, key = jax.random.split(KEY, 4)
    jpol = _jit_policy_init(jcfg, k_pol)
    jobs = jdn.denoiser_init(k_obs, FRAME_DIM, jcfg.action_dim,
                             jcfg.action_vocab_size, jwm_cfg)
    jrew = jrw.reward_init(k_rew, FRAME_DIM)
    tpol = params_from_numpy(jax.tree.map(np.asarray, jpol), device="cpu")
    twm_p = wm_params_from_numpy(jax.tree.map(
        np.asarray, {"obs": jobs, "reward": jrew}), device="cpu")
    b = 3
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (b, 12)).astype(np.int32)
    frame0 = rng.random((b, FRAME_DIM)).astype(np.float32)
    step0 = np.array([0, 4, 9], np.int32)
    exp = jimag.make_imagine_fn(jcfg, jwm_cfg)(
        jpol, jobs, jrew, key, jnp.asarray(tokens), jnp.asarray(frame0),
        jnp.asarray(step0))
    got = timag.imagine_rollout(
        tpol, twm_p["obs"], twm_p["reward"], None,
        _t(tokens).long(), _t(frame0), _t(step0), cfg=tcfg, wm=wm,
        noise=_imagination_noise(key, b, jcfg, jwm_cfg))
    assert set(got) == set(exp)
    for k in exp:
        assert tuple(got[k].shape) == exp[k].shape, k
    for k in ("actions", "dones", "steps", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), _np(exp[k]), k)
    np.testing.assert_array_equal(got["obs_tokens"].numpy(),
                                  _np(exp["obs_tokens"]))
    for k in ("frames", "rewards", "behavior_logp", "behavior_value"):
        np.testing.assert_allclose(got[k].numpy(), _np(exp[k]), err_msg=k,
                                   **POLICY_TOL)
    np.testing.assert_array_equal(got["frames"][:, 0].numpy(), frame0)
    # eq. 4 telescopes: Σ r̂ = scale·(M_r(ô_H) − M_r(ô_0))
    p = trw.reward_apply(twm_p["reward"], got["frames"][:, -1]) - \
        trw.reward_apply(twm_p["reward"], got["frames"][:, 0])
    np.testing.assert_allclose(got["rewards"].sum(1).numpy(),
                               (wm.reward_scale * p).numpy(), atol=1e-5)


def test_make_imagine_fn_is_numpy_in_and_out():
    tcfg, wm = _policy_cfg(tconfigs), _wm(tconfigs)
    from repro_torch.models.policy import init_policy_params
    gen = torch.Generator().manual_seed(0)
    pol = init_policy_params(tcfg, 0, device="cpu")
    obs = tdn.denoiser_init(gen, FRAME_DIM, tcfg.action_dim,
                            tcfg.action_vocab_size, wm)
    rew = trw.reward_init(gen, FRAME_DIM)
    rng = np.random.default_rng(1)
    args = (rng.integers(0, 64, (2, 12)).astype(np.int32),
            rng.random((2, FRAME_DIM)).astype(np.float32),
            np.zeros(2, np.int32))
    fn = timag.make_imagine_fn(tcfg, wm, device="cpu")
    outs = [fn(pol, obs, rew, torch.Generator().manual_seed(4), *args)
            for _ in range(2)]
    h = wm.imagine_horizon
    assert all(isinstance(v, np.ndarray) for v in outs[0].values())
    assert outs[0]["frames"].shape == (2, h + 1, FRAME_DIM)
    assert outs[0]["rewards"].shape == (2, h)
    assert outs[0]["steps"].dtype == np.int32
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], k)


# ---------------------------------------------------------------------------
# pre-training and the system
# ---------------------------------------------------------------------------

def test_pretrain_world_model_matches_reference_transitions():
    kw = dict(trajectories=4, train_steps=5, batch=8, action_vocab=64,
              action_dim=7)
    exp = jwm.pretrain_world_model("spatial", _wm(jconfigs), **kw)
    got = twm.pretrain_world_model("spatial", _wm(tconfigs), device="cpu",
                                   **kw)
    assert got["transitions"] == exp["transitions"]
    for k in ("obs", "reward"):
        assert len(got["losses"][k]) == 5
        assert np.isfinite(got["losses"][k]).all()
        assert set(got[k]) == set(exp[k])
        assert int(got[f"{k}_opt"].step) == 5


def _wm_system(cfgs, **kw):
    cfg = cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64)
    rl = cfgs.RLConfig(grad_accum=1, lr_policy=1e-4, lr_value=1e-3)
    rt = cfgs.RuntimeConfig(num_rollout_workers=2, inference_batch=4,
                            prefetch_to_device=True)
    wm = cfgs.WMConfig(imagine_horizon=2, history_frames=2,
                       diffusion_steps=4, obs_train_interval=2,
                       reward_train_interval=5)
    args = dict(suite="spatial", segment_horizon=4, max_episode_steps=8,
                imagination_batch=4, **kw)
    if cfgs is jconfigs:
        return jwm.AcceRLWMSystem(cfg, rl, rt, wm, **args)
    return twm.AcceRLWMSystem(cfg, rl, rt, wm, device="cpu", **args)


def test_wm_system_attaches_and_runs_with_the_reference_keys(monkeypatch):
    monkeypatch.setattr(jpolicy, "init_policy_params", _jit_policy_init)
    reference_keys = set(_wm_system(jconfigs).metrics(1.0))
    system = _wm_system(tconfigs)
    assert type(system) is AcceRLSystem
    assert isinstance(system.attachments[0], twm.WorldModelAttachment)
    # the SAME trainer service, rewired onto the mixed (B, B_img) source
    assert system.img_trainer is system.trainer
    assert isinstance(system.trainer.source, MixedExperienceSource)
    # ... through a prefetcher on the trainer's own ingest path
    pf = system.trainer.prefetcher
    assert pf.source is system.trainer.source and pf.batch_size == 4
    assert pf.to_device and pf.stage_batches
    assert pf.device == system.device == torch.device("cpu")
    names = set(system.registry.snapshot())
    assert {"inference", "trainer", "wm-trainer", "imagination-0"} <= names
    m = system.run_wm(train_steps=1, wall_timeout_s=120.0)
    assert set(m) == reference_keys
    assert m["img_train_steps"] >= 1
    assert m["imagined_steps"] > 0
    assert set(m["wm_updates"]) == {"obs", "reward"}
    assert m["real_env_steps"] == m["env_steps"]
    assert system.trainer.source.real_consumed == 0     # pure imagination
    for s in system.registry.all():
        assert s.healthy and s.status == "stopped", (s.name, s.health())
    log = system.trainer.metrics_log
    assert len(log) == m["train_steps"]
    assert all(np.isfinite(v) for entry in log for v in entry.values())
    # a started trainer's prefetcher cannot be swapped
    with pytest.raises(RuntimeError, match="rewire after start"):
        system.trainer.rewire(system.trainer.source, 4)


def test_mixed_diet_rejects_horizon_mismatch():
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), layers=2,
                           d_model=64)
    rl = tconfigs.RLConfig(grad_accum=1)
    wm = tconfigs.WMConfig(imagine_horizon=2, history_frames=2,
                           diffusion_steps=4)
    rt = tconfigs.RuntimeConfig(num_rollout_workers=1,
                                mix_real_fraction=0.25)
    with pytest.raises(ValueError, match="segment_horizon"):
        twm.AcceRLWMSystem(cfg, rl, rt, wm, segment_horizon=4,
                           max_episode_steps=8, device="cpu")
    # matching horizons bind fine; the pure-imagined extreme (0.0) never
    # mixes kinds, so mismatched horizons stay allowed there
    twm.AcceRLWMSystem(cfg, rl, rt, wm, segment_horizon=2,
                       max_episode_steps=8, device="cpu")
    twm.AcceRLWMSystem(cfg, rl, dataclasses.replace(
        rt, mix_real_fraction=0.0), wm, segment_horizon=4,
        max_episode_steps=8, device="cpu")


# ---------------------------------------------------------------------------
# the WM trainer's snapshots
# ---------------------------------------------------------------------------

def _transitions(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"frame": rng.random(FRAME_DIM).astype(np.float32),
             "next_frame": rng.random(FRAME_DIM).astype(np.float32),
             "actions": rng.integers(0, 64, 7).astype(np.int32),
             "success": np.float32(i % 3 == 0)} for i in range(n)]


def _wm_trainer(wm):
    gen = torch.Generator().manual_seed(0)
    params = {"obs": tdn.denoiser_init(gen, FRAME_DIM, 7, 64, wm),
              "reward": trw.reward_init(gen, FRAME_DIM)}
    chan = RingChannel(64)
    chan.put_many(_transitions(32))
    opts = {k: adamw.init(v) for k, v in params.items()}
    return params, twm.WorldModelTrainer(wm, params, opts, chan, batch=8,
                                         device="cpu")


def _snapshot(tree):
    return {k: v.clone() for k, v in tree.items()}


def _equal(tree, snap):
    return all(torch.equal(tree[k], snap[k]) for k in snap)


def test_wm_trainer_rebinds_and_never_writes_a_bound_tree():
    wm = tconfigs.WMConfig(history_frames=2, diffusion_steps=2,
                           denoiser_d_model=32, obs_train_interval=2,
                           reward_train_interval=3)
    params, trainer = _wm_trainer(wm)
    held, held_rew = params["obs"], params["reward"]
    snap, snap_rew = _snapshot(held), _snapshot(held_rew)
    # an imagination call reads the bound tree under inference mode on its
    # own thread, as the imagination worker does
    hist = torch.rand(4, 2, FRAME_DIM)
    acts = torch.zeros(4, 7, dtype=torch.long)

    def imagine():
        with torch.inference_mode():
            tdn.sample_next_frame(params["obs"], None, hist, acts, wm,
                                  x0=torch.zeros(4, FRAME_DIM))
    t = threading.Thread(target=imagine)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    for _ in range(wm.obs_train_interval):
        trainer.train_cycle(trainer.sample_batch())
    assert trainer.updates == {"obs": 1, "reward": 0}
    assert params["obs"] is not held and _equal(held, snap)
    assert params["reward"] is held_rew and _equal(held_rew, snap_rew)
    published = params["obs"]
    private = {x.untyped_storage().data_ptr() for x in trainer._obs.values()}
    for k, x in published.items():
        assert not x.is_inference() and not x.requires_grad, k
        assert x.untyped_storage().data_ptr() not in private, k
    assert not _equal(published, snap)              # it was an update
    # the next cycles still differentiate, and rebind once more
    snap_pub = _snapshot(published)
    for _ in range(wm.obs_train_interval):
        trainer.train_cycle(trainer.sample_batch())
    assert trainer.updates == {"obs": 2, "reward": 1}
    assert params["obs"] is not published and _equal(published, snap_pub)
    assert params["reward"] is not held_rew and _equal(held_rew, snap_rew)


def test_wm_trainer_under_concurrent_imagination_reads():
    """A reader thread samples on whatever tree is bound while the trainer
    steps on the main thread: every tree it read is unchanged after its
    read, across many rebinds."""
    wm = tconfigs.WMConfig(history_frames=2, diffusion_steps=2,
                           denoiser_d_model=32, obs_train_interval=1,
                           reward_train_interval=1)
    params, trainer = _wm_trainer(wm)
    hist = torch.rand(2, 2, FRAME_DIM)
    acts = torch.zeros(2, 7, dtype=torch.long)
    stop, reads, changed = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            tree = params["obs"]
            snap = _snapshot(tree)
            with torch.inference_mode():
                tdn.sample_next_frame(tree, None, hist, acts, wm,
                                      x0=torch.zeros(2, FRAME_DIM))
            reads.append(tree)
            if not _equal(tree, snap):
                changed.append(len(reads))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=reader)
    try:
        t.start()
        for _ in range(20):
            trainer.train_cycle(trainer.sample_batch())
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    assert trainer.updates == {"obs": 20, "reward": 20}
    assert reads and not changed
    assert len({id(tree) for tree in reads}) > 1     # it saw rebinds


def test_wm_trainer_driven_mode_names_its_roadmap_item():
    """A driven WM trainer (the pipeline executor's WM stage) never trains
    from its own loop, though B_wm holds transitions; the driver's
    ``train_cycle`` does."""
    wm = tconfigs.WMConfig(denoiser_d_model=32, obs_train_interval=1,
                           reward_train_interval=1)
    params, trainer = _wm_trainer(wm)
    opts = {k: adamw.init(v) for k, v in params.items()}
    driven = twm.WorldModelTrainer(wm, params, opts, trainer.frame_channel,
                                   batch=4, driven=True, device="cpu")
    assert driven.sample_batch() is not None
    driven.start()
    try:
        time.sleep(0.3)
        assert driven.cycles == 0 and driven.updates == {"obs": 0,
                                                         "reward": 0}
        driven.train_cycle(driven.sample_batch())
        assert driven.updates == {"obs": 1, "reward": 1}
    finally:
        driven.stop()
        driven.join(timeout=10.0)
    assert driven.cycles == 1
