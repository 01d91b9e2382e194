"""The moe family of the port (``repro_torch.models.moe`` and the moe
branch of ``repro_torch.models.transformer``) against the JAX package, on
the CPU, f32.

The same numpy-seeded inputs and the same weights go through both
packages: drawn by the port's init (whose tree, dtypes and scale the last
tests hold to the reference's) and carried to JAX through the bridge, so
that every JAX call can be jitted and the file stays cheap. Two MoE
settings: ``reduced()``'s own (4 experts, top-2, ``capacity_factor`` 2.0
= E/k, so no assignment is ever dropped) and one that drops (8 experts,
top-2, ``capacity_factor`` 1.0), each at one group and at several
(``group_tokens=32``). Keep masks must be equal element for element;
logits and aux terms agree within ``TOL`` (rtol/atol 1e-5, as
``test_torch_models.py``), the layer's outputs and gradients within TOL
of their largest value (``_close_scaled``); the backbone, prefill/decode
and the sampler within ``test_torch_policy.py``'s 1e-4 (tokens
identical); one train step within ``test_torch_train.py``'s METRIC_TOL and
per-leaf gradient bar. The JAX side runs its attention through the plain jnp
reference (the dispatch's CPU default), which the reference's own tests
hold against its Pallas kernels.
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
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import RLConfig as JRLConfig
from repro.data.trajectory import dummy_batch as jdummy_batch
from repro.core import advnorm as jadvnorm
from repro.models import moe as jmoe
from repro.models import policy as jpolicy
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import RLConfig, get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.core import advnorm
from repro_torch.data.trajectory import dummy_batch
from repro_torch.models import moe as tmoe
from repro_torch.models import policy as tpolicy
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path, tree_map

jts = importlib.import_module("repro.core.train_step")
tts = importlib.import_module("repro_torch.core.train_step")

TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "granite-moe-1b-a400m"
# (num_experts, top_k, capacity_factor): reduced()'s, and one that drops
MOE = {"no_drops": (4, 2, 2.0), "drops": (8, 2, 1.0)}
GROUPS = {"one_group": 512, "groups_of_32": 32}
D = 32


def _moe_cfgs(setting):
    e, k, cf = MOE[setting]
    kw = dict(num_experts=e, top_k=k, d_ff=48, capacity_factor=cf)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _to_jax(tparams):
    """The port's tree as the reference's (numpy through the bridge)."""
    return jax.tree.map(jnp.asarray, params_to_numpy(tparams))


@functools.lru_cache(maxsize=None)
def _layer(setting):
    """One layer's weights, drawn by the port's ``moe_init`` (the
    reference's shapes, dtypes and init rule) and given to both."""
    jcfg, tcfg = _moe_cfgs(setting)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), D, tcfg,
                       torch.float32, "cpu")
    return jcfg, tcfg, _to_jax(tp), tp


def _x(b, t, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _close(got, exp, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), err_msg=msg,
                               **(tol or TOL))


def _close_scaled(got, exp, msg=""):
    """Within TOL once both sides are divided by max(1, max|exp|): the
    layer's outputs and gradients reach ~30 (the reference's fan-in init
    draws expert weights at std 1/sqrt(E)), and each element is a sum of
    terms of that size, so f32 reordering moves a small element by ~1e-5
    of the largest."""
    exp = np.asarray(exp, np.float32)
    scale = max(float(np.abs(exp).max()), 1.0)
    _close(np.asarray(got, np.float32) / scale, exp / scale, msg=msg)


@functools.lru_cache(maxsize=None)
def _jit_moe_forward(setting, group_tokens):
    jcfg = _moe_cfgs(setting)[0]
    return jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg,
                                                 group_tokens=group_tokens))


def _grouped(jp, tp, jcfg, tcfg, x, group_tokens):
    """Both packages' ``_group_dispatch`` over moe_forward's own groups."""
    b, t, d = x.shape
    g = max(b * t // group_tokens, 1)
    ng = b * t // g
    cap = jmoe.capacity(ng, jcfg)
    assert cap == tmoe.capacity(ng, tcfg)
    xg = x.reshape(g, ng, d)
    j = jax.jit(jax.vmap(lambda v: jmoe._group_dispatch(jp, v, jcfg, cap)))(
        jnp.asarray(xg))
    t_ = tmoe._group_dispatch(tp, torch.from_numpy(xg), tcfg, cap)
    return j, t_


@pytest.mark.parametrize("setting", sorted(MOE))
@pytest.mark.parametrize("n", [1, 5, 64, 512])
def test_capacity_matches_reference(setting, n):
    jcfg, tcfg = _moe_cfgs(setting)
    assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg)


@pytest.mark.parametrize("setting", sorted(MOE))
def test_group_dispatch_matches_reference(setting):
    """One group of 64 tokens: out, logits and keep."""
    jcfg, tcfg, jp, tp = _layer(setting)
    x = _x(1, 64)[0]
    cap = jmoe.capacity(64, jcfg)
    jo, jl, jk = jax.jit(lambda p, v: jmoe._group_dispatch(p, v, jcfg, cap))(
        jp, jnp.asarray(x))
    to, tl, tk = tmoe._group_dispatch(tp, torch.from_numpy(x), tcfg, cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    _close(tl, jl)
    _close_scaled(to, jo)
    assert (not np.asarray(jk).all()) == (setting == "drops")


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("setting", sorted(MOE))
def test_moe_forward_matches_reference(setting, groups):
    """2 x 64 tokens as one group or four groups of 32: out and aux
    within TOL, the keep masks of every group equal; with drops, both
    packages drop a share of the assignments."""
    jcfg, tcfg, jp, tp = _layer(setting)
    gt = GROUPS[groups]
    x = _x(2, 64)
    jo, jaux = _jit_moe_forward(setting, gt)(jp, jnp.asarray(x))
    to, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg,
                                group_tokens=gt)
    _close_scaled(to, jo)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], msg=k)
    (_, jl, jk), (_, tl, tk) = _grouped(jp, tp, jcfg, tcfg, x, gt)
    assert tk.shape[0] == (1 if gt == 512 else 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    _close(tl, jl)
    if setting == "drops":
        assert float(jaux["dropped_frac"]) > 0
        assert float(taux["dropped_frac"]) > 0
    else:
        assert float(jaux["dropped_frac"]) == 0 == float(taux["dropped_frac"])


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("setting", sorted(MOE))
def test_moe_gradients_match_jax_grad(setting, groups):
    """d/d(x, every moe leaf) of sum(out * r) + load_balance + router_z
    (``_close_scaled``)."""
    jcfg, tcfg, jp, tp = _layer(setting)
    gt = GROUPS[groups]
    x = _x(2, 64)
    r = _x(2, 64, seed=1)

    def jloss(p, xx):
        out, aux = jmoe.moe_forward(p, xx, jcfg, group_tokens=gt)
        return (out * r).sum() + aux["load_balance"] + aux["router_z"]
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))

    tleaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_forward(tleaves, tx, tcfg, group_tokens=gt)
    loss = (out * torch.from_numpy(r)).sum() + aux["load_balance"] \
        + aux["router_z"]
    loss.backward()
    assert set(tleaves) == set(jgp) == {"router", "w_gate", "w_up", "w_down"}
    _close_scaled(tx.grad, jgx, msg="x")
    for k, v in tleaves.items():
        assert np.abs(np.asarray(jgp[k])).max() > 0, k
        _close_scaled(v.grad, jgp[k], msg=k)


@pytest.mark.parametrize("b,t", [(36, 275), (5, 205)])
def test_uneven_groups_raise_where_the_reference_fails(b, t):
    """B·T not a multiple of g = B·T // 512: the reference's reshape
    fails, and the port raises a ValueError naming the shape."""
    jcfg, tcfg, jp, tp = _layer("no_drops")
    x = _x(b, t, d=D)
    with pytest.raises(TypeError):
        jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match=f"{b} x {t} = {b * t} tokens"):
        tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)


@pytest.mark.parametrize("b,t", [(36, 20), (4, 275), (36, 256)])
def test_even_groups_run_on_both(b, t):
    """The env's and the system's one group, 1100 tokens as 2 groups of
    550, the training shape's 18 groups of 512."""
    _, tcfg, jp, tp = _layer("drops")
    x = _x(b, t, d=D)
    jo, jaux = _jit_moe_forward("drops", 512)(jp, jnp.asarray(x))
    to, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    _close_scaled(to, jo)
    _close(taux["dropped_frac"], jaux["dropped_frac"])


# --------------------------------------------------------------------------
# The moe backbone: reduced granite-moe-1b-a400m (2 layers, d 64, 4 heads,
# GQA 4/2), as reduced() makes it and with capacity_factor 0.5, where both
# packages drop assignments.
# --------------------------------------------------------------------------

CAPACITY = {"no_drops": None, "drops": 0.5}


def _cfgs(capacity):
    def one(get, red):
        cfg = red(get(ARCH), layers=2, d_model=64)
        if CAPACITY[capacity] is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=CAPACITY[capacity]))
        return cfg
    return one(jget_config, jreduced), one(get_config, reduced)


@functools.lru_cache(maxsize=None)
def _model(capacity):
    """Policy weights drawn by the port's ``init_policy_params`` (whose
    tree, shapes and dtypes the bf16 test below holds to the reference's)
    and given to both packages."""
    jcfg, tcfg = _cfgs(capacity)
    tparams = tpolicy.init_policy_params(tcfg, 0, device="cpu")
    return jcfg, tcfg, _to_jax(tparams), tparams


def _obs(cfg, b=3, t_obs=12):
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg.vocab_size, (b, t_obs)).astype(np.int32),
            np.array([0, 5, 63][:b], np.int32))


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().float().numpy() for path, x in
            tree_leaves_with_path(tree)}


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_backbone_forward_matches_reference(capacity):
    """Hidden states, logits and the aux terms (summed over layers, the
    dropped share averaged), with and without remat."""
    jcfg, tcfg, jp, tp = _model(capacity)
    obs, _ = _obs(jcfg)
    jout = jax.jit(functools.partial(jtransformer.forward, jcfg))(
        jp, jnp.asarray(obs))
    for remat in (False, True):
        tout = ttransformer.forward(tcfg, tp, torch.from_numpy(obs),
                                    remat=remat)
        _close(tout["hidden"], jout["hidden"], atol=ATOL, rtol=ATOL)
        _close(tout["logits"], jout["logits"], atol=ATOL, rtol=ATOL)
        assert set(tout["aux"]) == set(jout["aux"])
        for k in jout["aux"]:
            _close(tout["aux"][k], jout["aux"][k], msg=k)
    dropped = float(jout["aux"]["dropped_frac"])
    assert (dropped > 0) == (capacity == "drops"), dropped


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_prefill_and_decode_match_reference(capacity):
    jcfg, tcfg, jp, tp = _model(capacity)
    obs, _ = _obs(jcfg)
    j_out, j_cache = jax.jit(functools.partial(
        jtransformer.prefill, jcfg, cache_len=16))(jp, jnp.asarray(obs))
    j_decode = jax.jit(functools.partial(jtransformer.decode, jcfg))
    t_out, t_cache = ttransformer.prefill(tcfg, tp, torch.from_numpy(obs),
                                          cache_len=16)
    _close(t_out["hidden"], j_out["hidden"], atol=ATOL, rtol=ATOL)
    _close(t_out["logits"], j_out["logits"], atol=ATOL, rtol=ATOL)
    for tok in ([1, 2, 3], [40, 0, 7]):
        tok = np.array(tok, np.int32)
        j_dec, j_cache = j_decode(jp, jnp.asarray(tok), j_cache)
        t_dec, t_cache = ttransformer.decode(tcfg, tp, torch.from_numpy(tok),
                                             t_cache)
        _close(t_dec["logits"], j_dec["logits"], atol=ATOL, rtol=ATOL)
        _close(t_cache.attn.k, j_cache.attn.k, atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(t_cache.attn.length,
                                      j_cache.attn.length)


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
def test_sample_action_sequence_matches_reference(capacity):
    jcfg, tcfg, jp, tp = _model(capacity)
    obs, step = _obs(jcfg)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, jcfg.action_dim)
    shape = (obs.shape[0], jcfg.action_vocab_size)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, shape))
                       for k in keys])
    j_tok, j_logp, j_val = jpolicy.make_inference_fn(jcfg)(
        jp, key, jnp.asarray(obs), jnp.asarray(step))
    t_tok, t_logp, t_val = tpolicy.sample_action_sequence(
        tcfg, tp, None, torch.from_numpy(obs), torch.from_numpy(step),
        gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    _close(t_logp, j_logp, atol=ATOL, rtol=ATOL)
    _close(t_val, j_val, atol=ATOL, rtol=ATOL)


RL_KW = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
             entropy_coef=0.01)


def _batch_args(cfg):
    return (4, 3, 6, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
            cfg.num_prefix_tokens)


def test_train_step_matches_reference():
    """One train step (grad_accum 2) where both packages drop assignments:
    the loss (with the aux terms) and every metric (``moe_load_balance``
    and ``moe_dropped_frac`` among them) within METRIC_TOL; the AdamW
    moments, which carry the accumulated gradient, per leaf within
    test_torch_train's gradient bar, every moe leaf's nonzero."""
    jcfg, tcfg, jp, tparams = _model("drops")
    jrl, trl = JRLConfig(**RL_KW), RLConfig(**RL_KW)
    jstate = jts.TrainState(jp, jadamw.init(jp), jadvnorm.init_adv_state(),
                            jnp.zeros((), jnp.int32))
    tparams = tree_map(torch.clone, tparams)
    tstate = tts.TrainState(tparams, adamw.init(tparams),
                            advnorm.init_adv_state(device="cpu"),
                            torch.zeros((), dtype=torch.int32))
    jbatch = jdummy_batch(*_batch_args(jcfg))
    js, jm = jts.make_train_step(jcfg, jrl, donate=False)(jstate, jbatch)
    ts, tm = tts.make_train_step(tcfg, trl, device="cpu")(
        tstate, dummy_batch(*_batch_args(tcfg)))
    assert {"moe_load_balance", "moe_dropped_frac"} <= set(jm)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert float(jm["moe_dropped_frac"]) > 0
    # the first moments are (1 - b1) x the clipped mean of the two
    # micro-batches' grads: held per leaf as test_torch_train holds grads
    for t_tree, j_tree in ((ts.opt.mu, js.opt.mu), (ts.opt.nu, js.opt.nu)):
        got, exp = _tflat(t_tree), _jflat(j_tree)
        assert got.keys() == exp.keys()
        for path, e in exp.items():
            scale = float(np.abs(e).max())
            diff = float(np.abs(got[path] - e).max())
            assert diff <= 1e-5 + 1e-4 * scale, (path, diff, scale)
            assert scale > 0 or "moe" not in path, path


def test_bf16_tree_keeps_the_router_f32_through_bridge_and_adamw():
    """A bf16 moe tree from the reference: the router arrives f32 among
    bf16 leaves and round-trips bit for bit; the port's own init draws the
    same tree, shapes and dtypes; an AdamW update keeps every dtype."""
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH), layers=2,
                                        d_model=64), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(get_config(ARCH), layers=2,
                                       d_model=64), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jpolicy.init_policy_params, jcfg))(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, device="cpu")
    moe = tparams["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (2, 64, 4)
    assert moe["w_gate"].dtype == torch.bfloat16
    assert moe["w_down"].shape == (2, 4, 64, 64)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(params_to_numpy(tparams))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))

    own = tpolicy.init_policy_params(tcfg, 0, device="cpu")
    shapes = {p: (tuple(v.shape), str(v.dtype)[6:])
              for p, v in tree_leaves_with_path(own)}
    assert shapes == {p: (v.shape, str(v.dtype))
                      for p, v in _jflat(tree).items()}

    dtypes = {p: v.dtype for p, v in tree_leaves_with_path(tparams)}
    grads = params_from_numpy(jax.tree.map(
        lambda a: np.ones(a.shape, np.float32), tree), device="cpu")
    state = adamw.init(tparams)
    before = moe["router"].clone()
    adamw.update(grads, state, tparams, 1e-3)
    assert {p: v.dtype for p, v in tree_leaves_with_path(tparams)} == dtypes
    assert not torch.equal(moe["router"], before)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_full_configs_group_their_card_shapes(arch):
    """The token counts that the card runs at full width split evenly
    into groups: training 36 x 256 (18 groups of 512), the env's 36 x 19
    and the system's 36 x 20 (one group), serving {1, 2, 4, 8} x 12 or
    x 256 and decode batches."""
    cfg = get_config(arch)
    assert cfg.arch_type == "moe"
    for b, t in [(36, 256), (36, 19), (36, 20)] + [
            (b, t) for b in (1, 2, 4, 8) for t in (1, 12, 256)]:
        n = b * t
        g = max(n // tmoe.GROUP_TOKENS, 1)
        assert n % g == 0, (b, t)
    assert tmoe.GROUP_TOKENS == jmoe.GROUP_TOKENS


def test_moe_init_draws_at_the_reference_scale():
    """The port's draw has each leaf's scale as the reference's: fan-in
    ``shape[0]``, so the experts' [E, d, ff] and [E, ff, d] weights at std
    ~1/sqrt(E) (ROADMAP C6), the router at ~1/sqrt(d)."""
    jcfg, tcfg = _moe_cfgs("drops")
    d = 256
    jp = jax.jit(lambda k: jmoe.moe_init(k, d, jcfg, jnp.float32))(
        jax.random.PRNGKey(1))
    tp = tmoe.moe_init(torch.Generator().manual_seed(1), d, tcfg,
                       torch.float32, "cpu")
    for k, v in tp.items():
        ref = float(np.asarray(jp[k]).std())
        got = float(v.std())
        assert abs(got - ref) <= 0.03 * ref, (k, got, ref)
        fan_in = v.shape[0]
        # a truncated normal at +-2 sigma has std 0.88 sigma
        assert abs(got - 0.88 / fan_in ** 0.5) <= 0.03 * got, (k, got)
