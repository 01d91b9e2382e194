"""The ssm slice of the port (mamba2) against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's. Where
the JAX side reaches its Pallas SSD kernels (K6 ``ssd_scan``, K7
``ssd_scan_bwd``), they run in interpret mode (``dispatch.forced("pallas")``
or ``interpret=True``); the port's CPU route is the kernels' plain
versions. Tolerances are the reference's own:
  * the SSD scan, f32: rtol/atol 2e-4 (``tests/test_kernels.py``); bf16
    inputs 5e-2;
  * the SSD backward: rtol 2e-4, atol 2e-3 (``test_dispatch.py``'s
    ``test_ssd_backward_kernel_grad_parity``);
  * ``ssm_forward``: rtol/atol 5e-4; the backbone, prefill, decode and the
    sampler (f32, two layers): rtol/atol 1e-4, tokens identical;
  * one train step: loss and metrics rtol 1e-4 / atol 1e-5, each
    micro-batch's grads 1e-5 + 1e-4 * max|g| per leaf (as
    ``test_torch_train.py``).
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
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_bwd as j_ssd_scan_bwd
from repro.models import policy as jpolicy
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.bridge import batch_from_numpy, params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core import advnorm
from repro_torch.data.trajectory import dummy_batch
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import (plain_ssd_scan,
                                          plain_ssd_scan_bwd, ssd_scan,
                                          ssd_scan_bwd)
from repro_torch.models import policy as tpolicy
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path

jts = importlib.import_module("repro.core.train_step")
tts = importlib.import_module("repro_torch.core.train_step")

ARCH = "mamba2-2.7b"


def _ssd_data(b, t, h, p, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, p)).astype(dtype),
            rng.uniform(0.01, 0.1, (b, t, h)).astype(np.float32),
            -rng.uniform(0.5, 1.5, (h,)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(dtype),
            rng.standard_normal((b, t, n)).astype(dtype))


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, exp, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# K6 / K7: the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 128, 1, 64, 128, 64),     # mamba2-2.7b-like head
    (2, 256, 4, 32, 16, 128),
])
def test_plain_ssd_scan_matches_pallas_and_the_oracle(b, t, h, p, n, chunk):
    data = _ssd_data(b, t, h, p, n, seed=t + p)
    jy, js = j_ssd_scan(*map(jnp.asarray, data), chunk=chunk, interpret=True)
    ty, ts = ssd_scan(*_t(data), chunk=chunk)          # CPU: plain version
    oy, os_ = ref.reference_ssd(*_t(data))
    for got, exp in ((ty, jy), (ts, js), (oy, jy), (os_, js)):
        assert got.dtype == torch.float32
        _close(got, exp, 2e-4, 2e-4)
    ry, rs = jref.reference_ssd(*map(jnp.asarray, data))
    _close(oy, ry, 2e-4, 2e-4)
    _close(os_, rs, 2e-4, 2e-4)


def test_plain_ssd_scan_bf16_inputs():
    import ml_dtypes
    data = list(_ssd_data(1, 64, 2, 16, 8, seed=3))
    for i in (0, 3, 4):
        data[i] = data[i].astype(ml_dtypes.bfloat16)
    jy, js = j_ssd_scan(*map(jnp.asarray, data), chunk=32, interpret=True)
    tdata = [torch.from_numpy(d.astype(np.float32)).to(torch.bfloat16)
             if d.dtype.name == "bfloat16" else torch.from_numpy(d)
             for d in data]
    ty, ts = plain_ssd_scan(*tdata, 32)
    oy, _ = ref.reference_ssd(*tdata)
    _close(ty, jy, 5e-2, 5e-2)
    _close(ts, js, 5e-2, 5e-2)
    _close(ty, oy, 5e-2, 5e-2)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(2, 128, 3, 16, 8, 32),
                                             (1, 128, 2, 64, 128, 64)])
def test_entering_states_match_the_reference(b, t, h, p, n, chunk):
    data = _ssd_data(b, t, h, p, n, seed=11)
    _, _, j_enter = j_ssd_scan(*map(jnp.asarray, data), chunk=chunk,
                               interpret=True, return_states=True)
    _, _, t_enter = ssd_scan(*_t(data), chunk=chunk, return_states=True)
    assert t_enter.shape == (b, t // chunk, h, p, n)
    _close(t_enter, j_enter, 2e-4, 2e-4)
    np.testing.assert_array_equal(t_enter[:, 0].numpy(), 0.0)


@pytest.mark.parametrize("p", [64, 128])
def test_plain_ssd_backward_matches_pallas(p):
    """K7's plain version against the reverse-chunk Pallas kernel, with a
    nonzero final-state cotangent seeding the sweep."""
    b, t, h, n, chunk = 1, 64, 2, 4, 32
    data = _ssd_data(b, t, h, p, n, seed=9)
    rng = np.random.default_rng(10)
    dy = rng.standard_normal((b, t, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jx = list(map(jnp.asarray, data))
    _, _, j_enter = j_ssd_scan(*jx, chunk=chunk, interpret=True,
                               return_states=True)
    jg = j_ssd_scan_bwd(*jx, j_enter, jnp.asarray(dy), jnp.asarray(ds),
                        chunk=chunk, interpret=True)
    tx = _t(data)
    _, _, t_enter = plain_ssd_scan(*tx, chunk, return_states=True)
    tg = ssd_scan_bwd(*tx, t_enter, torch.from_numpy(dy),
                      torch.from_numpy(ds), chunk=chunk)   # CPU: plain
    pg = plain_ssd_scan_bwd(*tx, t_enter, torch.from_numpy(dy),
                            torch.from_numpy(ds), chunk)
    for name, got, same, exp in zip(("dx", "ddt", "dA", "dB", "dC"), tg, pg,
                                    jg):
        assert got.shape == exp.shape and got.dtype == torch.float32, name
        _close(got, exp, 2e-4, 2e-3, name)
        np.testing.assert_array_equal(got.numpy(), same.numpy())


def _bf16_ssd_data(b, t, h, p, n, seed):
    """``_ssd_data`` with x, B and C rounded to bf16: numpy arrays for the
    JAX side, and the same values as torch tensors (bf16 x, B, C)."""
    import ml_dtypes
    data = list(_ssd_data(b, t, h, p, n, seed))
    for i in (0, 3, 4):
        data[i] = data[i].astype(ml_dtypes.bfloat16)
    tdata = [torch.from_numpy(d.astype(np.float32)).to(torch.bfloat16)
             if i in (0, 3, 4) else torch.from_numpy(d)
             for i, d in enumerate(data)]
    return data, tdata


def _rel_err(got, exp):
    """Max abs error as a fraction of the largest value of ``exp``."""
    exp = np.asarray(exp, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - exp).max()
                 / max(np.abs(exp).max(), 1e-30))


# K6's tensor-core body splits W, S and x o din (f32) into bf16 terms. Its
# CPU oracle with three terms agrees with the Pallas kernel (f32 inside) to
# 2.5e-7 - 4.4e-7 of the largest value at these shapes, as the plain chunked
# form does (f32 reordering): held at 2e-6, ~5x. With two terms the error
# is 2.3e-6 - 4.1e-6, past that bar: why the body takes three.
TILED_SSD_TOL = 2e-6


@pytest.mark.parametrize("chunk,n,terms", [
    (32, 64, 3), (64, 128, 3), (128, 64, 3),
    (128, 128, 3),                 # mamba2-2.7b's SSD head and chunk
    (128, 128, 2), (32, 64, 2),    # two terms: past the bar
])
def test_tiled_ssd_oracle_matches_pallas(chunk, n, terms):
    """``ref.tiled_ssd_scan``, K6's tensor-core body's order of arithmetic,
    against the Pallas ``ssd_scan`` in interpret mode on bf16 inputs (two
    chunks, P 64): y, the final state and every entering state."""
    data, tdata = _bf16_ssd_data(1, 2 * chunk, 2, 64, n, seed=chunk + n)
    exp = j_ssd_scan(*map(jnp.asarray, data), chunk=chunk, interpret=True,
                     return_states=True)
    got = ref.tiled_ssd_scan(*tdata, chunk, terms=terms, return_states=True)
    errs = [_rel_err(g, e) for g, e in zip(got, exp)]
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32 and g.shape == e.shape
    if terms == 3:
        assert max(errs) <= TILED_SSD_TOL, errs
    else:
        three = ref.tiled_ssd_scan(*tdata, chunk, return_states=True)
        errs3 = [_rel_err(g, e) for g, e in zip(three, exp)]
        assert max(errs) > TILED_SSD_TOL, errs
        assert max(errs) > 4 * max(errs3), (errs, errs3)


@pytest.mark.parametrize("t", [300, 19, 12])
def test_tiled_ssd_oracle_takes_a_short_last_chunk(t):
    """The oracle on the kernels' chunk for T no multiple of 128 (a short
    last chunk of zero steps; T 19 and 12, the env's, as one chunk of 32)
    against the plain version, which the tests above hold against
    Pallas."""
    _, tdata = _bf16_ssd_data(2, t, 2, 64, 128, seed=t)
    got = ref.tiled_ssd_scan(*tdata, 128, return_states=True)
    exp = plain_ssd_scan(*tdata, 128, return_states=True)
    assert got[2].shape[1] == -(-t // 128)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        assert _rel_err(g, e) <= TILED_SSD_TOL


@pytest.mark.parametrize("mode", ["pallas", "jnp"])
def test_dispatch_ssd_grads_match_the_reference(mode):
    """The port's routed scan (plain on the CPU, through autograd) against
    the JAX dispatch on either of its routes, forward and backward through
    both outputs."""
    data = _ssd_data(2, 64, 3, 8, 4, seed=5)

    def jloss(x_, dt_, a_, b_, c_):
        with jdispatch.forced(mode):
            y_, s_ = jdispatch.ssd_scan(x_, dt_, a_, b_, c_, chunk=32)
        return jnp.sum(y_ * y_) + jnp.sum(jnp.sin(s_))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, data))
    tx = [v.requires_grad_() for v in _t(data)]
    y, s = dispatch.ssd_scan(*tx, chunk=32)
    (torch.sum(y * y) + torch.sum(torch.sin(s))).backward()
    for name, v, exp in zip(("x", "dt", "A", "B", "C"), tx, jg):
        _close(v.grad, exp, 2e-4, 2e-3, name)


def test_ragged_length_runs_the_plain_form_on_both_sides():
    """T = 24 is no multiple of the chunk (32). The reference's eligibility
    rule sends it to its plain chunked form (chunk min(32, T)) even with
    the Pallas kernels forced; on the CPU the port's wrappers run the same
    plain form, and nothing counts as a launch (on the card it goes to K6,
    ``test_torch_cuda.py``)."""
    data = _ssd_data(2, 24, 3, 8, 4, seed=5)
    with jdispatch.forced("pallas"):
        jy, js = jdispatch.ssd_scan(*map(jnp.asarray, data), chunk=32)
    from repro_torch.kernels.ssd_scan import ssd_scan as kernel_scan
    n0 = kernel_scan.launches
    ty, ts = dispatch.ssd_scan(*_t(data), chunk=32)
    assert kernel_scan.launches == n0
    oy, os_ = ref.reference_ssd(*_t(data))
    for got, exp in ((ty, jy), (ts, js), (ty, oy), (ts, os_)):
        _close(got, exp, 2e-4, 2e-4)


@pytest.mark.parametrize("t,chunk", [(40, 32), (19, 128), (12, 128),
                                     (200, 128)])
def test_short_last_chunk_pads_with_zero_steps(t, chunk):
    """A last chunk shorter than the chunk (what the kernels take on the
    card) padded with zero steps: y, the final state and the entering
    states equal the stepwise oracle's, and the grads the reference's."""
    data = _ssd_data(2, t, 3, 16, 8, seed=t)
    tx = [v.requires_grad_() for v in _t(data)]
    y, s, enter = plain_ssd_scan(*tx, chunk, return_states=True)
    oy, os_ = ref.reference_ssd(*_t(data))
    _close(y.detach(), oy, 2e-4, 2e-4, "y")
    _close(s.detach(), os_, 2e-4, 2e-4, "s")
    enter = enter.detach()
    q, tt = min(chunk, t), _t(data)
    assert enter.shape[1] == -(-t // q) and not enter[:, 0].any()
    for c in range(1, enter.shape[1]):     # the state after c chunks
        head = [v[:, :c * q] for v in tt[:2]] + [tt[2]] \
            + [v[:, :c * q] for v in tt[3:]]
        _close(enter[:, c], ref.reference_ssd(*head)[1], 2e-4, 2e-4,
               f"enter {c}")

    def loss(y, s):
        return (y * y).sum() + torch.sin(s).sum()
    loss(y, s).backward()

    def jloss(*a):
        jy, js = jssm.ssd_chunked(*a, chunk=t)     # one chunk: no padding
        return jnp.sum(jy * jy) + jnp.sum(jnp.sin(js))
    jg = jax.grad(jloss, argnums=range(5))(*map(jnp.asarray, data))
    for name, v, exp in zip(("x", "dt", "A", "B", "C"), tx, jg):
        _close(v.grad, exp, 2e-4, 2e-3, name)


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

def _ssm_block(fused: bool):
    jcfg = jreduced(jget_config(ARCH), layers=2, d_model=64)
    jcfg = dataclasses.replace(
        jcfg, ssm=dataclasses.replace(jcfg.ssm, fused_in_proj=fused))
    jp = jssm.ssm_init(jax.random.PRNGKey(1), jcfg.d_model, jcfg.ssm,
                       jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tp


@pytest.mark.parametrize("fused", [True, False])
def test_ssm_forward_matches_reference(fused):
    cfg, jp, tp = _ssm_block(fused)
    u = np.random.default_rng(2).standard_normal((2, 64, 64)) \
        .astype(np.float32)
    with jdispatch.forced("pallas"):
        jout, jst = jssm.ssm_forward(jp, jnp.asarray(u), cfg.d_model,
                                     cfg.ssm, return_state=True)
    tout, tst = tssm.ssm_forward(tp, torch.from_numpy(u), cfg.d_model,
                                 cfg.ssm, return_state=True)
    _close(tout, jout, 5e-4, 5e-4)
    _close(tst.ssm, jst.ssm, 5e-4, 5e-4)
    _close(tst.conv, jst.conv, 5e-4, 5e-4)
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
    # carried-state prefill (the plain chunked form on both sides)
    u2 = np.random.default_rng(3).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    jout2, jst2 = jssm.ssm_forward(jp, jnp.asarray(u2), cfg.d_model, cfg.ssm,
                                   init_state=jst, return_state=True)
    tout2, tst2 = tssm.ssm_forward(tp, torch.from_numpy(u2), cfg.d_model,
                                   cfg.ssm, init_state=tst,
                                   return_state=True)
    _close(tout2, jout2, 5e-4, 5e-4)
    _close(tst2.ssm, jst2.ssm, 5e-4, 5e-4)


def test_ssm_prefill_then_decode_equals_forward():
    """The SSD duality inside the port: a chunked prefill of T tokens
    followed by recurrent decodes gives the outputs and state of one
    full-sequence pass."""
    cfg, _, tp = _ssm_block(True)
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 96, 64)).astype(np.float32))
    full, st_full = tssm.ssm_forward(tp, u, cfg.d_model, cfg.ssm,
                                     return_state=True)
    out, st = tssm.ssm_forward(tp, u[:, :64], cfg.d_model, cfg.ssm,
                               return_state=True)
    outs = [out]
    for i in range(64, 96):
        o, st = tssm.ssm_decode(tp, u[:, i:i + 1], st, cfg.d_model, cfg.ssm)
        outs.append(o)
    _close(torch.cat(outs, 1), full, 1e-4, 1e-4)
    _close(st.ssm, st_full.ssm, 1e-4, 1e-4)
    # the conv tail is the in-projection of the last tokens: f32 matmuls
    # over 64 and 96 rows may round it differently
    _close(st.conv, st_full.conv, 1e-5, 1e-5)
    assert st.length.tolist() == [96, 96]


# ---------------------------------------------------------------------------
# The backbone, the sampler and one train step on reduced mamba2-2.7b
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jreduced(jget_config(ARCH), layers=2, d_model=64)
    tcfg = reduced(get_config(ARCH), layers=2, d_model=64)
    jparams = jpolicy.init_policy_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _obs(cfg, b=3, t_obs=64):
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg.vocab_size, (b, t_obs)).astype(np.int32),
            np.array([0, 5, 63][:b], np.int32))


def test_backbone_forward_matches_reference():
    jcfg, tcfg, jp, tp = _model()
    assert tcfg.num_prefix_tokens == 0 and tcfg.ssm.chunk == 32
    obs, _ = _obs(jcfg)
    with jdispatch.forced("pallas"):
        jout = jtransformer.forward(jcfg, jp, jnp.asarray(obs))
    tout = ttransformer.forward(tcfg, tp, torch.from_numpy(obs))
    _close(tout["hidden"], jout["hidden"], 1e-4, 1e-4)
    _close(tout["logits"], jout["logits"], 1e-4, 1e-4)


def test_prefill_and_decode_match_reference():
    jcfg, tcfg, jp, tp = _model()
    obs, _ = _obs(jcfg)
    with jdispatch.forced("pallas"):
        j_out, j_cache = jtransformer.prefill(jcfg, jp, jnp.asarray(obs),
                                              cache_len=71)
    t_out, t_cache = ttransformer.prefill(tcfg, tp, torch.from_numpy(obs),
                                          cache_len=71)
    assert t_cache.attn is None
    _close(t_out["logits"], j_out["logits"], 1e-4, 1e-4)
    _close(t_cache.ssm.ssm, j_cache.ssm.ssm, 1e-4, 1e-4)
    for tok in ([1, 2, 3], [40, 0, 7]):
        tok = np.array(tok, np.int32)
        j_dec, j_cache = jtransformer.decode(jcfg, jp, jnp.asarray(tok),
                                             j_cache)
        t_dec, t_cache = ttransformer.decode(tcfg, tp, torch.from_numpy(tok),
                                             t_cache)
        _close(t_dec["logits"], j_dec["logits"], 1e-4, 1e-4)
        _close(t_cache.ssm.ssm, j_cache.ssm.ssm, 1e-4, 1e-4)
        _close(t_cache.ssm.conv, j_cache.ssm.conv, 1e-4, 1e-4)
        np.testing.assert_array_equal(t_cache.ssm.length,
                                      j_cache.ssm.length)


def test_init_decode_cache_is_the_reference_state():
    jcfg, tcfg, _, _ = _model()
    j = jtransformer.init_decode_cache(jcfg, 3, 10)
    t = ttransformer.init_decode_cache(tcfg, 3, 10, device="cpu")
    assert t.attn is None
    for name in ("conv", "ssm", "length"):
        a, b = getattr(t.ssm, name), np.asarray(getattr(j.ssm, name))
        assert tuple(a.shape) == b.shape and not a.any(), name
        assert str(a.dtype)[6:] == str(b.dtype), name


def test_sample_action_sequence_matches_reference():
    jcfg, tcfg, jp, tp = _model()
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
    _close(t_logp, j_logp, 1e-4, 1e-4)
    _close(t_val, j_val, 1e-4, 1e-4)


def test_init_params_draws_the_reference_tree():
    """The port's own random init has the reference's tree, shapes and
    dtypes (f32 A_log / D / dt_bias in a bf16 model) and its init rules."""
    jcfg = jget_config(ARCH)
    jcfg = dataclasses.replace(jreduced(jcfg, layers=3, d_model=64),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(get_config(ARCH), layers=3,
                                       d_model=64), param_dtype="bfloat16")
    jshapes = {tuple(getattr(k, "key", None) for k in path):
               (tuple(v.shape), str(v.dtype))
               for path, v in jax.tree_util.tree_leaves_with_path(
                   jpolicy.init_policy_params(jcfg, jax.random.PRNGKey(0)))}
    tp = tpolicy.init_policy_params(tcfg, 0, device="cpu")
    tshapes = {path: (tuple(v.shape), str(v.dtype)[6:])
               for path, v in tree_leaves_with_path(tp)}
    assert tshapes == jshapes
    ssm = tp["layers"]["ssm"]
    assert not ssm["A_log"].any() and bool((ssm["D"] == 1).all())
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())
    assert not torch.equal(ssm["in_proj"][0], ssm["in_proj"][1])


def _batch_args(cfg):
    # 57 observation + 7 action tokens: T = 64, two chunks of 32
    return (4, 3, 57, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
            cfg.num_prefix_tokens)


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().numpy() for path, x in
            tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _step():
    kw = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
              entropy_coef=0.01)
    jcfg, tcfg, _, _ = _model()
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
                                        tstate.adv_norm, cfg=tcfg, rl=trl)
            tgrads.append(_tflat(g))
        _, jm = jts.train_step(jstate, jbatch, cfg=jcfg, rl=jrl)
    _, tm = tts.make_train_step(tcfg, trl, device="cpu")(
        tstate, dummy_batch(*_batch_args(tcfg)))
    return jm, tm, jgrads, tgrads


def test_train_step_loss_and_metrics_match():
    jm, tm, _, _ = _step()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_microbatch_grads_match():
    _, _, jgrads, tgrads = _step()
    for got, exp in zip(tgrads, jgrads):
        assert got.keys() == exp.keys()
        assert ("layers", "ssm", "A_log") in got
        for path, e in exp.items():
            scale = float(np.abs(e).max())
            diff = float(np.abs(got[path] - e).max())
            assert diff <= 1e-5 + 1e-4 * scale, (path, diff, scale)
