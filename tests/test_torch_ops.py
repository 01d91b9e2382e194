"""The kernel-ops entry point of the port (``repro_torch.kernels.ops``) and
the logits-level GIPO loss K5 against the JAX package, on the CPU.

The same numpy inputs go through both packages. The JAX side runs its
Pallas kernels in interpret mode (``interpret=True``, or its ``ops``,
which choose interpret mode off a TPU); the port's CPU route is each
kernel's plain version, and nothing launches. Tolerances are
``tests/test_dispatch.py``'s: loss, metrics and ``d_logits`` rtol 2e-4 /
atol 2e-5 in f32; attention and the SSD scan rtol/atol 2e-4. bf16 logits
(both sides f32 inside, from the same bf16 input): loss and metrics rtol
1e-4 / atol 1e-5, ``d_logits`` (rounded to bf16 on both sides from f32
values that agree to ~1e-7; up to 0.033 here) atol 1e-4. The GIPO data
puts logp_old within 0.1 of the logits' own log-prob, so that ω is near 1
and the surrogate's gradient shows; one case keeps it far off (ω near 0).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gipo_loss import gipo_head_loss as j_gipo_head_loss
import repro_torch.kernels as tkernels
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels import gipo_loss as gl
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

SIGMA = 0.2
TOL = dict(rtol=2e-4, atol=2e-5)
# test_dispatch.py's logits-level shapes: exact, ragged, ragged by one, V 256
SHAPES = [(64, 32), (300, 64), (257, 48), (100, 256)]
WRAPPERS = (flash_attention, flash_attention_bwd, decode_attention,
            gl.policy_loss_fwd, gl.policy_loss_bwd, gl.gipo_head_fwd,
            gl.gipo_head_bwd, ssd_scan, ssd_scan_bwd)


def _close(got, exp, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(exp, np.float32), **(kw or TOL))


def _own_logp(logits, targets):
    """Each row's log-softmax at its (in-range) target, in float64."""
    z = logits.astype(np.float64)
    z = z - z.max(-1, keepdims=True)
    lse = np.log(np.exp(z).sum(-1))
    return z[np.arange(len(targets)), targets] - lse


def _tok_data(n, v, seed, stale=False):
    """Logits, targets, logp_old, advantages, mask. logp_old lies within
    0.1 of the logits' own log-prob of the target (|log ρ| / σ about 0.5:
    ω near 1, so the surrogate carries weight); ``stale``: 0 ± 0.3, far
    above it (ω near 0, the k3-KL large)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, v)).astype(np.float32) * 2
    targets = rng.integers(0, v, n).astype(np.int32)
    noise = rng.standard_normal(n)
    logp_old = (noise * 0.3 if stale
                else _own_logp(logits, targets) + 0.1 * noise)
    return (logits, targets, logp_old.astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (rng.random(n) > 0.15).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _combine(pg, ent, kl):
    return pg + 0.1 * kl - 0.01 * ent


def _jax_head(data, block_n=128, loss=_combine):
    """The reference's Pallas K5 (interpret mode): loss, entropy, kl,
    metrics and d_logits of ``loss``."""
    logits, *rest = map(jnp.asarray, data)

    def f(lg):
        pg, ent, kl, m = j_gipo_head_loss(lg, *rest, SIGMA, block_n, True)
        return loss(pg, ent, kl), (pg, ent, kl, m)
    (_, out), grad = jax.value_and_grad(f, has_aux=True)(logits)
    return out, grad


def _torch_head(fn, data, dtype=torch.float32, loss=_combine):
    logits, *rest = _t(data)
    logits = logits.to(dtype).requires_grad_()
    pg, ent, kl, m = fn(logits, *rest, SIGMA)
    loss(pg, ent, kl).backward()
    return (pg, ent, kl, m), logits.grad


def _same_loss(got, exp, **kw):
    for g, e in zip(got[:3], exp[:3]):
        _close(g.detach(), e, **kw)
    assert set(got[3]) == set(exp[3]) == {"ratio_mean", "omega_mean",
                                          "stale_frac"}
    for k in exp[3]:
        _close(got[3][k], exp[3][k], **kw)


@pytest.mark.parametrize("n,v", SHAPES)
@pytest.mark.parametrize("route", ["kernel wrappers", "plain autodiff"])
def test_gipo_head_loss_matches_pallas(n, v, route):
    """K5's plain forward and analytic backward (the CPU route of the
    wrappers behind ``gipo_head_loss``) and the autodiffed plain route
    against the Pallas kernels in interpret mode, values and d_logits."""
    data = _tok_data(n, v, seed=n + v)
    (exp, exp_grad) = _jax_head(data)
    assert float(exp[3]["omega_mean"]) > 0.5
    fn = (gl.gipo_head_loss if route == "kernel wrappers"
          else gl.plain_gipo_head_loss)
    got, grad = _torch_head(fn, data)
    _same_loss(got, exp)
    assert grad.dtype == torch.float32
    _close(grad, exp_grad)


TERMS = {"pg": lambda pg, ent, kl: pg, "entropy": lambda pg, ent, kl: ent,
         "kl": lambda pg, ent, kl: kl}


@pytest.mark.parametrize("term", sorted(TERMS))
@pytest.mark.parametrize("route", ["kernel wrappers", "plain autodiff"])
def test_gipo_head_loss_each_term_matches_pallas(term, route):
    """d_logits of each loss term alone, so that none hides under
    another."""
    data = _tok_data(300, 64, seed=11)
    _, exp_grad = _jax_head(data, loss=TERMS[term])
    fn = (gl.gipo_head_loss if route == "kernel wrappers"
          else gl.plain_gipo_head_loss)
    _, grad = _torch_head(fn, data, loss=TERMS[term])
    assert np.abs(np.asarray(exp_grad)).max() > 0
    _close(grad, exp_grad)


def test_gipo_head_loss_matches_pallas_on_stale_logp():
    """logp_old far from the logits' log-probs (ω near 0)."""
    data = _tok_data(257, 48, seed=12, stale=True)
    (exp, exp_grad) = _jax_head(data)
    got, grad = _torch_head(gl.gipo_head_loss, data)
    _same_loss(got, exp)
    _close(grad, exp_grad)


@pytest.mark.parametrize("n,v", SHAPES)
def test_gipo_loss_fused_matches_the_unfused_reference(n, v):
    """``gipo_loss_fused`` (both packages) against the unfused oracle,
    ``ref.reference_gipo_loss`` (both packages)."""
    data = _tok_data(n, v, seed=3 * n + v)
    tl, tm = gl.gipo_loss_fused(*_t(data), SIGMA)
    jl, jm = jops.gipo_loss_op(*map(jnp.asarray, data), sigma=SIGMA,
                               block_n=128)
    rl, rm = ref.reference_gipo_loss(*_t(data), SIGMA)
    jrl, jrm = jref.reference_gipo_loss(*map(jnp.asarray, data), SIGMA)
    assert set(tm) == set(jm) == {"ratio_mean", "omega_mean", "stale_frac",
                                  "entropy", "kl"}
    for got, exp in ((tl, jl), (rl, jrl), (tl, rl)):
        _close(got, exp)
    for k in jm:
        _close(tm[k], jm[k])
    for k in jrm:
        _close(rm[k], jrm[k])
        _close(tm[k], rm[k])


def test_gipo_head_loss_bf16_logits():
    """bf16 logits: both packages f32 inside from the same bf16 values;
    d_logits comes back in bf16."""
    data = list(_tok_data(96, 64, seed=5))
    data[0] = data[0].astype(ml_dtypes.bfloat16)
    (exp, exp_grad) = _jax_head(data, block_n=32)
    data[0] = data[0].astype(np.float32)          # exact: bf16 values
    got, grad = _torch_head(gl.gipo_head_loss, data, torch.bfloat16)
    _same_loss(got, exp, rtol=1e-4, atol=1e-5)
    assert grad.dtype == torch.bfloat16 and exp_grad.dtype == jnp.bfloat16
    _close(grad.float(), np.asarray(exp_grad, np.float32), rtol=0,
           atol=1e-4)


def test_out_of_range_targets_match_the_reference_one_hot():
    """A target outside [0, V) matches no logit in the reference's one-hot:
    its log-prob is -lse (the target's shifted logit counts as 0), and its
    row's d_logits has no +1. The kernel takes the same semantics."""
    data = list(_tok_data(40, 48, seed=9))
    data[1][[3, 17, 30]] = [48, -1, 1000]
    (exp, exp_grad) = _jax_head(data, block_n=8)
    got, grad = _torch_head(gl.gipo_head_loss, data)
    _same_loss(got, exp)
    _close(grad, exp_grad)


def test_masked_rows_get_zero_gradient():
    data = list(_tok_data(33, 40, seed=2))
    data[4][:] = 0.0
    data[4][[1, 7]] = 1.0
    _, grad = _torch_head(gl.gipo_head_loss, data)
    keep = np.zeros(33, bool)
    keep[[1, 7]] = True
    assert not grad[torch.from_numpy(~keep)].any()
    assert grad[torch.from_numpy(keep)].abs().sum() > 0


# K5's register body in its order of arithmetic (ref.tiled_gipo_head_loss)
# at the layouts (lanes a row, rows a block: a warp's) that
# csrc/gipo_loss.cu::head_plan picks for f32 at these shapes (32 lanes, one
# row a warp, so that the grid covers the SMs), and at the layouts it picks
# at large N (f32: 4 lanes for V <= 128 from N 4224, 8 for V <= 256 from N
# 2112, 16 for V <= 512 from N 1056); offset 1: the logits one element past
# a 16-byte boundary, so that every row starts with a scalar head
TILED_HEAD_CASES = [
    (257, 48, 32, 1, 0, False), (257, 48, 32, 1, 0, True),
    (300, 64, 32, 1, 0, False), (300, 64, 16, 2, 0, True),
    (100, 256, 32, 1, 0, False), (224, 256, 32, 1, 0, False),
    (224, 256, 8, 4, 0, True), (77, 37, 32, 1, 0, False),
    (77, 37, 4, 8, 1, True),
]


@pytest.mark.parametrize("n,v,lanes,block_rows,offset,stale",
                         TILED_HEAD_CASES)
def test_tiled_gipo_head_oracle_matches_pallas(n, v, lanes, block_rows,
                                               offset, stale):
    """``ref.tiled_gipo_head_loss`` (K5's register body: per-lane sums,
    their butterfly, the CTA's rows in order, one reciprocal a row) against
    the Pallas ``gipo_head_loss`` in interpret mode, with a target outside
    V and masked rows, on live and stale logp_old: the loss terms and
    metrics within 2e-6 relative (floored at 1), d_logits within 2e-6 of
    its largest value (f32 sums in another order, exponentials within an
    ulp)."""
    _check_tiled_head(n, v, lanes, block_rows, offset, stale,
                      torch.float32)


# bf16 logits (8 elements a 16-byte vector) at the layouts head_plan picks
# for them: 4 lanes a row for V <= 256 from N 4224, where a row's head and
# tail (up to 7 elements each) take two elements a lane, and 8 lanes
# (V <= 512 from N 2112); offsets and V that give heads and tails of 1 to 7
TILED_HEAD_BF16_CASES = [
    (77, 37, 4, 8, 3, True), (64, 250, 4, 8, 0, False),
    (40, 61, 8, 4, 7, False),
]


@pytest.mark.parametrize("n,v,lanes,block_rows,offset,stale",
                         TILED_HEAD_BF16_CASES)
def test_tiled_gipo_head_oracle_takes_bf16_heads_and_tails(
        n, v, lanes, block_rows, offset, stale):
    """As ``test_tiled_gipo_head_oracle_matches_pallas``, on bf16 logits
    (the Pallas kernel on the same values in f32), within the same bars."""
    _check_tiled_head(n, v, lanes, block_rows, offset, stale,
                      torch.bfloat16)


def _check_tiled_head(n, v, lanes, block_rows, offset, stale, dtype):
    data = list(_tok_data(n, v, seed=7 * n + v, stale=stale))
    data[0] = torch.from_numpy(data[0]).to(dtype).float().numpy()
    data[1][0] = v                          # the reference's one-hot: none
    data[4][[1, n // 2]] = 0.0
    exp, exp_grad = _jax_head(data)
    logits, tg, lo, ad, mk = _t(data)
    logits = logits.to(dtype)
    coefs = torch.tensor([1.0, 0.1, -0.01]) / mk.sum().clamp_min(1.0)
    partials, d = ref.tiled_gipo_head_loss(logits, tg, lo, ad, mk, SIGMA,
                                           coefs, lanes=lanes,
                                           block_rows=block_rows,
                                           offset=offset)
    assert partials.shape == (-(-n // block_rows), gl.N_COLS)
    got = gl._finalize(partials.sum(0))
    for k in exp[3]:
        assert abs(float(got[3][k]) - float(exp[3][k])) \
            <= 2e-6 * max(abs(float(exp[3][k])), 1.0)
    for g, e in zip(got[:3], exp[:3]):
        assert abs(float(g) - float(e)) <= 2e-6 * max(abs(float(e)), 1.0)
    exp_grad = np.asarray(exp_grad)
    assert np.abs(d.numpy() - exp_grad).max() \
        <= 2e-6 * np.abs(exp_grad).max()
    assert not d[1].any() and not d[n // 2].any()


@pytest.mark.parametrize("mode", ["pallas", "jnp"])
@pytest.mark.parametrize("route", [None, "torch"])
def test_dispatch_gipo_loss_matches_the_reference_dispatch(mode, route):
    """``dispatch.gipo_loss`` on either of its routes (the kernel wrappers'
    CPU route, and ``forced("torch")``) against the reference's on either
    of its routes."""
    data = _tok_data(257, 48, seed=1)
    logits, *rest = map(jnp.asarray, data)

    def jf(lg):
        with jdispatch.forced(mode):
            pg, ent, kl, m = jdispatch.gipo_loss(lg, *rest, sigma=SIGMA,
                                                 block_n=128)
        return _combine(pg, ent, kl), (pg, ent, kl, m)
    (_, exp), exp_grad = jax.value_and_grad(jf, has_aux=True)(logits)

    def tf(lg, *r):
        return dispatch.gipo_loss(lg, *r[:-1], sigma=r[-1])
    if route is None:
        got, grad = _torch_head(tf, data)
    else:
        with dispatch.forced(route):
            got, grad = _torch_head(tf, data)
    _same_loss(got, exp)
    _close(grad, exp_grad)


# ---------------------------------------------------------------------------
# every op against the reference's ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5), (False, 7)])
def test_flash_attention_op_matches_reference(causal, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    exp = jops.flash_attention_op(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, window=window, block_q=16,
                                  block_k=16)
    got = ops.flash_attention_op(*_t((q, k, v)), causal=causal,
                                 window=window)
    _close(got, exp, rtol=2e-4, atol=2e-4)
    oracle = ref.reference_attention(*_t((q, k, v)), causal=causal,
                                     window=window)
    _close(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("op", ["gipo_loss_op", "gipo_head_loss_op"])
def test_gipo_ops_match_reference(op):
    data = _tok_data(100, 256, seed=6)
    logits, *rest = map(jnp.asarray, data)
    jfn, tfn = getattr(jops, op), getattr(ops, op)

    def loss(out):
        return out[0] if op == "gipo_loss_op" else _combine(*out[:3])

    def jf(lg):
        out = jfn(lg, *rest, sigma=SIGMA, block_n=64)
        return loss(out), out
    (_, exp), exp_grad = jax.value_and_grad(jf, has_aux=True)(logits)
    tl, *tr = _t(data)
    tl.requires_grad_()
    got = tfn(tl, *tr, sigma=SIGMA)
    loss(got).backward()
    _close(got[0].detach(), exp[0])
    for k, e in exp[-1].items():
        _close(got[-1][k], e)
    _close(tl.grad, exp_grad)


def test_fused_policy_loss_op_matches_reference():
    rng = np.random.default_rng(8)
    n, d, va = 65, 16, 48
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, va)) * 0.2).astype(np.float32)
    _, *rows = _tok_data(n, va, seed=8)
    rows[1] = (_own_logp(hidden @ w, rows[0])
               + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def jf(h, w_):
        out = jops.fused_policy_loss_op(h, w_, *map(jnp.asarray, rows),
                                        sigma=SIGMA, block_n=32)
        return _combine(*out[:3]), out
    (_, exp), (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th, tw = (x.requires_grad_() for x in _t((hidden, w)))
    got = ops.fused_policy_loss_op(th, tw, *_t(rows), sigma=SIGMA)
    _combine(*got[:3]).backward()
    _same_loss(got, exp)
    _close(th.grad, jdh, rtol=5e-4, atol=5e-5)
    _close(tw.grad, jdw, rtol=5e-4, atol=5e-5)


def test_ssd_scan_op_matches_reference():
    rng = np.random.default_rng(12)
    b, t, h, p, n = 2, 64, 3, 16, 8
    data = (rng.standard_normal((b, t, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.1, (b, t, h)).astype(np.float32),
            -rng.uniform(0.5, 1.5, (h,)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(np.float32))
    jy, js = jops.ssd_scan_op(*map(jnp.asarray, data), chunk=32)
    ty, ts = ops.ssd_scan_op(*_t(data), chunk=32)
    _close(ty, jy, rtol=2e-4, atol=2e-4)
    _close(ts, js, rtol=2e-4, atol=2e-4)


def test_ops_take_the_reference_names_and_defining_arguments():
    import inspect
    for name in ("flash_attention_op", "gipo_loss_op", "gipo_head_loss_op",
                 "fused_policy_loss_op", "ssd_scan_op"):
        want = [p for p in inspect.signature(getattr(jops, name)).parameters
                if p not in ("block_q", "block_k", "block_n", "interpret")]
        assert list(inspect.signature(getattr(ops, name)).parameters) \
            == want, name
        for p in ("causal", "window", "sigma", "chunk"):
            if p in want:
                assert inspect.signature(getattr(ops, name)).parameters[
                    p].default == inspect.signature(
                        getattr(jops, name)).parameters[p].default


def test_package_exports_what_the_reference_exports():
    import repro.kernels as jkernels
    for name in ("flash_attention", "fused_policy_loss", "gipo_head_loss",
                 "gipo_loss_fused", "ssd_scan", "dispatch", "ops", "ref"):
        assert hasattr(jkernels, name) and hasattr(tkernels, name), name
    assert tkernels.gipo_head_loss is gl.gipo_head_loss
    assert tkernels.ssd_scan is ssd_scan
    assert tkernels.ops is ops and tkernels.dispatch is dispatch


def test_a_cpu_call_launches_no_kernel():
    before = [fn.launches for fn in WRAPPERS]
    data = _t(_tok_data(64, 32, seed=0))
    data[0].requires_grad_()
    pg, ent, kl, _ = ops.gipo_head_loss_op(*data)
    _combine(pg, ent, kl).backward()
    ops.gipo_loss_op(*data)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 8)).astype(
        np.float32))
    ops.flash_attention_op(q, q, q, causal=False)
    x = torch.ones(1, 32, 1, 8)
    ops.ssd_scan_op(x, torch.full((1, 32, 1), 0.05), -torch.ones(1),
                    torch.ones(1, 32, 8), torch.ones(1, 32, 8), chunk=32)
    assert [fn.launches for fn in WRAPPERS] == before
