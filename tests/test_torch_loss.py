"""The fused action head + GIPO loss (K4) of the port against the JAX
package, on the CPU.

The port's wrapper takes its plain versions for CPU tensors, through the
same ``torch.autograd.Function`` the kernels use on the card (forward
partials, then the analytic backward with the ``_loss_coefs`` row). It is
held against the reference's Pallas kernel in interpret mode and against
``ref.reference_policy_loss`` (plain autodiff), on the reference's own
cases and tolerances: values rtol 2e-4 / atol 2e-5, grads rtol 5e-4 /
atol 5e-5 (f32 sums in other orders); bf16 hidden at 5e-2 (its rounding).
The autodiffed plain route that ``dispatch.forced("torch")`` selects is
held to the same bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gipo_loss import fused_policy_loss as pallas_policy_loss
from repro_torch.kernels import dispatch
from repro_torch.kernels import gipo_loss as gl

SIGMA = 0.2
VAL = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-5)


def _data(n, d, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, v)) * 0.2).astype(np.float32),
            rng.integers(0, v, n).astype(np.int32),
            (rng.standard_normal(n) * 0.3).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (rng.random(n) > 0.15).astype(np.float32))


def _combine(out):
    pg, ent, kl, _ = out
    return pg + 0.1 * kl - 0.01 * ent


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32), **tol)


def _port(route, h, w, rest):
    """(values, metrics, dh, dw) of the port on CPU tensors."""
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    rest_t = [torch.from_numpy(x) for x in rest]
    if route == "function":
        out = gl.fused_policy_loss(ht, wt, *rest_t, SIGMA)
    else:
        with dispatch.forced("torch"):
            out = dispatch.policy_head_loss(ht, wt, *rest_t, sigma=SIGMA)
    _combine(out).backward()
    return ([x.detach().numpy() for x in out[:3]],
            {k: x.numpy() for k, x in out[3].items()},
            ht.grad.numpy(), wt.grad.numpy())


@pytest.mark.parametrize("n,d,v", [(128, 32, 32),    # exact blocks
                                   (300, 64, 48),    # ragged
                                   (65, 16, 256)])   # ragged by one, Va 256
@pytest.mark.parametrize("route", ["function", "plain_autodiff"])
def test_policy_loss_matches_pallas_and_reference(n, d, v, route):
    h, w, *rest = _data(n, d, v, seed=n + d + v)
    jrest = [jnp.asarray(x) for x in rest]

    def pallas(h_, w_):
        return pallas_policy_loss(h_, w_, *jrest, SIGMA, 64, True)

    def reference(h_, w_):
        return jref.reference_policy_loss(h_, w_, *jrest, SIGMA)

    vals, metrics, dh, dw = _port(route, h, w, rest)
    for oracle in (pallas, reference):
        exp = oracle(jnp.asarray(h), jnp.asarray(w))
        for got, e in zip(vals, exp[:3]):
            _close(got, e, VAL)
        for k in ("ratio_mean", "omega_mean", "stale_frac"):
            _close(metrics[k], exp[3][k], VAL)
        edh, edw = jax.grad(lambda a, b: _combine(oracle(a, b)),
                            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
        _close(dh, edh, GRAD)
        _close(dw, edw, GRAD)


def test_policy_loss_bf16_hidden():
    n, d, v = 256, 32, 64
    h, w, *rest = _data(n, d, v, seed=3)
    hb, wb = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    exp, *_ = jref.reference_policy_loss(hb, wb, *map(jnp.asarray, rest),
                                         SIGMA)
    hp = torch.from_numpy(np.array(hb.astype(jnp.float32))).bfloat16()
    wp = torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16()
    pg, *_ = gl.fused_policy_loss(hp, wp, *map(torch.from_numpy, rest),
                                  SIGMA)
    assert float(pg) == pytest.approx(float(exp), rel=5e-2, abs=5e-2)


def test_backward_grads_keep_their_dtypes_and_skip_constants():
    h, w, *rest = _data(40, 16, 32, seed=5)
    ht = torch.from_numpy(h).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    pg, ent, kl, m = gl.fused_policy_loss(ht, wt,
                                          *map(torch.from_numpy, rest),
                                          SIGMA)
    assert all(not x.requires_grad for x in m.values())
    (pg + kl).backward()
    assert ht.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.bfloat16
    assert ht.grad.abs().sum() > 0 and wt.grad.abs().sum() > 0


def test_loss_coefs_row_matches_reference():
    from repro.kernels.gipo_loss import _loss_coefs as jcoefs
    mask = (np.random.default_rng(0).random(50) > 0.3).astype(np.float32)
    cts = (np.float32(1.5), np.float32(-0.25), np.float32(0.1))
    exp = np.asarray(jcoefs(jnp.asarray(mask),
                            tuple(map(jnp.asarray, cts)) + (None,)))[0, :3]
    got = gl._loss_coefs(torch.from_numpy(mask),
                         *map(torch.tensor, cts)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-7)


def test_plain_versions_match_the_shared_block_math_of_the_reference():
    """_fwd_partials and _block_dlogits against the reference's helpers on
    one block, bit for bit in spirit (f32, same order of operations)."""
    from repro.kernels import gipo_loss as jgl
    h, w, tg, lo, ad, mk = _data(33, 8, 24, seed=9)
    logits = h @ w
    exp = jgl._fwd_partials(jnp.asarray(logits), *map(jnp.asarray,
                                                      (tg, lo, ad, mk)),
                            SIGMA)
    got = gl._fwd_partials(torch.from_numpy(logits),
                           *map(torch.from_numpy, (tg, lo, ad, mk)), SIGMA)
    _close(got, exp, dict(rtol=1e-5, atol=1e-6))
    exp_d = jgl._block_dlogits(jnp.asarray(logits),
                               *map(jnp.asarray, (tg, lo, ad, mk)), SIGMA,
                               0.3, 0.1, -0.02)
    got_d = gl._block_dlogits(torch.from_numpy(logits),
                              *map(torch.from_numpy, (tg, lo, ad, mk)),
                              SIGMA, 0.3, 0.1, -0.02)
    _close(got_d, exp_d, dict(rtol=1e-5, atol=1e-7))


def test_cpu_route_launches_no_kernel():
    h, w, *rest = _data(20, 8, 16, seed=1)
    n0 = (gl.policy_loss_fwd.launches, gl.policy_loss_bwd.launches)
    ht = torch.from_numpy(h).requires_grad_(True)
    pg, *_ = gl.fused_policy_loss(ht, torch.from_numpy(w),
                                  *map(torch.from_numpy, rest), SIGMA)
    pg.backward()
    assert (gl.policy_loss_fwd.launches, gl.policy_loss_bwd.launches) == n0
