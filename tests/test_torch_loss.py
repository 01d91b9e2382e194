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
held to the same bars. ``ref.tiled_policy_loss``, the order of arithmetic
of K4's tensor-core body (d split over a cluster's ranks, d in three bf16
terms for dh and dw), is held against the Pallas kernel on bf16 inputs.
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
from repro_torch.kernels import ref

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


# K4's tensor-core body sums the logits over d in slices (a cluster's
# ranks) and feeds d to dh and dw in three bf16 terms. Its CPU oracle,
# ref.tiled_policy_loss, on inputs whose logits are exact in f32 (h = k / 8,
# w = k / 4096, |k| <= 16: both sides then agree on the logits bit for bit,
# and the comparison sees d's split), agrees with the Pallas kernel (f32
# inside) to 3.2e-7 - 1.3e-6 of the largest value in dh and dw at these
# shapes (f32 sums in other orders, in d's softmax too), and to 2.4e-7 in
# the loss and metrics: held at 2.5e-6 and 1e-6. With two terms dh and dw
# read 2.1e-6 - 5.0e-6: past that bar at the two cases below, and more
# than twice the three-term error there.
TILED_POLICY_TOL = 2.5e-6
TILED_POLICY_FWD_TOL = 1e-6


def _exact_policy_data(n, d, v, seed):
    """bf16-exact inputs with exact f32 logits, and live behaviour
    log-probs (the logits' own log-prob of the target plus 0.1 N(0, 1))."""
    rng = np.random.default_rng(seed)
    h = (rng.integers(-16, 17, (n, d)) / 8).astype(np.float32)
    w = (rng.integers(-16, 17, (d, v)) / 4096).astype(np.float32)
    tg = rng.integers(0, v, n).astype(np.int32)
    logits = h.astype(np.float64) @ w
    lp = logits - logits.max(1, keepdims=True)
    lp -= np.log(np.exp(lp).sum(1, keepdims=True))
    lo = (lp[np.arange(n), tg] + 0.1 * rng.standard_normal(n)) \
        .astype(np.float32)
    return (h, w, tg, lo, rng.standard_normal(n).astype(np.float32),
            (rng.random(n) > 0.15).astype(np.float32))


def _rel_err(got, exp):
    """Max abs error as a fraction of the largest value of ``exp``."""
    got = np.asarray(got, np.float32)
    exp = np.asarray(exp, np.float32)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


# (d, a cluster rank's rows of d as K4's tensor-core body takes them:
# d / 16 rounded up to 16 from d 256 up, fewer ranks below)
SLICES = [(8, 16), (24, 32), (64, 16), (128, 16), (2048, 128), (2056, 144),
          (2560, 160), (4096, 256), (6144, 384)]


@pytest.mark.parametrize("n,d,v,terms", [
    (40, 4096, 256, 3),            # openvla-7b's width and action head
    (37, 2560, 256, 3),            # mamba2-2.7b's, ragged N
    (33, 2048, 64, 3),             # zamba2-1.2b's, Va 64
    (70, 2056, 192, 3),            # d off the 16-grid: the last slice short
    (17, 4096, 64, 3),             # fewer rows than a tile
    (40, 4096, 256, 2), (33, 2048, 64, 2),   # two terms: past the bar
])
def test_tiled_policy_oracle_matches_pallas(n, d, v, terms):
    h, w, *rest = _exact_policy_data(n, d, v, seed=n + d + v)
    jrest = [jnp.asarray(x) for x in rest]

    def pallas(h_, w_):
        out = pallas_policy_loss(h_, w_, *jrest, SIGMA, 64, True)
        return _combine(out), out

    (_, exp), (edh, edw) = jax.value_and_grad(
        pallas, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    hb, wb = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    assert torch.equal(hb.float(), torch.from_numpy(h))
    assert torch.equal(wb.float(), torch.from_numpy(w))
    rest_t = [torch.from_numpy(x) for x in rest]
    coefs = gl._loss_coefs(rest_t[3], torch.tensor(1.0), torch.tensor(-0.01),
                           torch.tensor(0.1))

    def oracle(t):
        return ref.tiled_policy_loss(hb, wb, *rest_t, SIGMA, coefs,
                                     d_slice=dict(SLICES)[d], terms=t)
    sums, dh, dw = oracle(terms)
    pg, ent, kl, m = gl._finalize(sums)
    fwd = max(abs(float(a) - float(b)) / max(abs(float(b)), 1.0)
              for a, b in zip([pg, ent, kl] + [m[k] for k in sorted(m)],
                              list(exp[:3]) + [exp[3][k] for k in sorted(m)]))
    assert fwd <= TILED_POLICY_FWD_TOL, fwd
    assert dh.dtype == dw.dtype == torch.float32
    err = max(_rel_err(dh, edh), _rel_err(dw, edw))
    if terms == 3:
        assert err <= TILED_POLICY_TOL, err
    else:
        _, dh3, dw3 = oracle(3)
        err3 = max(_rel_err(dh3, edh), _rel_err(dw3, edw))
        assert err > TILED_POLICY_TOL, err
        assert err > 2 * err3, (err, err3)


@pytest.mark.parametrize("d,d_slice", SLICES)
def test_cluster_slices_cover_d(d, d_slice):
    """The oracle's slices of d cover it once, the last one short or wholly
    past d: on inputs whose logits are exact in any order, its sums, dh and
    dw are bit-equal to those of one slice of all of d."""
    h, w, *rest = _exact_policy_data(5, d, 16, seed=d)
    args = [torch.from_numpy(x) for x in (h, w, *rest)]
    coefs = torch.tensor([0.7, 0.1, -0.01]) / 5
    assert d_slice % 16 == 0 and -(-d // d_slice) <= 16
    got = ref.tiled_policy_loss(*args, SIGMA, coefs, d_slice=d_slice)
    exp = ref.tiled_policy_loss(*args, SIGMA, coefs, d_slice=d)
    for x, y in zip(got, exp):
        assert torch.equal(x, y)
