"""The port's plain attention versions, forward and backward, and its
autograd route through ``dispatch.dense_attention``, against the JAX Pallas
kernels.

The Pallas kernels run in interpret mode on the CPU, unchanged; the port's
wrappers take their plain PyTorch route because the tensors lie on the CPU.
Inputs are made with numpy from a seed and handed to both sides. Tolerance:
rtol/atol 2e-5 in f32 (the two sides sum in different orders); gradients
at rtol/atol 2e-4, the reference's own bar for its backward kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  split_layout)
from repro_torch.kernels.flash_attention import (check_attention_args,
                                                 flash_attention)

TOL = dict(rtol=2e-5, atol=2e-5)


def _data(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


@pytest.mark.parametrize("b,t,s,h,kv,causal", [
    (2, 16, 16, 4, 4, True),      # MHA
    (2, 100, 100, 8, 2, True),    # GQA, ragged vs the 64 block
    (2, 33, 33, 4, 1, True),      # MQA, ragged
    (1, 40, 100, 4, 2, False),    # cross lengths, no causal mask
])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_plain_matches_pallas(b, t, s, h, kv, causal, window):
    rng = np.random.default_rng(b * 1000 + t + s + h + kv)
    d = 64
    q, k, v = _data(rng, (b, t, h, d), (b, s, kv, d), (b, s, kv, d))
    exp_o, exp_lse = pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True,
        return_lse=True)
    o, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window, return_lse=True)
    assert o.dtype == torch.float32 and lse.shape == (b, t, h)
    _close(o, exp_o)
    _close(lse, exp_lse)


@pytest.mark.parametrize("t,h,kv", [(16, 4, 4), (100, 8, 2), (33, 4, 1)])
@pytest.mark.parametrize("window", [None, 8])
def test_dense_dispatch_matches_reference(t, h, kv, window):
    """dispatch.dense_attention on CPU tensors == the JAX dense oracle, and
    the port's own oracle agrees with it."""
    rng = np.random.default_rng(t + h)
    q, k, v = _data(rng, (2, t, h, 64), (2, t, kv, 64), (2, t, kv, 64))
    exp = jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(dispatch.dense_attention(tq, tk, tv, window=window), exp)
    _close(ref.reference_attention(tq, tk, tv, window=window), exp)


@pytest.mark.parametrize("b,s,h,kv", [
    (1, 128, 4, 4),     # MHA, cache == block
    (2, 200, 8, 2),     # GQA, ragged cache
    (3, 33, 4, 1),      # MQA, tiny cache
])
def test_decode_plain_matches_pallas(b, s, h, kv):
    rng = np.random.default_rng(b + s + h)
    d = 64
    q, k, v = _data(rng, (b, 1, h, d), (b, s, kv, d), (b, s, kv, d))
    valid = rng.random((b, s)) > 0.4           # ring-shaped holes
    valid[:, 0] = True
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    exp = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), block_k=64, interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(valid))
    _close(got, exp)
    _close(dispatch.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid)), exp)


@pytest.mark.parametrize("b,t,s,h,kv,causal,window", [
    (2, 100, 100, 8, 2, True, None),   # GQA, ragged vs the 64 tile
    (1, 77, 77, 4, 1, True, 8),        # MQA + window: tiles skipped whole
    (1, 40, 100, 4, 2, False, None),   # cross lengths, no causal mask
])
def test_tiled_reference_matches_pallas_flash(b, t, s, h, kv, causal,
                                              window):
    """The kernels' order of arithmetic (kernels/ref.py), in f32, against
    the Pallas flash kernel: rtol/atol 2e-5."""
    rng = np.random.default_rng(t + s + h)
    q, k, v = _data(rng, (b, t, h, 64), (b, s, kv, 64), (b, s, kv, 64))
    exp_o, exp_lse = pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True,
        return_lse=True)
    qpos, kpos = torch.arange(t)[:, None], torch.arange(s)[None, :]
    ok = torch.ones(t, s, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    o, lse = ref.tiled_softmax_attention(
        *map(torch.from_numpy, (q, k, v)), ok[None, None])
    _close(o, exp_o)
    _close(lse, exp_lse)


@pytest.mark.parametrize("b,t,s,h,kv,causal,window,d", [
    (2, 100, 100, 8, 2, True, None, 64),   # GQA, ragged vs the 64 tile
    (1, 77, 77, 4, 1, True, 8, 128),       # MQA + window, the widest head
    (1, 40, 100, 4, 2, False, None, 64),   # cross lengths, no causal mask
])
def test_tiled_reference_base2_matches_pallas_flash(b, t, s, h, kv, causal,
                                                    window, d):
    """The Hopper K1 body's order of arithmetic (``base2``: scale·log2(e)
    and exp2, the LSE back in natural log), in f32, against the Pallas
    flash kernel: rtol/atol 2e-5."""
    rng = np.random.default_rng(t + s + h + d)
    q, k, v = _data(rng, (b, t, h, d), (b, s, kv, d), (b, s, kv, d))
    exp_o, exp_lse = pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True,
        return_lse=True)
    qpos, kpos = torch.arange(t)[:, None], torch.arange(s)[None, :]
    ok = torch.ones(t, s, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    o, lse = ref.tiled_softmax_attention(
        *map(torch.from_numpy, (q, k, v)), ok[None, None], base2=True)
    _close(o, exp_o)
    _close(lse, exp_lse)


@pytest.mark.parametrize("b,s,h,kv", [(2, 200, 8, 2), (3, 33, 4, 1)])
def test_tiled_reference_matches_pallas_decode(b, s, h, kv):
    rng = np.random.default_rng(b * s + h)
    q, k, v = _data(rng, (b, 1, h, 64), (b, s, kv, 64), (b, s, kv, 64))
    valid = rng.random((b, s)) > 0.4
    valid[:, 0] = True
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    exp = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), block_k=64, interpret=True)
    o, _ = ref.tiled_softmax_attention(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(valid)[:, None, None, :])
    _close(o, exp)


@pytest.mark.parametrize("b,s,h,kv,masked", [
    (2, 275, 8, 2, (192, 275)),    # openvla-7b's 275 slots: 5 splits, the
                                   # last two wholly masked
    (2, 263, 4, 4, None),          # zamba2-1.2b's served cache
    (2, 200, 4, 1, (64, 128)),     # a middle split wholly masked
    (1, 129, 4, 4, None),          # one slot past a split boundary
    (3, 600, 4, 2, (512, 600)),    # two tiles a split, the last masked
])
def test_tiled_reference_split_matches_pallas_decode(b, s, h, kv, masked):
    """The split layout K2 takes (each split walks its own tiles from its
    own running max, then the splits combine in rank order) against the
    Pallas decode kernel, at the tolerance of the unsplit walk."""
    splits, tps = split_layout(s)
    assert splits > 1
    rng = np.random.default_rng(b * s + h)
    q, k, v = _data(rng, (b, 1, h, 64), (b, s, kv, 64), (b, s, kv, 64))
    valid = rng.random((b, s)) > 0.4
    valid[:, 0] = True
    if masked is not None:
        valid[:, masked[0]:masked[1]] = False
        assert masked[0] % (tps * ref.KERNEL_TILE) == 0
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    exp = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), block_k=64, interpret=True)
    o, _ = ref.tiled_softmax_attention(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(valid)[:, None, None, :],
        split=tps * ref.KERNEL_TILE)
    assert torch.isfinite(o).all()
    _close(o, exp)


def test_split_layout_covers_every_tile_once():
    """No split is empty, none holds more than its share, at most 8."""
    for s in range(1, 2000, 7):
        splits, tps = split_layout(s)
        tiles = -(-s // ref.KERNEL_TILE)
        assert 1 <= splits <= 8 and (splits - 1) * tps < tiles <= splits * tps
        assert splits == min(8, tiles) or tps > 1
    assert split_layout(20) == (1, 1) and split_layout(275) == (5, 1)


def test_tiled_reference_rounds_p_like_the_plain_version():
    """In bf16 the tiled reference rounds P before the value product; it
    stays within the bf16 bar (atol/rtol 2e-2) of the plain version."""
    from repro_torch.kernels.flash_attention import _plain_dense
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 70, 4, 32, generator=g).bfloat16()
               for _ in range(3))
    ok = torch.ones(70, 70, dtype=torch.bool).tril()
    o, _ = ref.tiled_softmax_attention(q, k, v, ok[None, None])
    torch.testing.assert_close(o, _plain_dense(q, k, v).float(), atol=2e-2,
                               rtol=2e-2)
    o32, _ = ref.tiled_softmax_attention(q.float(), k.float(), v.float(),
                                         ok[None, None])
    assert (o - o32).abs().max() > 0       # P really was rounded


def test_decode_masks_invalid_slots():
    """All slots masked but one: the output is that slot's value row."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 64, 4, 64
    q, k, v = _data(rng, (b, 1, h, d), (b, s, h, d), (b, s, h, d))
    valid = np.zeros((b, s), bool)
    valid[:, 7] = True
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(valid))
    _close(got[:, 0], v[:, 7])


def test_cpu_route_launches_no_kernel():
    rng = np.random.default_rng(4)
    q, k, v = map(torch.from_numpy,
                  _data(rng, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    before = (flash_attention.launches, decode_attention.launches)
    dispatch.dense_attention(q, k, v)
    dispatch.decode_attention(q[:, :1], k, v, torch.ones(1, 8, dtype=bool))
    assert (flash_attention.launches, decode_attention.launches) == before


def test_forced_modes():
    rng = np.random.default_rng(5)
    q, k, v = map(torch.from_numpy,
                  _data(rng, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    with dispatch.forced("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            dispatch.dense_attention(q, k, v)
    with dispatch.forced("torch"):
        out = dispatch.dense_attention(q, k, v)
    _close(out, ref.reference_attention(q, k, v))
    for bad in ("pallas", "auto"):
        with pytest.raises(ValueError):
            dispatch.set_mode(bad)
    assert dispatch._override is None


@pytest.mark.parametrize("shape_q,shape_k,dtype,match", [
    ((1, 4, 2, 260), (1, 4, 2, 260), torch.float32, "head_dim"),
    ((1, 4, 2, 12), (1, 4, 2, 12), torch.float32, "head_dim"),
    ((1, 4, 3, 16), (1, 4, 2, 16), torch.float32, "multiple of KV"),
    ((1, 4, 2, 16), (1, 4, 2, 16), torch.float16, "dtypes"),
    ((1, 4, 2, 16), (1, 4, 2, 16), torch.float32, "CUDA tensor"),
])
def test_kernel_argument_checks(shape_q, shape_k, dtype, match):
    """What the CUDA wrappers refuse, checked before any launch."""
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_k, dtype=dtype)
    with pytest.raises((ValueError, RuntimeError), match=match):
        check_attention_args(q, k, k)


# ---------------------------------------------------------------------------
# Backward (K3): the plain version and the autograd route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,h,kv,window", [
    (128, 4, 2, None),      # GQA, whole blocks
    (128, 4, 2, 32),        # GQA + window
    (50, 4, 4, None),       # ragged rows (the reference pads T, LSE 1e30)
])
def test_flash_bwd_plain_matches_pallas(d, t, h, kv, window):
    from repro.kernels.flash_attention import flash_attention_bwd as jbwd
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    rng = np.random.default_rng(d + t + h)
    q, k, v, do = _data(rng, (1, t, h, d), (1, t, kv, d), (1, t, kv, d),
                        (1, t, h, d))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = pallas_flash(jq, jk, jv, window=window, block_q=64,
                            block_k=64, interpret=True, return_lse=True)
    exp = jbwd(jq, jk, jv, out, lse, jnp.asarray(do), window=window,
               block_q=64, block_k=64, interpret=True)
    got = flash_attention_bwd(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(np.array(out)),
                              torch.from_numpy(np.array(lse)),
                              torch.from_numpy(do), window=window)
    for g, e in zip(got, exp):
        _close(g, e, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t,h,kv,d,window", [
    (128, 4, 2, 64, None),
    (50, 4, 4, 128, 32),
    (33, 4, 1, 16, None),
])
def test_dense_attention_grads_match_jax(t, h, kv, d, window):
    """jax.grad through the reference's dispatch.dense_attention (Pallas
    flash forward + backward in interpret mode) against torch autograd
    through the port's, which runs FlashAttentionFn on CPU tensors."""
    from repro.kernels import dispatch as jdispatch
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    rng = np.random.default_rng(t + d)
    q, k, v = _data(rng, (2, t, h, d), (2, t, kv, d), (2, t, kv, d))

    def jloss(q_, k_, v_):
        with jdispatch.forced("pallas"):
            out = jdispatch.dense_attention(q_, k_, v_, window=window)
        return jnp.sum(out * out)
    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    calls = []
    orig = FlashAttentionFn.backward

    def spy(ctx, do):
        calls.append(1)
        return orig(ctx, do)
    FlashAttentionFn.backward = staticmethod(spy)
    try:
        out = dispatch.dense_attention(tq, tk, tv, window=window)
        (out * out).sum().backward()
    finally:
        FlashAttentionFn.backward = staticmethod(orig)
    assert calls == [1]
    for g, e in zip((tq.grad, tk.grad, tv.grad), exp):
        _close(g, e, rtol=2e-4, atol=2e-4)


def test_dense_attention_without_grad_runs_the_forward_alone():
    rng = np.random.default_rng(6)
    q, k, v = map(torch.from_numpy,
                  _data(rng, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    assert dispatch.dense_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert dispatch.dense_attention(q, k, v).grad_fn is None
    assert dispatch.dense_attention(q, k, v).grad_fn is not None
