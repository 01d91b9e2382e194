"""The port's plain attention versions against the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, unchanged; the port's
wrappers take their plain PyTorch route because the tensors lie on the CPU.
Inputs are made with numpy from a seed and handed to both sides. Tolerance:
rtol/atol 2e-5 in f32 (the two sides sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.decode_attention import decode_attention
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
