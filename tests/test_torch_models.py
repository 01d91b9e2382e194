"""The port's model modules against the JAX reference functions.

Same numpy-seeded inputs and bridged JAX-initialised weights on both sides,
f32 throughout. Tolerance: atol 1e-5 (rtol 1e-5) — f32 sums in a different
order, and RoPE's sin/cos from two libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import value_head as jvh
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import value_head as tvh

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    exp = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x))
    _close(got, exp)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 4, 16)).astype(np.float32)
    if per_row:      # decode: one position per batch row, [B, 1]
        x = x[:, :1]
        pos = np.array([[5], [130], [274]], np.int32)
    else:
        pos = np.arange(7, dtype=np.int32)[None, :]
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, exp)


def test_mlp():
    p = jlayers.mlp_init(jax.random.PRNGKey(2), 64, 256, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    _close(tlayers.mlp(_t(p), torch.from_numpy(x)),
           jlayers.mlp(p, jnp.asarray(x)))


def test_value_head():
    p = jvh.value_head_init(jax.random.PRNGKey(3), 64, 16)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((4, 7, 64)).astype(np.float32)
    step = np.array([0, 3, 15, 40], np.int32)      # 40 is clipped to 15
    _close(tvh.value_head(_t(p), torch.from_numpy(h), torch.from_numpy(step)),
           jvh.value_head(p, jnp.asarray(h), jnp.asarray(step)))


def _attn_params(kv):
    return jattn.attention_init(jax.random.PRNGKey(4), 64, 4, kv, 16,
                                jnp.float32)


def _cache_close(tc, jc):
    for name in ("k", "v", "positions", "length"):
        _close(getattr(tc, name), getattr(jc, name))


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("cache_len,window", [
    (16, None),     # cache longer than the prompt
    (9, None),      # exactly the prompt
    (5, None),      # ring buffer: keeps the last 5, slot = pos % 5
    (5, 4),         # ring + sliding window
])
def test_attention_prefill_and_decode(kv, cache_len, window):
    """Prefill (normal and ring branches), then three decode steps that
    scatter into the cache; outputs and every cache field match."""
    p = _attn_params(kv)
    tp = _t(p)
    rng = np.random.default_rng(kv * 100 + cache_len)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    j_out, j_cache = jattn.attention_prefill(
        p, jnp.asarray(x), rope_theta=1e4, cache_len=cache_len,
        window=window)
    t_out, t_cache = tattn.attention_prefill(
        tp, torch.from_numpy(x), rope_theta=1e4, cache_len=cache_len,
        window=window)
    _close(t_out, j_out)
    _cache_close(t_cache, j_cache)
    for step in range(3):
        xs = rng.standard_normal((2, 1, 64)).astype(np.float32)
        j_out, j_cache = jattn.attention_decode(
            p, jnp.asarray(xs), j_cache, rope_theta=1e4, window=window)
        t_out, t_cache = tattn.attention_decode(
            tp, torch.from_numpy(xs), t_cache, rope_theta=1e4, window=window)
        _close(t_out, j_out)
        _cache_close(t_cache, j_cache)


def test_attention_decode_updates_cache_in_place():
    tp = _t(_attn_params(2))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4, 64)).astype(np.float32))
    _, cache = tattn.attention_prefill(tp, x, rope_theta=1e4, cache_len=8)
    k_before = cache.k
    _, new = tattn.attention_decode(tp, x[:, :1], cache, rope_theta=1e4)
    assert new.k is k_before and new.positions is cache.positions
    assert cache.positions[0, 4] == 4 and int(new.length[0]) == 5
