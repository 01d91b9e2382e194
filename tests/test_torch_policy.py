"""The serving slice as a whole: prefill, KV-cache decode and
``sample_action_sequence`` of the port against the JAX reference.

Two reduced configs: openvla-7b (vlm prefix path, MHA) and
llava-next-mistral-7b (vlm, GQA 4/2). The JAX side is initialised, its
weights are bridged, and the JAX side runs its Pallas kernels in interpret
mode (``dispatch.forced("pallas")``). Sampling on both sides uses the same
Gumbel noise: ``jax.random.categorical(key, logits)`` is
``argmax(logits + jax.random.gumbel(key, logits.shape))``, so the port gets
that noise through its ``gumbel`` argument. Tokens must be identical;
logits, logp and value agree within atol 1e-4 (f32, two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import dispatch as jdispatch
from repro.models import policy as jpolicy
from repro.models import transformer as jtransformer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.models import policy as tpolicy
from repro_torch.models import transformer as ttransformer

ATOL = 1e-4
ARCHS = ["openvla-7b", "llava-next-mistral-7b"]


def _setup(arch, b=3, t_obs=12):
    jcfg = jreduced(jget_config(arch), layers=2, d_model=64)
    tcfg = reduced(get_config(arch), layers=2, d_model=64)
    jparams = jpolicy.init_policy_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(7)
    obs = rng.integers(0, jcfg.vocab_size, (b, t_obs)).astype(np.int32)
    prefix = rng.standard_normal(
        (b, jcfg.num_prefix_tokens, 1024)).astype(np.float32)
    step = np.array([0, 5, 63][:b], np.int32)
    return jcfg, tcfg, jparams, tparams, obs, prefix, step


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_categorical_is_gumbel_argmax(arch):
    """The identity the port's sampler relies on, on this jax."""
    cfg = jreduced(jget_config(arch), layers=2, d_model=64)
    key = jax.random.PRNGKey(11)
    logits = jnp.asarray(np.random.default_rng(0).standard_normal(
        (5, cfg.action_vocab_size)), jnp.float32)
    g = jax.random.gumbel(key, logits.shape)
    np.testing.assert_array_equal(
        jax.random.categorical(key, logits, axis=-1),
        jnp.argmax(logits + g, axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jp, tp, obs, prefix, _ = _setup(arch)
    t_total = jcfg.num_prefix_tokens + obs.shape[1]
    with jdispatch.forced("pallas"):
        j_out, j_cache = jtransformer.prefill(
            jcfg, jp, jnp.asarray(obs), jnp.asarray(prefix),
            cache_len=t_total + 2)
    t_out, t_cache = ttransformer.prefill(
        tcfg, tp, torch.from_numpy(obs), torch.from_numpy(prefix),
        cache_len=t_total + 2)
    _close(t_out["hidden"], j_out["hidden"])
    _close(t_out["logits"], j_out["logits"])
    for tok in ([1, 2, 3], [40, 0, 7]):
        tok = np.array(tok, np.int32)
        with jdispatch.forced("pallas"):
            j_dec, j_cache = jtransformer.decode(jcfg, jp, jnp.asarray(tok),
                                                 j_cache)
        t_dec, t_cache = ttransformer.decode(tcfg, tp, torch.from_numpy(tok),
                                             t_cache)
        _close(t_dec["logits"], j_dec["logits"])
        _close(t_cache.attn.k, j_cache.attn.k)
        np.testing.assert_array_equal(t_cache.attn.positions,
                                      j_cache.attn.positions)
        np.testing.assert_array_equal(t_cache.attn.length,
                                      j_cache.attn.length)


@pytest.mark.parametrize("arch", ARCHS)
def test_sample_action_sequence_matches_reference(arch):
    jcfg, tcfg, jp, tp, obs, prefix, step = _setup(arch)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, jcfg.action_dim)
    shape = (obs.shape[0], jcfg.action_vocab_size)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, shape))
                       for k in keys])
    with jdispatch.forced("pallas"):
        j_tok, j_logp, j_val = jpolicy.sample_action_sequence(
            jcfg, jp, key, jnp.asarray(obs), jnp.asarray(step),
            jnp.asarray(prefix))
    t_tok, t_logp, t_val = tpolicy.sample_action_sequence(
        tcfg, tp, None, torch.from_numpy(obs), torch.from_numpy(step),
        torch.from_numpy(prefix), gumbel=torch.from_numpy(gumbel))
    assert t_tok.shape == (obs.shape[0], jcfg.action_dim)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    _close(t_logp, j_logp)
    _close(t_val, j_val)


def test_sampler_draws_from_its_generator():
    """Without injected noise the sampler is a function of its generator:
    same seed, same actions; tokens in range, logp <= 0."""
    _, tcfg, _, tp, obs, prefix, step = _setup("openvla-7b")
    args = (torch.from_numpy(obs), torch.from_numpy(step),
            torch.from_numpy(prefix))
    outs = [tpolicy.sample_action_sequence(
        tcfg, tp, torch.Generator().manual_seed(5), *args) for _ in range(2)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    tok, logp, val = outs[0]
    assert int(tok.min()) >= 0 and int(tok.max()) < tcfg.action_vocab_size
    assert bool((logp <= 0).all()) and bool(torch.isfinite(val).all())


def test_other_arch_types_name_a_later_slice():
    cfg = reduced(get_config("mamba2-2.7b"), layers=2, d_model=64)
    with pytest.raises(NotImplementedError, match="later slice"):
        ttransformer.init_params(cfg, torch.Generator(), device="cpu")
