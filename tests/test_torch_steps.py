"""The step programs of ``repro_torch.launch.steps`` and the blockwise
attention path against the JAX package, on the CPU.

  * ``_blockwise_attn`` against the reference's (forward and grads through
    ``jax.vjp`` on the same cotangent) and against the dense path, at
    S % block != 0, with and without a window, in f32 and bf16;
    ``attention_forward`` with ``block < T`` against the reference's.
  * ``seq_loss_fn`` / ``seq_train_step`` against the reference's on reduced
    deepseek-7b, openvla-7b (prefix tokens: S ragged against the block),
    mamba2-2.7b, zamba2-1.2b and granite-moe-1b-a400m, from the same
    bridged params and the same numpy batch. Each arch runs three cases
    that between them take accum 1 and 2, ``block=None`` and
    ``block < T``, the fused loss and the unfused GIPO and PPO losses.

Tolerances (f32), those of ``tests/test_torch_train.py``: metrics rtol
1e-4 / atol 1e-5; the accumulated grads 1e-5 + 1e-4 * max|g| a leaf
(read from the first moments, so scaled by 1 - b1); the updated params
within 0.1 lr (AdamW's first step moves an element by about lr whatever
its gradient), 2 lr where the reference's grad is within that bar of 0.
The blockwise attention: f32 rtol 1e-5 / atol 1e-5 (grads atol 1e-4 of
the largest); bf16, where the two frameworks round the value product's
output at different places, 2e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RLConfig as JRLConfig
from repro.core.advnorm import init_adv_state as j_init_adv_state
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models.policy import init_policy_params as j_init_policy_params
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import RLConfig
from repro_torch.core.advnorm import init_adv_state
from repro_torch.kernels.flash_attention import _plain_dense
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
RL_KW = dict(lr_policy=LR, warmup_steps=2)
ARCHS = ["deepseek-7b", "openvla-7b", "mamba2-2.7b", "zamba2-1.2b",
         "granite-moe-1b-a400m"]
# (accum, block, fused_loss, algo): accum 1 and 2, block None and < T,
# the fused loss and the unfused GIPO and PPO losses
CASES = [(1, None, True, "gipo"), (2, 16, False, "gipo"),
         (2, 16, False, "ppo")]
B, S = 4, 40
# ssm and hybrid: the reference's training scan wants T = S + prefix a
# multiple of the SSD chunk (32 reduced)
SSM_T = 64


@pytest.fixture(autouse=True)
def _deterministic():
    """The CPU embedding backward accumulates in no fixed order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _to(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_blockwise_attn_matches_reference_and_dense(dtype, window):
    """T = S = 37 over blocks of 16 (S padded to 48), GQA 4 over 2."""
    rng = np.random.default_rng(0)
    b, t, h, kv, d, block = 2, 37, 4, 2, 16, 16
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d),
                            (b, t, h, d)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    scale = d ** -0.5

    def jfn(q, k, v):
        return jattn._blockwise_attn(q, k, v, scale, window=window,
                                     block=block)
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x, jd) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g, jnp.float32))
    tq, tk, tv = (_to(x, td).requires_grad_() for x in (q, k, v))
    tout = tattn._blockwise_attn(tq, tk, tv, scale, window=window,
                                 block=block)
    assert tout.dtype == torch.float32 and tout.shape == (b, t, h, d)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout, np.float32), **tol)
    for got, exp in zip(tgrads, jgrads):
        exp = np.asarray(exp, np.float32)
        scale_g = np.abs(exp).max()
        np.testing.assert_allclose(
            got.float().numpy(), exp, rtol=tol["rtol"],
            atol=(1e-4 if dtype == "float32" else 2e-2) * scale_g)
    if dtype == "float32":
        dense = _plain_dense(tq.detach(), tk.detach(), tv.detach(),
                             window=window)
        np.testing.assert_allclose(tout.detach().numpy(), dense.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_attention_forward_block_path_matches_reference():
    """``attention_forward`` with ``block < T`` (the blockwise path, cast
    to x's dtype) against the reference's, and against the dense path."""
    rng = np.random.default_rng(1)
    d_model, h, kv, hd, t = 32, 4, 2, 8, 21
    params = {n: rng.standard_normal(s).astype(np.float32) * 0.3
              for n, s in (("wq", (d_model, h, hd)), ("wk", (d_model, kv, hd)),
                           ("wv", (d_model, kv, hd)),
                           ("wo", (h, hd, d_model)))}
    x = rng.standard_normal((2, t, d_model)).astype(np.float32)
    want = jattn.attention_forward(
        {n: jnp.asarray(p) for n, p in params.items()}, jnp.asarray(x),
        rope_theta=1e4, block=8)
    tp = {n: torch.from_numpy(p) for n, p in params.items()}
    got = tattn.attention_forward(tp, torch.from_numpy(x), rope_theta=1e4,
                                  block=8)
    dense = tattn.attention_forward(tp, torch.from_numpy(x), rope_theta=1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def _seq_len(cfg) -> int:
    if cfg.arch_type in ("ssm", "hybrid"):
        return SSM_T - cfg.num_prefix_tokens
    return S


def _batch(cfg, accum, seed=0):
    """A numpy batch with a leading [accum] axis where accum > 1."""
    rng = np.random.default_rng(seed)
    lead = (accum, B // accum) if accum > 1 else (B,)
    S = _seq_len(cfg)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, lead + (S,)
                               ).astype(np.int32),
        "behavior_logp": (rng.standard_normal(lead + (S,)) * 0.3
                          - np.log(cfg.action_vocab_size)).astype(np.float32),
        "rewards": rng.standard_normal(lead + (S - 1,)).astype(np.float32),
        "dones": (rng.random(lead + (S - 1,)) < 0.1).astype(np.float32),
        "mask": (rng.random(lead + (S - 1,)) < 0.9).astype(np.float32),
    }
    if cfg.num_prefix_tokens:
        out["prefix"] = rng.standard_normal(
            lead + (cfg.num_prefix_tokens, 1024)).astype(np.float32)
    return out


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().float().numpy()
            for path, x in tree_leaves_with_path(tree)}


def _run(arch, accum, block, fused, algo):
    """One ``seq_train_step`` in both packages from the same bridged params
    and the same numpy batch (the reference's jitted)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch), layers=2, d_model=64)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), layers=2, d_model=64)
    jrl = JRLConfig(fused_loss=fused, algo=algo, **RL_KW)
    trl = RLConfig(fused_loss=fused, algo=algo, **RL_KW)
    jp = j_init_policy_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    nb = _batch(jcfg, accum)
    jstate = jsteps.SeqTrainState(jp, jadamw.init(jp), j_init_adv_state())
    js, jm = jax.jit(functools.partial(
        jsteps.seq_train_step, cfg=jcfg, rl=jrl, block=block,
        accum=accum))(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    tstate = tsteps.SeqTrainState(tp, adamw.init(tp), init_adv_state("cpu"))
    ts, tm = tsteps.seq_train_step(
        tstate, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg=tcfg,
        rl=trl, block=block, accum=accum)
    return dict(jm=jm, tm=tm, jp=_jflat(js.params), tp=_tflat(ts.params),
                jmu=_jflat(js.opt.mu), tmu=_tflat(ts.opt.mu),
                jadv=js.adv_norm, tadv=ts.adv_norm)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("arch", ARCHS)
def test_seq_train_step_matches_reference(arch, case):
    """The step's metrics (``seq_loss_fn``'s, of the last micro-batch, and
    the grad norm), its accumulated grads (read from the first moments:
    mu = (1 - b1) * the clipped f32 grads), the Welford state and the
    updated params. Where the reference's grad is within the grads' bar of
    0, AdamW's first step may move the two sides apart by up to 2 lr in
    either direction; there the params are held within 2 lr."""
    r = _run(arch, *case)
    assert set(r["tm"]) == set(r["jm"])
    for k in r["jm"]:
        np.testing.assert_allclose(float(r["tm"][k]), float(r["jm"][k]),
                                   err_msg=k, **METRIC_TOL)
    for a, b in zip(r["tadv"], r["jadv"]):
        np.testing.assert_allclose(float(a), float(b), **METRIC_TOL)
    assert r["tmu"].keys() == r["jmu"].keys()
    lr = LR / RL_KW["warmup_steps"]
    for path, e in r["jmu"].items():
        bar = 1e-5 * 0.1 + 1e-4 * float(np.abs(e).max())
        diff = float(np.abs(r["tmu"][path] - e).max())
        assert diff <= bar, (path, diff)
        moved = np.abs(r["tp"][path] - r["jp"][path])
        held = np.where(np.abs(e) > bar, 0.1 * lr, 2 * lr + 1e-7)
        assert (moved <= held).all(), (path, float(moved.max()))
