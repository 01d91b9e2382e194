"""Fused action head + GIPO/entropy/KL loss (K4): the CUDA kernels
``csrc/gipo_loss.cu`` and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``repro/kernels/gipo_loss.py``
(``_policy_fwd_kernel`` / ``_policy_bwd_kernel`` behind the custom VJP of
``fused_policy_loss``). Forward: per block of token rows, ``hidden @ w``
in f32 → log-softmax → target gather → Gaussian trust weight ω (eq. 5,
constant) → surrogate (eq. 6), entropy, k3-KL and a stale flag, summed
into one row of the 8 partial-sum columns of ``N_COLS``; the sum over
blocks and ``_finalize`` are plain torch on the ``[nb, 8]`` partials.
Backward: the block's logits are recomputed, ``_block_dlogits`` gives
``d`` with the coefficient row of ``_loss_coefs``, then ``dh = d·wᵀ`` in
hidden's dtype and ``dw = Σ hᵀ·d`` in f32. Gradients flow to ``hidden``
and ``w`` only; targets, μ, advantages and mask are constants.

``fused_policy_loss`` is a ``torch.autograd.Function``: CUDA tensors launch
the kernels (raising on anything they do not take), CPU tensors take the
plain versions. ``policy_loss_fwd.launches`` and
``policy_loss_bwd.launches`` count kernel launches. ``plain_policy_loss``
is the autodiffed plain route (the reference's jnp twin), which
``dispatch.forced("torch")`` selects.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _capability

# Column layout of the per-block partial sums (padded to 8):
#   0: Σ pg        1: Σ ratio   2: Σ omega   3: Σ mask (token count)
#   4: Σ entropy   5: Σ k3-KL   6: Σ stale   7: unused
N_COLS = 8
BLOCK_N = 16          # token rows per CTA in csrc/gipo_loss.cu
MAX_VA = 256          # a row's logits live in the CTA's shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Shared block math (plain torch), as in the reference l.43-128
# ---------------------------------------------------------------------------

def _softmax_rows(logits32: torch.Tensor, targets: torch.Tensor):
    """Row log-softmax pieces. logits32: [bn, V] f32; targets [bn]."""
    row_max = logits32.amax(dim=-1, keepdim=True)
    shifted = logits32 - row_max
    expsh = torch.exp(shifted)
    sumexp = expsh.sum(dim=-1)
    lse = torch.log(sumexp)
    v = logits32.shape[1]
    onehot = (torch.arange(v, device=logits32.device)[None, :]
              == targets.long()[:, None])
    tgt_shifted = torch.where(onehot, shifted, 0.0).sum(dim=-1)
    logp_new = tgt_shifted - lse
    p = expsh / sumexp[:, None]
    logp = shifted - lse[:, None]
    ent = -(p * logp).sum(dim=-1)
    return p, logp, onehot, logp_new, ent


def _fwd_partials(logits32, targets, logp_old, adv, mask, sigma: float,
                  sg=lambda x: x) -> torch.Tensor:
    """One block's 8 partial sums. ``sg`` detaches the log-ratio inside ω
    and the stale flag when the caller autodiffs through this."""
    _, _, _, logp_new, ent = _softmax_rows(logits32, targets)
    lr = logp_new - logp_old
    ratio = torch.exp(lr)
    omega = torch.exp(-0.5 * (sg(lr) / sigma).square())       # eq. 5
    pg = -(omega * ratio * adv)                                # eq. 6
    k3 = torch.expm1(-lr) + lr                                 # k3 KL
    stale = (sg(lr).abs() > 2.0 * sigma).float()
    m = mask
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.stack([
        (pg * m).sum(), (ratio * m).sum(), (omega * m).sum(), m.sum(),
        (ent * m).sum(), (k3 * m).sum(), (stale * m).sum(), zero])


def _block_dlogits(logits32, targets, logp_old, adv, mask, sigma: float,
                   c_pg, c_kl, c_ent) -> torch.Tensor:
    """Analytic d_logits, f32 [bn, V]; c_* are the upstream cotangents
    already divided by the global denominator:
      pg:  ∂(−ω ρ Â)/∂logp_new = −ω ρ Â        (ω is constant)
      kl:  ∂k3/∂logp_new       = 1 − e^{−log ρ}
      ent: ∂H/∂z_v             = −p_v (log p_v + H)"""
    p, logp, onehot, logp_new, ent = _softmax_rows(logits32, targets)
    lr = logp_new - logp_old
    ratio = torch.exp(lr)
    omega = torch.exp(-0.5 * (lr / sigma).square())
    g = (c_pg * (-(omega * ratio * adv))
         + c_kl * (1.0 - torch.exp(-lr))) * mask
    d = g[:, None] * (onehot.float() - p)
    return d + (c_ent * mask)[:, None] * (-(p * (logp + ent[:, None])))


def _finalize(sums: torch.Tensor):
    """Partial-sum vector [8] -> (pg, entropy, kl, metrics); the metrics
    are detached diagnostics."""
    denom = torch.clamp_min(sums[3], 1.0)
    metrics = {"ratio_mean": (sums[1] / denom).detach(),
               "omega_mean": (sums[2] / denom).detach(),
               "stale_frac": (sums[6] / denom).detach()}
    return sums[0] / denom, sums[4] / denom, sums[5] / denom, metrics


def _loss_coefs(mask: torch.Tensor, ct_pg, ct_ent, ct_kl) -> torch.Tensor:
    """(pg, entropy, kl) cotangents over the denominator, as the f32 row
    (c_pg, c_kl, c_ent) the backward kernel reads."""
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (torch.stack([ct_pg, ct_kl, ct_ent]).float() / denom).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (the CPU route and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _logits32(hidden, w):
    return hidden.float() @ w.float()


def _plain_policy_loss_fwd(hidden, w, targets, logp_old, advantages, mask,
                           sigma: float) -> torch.Tensor:
    """All N rows as one block: partial sums [1, 8] f32."""
    return _fwd_partials(_logits32(hidden, w), targets, logp_old,
                         advantages, mask, sigma)[None]


def _plain_policy_loss_bwd(hidden, w, targets, logp_old, advantages, mask,
                           sigma: float, coefs: torch.Tensor):
    """``_block_dlogits`` over all N rows at once -> (dh in hidden's dtype,
    dw in w's dtype)."""
    d = _block_dlogits(_logits32(hidden, w), targets, logp_old, advantages,
                       mask, sigma, coefs[0], coefs[1], coefs[2])
    dh = (d @ w.float().T).to(hidden.dtype)
    dw = (hidden.float().T @ d).to(w.dtype)
    return dh, dw


def plain_policy_loss(hidden, w, targets, logp_old, advantages, mask,
                      sigma: float):
    """The forward math autodiffed by torch, with the log-ratio detached
    inside ω (the reference's jnp twin ``_jnp_policy_loss``)."""
    sums = _fwd_partials(_logits32(hidden, w), targets, logp_old,
                         advantages, mask, sigma, sg=torch.Tensor.detach)
    return _finalize(sums)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_policy_loss_args(hidden, w, targets, logp_old, advantages,
                           mask) -> None:
    """What the CUDA kernels take; anything else raises."""
    if hidden.ndim != 2 or w.ndim != 2 or w.shape[0] != hidden.shape[1]:
        raise ValueError(f"want hidden [N,d], w [d,Va]; got "
                         f"{tuple(hidden.shape)}, {tuple(w.shape)}")
    n, d = hidden.shape
    va = w.shape[1]
    if n == 0:
        raise ValueError("N must be >= 1")
    if d % 8 or va % 8 or not 8 <= va <= MAX_VA:
        raise ValueError(f"d={d} must be a multiple of 8 and Va={va} a "
                         f"multiple of 8 in [8, {MAX_VA}]")
    if hidden.dtype not in _DTYPE_CODES or w.dtype != hidden.dtype:
        raise ValueError(f"hidden and w must both be float32 or bfloat16; "
                         f"got {hidden.dtype}, {w.dtype}")
    if targets.dtype != torch.int32:
        raise ValueError(f"targets must be int32, got {targets.dtype}")
    for name, x in (("logp_old", logp_old), ("advantages", advantages),
                    ("mask", mask)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    for name, x in (("hidden", hidden), ("w", w), ("targets", targets),
                    ("logp_old", logp_old), ("advantages", advantages),
                    ("mask", mask)):
        if name not in ("hidden", "w") and tuple(x.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(x.shape)}")
        if not x.is_cuda or x.device != hidden.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{hidden.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    cap = _capability(hidden.device.index)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device "
                           f"{hidden.device} has compute capability {cap}")


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def policy_loss_fwd(hidden, w, targets, logp_old, advantages, mask,
                    sigma: float) -> torch.Tensor:
    """Per-block partial sums [ceil(N / BLOCK_N), 8] f32 (CUDA), or one
    block's [1, 8] from the plain version (CPU)."""
    if hidden.device.type == "cpu":
        return _plain_policy_loss_fwd(hidden, w, targets, logp_old,
                                      advantages, mask, sigma)
    check_policy_loss_args(hidden, w, targets, logp_old, advantages, mask)
    n, d = hidden.shape
    nb = -(-n // BLOCK_N)
    partials = torch.empty((nb, N_COLS), dtype=torch.float32,
                           device=hidden.device)
    lib = build.load()
    with torch.cuda.device(hidden.device):
        err = lib.policy_loss_fwd(
            hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
            logp_old.data_ptr(), advantages.data_ptr(), mask.data_ptr(),
            partials.data_ptr(), n, d, w.shape[1],
            _DTYPE_CODES[hidden.dtype], float(sigma),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err)
    _count(policy_loss_fwd)
    return partials


def policy_loss_bwd(hidden, w, targets, logp_old, advantages, mask,
                    sigma: float, coefs: torch.Tensor):
    """(dh [N,d] in hidden's dtype, dw [d,Va] in w's dtype) for the f32
    coefficient row ``coefs`` = (c_pg, c_kl, c_ent)."""
    if hidden.device.type == "cpu":
        return _plain_policy_loss_bwd(hidden, w, targets, logp_old,
                                      advantages, mask, sigma, coefs)
    check_policy_loss_args(hidden, w, targets, logp_old, advantages, mask)
    if coefs.dtype != torch.float32 or tuple(coefs.shape) != (3,) \
            or coefs.device != hidden.device or not coefs.is_contiguous():
        raise ValueError("coefs must be a contiguous float32 (3,) tensor "
                         "on the hidden's device")
    n, d = hidden.shape
    va = w.shape[1]
    dh = torch.empty_like(hidden)
    dlogits = torch.empty((n, va), dtype=torch.float32, device=hidden.device)
    dw = torch.empty((d, va), dtype=torch.float32, device=hidden.device)
    lib = build.load()
    with torch.cuda.device(hidden.device):
        err = lib.policy_loss_bwd(
            hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
            logp_old.data_ptr(), advantages.data_ptr(), mask.data_ptr(),
            coefs.data_ptr(), dh.data_ptr(), dlogits.data_ptr(),
            dw.data_ptr(), n, d, va, _DTYPE_CODES[hidden.dtype],
            float(sigma),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err)
    _count(policy_loss_bwd)
    return dh, dw.to(w.dtype)


policy_loss_fwd.launches = 0
policy_loss_bwd.launches = 0


class _FusedPolicyLoss(torch.autograd.Function):
    """Custom VJP of the reference (l.393-416): the forward kernel, and the
    backward kernel fed the coefficient row of ``_loss_coefs``."""

    @staticmethod
    def forward(ctx, hidden, w, targets, logp_old, advantages, mask, sigma):
        partials = policy_loss_fwd(hidden, w, targets, logp_old, advantages,
                                   mask, sigma)
        pg, ent, kl, m = _finalize(partials.sum(dim=0))
        ctx.save_for_backward(hidden, w, targets, logp_old, advantages, mask)
        ctx.sigma = sigma
        out = (pg, ent, kl, m["ratio_mean"], m["omega_mean"],
               m["stale_frac"])
        ctx.mark_non_differentiable(*out[3:])
        return out

    @staticmethod
    def backward(ctx, ct_pg, ct_ent, ct_kl, *_):
        hidden, w, targets, logp_old, advantages, mask = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        coefs = _loss_coefs(mask, *(zero if c is None else c
                                    for c in (ct_pg, ct_ent, ct_kl)))
        dh, dw = policy_loss_bwd(hidden, w, targets, logp_old, advantages,
                                 mask, ctx.sigma, coefs)
        return dh, dw, None, None, None, None, None


def fused_policy_loss(hidden, w, targets, logp_old, advantages, mask,
                      sigma: float) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """Action head + GIPO/entropy/KL over [N, d] hidden states; ``hidden @
    w`` is formed blockwise inside the kernel. Returns ``(pg_loss, entropy,
    kl, metrics)`` (masked means over the N rows; metrics detached),
    differentiable with respect to ``hidden`` and ``w``."""
    pg, ent, kl, ratio, omega, stale = _FusedPolicyLoss.apply(
        hidden, w, targets, logp_old, advantages, mask, sigma)
    return pg, ent, kl, {"ratio_mean": ratio, "omega_mean": omega,
                         "stale_frac": stale}
