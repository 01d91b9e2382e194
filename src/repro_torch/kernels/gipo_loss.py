"""The fused GIPO/entropy/KL loss: the CUDA kernels ``csrc/gipo_loss.cu``
and their plain PyTorch versions, at two fusion levels.

**K4, hidden level** (``fused_policy_loss``). Replaces the Pallas TPU
kernels of ``repro/kernels/gipo_loss.py`` (``_policy_fwd_kernel`` /
``_policy_bwd_kernel`` behind the custom VJP of ``fused_policy_loss``).
Forward: ``hidden @ w`` in f32 → log-softmax → target gather → Gaussian
trust weight ω (eq. 5, constant) → surrogate (eq. 6), entropy, k3-KL and a
stale flag, summed over a few token rows into rows of the 8 partial-sum
columns of ``N_COLS``; the sum over those rows and ``_finalize`` are plain
torch. Backward: the logits are recomputed, ``_block_dlogits`` gives ``d``
with the coefficient row of ``_loss_coefs``, then ``dh = d·wᵀ`` in hidden's
dtype and ``dw = Σ hᵀ·d`` in w's dtype. Gradients flow to ``hidden`` and
``w`` only. bf16 runs the tensor-core body: a thread-block cluster of up
to 16 CTAs splits d into slices (``policy_slice``), each rank forms its
slice's partial logits of 32 token rows on the tensor cores, the ranks
sum them through distributed shared memory, and the backward forms dh and
dw on the tensor cores with d in three bf16 terms; its order of
arithmetic is ``ref.tiled_policy_loss``. f32 runs the FMA body (16 rows a
CTA). ``policy_body`` says which a shape takes.

**K5, logits level** (``gipo_head_loss``). Replaces ``_gipo_fwd_kernel`` /
``_gipo_bwd_kernel`` behind the custom VJP of the reference's
``gipo_head_loss``: the same per-row terms over given ``[N, V]`` logits
(f32 or bf16, any V); the backward writes ``d_logits`` in the logits'
dtype. Gradients flow to ``logits`` only. Up to V 1024 the register body
runs: persistent CTAs bulk-copy blocks of rows into a shared-memory ring a
step ahead, a row is split over 4 to 32 lanes and held in registers, each
element's exponential taken once (base 2); its order of arithmetic is
``ref.tiled_gipo_head_loss`` with the layout ``head_layout`` reports. Past
V 1024 the streaming body (one warp a row) walks the row. ``head_body``
says which a shape takes.

Targets, μ, advantages and mask are constants at both levels. Both share
the block math below (``_softmax_rows``, ``_fwd_partials``,
``_block_dlogits``, ``_finalize``, ``_loss_coefs``), as the reference's
kernels share theirs, and the CUDA kernels share their per-row terms.

``fused_policy_loss`` and ``gipo_head_loss`` are ``torch.autograd.Function``s:
CUDA tensors launch the kernels (raising on anything they do not take), CPU
tensors take the plain versions. ``policy_loss_fwd.launches``,
``policy_loss_bwd.launches``, ``gipo_head_fwd.launches`` and
``gipo_head_bwd.launches`` count kernel launches, ``policy_loss_fwd.tc``
and ``policy_loss_bwd.tc`` those of K4 on its tensor-core body.
``plain_policy_loss`` and ``plain_gipo_head_loss`` are the autodiffed
plain routes (the reference's jnp twins), which ``dispatch.forced("torch")``
selects.
"""
from __future__ import annotations

import threading
import types
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _capability

# Column layout of the per-block partial sums (padded to 8):
#   0: Σ pg        1: Σ ratio   2: Σ omega   3: Σ mask (token count)
#   4: Σ entropy   5: Σ k3-KL   6: Σ stale   7: unused
N_COLS = 8
MAX_VA = 256          # a row's logits live in the CTA's shared memory (K4)
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


def _plain_gipo_head_fwd(logits, targets, logp_old, advantages, mask,
                         sigma: float) -> torch.Tensor:
    """K5's forward over all N rows as one block: partial sums [1, 8]
    f32."""
    return _fwd_partials(logits.float(), targets, logp_old, advantages,
                         mask, sigma)[None]


def _plain_gipo_head_bwd(logits, targets, logp_old, advantages, mask,
                         sigma: float, coefs: torch.Tensor) -> torch.Tensor:
    """K5's analytic backward: ``_block_dlogits`` over all N rows at once,
    in the logits' dtype."""
    return _block_dlogits(logits.float(), targets, logp_old, advantages,
                          mask, sigma, coefs[0], coefs[1],
                          coefs[2]).to(logits.dtype)


def plain_gipo_head_loss(logits, targets, logp_old, advantages, mask,
                         sigma: float):
    """K5's forward math autodiffed by torch, with the log-ratio detached
    inside ω (the reference's jnp twin ``_jnp_gipo_loss``)."""
    sums = _fwd_partials(logits.float(), targets, logp_old, advantages, mask,
                         sigma, sg=torch.Tensor.detach)
    return _finalize(sums)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(n, device, named) -> None:
    """The per-row operands: targets int32, the rest float32, all [N],
    contiguous, on ``device``."""
    for name, x in named:
        want = torch.int32 if name == "targets" else torch.float32
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(x.shape)}")
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_capability(device) -> None:
    cap = _capability(device.index)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device "
                           f"{device} has compute capability {cap}")


def check_policy_loss_args(hidden, w, targets, logp_old, advantages,
                           mask) -> None:
    """What K4's CUDA kernels take; anything else raises."""
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
    named = (("hidden", hidden), ("w", w), ("targets", targets),
             ("logp_old", logp_old), ("advantages", advantages),
             ("mask", mask))
    _check_rows(n, hidden.device, named[2:])
    for name, x in named:
        if not x.is_cuda or x.device != hidden.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{hidden.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    _check_capability(hidden.device)


def check_gipo_head_args(logits, targets, logp_old, advantages,
                         mask) -> None:
    """What K5's CUDA kernels take (any N, V >= 1; a row start off a
    16-byte boundary takes scalar loads); anything else raises."""
    if logits.ndim != 2 or logits.shape[0] == 0 or logits.shape[1] == 0:
        raise ValueError(f"want logits [N,V] with N, V >= 1; got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    if not logits.is_cuda:
        raise ValueError(f"logits must be a CUDA tensor, got {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    _check_rows(logits.shape[0], logits.device,
                (("targets", targets), ("logp_old", logp_old),
                 ("advantages", advantages), ("mask", mask)))
    _check_capability(logits.device)


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def policy_slice(hidden, w) -> int:
    """Rows of d that a rank of K4's tensor-core body takes for these CUDA
    inputs (``csrc/gipo_loss.cu::cluster_plan``), or 0 where they run the
    FMA body."""
    n, d = hidden.shape
    return build.load().policy_loss_slice(n, d, w.shape[1],
                                          _DTYPE_CODES[hidden.dtype])


def policy_body(hidden, w) -> str:
    """Which K4 body ``policy_loss_fwd`` / ``policy_loss_bwd`` launch for
    these CUDA inputs: "tensor cores" (bf16) or "fma" (f32)."""
    return "tensor cores" if policy_slice(hidden, w) else "fma"


def policy_loss_fwd(hidden, w, targets, logp_old, advantages, mask,
                    sigma: float) -> torch.Tensor:
    """Partial sums [R, 8] f32, each row a sum over a few token rows (CUDA:
    R = ceil(N / 32) x the cluster's ranks on the tensor-core body,
    ceil(N / 16) on the FMA body), or one block's [1, 8] from the plain
    version (CPU)."""
    if hidden.device.type == "cpu":
        return _plain_policy_loss_fwd(hidden, w, targets, logp_old,
                                      advantages, mask, sigma)
    check_policy_loss_args(hidden, w, targets, logp_old, advantages, mask)
    n, d = hidden.shape
    va, code = w.shape[1], _DTYPE_CODES[hidden.dtype]
    lib = build.load()
    partials = torch.empty((lib.policy_loss_partial_rows(n, d, va, code),
                            N_COLS), dtype=torch.float32,
                           device=hidden.device)
    tc = policy_body(hidden, w) == "tensor cores"
    with torch.cuda.device(hidden.device):
        err = lib.policy_loss_fwd(
            hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
            logp_old.data_ptr(), advantages.data_ptr(), mask.data_ptr(),
            partials.data_ptr(), n, d, va, code, float(sigma),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err)
    _count(policy_loss_fwd)
    if tc:
        _count(policy_loss_fwd.tc)
    return partials


def policy_loss_bwd(hidden, w, targets, logp_old, advantages, mask,
                    sigma: float, coefs: torch.Tensor):
    """(dh [N,d] in hidden's dtype, dw [d,Va] in w's dtype) for the f32
    coefficient row ``coefs`` = (c_pg, c_kl, c_ent). On the card the row
    kernel leaves d in an f32 [N, Va] scratch for the dw kernel, which
    writes dw in w's dtype."""
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
    dw = torch.empty_like(w)
    tc = policy_body(hidden, w) == "tensor cores"
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
    if tc:
        _count(policy_loss_bwd.tc)
    return dh, dw


policy_loss_fwd.launches = 0
policy_loss_bwd.launches = 0
#: K4 launches that ran the tensor-core body (also counted in .launches)
policy_loss_fwd.tc = types.SimpleNamespace(launches=0)
policy_loss_bwd.tc = types.SimpleNamespace(launches=0)


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


def head_layout(logits) -> Tuple[int, int]:
    """(lanes a row, token rows a block) of K5 for these CUDA logits
    (``csrc/gipo_loss.cu::head_plan``): the forward writes one partial row
    a block, a warp's rows on the register body; lanes is 0 where the
    shape runs the streaming body (one warp a row, 8 rows a block)."""
    n, v = logits.shape
    lib, code = build.load(), _DTYPE_CODES[logits.dtype]
    return (lib.gipo_head_lanes(n, v, code),
            lib.gipo_head_block_rows(n, v, code))


def head_body(logits) -> str:
    """Which K5 body ``gipo_head_fwd`` / ``gipo_head_bwd`` launch for these
    CUDA logits: "registers" (V <= 1024) or "streaming"."""
    return "registers" if head_layout(logits)[0] else "streaming"


def gipo_head_fwd(logits, targets, logp_old, advantages, mask,
                  sigma: float) -> torch.Tensor:
    """K5 forward: partial sums [R, 8] f32, each a sum over a block of
    token rows (``head_layout``; CUDA: R from the C query
    ``gipo_head_partial_rows``), or one block's [1, 8] from the plain
    version (CPU)."""
    if logits.device.type == "cpu":
        return _plain_gipo_head_fwd(logits, targets, logp_old, advantages,
                                    mask, sigma)
    check_gipo_head_args(logits, targets, logp_old, advantages, mask)
    n, v = logits.shape
    lib = build.load()
    partials = torch.empty((lib.gipo_head_partial_rows(
        n, v, _DTYPE_CODES[logits.dtype]), N_COLS), dtype=torch.float32,
        device=logits.device)
    with torch.cuda.device(logits.device):
        err = lib.gipo_head_fwd(
            logits.data_ptr(), targets.data_ptr(), logp_old.data_ptr(),
            advantages.data_ptr(), mask.data_ptr(), partials.data_ptr(), n,
            v, _DTYPE_CODES[logits.dtype], float(sigma),
            torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err)
    _count(gipo_head_fwd)
    return partials


def gipo_head_bwd(logits, targets, logp_old, advantages, mask, sigma: float,
                  coefs: torch.Tensor) -> torch.Tensor:
    """K5 backward: ``d_logits`` [N, V] in the logits' dtype for the f32
    coefficient row ``coefs`` = (c_pg, c_kl, c_ent)."""
    if logits.device.type == "cpu":
        return _plain_gipo_head_bwd(logits, targets, logp_old, advantages,
                                    mask, sigma, coefs)
    check_gipo_head_args(logits, targets, logp_old, advantages, mask)
    if coefs.dtype != torch.float32 or tuple(coefs.shape) != (3,) \
            or coefs.device != logits.device or not coefs.is_contiguous():
        raise ValueError("coefs must be a contiguous float32 (3,) tensor "
                         "on the logits' device")
    n, v = logits.shape
    # d_logits starts at the logits' offset within 16 bytes, so that the
    # kernel's 16-byte loads and stores line up in every row
    lead = logits.data_ptr() % 16 // logits.element_size()
    d = torch.empty(lead + n * v, dtype=logits.dtype,
                    device=logits.device)[lead:].view(n, v)
    lib = build.load()
    with torch.cuda.device(logits.device):
        err = lib.gipo_head_bwd(
            logits.data_ptr(), targets.data_ptr(), logp_old.data_ptr(),
            advantages.data_ptr(), mask.data_ptr(), coefs.data_ptr(),
            d.data_ptr(), n, v, _DTYPE_CODES[logits.dtype], float(sigma),
            torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err)
    _count(gipo_head_bwd)
    return d


gipo_head_fwd.launches = 0
gipo_head_bwd.launches = 0


class _GipoHeadLoss(torch.autograd.Function):
    """Custom VJP of the reference's ``gipo_head_loss`` (l.232-256): the
    forward kernel, and the backward kernel fed the coefficient row of
    ``_loss_coefs``."""

    @staticmethod
    def forward(ctx, logits, targets, logp_old, advantages, mask, sigma):
        partials = gipo_head_fwd(logits, targets, logp_old, advantages, mask,
                                 sigma)
        pg, ent, kl, m = _finalize(partials.sum(dim=0))
        ctx.save_for_backward(logits, targets, logp_old, advantages, mask)
        ctx.sigma = sigma
        out = (pg, ent, kl, m["ratio_mean"], m["omega_mean"],
               m["stale_frac"])
        ctx.mark_non_differentiable(*out[3:])
        return out

    @staticmethod
    def backward(ctx, ct_pg, ct_ent, ct_kl, *_):
        logits, targets, logp_old, advantages, mask = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        coefs = _loss_coefs(mask, *(zero if c is None else c
                                    for c in (ct_pg, ct_ent, ct_kl)))
        d = gipo_head_bwd(logits, targets, logp_old, advantages, mask,
                          ctx.sigma, coefs)
        return d, None, None, None, None, None


def gipo_head_loss(logits, targets, logp_old, advantages, mask,
                   sigma: float) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """Fused GIPO surrogate + entropy + k3-KL over [N, V] logits. Returns
    ``(pg_loss, entropy, kl, metrics)`` (masked means over the N rows;
    metrics detached), differentiable with respect to ``logits``."""
    pg, ent, kl, ratio, omega, stale = _GipoHeadLoss.apply(
        logits, targets, logp_old, advantages, mask, sigma)
    return pg, ent, kl, {"ratio_mean": ratio, "omega_mean": omega,
                         "stale_frac": stale}


def gipo_loss_fused(logits, targets, logp_old, advantages, mask,
                    sigma: float) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """logits: [N, V]; targets/logp_old/advantages/mask: [N]. Returns (pg
    loss, metrics with ``entropy`` and ``kl``), as the reference's
    ``gipo_loss_fused``; differentiable with respect to ``logits``."""
    pg, ent, kl, metrics = gipo_head_loss(logits, targets, logp_old,
                                          advantages, mask, sigma)
    return pg, dict(metrics, entropy=ent.detach(), kl=kl.detach())
