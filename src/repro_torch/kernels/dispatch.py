"""Kernel routing for the model code.

Routing by device belongs to the kernel wrappers: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
CUDA kernel, which raises if the shape, dtype, layout or device is not one
it takes. There is no fallback and no environment variable between the two.

``dense_attention`` is differentiable: with grad enabled and an input
that requires it, it runs ``FlashAttentionFn`` (flash forward saving the
LSE, flash backward), otherwise the forward kernel alone, as in serving.
``policy_head_loss`` is the fused action head + GIPO loss (K4), and
``gipo_loss`` the same loss over given logits (K5).
``ssd_scan`` is the Mamba2 SSD scan of a fresh sequence (K6 forward, K7
backward), differentiable in the same way.

This module adds only the override ``set_mode`` / ``forced`` (mirroring the
reference's ``repro.kernels.dispatch``), which tests and ``chip_smoke.py``
use to run the plain route on the card for comparison:

  ``None`` (route by device) | ``"cuda"`` (kernel; a CPU tensor raises) |
  ``"torch"`` (plain version on any device).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import gipo_loss as _gl
from repro_torch.kernels.ssd_scan import (SSDScanFn, plain_ssd_scan,
                                          ssd_scan as _kernel_ssd_scan)
from repro_torch.kernels.decode_attention import (_plain_decode,
                                                  decode_attention as
                                                  _kernel_decode)
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 _plain_dense,
                                                 flash_attention)

_MODES = ("cuda", "torch")
_override: Optional[str] = None


def set_mode(mode: Optional[str]) -> None:
    """Process-wide override; ``None`` restores routing by device."""
    global _override
    if mode is not None and mode not in _MODES:
        raise ValueError(f"mode must be None or one of {_MODES}, got {mode!r}")
    _override = mode


@contextlib.contextmanager
def forced(mode: str):
    """Temporarily force a route (tests, chip_smoke.py)."""
    prev = _override
    set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


def _forced_plain(x: torch.Tensor) -> bool:
    """True if the override sends this call to the plain version."""
    if _override == "cuda" and not x.is_cuda:
        raise ValueError("dispatch forced to 'cuda' but the tensor is on "
                         f"{x.device}; the CUDA kernels take CUDA tensors")
    return _override == "torch"


def dense_attention(q, k, v, *, window: Optional[int] = None):
    """Dense causal attention over the prompt (T == S, no KV cache).
    q: [B,T,H,D]; k/v: [B,T,KV,D] -> [B,T,H,D] in q.dtype."""
    if _forced_plain(q):
        return _plain_dense(q, k, v, causal=True, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, window)
    return flash_attention(q, k, v, causal=True, window=window)


def policy_head_loss(hidden, w, targets, logp_old, advantages, mask, *,
                     sigma: float):
    """Fused action head + GIPO/entropy/KL loss. hidden: [N, d]; w: [d, Va];
    targets (int32), logp_old, advantages, mask: [N] -> (pg, entropy, kl,
    metrics). The kernel route never writes an [N, Va] softmax; the plain
    route (``forced("torch")``) autodiffs the same forward math."""
    if _forced_plain(hidden):
        return _gl.plain_policy_loss(hidden, w, targets, logp_old,
                                     advantages, mask, sigma)
    return _gl.fused_policy_loss(hidden, w, targets, logp_old, advantages,
                                 mask, sigma)


def gipo_loss(logits, targets, logp_old, advantages, mask, *,
              sigma: float):
    """Logits-level fused GIPO/entropy/KL loss (K5). logits: [N, V];
    targets (int32), logp_old, advantages, mask: [N] -> (pg, entropy, kl,
    metrics), differentiable with respect to ``logits``; the plain route
    (``forced("torch")``) autodiffs the same forward math. The reference's
    ``block_n`` and ``mode`` choose its TPU tiling and its environment
    routing; the kernel picks its own rows, and routing is by device."""
    if _forced_plain(logits):
        return _gl.plain_gipo_head_loss(logits, targets, logp_old,
                                        advantages, mask, sigma)
    return _gl.gipo_head_loss(logits, targets, logp_old, advantages, mask,
                              sigma)


def decode_attention(q, k, v, valid):
    """Single-token attention decode. q: [B,1,H,D]; k/v: [B,S,KV,D];
    valid: [B,S] bool -> [B,1,H,D] in q.dtype."""
    if _forced_plain(q):
        return _plain_decode(q, k, v, valid)
    return _kernel_decode(q, k, v, valid)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked Mamba2 SSD scan of a fresh sequence (no carried state).
    x: [B,T,H,P]; dt: [B,T,H] (f32, post-softplus); A: [H] (negative);
    Bm/Cm: [B,T,N] (single group). Returns (y [B,T,H,P] f32, final state
    [B,H,P,N] f32).

    Every length goes to the kernel wrappers: ``SSDScanFn`` (K6 saving
    entering states, K7 as its backward) when grad is on and an input needs
    it, else K6 alone; on a CPU tensor the wrappers run the plain chunked
    form. (The reference sends only ``T >= chunk and T % chunk == 0`` to its
    Pallas kernel, a TPU tiling limit; the CUDA kernels take a short last
    chunk.) The kernels take contiguous inputs, so views are copied first."""
    if _forced_plain(x):
        return plain_ssd_scan(x, dt, A, Bm, Cm, chunk)
    args = [v.contiguous() for v in (x, dt, A, Bm, Cm)]
    if torch.is_grad_enabled() and any(v.requires_grad for v in args):
        return SSDScanFn.apply(*args, chunk)
    return _kernel_ssd_scan(*args, chunk=chunk)
