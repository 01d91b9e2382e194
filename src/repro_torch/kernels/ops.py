"""The kernels' public entry points, as the reference's
``repro/kernels/ops.py``: one function per kernel, with the reference's
names and every argument that defines the function.

Each op calls its kernel's wrapper, which routes by device: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor runs the plain
version. The reference's ``block_q``, ``block_k``, ``block_n`` and
``interpret`` are left out: they choose TPU tiles and Pallas's interpret
mode, and the CUDA kernels pick their own tiles. The reference's ``jit``
has no counterpart: the ops run eagerly.

  ``flash_attention_op``   K1, forward only (causal or not, optional window)
  ``gipo_loss_op``         K5: (pg, metrics with entropy and kl)
  ``gipo_head_loss_op``    K5: (pg, entropy, kl, metrics), custom backward
  ``fused_policy_loss_op`` K4: action head + loss, custom backward
  ``ssd_scan_op``          K6, forward only: (y, final state)
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gipo_loss import (fused_policy_loss,
                                           gipo_head_loss, gipo_loss_fused)
from repro_torch.kernels.ssd_scan import ssd_scan


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None):
    """q: [B,T,H,D]; k/v: [B,S,KV,D] -> [B,T,H,D] in q.dtype."""
    return flash_attention(q, k, v, causal=causal, window=window)


def gipo_loss_op(logits, targets, logp_old, advantages, mask, *,
                 sigma: float = 0.2):
    """logits: [N, V]; rest [N] -> (pg loss, metrics)."""
    return gipo_loss_fused(logits, targets, logp_old, advantages, mask,
                           sigma)


def gipo_head_loss_op(logits, targets, logp_old, advantages, mask, *,
                      sigma: float = 0.2):
    """Custom-VJP fused GIPO + entropy + KL -> (pg, ent, kl, metrics)."""
    return gipo_head_loss(logits, targets, logp_old, advantages, mask, sigma)


def fused_policy_loss_op(hidden, w, targets, logp_old, advantages, mask, *,
                         sigma: float = 0.2):
    """Hidden-level fused action head + loss -> (pg, ent, kl, metrics)."""
    return fused_policy_loss(hidden, w, targets, logp_old, advantages, mask,
                             sigma)


def ssd_scan_op(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: [B,T,H,P]; dt: [B,T,H]; A: [H]; Bm/Cm: [B,T,N] -> (y [B,T,H,P]
    f32, final state [B,H,P,N] f32). Any T (the reference's Pallas kernel
    takes T % chunk == 0 only)."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
