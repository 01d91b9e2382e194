"""Policy-gradient objectives: GIPO (paper eqs. 5–6) and the PPO baseline,
as in the reference ``repro/core/gipo.py``. These serve the trainer's
reference (non-fused) loss path.

Token-level optimisation (App. D.3): each action token is an independent
decision point; the step advantage is broadcast across the step's action
tokens.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def gaussian_trust_weight(log_ratio_sg: torch.Tensor,
                          sigma: float) -> torch.Tensor:
    """ω(ρ̄; σ) = exp(−½ (log ρ̄ / σ)²)   (eq. 5), on a detached log-ratio."""
    return torch.exp(-0.5 * (log_ratio_sg / sigma).square())


def gipo_loss(logp_new: torch.Tensor, logp_old: torch.Tensor,
              advantages: torch.Tensor, mask: torch.Tensor,
              sigma: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level GIPO surrogate (eq. 6). logp_new/logp_old: [B, T, A];
    advantages: [B, T] (broadcast over A); mask: [B, T]."""
    log_ratio = logp_new - logp_old
    ratio = torch.exp(log_ratio)
    log_ratio_sg = log_ratio.detach()
    omega = gaussian_trust_weight(log_ratio_sg, sigma)
    per_token = -(omega * ratio * advantages[..., None])        # eq. 6
    m = mask[..., None]
    denom = torch.clamp_min(m.sum() * per_token.shape[-1], 1.0)
    loss = torch.sum(per_token * m) / denom
    metrics = {
        "ratio_mean": (torch.sum(ratio * m) / denom).detach(),
        "omega_mean": torch.sum(omega * m) / denom,
        "stale_frac": torch.sum((log_ratio_sg.abs() > 2 * sigma) * m) / denom,
    }
    return loss, metrics


def ppo_loss(logp_new: torch.Tensor, logp_old: torch.Tensor,
             advantages: torch.Tensor, mask: torch.Tensor,
             clip_eps: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level PPO-clip baseline (the ablation's comparison point)."""
    ratio = torch.exp(logp_new - logp_old)
    adv = advantages[..., None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    per_token = -torch.minimum(unclipped, clipped)
    m = mask[..., None]
    denom = torch.clamp_min(m.sum() * per_token.shape[-1], 1.0)
    loss = torch.sum(per_token * m) / denom
    clip_frac = torch.sum(((ratio - 1.0).abs() > clip_eps) * m) / denom
    return loss, {"ratio_mean": (torch.sum(ratio * m) / denom).detach(),
                  "clip_frac": clip_frac.detach()}


def kl_penalty(logp_new: torch.Tensor, logp_old: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """k3 estimator of KL(μ ‖ π): (ρ⁻¹ − 1) + log ρ ≥ 0, low variance."""
    log_ratio = logp_new - logp_old
    k3 = torch.expm1(-log_ratio) + log_ratio
    m = mask[..., None]
    return torch.sum(k3 * m) / torch.clamp_min(m.sum() * k3.shape[-1], 1.0)


def entropy_bonus(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean policy entropy over valid action tokens. logits: [B, T, A, V]."""
    logp = torch.log_softmax(logits, dim=-1)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)            # [B, T, A]
    m = mask[..., None]
    return torch.sum(ent * m) / torch.clamp_min(m.sum() * ent.shape[-1], 1.0)


def value_loss(values: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """0.5 (V − R)² over valid steps; targets are detached by the caller."""
    err = 0.5 * (values - targets).square()
    return torch.sum(err * mask) / torch.clamp_min(mask.sum(), 1.0)
