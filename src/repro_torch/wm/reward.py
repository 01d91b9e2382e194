"""M_reward — the "virtual referee" (paper §4), as in the reference
``repro/wm/reward.py``: a binary success classifier over frames, regressed
on real (o_t, success_t) pairs from B_wm every ``reward_train_interval``
cycles. Its success probability drives both the potential-based imagined
reward (eq. 4) and the imagined termination signal."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init
from repro_torch.optim import adamw


def reward_init(gen: torch.Generator, frame_dim: int,
                hidden: int = 128) -> Params:
    """Random classifier parameters, drawn from ``gen`` on its device."""
    dev, f32 = gen.device, torch.float32
    return {
        "w1": dense_init(gen, (frame_dim, hidden), f32, dev),
        "b1": torch.zeros((hidden,), dtype=f32, device=dev),
        "w2": dense_init(gen, (hidden, hidden), f32, dev),
        "b2": torch.zeros((hidden,), dtype=f32, device=dev),
        "w3": dense_init(gen, (hidden, 1), f32, dev),
        "b3": torch.zeros((1,), dtype=f32, device=dev),
    }


def reward_logit(params: Params, frames: torch.Tensor) -> torch.Tensor:
    h = F.silu(frames @ params["w1"] + params["b1"])
    h = F.silu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"] + params["b3"])[..., 0]


def reward_apply(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Success probability M_reward(o) ∈ (0, 1). frames: [B, F] -> [B]."""
    return torch.sigmoid(reward_logit(params, frames))


def reward_loss(params: Params, frames: torch.Tensor,
                success: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on real success labels (the stable form)."""
    logit = reward_logit(params, frames)
    return torch.mean(logit.clamp_min(0) - logit * success
                      + torch.log1p(torch.exp(-logit.abs())))


def make_reward_train_step(lr: float = 1e-4):
    """One AdamW step (no weight decay) on the BCE, by autograd over the
    plain function (``adamw.grad_step``); ``params`` and ``opt`` are
    updated in place."""
    def step(params, opt, frames, success):
        return adamw.grad_step(
            lambda p: reward_loss(p, frames, success), params, opt, lr)
    return step
