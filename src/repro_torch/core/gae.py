"""Generalized Advantage Estimation with just-in-time value recomputation,
as in the reference ``repro/core/gae.py``.

Paper §5 + App. C.1: GAE runs on the values produced by the *training*
forward pass, inside the micro-batch step. Segment layout (paper eq. 2):
arrays carry T+1 entries; index T holds the bootstrap observation's value,
which feeds GAE as the bootstrap target only and is detached.
"""
from __future__ import annotations

from typing import Tuple

import torch


def gae(values: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor,
        discount: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """values: [B, T+1] (index T = bootstrap, caller detaches);
    rewards, dones: [B, T]. Returns (advantages [B, T], returns [B, T]).
    The reference's reverse ``lax.scan`` is a reverse loop over T (T is a
    segment horizon, at most a few tens of steps)."""
    t = rewards.shape[1]
    v_now = values[:, :t]
    v_next = values[:, 1:t + 1]
    nonterm = 1.0 - dones.float()
    deltas = rewards + discount * nonterm * v_next - v_now      # [B, T]
    carry = torch.zeros_like(deltas[:, 0])
    advs = [None] * t
    for j in reversed(range(t)):
        carry = deltas[:, j] + discount * lam * nonterm[:, j] * carry
        advs[j] = carry
    advantages = torch.stack(advs, dim=1)                        # [B, T]
    return advantages, advantages + v_now


def gae_reference(values, rewards, dones, discount, lam):
    """Slow python-loop oracle for tests (numpy, float64)."""
    import numpy as np
    values = np.asarray(values, np.float64)
    rewards = np.asarray(rewards, np.float64)
    dones = np.asarray(dones, np.float64)
    b, t = rewards.shape
    adv = np.zeros((b, t))
    for i in range(b):
        acc = 0.0
        for j in reversed(range(t)):
            nonterm = 1.0 - dones[i, j]
            delta = rewards[i, j] + discount * nonterm * values[i, j + 1] \
                - values[i, j]
            acc = delta + discount * lam * nonterm * acc
            adv[i, j] = acc
    return adv, adv + values[:, :t]


def jit_gae_from_forward(values_with_bootstrap: torch.Tensor,
                         rewards: torch.Tensor, dones: torch.Tensor,
                         discount: float, lam: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values straight from the training forward pass, detached here (App.
    C.1: 'the target value node must be detached from the graph')."""
    return gae(values_with_bootstrap.detach(), rewards, dones, discount, lam)
