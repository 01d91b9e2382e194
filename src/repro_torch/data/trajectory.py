"""Trajectory batches: the wire format between rollout and trainer, as in
the reference ``repro/data/trajectory.py``.

Paper eq. 2:  τ = (o_{1:T+1}, a_{1:T}, r_{1:T}, μ_{1:T}, v_{1:T}, ṽ_{T+1}, done)

Arrays indexed 0..T carry T+1 entries; index T is the bootstrap slot
(observation o_{T+1}; its action/logp entries are padding). ``mask`` marks
valid *steps* (0..T−1). The leaves are numpy arrays on the host (as
``dummy_batch`` makes them) or tensors on a device
(``repro_torch.bridge.batch_from_numpy``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np


class TrajectoryBatch(NamedTuple):
    obs_tokens: Any                  # [B, T+1, T_obs] i32
    actions: Any                     # [B, T+1, A] i32 (index T = padding)
    behavior_logp: Any               # [B, T+1, A] f32  (μ)
    behavior_value: Any              # [B, T+1] f32     (v at collection)
    rewards: Any                     # [B, T] f32
    dones: Any                       # [B, T] f32 (natural termination)
    steps: Any                       # [B, T+1] i32 episode-step index
    mask: Any                        # [B, T] f32 valid steps
    policy_version: Any              # [B] i32 — version of μ (staleness)
    prefix_embeds: Optional[Any] = None   # [B, T+1, P, F] f32

    @property
    def horizon(self) -> int:
        return self.rewards.shape[1]

    def num_steps(self):
        return self.mask.sum()


def dummy_batch(batch: int, horizon: int, t_obs: int, action_dim: int,
                vocab: int, action_vocab: int,
                num_prefix: int = 0, frontend_dim: int = 1024,
                seed: int = 0) -> TrajectoryBatch:
    """Random but well-formed batch of numpy arrays, with the reference's
    draws from ``np.random.default_rng(seed)`` in the reference's order, so
    both packages get identical data from one seed."""
    rng = np.random.default_rng(seed)
    tp1 = horizon + 1
    prefix = None
    if num_prefix:
        prefix = rng.standard_normal(
            (batch, tp1, num_prefix, frontend_dim)).astype(np.float32)
    return TrajectoryBatch(
        obs_tokens=rng.integers(0, vocab, (batch, tp1, t_obs)).astype(np.int32),
        actions=rng.integers(0, action_vocab,
                             (batch, tp1, action_dim)).astype(np.int32),
        behavior_logp=np.log(
            rng.uniform(0.05, 0.9, (batch, tp1, action_dim))
        ).astype(np.float32),
        behavior_value=rng.standard_normal((batch, tp1)).astype(np.float32),
        rewards=rng.uniform(-1, 1, (batch, horizon)).astype(np.float32),
        dones=(rng.uniform(size=(batch, horizon)) < 0.05).astype(np.float32),
        steps=np.tile(np.arange(tp1, dtype=np.int32), (batch, 1)),
        mask=np.ones((batch, horizon), np.float32),
        policy_version=np.zeros((batch,), np.int32),
        prefix_embeds=prefix,
    )
