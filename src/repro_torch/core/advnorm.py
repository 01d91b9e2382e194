"""Lagged global advantage normalisation (paper eq. 8 + App. C.1/C.2), as
in the reference ``repro/core/advnorm.py``.

The current batch is normalised with the *previous* optimizer step's
global statistics; its own packed (sum, sum², count) triple is folded into
a running Welford state at the end of the accumulation window. On one
device the packed triple needs no collective; across devices it is one
all-reduce of a (3,) tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device


class AdvNormState(NamedTuple):
    """Welford running state of the advantage distribution (f32 scalars)."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor      # sum of squared deviations

    @property
    def std(self) -> torch.Tensor:
        var = torch.where(self.count > 1,
                          self.m2 / torch.clamp_min(self.count, 1.0),
                          torch.ones_like(self.m2))
        return torch.sqrt(torch.clamp_min(var, 1e-12))


def init_adv_state(device="cuda") -> AdvNormState:
    """An empty Welford state on ``device``."""
    dev = resolve_device(device)

    def z():
        return torch.zeros((), dtype=torch.float32, device=dev)
    return AdvNormState(count=z(), mean=z(), m2=z())


def local_stats(adv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Packed (sum, sum², count): the one tensor that gets all-reduced."""
    return torch.stack([torch.sum(adv * mask),
                        torch.sum(adv.square() * mask), torch.sum(mask)])


def welford_update(state: AdvNormState,
                   global_stats: torch.Tensor) -> AdvNormState:
    """Chan's parallel Welford merge of a batch (from its packed stats)."""
    s, sq, n = global_stats[0], global_stats[1], global_stats[2]
    n = torch.clamp_min(n, 1e-9)
    batch_mean = s / n
    batch_m2 = sq - n * batch_mean.square()
    total = state.count + n
    delta = batch_mean - state.mean
    new_mean = state.mean + delta * n / total
    new_m2 = state.m2 + batch_m2 + delta.square() * state.count * n / total
    return AdvNormState(count=total, mean=new_mean, m2=new_m2)


def normalize_lagged(adv: torch.Tensor, state: AdvNormState,
                     eps: float = 1e-8) -> torch.Tensor:
    """Â_t = (A_t − μ_{t−1}) / (σ_{t−1} + ε)   (eq. 8). On the very first
    step (count == 0) the advantages pass through unnormalised."""
    has_stats = state.count > 0
    mean = torch.where(has_stats, state.mean, torch.zeros_like(state.mean))
    std = torch.where(has_stats, state.std, torch.ones_like(state.mean))
    return (adv - mean) / (std + eps)
