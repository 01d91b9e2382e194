"""Action-aware attention-pooling value head (paper App. D.2), as in the
reference ``repro/models/value_head.py``.

Pools the action-token hidden states with a learned attention score, adds a
step embedding, and regresses V(o_t) with a small MLP. Hidden states are
detached, so value gradients never reach the policy representation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init


def value_head_init(gen: torch.Generator, hidden_dim: int,
                    max_episode_steps: int, device) -> Params:
    f32 = torch.float32
    return {
        "attn_proj": dense_init(gen, (hidden_dim, 1), f32, device),
        "step_emb": dense_init(gen, (max_episode_steps, hidden_dim), f32,
                               device),
        "mlp_w1": dense_init(gen, (hidden_dim, hidden_dim), f32, device),
        "mlp_b1": torch.zeros((hidden_dim,), dtype=f32, device=device),
        "mlp_w2": dense_init(gen, (hidden_dim, 1), f32, device),
        "mlp_b2": torch.zeros((1,), dtype=f32, device=device),
    }


def value_head(params: Params, hidden_states: torch.Tensor,
               step_t: torch.Tensor) -> torch.Tensor:
    """hidden_states: [B, S, D] (action-token hiddens); step_t: [B] int.
    Returns V(s_t): [B]."""
    h = hidden_states.detach().float()
    e = h @ params["attn_proj"]                          # [B, S, 1]
    alpha = torch.softmax(e, dim=1)
    z_pool = (alpha * h).sum(dim=1)                      # [B, D]
    max_steps = params["step_emb"].shape[0]
    e_step = params["step_emb"][step_t.long().clamp(0, max_steps - 1)]
    x = z_pool + e_step
    # jax.nn.gelu defaults to the tanh approximation
    x = F.gelu(x @ params["mlp_w1"] + params["mlp_b1"], approximate="tanh")
    v = x @ params["mlp_w2"] + params["mlp_b2"]
    return v[:, 0]
