"""Common model primitives: RMSNorm, RoPE, SwiGLU, embeddings, init.

Plain functions over plain-dict parameter trees, as in the reference
(``repro/models/layers.py``); keys match the reference's tree paths.

``tp`` (a ``sharding.spmd.TensorParallel``, or ``None``) runs a layer on
the rank's shards of a tensor-parallel step program: the MLP on its
``d_ff`` columns, the embedding on its vocabulary rows.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in f32 on ``device`` from
    ``gen``, then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / (fan_in ** 0.5)
    out = torch.empty(shape, dtype=dtype, device=device)
    tmp = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out.copy_(tmp.mul_(std))
    return out


def stacked_dense_init(gen: torch.Generator, n: int, shape, dtype, device,
                       scale: float = 1.0) -> torch.Tensor:
    """``n`` independent ``dense_init`` draws stacked on a leading axis,
    one slice at a time so the f32 draw never holds the whole leaf."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = dense_init(gen, shape, dtype, device, scale)
    return out


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """Computed in f32 with the scale in f32, then cast back."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding (split halves, not interleaved pairs)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # [D/2]
    angles = positions[..., None].float() * freqs                # [..., T, D/2]
    angles = angles[..., None, :]                                # [..., T, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def mlp(params: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU; under ``tp`` on the rank's ``d_ff`` columns (``w_gate``,
    ``w_up``) and rows (``w_down``), the partial sums all-reduced."""
    if tp is not None:
        x = tp.enter(x)
    gate = F.silu(x @ params["w_gate"])
    out = (gate * (x @ params["w_up"])) @ params["w_down"]
    return out if tp is None else tp.reduce(out)


# --------------------------------------------------------------------------
# Embedding + slimmed action head
# --------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Table rows; under ``tp`` the table is the rank's vocabulary rows
    (``TensorParallel.embed``)."""
    if tp is not None:
        return tp.embed(params["table"], tokens)
    return params["table"][tokens]


def action_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    # logits in f32 for a numerically stable softmax downstream
    return (x @ params["w"]).float()
