"""Top-k mixture-of-experts with GShard-style grouped capacity dispatch, as
in the reference ``repro/models/moe.py``.

Dispatch is a set of dense products over a per-group [tokens, experts,
capacity] one-hot combine tensor, in the reference's order of arithmetic:
f32 router logits, softmax, top-k (first choice first), renormalised gates;
GShard priority (every first choice in token order, then every second
choice, ...) through an integer cumsum; a token past an expert's capacity
is dropped from that expert. Tokens are processed in fixed-size groups
(``group_tokens``) taken from the row-major [B·T] flattening; the
reference's ``vmap`` over groups is a leading group axis here.

The auxiliary load-balance and router-z losses (scaled by their
coefficients) and the dropped share of assignments are returned so the RL
train step can fold them into the GIPO objective. The reference has no
Pallas kernel here; the products stay ``torch.einsum``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, dense_init, stacked_dense_init

GROUP_TOKENS = 512


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
             device="cuda") -> Params:
    """One layer's parameters drawn on ``device`` from ``gen`` (a generator
    on that device): the router in f32 (the reference's one f32 weight of
    the block), the experts' SwiGLU weights in ``dtype``."""
    device = resolve_device(device)
    e, ff = cfg.num_experts, cfg.d_ff
    return {
        "router": dense_init(gen, (d_model, e), torch.float32, device),
        "w_gate": dense_init(gen, (e, d_model, ff), dtype, device),
        "w_up": dense_init(gen, (e, d_model, ff), dtype, device),
        "w_down": dense_init(gen, (e, ff, d_model), dtype, device),
    }


def stacked_moe_init(gen: torch.Generator, n: int, d_model: int,
                     cfg: MoEConfig, dtype, device="cuda") -> Params:
    """``n`` layers of ``moe_init``'s leaves, stacked on a leading axis
    (each leaf drawn one layer at a time)."""
    device = resolve_device(device)
    e, ff = cfg.num_experts, cfg.d_ff
    return {
        "router": stacked_dense_init(gen, n, (d_model, e), torch.float32,
                                     device),
        "w_gate": stacked_dense_init(gen, n, (e, d_model, ff), dtype, device),
        "w_up": stacked_dense_init(gen, n, (e, d_model, ff), dtype, device),
        "w_down": stacked_dense_init(gen, n, (e, ff, d_model), dtype, device),
    }


def capacity(group_tokens: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * group_tokens * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.top_k)


def _group_dispatch(params: Params, xg: torch.Tensor, cfg: MoEConfig,
                    cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xg: [..., n, d], one token group per leading index. Returns (out
    [..., n, d], logits [..., n, e] f32, keep [..., n, k] bool)."""
    n = xg.shape[-2]
    e, k = cfg.num_experts, cfg.top_k
    lead = xg.shape[:-2]

    logits = xg.float() @ params["router"]                          # [.., n, e]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    onehot = F.one_hot(expert_idx, e)                               # [.., n, k, e]
    # GShard priority: all 1st choices, then 2nd choices, ...
    prio = onehot.transpose(-3, -2).reshape(lead + (k * n, e))
    pos_prio = torch.cumsum(prio, dim=-2) - prio
    within = (pos_prio.reshape(lead + (k, n, e)).transpose(-3, -2)
              * onehot).sum(-1)                                     # [.., n, k]
    keep = within < cap
    gates = (gate_vals * keep).to(xg.dtype)

    cap_onehot = F.one_hot(torch.where(keep, within, cap),
                           cap + 1).to(xg.dtype)[..., :cap]         # [.., n, k, cap]
    # "nk,nke,nkc->nec": the k choices of a token go to distinct experts,
    # so each (n, e, c) sums one nonzero term, the gate, exactly
    weighted = gates[..., None] * onehot.to(xg.dtype)               # [.., n, k, e]
    combine = weighted.transpose(-1, -2) @ cap_onehot               # [.., n, e, cap]
    dispatch = (combine > 0).to(xg.dtype)

    expert_in = torch.einsum("...nd,...nec->...ecd", xg, dispatch)  # [.., e, cap, d]
    h = F.silu(torch.einsum("...ecd,edf->...ecf", expert_in,
                            params["w_gate"]))
    h = h * torch.einsum("...ecd,edf->...ecf", expert_in, params["w_up"])
    expert_out = torch.einsum("...ecf,efd->...ecd", h, params["w_down"])
    out = torch.einsum("...ecd,...nec->...nd", expert_out, combine)
    return out, logits, keep


def moe_forward(params: Params, x: torch.Tensor, cfg: MoEConfig,
                group_tokens: int = GROUP_TOKENS
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, d] -> (out [B, T, d], aux losses). The B·T tokens form
    ``g = max(B·T // group_tokens, 1)`` equal groups; where B·T is not a
    multiple of g the reference's reshape fails, and so does this (a
    ``ValueError``: padding would route differently)."""
    b, t, d = x.shape
    n = b * t
    g = max(n // group_tokens, 1)
    if n % g:
        raise ValueError(
            f"moe_forward: {b} x {t} = {n} tokens do not split into {g} "
            f"equal groups (group_tokens {group_tokens}, {n} % {g} = "
            f"{n % g})")
    ng = n // g
    cap = capacity(ng, cfg)
    out, logits, keep = _group_dispatch(params, x.reshape(g, ng, d), cfg,
                                        cap)

    e = cfg.num_experts
    logits2 = logits.reshape(n, e)
    probs2 = torch.softmax(logits2, dim=-1)
    top1 = probs2.argmax(dim=-1)
    me = probs2.mean(dim=0)
    ce = F.one_hot(top1, e).float().mean(dim=0)
    load_balance = e * (me * ce).sum()
    router_z = torch.logsumexp(logits2, dim=-1).square().mean()
    aux = {
        "load_balance": cfg.load_balance_coef * load_balance,
        "router_z": cfg.router_z_coef * router_z,
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return out.reshape(b, t, d), aux
