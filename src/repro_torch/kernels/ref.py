"""Oracles for the attention kernels: the dense allclose target, and the
kernels' own order of arithmetic for holding their bf16 bodies tightly."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_TILE = 64          # keys per tile in csrc/flash_attention.cu and
                          # csrc/decode_attention.cu


def tiled_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, ok: torch.Tensor,
                            *, tile: int = KERNEL_TILE
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention in the CUDA kernels' order of arithmetic, in f32.

    Keys go in tiles of ``tile``; scores are ``(q . k) * scale`` in f32; the
    running max starts at NEG_INF; ``P = exp(s - m)`` is rounded to
    ``q.dtype`` before the value product while ``l`` sums the unrounded P.
    q: [B,T,H,D]; k/v: [B,S,KV,D]; ok: bool, broadcastable to [B,H,T,S].
    Returns the output before its final rounding [B,T,H,D] f32 and the
    log-sum-exp [B,T,H] f32.

    Given inputs whose dot products are exact in f32 in any order, the
    kernels' P are bit-identical to these, so their bf16 output lies within
    half a bf16 ulp of this one plus f32 reordering error."""
    b, t, h, d = q.shape
    s, group = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)                            # [B,H,T,D]
    kf = k.float().repeat_interleave(group, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, 2).transpose(1, 2)
    ok = ok.expand(b, h, t, s)
    m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, t, 1), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    for s0 in range(0, s, tile):
        sc = (qf @ kf[:, :, s0:s0 + tile].transpose(-1, -2)) * (d ** -0.5)
        sc = sc.masked_fill(~ok[..., s0:s0 + tile], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ vf[:, :, s0:s0 + tile]
        m = m_new
    l = l.clamp_min(1e-30)
    return ((acc / l).transpose(1, 2),
            (m + torch.log(l)).squeeze(-1).transpose(1, 2))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Dense GQA attention in f32. q: [B,T,H,D]; k/v: [B,S,KV,D] ->
    [B,T,H,D] in q.dtype."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, t, kv, group, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (d ** -0.5)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
