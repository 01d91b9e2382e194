"""Grouped-query attention: the training forward, prefill (emitting the
KV cache) and single-token decode, as in the reference
``repro/models/attention.py``.

The cache may be a ring buffer (``cache_len < t``): slot = pos % cache_len.
Training and prefill attention go through ``dispatch.dense_attention``
(differentiable) and decode attention through ``dispatch.decode_attention``:
the CUDA kernels for CUDA tensors, the plain versions on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.layers import Params, apply_rope, stacked_dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    """KV cache; ``positions`` carries absolute positions (ring buffers
    overwrite slots out of order). ``length`` = tokens seen so far."""

    k: torch.Tensor            # [B, S_cache, KV, D]
    v: torch.Tensor            # [B, S_cache, KV, D]
    positions: torch.Tensor    # [B, S_cache] int32, -1 = empty
    length: torch.Tensor       # [B] int32


def stacked_attention_init(gen, n: int, d_model: int, num_heads: int,
                           num_kv_heads: int, head_dim: int, dtype,
                           device) -> Params:
    """``n`` layers' attention weights, stacked on a leading axis."""
    def w(shape):
        return stacked_dense_init(gen, n, shape, dtype, device)
    return {
        "wq": w((d_model, num_heads, head_dim)),
        "wk": w((d_model, num_kv_heads, head_dim)),
        "wv": w((d_model, num_kv_heads, head_dim)),
        "wo": w((num_heads, head_dim, d_model)),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,T,d] @ w [d,H,D] -> [B,T,H,D]."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:2], h, hd)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o [B,T,H,D] @ wo [H,D,d] -> [B,T,d]."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:2], h * hd) @ wo.reshape(h * hd, d)


def _project_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                 rope_theta: float):
    q = apply_rope(_proj(x, params["wq"]), positions, rope_theta)
    k = apply_rope(_proj(x, params["wk"]), positions, rope_theta)
    v = _proj(x, params["wv"])
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,T,H,D], k: [B,S,KV,D] -> scores [B,H,T,S] f32 (head-grouped;
    the products are exact in f32 and accumulate in f32)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    return scores.reshape(b, h, t, k.shape[1])


def _gqa_combine(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights: [B,H,T,S], v: [B,S,KV,D] -> [B,T,H,D]."""
    b, h, t, s = weights.shape
    kv = v.shape[2]
    wg = weights.reshape(b, kv, h // kv, t, s)
    out = torch.einsum("bkgts,bskd->btkgd", wg, v)
    return out.reshape(b, t, h, v.shape[3])


def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, cache_len, num_kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, cache_len, num_kv_heads, head_dim), dtype=dtype,
                      device=device),
        positions=torch.full((batch, cache_len), -1, dtype=torch.int32,
                             device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def attention_forward(params: Params, x: torch.Tensor, *, rope_theta: float,
                      window: Optional[int] = None,
                      positions: Optional[torch.Tensor] = None,
                      block: Optional[int] = None) -> torch.Tensor:
    """Full causal self-attention for training / teacher-forced scoring
    (the reference's dense path). The reference's blockwise path for
    ``t > block`` is not ported yet and raises."""
    b, t, _ = x.shape
    if block is not None and t > block:
        raise NotImplementedError(
            f"blockwise attention (t={t} > block={block}) is not ported yet")
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, positions, rope_theta)
    out = dispatch.dense_attention(q, k, v, window=window)
    return _out_proj(out, params["wo"])


def attention_prefill(params: Params, x: torch.Tensor, *, rope_theta: float,
                      cache_len: int, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; emits the populated KV cache.
    (The reference's blockwise ``block`` path is training-only and belongs
    to a later slice.)"""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, positions, rope_theta)
    out = dispatch.dense_attention(q, k, v, window=window)
    out = _out_proj(out, params["wo"])

    pos = positions.expand(b, t).to(torch.int32)
    if cache_len >= t:
        cache = init_cache(b, cache_len, k.shape[2], k.shape[3], k.dtype,
                           x.device)
        cache.k[:, :t] = k
        cache.v[:, :t] = v
        cache.positions[:, :t] = pos
        k_c, v_c, pos_c = cache.k, cache.v, cache.positions
    else:  # ring buffer keeps the last ``cache_len`` tokens
        k_c = k[:, t - cache_len:]
        v_c = v[:, t - cache_len:]
        pos_c = pos[:, t - cache_len:]
        # ring layout: slot = pos % cache_len
        inv = torch.argsort(pos_c[0] % cache_len)
        k_c, v_c = k_c[:, inv].contiguous(), v_c[:, inv].contiguous()
        pos_c = pos_c[:, inv].contiguous()
    cache = KVCache(k=k_c, v=v_c, positions=pos_c,
                    length=torch.full((b,), t, dtype=torch.int32,
                                      device=x.device))
    return out, cache


def attention_decode(params: Params, x: torch.Tensor, cache: KVCache, *,
                     rope_theta: float, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One new token per sequence. x: [B, 1, d].

    The new key/value row is scattered per batch row into slot
    ``pos % cache_len`` (the reference's scatter variant). The port writes
    it IN PLACE into ``cache.k``, ``cache.v`` and ``cache.positions`` (the
    returned cache shares those tensors), where the reference returns
    fresh arrays."""
    b = x.shape[0]
    cache_len = cache.k.shape[1]
    pos = cache.length                                       # [B]
    q = apply_rope(_proj(x, params["wq"]), pos[:, None], rope_theta)
    k_new = apply_rope(_proj(x, params["wk"]), pos[:, None], rope_theta)
    v_new = _proj(x, params["wv"])

    slot = (pos % cache_len).long()   # ring layout (== pos when S_cache > pos)
    b_idx = torch.arange(b, device=x.device)
    cache.k[b_idx, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[b_idx, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.positions[b_idx, slot] = pos
    pos_c = cache.positions

    valid = pos_c >= 0                                       # [B,S]
    if window is not None:
        valid &= (pos[:, None] - pos_c) < window
    valid &= pos_c <= pos[:, None]
    out = dispatch.decode_attention(q, cache.k, cache.v, valid)
    out = _out_proj(out, params["wo"])
    return out, KVCache(k=cache.k, v=cache.v, positions=pos_c,
                        length=pos + 1)
