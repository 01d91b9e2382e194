"""Grouped-query attention: the training forward, prefill (emitting the
KV cache) and single-token decode, as in the reference
``repro/models/attention.py``.

The cache may be a ring buffer (``cache_len < t``): slot = pos % cache_len.
Training and prefill attention go through ``dispatch.dense_attention``
(differentiable), or, for ``t > block``, ``dispatch.attention`` (the
blockwise path: on the CPU the online-softmax twin ``_blockwise_attn``);
decode attention goes through ``dispatch.decode_attention``: the CUDA
kernels for CUDA tensors, the plain versions on the CPU.

``tp`` (a ``sharding.spmd.TensorParallel``, or ``None``) runs a layer on
the rank's heads in a tensor-parallel step program: ``wq`` holds its query
heads (``_proj`` reads the count from the weight), ``wo`` its rows of
them, and the output's partial sums are all-reduced. Where the KV heads
divide ``model`` (``tp.kv is None``) ``wk``/``wv`` hold the rank's KV
heads and the cache holds them too. Where they do not, ``wk``/``wv`` are
whole and the rank projects only the KV heads ``tp.kv`` its query heads
read; prefill projects every KV head and keeps its ``head_dim`` slice of
each in the cache (``rules.cache_specs``), and decode attends its query
heads against its KV heads' slices all-gathered over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
                 rope_theta: float, kv: Optional[slice] = None):
    """q, k, v; ``kv`` projects only those KV heads of whole ``wk``/``wv``."""
    wk, wv = params["wk"], params["wv"]
    if kv is not None:
        wk, wv = wk[:, kv], wv[:, kv]
    q = apply_rope(_proj(x, params["wq"]), positions, rope_theta)
    k = apply_rope(_proj(x, wk), positions, rope_theta)
    v = _proj(x, wv)
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


def _attend(q, k, v, window: Optional[int], block: Optional[int],
            dtype) -> torch.Tensor:
    """The prompt's causal attention: ``t > block`` takes the blockwise
    path (cast to the activations' dtype, as the reference casts it), the
    rest the dense one."""
    if block is not None and q.shape[1] > block:
        return dispatch.attention(q, k, v, window=window,
                                  block=block).to(dtype)
    return dispatch.dense_attention(q, k, v, window=window)


def attention_forward(params: Params, x: torch.Tensor, *, rope_theta: float,
                      window: Optional[int] = None,
                      positions: Optional[torch.Tensor] = None,
                      block: Optional[int] = None, tp=None) -> torch.Tensor:
    """Full causal self-attention for training / teacher-forced scoring.

    ``block`` switches to the blockwise path (O(T·block) score memory
    instead of O(T²)), required for the 4k/32k production shapes:
    ``dispatch.attention``, the flash kernels on the card, the
    online-softmax twin ``_blockwise_attn`` on the CPU."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _project_qkv(params, x, positions, rope_theta,
                           None if tp is None else tp.kv)
    out = _out_proj(_attend(q, k, v, window, block, x.dtype), params["wo"])
    return out if tp is None else tp.reduce(out)


def _block_step(m, l, acc, q, kj, vj, j: int, s: int, scale: float,
                window: Optional[int]):
    """One KV block of the online softmax: the reference's scan body."""
    t, block = q.shape[1], kj.shape[1]
    qpos = torch.arange(t, device=q.device)[:, None]               # [T, 1]
    kpos = j * block + torch.arange(block, device=q.device)[None, :]
    ok = (kpos <= qpos) & (kpos < s)
    if window is not None:
        ok &= (qpos - kpos) < window
    scores = _gqa_scores(q, kj) * scale
    scores = torch.where(ok[None, None], scores, NEG_INF)      # [B,H,T,blk]
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = _gqa_combine(p.to(vj.dtype), vj).float()
    # pv: [B,T,H,D] -> the accumulator's layout [B,H,T,D]
    acc_new = acc * corr[..., None] + pv.transpose(1, 2)
    return m_new, l_new, acc_new


def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, window: Optional[int],
                    block: int) -> torch.Tensor:
    """Online-softmax attention over KV blocks, the reference's
    ``_blockwise_attn`` (flash attention's algorithm in plain PyTorch).

    q: [B,T,H,D]; k/v: [B,S,KV,D] -> [B,T,H,D] f32. Causal over absolute
    positions 0..T-1 (q) vs 0..S-1 (k); S is padded to a multiple of
    ``block`` (prefix tokens make it ragged). With grad on, each block is
    checkpointed (the reference's ``jax.checkpoint`` of the scan body): the
    backward recomputes a block's scores instead of saving them."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if s % block:
        pad = block - s % block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled()
    for j in range(k.shape[1] // block):
        kj = k[:, j * block:(j + 1) * block]
        vj = v[:, j * block:(j + 1) * block]
        if remat:
            m, l, acc = checkpoint(_block_step, m, l, acc, q, kj, vj, j, s,
                                   scale, window, use_reentrant=False)
        else:
            m, l, acc = _block_step(m, l, acc, q, kj, vj, j, s, scale,
                                    window)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]               # [B,H,T,D]
    return out.transpose(1, 2)                                     # [B,T,H,D]


def attention_prefill(params: Params, x: torch.Tensor, *, rope_theta: float,
                      cache_len: int, window: Optional[int] = None,
                      block: Optional[int] = None, tp=None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; emits the populated KV cache.
    ``block`` and ``tp`` as in ``attention_forward``."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _project_qkv(params, x, positions, rope_theta)
    kv = None if tp is None else tp.kv
    ka, va = (k, v) if kv is None else (k[:, :, kv], v[:, :, kv])
    out = _out_proj(_attend(q, ka, va, window, block, x.dtype), params["wo"])
    if tp is not None:
        out = tp.reduce(out)
    if kv is not None:
        # the cache's region: this rank's head_dim slice of every KV head
        dims = tp.part(k.shape[3])
        k, v = k[..., dims], v[..., dims]

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
                     rope_theta: float, window: Optional[int] = None,
                     uniform: bool = False,
                     tp=None) -> Tuple[torch.Tensor, KVCache]:
    """One new token per sequence. x: [B, 1, d].

    The new key/value row goes into slot ``pos % cache_len`` of each batch
    row: scattered per row, or with ``uniform=True`` (every sequence at the
    same position, lockstep serving) into the first row's slot for the
    whole batch (``index_copy_`` along the slot axis with a one-element
    index tensor: no host sync), the reference's dynamic-update-slice. With
    uniform positions the two are bit for bit the same. The port writes IN
    PLACE into ``cache.k``, ``cache.v`` and ``cache.positions`` (the
    returned cache shares those tensors), where the reference returns
    fresh arrays."""
    b = x.shape[0]
    cache_len = cache.k.shape[1]
    pos = cache.length                                       # [B]
    if tp is not None:
        x = tp.enter(x)
    q = apply_rope(_proj(x, params["wq"]), pos[:, None], rope_theta)
    k_new = apply_rope(_proj(x, params["wk"]), pos[:, None], rope_theta)
    v_new = _proj(x, params["wv"])
    kv = None if tp is None else tp.kv
    if kv is not None:
        dims = tp.part(k_new.shape[3])
        k_new, v_new = k_new[..., dims], v_new[..., dims]

    slot = (pos % cache_len).long()   # ring layout (== pos when S_cache > pos)
    if uniform:
        s0 = slot[:1]
        cache.k.index_copy_(1, s0, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, s0, v_new.to(cache.v.dtype))
        cache.positions.index_copy_(1, s0, pos[:, None])
    else:
        b_idx = torch.arange(b, device=x.device)
        cache.k[b_idx, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[b_idx, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.positions[b_idx, slot] = pos
    pos_c = cache.positions

    valid = pos_c >= 0                                       # [B,S]
    if window is not None:
        valid &= (pos[:, None] - pos_c) < window
    valid &= pos_c <= pos[:, None]
    k_c, v_c = cache.k, cache.v
    if kv is not None:
        # the KV heads the rank's query heads read, whole over head_dim
        k_c, v_c = (tp.gather(c[:, :, kv], 3) for c in (k_c, v_c))
    out = dispatch.decode_attention(q, k_c, v_c, valid)
    out = _out_proj(out, params["wo"])
    if tp is not None:
        out = tp.reduce(out)
    return out, KVCache(k=cache.k, v=cache.v, positions=pos_c,
                        length=pos + 1)
