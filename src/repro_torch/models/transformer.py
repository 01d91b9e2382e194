"""Policy backbone for the dense / vlm / audio arch types, as in the
reference ``repro/models/transformer.py``.

Per-layer leaves are stacked on a leading ``L`` axis under
``params["layers"]``; the reference's layer scan is a Python loop over
``L`` here. Entry points:

  * ``prefill`` — prompt pass that also emits the decode cache
  * ``decode``  — one token against the cache

The moe, ssm and hybrid arch types and the training ``forward`` belong to
later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    Params,
    action_head,
    dense_init,
    embed,
    mlp,
    rmsnorm,
    rmsnorm_init,
    stacked_dense_init,
)

FRONTEND_DIM = 1024  # stub modality-frontend embedding width (ViT/EnCodec)
_ARCHS = ("dense", "audio", "vlm")


class DecodeCache(NamedTuple):
    """Family-polymorphic decode cache (only ``attn`` in this slice)."""

    attn: Optional[KVCache]      # stacked [L, ...]
    ssm: Optional[Any]


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in _ARCHS:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet: moe, ssm and "
            f"hybrid backbones come in a later slice of the port")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Params:
    """Random backbone parameters drawn on ``device`` from ``gen`` (a
    generator on that device): truncated-normal fan-in init, same shapes
    and dtypes as the reference's ``init_params``."""
    _check_arch(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    n, d = cfg.num_layers, cfg.d_model
    params: Dict[str, Any] = {
        "embed": {"table": dense_init(gen, (cfg.vocab_size, d), dtype, dev)},
        "final_norm": rmsnorm_init(d, dtype, dev),
        "action_head": {"w": dense_init(
            gen, (d, cfg.action_vocab_size), dtype, dev)},
    }
    if cfg.num_prefix_tokens:
        params["prefix_proj"] = {
            "w": dense_init(gen, (FRONTEND_DIM, d), dtype, dev)}
    ones = torch.ones((n, d), dtype=dtype, device=dev)
    params["layers"] = {
        "attn_norm": {"scale": ones.clone()},
        "attn": attn_lib.stacked_attention_init(
            gen, n, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, dtype,
            dev),
        "mlp_norm": {"scale": ones},
        "mlp": {
            "w_gate": stacked_dense_init(gen, n, (d, cfg.d_ff), dtype, dev),
            "w_up": stacked_dense_init(gen, n, (d, cfg.d_ff), dtype, dev),
            "w_down": stacked_dense_init(gen, n, (cfg.d_ff, d), dtype, dev),
        },
    }
    return params


# ---------------------------------------------------------------------------
# Embedding of (prefix, tokens)
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    if prefix_embeds is not None:
        proj = prefix_embeds.to(x.dtype) @ params["prefix_proj"]["w"]
        x = torch.cat([proj, x], dim=1)
    return x.to(_dtype(cfg.compute_dtype))


# ---------------------------------------------------------------------------
# Decode cache init
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                      window: Optional[int] = None,
                      device="cuda") -> DecodeCache:
    _check_arch(cfg)
    dev = resolve_device(device)
    eff_len = min(cache_len, window) if window else cache_len
    one = attn_lib.init_cache(batch, eff_len, cfg.num_kv_heads, cfg.head_dim,
                              _dtype(cfg.compute_dtype), dev)
    n = cfg.num_layers
    return DecodeCache(
        attn=KVCache(*(t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)
                       for t in one)),
        ssm=None)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *,
            cache_len: Optional[int] = None,
            window: Optional[int] = None
            ) -> Tuple[Dict[str, torch.Tensor], DecodeCache]:
    """Returns ({"hidden": [B,T,d], "logits": [B,T,Va] f32}, cache)."""
    _check_arch(cfg)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    t = x.shape[1]
    cache_len = cache_len or t
    eff_len = min(cache_len, window) if window else cache_len
    caches = []
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        hn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        out, kv = attn_lib.attention_prefill(
            p["attn"], hn, rope_theta=cfg.rope_theta, cache_len=eff_len,
            window=window)
        x = x + out
        hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], hn)
        caches.append(kv)
    attn_cache = KVCache(*(torch.stack(parts) for parts in zip(*caches)))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x)
    return {"hidden": x, "logits": logits}, DecodeCache(attn=attn_cache,
                                                        ssm=None)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode(cfg: ModelConfig, params: Params, token: torch.Tensor,
           cache: DecodeCache, *, window: Optional[int] = None
           ) -> Tuple[Dict[str, torch.Tensor], DecodeCache]:
    """token: [B] or [B,1] int -> logits [B, 1, Va]. Updates the cache's
    k/v/positions tensors in place (see ``attention_decode``)."""
    _check_arch(cfg)
    if token.ndim == 1:
        token = token[:, None]
    x = embed(params["embed"], token).to(_dtype(cfg.compute_dtype))
    kvs = cache.attn
    lengths = []
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        kv = KVCache(kvs.k[i], kvs.v[i], kvs.positions[i], kvs.length[i])
        hn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        out, kv = attn_lib.attention_decode(
            p["attn"], hn, kv, rope_theta=cfg.rope_theta, window=window)
        x = x + out
        hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], hn)
        lengths.append(kv.length)
    new_cache = DecodeCache(
        attn=KVCache(kvs.k, kvs.v, kvs.positions, torch.stack(lengths)),
        ssm=None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x)
    return {"hidden": x, "logits": logits}, new_cache
