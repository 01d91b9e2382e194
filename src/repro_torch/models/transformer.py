"""Policy backbone for the dense / vlm / audio and ssm arch types, as in
the reference ``repro/models/transformer.py``.

Per-layer leaves are stacked on a leading ``L`` axis under
``params["layers"]``; the reference's layer scan is a Python loop over
``L`` here. Entry points:

  * ``forward`` — teacher-forced scoring (training / value recomputation)
  * ``prefill`` — prompt pass that also emits the decode cache
  * ``decode``  — one token against the cache

The ssm backbone (mamba2) stacks ``{"norm", "ssm"}`` blocks on ``L``; its
decode cache is the stacked ``SSMState`` (``DecodeCache.ssm``). The moe and
hybrid arch types belong to later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
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
from repro_torch.models.ssm import SSMState
from repro_torch.tree import tree_map

FRONTEND_DIM = 1024  # stub modality-frontend embedding width (ViT/EnCodec)
_ARCHS = ("dense", "audio", "vlm", "ssm")


class DecodeCache(NamedTuple):
    """Family-polymorphic decode cache."""

    attn: Optional[KVCache]      # stacked [L, ...] or None
    ssm: Optional[SSMState]      # stacked [L, ...] or None


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in _ARCHS:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet: moe and hybrid "
            f"backbones come in a later slice of the port")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree, each leaf split once with
    ``unbind`` (views; its backward is one stack per leaf)."""
    split = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _stacked(init_one, n: int) -> Params:
    """``n`` draws of ``init_one()`` stacked on a leading axis, one layer at
    a time, so the whole stack is never held twice."""
    first = init_one()
    out = tree_map(lambda v: v.new_empty((n,) + tuple(v.shape)), first)
    for i in range(n):
        tree_map(lambda o, v: o[i].copy_(v), out,
                 first if i == 0 else init_one())
    return out


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
    if cfg.arch_type == "ssm":
        params["layers"] = _stacked(lambda: {
            "norm": rmsnorm_init(d, dtype, dev),
            "ssm": ssm_lib.ssm_init(gen, d, cfg.ssm, dtype, dev)}, n)
        return params
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
# Forward (teacher-forced scoring)
# ---------------------------------------------------------------------------

_ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0, "dropped_frac": 0.0}


def _attn_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        window: Optional[int],
                        block: Optional[int]) -> torch.Tensor:
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attn_lib.attention_forward(
        p["attn"], h, rope_theta=cfg.rope_theta, window=window, block=block)
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h)


def _ssm_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       window: Optional[int],
                       block: Optional[int]) -> torch.Tensor:
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    return x + ssm_lib.ssm_forward(p["ssm"], h, cfg.d_model, cfg.ssm)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *,
            window: Optional[int] = None, remat: bool = False,
            block: Optional[int] = None,
            head: bool = True) -> Dict[str, Any]:
    """Returns {"hidden": [B,S,d], "logits": [B,S,Va] f32 or None, "aux"}.

    ``head=False`` skips the action head (``logits`` is None): the
    fused-loss path applies it blockwise inside the loss kernel.
    ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant), the reference's
    ``jax.checkpoint`` of the scan body. The reference's ``unroll`` and
    ``act_sharding`` (scan unrolling and a GSPMD layout pin) have no
    counterpart in an eager single-device loop and are not taken."""
    _check_arch(cfg)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    block_fn = (_ssm_block_forward if cfg.arch_type == "ssm"
                else _attn_block_forward)
    for p in _unstack(params["layers"], cfg.num_layers):
        if remat:
            x = checkpoint(block_fn, p, x, cfg, window, block,
                           use_reentrant=False)
        else:
            x = block_fn(p, x, cfg, window, block)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x) if head else None
    return {"hidden": x, "logits": logits, "aux": dict(_ZERO_AUX)}


# ---------------------------------------------------------------------------
# Decode cache init
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                      window: Optional[int] = None,
                      device="cuda") -> DecodeCache:
    """Zeroed per-layer caches stacked on ``L``: KV caches for the attention
    archs, ``SSMState`` for ssm (``cache_len`` and ``window`` unused)."""
    _check_arch(cfg)
    dev = resolve_device(device)
    n = cfg.num_layers
    if cfg.arch_type == "ssm":
        one = ssm_lib.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                     _dtype(cfg.compute_dtype), dev)
        return DecodeCache(attn=None, ssm=SSMState(
            *(t.unsqueeze(0).repeat((n,) + (1,) * t.ndim) for t in one)))
    eff_len = min(cache_len, window) if window else cache_len
    one = attn_lib.init_cache(batch, eff_len, cfg.num_kv_heads, cfg.head_dim,
                              _dtype(cfg.compute_dtype), dev)
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
    """Returns ({"hidden": [B,T,d], "logits": [B,T,Va] f32}, cache).
    ``cache_len`` and ``window`` size the KV cache; an ssm cache is the
    state after the prompt and ignores them."""
    _check_arch(cfg)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    if cfg.arch_type == "ssm":
        states = []
        for p in _unstack(params["layers"], cfg.num_layers):
            hn = rmsnorm(p["norm"], x, cfg.norm_eps)
            out, st = ssm_lib.ssm_forward(p["ssm"], hn, cfg.d_model, cfg.ssm,
                                          return_state=True)
            x = x + out
            states.append(st)
        cache = DecodeCache(attn=None, ssm=SSMState(
            *(torch.stack(parts) for parts in zip(*states))))
    else:
        t = x.shape[1]
        cache_len = cache_len or t
        eff_len = min(cache_len, window) if window else cache_len
        caches = []
        for p in _unstack(params["layers"], cfg.num_layers):
            hn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            out, kv = attn_lib.attention_prefill(
                p["attn"], hn, rope_theta=cfg.rope_theta, cache_len=eff_len,
                window=window)
            x = x + out
            hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
            x = x + mlp(p["mlp"], hn)
            caches.append(kv)
        cache = DecodeCache(attn=KVCache(*(torch.stack(parts)
                                           for parts in zip(*caches))),
                            ssm=None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x)
    return {"hidden": x, "logits": logits}, cache


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode(cfg: ModelConfig, params: Params, token: torch.Tensor,
           cache: DecodeCache, *, window: Optional[int] = None
           ) -> Tuple[Dict[str, torch.Tensor], DecodeCache]:
    """token: [B] or [B,1] int -> logits [B, 1, Va]. Updates the cache's
    k/v/positions tensors (see ``attention_decode``), or each layer's conv
    tail and SSM state, in place."""
    _check_arch(cfg)
    if token.ndim == 1:
        token = token[:, None]
    x = embed(params["embed"], token).to(_dtype(cfg.compute_dtype))
    lengths = []
    if cfg.arch_type == "ssm":
        st = cache.ssm
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
            hn = rmsnorm(p["norm"], x, cfg.norm_eps)
            out, new = ssm_lib.ssm_decode(
                p["ssm"], hn, SSMState(st.conv[i], st.ssm[i], st.length[i]),
                cfg.d_model, cfg.ssm)
            st.conv[i].copy_(new.conv)
            st.ssm[i].copy_(new.ssm)
            lengths.append(new.length)
            x = x + out
        new_cache = DecodeCache(attn=None, ssm=SSMState(
            st.conv, st.ssm, torch.stack(lengths)))
    else:
        kvs = cache.attn
        for i, p in enumerate(_unstack(params["layers"], cfg.num_layers)):
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
