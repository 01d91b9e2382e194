"""Policy backbone for every arch type (dense / vlm / audio, moe, ssm and
hybrid), as in the reference ``repro/models/transformer.py``.

Per-layer leaves are stacked on a leading ``L`` axis under
``params["layers"]``; the reference's layer scan is a Python loop over
``L`` here. Entry points:

  * ``forward`` — teacher-forced scoring (training / value recomputation)
  * ``prefill`` — prompt pass that also emits the decode cache
  * ``decode``  — one token against the cache

The ssm backbone (mamba2) stacks ``{"norm", "ssm"}`` blocks on ``L``; its
decode cache is the stacked ``SSMState`` (``DecodeCache.ssm``). The hybrid
backbone (zamba2) applies one *shared* attention + MLP block
(``params["shared_attn"]``, not stacked: its weights are tied across
applications) before every ``shared_every``-th Mamba2 layer: ``layers``
holds ``n_macro * g`` Mamba2 blocks and ``layers_rem`` the remainder. Its
KV cache has one slot per application (``num_shared_applications``), its
``SSMState`` one per Mamba2 layer. The moe backbone (granite-moe, dbrx)
stacks attention + ``moe`` blocks (``models/moe.py``: GShard capacity
dispatch, the router in f32); ``forward`` returns the layers' summed
load-balance and router-z terms and their mean dropped share in ``aux``,
while prefill and decode drop them, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
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


class DecodeCache(NamedTuple):
    """Family-polymorphic decode cache."""

    attn: Optional[KVCache]      # stacked [L or n_shared, ...] or None
    ssm: Optional[SSMState]      # stacked [L, ...] or None


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_macro, group, remainder): the shared block fires n_macro (+1 if
    rem) times, before each macro group of ``group`` Mamba2 layers."""
    g = cfg.hybrid.shared_every
    return cfg.num_layers // g, g, cfg.num_layers % g


def num_shared_applications(cfg: ModelConfig) -> int:
    n_macro, _, rem = hybrid_layout(cfg)
    return n_macro + (1 if rem else 0)


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

    def ssm_block():
        return {"norm": rmsnorm_init(d, dtype, dev),
                "ssm": ssm_lib.ssm_init(gen, d, cfg.ssm, dtype, dev)}
    if cfg.arch_type == "ssm":
        params["layers"] = _stacked(ssm_block, n)
    elif cfg.arch_type == "hybrid":
        n_macro, g, rem = hybrid_layout(cfg)
        params["layers"] = _stacked(ssm_block, n_macro * g)
        if rem:
            params["layers_rem"] = _stacked(ssm_block, rem)
        params["shared_attn"] = tree_map(
            lambda v: v[0], _attn_blocks_init(gen, cfg, 1,
                                              cfg.hybrid.shared_d_ff, dtype,
                                              dev))
    elif cfg.arch_type in ("dense", "audio", "vlm", "moe"):
        params["layers"] = _attn_blocks_init(gen, cfg, n, cfg.d_ff, dtype,
                                             dev)
    else:
        raise ValueError(f"unknown arch_type {cfg.arch_type}")
    return params


def _attn_blocks_init(gen, cfg: ModelConfig, n: int, d_ff: int, dtype,
                      dev) -> Params:
    """``n`` attention + MLP blocks stacked on a leading axis; for the moe
    arch type the MLP is ``moe`` (``moe_lib.stacked_moe_init``)."""
    d = cfg.d_model
    ones = torch.ones((n, d), dtype=dtype, device=dev)
    blocks = {
        "attn_norm": {"scale": ones.clone()},
        "attn": attn_lib.stacked_attention_init(
            gen, n, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, dtype,
            dev),
        "mlp_norm": {"scale": ones},
    }
    if cfg.arch_type == "moe":
        blocks["moe"] = moe_lib.stacked_moe_init(gen, n, d, cfg.moe, dtype,
                                                 dev)
    else:
        blocks["mlp"] = {
            "w_gate": stacked_dense_init(gen, n, (d, d_ff), dtype, dev),
            "w_up": stacked_dense_init(gen, n, (d, d_ff), dtype, dev),
            "w_down": stacked_dense_init(gen, n, (d_ff, d), dtype, dev),
        }
    return blocks


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


def _attn_sublayer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   window: Optional[int], block: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + attention(norm(x)), and that sum normed for the block's MLP."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    x = x + attn_lib.attention_forward(
        p["attn"], h, rope_theta=cfg.rope_theta, window=window, block=block)
    return x, rmsnorm(p["mlp_norm"], x, cfg.norm_eps)


def _attn_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        window: Optional[int],
                        block: Optional[int]) -> torch.Tensor:
    x, h = _attn_sublayer(p, x, cfg, window, block)
    return x + mlp(p["mlp"], h)


def _moe_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       window: Optional[int], block: Optional[int]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, h = _attn_sublayer(p, x, cfg, window, block)
    out, aux = moe_lib.moe_forward(p["moe"], h, cfg.moe)
    return x + out, aux


def _ssm_block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       window: Optional[int],
                       block: Optional[int]) -> torch.Tensor:
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    return x + ssm_lib.ssm_forward(p["ssm"], h, cfg.d_model, cfg.ssm)


def _schedule(cfg: ModelConfig, params: Params) -> List[Tuple[str, Params,
                                                               int]]:
    """The backbone's blocks in order, as (kind, params, index): kind
    "attn", "moe" (attention + MoE) or "ssm", index counting that kind's
    blocks only (the KV slot of an attention or moe block, the
    ``SSMState`` layer of a Mamba2 block). In the hybrid every "attn" is
    the one ``shared_attn`` block, its index the application."""
    if cfg.arch_type != "hybrid":
        kind = {"ssm": "ssm", "moe": "moe"}.get(cfg.arch_type, "attn")
        return [(kind, p, i) for i, p in
                enumerate(_unstack(params["layers"], cfg.num_layers))]
    n_macro, g, rem = hybrid_layout(cfg)
    ssm = _unstack(params["layers"], n_macro * g)
    if rem:
        ssm += _unstack(params["layers_rem"], rem)
    out = []
    for a in range(num_shared_applications(cfg)):
        out.append(("attn", params["shared_attn"], a))
        out += [("ssm", ssm[j], j)
                for j in range(a * g, min(a * g + g, cfg.num_layers))]
    return out


_BLOCK_FORWARD = {"attn": _attn_block_forward, "moe": _moe_block_forward,
                  "ssm": _ssm_block_forward}


def _sum_aux(cfg: ModelConfig, auxs: List[Dict[str, torch.Tensor]]
             ) -> Dict[str, Any]:
    """The moe layers' aux terms summed over layers, ``dropped_frac``
    averaged (the reference's sum over its scan); zeros for the others."""
    if not auxs:
        return dict(_ZERO_AUX)
    aux = {k: torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]}
    aux["dropped_frac"] = aux["dropped_frac"] / cfg.num_layers
    return aux


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *,
            window: Optional[int] = None, remat: bool = False,
            block: Optional[int] = None,
            head: bool = True) -> Dict[str, Any]:
    """Returns {"hidden": [B,S,d], "logits": [B,S,Va] f32 or None, "aux"}.

    ``head=False`` skips the action head (``logits`` is None): the
    fused-loss path applies it blockwise inside the loss kernel.
    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant), the reference's ``jax.checkpoint`` of the scan body
    (the hybrid's of each macro group: the same arithmetic). The
    reference's ``unroll`` and ``act_sharding`` (scan unrolling and a GSPMD
    layout pin) have no counterpart in an eager single-device loop and are
    not taken. ``aux`` holds the moe terms (``_sum_aux``), floats 0 for
    the other arch types."""
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    auxs = []
    for kind, p, _ in _schedule(cfg, params):
        block_fn = _BLOCK_FORWARD[kind]
        if remat:
            x = checkpoint(block_fn, p, x, cfg, window, block,
                           use_reentrant=False)
        else:
            x = block_fn(p, x, cfg, window, block)
        if kind == "moe":
            x, aux = x
            auxs.append(aux)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x) if head else None
    return {"hidden": x, "logits": logits, "aux": _sum_aux(cfg, auxs)}


# ---------------------------------------------------------------------------
# Decode cache init
# ---------------------------------------------------------------------------

def _stack_copies(one, n: int):
    return type(one)(*(t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)
                       for t in one))


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                      window: Optional[int] = None,
                      device="cuda") -> DecodeCache:
    """Zeroed caches: a KV cache stacked on the attention layers (on the
    shared block's applications for hybrid), an ``SSMState`` stacked on the
    Mamba2 layers (``cache_len`` and ``window`` unused for ssm)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.compute_dtype)
    attn = ssm = None
    if cfg.arch_type in ("ssm", "hybrid"):
        ssm = _stack_copies(ssm_lib.init_ssm_state(batch, cfg.d_model,
                                                   cfg.ssm, dtype, dev),
                            cfg.num_layers)
    if cfg.arch_type != "ssm":
        eff_len = min(cache_len, window) if window else cache_len
        n_attn = (num_shared_applications(cfg) if cfg.arch_type == "hybrid"
                  else cfg.num_layers)
        attn = _stack_copies(attn_lib.init_cache(
            batch, eff_len, cfg.num_kv_heads, cfg.head_dim, dtype, dev),
            n_attn)
    return DecodeCache(attn=attn, ssm=ssm)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _feed_forward(kind: str, p: Params, h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """An attention block's MLP on its normed input: SwiGLU, or for a moe
    block the MoE layer with its aux terms dropped, as the reference's
    prefill and decode drop them."""
    if kind == "moe":
        return moe_lib.moe_forward(p["moe"], h, cfg.moe)[0]
    return mlp(p["mlp"], h)


def _stack_parts(cls, parts):
    return cls(*(torch.stack(p) for p in zip(*parts))) if parts else None


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *,
            cache_len: Optional[int] = None,
            window: Optional[int] = None
            ) -> Tuple[Dict[str, torch.Tensor], DecodeCache]:
    """Returns ({"hidden": [B,T,d], "logits": [B,T,Va] f32}, cache).
    ``cache_len`` and ``window`` size the KV caches; an SSM state is the
    state after the prompt and ignores them. Each attention block (each
    application of the hybrid's shared block) fills its own KV slot."""
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    cache_len = cache_len or x.shape[1]
    eff_len = min(cache_len, window) if window else cache_len
    caches, states = [], []
    for kind, p, _ in _schedule(cfg, params):
        if kind == "ssm":
            hn = rmsnorm(p["norm"], x, cfg.norm_eps)
            out, st = ssm_lib.ssm_forward(p["ssm"], hn, cfg.d_model, cfg.ssm,
                                          return_state=True)
            x = x + out
            states.append(st)
            continue
        hn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        out, kv = attn_lib.attention_prefill(
            p["attn"], hn, rope_theta=cfg.rope_theta, cache_len=eff_len,
            window=window)
        x = x + out
        hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + _feed_forward(kind, p, hn, cfg)
        caches.append(kv)
    cache = DecodeCache(attn=_stack_parts(KVCache, caches),
                        ssm=_stack_parts(SSMState, states))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x)
    return {"hidden": x, "logits": logits}, cache


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------

def decode(cfg: ModelConfig, params: Params, token: torch.Tensor,
           cache: DecodeCache, *, window: Optional[int] = None
           ) -> Tuple[Dict[str, torch.Tensor], DecodeCache]:
    """token: [B] or [B,1] int -> logits [B, 1, Va]. Updates the cache in
    place: each attention block's k/v/positions slot (see
    ``attention_decode``; the hybrid's application i writes slot i) and
    each Mamba2 layer's conv tail and SSM state."""
    if token.ndim == 1:
        token = token[:, None]
    x = embed(params["embed"], token).to(_dtype(cfg.compute_dtype))
    kvs, st = cache.attn, cache.ssm
    kv_lengths, ssm_lengths = [], []
    for kind, p, i in _schedule(cfg, params):
        if kind == "ssm":
            hn = rmsnorm(p["norm"], x, cfg.norm_eps)
            out, new = ssm_lib.ssm_decode(
                p["ssm"], hn, SSMState(st.conv[i], st.ssm[i], st.length[i]),
                cfg.d_model, cfg.ssm)
            st.conv[i].copy_(new.conv)
            st.ssm[i].copy_(new.ssm)
            ssm_lengths.append(new.length)
            x = x + out
            continue
        kv = KVCache(kvs.k[i], kvs.v[i], kvs.positions[i], kvs.length[i])
        hn = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        out, kv = attn_lib.attention_decode(
            p["attn"], hn, kv, rope_theta=cfg.rope_theta, window=window)
        x = x + out
        hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + _feed_forward(kind, p, hn, cfg)
        kv_lengths.append(kv.length)
    new_cache = DecodeCache(
        attn=None if kvs is None else KVCache(
            kvs.k, kvs.v, kvs.positions, torch.stack(kv_lengths)),
        ssm=None if st is None else SSMState(
            st.conv, st.ssm, torch.stack(ssm_lengths)))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = action_head(params["action_head"], x)
    return {"hidden": x, "logits": logits}, new_cache
