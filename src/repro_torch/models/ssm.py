"""Mamba2 (SSD — state-space duality) block, as in the reference
``repro/models/ssm.py``: the chunked dual form for training and prefill,
and the O(1)-state recurrent step for single-token decode.

A fresh-sequence scan goes through ``dispatch.ssd_scan`` (kernels K6/K7 on
the card, at every length); a prefill that
carries state in (``init_state``) stays on the plain chunked form, as in the
reference. Tests hold the two forms against each other (the SSD duality).

``tp`` (a ``sharding.spmd.TensorParallel``, or ``None``) runs a block on
the rank's heads in a tensor-parallel step program. ``out_proj`` holds the
rank's rows of d_inner and ``norm_scale`` its part of it (both aligned
with whole heads); ``in_proj*``, ``conv_w``, ``conv_b``, ``A_log``, ``D``
and ``dt_bias`` are whole, and the rank takes its columns of them
(:class:`_Cols`): its z, x and dt, and B and C whole (on one rank all of
them: the leaves themselves). The scan (K6/K7 on
the card) runs on the rank's heads, the gated norm's mean of squares over
the whole d_inner is summed over ``model`` (``tp.sum``), and
``out_proj``'s partial sums are all-reduced. The block's input goes
through ``tp.enter``. The cache holds the rank's heads of the SSM state
and, as ``rules.cache_specs`` places it, its contiguous chunk of the conv
tail's channels (``tp.part``), which does not follow the x | B | C
layout: the tail is all-gathered whole over ``model`` where a step reads
or writes it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan import plain_ssd_scan
from repro_torch.models.layers import Params, dense_init


class SSMState(NamedTuple):
    conv: torch.Tensor     # [B, K-1, conv_channels] rolling conv input tail
    ssm: torch.Tensor      # [B, H, P, N] recurrent state (f32)
    length: torch.Tensor   # [B] int32


def ssm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, dtype,
             device) -> Params:
    """One layer's parameters drawn on ``device`` from ``gen``: the
    reference's shapes, dtypes and init rules (A_log 0, D 1, dt_bias the
    inverse softplus of dt ~ logU[1e-3, 1e-1], all three f32)."""
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    g, n, kk = cfg.n_groups, cfg.state_dim, cfg.conv_dim
    conv_ch = di + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand((nh,), generator=gen, **f32))
    params = {
        "conv_w": dense_init(gen, (kk, conv_ch), dtype, device, scale=1.0),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d_model), dtype, device),
    }
    if cfg.fused_in_proj:
        params["in_proj"] = dense_init(
            gen, (d_model, 2 * di + 2 * g * n + nh), dtype, device)
    else:
        params["in_proj_z"] = dense_init(gen, (d_model, di), dtype, device)
        params["in_proj_x"] = dense_init(gen, (d_model, di + 2 * g * n),
                                         dtype, device)
        params["in_proj_dt"] = dense_init(gen, (d_model, nh), dtype, device)
    return params


class _Cols(NamedTuple):
    """A rank's columns of a Mamba2 block: its heads, its slice of d_inner,
    and its conv channels (its x channels, then B and C); all of them on
    one rank."""

    heads: slice
    inner: slice
    conv: Tuple[slice, slice]


def _cols(params: Params, d_model: int, cfg: SSMConfig, tp) -> _Cols:
    di, p = cfg.d_inner(d_model), cfg.head_dim
    rank, size = (0, 1) if tp is None else (tp.rank, tp.size)
    hl = cfg.num_heads(d_model) // size
    heads = slice(rank * hl, (rank + 1) * hl)
    inner = slice(heads.start * p, heads.stop * p)
    return _Cols(heads, inner, (inner, slice(di, params["conv_b"].shape[0])))


def _take(x: torch.Tensor, *parts: slice) -> torch.Tensor:
    """``x``'s last-axis slices ``parts`` joined in order: a view where they
    are adjacent, ``x`` itself where they cover it (on one rank)."""
    runs = []
    for s in parts:
        if runs and runs[-1].stop == s.start:
            runs[-1] = slice(runs[-1].start, s.stop)
        else:
            runs.append(s)
    if len(runs) > 1:
        return torch.cat([x[..., s] for s in runs], dim=-1)
    if (runs[0].start, runs[0].stop) == (0, x.shape[-1]):
        return x
    return x[..., runs[0]]


def _split_proj(params: Params, u: torch.Tensor, d_model: int,
                cfg: SSMConfig, cols: _Cols):
    """z, xbc (pre-conv), dt and the sizes, on the rank's columns (B and C
    whole) and its heads."""
    di = cfg.d_inner(d_model)
    gn = cfg.n_groups * cfg.state_dim
    zs, hs = cols.inner, cols.heads
    xs = slice(di + zs.start, di + zs.stop)
    bc = slice(2 * di, 2 * di + 2 * gn)
    dts = slice(bc.stop + hs.start, bc.stop + hs.stop)
    dl, nl = zs.stop - zs.start, hs.stop - hs.start
    if cfg.fused_in_proj:
        proj = u @ _take(params["in_proj"], zs, xs, bc, dts)
        z, xbc, dt_raw = torch.split(proj, [dl, dl + 2 * gn, nl], dim=-1)
    else:
        z = u @ _take(params["in_proj_z"], zs)
        xbc = u @ _take(params["in_proj_x"], zs, slice(di, di + 2 * gn))
        dt_raw = u @ _take(params["in_proj_dt"], hs)
    dt = F.softplus(dt_raw.float() + _take(params["dt_bias"], hs))
    return z, xbc, dt, dl, cfg.n_groups, cfg.state_dim, nl


def _conv_params(params: Params, cols: _Cols) -> Params:
    """``conv_w``/``conv_b`` on the rank's channels."""
    return {k: _take(params[k], *cols.conv) for k in ("conv_w", "conv_b")}


def _causal_conv(params: Params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, T, C]."""
    k = params["conv_w"].shape[0]
    t = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + t] * params["conv_w"][i] for i in range(k))
    return F.silu(out + params["conv_b"])


def _gated_norm(params: Params, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-5, tp=None) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` over d_inner; under ``tp`` ``y``/``z``
    are the rank's part and the sum of squares is summed over ``model``."""
    g = y.float() * F.silu(z.float())
    if tp is None:
        var = g.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.sum(g.square().sum(dim=-1, keepdim=True)) / (
            g.shape[-1] * tp.size)
    g = g * torch.rsqrt(var + eps)
    return (g * params["norm_scale"].float()).to(y.dtype)


def _out(params: Params, y: torch.Tensor, z: torch.Tensor, tp=None):
    """The gated norm and ``out_proj`` (its partial sums all-reduced under
    ``tp``)."""
    out = _gated_norm(params, y, z, tp=tp) @ params["out_proj"]
    return out if tp is None else tp.reduce(out)


def _rank_tail(conv: torch.Tensor, cols: _Cols, tp) -> torch.Tensor:
    """A cache's conv tail on the rank's channels: under ``tp`` the cache
    holds the rank's region of it (``tp.part``), gathered whole over
    ``model`` first."""
    if conv.shape[-1] != cols.conv[1].stop:
        conv = tp.gather(conv, -1)
    return _take(conv, *cols.conv)


def _cache_tail(tail: torch.Tensor, dl: int, tp) -> torch.Tensor:
    """A conv tail on the rank's channels (``dl`` x channels, then B and C)
    as the cache holds it: under ``tp`` the x channels all-gathered over
    ``model`` and the cache's region (``tp.part``) cut from the whole."""
    if tp is None:
        return tail
    whole = torch.cat([tp.gather(tail[..., :dl], -1), tail[..., dl:]],
                      dim=-1)
    return whole[..., tp.part(whole.shape[-1])]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with chunk ``min(chunk, T)``.

    x: [B,T,H,P]; dt: [B,T,H] (f32, post-softplus); A: [H] (negative);
    Bm/Cm: [B,T,N] (single group, broadcast over heads).
    Returns (y [B,T,H,P] f32, final_state [B,H,P,N] f32)."""
    return plain_ssd_scan(x, dt, A, Bm, Cm, chunk, init_state=init_state)


def ssd_recurrent_step(state: torch.Tensor, x_t: torch.Tensor,
                       dt_t: torch.Tensor, A: torch.Tensor,
                       B_t: torch.Tensor, C_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state: [B,H,P,N]; x_t: [B,H,P]; dt_t: [B,H];
    B_t/C_t: [B,N]. Returns (y_t [B,H,P], new_state)."""
    da = torch.exp(dt_t * A[None, :])                           # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, x_t.float(), B_t.float())
    new_state = da[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.float())
    return y, new_state


def ssm_forward(params: Params, u: torch.Tensor, d_model: int,
                cfg: SSMConfig, init_state: Optional[SSMState] = None,
                return_state: bool = False, tp=None):
    """Full-sequence Mamba2 block. u: [B, T, d_model]. ``tp``: the rank's
    heads (the module's docstring)."""
    b, t, _ = u.shape
    if tp is not None:
        u = tp.enter(u)
    cols = _cols(params, d_model, cfg, tp)
    z, xbc_raw, dt, di, g, n, nh = _split_proj(params, u, d_model, cfg, cols)
    conv = _conv_params(params, cols)
    p = cfg.head_dim
    kk = cfg.conv_dim

    if init_state is not None:
        padded = torch.cat([_rank_tail(init_state.conv, cols, tp), xbc_raw],
                           dim=1)
        conv_out = sum(padded[:, i:i + t] * conv["conv_w"][i]
                       for i in range(kk))
        xbc = F.silu(conv_out + conv["conv_b"])
        ssm0 = init_state.ssm
    else:
        xbc = _causal_conv(conv, xbc_raw)
        ssm0 = None

    xs, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = xs.reshape(b, t, nh, p)
    A = -torch.exp(_take(params["A_log"], cols.heads))
    if ssm0 is None:
        # a fresh-sequence scan goes through the kernel dispatch layer;
        # carried-state prefill keeps the plain chunked form below
        y, s_final = dispatch.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.chunk)
    else:
        y, s_final = ssd_chunked(x, dt, A, Bm, Cm, cfg.chunk,
                                 init_state=ssm0)
    y = y + _take(params["D"], cols.heads)[None, None, :, None] * x.float()
    y = y.reshape(b, t, di).to(u.dtype)
    out = _out(params, y, z, tp)
    if not return_state:
        return out
    raw = xbc_raw[:, max(t - (kk - 1), 0):]
    if t < kk - 1:
        new_tail = torch.cat([raw.new_zeros((b, kk - 1 - t, raw.shape[-1])),
                              raw], dim=1)
    else:
        new_tail = raw
    length = (init_state.length if init_state is not None
              else torch.zeros((b,), dtype=torch.int32, device=u.device)) + t
    return out, SSMState(conv=_cache_tail(new_tail, di, tp), ssm=s_final,
                         length=length)


def ssm_decode(params: Params, u: torch.Tensor, state: SSMState,
               d_model: int, cfg: SSMConfig, tp=None
               ) -> Tuple[torch.Tensor, SSMState]:
    """Single-token recurrent decode. u: [B, 1, d_model]. ``tp``: the
    rank's heads, ``state`` the rank's region of the cache."""
    b = u.shape[0]
    if tp is not None:
        u = tp.enter(u)
    cols = _cols(params, d_model, cfg, tp)
    z, xbc_raw, dt, di, g, n, nh = _split_proj(params, u, d_model, cfg, cols)
    conv = _conv_params(params, cols)
    p = cfg.head_dim

    window = torch.cat([_rank_tail(state.conv, cols, tp), xbc_raw],
                       dim=1)                                  # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window, conv["conv_w"])
    xbc = F.silu(conv_out + conv["conv_b"])[:, None, :]

    xs, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x_t = xs[:, 0].reshape(b, nh, p)
    A = -torch.exp(_take(params["A_log"], cols.heads))
    y_t, new_ssm = ssd_recurrent_step(state.ssm, x_t, dt[:, 0], A,
                                      Bm[:, 0], Cm[:, 0])
    y_t = y_t + _take(params["D"], cols.heads)[None, :, None] * x_t.float()
    y = y_t.reshape(b, 1, di).to(u.dtype)
    out = _out(params, y, z, tp)
    return out, SSMState(conv=_cache_tail(window[:, 1:], di, tp),
                         ssm=new_ssm, length=state.length + 1)


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig, dtype,
                   device) -> SSMState:
    di = cfg.d_inner(d_model)
    nh = cfg.num_heads(d_model)
    conv_ch = di + 2 * cfg.n_groups * cfg.state_dim
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_dim - 1, conv_ch), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nh, cfg.head_dim, cfg.state_dim),
                        dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))
