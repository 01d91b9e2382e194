"""Mamba2 (SSD — state-space duality) block, as in the reference
``repro/models/ssm.py``: the chunked dual form for training and prefill,
and the O(1)-state recurrent step for single-token decode.

A fresh-sequence scan goes through ``dispatch.ssd_scan`` (kernels K6/K7 on
the card, at every length); a prefill that
carries state in (``init_state``) stays on the plain chunked form, as in the
reference. Tests hold the two forms against each other (the SSD duality).
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


def _split_proj(params: Params, u: torch.Tensor, d_model: int,
                cfg: SSMConfig):
    di = cfg.d_inner(d_model)
    g, n = cfg.n_groups, cfg.state_dim
    nh = cfg.num_heads(d_model)
    if cfg.fused_in_proj:
        proj = u @ params["in_proj"]
        z, xbc, dt_raw = torch.split(proj, [di, di + 2 * g * n, nh], dim=-1)
    else:
        z = u @ params["in_proj_z"]
        xbc = u @ params["in_proj_x"]
        dt_raw = u @ params["in_proj_dt"]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])       # [..., nh]
    return z, xbc, dt, di, g, n, nh


def _causal_conv(params: Params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, T, C]."""
    k = params["conv_w"].shape[0]
    t = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + t] * params["conv_w"][i] for i in range(k))
    return F.silu(out + params["conv_b"])


def _gated_norm(params: Params, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + eps)
    return (g * params["norm_scale"].float()).to(y.dtype)


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
                return_state: bool = False):
    """Full-sequence Mamba2 block. u: [B, T, d_model]."""
    b, t, _ = u.shape
    z, xbc_raw, dt, di, g, n, nh = _split_proj(params, u, d_model, cfg)
    p = cfg.head_dim
    kk = cfg.conv_dim

    if init_state is not None:
        padded = torch.cat([init_state.conv, xbc_raw], dim=1)
        conv_out = sum(padded[:, i:i + t] * params["conv_w"][i]
                       for i in range(kk))
        xbc = F.silu(conv_out + params["conv_b"])
        ssm0 = init_state.ssm
    else:
        xbc = _causal_conv(params, xbc_raw)
        ssm0 = None

    xs, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = xs.reshape(b, t, nh, p)
    A = -torch.exp(params["A_log"])
    if ssm0 is None:
        # a fresh-sequence scan goes through the kernel dispatch layer;
        # carried-state prefill keeps the plain chunked form below
        y, s_final = dispatch.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.chunk)
    else:
        y, s_final = ssd_chunked(x, dt, A, Bm, Cm, cfg.chunk,
                                 init_state=ssm0)
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(b, t, di).to(u.dtype)
    out = _gated_norm(params, y, z) @ params["out_proj"]
    if not return_state:
        return out
    if t < kk - 1:
        new_tail = torch.cat([xbc_raw.new_zeros((b, kk - 1 - t,
                                                 xbc_raw.shape[-1])),
                              xbc_raw], dim=1)
    else:
        new_tail = xbc_raw[:, t - (kk - 1):]
    length = (init_state.length if init_state is not None
              else torch.zeros((b,), dtype=torch.int32, device=u.device)) + t
    return out, SSMState(conv=new_tail, ssm=s_final, length=length)


def ssm_decode(params: Params, u: torch.Tensor, state: SSMState,
               d_model: int, cfg: SSMConfig
               ) -> Tuple[torch.Tensor, SSMState]:
    """Single-token recurrent decode. u: [B, 1, d_model]."""
    b = u.shape[0]
    z, xbc_raw, dt, di, g, n, nh = _split_proj(params, u, d_model, cfg)
    p = cfg.head_dim

    window = torch.cat([state.conv, xbc_raw], dim=1)           # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"])
    xbc = F.silu(conv_out + params["conv_b"])[:, None, :]

    xs, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x_t = xs[:, 0].reshape(b, nh, p)
    A = -torch.exp(params["A_log"])
    y_t, new_ssm = ssd_recurrent_step(state.ssm, x_t, dt[:, 0], A,
                                      Bm[:, 0], Cm[:, 0])
    y_t = y_t + params["D"][None, :, None] * x_t.float()
    y = y_t.reshape(b, 1, di).to(u.dtype)
    out = _gated_norm(params, y, z) @ params["out_proj"]
    return out, SSMState(conv=window[:, 1:], ssm=new_ssm,
                         length=state.length + 1)


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
