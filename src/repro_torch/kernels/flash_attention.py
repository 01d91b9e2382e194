"""Flash attention, forward (K1) and backward (K3): the CUDA kernels
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` and their
plain PyTorch versions.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_attn_kernel`` via ``flash_attention``). On this card the serving shapes
make it memory-bound (q, k, v and o cross device memory once each). One CTA
per (64-row q tile, head, batch row) loops over 64-key tiles inside the
CTA. bf16 heads of width 16..128 run the Hopper body: a producer warp
streams K and V tiles by TMA through a ring of shared-memory slots while a
consumer warpgroup runs both products on ``wgmma``; f32 and other widths
run f32 FMAs. See the note at the top of the CUDA source for the design.

``flash_attention`` launches the kernel for CUDA tensors and raises on any
shape, dtype, layout or device it does not take; a CPU tensor goes to
``_plain_dense``. ``flash_attention.launches`` counts kernel launches.

The backward replaces the reference's ``flash_attention_bwd``
(``_attn_bwd_dq_kernel`` and ``_attn_bwd_dkv_kernel``): dq, dk, dv from the
saved per-row log-sum-exp, ``p = exp(s - lse)``, ``ds = p∘(dO·Vᵀ − D)``
with ``D = rowsum(dO∘O)``. One kernel accumulates dq over kv tiles and
computes D for its rows on the way (no PyTorch arithmetic around the
launch); the other dk/dv over q tiles and over the GQA group of its kv
head, reading D from the first. ``flash_attention_bwd`` routes like the
forward (CPU → ``_plain_flash_bwd``); ``flash_attention_bwd.launches``
counts its launches. ``FlashAttentionFn`` ties the two together for
autograd.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)     # one entry per device index
def _capability(index: int):
    return torch.cuda.get_device_capability(index)


def check_attention_args(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """What the CUDA attention kernels take; anything else raises."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,T,H,D], k/v [B,S,KV,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"batch/head_dim mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head_dim {d} must be a multiple of 8 in [8, 256]")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    cap = _capability(q.device.index)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device "
                           f"{q.device} has compute capability {cap}")


def _plain_dense(q, k, v, *, causal: bool = True,
                 window: Optional[int] = None, return_lse: bool = False):
    """Plain PyTorch version, the math of the reference's ``_twin_dense``:
    f32 scores, an additive causal/window mask, softmax cast to q.dtype
    before the value combine. Positions count from 0 on both sides."""
    from repro_torch.models.attention import _gqa_combine, _gqa_scores
    t, s = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k) * (q.shape[-1] ** -0.5)      # [B,H,T,S] f32
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _gqa_combine(weights, v)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).transpose(1, 2)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q: [B,T,H,D]; k/v: [B,S,KV,D] with H % KV == 0 -> [B,T,H,D] in
    q.dtype, plus the per-row log-sum-exp [B,T,H] f32 if ``return_lse``."""
    if q.device.type == "cpu":
        return _plain_dense(q, k, v, causal=causal, window=window,
                            return_lse=return_lse)
    check_attention_args(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, t, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, t, s, h, kv, d, int(causal), int(window or 0),
            _DTYPE_CODES[q.dtype], d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err)
    with _count_lock:
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _plain_flash_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                     window: Optional[int] = None):
    """Plain PyTorch backward: replays ``p = exp(s − lse)`` densely in f32,
    per q head, then folds dk/dv over each GQA group. Returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=2)             # [B,S,H,D]
    vf = v.float().repeat_interleave(group, dim=2)
    dd = (dof * out.float()).sum(-1)                           # [B,T,H]
    sc = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    p = torch.where(ok, torch.exp(sc - lse.transpose(1, 2)[..., None]), 0.0)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - dd.transpose(1, 2)[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dk = dk.reshape(b, s, kv, group, d).sum(3)
    dv = dv.reshape(b, s, kv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: widest head the backward kernel stages (four [64, D] f32 tiles fit
#: shared memory up to D = 128)
BWD_MAX_D = 128


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients (dq, dk, dv) from the forward's residuals. q/out/do:
    [B,T,H,D]; k/v: [B,S,KV,D]; lse: [B,T,H] f32 from
    ``flash_attention(..., return_lse=True)``. dq/dk/dv come out in the
    inputs' dtype (f32 accumulation)."""
    if q.device.type == "cpu":
        return _plain_flash_bwd(q, k, v, out, lse, do, causal=causal,
                                window=window)
    check_attention_args(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if d > BWD_MAX_D:
        raise ValueError(f"head_dim {d} > {BWD_MAX_D}: the backward kernel "
                         f"does not take it")
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype \
                or x.device != q.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} tensor of q's shape on {q.device}")
    if lse.shape != (b, t, h) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [B,T,H] tensor "
                         f"on {q.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # the kernels' scratch: rowsum(dO∘O) and lse·log2(e) per (b, h, row),
    # written by the dq kernel for the dk/dv kernel
    aux = torch.empty((2, b, h, -(-t // 64) * 64), dtype=torch.float32,
                      device=q.device)
    _launch_bwd(q, k, v, out, lse, do, aux, dq, dk, dv, causal, window)
    with _count_lock:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


def _launch_bwd(q, k, v, out, lse, do, aux, dq, dk, dv, causal, window):
    """The backward kernels alone, on checked inputs and allocated outputs
    (``chip_smoke.py`` times this to part the kernels from the wrapper)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), aux.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, t, s, h, kv, d, int(causal),
            int(window or 0), _DTYPE_CODES[q.dtype], d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err)


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Causal attention with the flash forward (saving the LSE) and the
    flash backward, routed by device like the wrappers: the reference's
    ``_flash_with_twin_bwd`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention(q, k, v, causal=True, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=True, window=ctx.window)
        return dq, dk, dv, None
