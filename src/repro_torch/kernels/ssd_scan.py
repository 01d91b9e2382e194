"""Chunked Mamba2 SSD scan, forward (K6) and backward (K7): the CUDA
kernels ``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu`` and their plain
PyTorch versions.

Replaces the Pallas TPU kernels of ``repro/kernels/ssd_scan.py``:
``_ssd_kernel`` behind ``ssd_scan`` (K6) and ``_ssd_bwd_kernel`` behind
``ssd_scan_bwd`` (K7). Shapes: x [B,T,H,P] (f32 or bf16), dt [B,T,H] f32
(post-softplus), A [H] f32 (negative), Bm / Cm [B,T,N] (x's dtype, a single
group shared by the heads). T is any length: a sequence's last chunk may be
short, and the kernels load its missing rows as zeros, which change neither
the state nor any output row (the Pallas kernels wanted T a multiple of the
chunk; that was a TPU tiling limit). A sequence shorter than ``chunk`` runs
as one chunk of T rounded up to 32.

K6 writes y [B,T,H,P] f32, the final state [B,H,P,N] f32 and, with
``return_states``, every chunk's entering state [B,NC,H,P,N] f32 (NC the
number of chunks, the last one counted if short). K7 takes
those entering states and the cotangents dy (f32) and ds_final (f32) and
returns (dx, ddt, dA, dBm, dCm) in the reference's dtypes; its second
kernel sums the per-(batch, chunk, head) dA partials, as the reference's
wrapper does, so the wrapper issues no arithmetic of its own.

What bounds them on the H100 (700 W) at the port's shapes: K6 at the
serving shape (B8 T256 H80 P64 N128, bf16) moves ~86 MB, ~0.026 ms at 3.35
TB/s; K6 with states at the training shape (B36) ~570 MB, ~0.17 ms; K7 at
the training shape ~670 MB, ~0.20 ms. Both have a bf16 body for chunk <=
128, P <= 64, N <= 128 (every shape of the main paths) that runs every
chunk product on the tensor cores (mma.sync, f32 operands split into bf16
terms, three for K6's W, S and x o din; no TF32), one CTA of 8 warps
keeping the [q,q] tiles in registers 16 x 16 at a time and the carried
state's f32 master in registers; K6's CTAs are persistent, walking (head,
batch row) items, and sum each k16 step on the tensor cores from zero
before adding it in f32. f32 inputs and other bf16 shapes keep the f32 FMA
bodies. Both walk the chunks in order (K6) or in reverse (K7) carrying the
state (or its cotangent). K7 writes per-head f32 dB / dC partials and a
second kernel sums them over the heads in a fixed order: no atomics, so two
runs agree bit for bit. K7's f32 tiles at chunk 128 (P 64, N 128) need ~280
KB of shared memory, more than a block may have: with f32 inputs it runs at
chunk 64, and at chunk 128 its launch raises. See the notes at the top of
the CUDA sources.

The wrappers ``ssd_scan`` and ``ssd_scan_bwd`` launch the kernels for CUDA
tensors and raise on any shape, dtype, layout or device they do not take; a
CPU tensor goes to ``plain_ssd_scan`` / ``plain_ssd_scan_bwd``.
``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel launches,
``ssd_scan.tc.launches`` those of K6 that ran its tensor-core body.
``SSDScanFn`` ties the two together for autograd.
"""
from __future__ import annotations

import threading
import types
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _capability

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Plain versions (the CPU route and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def plain_ssd_scan(x, dt, A, Bm, Cm, chunk: int, return_states: bool = False,
                   init_state: Optional[torch.Tensor] = None):
    """The chunk-parallel SSD scan, as the reference's ``ssd_chunked``
    (``repro/models/ssm.py``) writes it, in f32, with chunk
    ``min(chunk, T)``. Returns (y [B,T,H,P], final state [B,H,P,N][,
    entering states [B,NC,H,P,N]]), all f32. ``init_state`` [B,H,P,N] is
    the state entering the first chunk. Where T is no multiple of the chunk,
    the last chunk is padded with zero steps (dt = 0, x = B = C = 0), which
    change neither the state nor any output row."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)
    f32 = torch.float32

    def chunks(v, *shape):
        v = v.to(f32)
        if nc * q > t:                    # zero steps pad the last chunk
            v = torch.cat([v, v.new_zeros((b, nc * q - t, *v.shape[2:]))], 1)
        return v.reshape(b, nc, q, *shape)
    xc = chunks(x, h, p)
    dtc = chunks(dt, h)
    bc = chunks(Bm, n)
    cc = chunks(Cm, n)
    cum = torch.cumsum(dtc * A.to(f32), dim=2)           # inclusive, <= 0
    cum_total = cum[:, :, -1:, :]
    # y_intra[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j; the
    # exponent is masked before exp (it is positive above the diagonal)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,i,j,h]
    g = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    w = cb[..., None] * g * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    # each chunk's own state: sum_j exp(cum_q - cum_j) dt_j B_j x_j^T
    decay_in = torch.exp(cum_total - cum) * dtc
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_in, bc, xc)
    chunk_decay = torch.exp(cum_total[:, :, 0, :])       # [b,nc,h]
    s = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    enter = []
    for c in range(nc):
        enter.append(s)
        s = chunk_decay[:, c, :, None, None] * s + s_chunk[:, c]
    s_enter = torch.stack(enter, dim=1)                  # [b,nc,h,p,n]
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc, s_enter,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :t]
    return (y, s, s_enter) if return_states else (y, s)


def plain_ssd_scan_bwd(x, dt, A, Bm, Cm, s_enter, dy, ds_final, chunk: int):
    """Gradients (dx, ddt, dA, dBm, dCm) of ``plain_ssd_scan`` in the
    inputs' dtypes, by autograd (which recomputes what ``s_enter`` holds,
    so it is not read)."""
    del s_enter
    ins = (x, dt, A, Bm, Cm)
    with torch.enable_grad():
        leaves = [v.detach().float().requires_grad_() for v in ins]
        y, s = plain_ssd_scan(*leaves, chunk)
        grads = torch.autograd.grad((y, s), leaves,
                                    (dy.float(), ds_final.float()))
    return tuple(g.to(v.dtype) for g, v in zip(grads, ins))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(device: torch.device, named) -> None:
    for name, v in named:
        if not v.is_cuda or v.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    cap = _capability(device.index)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device "
                           f"{device} has compute capability {cap}")


def check_ssd_args(x, dt, A, Bm, Cm, chunk: int) -> None:
    """What the CUDA kernels take; anything else raises."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"want x [B,T,H,P], dt [B,T,H], A [H], Bm/Cm "
                         f"[B,T,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:2]) != (b, t):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if chunk < 32 or chunk % 32:
        raise ValueError(f"chunk {chunk} must be a multiple of 32")
    if t < 1:
        raise ValueError(f"T={t} must be positive")
    if p % 8 or n % 8:
        raise ValueError(f"P={p} and N={n} must be multiples of 8")
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must all be float32 or all bfloat16; "
                         f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32; got {dt.dtype}, "
                         f"{A.dtype}")
    _check_cuda(x.device, (("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                           ("Cm", Cm)))


def _kernel_chunk(chunk: int, t: int) -> int:
    """The chunk the kernels run: ``chunk``, or T rounded up to 32 when the
    sequence is shorter (one chunk either way)."""
    return min(chunk, -(-t // 32) * 32)


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def fwd_body(x, Bm, chunk: int = 128) -> str:
    """Which K6 body ``ssd_scan`` launches for these CUDA inputs, as the C
    entry decides it: "tensor cores" (bf16, chunk <= 128, P <= 64, N <= 128)
    or "fma"."""
    q = _kernel_chunk(chunk, x.shape[1])
    tc = build.load().ssd_scan_fwd_tc_body(x.shape[-1], Bm.shape[-1], q,
                                           _DTYPE_CODES[x.dtype])
    return "tensor cores" if tc else "fma"


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128,
             return_states: bool = False, body: str = "auto"):
    """(y [B,T,H,P] f32, final state [B,H,P,N] f32[, entering states
    [B,NC,H,P,N] f32]) from K6 (CUDA) or ``plain_ssd_scan`` (CPU).
    ``body="fma"`` launches the FMA body whatever the dtype and shape, to
    hold the tensor-core body against it; no model path passes it."""
    if x.device.type == "cpu":
        return plain_ssd_scan(x, dt, A, Bm, Cm, chunk, return_states)
    if body not in ("auto", "fma"):
        raise ValueError(f"body must be 'auto' or 'fma'; got {body!r}")
    check_ssd_args(x, dt, A, Bm, Cm, chunk)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    q = _kernel_chunk(chunk, t)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, t, h, p), **f32)
    s_final = torch.empty((b, h, p, n), **f32)
    s_enter = (torch.empty((b, -(-t // q), h, p, n), **f32) if return_states
               else None)
    lib = build.load()
    tc = body == "auto" and fwd_body(x, Bm, chunk) == "tensor cores"
    entry = lib.ssd_scan_fwd if body == "auto" else lib.ssd_scan_fwd_fma
    with torch.cuda.device(x.device):
        err = entry(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            None if s_enter is None else s_enter.data_ptr(), b, t, h, p, n,
            q, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err)
    _count(ssd_scan)
    if tc:
        _count(ssd_scan.tc)
    return (y, s_final, s_enter) if return_states else (y, s_final)


def ssd_scan_bwd(x, dt, A, Bm, Cm, s_enter, dy, ds_final, *,
                 chunk: int = 128):
    """Gradients (dx, ddt, dA, dBm, dCm) of ``ssd_scan`` in the inputs'
    dtypes, from K7 (CUDA) or ``plain_ssd_scan_bwd`` (CPU). ``s_enter``
    comes from ``ssd_scan(..., return_states=True)``; dy [B,T,H,P] and
    ds_final [B,H,P,N] are f32."""
    if x.device.type == "cpu":
        return plain_ssd_scan_bwd(x, dt, A, Bm, Cm, s_enter, dy, ds_final,
                                  chunk)
    check_ssd_args(x, dt, A, Bm, Cm, chunk)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    q = _kernel_chunk(chunk, t)
    nc = -(-t // q)
    for name, v, shape in (("s_enter", s_enter, (b, nc, h, p, n)),
                           ("dy", dy, (b, t, h, p)),
                           ("ds_final", ds_final, (b, h, p, n))):
        if tuple(v.shape) != shape or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{v.dtype} {tuple(v.shape)}")
    _check_cuda(x.device, (("s_enter", s_enter), ("dy", dy),
                           ("ds_final", ds_final)))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, t, h), **f32)
    da_part = torch.empty((b, nc, h), **f32)
    da = torch.empty((h,), **f32)
    db_part = torch.empty((b, t, h, n), **f32)
    dc_part = torch.empty((b, t, h, n), **f32)
    db = torch.empty_like(Bm)
    dc = torch.empty_like(Cm)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), s_enter.data_ptr(), dy.data_ptr(),
            ds_final.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_part.data_ptr(), da.data_ptr(), db_part.data_ptr(),
            dc_part.data_ptr(),
            db.data_ptr(), dc.data_ptr(), b, t, h, p, n, q,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err)
    _count(ssd_scan_bwd)
    return dx, ddt, da, db, dc


ssd_scan.launches = 0
#: K6 launches that ran the tensor-core body (also counted in .launches)
ssd_scan.tc = types.SimpleNamespace(launches=0)
ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """The reference's custom VJP (``repro/kernels/dispatch.py``
    ``_ssd_with_twin_bwd``): K6 saving every chunk's entering state, and K7
    sweeping the chunks in reverse from them. An unused final state gets a
    zero cotangent, which still seeds the sweep."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, s_final, s_enter = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                       return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, s_enter)
        ctx.chunk = chunk
        ctx.set_materialize_grads(True)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        x, dt, A, Bm, Cm, s_enter = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, s_enter,
                             dy.float().contiguous(),
                             ds_final.float().contiguous(), chunk=ctx.chunk)
        return (*grads, None)
