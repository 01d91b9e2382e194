"""Single-token decode attention: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``_decode_kernel`` via ``decode_attention``). It reads the KV cache once
(bound by device-memory bytes at long caches, by launch overhead at the
serving path's short ones); one CTA per (kv head, batch row) serves every
query head of that kv head. Validity goes to the kernel as the bool mask's
bytes, not as an additive bias. See the note at the top of the CUDA source.

``decode_attention`` launches the kernel for CUDA tensors and raises on
what it does not take; a CPU tensor goes to ``_plain_decode``.
``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_DTYPE_CODES, NEG_INF,
                                                 check_attention_args)

_count_lock = threading.Lock()


def _plain_decode(q, k, v, valid):
    """Plain PyTorch version, the math of the reference's ``_twin_decode``:
    f32 scores, invalid slots set to NEG_INF, softmax cast to q.dtype
    before the value combine."""
    from repro_torch.models.attention import _gqa_combine, _gqa_scores
    scores = _gqa_scores(q, k) * (q.shape[-1] ** -0.5)      # [B,H,1,S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(weights, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: [B,1,H,D]; k/v: [B,S,KV,D]; valid: [B,S] bool (slots this token
    may attend) -> [B,1,H,D] in q.dtype."""
    if q.device.type == "cpu":
        return _plain_decode(q, k, v, valid)
    check_attention_args(q, k, v)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if t != 1:
        raise ValueError(f"decode kernel wants one query token, got T={t}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, s) \
            or valid.device != q.device or not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous bool [B,S]=({b},{s}) "
                         f"tensor on {q.device}; got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), b, s, h, kv, d, _DTYPE_CODES[q.dtype],
            d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err)
    with _count_lock:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
