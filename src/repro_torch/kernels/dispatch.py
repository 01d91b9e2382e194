"""Kernel routing for the model code.

Routing by device belongs to the kernel wrappers: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
CUDA kernel, which raises if the shape, dtype, layout or device is not one
it takes. There is no fallback and no environment variable between the two.

This module adds only the override ``set_mode`` / ``forced`` (mirroring the
reference's ``repro.kernels.dispatch``), which tests and ``chip_smoke.py``
use to run the plain route on the card for comparison:

  ``None`` (route by device) | ``"cuda"`` (kernel; a CPU tensor raises) |
  ``"torch"`` (plain version on any device).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (_plain_decode,
                                                  decode_attention as
                                                  _kernel_decode)
from repro_torch.kernels.flash_attention import _plain_dense, flash_attention

_MODES = ("cuda", "torch")
_override: Optional[str] = None


def set_mode(mode: Optional[str]) -> None:
    """Process-wide override; ``None`` restores routing by device."""
    global _override
    if mode is not None and mode not in _MODES:
        raise ValueError(f"mode must be None or one of {_MODES}, got {mode!r}")
    _override = mode


@contextlib.contextmanager
def forced(mode: str):
    """Temporarily force a route (tests, chip_smoke.py)."""
    prev = _override
    set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


def _forced_plain(x: torch.Tensor) -> bool:
    """True if the override sends this call to the plain version."""
    if _override == "cuda" and not x.is_cuda:
        raise ValueError("dispatch forced to 'cuda' but the tensor is on "
                         f"{x.device}; the CUDA kernels take CUDA tensors")
    return _override == "torch"


def dense_attention(q, k, v, *, window: Optional[int] = None):
    """Dense causal attention over the prompt (T == S, no KV cache).
    q: [B,T,H,D]; k/v: [B,T,KV,D] -> [B,T,H,D] in q.dtype."""
    if _forced_plain(q):
        return _plain_dense(q, k, v, causal=True, window=window)
    return flash_attention(q, k, v, causal=True, window=window)


def decode_attention(q, k, v, valid):
    """Single-token attention decode. q: [B,1,H,D]; k/v: [B,S,KV,D];
    valid: [B,S] bool -> [B,1,H,D] in q.dtype."""
    if _forced_plain(q):
        return _plain_decode(q, k, v, valid)
    return _kernel_decode(q, k, v, valid)
