"""PyTorch/CUDA port of the AcceRL reproduction (``src/repro`` is the JAX
reference it is held against).

The module layout mirrors ``repro``: ``configs``, ``kernels``, ``models``,
``runtime``. The port imports ``torch`` and numpy only; every hot kernel of
the reference's Pallas set that it carries is a hand-written CUDA kernel for
Hopper (``csrc/``), with a plain PyTorch version beside it for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Entry points default to
    ``"cuda"``; without a card that raises unless the caller asked for the
    CPU explicitly (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch route on the CPU")
    return dev
