"""Parameter trees between the JAX reference and the port, through numpy.

``params_from_numpy`` takes the reference's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the same
nested dict with torch tensors. Keys are the JAX tree paths, so nothing is
renamed; stacked per-layer leaves keep their leading ``L`` axis.

``wm_params_from_numpy`` carries the reference's world-model parameters
(and AdamW moments, when given) the same way.

``batch_from_numpy`` carries a numpy ``TrajectoryBatch`` (as
``dummy_batch`` or the reference's rollout makes it) to the device, leaf by
leaf, with the same dtypes.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays. They are carried
bit-exactly through a ``uint16`` view, recognised by ``dtype.name`` so this
module never needs ``ml_dtypes`` on the way in.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.trajectory import TrajectoryBatch
from repro_torch.optim import adamw


def _leaf_to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")           # contiguous, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tensor_to_leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], *,
                      device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy leaves -> the same nested dict of tensors."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_tensor(np.asarray(node), dev)
    return conv(tree)


def wm_params_from_numpy(tree: Dict[str, Any], *,
                         device="cuda") -> Dict[str, Any]:
    """The reference's world-model parameters ``{"obs": …, "reward": …}``
    with numpy leaves -> the port's f32 tensors, with the AdamW moments
    ``"obs_opt"`` / ``"reward_opt"``: carried when the tree has them (as
    numpy ``(step, mu, nu)``), fresh otherwise."""
    dev = resolve_device(device)
    out = {k: params_from_numpy(tree[k], device=dev)
           for k in ("obs", "reward")}
    for k in ("obs", "reward"):
        opt = tree.get(f"{k}_opt")
        out[f"{k}_opt"] = adamw.init(out[k]) if opt is None else \
            adamw.AdamWState(
                step=_leaf_to_tensor(np.asarray(opt[0]), dev),
                mu=params_from_numpy(opt[1], device=dev),
                nu=params_from_numpy(opt[2], device=dev))
    return out


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``params_from_numpy``: bf16 tensors come back as
    ``ml_dtypes.bfloat16`` arrays with the same bits."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _tensor_to_leaf(tree)


def batch_from_numpy(batch: TrajectoryBatch, *,
                     device="cuda") -> TrajectoryBatch:
    """A ``TrajectoryBatch`` of numpy arrays -> the same batch of tensors
    on ``device`` (``None`` leaves stay ``None``)."""
    dev = resolve_device(device)
    return TrajectoryBatch(*(
        None if x is None else _leaf_to_tensor(np.asarray(x), dev)
        for x in batch))
