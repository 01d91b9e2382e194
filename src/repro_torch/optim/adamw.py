"""AdamW with f32 moments over (possibly bf16) parameters, global-norm
clipping and a linear warmup, as in the reference ``repro/optim/adamw.py``.

Step for step the same arithmetic: grads are cast to f32 before clipping,
the bias corrections are ``1 - b ** step`` in f32, the step is
``mhat / (sqrt(vhat) + eps)``, and parameters are updated in f32, then
cast back to their dtype. ``torch.optim.AdamW`` places eps and the bias
correction differently, so it is not used.

The port updates ``params``, ``mu`` and ``nu`` IN PLACE, leaf by leaf, to
keep one copy of the optimizer state on the card (the returned trees share
those tensors); the reference returns fresh arrays. Temporaries live for
one leaf at a time.

Moments placed as DTensors over ``data`` (``optim/zero.py``, ZeRO-2) are
updated slice by slice: each rank applies the same per-element arithmetic
to its slice of the moments and of the parameter, then the parameter
slices are all-gathered. The global grad norm is taken on the full f32
grads before any slicing.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.optim import zero
from repro_torch.sharding.rules import is_dtensor
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # i32 scalar
    mu: dict               # first moments (f32), same tree as params
    nu: dict               # second moments (f32)


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def warmup_schedule(base_lr: float, warmup_steps: int) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp_max(
            (step.float() + 1.0) / max(warmup_steps, 1), 1.0)
        return base_lr * frac
    return lr


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(grads, state: AdamWState, params,
           lr: Union[torch.Tensor, float, Dict], *,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           weight_decay: float = 0.0, max_grad_norm: float = 0.0
           ) -> Tuple[dict, AdamWState, torch.Tensor]:
    """Returns (params, new_state, grad_norm); ``params``, ``state.mu`` and
    ``state.nu`` are updated in place. ``lr`` is one value or a tree of
    per-leaf values (the policy / value-head learning rates, Table 3)."""
    norm = global_norm(grads)            # of the f32 grads, before clipping
    scale = _clip_scale(norm, max_grad_norm) if max_grad_norm > 0 else None
    step = state.step + 1
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    lr_tree = lr if isinstance(lr, dict) else tree_map(lambda _: lr, params)

    def step_(p, g, m, v, lr_leaf):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square() * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr_leaf * delta).to(p.dtype))

    def upd(p, g, m, v, lr_leaf):
        if is_dtensor(m):
            zero.update_leaf(step_, p, g, m, v, lr_leaf)
        else:
            step_(p, g, m, v, lr_leaf)

    tree_map(upd, params, grads, state.mu, state.nu, lr_tree)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), norm


def grad_step(loss_fn: Callable, params, state: AdamWState,
              lr: Union[torch.Tensor, float]
              ) -> Tuple[dict, AdamWState, torch.Tensor]:
    """One ``update`` on the gradient of ``loss_fn(params)``, taken by
    autograd over detached copies of the leaves (grad mode is switched on
    for the call, whatever the thread's mode). Returns (params, new_state,
    loss); ``params`` and the moments are updated in place."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(leaves)
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(grads), leaves)
    params, state, _ = update(grads, state, params, lr)
    return params, state, loss.detach()
