"""ZeRO-2-style partitioning of optimizer state over the ``data`` axis, as
in the reference ``repro/optim/zero.py``.

Paper §3.1: "Trainer Workers employ ZeRO-2 to partition optimizer states and
gradients, supporting larger micro-batch sizes." Parameters keep their
tensor-parallel placement (replicated across ``data``), while the f32 Adam
moments are *additionally* sharded over ``data`` along each tensor's
largest divisible axis; a leaf whose parameter is already placed over
``data`` (FSDP) gets nothing more.

The moments are DTensors under those specs. ``adamw.update`` takes them
through :func:`update_leaf`: each rank updates its slice of the moments
and of the parameter from the f32 gradient, and the updated parameter
slices are all-gathered over ``data`` (over no mesh dim of one rank).
In the placed step programs (``sharding/spmd.py``) each rank computes the
gradients of its rows and they are all-reduced over ``data``: the
reference's record shows all-reduce and no reduce-scatter, and each rank
reads its slice of the summed gradients it holds.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding.rules import (P, NamedSharding, full_tensor,
                                        is_dtensor, local_region, mesh_shape,
                                        place, region)
from repro_torch.tree import tree_leaves, tree_map


def _zero_spec_for(shape, param_spec: P, data_axis: str,
                   data_size: int) -> P:
    """Pick the largest axis not already sharded and divisible by data."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    # FSDP-style params already consume the data axis - nothing to add
    for e in entries:
        names = e if isinstance(e, tuple) else (e,)
        if data_axis in names:
            return param_spec
    best, best_dim = None, 0
    for i, (dim, taken) in enumerate(zip(shape, entries)):
        if taken is not None:
            continue
        if dim % data_size == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is None:
        return param_spec
    entries[best] = data_axis
    return P(*entries)


def shard_moments_spec(param_shapes, param_specs, *, data_axis: str = "data",
                       data_size: int = 16):
    """``param_shapes``: a tree of tensors (``meta`` ones will do);
    ``param_specs``: its spec tree. Returns the ZeRO-sharded moments spec
    tree."""
    return tree_map(
        lambda s, spec: _zero_spec_for(tuple(s.shape), spec, data_axis,
                                       data_size),
        param_shapes, param_specs)


def moments_bytes_per_device(param_count: int, data_size: int,
                             zero: bool) -> float:
    """Analytic check of the ZeRO-2 memory claim (2 × f32 moments)."""
    total = 2 * 4 * param_count
    return total / (data_size if zero else 1)


# --------------------------------------------------------------------------
# live-state wiring: turn the spec trees into DTensor placements
# --------------------------------------------------------------------------

def moment_shardings(params, mesh, *, param_specs=None,
                     data_axis: str = "data"):
    """``NamedSharding`` tree for the f32 moments of ``params`` on ``mesh``.

    ``param_specs`` defaults to fully-replicated (pure ZeRO, no tensor
    parallelism) — pass the tree from ``sharding.rules.param_specs`` to
    compose ZeRO with the TP/FSDP layout.
    """
    data_size = mesh_shape(mesh).get(data_axis, 1)
    if param_specs is None:
        param_specs = tree_map(lambda p: P(), params)
    mspecs = shard_moments_spec(params, param_specs, data_axis=data_axis,
                                data_size=data_size)
    return tree_map(lambda s: NamedSharding(mesh, s), mspecs)


def shard_opt_state(opt, mesh, *, param_specs=None, data_axis: str = "data"):
    """Re-place an ``adamw.AdamWState`` so mu/nu live under the ZeRO specs
    (as DTensors on ``mesh``)."""
    shardings = moment_shardings(opt.mu, mesh, param_specs=param_specs,
                                 data_axis=data_axis)

    def put(tree):
        return tree_map(lambda t, s: place(full_tensor(t), s), tree,
                        shardings)
    return opt._replace(mu=put(opt.mu), nu=put(opt.nu))


def _nbytes(t) -> int:
    local = t.to_local() if is_dtensor(t) else t
    return local.numel() * local.element_size()


def realized_moments_bytes_per_device(opt) -> int:
    """Measured per-device footprint of the moments: the bytes of this
    rank's local shards, maxed over the ranks with an all-reduce when the
    group has more than one.

    On an even ZeRO layout every device holds the same number of bytes,
    so this equals the analytic ``moments_bytes_per_device`` when every
    tensor found a divisible axis.
    """
    import torch.distributed as dist
    local = sum(_nbytes(t) for tree in (opt.mu, opt.nu)
                for t in tree_leaves(tree))
    if dist.is_initialized() and dist.get_world_size() > 1:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        buf = torch.tensor([local], dtype=torch.int64, device=dev)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        local = int(buf.item())
    return local


def update_leaf(step: Callable, p, g, m, v, lr) -> None:
    """ZeRO-2 for one leaf whose moments ``m``, ``v`` are DTensors:
    ``step(p_part, g_part, m_local, v_local, lr)`` (the per-element AdamW
    arithmetic, in place) on this rank's region of the moments, with the
    matching region of the gradient ``g`` and of the parameter ``p`` (each
    a full tensor, or a DTensor whose local region holds the moments'
    region, as one placed like the parameter does); then the updated
    parameter regions are all-gathered (a copy, bit for bit) over the mesh
    dim that shards the moments but not the parameter, so every rank holds the whole
    updated parameter (its own placement of it)."""
    import torch.distributed as dist
    mesh = m.device_mesh
    shape = tuple(m.shape)
    mshape, moff = local_region(shape, mesh, m.placements)

    def local(x):
        """(local tensor, placements or None, offset of its region)."""
        if is_dtensor(x):
            _, off = local_region(shape, x.device_mesh, x.placements)
            return x.to_local(), x.placements, off
        return x, None, (0,) * len(shape)

    def part(loc, off):
        return region(loc, mshape, tuple(a - b for a, b in zip(moff, off)))
    p_loc, p_plc, poff = local(p)
    g_loc, _, goff = local(g)
    p_part = part(p_loc, poff)
    step(p_part, part(g_loc, goff), m.to_local(), v.to_local(), lr)
    extra = [(i, pl) for i, pl in enumerate(m.placements)
             if pl.is_shard() and mesh.size(i) > 1
             and (p_plc is None or p_plc[i] != pl)]
    if not extra:
        return
    if len(extra) > 1:
        raise ValueError(f"moments {m.placements} shard over more mesh "
                         f"dims than the parameter {p_plc} plus one")
    (i, pl), = extra
    part = p_part.contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.size(i))]
    dist.all_gather(parts, part, group=mesh.get_group(i))
    whole = torch.cat(parts, dim=pl.dim)
    if whole.shape != p_loc.shape:
        raise ValueError(f"gathered {tuple(whole.shape)} for a parameter "
                         f"shard of {tuple(p_loc.shape)}")
    p_loc.copy_(whole)
