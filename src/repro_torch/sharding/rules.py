"""Logical-axis partition rules for every architecture family, as in the
reference ``repro/sharding/rules.py``, and their placement as DTensors.

Parameters are plain-dict trees; specs are assigned by matching the leaf
*path* (e.g. ``layers/attn/wq``) against a rules table of *candidate*
shardings. Each candidate is ``(axis_index, mesh_axis_or_tuple)``; the
first candidate whose dimension is divisible by the mesh-axis size wins,
so one rules table covers all ten assigned architectures (head counts,
KV-group counts, vocab sizes and expert counts all differ in divisibility).

Baseline layout (the reference's DESIGN.md §5):
  * ``model`` — tensor parallel: heads / d_ff / experts / vocab
  * ``data``  — batch; Adam moments additionally ZeRO-2-sharded on it;
    for >30B-param archs the expert/ff axes are *also* sharded on ``data``
    (FSDP-style) so dbrx-132b fits.
  * ``pod``   — outermost data-parallel axis in the multi-pod mesh.

A spec is a :class:`PartitionSpec`: per tensor dim ``None``, a mesh axis
name, or a tuple of names (major to minor), the entries of the
reference's ``jax.sharding.PartitionSpec``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or an
:class:`AbstractMesh` (names and sizes only, no process group) where only
the specs are wanted. :func:`placements` turns a spec on a ``DeviceMesh``
into DTensor placements, and :func:`place` builds the DTensor from a
full tensor that every rank holds, cutting out the rank's own region
(no collective).
"""
from __future__ import annotations

import dataclasses
import math
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map, tree_map_with_path

Axis = Union[str, Tuple[str, ...]]
Candidate = Tuple[int, Axis]

# FSDP threshold: above this parameter count, weight matrices are also
# sharded over ``data`` (granite-20b/starcoder2/dbrx: f32 gradients at
# tensor-parallel-only sharding would alone eat a large share of a chip).
FSDP_PARAM_THRESHOLD = 12_000_000_000


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (major to minor). Trailing dims may be left out (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes alone: specs for a production mesh
    (16 x 16, 2 x 16 x 16) need no process group."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for names {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, of a ``DeviceMesh`` (by
    ``mesh.size(dim)``) or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the device mesh needs named dims "
                         "(mesh_dim_names)")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _names(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def _axis_size(sizes: Dict[str, int], axis: Axis) -> int:
    return math.prod(sizes[a] for a in _names(axis))


def _first_fit(shape: Sequence[int], candidates: List[Candidate],
               sizes: Dict[str, int],
               taken: Optional[Dict[int, Axis]] = None) -> Dict[int, Axis]:
    """Greedy multi-axis assignment: place each candidate mesh axis on the
    first tensor dim that divides, skipping dims already taken."""
    out: Dict[int, Axis] = dict(taken or {})
    used_mesh = {a for ax in out.values() for a in _names(ax)}
    for idx, axis in candidates:
        names = _names(axis)
        if any(a in used_mesh for a in names):
            continue
        i = idx if idx >= 0 else len(shape) + idx
        if i in out or i < 0 or i >= len(shape):
            continue
        if shape[i] % _axis_size(sizes, axis) == 0 and shape[i] > 1:
            out[i] = axis
            used_mesh.update(names)
    return out


def _to_spec(shape: Sequence[int], assign: Dict[int, Axis]) -> P:
    return P(*[assign.get(i) for i in range(len(shape))])


# ---------------------------------------------------------------------------
# Rules table — matched against the '/'-joined leaf path (the reference's,
# entry for entry). Axis indices are relative to the *unstacked* tensor; a
# leading layer-stack dim shifts them by +1 automatically.
# ---------------------------------------------------------------------------

# When the head count does not divide the model axis, prefer sharding the
# CONTRACTING d_model axis (one all-reduce per layer) over head_dim (an
# all-reduce per KV block). Off, as in the reference.
ATTN_PREFER_DMODEL = False

# (pattern, tp_candidates, fsdp_candidates)
_RULES: List[Tuple[str, List[Candidate], List[Candidate]]] = [
    # embedding: vocab on model, fallback d_model
    (r"embed/table$", [(0, "model"), (1, "model")], [(1, "data")]),
    (r"action_head/w$", [(1, "model"), (0, "model")], []),
    (r"prefix_proj/w$", [(1, "model")], []),
    # attention
    (r"attn/wq$", [(1, "model"), (2, "model"), (0, "model")], [(0, "data")]),
    (r"attn/wk$", [(1, "model"), (2, "model"), (0, "model")], [(0, "data")]),
    (r"attn/wv$", [(1, "model"), (2, "model"), (0, "model")], [(0, "data")]),
    (r"attn/wo$", [(0, "model"), (1, "model"), (2, "model")], [(2, "data")]),
    # dense MLP: d_ff on model
    (r"mlp/w_gate$", [(1, "model")], [(0, "data")]),
    (r"mlp/w_up$", [(1, "model")], [(0, "data")]),
    (r"mlp/w_down$", [(0, "model")], [(1, "data")]),
    # MoE: experts on model, per-expert ff on data when FSDP
    (r"moe/router$", [], []),
    (r"moe/w_gate$", [(0, "model")], [(2, "data")]),
    (r"moe/w_up$", [(0, "model")], [(2, "data")]),
    (r"moe/w_down$", [(0, "model")], [(1, "data")]),
    # Mamba2 / SSD
    (r"ssm/in_proj$", [(1, "model")], [(0, "data")]),
    (r"ssm/in_proj_z$", [(1, "model")], [(0, "data")]),
    (r"ssm/in_proj_x$", [(1, "model")], [(0, "data")]),
    (r"ssm/in_proj_dt$", [(1, "model")], [(0, "data")]),
    (r"ssm/conv_w$", [(1, "model")], []),
    (r"ssm/conv_b$", [(0, "model")], []),
    (r"ssm/out_proj$", [(0, "model")], [(1, "data")]),
    (r"ssm/norm_scale$", [(0, "model")], []),
    # value head (f32): the hidden MLP is d×d — shard its wide axis
    (r"value_head/mlp_w1$", [(1, "model")], [(0, "data")]),
    (r"value_head/step_emb$", [(1, "model")], []),
    # everything small (norm scales, A_log, D, dt_bias, biases)
    (r".*", [], []),
]


def _match(path: str) -> Tuple[List[Candidate], List[Candidate]]:
    for pat, tp, fsdp in _RULES:
        if re.search(pat, path):
            if ATTN_PREFER_DMODEL and pat.startswith(r"attn/w"):
                if pat == r"attn/wo$":
                    tp = [(0, "model"), (2, "model"), (1, "model")]
                else:
                    tp = [(1, "model"), (0, "model"), (2, "model")]
            return tp, fsdp
    return [], []


def _leaf_path(path: Tuple[str, ...]) -> str:
    return "/".join(str(p) for p in path)


def _is_stacked(path: str) -> bool:
    return path.startswith(("layers/", "layers_rem/")) \
        or "/layers/" in path or "/layers_rem/" in path


def param_specs(cfg: ModelConfig, params, mesh, *,
                fsdp: Optional[bool] = None, tp: bool = True):
    """Spec tree for a parameter tree (tensors, or ``meta`` tensors for a
    tree that costs no memory).

    ``tp=False`` (pure data parallelism): parameters fully replicated —
    for models that fit per chip, dropping tensor parallelism removes
    every per-layer collective; only the gradient all-reduce remains."""
    if fsdp is None:
        fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
    if not tp:
        return tree_map(lambda leaf: P(*([None] * len(leaf.shape))), params)
    sizes = mesh_shape(mesh)

    def assign(path, leaf):
        pstr = _leaf_path(path)
        shape = tuple(leaf.shape)
        tp_c, fs = _match(pstr)
        shift = 1 if _is_stacked(pstr) else 0
        cands = [(i + shift if i >= 0 else i, a) for i, a in tp_c]
        if fsdp:
            cands += [(i + shift if i >= 0 else i, a) for i, a in fs]
        return _to_spec(shape, _first_fit(shape, cands, sizes))

    return tree_map_with_path(assign, params)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The (composite) data-parallel axis: ('pod','data') on multi-pod."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def data_spec(mesh, global_batch: int, ndim: int, *,
              seq_axis: Optional[int] = None, seq_len: int = 0) -> P:
    """Spec for a batch tensor [B, ...]. Batch goes on the composite data
    axis when divisible; otherwise (long_500k, B=1) the sequence axis is
    sharded over ``data`` instead (context parallelism)."""
    sizes = mesh_shape(mesh)
    dp = batch_axes(mesh)
    dp_size = _axis_size(sizes, tuple(dp))
    entries: List[Optional[Axis]] = [None] * ndim
    if global_batch % dp_size == 0 and global_batch > 1:
        entries[0] = tuple(dp) if len(dp) > 1 else dp[0]
    elif seq_axis is not None and seq_len % sizes["data"] == 0:
        entries[seq_axis] = "data"
    return P(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``. On a
    ``DeviceMesh`` it places a tensor (:func:`place`)."""

    mesh: object
    spec: P


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def cache_specs(cfg: ModelConfig, cache, mesh, global_batch: int,
                cache_len: int, seq_shard_model: bool = False):
    """Spec tree for the ``DecodeCache`` (leaves carry a leading stacked
    layer axis, then batch). Batch shards on data when divisible; for
    batch=1 long-context the KV sequence axis shards on data (context
    parallel). Head-ish axes go on model when divisible."""
    sizes = mesh_shape(mesh)
    dp = batch_axes(mesh)
    dp_size = _axis_size(sizes, tuple(dp))
    batch_ok = global_batch % dp_size == 0 and global_batch > 1

    def assign(path, leaf):
        pstr = _leaf_path(path)
        shape = tuple(leaf.shape)
        assign_map: Dict[int, Axis] = {}
        if batch_ok and len(shape) >= 2:
            assign_map[1] = tuple(dp) if len(dp) > 1 else dp[0]
        if pstr.endswith((".k", ".v", "/k", "/v")) or "positions" in pstr:
            # KVCache: [L, B, S, KV, hd]
            if not batch_ok and len(shape) >= 3 \
                    and shape[2] % sizes["data"] == 0 and shape[2] > 1:
                assign_map[2] = "data"
            if seq_shard_model and len(shape) >= 3 \
                    and shape[2] % sizes["model"] == 0:
                # flash-decoding context parallelism: shard the KV
                # SEQUENCE over model; softmax combines partial (max, sum)
                assign_map[2] = ("data", "model") \
                    if assign_map.get(2) == "data" else "model"
            elif len(shape) == 5:
                assign_map.update(_first_fit(
                    shape, [(3, "model"), (4, "model")], sizes,
                    taken=assign_map))
        elif "ssm" in pstr and len(shape) == 5:
            # SSMState.ssm: [L, B, H, P, N] — heads on model
            assign_map.update(_first_fit(
                shape, [(2, "model"), (3, "model")], sizes, taken=assign_map))
        elif "conv" in pstr and len(shape) == 4:
            # SSMState.conv: [L, B, K-1, C] — channels on model
            assign_map.update(_first_fit(
                shape, [(3, "model")], sizes, taken=assign_map))
        return _to_spec(shape, assign_map)

    return tree_map_with_path(assign, cache)


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``, one per mesh
    dim: ``Shard(i)`` where tensor dim ``i`` names the mesh dim, else
    ``Replicate()``. A tuple entry shards one tensor dim over several mesh
    dims; DTensor splits over mesh dims in the mesh's order (the first
    outermost), so the tuple's names must come in that order, as the
    reference's major-to-minor tuples do."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_shape(mesh))
    owner: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        got = _names(entry)
        for n in got:
            if n not in names:
                raise ValueError(f"{spec}: {n!r} is not a dim of the mesh "
                                 f"{names}")
            if n in owner:
                raise ValueError(f"{spec}: mesh dim {n!r} used twice")
            owner[n] = i
        if list(got) != sorted(got, key=names.index):
            raise ValueError(f"{spec}: {got} is not in the mesh's order "
                             f"{names}")
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def local_region(shape: Sequence[int], mesh, plc) -> Tuple[Tuple[int, ...],
                                                          Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under placements ``plc``: each ``Shard(d)``, mesh dim by mesh
    dim in the mesh's order, splits dim ``d`` of the current region into
    equal parts and keeps the one at this rank's coordinate."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    size = list(shape)
    off = [0] * len(shape)
    for m, p in enumerate(plc):
        if not p.is_shard():
            continue
        n = mesh.size(m)
        if size[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                             f"split into {n} equal parts")
        size[p.dim] //= n
        off[p.dim] += coord[m] * size[p.dim]
    return tuple(size), tuple(off)


def region(tensor: torch.Tensor, shape: Sequence[int],
           offset: Sequence[int]) -> torch.Tensor:
    """The view ``tensor[offset : offset + shape]``."""
    return tensor[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def place(tensor: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``tensor`` (the full value, the same on every rank)
    under ``sharding``: this rank's region, copied out so the full tensor
    can be freed (kept as it is where the region is the whole tensor)."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    plc = placements(sharding.spec, mesh)
    shape = tuple(tensor.shape)
    lshape, off = local_region(shape, mesh, plc)
    local = tensor if lshape == shape else region(tensor, lshape,
                                                  off).clone()
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def place_tree(tree, mesh, specs):
    """:func:`place` over a tree and its spec tree."""
    return tree_map(lambda t, s: place(t, NamedSharding(mesh, s)), tree,
                    specs)


def spec_tree(shardings):
    """The spec tree of a tree of ``NamedSharding``s."""
    return tree_map(lambda s: s.spec, shardings)


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (none exists before ``torch.distributed.tensor``
    is imported, so the plain path imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def full_tensor(x):
    """The full value of ``x``: a plain tensor as it is; a DTensor's local
    tensor where it is sharded only over mesh dims of size 1 (no
    collective), else its all-gather."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    if all(not p.is_shard() or mesh.size(m) == 1
           for m, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()
