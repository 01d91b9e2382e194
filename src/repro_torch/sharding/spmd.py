"""The placed step programs' split over the mesh: what GSPMD does for the
reference, done here by hand for the port's eager programs.

The reference jits ``seq_train_step``, ``prefill_step`` and ``serve_step``
(``repro/launch/steps.py``) with the batch sharded over the data axes
(``rules.data_spec``) and heads, ``d_ff`` and vocab sharded over ``model``
(the rules table); GSPMD then splits the compute accordingly. Each rank of
the port runs the split program itself:

  * **The data split** (every arch). The rank takes its rows of each
    micro-batch (:func:`rows`: ``rules.data_spec`` on its coordinate over
    the batch axes, ``("pod", "data")`` or ``("data",)``; a leading
    ``[accum]`` axis stays whole). The reference's losses are masked means
    over the global micro-batch, so each rank's term is weighted by its
    mask count over the global count (:func:`weights`), never averaged as
    per-rank means; the grads, the metrics and the advantage stats are then
    all-reduced over the data axes. A MoE block takes its capacity groups
    from the global micro-batch's token count and its load-balance and
    router-z means over the global micro-batch (:meth:`DataAxes.sum`).
  * **Tensor parallelism over model** (the dense family: dense, vlm and
    audio), Megatron's layout on each rank's local shards: ``attn/wq``,
    ``wk`` and ``wv`` on heads and ``mlp/w_gate`` and ``w_up`` on
    ``d_ff`` (column-parallel), ``attn/wo`` and ``mlp/w_down`` each
    followed by an all-reduce (row-parallel, :class:`_Reduce`), the
    sublayer's input through :class:`_Enter` (identity forward, all-reduce
    of its gradient), the embedding vocab-parallel
    (:meth:`TensorParallel.embed`). A group whose leaves the rules put on
    another axis (heads that do not divide ``model``) is not split.
  * **Gathered leaves.** Every other leaf sharded over the mesh (the action
    and value heads, ``prefix_proj``, every leaf of the ssm, moe and hybrid
    families) is gathered whole before use, and its gradient cut back to
    the rank's region (:func:`place_grads`). Replicated leaves (norm
    scales, biases) are used as they are; their gradients come out equal
    on every model rank and are not summed over ``model``.

Only all-reduce and all-gather are issued, the two kinds the reference's
record shows, as ``torch.distributed`` calls on plain tensors: the program
runs on NCCL and on gloo (CPU tensors, and CUDA tensors, which gloo stages
through the host). A mesh dim of one rank issues none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

#: the arch types whose attention and MLP blocks split over ``model``
TP_ARCHS = ("dense", "vlm", "audio")

# leaf path -> (group, the tensor dim that carries ``model``; the stacked
# layer axis counted)
_TP_LEAVES = {
    "layers/attn/wq": ("attn", 2), "layers/attn/wk": ("attn", 2),
    "layers/attn/wv": ("attn", 2), "layers/attn/wo": ("attn", 1),
    "layers/mlp/w_gate": ("mlp", 2), "layers/mlp/w_up": ("mlp", 2),
    "layers/mlp/w_down": ("mlp", 1),
    "embed/table": ("vocab", 0),
}


def _dist():
    import torch.distributed as dist
    return dist


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum ``x`` in place over each group in turn."""
    for g in groups:
        _dist().all_reduce(x, group=g)
    return x


def _fresh(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


class _Enter(torch.autograd.Function):
    """A column-parallel sublayer's input: identity forward, the gradient
    all-reduced over ``model`` (each rank's heads or ``d_ff`` columns give
    a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_fresh(g), [ctx.group]), None


class _Reduce(torch.autograd.Function):
    """A row-parallel product's output: the partial sums all-reduced over
    ``model``; the gradient passes as it is (what follows is the same on
    every model rank)."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(_fresh(x), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumData(torch.autograd.Function):
    """A sum over the data axes whose result every data rank uses in a term
    it weights by 1/size: its adjoint is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(_fresh(x), groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_fresh(g), ctx.groups), None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class TensorParallel:
    """The ``model`` group of a mesh and the rank's place in it: the
    collectives of Megatron's layout."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel sublayer's input (:class:`_Enter`)."""
        return _Enter.apply(x, self.group) if _needs_grad(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums, all-reduced
        (:class:`_Reduce`)."""
        if _needs_grad(x):
            return _Reduce.apply(x, [self.group])
        return _all_reduce(x.contiguous(), [self.group])

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Vocab-parallel lookup: ``table`` holds rows ``[rank * n, (rank +
        1) * n)`` of the vocabulary; ids outside that range look up zeros,
        and the all-reduce gives every rank the whole embedding (one
        nonzero term an element: the reference's values exactly)."""
        n = table.shape[0]
        ids = tokens.long() - self.rank * n
        ok = (ids >= 0) & (ids < n)
        x = table[ids.clamp(0, n - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return self.reduce(x)


class DataAxes:
    """The batch axes of a mesh (``rules.batch_axes``): their size, this
    rank's index over them (major to minor) and their groups."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        self.size, self.index, self.groups = 1, 0, []
        for a in rules.batch_axes(mesh):
            n = mesh.size(names.index(a))
            self.index = self.index * n + mesh.get_local_rank(a)
            self.size *= n
            if n > 1:
                self.groups.append(mesh.get_group(a))

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over the data axes (no gradient)."""
        return _all_reduce(x, self.groups)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axes into a new tensor; its gradient
        is summed there too (:class:`_SumData`)."""
        if _needs_grad(x):
            return _SumData.apply(x, self.groups)
        return _all_reduce(_fresh(x), self.groups)


class Split(NamedTuple):
    """What a forward runs under: the tensor-parallel group of each block
    kind (``None`` where it is not split) and the data axes where the batch
    is split over them."""

    attn: Optional[TensorParallel] = None
    mlp: Optional[TensorParallel] = None
    vocab: Optional[TensorParallel] = None
    data: Optional[DataAxes] = None


@dataclasses.dataclass
class Layout:
    """The split a placed parameter tree gives the step programs."""

    mesh: object
    data: Optional[DataAxes]            # None where the data axes hold 1
    split: Split                        # the tensor-parallel groups
    keep: Dict[str, Tuple[int, ...]]    # leaf path -> mesh dims kept local

    def run(self, data_split: bool) -> Split:
        """The forward's :class:`Split`, with the data axes where the batch
        is split over them."""
        return self.split._replace(data=self.data if data_split else None)

    def tensor_parallel(self) -> List[str]:
        """The block kinds split over ``model``."""
        return [k for k in ("attn", "mlp", "vocab")
                if getattr(self.split, k) is not None]

    def gathered(self, params) -> List[str]:
        """The leaves sharded over ``model`` that are gathered whole."""
        out = []
        for path, x in tree_leaves_with_path(params):
            key = "/".join(path)
            if rules.is_dtensor(x) and key not in self.keep and any(
                    p.is_shard() and x.device_mesh.size(m) > 1
                    for m, p in enumerate(x.placements)):
                out.append(key)
        return out


def layout(cfg: ModelConfig, params) -> Optional[Layout]:
    """The :class:`Layout` of a parameter tree placed as DTensors (by
    ``rules.param_specs``), or ``None`` for plain tensors (one device)."""
    placed = [("/".join(p), x) for p, x in tree_leaves_with_path(params)
              if rules.is_dtensor(x)]
    if not placed:
        return None
    mesh = placed[0][1].device_mesh
    names = tuple(mesh.mesh_dim_names)
    data = DataAxes(mesh)
    split, keep = Split(), {}
    m = names.index("model") if "model" in names else None
    if cfg.arch_type in TP_ARCHS and m is not None and mesh.size(m) > 1:
        tp = TensorParallel(mesh.get_group("model"),
                            mesh.get_local_rank("model"), mesh.size(m))
        found: Dict[str, List[Tuple[str, bool]]] = {}
        for key, x in placed:
            if key not in _TP_LEAVES:
                continue
            group, dim = _TP_LEAVES[key]
            plc = x.placements[m]
            found.setdefault(group, []).append(
                (key, plc.is_shard() and plc.dim == dim))
        want = {"attn": 4, "mlp": 3, "vocab": 1}
        on = {g for g, leaves in found.items()
              if len(leaves) == want[g] and all(ok for _, ok in leaves)}
        split = Split(*(tp if g in on else None
                        for g in ("attn", "mlp", "vocab")))
        keep = {key: (m,) for g in on for key, _ in found[g]}
    return Layout(mesh=mesh, data=data if data.size > 1 else None,
                  split=split, keep=keep)


def gather(x, keep: Tuple[int, ...] = ()) -> torch.Tensor:
    """A DTensor's value gathered over every mesh dim of more than one rank
    that shards it, but those in ``keep`` (innermost mesh dim first;
    ``all_gather`` lists, a copy: bit for bit). A plain tensor as it is."""
    if not rules.is_dtensor(x):
        return x
    mesh = x.device_mesh
    out = x.to_local()
    for m in reversed(range(mesh.ndim)):
        p = x.placements[m]
        if not p.is_shard() or mesh.size(m) == 1 or m in keep:
            continue
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(mesh.size(m))]
        _dist().all_gather(parts, out, group=mesh.get_group(m))
        out = torch.cat(parts, dim=p.dim)
    return out


def _live_region(x, keep: Tuple[int, ...]):
    """(shape, offset) of what :func:`gather` gives of ``x``."""
    from torch.distributed.tensor import Replicate
    plc = tuple(p if p.is_shard() and m in keep else Replicate()
                for m, p in enumerate(x.placements))
    return rules.local_region(tuple(x.shape), x.device_mesh, plc)


def live_params(params, lay: Layout, *, requires_grad: bool = False):
    """The plain tensors a forward under ``lay`` takes: the local shard of a
    tensor-parallel leaf, every other leaf gathered whole (detached leaves
    that require grad with ``requires_grad``)."""
    def one(path, x):
        t = gather(x, lay.keep.get("/".join(path), ()))
        return t.detach().requires_grad_(True) if requires_grad else t
    return tree_map_with_path(one, params)


def place_grads(grads, params, lay: Layout):
    """Each gradient (the shape of its live leaf) as a DTensor placed as its
    parameter: the parameter's region cut out of it."""
    from torch.distributed.tensor import DTensor

    def one(path, g, p):
        if not rules.is_dtensor(p):
            return g
        lshape, loff = rules.local_region(tuple(p.shape), p.device_mesh,
                                          p.placements)
        _, goff = _live_region(p, lay.keep.get("/".join(path), ()))
        local = g if tuple(g.shape) == lshape else rules.region(
            g, lshape, tuple(a - b for a, b in zip(loff, goff))).clone()
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return tree_map_with_path(one, grads, params)


def recut(g, sharding):
    """A gradient DTensor under ``sharding``, a refinement of its own
    placement (the moments' ZeRO-2 specs): its region of the local
    tensor, no collective."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    plc = rules.placements(sharding.spec, mesh)
    if tuple(plc) == tuple(g.placements):
        return g
    shape = tuple(g.shape)
    tshape, toff = rules.local_region(shape, mesh, plc)
    gshape, goff = rules.local_region(shape, g.device_mesh, g.placements)
    rel = tuple(a - b for a, b in zip(toff, goff))
    if any(r < 0 or r + n > m for r, n, m in zip(rel, tshape, gshape)):
        raise ValueError(f"{sharding.spec} is not a refinement of "
                         f"{g.placements}")
    local = rules.region(g.to_local(), tshape, rel).clone()
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=g.shape, stride=g.stride())


# ---------------------------------------------------------------------------
# The rank's rows, the cache's region and the loss weights
# ---------------------------------------------------------------------------

def splits(cfg: ModelConfig, mesh, global_batch: int,
           tokens_per_row: int) -> bool:
    """Whether the step programs split a batch of ``global_batch`` rows over
    the data axes: where ``rules.data_spec`` puts the batch on them (not
    long_500k's B = 1, whose sequence it puts there), and, for a MoE
    backbone, where the reference's capacity groups of the global batch
    (``moe.GROUP_TOKENS`` tokens) do not straddle two ranks' rows."""
    if rules.data_spec(mesh, global_batch, 1)[0] is None:
        return False
    if cfg.arch_type != "moe":
        return True
    from repro_torch.models.moe import GROUP_TOKENS
    n = global_batch * tokens_per_row
    size = rules._axis_size(rules.mesh_shape(mesh),
                            tuple(rules.batch_axes(mesh)))
    g = max(n // GROUP_TOKENS, 1)
    return n % g == 0 and (n // size) % (n // g) == 0


def rows(tree, mesh, *, dim: int = 0, split: bool = True):
    """The rank's rows of each leaf of a batch (or cache) tree: ``dim`` cut
    into as many equal parts as the data axes hold ranks, the part at the
    rank's index (views). ``split=False`` keeps the whole batch."""
    data = DataAxes(mesh)

    def cut(_, x):
        if not split or data.size == 1:
            return x
        n = x.shape[dim]
        if n % data.size:
            raise ValueError(f"{n} rows do not split over {data.size} data "
                             f"ranks")
        k = n // data.size
        return x.narrow(dim, data.index * k, k)
    return tree_map_with_path(cut, tree)


def local_cache(cache, lay: Optional[Layout], *, split: bool = True):
    """The rank's part of a whole decode cache (leaves ``[L, B, ...]``): its
    rows (``split``), and where attention is split over ``model`` its KV
    heads, as ``rules.cache_specs`` places them; each leaf a copy of its
    own (the cache ``prefill_step`` emits on the mesh, built here from a
    whole one)."""
    if lay is None:
        return cache
    tp = lay.split.attn

    def heads(path, x):
        if tp is not None and path[-1] in ("k", "v") and path[0] == "attn":
            n = x.shape[3] // tp.size
            x = x.narrow(3, tp.rank * n, n)
        return x.clone()
    return tree_map_with_path(heads, rows(cache, lay.mesh, dim=1,
                                          split=split))


def weights(mask: torch.Tensor, accum: int, data: Optional[DataAxes]):
    """Each micro-batch's weight of this rank's masked means: ``max(n, 1) /
    max(N, 1)`` with ``n`` the rank's mask count and ``N`` the global
    micro-batch's (one all-reduce for the window), so that the weighted
    means sum over the data axes to the reference's ``sum / max(N, 1)``.
    ``None`` each where the batch is not split."""
    if data is None:
        return [None] * accum
    n = mask.detach().float().reshape(accum, -1).sum(dim=1)
    total = data.sum_(n.clone())
    return list(torch.clamp_min(n, 1.0) / torch.clamp_min(total, 1.0))


def sum_metrics(metrics: Dict[str, torch.Tensor], stats: torch.Tensor,
                data: DataAxes):
    """The rank's weighted metrics and advantage stats summed over the data
    axes (one all-reduce): the global micro-batch's."""
    keys = list(metrics)
    packed = torch.cat([torch.stack([metrics[k].float() for k in keys]),
                        stats.float()])
    data.sum_(packed)
    return dict(zip(keys, packed[:len(keys)])), packed[len(keys):]


def program(cfg: ModelConfig, lay: Optional[Layout], params, kind: str,
            data_split: bool) -> str:
    """What a placed step program runs: the ``program`` field of the dry
    run's records."""
    step = {"train": "seq_train_step", "prefill": "prefill_step",
            "decode": "serve_step"}[kind]
    if lay is None:
        return f"eager {step} on one device"
    parts = [f"eager {step} on every rank"]
    if lay.data is None:
        parts.append("the data axes hold one rank")
    elif data_split:
        parts.append("the rank's rows of the batch (split over "
                     + ", ".join(rules.batch_axes(lay.mesh)) + ")"
                     + ("; each loss term weighted by the rank's mask count "
                        "over the global micro-batch's, the grads, metrics "
                        "and advantage stats all-reduced over data"
                        if kind == "train" else ""))
    else:
        parts.append("the whole batch on every rank (not split over data: "
                     "its batch is not on the data axes"
                     + (", or a MoE capacity group straddles two ranks"
                        if cfg.arch_type == "moe" else "") + ")")
    tp = lay.tensor_parallel()
    what = {"attn": "attention on heads (wq/wk/wv column-, wo row-parallel)",
            "mlp": "the MLP on d_ff (w_gate/w_up column-, w_down "
                   "row-parallel)",
            "vocab": "the embedding on vocab"}
    if tp:
        parts.append("tensor parallelism over model: "
                     + "; ".join(what[k] for k in tp)
                     + (", the local KV cache's heads" if "attn" in tp
                        and kind != "train" else ""))
    else:
        sizes = rules.mesh_shape(lay.mesh)
        parts.append("no tensor parallelism over model ("
                     + ("the model axis holds one rank"
                        if sizes.get("model", 1) == 1
                        else f"arch type {cfg.arch_type}"
                        if cfg.arch_type not in TP_ARCHS
                        else "no block's leaves on their split axes") + ")")
    gathered = lay.gathered(params)
    if gathered:
        parts.append("gathered whole before use: " + ", ".join(
            sorted({_short(k) for k in gathered})))
    if kind == "train":
        parts.append("ZeRO-2 moments updated slice by slice, the slices "
                     "all-gathered over data; attention (blockwise) and the "
                     "fused loss counted on their plain versions")
    else:
        parts.append("attention counted on its plain version")
    return "; ".join(parts)


def _short(key: str) -> str:
    """A leaf path without its stacked-layer prefix."""
    for pre in ("layers_rem/", "layers/"):
        if key.startswith(pre):
            return key[len(pre):]
    return key
