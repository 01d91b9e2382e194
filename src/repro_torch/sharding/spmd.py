"""The placed step programs' split over the mesh: what GSPMD does for the
reference, done here by hand for the port's eager programs.

The reference jits ``seq_train_step``, ``prefill_step`` and ``serve_step``
(``repro/launch/steps.py``) with the batch sharded over the data axes
(``rules.data_spec``) and heads, ``d_ff``, experts, Mamba2 channels and
vocab sharded over ``model`` (the rules table); GSPMD then splits the
compute accordingly. Each rank of the port runs the split program itself:

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
  * **Tensor parallelism over model**, Megatron's layout on each rank's
    local shards, block by block where the rules put the block's leaves on
    their split axes (every family: a layer-stacked block's axis is one
    higher than a shared one's, as in the rules table):

      - attention (``attn``): ``wq`` on heads and ``wo`` on its rows of
        them; ``wk`` and ``wv`` on heads too where the KV heads divide
        ``model``, else (on ``head_dim``) used whole, each rank projecting
        only the KV heads its query heads read (``TensorParallel.kv``);
      - the MLP (``mlp``): ``w_gate``/``w_up`` on ``d_ff`` columns,
        ``w_down`` on its rows;
      - MoE (``moe``): each rank's experts; the router, top-k, priority,
        capacity and keep masks whole on every rank (from the block input
        before :class:`_Enter`), the dispatch and combine products and the
        SwiGLU on the rank's experts, the gates through :class:`_Enter`;
      - Mamba2 (``ssm``): each rank's heads (``out_proj``'s rows and
        ``norm_scale`` aligned with them), the fused ``in_proj`` and the
        conv used whole on the rank's z, x and dt columns plus B and C,
        K6/K7 on the rank's heads, the gated norm's mean of squares summed
        over ``model``;
      - the embedding (``vocab``): vocab-parallel
        (:meth:`TensorParallel.embed`).

    A block's input goes through :class:`_Enter` (identity forward, its
    gradient all-reduced), its row-parallel output through
    :class:`_Reduce` (the partial sums all-reduced).
  * **Leaves used whole inside a split block** (``Layout.summed``: ``wk``/
    ``wv`` off the heads axis, Mamba2's ``in_proj*``, ``conv_w``,
    ``conv_b``, ``A_log``, ``D``, ``dt_bias``): each model rank
    back-propagates only its heads, so its gradient of such a leaf is a
    part; the parts are summed over ``model`` once a step, after the
    accumulation, beside the data all-reduce (:meth:`Layout.sum_parts`).
  * **Gathered leaves.** Every other leaf sharded over the mesh (the action
    and value heads, ``prefix_proj``, a block whose leaves the rules put
    off their split axes) is gathered whole before use, and its gradient
    cut back to the rank's region (:func:`place_grads`). Leaves read
    outside every split block, or before its :class:`_Enter` (norm scales,
    the router), give every model rank the same gradient and are not
    summed.

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

# leaf (the last two keys of its path) -> (block, the dim of the unstacked
# leaf that carries ``model`` where the block is split)
_TP_LEAVES = {
    "attn/wq": ("attn", 1), "attn/wk": ("attn", 1), "attn/wv": ("attn", 1),
    "attn/wo": ("attn", 0),
    "mlp/w_gate": ("mlp", 1), "mlp/w_up": ("mlp", 1), "mlp/w_down": ("mlp", 0),
    "moe/w_gate": ("moe", 0), "moe/w_up": ("moe", 0), "moe/w_down": ("moe", 0),
    "ssm/out_proj": ("ssm", 0), "ssm/norm_scale": ("ssm", 0),
    "embed/table": ("vocab", 0),
}
# leaves a split block uses whole after its input's _Enter (gathered; each
# model rank's gradient a part): attention's where its KV heads are off the
# heads axis, every Mamba2 leaf but the two split ones
_WHOLE_IN = {
    "attn": ("attn/wk", "attn/wv"),
    "ssm": tuple(f"ssm/{k}" for k in (
        "in_proj", "in_proj_z", "in_proj_x", "in_proj_dt", "conv_w",
        "conv_b", "A_log", "D", "dt_bias")),
}
_KINDS = ("attn", "mlp", "moe", "ssm", "vocab")


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
    collectives of Megatron's layout. ``kv`` (attention only) is the slice
    of KV heads the rank's query heads read where ``wk``/``wv`` are used
    whole (their heads do not divide ``model``); ``None`` where the KV
    heads are split with the query heads."""

    def __init__(self, group, rank: int, size: int,
                 kv: Optional[slice] = None):
        self.group, self.rank, self.size, self.kv = group, rank, size, kv

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel sublayer's input (:class:`_Enter`)."""
        return _Enter.apply(x, self.group) if _needs_grad(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums, all-reduced
        (:class:`_Reduce`)."""
        if _needs_grad(x):
            return _Reduce.apply(x, [self.group])
        return _all_reduce(x.contiguous(), [self.group])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model`` where every rank uses the sum for its
        own part: its gradient is summed there too (:class:`_SumData` over
        the model group)."""
        if _needs_grad(x):
            return _SumData.apply(x, [self.group])
        return _all_reduce(_fresh(x), [self.group])

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated on ``dim`` in rank order (no
        gradient: the serving paths' cache regions)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        _dist().all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def part(self, n: int) -> slice:
        """The rank's contiguous chunk of an axis of ``n`` placed on
        ``model`` where ``n`` splits (``rules._first_fit``), else all of
        it."""
        if n % self.size or n == 1:
            return slice(0, n)
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

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
    moe: Optional[TensorParallel] = None
    ssm: Optional[TensorParallel] = None


@dataclasses.dataclass
class Layout:
    """The split a placed parameter tree gives the step programs."""

    mesh: object
    data: Optional[DataAxes]            # None where the data axes hold 1
    split: Split                        # the tensor-parallel groups
    keep: Dict[str, Tuple[int, ...]]    # leaf path -> mesh dims kept local
    summed: Tuple[str, ...] = ()        # leaves whose grads sum over model
    unsplit: Tuple[str, ...] = ()       # blocks present but not split

    def run(self, data_split: bool) -> Split:
        """The forward's :class:`Split`, with the data axes where the batch
        is split over them."""
        return self.split._replace(data=self.data if data_split else None)

    def tensor_parallel(self) -> List[str]:
        """The block kinds split over ``model``."""
        return [k for k in _KINDS if getattr(self.split, k) is not None]

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

    def sum_parts(self, grads) -> None:
        """The gradients of the leaves used whole inside a split block
        (``summed``), each model rank's part, summed in place over
        ``model``."""
        if not self.summed:
            return
        group = self.mesh.get_group("model")

        def one(path, g):
            if "/".join(path) in self.summed:
                _all_reduce(g, [group])
            return g
        tree_map_with_path(one, grads)


def _group_of(key: str):
    """(block, unstacked model dim or ``None``, the leaf's last two keys)
    of a leaf path the split knows, or ``None``."""
    leaf = "/".join(key.split("/")[-2:])
    if leaf in _TP_LEAVES:
        return (*_TP_LEAVES[leaf], leaf)
    if leaf in _WHOLE_IN["ssm"]:
        return "ssm", None, leaf
    return None


def _kv_slice(cfg: ModelConfig, size: int, rank: int) -> Optional[slice]:
    """The one KV head the rank's query heads read where ``wk``/``wv`` sit
    off the heads axis (the KV heads do not divide ``model``, so a rank's
    query heads never span whole groups); ``None`` where they span two
    groups, or ``head_dim``, which then carries the cache, does not split
    over ``model``."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hl, g = h // size, h // kv
    if not hl or hd % size or g % hl:
        return None
    lo = rank * hl // g
    return slice(lo, lo + 1)


def layout(cfg: ModelConfig, params) -> Optional[Layout]:
    """The :class:`Layout` of a parameter tree placed as DTensors (by
    ``rules.param_specs``), or ``None`` for plain tensors (one device).
    A block splits over ``model`` where every one of its leaves sits on
    its split axis (attention's ``wk``/``wv`` may instead be used whole,
    :func:`_kv_slice`; Mamba2's heads must divide ``model``)."""
    placed = [("/".join(p), x) for p, x in tree_leaves_with_path(params)
              if rules.is_dtensor(x)]
    if not placed:
        return None
    mesh = placed[0][1].device_mesh
    names = tuple(mesh.mesh_dim_names)
    data = DataAxes(mesh)
    split, keep, summed, unsplit = Split(), {}, (), ()
    m = names.index("model") if "model" in names else None
    if m is not None and mesh.size(m) > 1:
        size, rank = mesh.size(m), mesh.get_local_rank("model")
        # block -> [(path, leaf, on its split axis)]
        found: Dict[str, List[Tuple[str, str, bool]]] = {}
        for key, x in placed:
            got = _group_of(key)
            if got is None:
                continue
            block, dim, leaf = got
            plc = x.placements[m]
            on = dim is not None and plc.is_shard() and plc.dim == dim + (
                1 if rules._is_stacked(key) else 0)
            found.setdefault(block, []).append((key, leaf, on))
        tps, kept, parts = {}, [], []
        for block, leaves in found.items():
            whole = _WHOLE_IN["ssm"] if block == "ssm" else ()
            kv = None
            if block == "attn" and not all(on for _, _, on in leaves):
                # wq/wo on heads, wk/wv off them: used whole
                kv, whole = _kv_slice(cfg, size, rank), _WHOLE_IN["attn"]
                if kv is None:
                    continue
            if not all(on for _, leaf, on in leaves if leaf not in whole):
                continue
            if block == "ssm" and cfg.ssm.num_heads(cfg.d_model) % size:
                continue
            tps[block] = TensorParallel(mesh.get_group("model"), rank, size,
                                        kv=kv)
            kept += [k for k, leaf, _ in leaves if leaf not in whole]
            parts += [k for k, leaf, _ in leaves if leaf in whole]
        split = Split(**tps)
        keep = {key: (m,) for key in kept}
        summed = tuple(parts)
        unsplit = tuple(k for k in _KINDS if k in found and k not in tps)
    return Layout(mesh=mesh, data=data if data.size > 1 else None,
                  split=split, keep=keep, summed=summed, unsplit=unsplit)


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
    rows (``split``), and where a block is split over ``model`` its region
    of that block's cache, as ``rules.cache_specs`` places it: split
    attention's KV heads, or with its KV heads off the heads axis its
    ``head_dim`` slice of each; split Mamba2's heads of ``SSMState.ssm``
    and its contiguous chunk of ``SSMState.conv``'s channels. Each leaf a
    copy of its own (the cache ``prefill_step`` emits on the mesh, built
    here from a whole one)."""
    if lay is None:
        return cache
    attn, ssm = lay.split.attn, lay.split.ssm

    def region(path, x):
        if attn is not None and path[0] == "attn" and path[-1] in ("k", "v"):
            dim = 3 if attn.kv is None else 4
            x = x[(slice(None),) * dim + (attn.part(x.shape[dim]),)]
        elif ssm is not None and path[0] == "ssm" and path[-1] in ("ssm",
                                                                   "conv"):
            dim = 2 if path[-1] == "ssm" else 3
            x = x[(slice(None),) * dim + (ssm.part(x.shape[dim]),)]
        return x.clone()
    return tree_map_with_path(region, rows(cache, lay.mesh, dim=1,
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
    serving = kind != "train"
    attn = lay.split.attn
    what = {
        "attn": "attention on heads (wq/wk/wv column-, wo row-parallel"
                + (", the cache's KV heads" if serving else "") + ")"
                if attn is None or attn.kv is None else
                "attention on query heads (wq column-, wo row-parallel; wk/wv "
                "off the heads axis used whole, each rank projecting only the "
                "KV heads its query heads read"
                + {"train": "",
                   "prefill": "; prefill projects every KV head and keeps "
                              "its head_dim slice of each in the cache",
                   "decode": "; decode attends against those KV heads' "
                             "head_dim slices of the cache all-gathered "
                             "over model, the partial-score split being "
                             "queued (C10d)"}[kind] + ")",
        "mlp": "the MLP on d_ff (w_gate/w_up column-, w_down row-parallel)",
        "moe": "MoE on experts (the router, top-k, priority, capacity and "
               "keep masks whole on every rank; the dispatch and combine "
               "products and the SwiGLU on the rank's experts, the output "
               "all-reduced)",
        "ssm": "Mamba2 on heads (in_proj, the conv, A_log, D and dt_bias "
               "used whole on the rank's z, x and dt columns plus B and C; "
               "the SSD scan on the rank's heads; the gated norm's sum of "
               "squares and out_proj's rows all-reduced"
               + ("; the cache's SSM state on the rank's heads, its conv "
                  "tail's channels in contiguous chunks, all-gathered "
                  "whole where a step reads or writes it" if serving else "")
               + ")",
        "vocab": "the embedding on vocab"}
    if tp:
        parts.append("tensor parallelism over model: "
                     + "; ".join(what[k] for k in tp))
    sizes = rules.mesh_shape(lay.mesh)
    if sizes.get("model", 1) == 1:
        parts.append("no tensor parallelism over model (the model axis "
                     "holds one rank)")
    elif lay.unsplit:
        parts.append("not split over model (the rules put a leaf off its "
                     "split axis, or the heads do not split): "
                     + ", ".join(lay.unsplit))
    if kind == "train" and lay.summed:
        parts.append("grads of the leaves used whole inside a split block "
                     "summed over model once a step: " + ", ".join(
                         sorted({_short(k) for k in lay.summed})))
    gathered = lay.gathered(params)
    if gathered:
        parts.append("gathered whole before use: " + ", ".join(
            sorted({_short(k) for k in gathered})))
    if kind == "train":
        parts.append("ZeRO-2 moments updated slice by slice, the slices "
                     "all-gathered over data; attention (blockwise), the SSD "
                     "scan and the fused loss counted on their plain versions")
    else:
        parts.append("attention and the SSD scan counted on their plain "
                     "versions")
    return "; ".join(parts)


def _short(key: str) -> str:
    """A leaf path without its stacked-layer prefix."""
    for pre in ("layers_rem/", "layers/"):
        if key.startswith(pre):
            return key[len(pre):]
    return key
