"""Roofline terms of a step program, as in the reference
``repro/roofline/analysis.py`` (no real hardware):

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = collective_bytes / link_bw

per device, over the NVIDIA H100 constants of ``launch/mesh.py``.

The reference reads its terms from XLA: ``cost_analysis()`` of the
compiled, partitioned module (FLOPs and "bytes accessed") and a parse of
the post-optimization HLO text for the collectives. The port has no
compiled module and no HLO: ``terms_from_program`` RUNS the program (on
``meta`` tensors for a dry run, so nothing is computed or allocated) and
counts, op by op, what the eager program issues:

  * FLOPs with ``torch.utils.flop_counter.FlopCounterMode``;
  * bytes as each op's input and output bytes (views and allocations move
    none), the counterpart of XLA's "bytes accessed" (per op, where XLA
    counts per fusion);
  * collectives by the reference's five kinds from the c10d ops the
    program issues (functional and in place), each counted at its result
    bytes as the reference counts HLO results. ``collective_bytes`` takes
    that record, not HLO text.

Every rank of the port runs the same program, so the counts are per
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# c10d op names (``_c10d_functional::`` and ``c10d::``) by kind
_KIND_OF = {
    **dict.fromkeys(("all_gather_into_tensor",
                     "all_gather_into_tensor_coalesced", "allgather_",
                     "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_",
                     "allreduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                     "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_"),
                    "all-to-all"),
    **dict.fromkeys(("send", "recv_"), "collective-permute"),
}

Record = List[Tuple[str, int]]          # (kind, result bytes) a collective


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(x) for x in tree_flatten(tree)[0])


_NO_TRAFFIC = ("aten::empty", "aten::empty_like", "aten::empty_strided",
               "aten::new_empty", "aten::new_empty_strided", "aten::detach",
               "aten::alias", "aten::lift_fresh")


def _moves_no_bytes(func) -> bool:
    """Views and allocations read and write nothing."""
    return func.is_view or func._schema.name in _NO_TRAFFIC


class _Counter(TorchDispatchMode):
    """Each op's input + output bytes, and the record of the collectives
    (their kind and result bytes)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.record: Record = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in ("c10d", "_c10d_functional") and op in _KIND_OF:
            self.record.append((_KIND_OF[op], _tensor_bytes(out)))
        if not _moves_no_bytes(func):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def collective_bytes(record: Record) -> Dict[str, int]:
    """Per-op-kind collective result bytes of a program's record (from
    ``terms_from_program``), and their counts under ``_counts``."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for kind, nbytes in record:
        out[kind] += nbytes
        counts[kind] += 1
    out["_counts"] = counts  # type: ignore[assignment]
    return out


def terms_from_program(fn, *args, **kwargs) -> Dict:
    """Raw per-device terms of one run of ``fn(*args, **kwargs)``: flops,
    bytes, and collective bytes by kind (floats, unscaled), with the
    collectives' counts: the reference's ``terms_from_compiled``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = _Counter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args, **kwargs)
    coll = collective_bytes(counter.record)
    counts = coll.pop("_counts")
    return {
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "coll": {k: float(v) for k, v in coll.items()},
        "counts": counts,
    }


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    coll_by_kind: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (chips × FLOPs)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (training) / 2·N·D (inference); N = active
    params, D = tokens processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: ONE token per sequence
    return 2.0 * n * shape.global_batch


def combine_layer_delta(t1: Dict, t2: Dict, n_units: float) -> Dict:
    """Layer-delta extrapolation:
    ``total = t1 + (n_units − 1)·(t2 − t1)``.

    t1/t2 are ``terms_from_program`` of 1-unit and 2-unit surrogate
    programs; layers are identical so the per-unit delta is exact."""
    f = n_units - 1.0
    out = {
        "flops": max(t1["flops"] + f * (t2["flops"] - t1["flops"]), 0.0),
        "bytes": max(t1["bytes"] + f * (t2["bytes"] - t1["bytes"]), 0.0),
        # clamp: a negative extrapolation is an artifact
        "coll": {k: max(t1["coll"][k] + f * (t2["coll"][k] - t1["coll"][k]),
                        0.0)
                 for k in t1["coll"]},
        "counts": {k: max(round(t1["counts"][k]
                                + f * (t2["counts"][k] - t1["counts"][k])),
                          0)
                   for k in t1["counts"]},
    }
    return out


def roofline_from_terms(terms: Dict, cfg: ModelConfig, shape: ShapeConfig,
                        chips: int, scale: float = 1.0) -> RooflineTerms:
    """``scale`` multiplies the measured per-program terms — used when the
    cost program is one micro-batch of a ``scale``-step gradient-
    accumulation window (the programs are identical across micro-steps)."""
    flops = terms["flops"] * scale
    nbytes = terms["bytes"] * scale
    coll = {k: v * scale for k, v in terms["coll"].items()}
    total_coll = float(sum(coll.values()))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = total_coll / ICI_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    return RooflineTerms(
        flops=flops, hbm_bytes=nbytes, coll_bytes=total_coll,
        coll_by_kind={**coll, "counts": terms.get("counts", {})},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dom, model_flops=mf,
        useful_ratio=mf / max(flops * chips, 1.0))
