"""Checkpointing: atomic save/restore of the full trainer state (params,
AdamW moments, the advantage-normalisation state and the version
counter), as in the reference ``repro/data/checkpoint.py``.

The format is the reference's, byte for byte: one ``ckpt_<step:010d>.npz``
plus a ``.json`` sidecar, written atomically (tmp + rename, the pattern of
the shared-storage weight transport, App. G.3), pruned to the ``keep``
newest. Member names are the reference's ``_flatten`` key paths:
``::``-joined, NamedTuple fields by name, dict keys sorted, sequence items
by index. A bf16 leaf is stored as the 2-byte void records that
``np.savez`` writes for an ``ml_dtypes.bfloat16`` array (header ``descr``
``'<V2'``), so both packages write the same bytes for every member of the
same state and each reads the other's files.

Two differences from the reference:

  * ``restore`` rebuilds a bf16 leaf from its bits. The reference casts
    every saved array with ``astype(template.dtype)``, which numpy cannot
    do for a bf16 template, so it cannot restore a default policy's
    checkpoint (ROADMAP C5); the port diverges there on purpose.
  * ``save`` writes the archive straight to the tmp file instead of
    through an in-memory copy, one leaf's host copy at a time (the
    members ``np.savez`` would write, in its layout): the same bytes, and
    host memory of one leaf instead of two copies of the state. CUDA
    leaves cross to the host through one pinned buffer the size of the
    largest leaf.

``restore`` takes a template tree of tensors, or of ``device="meta"``
tensors for a cold start (the counterpart of the reference's
``ShapeDtypeStruct`` template) and puts every leaf on ``device``, the
card unless the caller asks for the CPU. With ``shardings`` (a tree of
``sharding.rules.NamedSharding``, one for each leaf of the template) each
restored leaf is then placed on its mesh as a DTensor, as the reference
re-shards on load. A placed leaf of the state being saved is written as
its full value.
"""
from __future__ import annotations

import json
import pathlib
import re
import time
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sharding.rules import full_tensor, place

_SEP = "::"
#: the host dtype of a bf16 leaf's bits (numpy has no bf16 without
#: ``ml_dtypes``, which the port never imports)
BF16_HOST = np.dtype("V2")


def _to_host(t, staging: Optional[torch.Tensor] = None) -> np.ndarray:
    """A tensor (any device) as a C-contiguous host array; bf16 as its
    bits in ``BF16_HOST`` records. numpy input passes through. A CUDA
    tensor is copied into ``staging`` (pinned bytes, reused leaf after
    leaf) when given: the array then views it until the next leaf."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = full_tensor(t)
    if staging is not None and t.is_cuda:
        n = t.numel() * t.element_size()
        t = staging[:n].view(t.dtype).view(t.shape).copy_(t.detach())
    else:
        t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


def _from_host(arr: np.ndarray, *, device=None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A fresh host array (one the caller hands over) as a tensor on
    ``device`` (the CPU by default: sharing the array's memory where it is
    contiguous and writable) and in ``dtype`` (its own by default).
    ``BF16_HOST`` records and ``ml_dtypes.bfloat16`` arrays are bf16
    bits."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    if arr.dtype == BF16_HOST or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t if device is None else t.to(device)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_path(tree, path: Tuple[str, ...] = ()
                       ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and naming; ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _unflatten(template, leaves: Iterator[Any]):
    """``template``'s structure with its leaves taken from ``leaves`` in
    ``_flatten_with_path`` order."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _write_member(zf: zipfile.ZipFile, key: str, leaf,
                  staging: Optional[torch.Tensor]) -> None:
    """One ``<key>.npy`` member as ``np.savez`` writes it; a bf16 leaf
    gets the header an ``ml_dtypes.bfloat16`` array gets (``descr``
    ``'<V2'``)."""
    arr = _to_host(leaf, staging)
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        if arr.dtype != BF16_HOST:
            np.lib.format.write_array(fid, arr, allow_pickle=False)
            return
        header = np.lib.format.header_data_from_array_1_0(arr)
        header["descr"] = "<V2"
        np.lib.format.write_array_header_1_0(fid, header)
        fid.write(memoryview(arr.view(np.uint8).reshape(-1)))


def _path(d: pathlib.Path, step: int, suffix: str) -> pathlib.Path:
    return d / f"ckpt_{step:010d}{suffix}"


def save(directory: str, step: int, state: Any, *,
         keep: int = 3, metadata: Optional[Dict] = None) -> str:
    """Atomically write ``ckpt_<step>.npz``; prune to the ``keep`` newest."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = _path(d, step, ".npz")
    tmp = d / f".tmp_{time.time_ns()}"
    leaves = list(_flatten_with_path(state))
    cuda = [x.numel() * x.element_size() for _, x in leaves
            if isinstance(x, torch.Tensor) and x.is_cuda]
    staging = (torch.empty(max(cuda), dtype=torch.uint8, pin_memory=True)
               if cuda else None)
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:      # as np.savez opens it
        for key, leaf in leaves:
            _write_member(zf, key, leaf, staging)
    tmp.rename(path)                                  # atomic publish
    meta = {"step": step, "time": time.time(), **(metadata or {})}
    _path(d, step, ".json").write_text(json.dumps(meta))
    for old in sorted(d.glob("ckpt_*.npz"))[:-keep]:
        old.unlink(missing_ok=True)
        old.with_suffix(".json").unlink(missing_ok=True)
    return str(path)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    steps = [int(m.group(1)) for f in d.glob("ckpt_*.npz")
             if (m := re.match(r"ckpt_(\d+)\.npz", f.name))]
    return max(steps) if steps else None


def _restore_leaf(key: str, arr: np.ndarray, tmpl, device):
    if isinstance(tmpl, torch.Tensor):
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, the template {tuple(tmpl.shape)}")
        return _from_host(arr, device=device, dtype=tmpl.dtype)
    if hasattr(tmpl, "dtype"):
        return arr.astype(tmpl.dtype)
    return arr


def restore(directory: str, template: Any, *, step: Optional[int] = None,
            device="cuda", shardings: Any = None) -> Any:
    """Restore into the structure of ``template`` (tensors, or meta tensors
    for a cold start). A tensor leaf comes back in the template leaf's
    dtype (bf16 from its bits) on ``device``, the card unless the caller
    asks for the CPU; a numpy leaf is cast as the reference casts it.
    ``shardings``: a tree of ``NamedSharding`` with ``template``'s leaves;
    each leaf is placed under its own (``sharding.rules.place``)."""
    device = resolve_device(device)
    d = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    n_leaves = sum(1 for _ in _flatten_with_path(template))
    shards = ([sh for _, sh in _flatten_with_path(shardings)]
              if shardings is not None else [None] * n_leaves)
    if len(shards) != n_leaves:
        raise ValueError(f"{len(shards)} shardings for {n_leaves} leaves")
    leaves: List[Any] = []
    with np.load(_path(d, step, ".npz")) as z:
        for (key, tmpl), sh in zip(_flatten_with_path(template), shards):
            leaf = _restore_leaf(key, z[key], tmpl, device)
            leaves.append(leaf if sh is None else place(leaf, sh))
    return _unflatten(template, iter(leaves))
