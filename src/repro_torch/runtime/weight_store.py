"""Versioned weight store with the inference-drain protocol (App. D.6), as
in the reference ``repro/runtime/weight_store.py``:

  * ``begin_publish()`` — the trainer's drain signal. Inference workers stop
    scheduling new batches, finish the in-flight one, and wait.
  * ``publish(params, version)`` — an atomic swap of the weight reference.
  * ``acquire()`` — inference side: newest (params, version).

Three transports reproduce Table 8's comparison:
  * :class:`DirectTransport`      — in-memory reference swap (NCCL analogue)
  * :class:`SerializedTransport`  — full serialize→deserialize round-trip
    (PCIe / host-mediated analogue)
  * :class:`DiskTransport`        — checkpoint write + poll + reload
    (shared-storage / AReaL analogue)

``send`` copies a tree of tensors to the host, as the reference's
``jax.tree.map(np.asarray, …)`` does: through the wire codec
(``transport.codec``), whose blob also carries bf16 leaves as their bits
where the reference pickles or ``np.savez``-es its numpy tree (numpy has
no bf16 without ``ml_dtypes``). ``recv`` decodes onto the device ``send``
read the tree from, so the host-to-device copy is part of the cost, as
``block_until_ready`` makes it in the reference's Table 8 benchmark. A
tree of numpy leaves comes back as numpy.
"""
from __future__ import annotations

import mmap
import pathlib
import tempfile
import threading
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.runtime.transport.codec import (decode_pytree,
                                                 encode_pytree, plan_pytree)
from repro_torch.tree import tree_leaves_with_path


def _device_of(params: Any) -> Optional[str]:
    """The device of the tree's first tensor leaf (None: numpy leaves)."""
    for _, leaf in tree_leaves_with_path(params):
        if isinstance(leaf, torch.Tensor):
            return str(leaf.device)
    return None


def _decode(blob, device: Optional[str]) -> Any:
    """Tensors on ``device``, or independent numpy arrays (None)."""
    if device is None:
        return decode_pytree(blob, copy=True)
    return decode_pytree(blob, device=device)


class DirectTransport:
    """Reference handoff — the NCCL-broadcast analogue."""

    name = "nccl_direct"

    def send(self, params: Any) -> Any:
        return params

    def recv(self, payload: Any) -> Any:
        return payload


class SerializedTransport:
    """Full host-side serialize/deserialize — the PCIe/host-mediated path:
    the tree encoded to one host blob and decoded back."""

    name = "host_serialized"

    def send(self, params: Any) -> Tuple[Optional[str], bytearray]:
        return _device_of(params), encode_pytree(params)

    def recv(self, payload: Tuple[Optional[str], bytearray]) -> Any:
        device, blob = payload
        return _decode(blob, device)


class DiskTransport:
    """Checkpoint to shared storage + reload — the AReaL-style path: the
    encoded tree written to a file (tmp + rename) and mapped back."""

    name = "shared_storage"

    def __init__(self, directory: Optional[str] = None):
        self._dir = pathlib.Path(directory or tempfile.mkdtemp(
            prefix="accerl_ckpt_"))
        self._dir.mkdir(parents=True, exist_ok=True)

    def send(self, params: Any) -> Tuple[Optional[str], str]:
        plan = plan_pytree(params)
        path = self._dir / f"ckpt_{time.time_ns()}.bin"
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w+b") as f:
            f.truncate(plan.nbytes)
            with mmap.mmap(f.fileno(), plan.nbytes) as mm:
                plan.write_into(mm)
        tmp.rename(path)                      # atomic publish
        return _device_of(params), str(path)

    def recv(self, payload: Tuple[Optional[str], str]) -> Any:
        device, path = payload
        with open(path, "rb") as f, mmap.mmap(
                f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            return _decode(mm, device)


class VersionedWeightStore:
    """Thread-safe publish/acquire channel between trainer and inference."""

    def __init__(self, transport=None):
        self.transport = transport or DirectTransport()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._payload = None
        self._version = -1
        self._draining = False
        self.publishes = 0
        self.last_sync_latency_s = 0.0
        # optional observer called AFTER each publish commits (outside the
        # cv, so a slow observer never blocks acquirers) with
        # ``(params, version)``
        self.on_publish = None

    # -- trainer side --------------------------------------------------------
    def begin_publish(self) -> None:
        """Drain signal: sent before the optimizer step completes."""
        with self._lock:
            self._draining = True

    def publish(self, params: Any, version: int) -> None:
        t0 = time.monotonic()
        payload = self.transport.send(params)
        with self._cv:
            self._payload = payload
            self._version = version
            self._draining = False
            self.publishes += 1
            self.last_sync_latency_s = time.monotonic() - t0
            self._cv.notify_all()
        hook = self.on_publish
        if hook is not None:
            hook(params, version)

    # -- inference side ------------------------------------------------------
    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def version(self) -> int:
        with self._lock:
            return self._version

    def acquire(self, newer_than: int = -1,
                timeout: Optional[float] = None) -> Optional[Tuple[Any, int]]:
        """Newest (params, version); blocks until version > ``newer_than``."""
        raw = self.acquire_raw(newer_than, timeout)
        if raw is None:
            return None
        payload, version = raw
        return self.transport.recv(payload), version

    def acquire_raw(self, newer_than: int = -1,
                    timeout: Optional[float] = None
                    ) -> Optional[Tuple[Any, int]]:
        """Newest (transport payload, version) without ``transport.recv``."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._version > newer_than, timeout=timeout):
                return None
            return self._payload, self._version
