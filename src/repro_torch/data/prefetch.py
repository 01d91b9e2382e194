"""Asynchronous parallel data prefetching (paper App. D.5), as in the
reference ``repro/data/prefetch.py``.

A background producer thread watches an experience source, assembles
ready-to-train super-batches (tensorization + batching off the critical
path), and parks them in a bounded local cache; the trainer pops fully
formed batches. While the device runs step ``k``, the prefetcher prepares
the data for step ``k+1``.

The source is anything exposing ``pop_batch(n, timeout)`` — a
:class:`~repro_torch.data.replay.FIFOReplayBuffer`, a
:class:`~repro_torch.runtime.experience.FifoChannel`, or a
:class:`~repro_torch.runtime.experience.MixedExperienceSource` blending
real and imagined segments.

Device ingest path:

  * with ``stage_batches`` the collated batch is assembled into a slab
    from a small pool of reusable page-aligned host staging buffers
    (:class:`StagingPool`) instead of freshly allocated arrays — steady
    state runs at zero batch-sized allocations per step. Without
    ``to_device`` a slab is recycled only after the trainer pops the NEXT
    batch (``get`` → ``get``): by then the sequential trainer has read
    the previous one;
  * with ``to_device`` on a CUDA device the slabs are pinned, and the
    prefetch thread copies each staged batch to the card with
    ``non_blocking=True`` on a side ``torch.cuda.Stream``, recording an
    event after the copy: the H2D of batch N overlaps the collate of batch
    N+1 and the trainer's step. ``get`` makes the caller's stream wait on
    that event (and records the batch's tensors as used there, for the
    caching allocator). A slab goes back to the pool once its event has
    completed — a non-blocking copy may still be reading it when the call
    returns, so the reference's recycle-on-next-get rule does not apply.
    On the CPU ``to_device`` leaves the staged numpy batch as it is: no
    pinning and no CUDA call.

The drain loop's partial-batch timeout is configurable
(``drain_timeout_s``) and backs off exponentially up to
``idle_timeout_max_s`` while the source stays empty, so an idle trainer
does not burn a wakeup every slice.

The reference's ring-lease release for zero-copy transport sources, and
its ``views_served`` count, come with the transport slice (ROADMAP A6).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

_PAGE = 4096
_ALIGN = 64


def _align(n: int, to: int = _ALIGN) -> int:
    return (n + to - 1) & ~(to - 1)


class _Slab:
    """One page-aligned host staging buffer (``raw`` holds the allocation,
    ``buf`` is the aligned uint8 window batches are carved from). A pinned
    slab is a pinned uint8 tensor; ``tbuf`` is its window as a tensor."""

    __slots__ = ("raw", "buf", "tbuf")

    def __init__(self, nbytes: int, pin: bool = False):
        if pin:
            self.raw = torch.empty(nbytes + _PAGE, dtype=torch.uint8,
                                   pin_memory=True)
            off = (-self.raw.data_ptr()) % _PAGE
            self.tbuf = self.raw[off:off + nbytes]
            self.buf = self.tbuf.numpy()
        else:
            self.raw = np.empty(nbytes + _PAGE, dtype=np.uint8)
            off = (-self.raw.ctypes.data) % _PAGE
            self.buf = self.raw[off:off + nbytes]
            self.tbuf = None


class StagingPool:
    """Small pool of reusable page-aligned host staging buffers.

    ``acquire`` prefers a free slab big enough for the request (batches
    are shape-stable, so after warmup every acquire is a reuse);
    ``release`` returns a slab once its batch can no longer be read — see
    the recycle rules in the module docstring. ``pin`` allocates pinned
    slabs (the CUDA ingest path).
    """

    def __init__(self, max_free: int = 4, *, pin: bool = False):
        self._free: List[_Slab] = []
        self._lock = threading.Lock()
        self._max_free = max(int(max_free), 1)
        self._pin = pin
        self.staging_reuse = 0
        self.slabs_allocated = 0

    def acquire(self, nbytes: int) -> _Slab:
        nbytes = _align(max(nbytes, 1), _PAGE)
        with self._lock:
            for i, slab in enumerate(self._free):
                if slab.buf.nbytes >= nbytes:
                    self.staging_reuse += 1
                    return self._free.pop(i)
        self.slabs_allocated += 1
        return _Slab(nbytes, pin=self._pin)

    def release(self, slab: Optional[_Slab]) -> None:
        if slab is None:
            return
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(slab)


def _flatten_batch(batch) -> Optional[Tuple[List[np.ndarray], Callable]]:
    """Split a collated batch (NamedTuple or dict of arrays) into its
    ndarray leaves + a rebuilder; None when the shape is unknown (staging
    is then skipped and the batch passes through untouched)."""
    if hasattr(batch, "_fields"):
        vals = [getattr(batch, f) for f in batch._fields]
        idx = [i for i, v in enumerate(vals) if isinstance(v, np.ndarray)]

        def rebuild(staged, vals=vals, idx=idx, cls=type(batch)):
            out = list(vals)
            for i, leaf in zip(idx, staged):
                out[i] = leaf
            return cls(*out)

        return [vals[i] for i in idx], rebuild
    if isinstance(batch, dict):
        keys = [k for k, v in batch.items() if isinstance(v, np.ndarray)]

        def rebuild(staged, batch=batch, keys=keys):
            out = dict(batch)
            out.update(zip(keys, staged))
            return out

        return [batch[k] for k in keys], rebuild
    return None


def _tensor_leaves(batch) -> List[torch.Tensor]:
    vals = (batch.values() if isinstance(batch, dict)
            else [getattr(batch, f) for f in batch._fields])
    return [v for v in vals if isinstance(v, torch.Tensor)]


class Prefetcher:
    def __init__(self, source, batch_size: int,
                 collate: Callable, depth: int = 2, *,
                 drain_timeout_s: float = 0.1,
                 idle_timeout_max_s: float = 0.5,
                 stage_batches: bool = False,
                 to_device: bool = False,
                 staging_slabs: int = 4,
                 device="cuda"):
        self.source = source
        self.batch_size = batch_size
        self.collate = collate
        self.drain_timeout_s = max(float(drain_timeout_s), 0.001)
        self.idle_timeout_max_s = max(float(idle_timeout_max_s),
                                      self.drain_timeout_s)
        self.stage_batches = bool(stage_batches or to_device)
        self.to_device = bool(to_device)
        # the device matters only to the ingest path
        self.device = resolve_device(device) if to_device else None
        self._cuda = self.device is not None and self.device.type == "cuda"
        self._pool = StagingPool(max_free=staging_slabs, pin=self._cuda)
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._cache: queue.Queue = queue.Queue(maxsize=depth)
        self._in_use: Optional[_Slab] = None     # slab of the last get()
        self._in_flight: List[Tuple[_Slab, object]] = []   # (slab, event)
        self._flight_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetcher")
        self.batches_built = 0
        self.bytes_copied = 0        # staged bytes (collate → slab memcpy)
        self.idle_backoffs = 0       # drains that came back empty

    def start(self) -> "Prefetcher":
        self._thread.start()
        return self

    # -- staging plumbing -------------------------------------------------------
    def _stage(self, batch) -> Tuple[object, Optional[_Slab], object]:
        """Assemble ``batch`` into one pooled page-aligned slab (and ship
        it to the card when configured). Returns the staged batch, the slab
        backing it (recycled on the get-after-next; None once shipped) and
        the copy's event (None off the CUDA path)."""
        flat = _flatten_batch(batch)
        if flat is None:
            return batch, None, None
        leaves, rebuild = flat
        self._recycle()
        total = sum(_align(leaf.nbytes) for leaf in leaves)
        slab = self._pool.acquire(total)
        staged, offsets, off = [], [], 0
        for leaf in leaves:
            view = (slab.buf[off:off + leaf.nbytes]
                    .view(leaf.dtype).reshape(leaf.shape))
            np.copyto(view, leaf)
            self.bytes_copied += leaf.nbytes
            staged.append(view)
            offsets.append(off)
            off += _align(leaf.nbytes)
        if not self._cuda:
            return rebuild(staged), slab, None
        out, event = self._to_device(slab, staged, offsets)
        with self._flight_lock:
            self._in_flight.append((slab, event))
        return rebuild(out), None, event

    def _to_device(self, slab: _Slab, staged, offsets):
        """Non-blocking H2D copies of the pinned leaves on the side stream,
        then an event recorded after them. The device tensors are
        allocated on the side stream; ``get`` records them on the
        consumer's stream."""
        out = []
        with torch.cuda.stream(self._stream):
            for leaf, off in zip(staged, offsets):
                dtype = torch.from_numpy(np.empty(0, leaf.dtype)).dtype
                host = (slab.tbuf[off:off + leaf.nbytes].view(dtype)
                        .view(leaf.shape))
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _recycle(self) -> None:
        """Return to the pool every in-flight slab whose copy has ended."""
        with self._flight_lock:
            flight, self._in_flight = self._in_flight, []
            for slab, event in flight:
                if event.query():
                    self._pool.release(slab)
                else:
                    self._in_flight.append((slab, event))

    # -- producer loop ----------------------------------------------------------
    def _run(self) -> None:
        # a pop_many source is drained in COALESCED partial batches (one
        # lock per drain, items accumulate here until a super-batch is
        # full) instead of exact-n pops that wait for the batch to round
        # out while ready items sit in the channel
        pop_many = getattr(self.source, "pop_many", None)
        pending = []
        timeout = self.drain_timeout_s
        while not self._stop.is_set():
            if pop_many is not None:
                got = pop_many(self.batch_size - len(pending),
                               timeout=timeout)
                if got:
                    pending.extend(got)
                    timeout = self.drain_timeout_s
                else:
                    # empty drain: back off so an idle trainer sleeps in
                    # the source instead of waking every slice
                    self.idle_backoffs += 1
                    timeout = min(timeout * 2, self.idle_timeout_max_s)
                if len(pending) < self.batch_size:
                    continue
                segments, pending = pending, []
            else:
                segments = self.source.pop_batch(self.batch_size,
                                                 timeout=timeout)
                if segments is None:
                    self.idle_backoffs += 1
                    timeout = min(timeout * 2, self.idle_timeout_max_s)
                    continue
                timeout = self.drain_timeout_s
            batch = self.collate(segments)
            slab = event = None
            if self.stage_batches:
                batch, slab, event = self._stage(batch)
            self.batches_built += 1
            while not self._stop.is_set():
                try:
                    self._cache.put((batch, slab, event), timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer surface -------------------------------------------------------
    def get(self, timeout: Optional[float] = None):
        """Pop a ready super-batch (None on timeout). Host batches: popping
        batch N+1 recycles batch N's staging slab. Device batches: the
        caller's current stream waits on the batch's copy event."""
        try:
            batch, slab, event = self._cache.get(timeout=timeout)
        except queue.Empty:
            return None
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensor_leaves(batch):
                t.record_stream(stream)
            self._recycle()
        else:
            self._pool.release(self._in_use)
            self._in_use = slab
        return batch

    def metrics(self) -> Dict[str, float]:
        return {
            "batches_built": float(self.batches_built),
            "bytes_copied": float(self.bytes_copied),
            "staging_reuse": float(self._pool.staging_reuse),
            "staging_slabs": float(self._pool.slabs_allocated),
            "idle_backoffs": float(self.idle_backoffs),
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # only join a started thread
            self._thread.join(timeout=2.0)
