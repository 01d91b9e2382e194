"""WeightStoreTransport: the VersionedWeightStore contract over the wire,
as in the reference ``repro/runtime/transport/weights.py``.

Remote workers pull fresh policy weights by version (the LlamaRL-style
distributed broadcast, pull-flavored): this proxy exposes the exact
surface :class:`~repro_torch.runtime.weight_store.VersionedWeightStore` gives
the in-process inference pool —

  * ``acquire(newer_than, timeout)`` — newest ``(params, version)``,
    blocking until something newer exists (long-polled in bounded slices
    so ``close()`` always unblocks it);
  * ``draining`` / ``version()`` — the drain-protocol poll (App. D.6),
    cached for ``state_ttl`` seconds so a hot inference loop does not
    turn every iteration into an RPC;
  * ``begin_publish()`` / ``publish(params, version)`` — the trainer side,
    so a trainer could live across the wire too (transport parity with
    the in-process store is what the tests pin down).

An :class:`~repro_torch.runtime.inference.InferenceService` constructed with
this object instead of the local store is a *remote* inference worker —
no code change on its side, which is the whole point of the seam.

``acquire`` decodes the blob into tensors on ``device``, the worker's own
(bf16 carried bit for bit); ``publish`` encodes a tree of tensors from a
host copy. With ``metrics`` (a service's registry) set, each successful
acquire's seconds, from the request to the tensors on the device (a wait
for the version inside the request's poll slice included), are observed
as ``weight_acquire_s`` and kept as the gauge
``weight_acquire_s_v<version>``; an acquire read from the lane counts
``weight_lane_hits``, one that fell back to the socket body
``weight_lane_fallbacks`` (also ``lane_hits`` and ``lane_fallbacks`` on
the object).
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.runtime.transport.channel import (ChannelClosed, WireClient,
                                                   long_poll)
from repro_torch.runtime.transport.codec import decode_pytree, encode_pytree
from repro_torch.runtime.transport.ring import RingError, ShmRing

__all__ = ["WeightStoreTransport"]


class WeightStoreTransport:
    """Client-side remote weight store (publish/acquire over the wire)."""

    def __init__(self, address: Tuple[str, int], *, use_shm: bool = False,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16, state_ttl: float = 0.05,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 use_lane: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.metrics = None
        self._client = WireClient(address, connect_timeout=connect_timeout,
                                  shm_threshold=shm_threshold,
                                  reconnect_attempts=reconnect_attempts,
                                  reconnect_backoff_s=reconnect_backoff_s,
                                  on_reconnect=self._on_reconnect)
        self._use_shm = use_shm
        # broadcast lane (same-host only): acquire replies may carry the
        # blob's position in the server's persistent lane ring instead of
        # a body; this reader attaches the lane ONCE and copies blobs out
        # positionally — no per-acquire segment churn
        self._use_lane = bool(use_lane)
        self._lane = None                          # attached lane ring
        self.lane_hits = 0
        self.lane_fallbacks = 0
        self._state_ttl = state_ttl
        self._state = (-float("inf"), -1, False)   # (stamp, version, drain)

    def _on_reconnect(self) -> None:
        """A server-side drop may have hidden publishes: bust the cached
        (version, draining) so the next poll re-acquires the true newest
        version instead of serving the pre-drop state for a TTL. A
        replacement server also means a fresh lane ring, so drop the
        stale attachment (re-attached lazily by name)."""
        self._state = (-float("inf"), -1, False)
        lane, self._lane = self._lane, None
        if lane is not None:
            lane.close()

    # -- broadcast lane (positional reads) ------------------------------------
    def _lane_read(self, resp: dict) -> Optional[Any]:
        """Decode the blob at the advertised position of the server's lane
        ring straight onto the device (no host copy of the blob: the
        device copy reads the shared memory, and the record's header is
        checked before and after it); None on any failure (stale
        attachment, torn read under a concurrent newer publish) — the
        caller falls back to an in-band re-acquire."""
        name = resp["lane"]
        where = (int(resp["lane_pos"]), int(resp["lane_seq"]),
                 int(resp["lane_nbytes"]))
        try:
            if self._lane is None or self._lane.name != name:
                if self._lane is not None:
                    self._lane.close()
                    self._lane = None
                self._lane = ShmRing.attach(name)
            view = self._lane.view_at(*where)
            if view is None:
                return None
            try:
                params = decode_pytree(view, device=self.device)
            finally:
                try:
                    view.release()
                except BufferError:   # a view still exported: dies with it
                    pass
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return params if self._lane.still_at(*where) else None
        except (RingError, OSError, ValueError):
            return None

    # -- state poll (cached) --------------------------------------------------
    def _fresh_state(self) -> Tuple[int, bool]:
        stamp, version, draining = self._state
        if time.monotonic() - stamp < self._state_ttl:
            return version, draining
        try:
            resp, _ = self._client.request({"m": "store.state"})
        except ChannelClosed:
            # shutdown is a data-plane no-op here too: keep serving the
            # last known state (acquire/put already degrade the same way);
            # the worker's control loop is what notices the parent is gone
            return version, False
        version, draining = int(resp["version"]), bool(resp["draining"])
        self._state = (time.monotonic(), version, draining)
        return version, draining

    @property
    def draining(self) -> bool:
        return self._fresh_state()[1]

    def version(self) -> int:
        return self._fresh_state()[0]

    # -- inference side -------------------------------------------------------
    def acquire(self, newer_than: int = -1,
                timeout: Optional[float] = None
                ) -> Optional[Tuple[Any, int]]:
        """Newest (params, version) with version > ``newer_than``; the
        params as tensors on the transport's device."""
        t0 = time.monotonic()
        got = long_poll(
            self._client,
            lambda t: {"m": "store.acquire", "newer_than": newer_than,
                       "timeout": t, "want_shm": self._use_shm,
                       "want_lane": self._use_lane},
            timeout)
        if got is None:
            return None
        resp, body = got
        version = int(resp["version"])
        params = None
        if resp.get("lane"):
            params = self._lane_read(resp)
            if params is not None:
                self.lane_hits += 1
                self._count("weight_lane_hits")
            else:
                # torn or stale lane read: one in-band re-acquire (the
                # version exists, so newer_than = version - 1 succeeds
                # immediately with this version or a newer one)
                self.lane_fallbacks += 1
                self._count("weight_lane_fallbacks")
                try:
                    resp, body = self._client.request(
                        {"m": "store.acquire", "newer_than": version - 1,
                         "timeout": 5.0, "want_shm": self._use_shm})
                except ChannelClosed:
                    return None
                if not resp.get("ok"):
                    return None
                version = int(resp["version"])
        if params is None:
            params = decode_pytree(body, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self.metrics is not None:
            dt = time.monotonic() - t0
            self.metrics.observe("weight_acquire_s", dt)
            self.metrics.set_gauge(f"weight_acquire_s_v{version}", dt)
        return params, version

    def _count(self, key: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(key)

    # -- trainer side ---------------------------------------------------------
    def begin_publish(self) -> None:
        self._client.request({"m": "store.drain"})
        self._state = (-float("inf"), *self._state[1:])   # bust the cache

    def publish(self, params: Any, version: int) -> None:
        blob = encode_pytree(params)
        self._client.request({"m": "store.publish", "version": version},
                             blob, oob=self._use_shm)
        self._state = (-float("inf"), *self._state[1:])

    # -- lifecycle ------------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._client.closed

    def close(self) -> None:
        self._client.close()
        lane, self._lane = self._lane, None
        if lane is not None:
            lane.close()                 # attachment only — server unlinks
