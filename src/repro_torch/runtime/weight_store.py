"""Versioned weight store with the inference-drain protocol (App. D.6), as
in the reference ``repro/runtime/weight_store.py``:

  * ``begin_publish()`` — the trainer's drain signal. Inference workers stop
    scheduling new batches, finish the in-flight one, and wait.
  * ``publish(params, version)`` — an atomic swap of the weight reference.
  * ``acquire()`` — inference side: newest (params, version).

Only the in-memory :class:`DirectTransport` is ported in this slice; the
serialized and disk transports come with the transport slice.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional, Tuple


class DirectTransport:
    """Reference handoff — the NCCL-broadcast analogue."""

    name = "nccl_direct"

    def send(self, params: Any) -> Any:
        return params

    def recv(self, payload: Any) -> Any:
        return payload


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
