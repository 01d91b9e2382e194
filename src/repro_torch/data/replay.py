"""Replay buffers (paper §3.1, §4): the non-blocking FIFO trajectory buffer
``B`` feeding the trainer (single-epoch consumption), plus the ring buffer
``B_wm`` of real transitions for world-model training and the FIFO ``B_img``
of imagined segments. A copy of the reference ``repro/data/replay.py``
(numpy and the standard library only).

All buffers are host-side, thread-safe, and hold numpy pytrees (trajectory
segments). The trainer-side batching/tensorization happens in the
prefetcher so the training critical path stays clean (App. D.5).

The FIFO buffer supports pluggable backpressure policies (consumed through
:mod:`repro_torch.runtime.experience`, which layers the ExperienceChannel
abstraction on top of these buffers):

  * ``drop_oldest`` — the paper's fully-asynchronous default: producers
    never block, the stalest segments are evicted;
  * ``drop_newest`` — reject the incoming segment (bounded staleness:
    what is already queued wins);
  * ``block``       — producers wait (bounded by a timeout) for the
    consumer, i.e. rollout throughput is clamped to trainer throughput.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, List, Optional

import numpy as np

BACKPRESSURE_POLICIES = ("drop_oldest", "drop_newest", "block")


class FIFOReplayBuffer:
    """FIFO segment queue (the paper's ``B``).

    Producers ``push`` trajectory segments as episodes complete; the trainer
    ``pop_batch``es the oldest segments (single-epoch semantics — each
    segment is trained on once). The ``policy`` decides what happens when
    the buffer is full; the default ``drop_oldest`` never blocks the
    producer (full asynchrony).
    """

    def __init__(self, capacity: int, policy: str = "drop_oldest"):
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(f"policy must be one of "
                             f"{BACKPRESSURE_POLICIES}, got {policy!r}")
        self.capacity = capacity
        self.policy = policy
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.total_pushed = 0
        self.total_dropped = 0

    def push(self, segment: Any, timeout: float = 0.5) -> bool:
        """Add a segment; returns False iff it was rejected (``drop_newest``
        full, or ``block`` timed out waiting for space)."""
        with self._lock:
            if len(self._q) >= self.capacity:
                if self.policy == "drop_oldest":
                    self._q.popleft()
                    self.total_dropped += 1
                elif self.policy == "drop_newest":
                    self.total_dropped += 1
                    return False
                else:  # block
                    if not self._not_full.wait_for(
                            lambda: len(self._q) < self.capacity,
                            timeout=timeout):
                        self.total_dropped += 1
                        return False
            self._q.append(segment)
            self.total_pushed += 1
            self._not_empty.notify_all()
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def pop_batch(self, n: int, timeout: Optional[float] = None
                  ) -> Optional[List[Any]]:
        """Pop the n oldest segments; blocks until available (or timeout)."""
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: len(self._q) >= n,
                                            timeout=timeout):
                return None
            out = [self._q.popleft() for _ in range(n)]
            self._not_full.notify_all()
            return out

    def pop_upto(self, max_items: int, timeout: Optional[float] = None
                 ) -> Optional[List[Any]]:
        """Coalescing pop: whatever is queued, at most ``max_items``,
        under ONE lock acquisition — blocks (up to ``timeout``) only for
        the first segment. The batch-drain primitive ``pop_many`` rides
        on (one RPC per drain over a remote channel)."""
        if max_items <= 0:
            return None
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: len(self._q) >= 1,
                                            timeout=timeout):
                return None
            out = [self._q.popleft()
                   for _ in range(min(max_items, len(self._q)))]
            self._not_full.notify_all()
            return out

    def drain(self) -> List[Any]:
        """Pop everything currently queued (sync-mode round collection)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
            return out

    def peek_depth(self) -> int:
        return len(self)

    def peek_all(self) -> List[Any]:
        """Non-destructive copy of the queued items, oldest first
        (journal snapshot capture)."""
        with self._lock:
            return list(self._q)


class RingReplayBuffer:
    """Uniform-sampling ring buffer (the paper's ``B_wm``)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._items: List[Any] = []
        self._ptr = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self.total_pushed = 0

    def push(self, item: Any) -> None:
        with self._lock:
            if len(self._items) < self.capacity:
                self._items.append(item)
            else:
                self._items[self._ptr] = item
                self._ptr = (self._ptr + 1) % self.capacity
            self.total_pushed += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def sample(self, n: int) -> Optional[List[Any]]:
        with self._lock:
            if not self._items:
                return None
            idx = self._rng.integers(0, len(self._items), size=n)
            return [self._items[i] for i in idx]
