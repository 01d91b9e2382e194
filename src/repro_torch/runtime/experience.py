"""ExperienceChannel: the typed data plane between runtime services.

The paper's pipeline moves experience through three conceptual channels —
``B`` (real trajectory segments → trainer), ``B_wm`` (real transitions →
world-model trainers + imagination seeds), and ``B_img`` (imagined segments
→ trainer). This module gives them one abstraction over the host-side
buffers in :mod:`repro_torch.data.replay`:

  * :class:`FifoChannel`   — streaming single-epoch segments with a
    pluggable backpressure policy (drop_oldest / drop_newest / block);
  * :class:`RingChannel`   — uniform-resampling transitions;
  * :class:`MixedExperienceSource` — composes a real and an imagined
    channel at a configurable real fraction, so the trainer consumes ONE
    source regardless of whether a world model is attached (the mix ratio
    is how §4's "policy trains on B_img" generalizes to hybrid diets).

Everything exposing ``pop_batch(n, timeout)`` is a valid trainer source
(the :class:`~repro_torch.data.prefetch.Prefetcher` contract).

As in the reference ``repro/runtime/experience.py``, with its
import-gated tracing (``REPRO_TRACE``: ``replay.pop`` and ``mixed.blend``).
"""
from __future__ import annotations

import abc
import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.data.replay import (BACKPRESSURE_POLICIES, FIFOReplayBuffer,
                                     RingReplayBuffer)

# Import-gated tracing (see transport.faults for the idiom).
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None

__all__ = ["BACKPRESSURE_POLICIES", "ExperienceChannel", "FifoChannel",
           "RingChannel", "MixedExperienceSource"]


def _trace_pop(out: Optional[List[Any]], where: str) -> None:
    """Mark a successful drain on the trace of its FIRST item: segments
    carry ``_trace`` stamped by the rollout worker, so the replay hop
    shows up on the same episode timeline as rollout.put/server.apply."""
    if _tel is None or not out:
        return
    first = out[0]
    trace = first.get("_trace") if isinstance(first, dict) else None
    if trace is not None:
        _tel.instant("replay.pop", cat="experience", trace=int(trace),
                     args={"count": len(out), "src": where}, flow="step")


class ExperienceChannel(abc.ABC):
    """Producer-facing contract: non-blocking-ish ``put`` + depth + stats."""

    @abc.abstractmethod
    def put(self, item: Any) -> bool:
        """Offer one item; False iff rejected by the backpressure policy."""

    def put_many(self, items: List[Any]) -> List[bool]:
        """Offer a batch; one backpressure verdict per item. In-process
        this is just a loop, but remote channels override it into a single
        wire round-trip (one codec blob per flush instead of one per
        item), so producers should flush episodes through it."""
        return [self.put(item) for item in items]

    def pop_many(self, max_items: int, timeout: Optional[float] = None
                 ) -> Optional[List[Any]]:
        """Coalescing drain: block (up to ``timeout``) only for the FIRST
        item, then take everything immediately available up to
        ``max_items`` — never fewer than one on success, never blocks to
        round a batch out. Remote channels override it into ONE wire
        round-trip and codec blob per drain; consumers that can accept
        partial batches (the prefetcher, the mixed source) should drain
        through it. Default rides on ``pop_batch`` where a subclass
        provides one."""
        if max_items <= 0:
            return None
        pop_batch = getattr(self, "pop_batch", None)
        if pop_batch is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no pop path")
        got = pop_batch(1, timeout=timeout)
        if not got:
            return None
        if max_items > 1:
            more = pop_batch(min(max_items - 1, len(self)), timeout=0) \
                if len(self) else None
            if more:
                got = list(got) + list(more)
        return got

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    def stats(self) -> Dict[str, float]:
        return {"depth": float(len(self))}


class FifoChannel(ExperienceChannel):
    """Streaming segment channel (B / B_img): FIFO, single-epoch pops."""

    def __init__(self, capacity: int, *, policy: str = "drop_oldest",
                 block_timeout: float = 0.5):
        self._buf = FIFOReplayBuffer(capacity, policy=policy)
        self._block_timeout = block_timeout

    @property
    def policy(self) -> str:
        return self._buf.policy

    @property
    def capacity(self) -> int:
        return self._buf.capacity

    def put(self, item: Any) -> bool:
        return self._buf.push(item, timeout=self._block_timeout)

    def pop_batch(self, n: int, timeout: Optional[float] = None
                  ) -> Optional[List[Any]]:
        out = self._buf.pop_batch(n, timeout=timeout)
        if _tel is not None:
            _trace_pop(out, "fifo")
        return out

    def pop_many(self, max_items: int, timeout: Optional[float] = None
                 ) -> Optional[List[Any]]:
        # single lock acquisition in the buffer, not two pop_batch calls
        out = self._buf.pop_upto(max_items, timeout=timeout)
        if _tel is not None:
            _trace_pop(out, "fifo")
        return out

    def drain(self) -> List[Any]:
        return self._buf.drain()

    def peek_all(self) -> List[Any]:
        """Non-destructive copy (journal snapshot capture)."""
        return self._buf.peek_all()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def total_pushed(self) -> int:
        return self._buf.total_pushed

    @property
    def total_dropped(self) -> int:
        return self._buf.total_dropped

    def stats(self) -> Dict[str, float]:
        return {"depth": float(len(self)),
                "pushed": float(self.total_pushed),
                "dropped": float(self.total_dropped)}


class RingChannel(ExperienceChannel):
    """Resampling transition channel (B_wm): ring storage, uniform sample."""

    def __init__(self, capacity: int, seed: int = 0):
        self._buf = RingReplayBuffer(capacity, seed=seed)

    def put(self, item: Any) -> bool:
        self._buf.push(item)
        return True

    def sample(self, n: int) -> Optional[List[Any]]:
        return self._buf.sample(n)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def total_pushed(self) -> int:
        return self._buf.total_pushed

    def stats(self) -> Dict[str, float]:
        return {"depth": float(len(self)),
                "pushed": float(self.total_pushed)}


class MixedExperienceSource:
    """Compose a real and an imagined FIFO channel into one trainer source.

    ``real_fraction`` sets the target share of real segments per batch.
    For intermediate fractions, a starved side is backfilled by the other
    so the trainer never stalls on the mix (availability beats ratio).
    The extremes are HARD pins: ``0.0`` reproduces the paper's WM mode —
    the policy trains purely on B_img and waits for imagination rather
    than silently consuming real segments — and ``1.0`` is the pure
    model-free diet.

    Single-consumer source (the trainer's prefetcher): items gathered
    before a timeout are carried to the next ``pop_batch`` call, so
    batches are always exactly ``n`` items and nothing is dropped.
    """

    def __init__(self, real, imagined, *, real_fraction: float = 0.0):
        if not 0.0 <= real_fraction <= 1.0:
            raise ValueError(f"real_fraction must be in [0, 1], "
                             f"got {real_fraction}")
        self.real = real
        self.imagined = imagined
        self.real_fraction = real_fraction
        self.real_consumed = 0
        self.imagined_consumed = 0
        self._pending: List[Any] = []

    def _take(self, chan, k: int) -> int:
        # coalesced non-blocking drain: one call (one RPC when the side
        # is remote), no separate len() probe to race against producers
        got = chan.pop_many(k, timeout=0) if k else None
        if got:
            self._pending.extend(got)
            return len(got)
        return 0

    def _mix_round(self, need: int, want_real: int, taken_real: int) -> int:
        """ONE non-blocking take at the mix policy (the single home of
        the ratio rules): real share first (capped by availability),
        backfill across sides only for intermediate fractions — the
        extremes are hard pins (0.0 never touches real, 1.0 never
        imagined). Returns how many real items were taken."""
        k_real = min(max(want_real - taken_real, 0), len(self.real))
        if (0.0 < self.real_fraction
                and len(self.imagined) < need - k_real):
            k_real = min(need - len(self.imagined), len(self.real))
        got_real = self._take(self.real, min(k_real, need))
        self.real_consumed += got_real
        k_img = need - got_real if self.real_fraction < 1.0 else 0
        self.imagined_consumed += self._take(self.imagined, k_img)
        return got_real

    def pop_batch(self, n: int, timeout: Optional[float] = None,
                  poll_s: float = 0.005) -> Optional[List[Any]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        want_real = int(round(n * self.real_fraction))
        taken_real = 0
        while True:
            need = n - len(self._pending)
            if need <= 0:
                out, self._pending = (self._pending[:n],
                                      self._pending[n:])
                if _tel is not None:
                    _trace_pop(out, "mixed")
                    self._blend_trace(out)
                return out
            taken_real += self._mix_round(need, want_real, taken_real)
            if len(self._pending) >= n:
                continue
            if deadline is not None and time.monotonic() >= deadline:
                return None        # gathered items carry to the next call
            time.sleep(poll_s)

    def pop_many(self, max_items: int, timeout: Optional[float] = None,
                 poll_s: float = 0.005) -> Optional[List[Any]]:
        """Coalescing drain at the mixed ratio: returns as soon as ANY
        items are available (≤ ``max_items``) instead of waiting to round
        out an exact batch — the prefetcher accumulates partials, so the
        mix is still targeted per drain but a starved side never stalls
        the pipeline. The extremes stay hard pins (0.0 never touches
        real, 1.0 never imagined)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        want_real = int(round(max_items * self.real_fraction))
        while True:
            if self._pending:
                out, self._pending = (self._pending[:max_items],
                                      self._pending[max_items:])
                if _tel is not None:
                    _trace_pop(out, "mixed")
                    self._blend_trace(out)
                return out
            self._mix_round(max_items, want_real, 0)
            if self._pending:
                continue
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(poll_s)

    def _blend_trace(self, out: List[Any]) -> None:
        """One ``mixed.blend`` instant per served drain, on the batch's
        trace id (first traced item): the real/imagined diet actually
        served shows up next to wm.imagine on the Perfetto timeline."""
        first = out[0]
        trace = first.get("_trace") if isinstance(first, dict) else None
        _tel.instant("mixed.blend", cat="experience",
                     trace=int(trace) if trace is not None else None,
                     args={"count": len(out),
                           "real_consumed": self.real_consumed,
                           "imagined_consumed": self.imagined_consumed,
                           "real_fraction": self.real_fraction},
                     flow="step")

    def __len__(self) -> int:
        return len(self.real) + len(self.imagined)

    def stats(self) -> Dict[str, float]:
        return {"depth": float(len(self)),
                "real_consumed": float(self.real_consumed),
                "imagined_consumed": float(self.imagined_consumed),
                "real_fraction": self.real_fraction}
