"""Schedulers: the SAME services under different pacing (paper Fig. 1).

The asynchronous AcceRL pipeline and the synchronous baseline used to be
two separate code paths (``run_async`` starting threads, ``run_sync``
re-implementing the whole rollout loop inline). Here both are expressed as
schedulers over the one service set:

  * :class:`FreeRunScheduler` — everything free-runs (the AcceRL mode):
    start every registered service, poll the primary trainer until the
    step budget or wall clock is hit, stop in reverse order.

  * :class:`BarrierScheduler` — the synchronous baseline with its three
    long-tail barriers, reproduced as *pacing* rather than a parallel
    implementation:
      - step barrier    — a :class:`BarrierGate` makes every live worker
        rendezvous before each env step, and the inference window widens to
        one batched forward per lockstep tick;
      - episode barrier — each round releases a fixed episode quota and
        waits for ALL of it to finish before training may begin;
      - cluster barrier — the trainer steps inline between rounds, so
        rollouts are idle while the optimizer runs (and vice versa).

Because the barriers live in the gate + scheduler, the rollout loop,
inference pool, and train step are byte-for-byte the code the async mode
runs — exactly the paper's claim that the contrast is *structural*.

A straight port of the reference ``repro/runtime/scheduler.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

from repro_torch.runtime.service import RolloutGate


class _DynamicBarrier:
    """A barrier whose party count changes as workers join/leave mid-round
    (episodes end at different times). ``wait`` releases a generation when
    every currently-joined party has arrived."""

    def __init__(self):
        self._cv = threading.Condition()
        self._parties = 0
        self._waiting = 0
        self._gen = 0

    def join(self) -> None:
        with self._cv:
            self._parties += 1

    def leave(self) -> None:
        with self._cv:
            self._parties -= 1
            self._release_if_full()

    def wait(self, stop: threading.Event, poll_s: float = 0.05) -> None:
        with self._cv:
            gen = self._gen
            self._waiting += 1
            self._release_if_full()
            while self._gen == gen:
                if stop.is_set():
                    self._waiting -= 1        # withdraw from this round
                    return
                self._cv.wait(poll_s)

    def _release_if_full(self) -> None:
        # >=, not ==: leave() can drop parties below the waiting count
        if self._parties > 0 and self._waiting >= self._parties:
            self._gen += 1
            self._waiting = 0
            self._cv.notify_all()


class BarrierGate(RolloutGate):
    """Synchronous-mode pacing: episodes gated by a permit quota (episode
    barrier), env steps by a dynamic lockstep barrier (step barrier).

    ``completed`` counts ``end_episode`` calls — finished AND aborted
    episodes — so a permit can never leak: the scheduler's round ends when
    every released permit has been accounted for, even if an episode died
    on an inference error."""

    def __init__(self, lockstep: bool = True):
        self._permits = threading.Semaphore(0)
        self._barrier = _DynamicBarrier()
        self._lockstep = lockstep
        self._done_lock = threading.Lock()
        self.completed = 0

    def release(self, n: int) -> None:
        for _ in range(n):
            self._permits.release()

    def begin_episode(self, stop: threading.Event) -> bool:
        while not stop.is_set():
            if self._permits.acquire(timeout=0.05):
                if self._lockstep:
                    self._barrier.join()
                return True
        return False

    def before_step(self, stop: threading.Event) -> None:
        if self._lockstep:
            self._barrier.wait(stop)

    def end_episode(self) -> None:
        if self._lockstep:
            self._barrier.leave()
        with self._done_lock:
            self.completed += 1


class Scheduler:
    """Drives a system's service registry to a train-step budget."""

    def run(self, system, *, train_steps: int,
            wall_timeout_s: float = 300.0) -> Dict:
        raise NotImplementedError

    @staticmethod
    def _failed(system) -> bool:
        """A crashed service can never make progress — spinning on the
        step counter until the wall clock would hide the crash."""
        return any(s.error is not None for s in system.registry.all())


class FreeRunScheduler(Scheduler):
    """The AcceRL mode: every service free-runs; returns system metrics."""

    def run(self, system, *, train_steps: int,
            wall_timeout_s: float = 300.0) -> Dict:
        t0 = time.monotonic()
        trainer = system.trainer
        try:
            system.registry.start_all()
            while (trainer.steps_done < train_steps
                   and time.monotonic() - t0 < wall_timeout_s
                   and not self._failed(system)):
                time.sleep(0.02)
        finally:
            system.registry.stop_all()
            system.registry.join_all()
        return system.metrics(time.monotonic() - t0)


class BarrierScheduler(Scheduler):
    """Synchronous baseline: rollout quota → barrier → train → broadcast."""

    def __init__(self, *, episodes_per_round: int = 8, lockstep: bool = True):
        self.episodes_per_round = episodes_per_round
        self.lockstep = lockstep

    def run(self, system, *, train_steps: int,
            wall_timeout_s: float = 300.0) -> Dict:
        from repro_torch.runtime.trainer import collate_segments

        t0 = time.monotonic()
        deadline = t0 + wall_timeout_s
        trainer = system.trainer
        trainer.begin_inline()
        gate = BarrierGate(lockstep=self.lockstep)
        workers = system.workers
        for w in workers:
            w.gate = gate
        # step barrier at the inference window: one batched forward per
        # lockstep tick of all live workers
        system.inference.window_batch = max(len(workers), 1)
        empty_rounds = 0
        try:
            # rollout workers (and any attachment services) run; the
            # trainer thread does NOT — the scheduler steps it inline
            system.registry.start_all(exclude_roles=("trainer",))
            while (trainer.steps_done < train_steps
                   and time.monotonic() < deadline
                   and not self._failed(system)):
                # --- rollout phase: the full quota must finish ------------
                # (gate.completed counts aborted episodes too, so a failed
                # episode cannot leak its permit and stall the round)
                target = gate.completed + self.episodes_per_round
                gate.release(self.episodes_per_round)
                while (gate.completed < target
                       and time.monotonic() < deadline
                       and not self._failed(system)):
                    time.sleep(0.005)
                # --- train phase (rollouts idle — cluster barrier) --------
                segments = system.experience.drain()
                batch_size = trainer.prefetcher.batch_size
                if not segments:
                    # a completed round with zero data means every episode
                    # aborted (dead inference / broken store) — fail loudly
                    # like the old inline loop did, don't spin to the wall
                    if time.monotonic() < deadline:
                        empty_rounds += 1
                        if empty_rounds >= 2:
                            raise RuntimeError(
                                "sync rollout rounds produce no segments — "
                                "every episode is aborting (inference or "
                                "weight-store failure?)")
                    continue
                empty_rounds = 0
                trainer.train_on_batch(
                    collate_segments(segments[:batch_size]))
                dropped = max(len(segments) - batch_size, 0)
                if dropped:
                    # single-epoch semantics: a sync round trains on ONE
                    # super-batch; the surplus is discarded, as the
                    # baseline's inline loop always did
                    trainer.metrics.inc("sync_surplus_segments", dropped)
        finally:
            system.registry.stop_all()
            system.registry.join_all()
        return system.metrics(time.monotonic() - t0)
