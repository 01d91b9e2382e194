"""Trainer worker (paper §3.1, App. C/D), as in the reference
``repro/runtime/trainer.py``.

Continuously pops prefetched super-batches from its experience source
(never waiting on rollouts — macro-asynchrony), runs the GIPO + JIT-GAE
train step, and publishes versioned weights through the store with the
drain protocol. ``weight_sync_interval`` throttles publishes ("broadcast
only when an actual update occurs").

The trainer is a :class:`~repro_torch.runtime.service.Service`. Two drive
modes, same train path:

  * free-running (``start``) — the asynchronous pipeline: the service
    thread pops from the prefetcher and steps continuously;
  * inline (``begin_inline`` + ``train_on_batch``) — the barrier scheduler
    drives steps between rollout rounds, reproducing the synchronous
    baseline's cluster barrier without duplicating any training code.

The step is ``core.train_step.make_train_step`` on one device (the
reference builds it through its step program and a mesh). The port's
AdamW updates the params in place, so every publish hands the store a
detached clone of each leaf — a frozen snapshot per version, as the
reference's immutable arrays are. The clone runs on the trainer thread's
current stream; every thread of the runtime uses the default stream, so
stream order makes the copy visible to the inference service.

With ``checkpoint_dir`` and ``checkpoint_interval``, the trainer saves
its whole state (``data/checkpoint.py``, the reference's format) every
``checkpoint_interval`` steps, after the step's publish, as the reference
does.

Not ported yet: the pipelined executor (``rt.pipeline``, ROADMAP A7, which
raises) and the import-gated tracing (A6b).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RLConfig, RuntimeConfig
from repro_torch.core.train_step import init_train_state, make_train_step
from repro_torch.data import checkpoint
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.trajectory import TrajectoryBatch
from repro_torch.models.transformer import FRONTEND_DIM
from repro_torch.runtime.service import Service, ServiceState
from repro_torch.runtime.weight_store import VersionedWeightStore
from repro_torch.tree import tree_map


def collate_segments(segments: List[Dict[str, np.ndarray]]
                     ) -> TrajectoryBatch:
    """Stack rollout segments into a numpy TrajectoryBatch (prefetcher
    thread)."""
    stack = lambda k: np.stack([s[k] for s in segments])  # noqa: E731
    frames = stack("frames")                        # [B, T+1, F_env]
    b, tp1, f = frames.shape
    prefix = np.zeros((b, tp1, 1, FRONTEND_DIM), np.float32)
    prefix[..., 0, :min(f, FRONTEND_DIM)] = frames[..., :FRONTEND_DIM]
    return TrajectoryBatch(
        obs_tokens=stack("obs_tokens").astype(np.int32),
        actions=stack("actions").astype(np.int32),
        behavior_logp=stack("behavior_logp").astype(np.float32),
        behavior_value=stack("behavior_value").astype(np.float32),
        rewards=stack("rewards").astype(np.float32),
        dones=stack("dones").astype(np.float32),
        steps=stack("steps").astype(np.int32),
        mask=stack("mask").astype(np.float32),
        policy_version=stack("policy_version").astype(np.int32),
        prefix_embeds=prefix,
    )


def _host_float(x, reduce: str) -> float:
    """``x.mean()`` or ``x.sum()`` of a numpy array or a tensor, on the
    host."""
    if isinstance(x, torch.Tensor):
        return float(getattr(x.float(), reduce)())
    return float(getattr(np.asarray(x), reduce)())


class TrainerWorker(Service):
    def __init__(self, cfg: ModelConfig, rl: RLConfig, rt: RuntimeConfig,
                 source, store: VersionedWeightStore, *,
                 batch_episodes: int = 8, seed: int = 0,
                 checkpoint_dir=None, checkpoint_interval: int = 0,
                 name: str = "trainer", device="cuda"):
        self.device = resolve_device(device)
        if rt.pipeline:
            raise NotImplementedError(
                "rt.pipeline (the pipelined executor over disjoint device "
                "sets) is not ported yet: ROADMAP A7")
        super().__init__(name, role="trainer")
        self.cfg, self.rl, self.rt = cfg, rl, rt
        self.store = store
        self.state = init_train_state(cfg, seed, device=self.device)
        self._step_fn = make_train_step(cfg, rl, device=self.device)
        self.rewire(source, batch_episodes)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = checkpoint_interval
        self.metrics_log: List[Dict] = []
        #: the first batch ``train_on_batch`` consumed (a step-1 replay
        #: needs it beside the published version-0 snapshot)
        self.first_batch = None

    def rewire(self, source, batch_size: int) -> None:
        """Consume ``source`` in batches of ``batch_size`` through a new
        prefetcher on the runtime config's ingest path (staging, pinned
        copies to ``device``, timeouts). Before ``start`` only: a running
        prefetcher cannot be swapped."""
        if self.status != ServiceState.NEW:
            raise RuntimeError(f"{self.name}: rewire after start "
                               f"(state={self.status})")
        self.source = source
        self.prefetcher = Prefetcher(
            source, batch_size, collate_segments,
            depth=self.rt.prefetch_depth,
            drain_timeout_s=self.rt.prefetch_drain_timeout_s,
            idle_timeout_max_s=self.rt.prefetch_idle_timeout_s,
            stage_batches=self.rt.prefetch_staging,
            to_device=self.rt.prefetch_to_device, device=self.device)

    # -- registry-backed counters ----------------------------------------------
    @property
    def steps_done(self) -> int:
        return int(self.metrics.counter("steps"))

    @property
    def samples_seen(self) -> int:
        return int(self.metrics.counter("samples"))

    @property
    def policy_lag(self) -> List[float]:
        return self.metrics.series("policy_lag")

    @property
    def busy_s(self) -> float:
        return self.metrics.counter("busy_s")

    def _publish(self, version: int) -> None:
        """Publish a detached clone of every param leaf: the next step
        updates the live ones in place."""
        with torch.no_grad():
            snapshot = tree_map(lambda p: p.detach().clone(),
                                self.state.params)
        self.store.publish(snapshot, version)

    # -- lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        # version 0 published so inference can begin before the first step
        self._publish(0)
        self.prefetcher.start()

    def begin_inline(self) -> None:
        """Scheduler-driven mode: publish v0 and mark the clock, without
        the free-running thread or the prefetcher."""
        self.started_at = time.monotonic()
        self._publish(0)

    def stop(self) -> None:
        was_running = bool(self._threads)
        super().stop()
        if was_running:
            self.prefetcher.stop()
            self.join(timeout=10.0)

    # -- loop -------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self.prefetcher.get(timeout=0.2)
            if batch is None:
                continue
            self.train_on_batch(batch)

    def train_on_batch(self, batch: TrajectoryBatch) -> Dict:
        if self.first_batch is None:
            # a staged host batch views a slab the prefetcher recycles
            self.first_batch = TrajectoryBatch(*(
                x.copy() if isinstance(x, np.ndarray) else x for x in batch))
        with self.metrics.timer("busy_s"):
            version = int(self.state.version)
            lag = version - _host_float(batch.policy_version, "mean")
            self.metrics.record("policy_lag", lag)
            self.metrics.observe("policy_lag", lag)
            self.state, metrics = self._step_fn(self.state, batch)
            steps = int(self.metrics.inc("steps"))
            self.metrics.inc("samples", _host_float(batch.mask, "sum"))
            if steps % self.rt.weight_sync_interval == 0:
                if self.rt.drain:
                    self.store.begin_publish()     # drain signal, App. D.6
                self._publish(version + 1)
            if (self.checkpoint_dir and self.checkpoint_interval
                    and steps % self.checkpoint_interval == 0):
                checkpoint.save(self.checkpoint_dir, steps, self.state)
        out = {k: float(v) for k, v in metrics.items()}
        out["policy_lag"] = lag
        self.metrics_log.append(out)
        return out

    # -- metrics -----------------------------------------------------------------
    def sps(self) -> float:
        if not self.started_at:
            return 0.0
        return self.samples_seen / max(
            time.monotonic() - self.started_at, 1e-9)
