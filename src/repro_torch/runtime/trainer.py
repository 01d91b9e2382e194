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

Both drive modes build the step through the same IR
(``runtime/step_program.py``). By default the step is the program's fused
form on ``device`` (``core.train_step.make_train_step``; no mesh: the
reference's local mesh is a no-op on one device). With ``rt.pipeline``
the trainer builds the layout over the local devices of ``device``'s
type, the policy submesh's ``(n, 1)`` mesh, the program with that mesh,
the state placed through it (a no-op on one device) and the
:class:`~repro_torch.runtime.pipeline_exec.PipelineExecutor`;
``train_on_batch`` then runs a round, and ``set_wm_stage`` attaches the
world-model trainer as the second stage.

The port's AdamW updates the params in place, so every publish hands the
store a detached clone of each leaf (of its full value, for a placed
leaf) — a frozen snapshot per version, as the reference's immutable
arrays are. The clone runs on the trainer thread's current stream; every
thread of the runtime uses the default stream (the pipelined policy
stage's own stream has finished a round before it returns), so stream
order makes the copy visible to the inference service.

With ``checkpoint_dir`` and ``checkpoint_interval``, the trainer saves
its whole state (``data/checkpoint.py``, the reference's format) every
``checkpoint_interval`` steps, after the step's publish, as the reference
does.

With ``REPRO_TRACE`` set, collate records ``trainer.collate`` on each
traced segment's trace (and the segment's age as ``batch_age_s``), and a
publish records ``weights.publish`` once the store holds the snapshot.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RLConfig, RuntimeConfig
from repro_torch.core.train_step import init_train_state
from repro_torch.data import checkpoint
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.trajectory import TrajectoryBatch
from repro_torch.models.transformer import FRONTEND_DIM
from repro_torch.runtime.service import Service, ServiceState
from repro_torch.runtime.weight_store import VersionedWeightStore
from repro_torch.sharding.rules import full_tensor
from repro_torch.tree import tree_map

# Import-gated tracing (see transport.faults for the idiom).
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None


def collate_segments(segments: List[Dict[str, np.ndarray]],
                     metrics=None) -> TrajectoryBatch:
    """Stack rollout segments into a numpy TrajectoryBatch (prefetcher
    thread).

    When tracing is on, rollout workers stamp ``_trace``/``_t_put`` into
    each segment; the trainer-side instant here closes the per-episode
    flow (rollout.put -> server.apply -> trainer.collate) and the
    end-to-end batch age lands in the ``batch_age_s`` histogram.
    """
    if _tel is not None:
        now = time.time()
        for s in segments:
            trace = s.get("_trace")
            if trace is None:
                continue
            _tel.instant("trainer.collate", cat="trainer",
                         trace=int(trace),
                         args={"batch": len(segments)}, flow="end")
            if metrics is not None and s.get("_t_put") is not None:
                metrics.observe("batch_age_s",
                                max(now - float(s["_t_put"]), 0.0))
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
        from repro_torch.runtime import step_program
        self.device = resolve_device(device)
        super().__init__(name, role="trainer")
        self.cfg, self.rl, self.rt = cfg, rl, rt
        self.store = store
        n_micro = rt.pipeline_microbatches or rl.grad_accum
        if rt.pipeline:
            from repro_torch.runtime import pipeline_exec
            self._layout = pipeline_exec.SubmeshLayout.split(
                pipeline_exec.local_devices(self.device),
                wm_devices=rt.pipeline_wm_devices)
            self.device = self._layout.policy.device
            self._mesh = self._layout.policy.mesh()
            self.program = step_program.build_train_step_program(
                cfg, rl, n_micro=n_micro, mesh=self._mesh,
                device=self.device)
            self.state = init_train_state(cfg, seed, mesh=self._mesh,
                                          device=self.device)
            self.pipeline = pipeline_exec.PipelineExecutor(
                self.program, self._layout, n_micro=n_micro,
                metrics=self.metrics)
            self._step_fn = None
        else:
            self.program = step_program.build_train_step_program(
                cfg, rl, n_micro=n_micro, device=self.device)
            self.state = init_train_state(cfg, seed, device=self.device)
            self.pipeline = None
            self._step_fn = self.program.fused(donate=True)
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
            source, batch_size,
            functools.partial(collate_segments, metrics=self.metrics),
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

    def _publish(self, version: int, step: int = 0) -> None:
        """Publish a detached clone of every param leaf: the next step
        updates the live ones in place. Then open the policy-lag trace
        flow: the version is the flow id on both ends, so publish ->
        acquire -> first action line up in the trace viewer without any
        shared state (the instant marks the store's commit on the host;
        the clone may still be running on the device)."""
        with torch.no_grad():
            snapshot = tree_map(lambda p: full_tensor(p).detach().clone(),
                                self.state.params)
        self.store.publish(snapshot, version)
        if _tel is not None:
            _tel.instant("weights.publish", cat="weights", trace=version,
                         args={"version": version, "step": step},
                         flow="start")

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

    def set_wm_stage(self, stage_fn, feed_fn, *, wm_micro: int = 1) -> None:
        """Attach the world-model trainer as the second pipeline stage
        (pipeline mode only — see WorldModelAttachment.bind)."""
        if self.pipeline is None:
            raise RuntimeError("set_wm_stage requires rt.pipeline")
        self.pipeline.set_wm_stage(stage_fn, feed_fn, wm_micro=wm_micro)

    def stop(self) -> None:
        was_running = bool(self._threads)
        super().stop()
        if was_running:
            self.prefetcher.stop()
            self.join(timeout=10.0)
        if self.pipeline is not None:
            self.pipeline.close()

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
            if self.pipeline is not None:
                self.state, metrics, _ = self.pipeline.run_round(
                    self.state, batch)
            else:
                self.state, metrics = self._step_fn(self.state, batch)
            steps = int(self.metrics.inc("steps"))
            self.metrics.inc("samples", _host_float(batch.mask, "sum"))
            if steps % self.rt.weight_sync_interval == 0:
                if self.rt.drain:
                    self.store.begin_publish()     # drain signal, App. D.6
                self._publish(version + 1, step=steps)
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
