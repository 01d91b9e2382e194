"""Orchestrator: composes the runtime services — rollout workers, the
inference pool, the trainer — on a :class:`ServiceRegistry` and runs them
under a :class:`~repro_torch.runtime.scheduler.Scheduler`, as in the
reference ``repro/runtime/orchestrator.py``:

  * ``run_async``  — :class:`FreeRunScheduler`, the fully asynchronous
    AcceRL pipeline (paper §3);
  * ``run_sync``   — :class:`BarrierScheduler`, the synchronous baseline
    with its step/episode/cluster barriers (paper Fig. 1) — the SAME
    services, only paced differently.

Extensions attach through ``system.attach(...)``: an attachment registers
additional services on the bus and may rewire the trainer's experience
source.

``metrics()`` is rebuilt on the per-service metric registries, with the
reference's keys (its ``pipeline_*`` keys come with the pipelined executor)
and the full per-service snapshot under ``metrics()["services"]``.

The system runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
plain PyTorch route): the inference pool, the trainer and ``evaluate`` all
run there, and on CUDA the kernels are built before any service starts.

Not ported yet, and raising: remote and connected rollout workers, the
elastic autoscaler and the telemetry sink (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RLConfig, RuntimeConfig
from repro_torch.core.resampler import DynamicWeightedResampler
from repro_torch.envs.toy_manipulation import TASKS_PER_SUITE, ManipulationEnv
from repro_torch.runtime.experience import FifoChannel, RingChannel
from repro_torch.runtime.inference import InferenceService, _frame_to_prefix
from repro_torch.runtime.rollout import RolloutWorker
from repro_torch.runtime.scheduler import BarrierScheduler, FreeRunScheduler
from repro_torch.runtime.service import ServiceRegistry
from repro_torch.runtime.trainer import TrainerWorker
from repro_torch.runtime.weight_store import VersionedWeightStore


def _check_ported(rt: RuntimeConfig) -> None:
    tcfg = rt.transport
    if tcfg.remote_rollout_workers or tcfg.connect_rollout_workers:
        raise NotImplementedError(
            "remote and connected rollout workers (runtime/transport) are "
            "not ported yet: ROADMAP A6")
    if tcfg.supervision.max_workers > 0:
        raise NotImplementedError(
            "the elastic autoscaler (supervision.max_workers) is not ported "
            "yet: ROADMAP A6")
    if rt.telemetry.sink:
        raise NotImplementedError(
            "the telemetry sink (runtime/telemetry.py) is not ported yet: "
            "ROADMAP A6")


class AcceRLSystem:
    def __init__(self, cfg: ModelConfig, rl: RLConfig, rt: RuntimeConfig, *,
                 suite: str = "spatial", segment_horizon: int = 8,
                 max_episode_steps: int = 30, batch_episodes: int = 8,
                 latency=None, transport=None, seed: int = 0,
                 collect_frames: bool = False, device="cuda"):
        self.device = resolve_device(device)
        _check_ported(rt)
        if cfg.num_prefix_tokens == 0:
            # a VLA policy always consumes the observation frame — give
            # text-only backbones a 1-token frame-embedding prefix
            cfg = dataclasses.replace(cfg, num_prefix_tokens=1)
        if self.device.type == "cuda":
            # the first kernel launch would build them inside a service
            from repro_torch.kernels import build
            build.load()
        self.cfg, self.rl, self.rt = cfg, rl, rt
        self.suite = suite
        self.seed = seed
        self.max_episode_steps = max_episode_steps
        self.segment_horizon = segment_horizon
        self.store = VersionedWeightStore(transport=transport)
        # B: real trajectory segments -> trainer
        self.experience = FifoChannel(rt.replay_capacity,
                                      policy=rt.replay_backpressure)
        # B_wm: real transitions -> world-model trainers + imagination seeds
        self.frame_channel = (RingChannel(rt.wm_replay_capacity, seed=seed)
                              if collect_frames else None)
        self.resampler = DynamicWeightedResampler(TASKS_PER_SUITE, seed=seed)
        self.registry = ServiceRegistry()
        self.attachments: List = []
        self.inference = self.registry.register(
            InferenceService(cfg, self.store, rt, seed=seed,
                             device=self.device))
        self.trainer = self.registry.register(
            TrainerWorker(cfg, rl, rt, self.experience, self.store,
                          batch_episodes=batch_episodes, seed=seed,
                          device=self.device))
        self.workers = [
            self.registry.register(RolloutWorker(
                i, cfg, self.inference, self.experience,
                suite=suite, resampler=self.resampler,
                segment_horizon=segment_horizon,
                max_steps=max_episode_steps, latency=latency,
                seed=seed * 1000 + i,
                frame_channel=self.frame_channel))
            for i in range(rt.num_rollout_workers)
        ]

    # ------------------------------------------------------------- attachments
    def attach(self, attachment) -> "AcceRLSystem":
        """Plug an extension into the runtime: the attachment registers its
        services on the bus (and may rewire the trainer) via ``bind``."""
        attachment.bind(self)
        self.attachments.append(attachment)
        return self

    # ------------------------------------------------------------------ runs
    def run_async(self, *, train_steps: int,
                  wall_timeout_s: float = 300.0) -> Dict:
        """The AcceRL mode: everything free-runs; returns system metrics."""
        return FreeRunScheduler().run(self, train_steps=train_steps,
                                      wall_timeout_s=wall_timeout_s)

    def run_sync(self, *, train_steps: int, episodes_per_round: int = 8,
                 wall_timeout_s: float = 300.0) -> Dict:
        """Synchronous baseline: rollout barrier → train → broadcast —
        the same services under the barrier scheduler."""
        return BarrierScheduler(episodes_per_round=episodes_per_round).run(
            self, train_steps=train_steps, wall_timeout_s=wall_timeout_s)

    def run_wm(self, *, train_steps: int,
               wall_timeout_s: float = 300.0) -> Dict:
        """World-model mode: the async pipeline with the WM attachment's
        imagination + WM-trainer services on the bus."""
        if not self.attachments:
            raise RuntimeError(
                "run_wm needs a world model: build the system via "
                "repro_torch.wm.AcceRLWMSystem or system.attach(...) first")
        return self.run_async(train_steps=train_steps,
                              wall_timeout_s=wall_timeout_s)

    # -------------------------------------------------------------- evaluation
    def evaluate(self, *, episodes: int = 20, tasks: Optional[List[int]] =
                 None, seed: int = 123) -> Dict:
        """Greedy-ish evaluation success rate using the latest weights."""
        got = self.store.acquire(timeout=5.0)
        assert got is not None, "no published weights"
        params, _ = got
        from repro_torch.models.policy import make_inference_fn
        fn = make_inference_fn(self.cfg, temperature=0.35,
                               device=self.device)
        env = ManipulationEnv(
            suite=self.suite, max_steps=self.max_episode_steps,
            action_vocab=self.cfg.action_vocab_size,
            action_dim=self.cfg.action_dim, seed=seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        succ, returns = 0, []
        for ep in range(episodes):
            task = (tasks[ep % len(tasks)] if tasks
                    else ep % TASKS_PER_SUITE)
            obs = env.reset(task)
            done, ep_ret = False, 0.0
            while not done:
                toks, _, _ = fn(params, gen, obs["tokens"][None],
                                np.array([obs["step"]], np.int32),
                                _frame_to_prefix(obs["frame"][None]))
                obs, r, done, info = env.step(toks[0])
                ep_ret += r
            succ += int(info["success"])
            returns.append(ep_ret)
        return {"success_rate": succ / episodes,
                "mean_return": float(np.mean(returns))}

    # ----------------------------------------------------------------- metrics
    def health(self) -> Dict:
        """Per-service health report from the registry."""
        return self.registry.health()

    def metrics(self, wall_s: float) -> Dict:
        """One metric schema for every consumer, rebuilt on the per-service
        registries; attachments extend it in place."""
        rollouts = self.workers
        env_steps = sum(w.env_steps for w in rollouts)
        episodes = sum(w.episodes_done for w in rollouts)
        rets = [r for w in rollouts for r in w.returns]
        m = {
            "wall_s": wall_s,
            "train_steps": self.trainer.steps_done,
            "env_steps": env_steps,
            "episodes": episodes,
            "sps_env": env_steps / max(wall_s, 1e-9),
            "sps_train": self.trainer.samples_seen / max(wall_s, 1e-9),
            "trainer_util": self.trainer.utilization(),
            "inference_util": self.inference.utilization(),
            "mean_policy_lag": self.trainer.metrics.series_mean("policy_lag"),
            "mean_return": float(np.mean(rets)) if rets else 0.0,
            "success_rate": (sum(w.successes for w in rollouts)
                             / max(episodes, 1)),
            "buffer_dropped": self.experience.total_dropped,
            "inference_batches": self.inference.batches_run,
            "sync_latency_s": self.store.last_sync_latency_s,
            "services": self.registry.snapshot(),
        }
        for attachment in self.attachments:
            attachment.extend_metrics(m, self)
        return m
