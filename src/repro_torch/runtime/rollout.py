"""Rollout workers (paper §3.1–3.2).

Each worker owns ONE (non-vectorized) environment instance — the paper's
"no natural batchability" regime — and loops:

    obs → async inference request → suspend → env.step(actions)

Completed episodes are packaged per eq. 2 as
τ = (o_{1:T+1}, a_{1:T}, r_{1:T}, μ_{1:T}, v_{1:T}, ṽ_{T+1}, done) and
sliced into fixed-horizon segments streamed to the experience channel —
rollouts are *interruptible*: segments of an unfinished episode ship
immediately with a bootstrap value, so the trainer never waits for long
episodes (episode-level long-tail removal).

The worker is a :class:`~repro_torch.runtime.service.Service`; its pacing
is a :class:`~repro_torch.runtime.service.RolloutGate` supplied by the
scheduler — :class:`NullGate` free-runs (async mode), the barrier gate
reproduces the synchronous baseline's step/episode barriers through the
SAME loop.

Task selection uses Dynamic Weighted Resampling (App. D.4).

As in the reference ``repro/runtime/rollout.py``, with its import-gated
tracing (``REPRO_TRACE``: ``rollout.put``). The worker submits to the
port's :class:`~repro_torch.runtime.inference.InferenceService` (or to a
:class:`~repro_torch.runtime.transport.inference_plane.RemoteInferenceClient`),
which answers with numpy actions, log-probs and a float value.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.resampler import DynamicWeightedResampler
from repro_torch.envs.toy_manipulation import ManipulationEnv
from repro_torch.runtime.service import NULL_GATE, RolloutGate, Service

# Import-gated tracing (see transport.faults for the idiom): when off,
# the put path below carries zero extra work and zero extra keys.
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None


def episode_to_segments(traj: Dict[str, np.ndarray], horizon: int
                        ) -> List[Dict[str, np.ndarray]]:
    """Slice an episode (T steps) into fixed-``horizon`` segments with a
    T+1 bootstrap slot each; ragged tails are padded and masked."""
    t = len(traj["rewards"])
    segs = []
    for s0 in range(0, t, horizon):
        s1 = min(s0 + horizon, t)
        n = s1 - s0
        pad = horizon - n

        def pad_steps(x, fill=0):
            x = np.asarray(x[s0:s1])
            if pad:
                x = np.concatenate(
                    [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
            return x

        # T+1 slot: the observation after the last step of the segment
        def with_bootstrap(x):
            x = np.asarray(x[s0:s1 + 1])
            need = horizon + 1 - len(x)
            if need:
                x = np.concatenate(
                    [x, np.repeat(x[-1:], need, axis=0)])
            return x

        segs.append({
            "obs_tokens": with_bootstrap(traj["obs_tokens"]),
            "frames": with_bootstrap(traj["frames"]),
            "actions": with_bootstrap(traj["actions"]),
            "behavior_logp": with_bootstrap(traj["behavior_logp"]),
            "behavior_value": with_bootstrap(traj["values"]),
            "rewards": pad_steps(traj["rewards"]),
            "dones": pad_steps(traj["dones"]),
            "steps": with_bootstrap(traj["steps"]),
            "mask": np.concatenate(
                [np.ones(n, np.float32), np.zeros(pad, np.float32)]),
            "policy_version": np.int32(traj["policy_version"]),
            "task_id": np.int32(traj["task_id"]),
            "success": np.float32(traj["success"]),
        })
    return segs


class RolloutWorker(Service):
    def __init__(self, worker_id: int, cfg: ModelConfig,
                 inference, experience, *,
                 suite: str = "spatial",
                 resampler: Optional[DynamicWeightedResampler] = None,
                 segment_horizon: int = 8,
                 max_steps: int = 30,
                 latency=None, seed: int = 0,
                 frame_channel=None,
                 gate: Optional[RolloutGate] = None):
        super().__init__(f"rollout-{worker_id}", role="rollout")
        self.worker_id = worker_id
        self.cfg = cfg
        self.inference = inference
        self.experience = experience
        self.resampler = resampler
        self.segment_horizon = segment_horizon
        self.frame_channel = frame_channel    # optional B_wm feed (real frames)
        self.gate = gate or NULL_GATE
        self.env = ManipulationEnv(
            suite=suite, task_id=0, max_steps=max_steps,
            action_vocab=cfg.action_vocab_size, action_dim=cfg.action_dim,
            latency=latency, seed=seed)

    # -- registry-backed counters (the service's public read surface) ----------
    @property
    def env_steps(self) -> int:
        return int(self.metrics.counter("env_steps"))

    @property
    def episodes_done(self) -> int:
        return int(self.metrics.counter("episodes"))

    @property
    def successes(self) -> int:
        return int(self.metrics.counter("successes"))

    @property
    def returns(self) -> List[float]:
        return self.metrics.series("return")

    # -- episode loop -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.gate.begin_episode(self._stop):
                continue
            try:
                task = (self.resampler.sample_task()
                        if self.resampler is not None else 0)
                self._episode(task)
            finally:
                self.gate.end_episode()

    def _episode(self, task_id: int) -> None:
        obs = self.env.reset(task_id)
        traj = {k: [] for k in ("obs_tokens", "frames", "actions",
                                "behavior_logp", "values", "rewards",
                                "dones", "steps")}
        version = -1
        ep_return, success = 0.0, False
        done = False
        while not done and not self._stop.is_set():
            self.gate.before_step(self._stop)
            fut = self.inference.submit(obs["tokens"], obs["frame"],
                                        obs["step"])
            try:
                res = fut.result(timeout=30.0)
            except Exception:
                return
            traj["obs_tokens"].append(obs["tokens"])
            traj["frames"].append(obs["frame"])
            traj["steps"].append(obs["step"])
            traj["actions"].append(res["actions"])
            traj["behavior_logp"].append(res["logp"])
            traj["values"].append(res["value"])
            version = res["policy_version"]
            obs, reward, done, info = self.env.step(res["actions"])
            traj["rewards"].append(reward)
            # natural termination only (truncation bootstraps, App. C.1)
            traj["dones"].append(float(done and not info["truncated"]))
            ep_return += reward
            success = success or info["success"]
            self.metrics.inc("env_steps")
        if self._stop.is_set() and not done:
            return
        # bootstrap slot o_{T+1}
        traj["obs_tokens"].append(obs["tokens"])
        traj["frames"].append(obs["frame"])
        traj["steps"].append(obs["step"])
        traj["actions"].append(np.zeros(self.cfg.action_dim, np.int32))
        traj["behavior_logp"].append(np.zeros(self.cfg.action_dim,
                                              np.float32))
        traj["values"].append(0.0)
        traj["policy_version"] = version
        traj["task_id"] = task_id
        traj["success"] = float(success)

        segments = episode_to_segments(traj, self.segment_horizon)
        # batched flush: one backpressure verdict per segment, and over a
        # remote channel ONE codec blob + round-trip per episode instead
        # of one per segment (or one pipelined stream frame, in which
        # case the verdicts here are provisional and the channel's
        # stream stats carry the authoritative accept counts)
        if _tel is not None:
            # One trace per episode flush: the id is stamped into every
            # segment (collate only stacks named keys, so extra scalars
            # survive the channel untouched) and rides the put-frame
            # header, joining rollout.put -> server.apply -> trainer
            # collate into one cross-process chain.
            trace = _tel.new_id()
            t_put = time.time()
            for seg in segments:
                seg["_trace"] = trace
                seg["_t_put"] = t_put
            with _tel.span("rollout.put", cat="rollout", trace=trace,
                           args={"worker": self.worker_id,
                                 "segments": len(segments),
                                 "policy_version": int(version)},
                           flow="start"):
                verdicts = self.experience.put_many(segments)
        else:
            verdicts = self.experience.put_many(segments)
        self.metrics.inc("segments", float(len(segments)))
        rejected = sum(1 for v in verdicts if not v)
        if rejected:
            self.metrics.inc("segments_rejected", float(rejected))
        # policy staleness of the worker's last episode
        self.metrics.set_gauge("policy_version", float(version))
        if self.frame_channel is not None:
            self.frame_channel.put_many([
                {
                    "frame": traj["frames"][i],
                    "next_frame": traj["frames"][i + 1],
                    "tokens": traj["obs_tokens"][i],
                    "step": np.int32(traj["steps"][i]),
                    "actions": traj["actions"][i],
                    "reward": traj["rewards"][i],
                    "success": np.float32(
                        traj["success"] if i == len(traj["rewards"]) - 1
                        else 0.0),
                }
                for i in range(len(traj["rewards"]))
            ])
        self.metrics.inc("episodes")
        self.metrics.inc("successes", float(success))
        self.metrics.record("return", ep_return)
        if self.resampler is not None:
            self.resampler.update_history(task_id, float(success))
