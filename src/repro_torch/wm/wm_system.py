"""AcceRL-WM: the world-model-augmented mode (paper §4, Fig. 2b), as in the
reference ``repro/wm/wm_system.py``.

The world model is a *plug-and-play attachment*, not a subclass of the
orchestrator: :class:`WorldModelAttachment` binds to an
:class:`~repro_torch.runtime.orchestrator.AcceRLSystem` via
``system.attach(...)`` and registers on the service bus

  * B_img — a FIFO channel of imagined τ̂ segments,
  * N :class:`~repro_torch.wm.imagination.ImaginationWorker` producer
    services,
  * a :class:`WorldModelTrainer` service running the decoupled M_obs /
    M_reward loops (§4.2: M_obs every ``obs_train_interval`` cycles on
    B_wm; M_reward every ``reward_train_interval``),
  * a rewire of the existing policy trainer onto a
    :class:`~repro_torch.runtime.experience.MixedExperienceSource` over (B,
    B_img) at ``rt.mix_real_fraction`` (0.0 = the paper's pure-imagination
    diet) — the same trainer service, its prefetcher on the same ingest
    path, a different experience diet.

``AcceRLWMSystem(...)`` is the one-call constructor: it builds the base
system with frame collection on and attaches the world model — the
returned object IS an ``AcceRLSystem``; ``run_wm`` is the async scheduler
over the extended service set.

``pretrain_world_model`` — the paper's offline WM pre-training on oracle
trajectories (1,000 offline trajectories in Fig. 4b).

The port's AdamW updates in place, and the reference's WM trainer rebinds
the shared entries to new trees after each update. So the WM trainer steps
private copies and rebinds each shared entry to a detached clone after an
update: a tree an imagination call has read is never written. With
``rt.pipeline`` the trainer's pipeline executor drives the WM trainer as
its second stage (``driven``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ModelConfig, RLConfig, RuntimeConfig,
                                      WMConfig)
from repro_torch.envs.toy_manipulation import FRAME_DIM, ManipulationEnv
from repro_torch.optim import adamw
from repro_torch.runtime.experience import FifoChannel, MixedExperienceSource
from repro_torch.runtime.orchestrator import AcceRLSystem
from repro_torch.runtime.service import Service
from repro_torch.runtime.trainer import TrainerWorker
from repro_torch.tree import tree_map
from repro_torch.wm import denoiser as dn
from repro_torch.wm import reward as rw
from repro_torch.wm.imagination import ImaginationWorker


def _clone(tree, device=None):
    """Detached copies of every tensor leaf (an AdamWState's too), on
    ``device`` (default: each leaf's own)."""
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_clone(x, device) for x in tree))
    with torch.no_grad():
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(device, copy=True)
        return tree_map(lambda p: p.detach().to(device, copy=True), tree)


def pretrain_world_model(suite: str, wm: WMConfig, *, trajectories: int = 100,
                         train_steps: int = 300, batch: int = 64,
                         action_vocab: int = 64, action_dim: int = 7,
                         max_steps: int = 30, seed: int = 0,
                         device="cuda") -> Dict:
    """Collect oracle (out-of-distribution) trajectories offline and
    pre-train M_obs + M_reward on ``device`` — the paper's 1,000-trajectory
    setup."""
    dev = resolve_device(device)
    env = ManipulationEnv(suite=suite, action_vocab=action_vocab,
                          action_dim=action_dim, max_steps=max_steps,
                          seed=seed)
    transitions = []
    rng = np.random.default_rng(seed)
    for ep in range(trajectories):
        obs = env.reset(int(rng.integers(0, 10)))
        done = False
        frames, actions, successes = [obs["frame"]], [], []
        while not done:
            a = env.oracle_action()
            obs, r, done, info = env.step(a)
            frames.append(obs["frame"])
            actions.append(a)
            successes.append(float(info["success"]))
        for i in range(len(actions)):
            transitions.append((frames[i], actions[i], frames[i + 1],
                                successes[i]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    obs_params = dn.denoiser_init(gen, FRAME_DIM, action_dim, action_vocab,
                                  wm)
    rew_params = rw.reward_init(gen, FRAME_DIM)
    obs_opt = adamw.init(obs_params)
    rew_opt = adamw.init(rew_params)
    dn_step = dn.make_denoiser_train_step(wm)
    rw_step = rw.make_reward_train_step()

    n = len(transitions)
    as_t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    f0 = as_t(np.stack([t[0] for t in transitions]))
    ac = as_t(np.stack([t[1] for t in transitions]).astype(np.int64))
    f1 = as_t(np.stack([t[2] for t in transitions]))
    sc = as_t(np.array([t[3] for t in transitions], np.float32))
    losses = {"obs": [], "reward": []}
    for step in range(train_steps):
        idx = as_t(rng.integers(0, n, batch))
        hist = f0[idx][:, None].repeat(1, wm.history_frames, 1)
        obs_params, obs_opt, l_obs = dn_step(obs_params, obs_opt, gen,
                                             f1[idx], hist, ac[idx])
        rew_params, rew_opt, l_rew = rw_step(rew_params, rew_opt, f1[idx],
                                             sc[idx])
        losses["obs"].append(l_obs)
        losses["reward"].append(l_rew)
    # one read of the curves at the end, not a sync every step
    losses = {k: torch.stack(v).tolist() if v else []
              for k, v in losses.items()}
    return {"obs": obs_params, "reward": rew_params,
            "obs_opt": obs_opt, "reward_opt": rew_opt,
            "losses": losses, "transitions": n}


class WorldModelTrainer(Service):
    """The M_obs / M_reward trainer loops (§4.2) as one bus service:
    samples real transitions from B_wm and, after each update, rebinds the
    shared WM parameter reference's entry ("broadcast to the Inference Pool
    only on update" — imagination workers read the same dict).

    The updates run on private copies of the given trees and moments, and
    each rebind hands the dict a detached clone, so no tree that a reader
    may hold is written in place (the port's AdamW updates in place).

    ``driven=True``: cycles come from an external driver (the pipeline
    executor's WM stage calls ``train_cycle`` on ``sample_batch``'s
    batches) and this service's own loop idles."""

    def __init__(self, wm: WMConfig, wm_params: Dict, opts: Dict,
                 frame_channel, *, batch: int = 32, seed: int = 0,
                 driven: bool = False, device="cuda"):
        super().__init__("wm-trainer", role="wm")
        self.wm = wm
        self.device = resolve_device(device)
        self.wm_params = wm_params            # shared mutable reference
        self._obs = _clone(wm_params["obs"])
        self._rew = _clone(wm_params["reward"])
        self._obs_opt = _clone(opts["obs"])
        self._rew_opt = _clone(opts["reward"])
        self._dn_step = dn.make_denoiser_train_step(wm)
        self._rw_step = rw.make_reward_train_step()
        self.frame_channel = frame_channel
        self.batch = batch
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1234)
        self.driven = driven
        self._cycle = 0

    @property
    def cycles(self) -> int:
        return self._cycle

    @property
    def updates(self) -> Dict[str, int]:
        return {"obs": int(self.metrics.counter("obs_updates")),
                "reward": int(self.metrics.counter("reward_updates"))}

    def sample_batch(self):
        """Next B_wm batch, or None when the channel is still empty."""
        return self.frame_channel.sample(self.batch)

    def train_cycle(self, batch) -> Dict[str, int]:
        """One decoupled M_obs / M_reward cycle on a sampled B_wm batch
        (§4.2) — the body of the free-running loop."""
        self._cycle += 1
        cycle = self._cycle
        obs_due = cycle % self.wm.obs_train_interval == 0
        rew_due = cycle % self.wm.reward_train_interval == 0
        if not (obs_due or rew_due):
            return {"cycle": cycle}
        as_t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        f1 = as_t(np.stack([b["next_frame"] for b in batch])
                  .astype(np.float32))
        with self.metrics.timer("busy_s"):
            if obs_due:
                f0 = as_t(np.stack([b["frame"] for b in batch])
                          .astype(np.float32))
                ac = as_t(np.stack([b["actions"] for b in batch])
                          .astype(np.int64))
                hist = f0[:, None].repeat(1, self.wm.history_frames, 1)
                self._obs, self._obs_opt, _ = self._dn_step(
                    self._obs, self._obs_opt, self._gen, f1, hist, ac)
                self.wm_params["obs"] = _clone(self._obs)
                self.metrics.inc("obs_updates")
            if rew_due:
                sc = as_t(np.array([b["success"] for b in batch],
                                   np.float32))
                self._rew, self._rew_opt, _ = self._rw_step(
                    self._rew, self._rew_opt, f1, sc)
                self.wm_params["reward"] = _clone(self._rew)
                self.metrics.inc("reward_updates")
        return {"cycle": cycle}

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.driven:                     # pipeline-executor drive
                self._stop.wait(0.05)
                continue
            batch = self.sample_batch()
            if batch is None:
                self._stop.wait(0.05)
                continue
            self.train_cycle(batch)
            self._stop.wait(0.001)


class WorldModelAttachment:
    """Binds the world model onto a base system's service bus."""

    def __init__(self, wm: WMConfig, *, wm_params: Optional[Dict] = None,
                 num_imagination_workers: int = 1,
                 imagination_batch: int = 16, seed: int = 0):
        self.wm = wm
        self._init_params = wm_params
        self.num_imagination_workers = num_imagination_workers
        self.imagination_batch = imagination_batch
        self.seed = seed
        # populated by bind()
        self.img_channel: Optional[FifoChannel] = None
        self.wm_params: Optional[Dict] = None
        self.wm_trainer: Optional[WorldModelTrainer] = None
        self.imaginers: list = []
        self.img_trainer: Optional[TrainerWorker] = None

    def bind(self, system: AcceRLSystem) -> None:
        if system.frame_channel is None:
            raise RuntimeError(
                "world-model attachment needs real transitions: build the "
                "system with collect_frames=True (B_wm)")
        cfg, rt, dev = system.cfg, system.rt, system.device
        if (0.0 < rt.mix_real_fraction < 1.0
                and system.segment_horizon != self.wm.imagine_horizon):
            # a mixed diet collates real and imagined segments into ONE
            # super-batch — their time axes must agree, or np.stack dies
            # deep inside the prefetcher thread instead of here
            raise ValueError(
                f"mix_real_fraction={rt.mix_real_fraction} blends real "
                f"segments (horizon {system.segment_horizon}) with "
                f"imagined ones (horizon {self.wm.imagine_horizon}) in one "
                f"batch; set segment_horizon == wm.imagine_horizon")
        seed = self.seed
        self.img_channel = FifoChannel(rt.img_replay_capacity,
                                       policy=rt.replay_backpressure)
        init = self._init_params or {}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 99)
        obs = init.get("obs")
        if obs is None:
            obs = dn.denoiser_init(gen, FRAME_DIM, cfg.action_dim,
                                   cfg.action_vocab_size, self.wm)
        reward = init.get("reward")
        if reward is None:
            reward = rw.reward_init(gen, FRAME_DIM)
        # shared mutable reference — imagination workers read the newest
        # WM weights; the WM trainer rebinds its entries on update
        self.wm_params = {"obs": obs, "reward": reward}
        opts = {k: (init.get(f"{k}_opt") if init.get(f"{k}_opt") is not None
                    else adamw.init(self.wm_params[k]))
                for k in ("obs", "reward")}
        # rewire the SAME policy trainer to consume (B, B_img) at the
        # configured real/imagined mix — no second TrainerWorker, so the
        # params/optimizer tree and the train step are built exactly once
        source = MixedExperienceSource(
            system.experience, self.img_channel,
            real_fraction=rt.mix_real_fraction)
        trainer = system.trainer
        trainer.rewire(source, self.imagination_batch)
        self.img_trainer = trainer
        system.img_trainer = trainer

        # pipeline mode: the WM trainer becomes the second pipeline stage
        # — the executor drives train_cycle beside the policy's
        # micro-batches instead of the service's own loop
        driven = rt.pipeline and trainer.pipeline is not None
        self.wm_trainer = system.registry.register(WorldModelTrainer(
            self.wm, self.wm_params, opts, system.frame_channel,
            seed=seed, driven=driven, device=dev))
        if driven:
            trainer.set_wm_stage(self.wm_trainer.train_cycle,
                                 self.wm_trainer.sample_batch)
        self.imaginers = [
            system.registry.register(ImaginationWorker(
                i, cfg, self.wm, system.store, self.wm_params,
                system.frame_channel, self.img_channel,
                batch=self.imagination_batch, seed=seed + i, device=dev))
            for i in range(self.num_imagination_workers)
        ]
        system.imaginers = self.imaginers
        system.wm_params = self.wm_params
        system.wm_trainer = self.wm_trainer

    def extend_metrics(self, m: Dict, system: AcceRLSystem) -> None:
        m["imagined_steps"] = sum(im.imagined_steps for im in self.imaginers)
        m["img_train_steps"] = self.img_trainer.steps_done
        m["wm_updates"] = self.wm_trainer.updates
        m["real_env_steps"] = m["env_steps"]
        m["img_buffer_dropped"] = self.img_channel.total_dropped
        m["mix_real_fraction"] = self.img_trainer.source.real_fraction


def AcceRLWMSystem(cfg: ModelConfig, rl: RLConfig, rt: RuntimeConfig,
                   wm: WMConfig, *, wm_params: Optional[Dict] = None,
                   num_imagination_workers: int = 1,
                   imagination_batch: int = 16, seed: int = 0,
                   **kw) -> AcceRLSystem:
    """World-model-augmented asynchronous system: the base
    :class:`AcceRLSystem` (collecting real frames into B_wm) with a
    :class:`WorldModelAttachment` plugged onto its service bus. ``kw`` goes
    to ``AcceRLSystem`` (``device`` among them)."""
    system = AcceRLSystem(cfg, rl, rt, collect_frames=True, seed=seed, **kw)
    system.attach(WorldModelAttachment(
        wm, wm_params=wm_params,
        num_imagination_workers=num_imagination_workers,
        imagination_batch=imagination_batch, seed=seed))
    return system
