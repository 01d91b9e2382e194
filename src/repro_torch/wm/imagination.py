"""Imagination rollouts (paper §4.1), as in the reference
``repro/wm/imagination.py``.

A real frame o_t seeds the rollout (ô_t = o_t); the policy M_policy produces
â_t; M_obs samples ô_{t+1}; M_reward scores both frames; the imagined
reward is the potential difference (eq. 4)

    r̂_t = M_reward(ô_{t+1}) − M_reward(ô_t)

scaled by ``reward_scale``, with the termination signal d̂one from the
success probability. Trajectories are STRICTLY capped at horizon H to bound
autoregressive compounding error, packaged per eq. 3, and pushed to B_img.

The reference runs the horizon as one jitted ``lax.scan``; here it is a
Python loop over the same body. On a CUDA device each step's action sampling
runs the policy's prefill (K1) and its decode tokens (K2); the world model's
own products are plain PyTorch. With ``REPRO_TRACE`` set, the worker
records a ``wm.imagine`` span around each imagination call, as the
reference does; the call returns numpy results, so the span closes after
the device work.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, WMConfig
from repro_torch.models.policy import sample_action_sequence
from repro_torch.models.transformer import FRONTEND_DIM
from repro_torch.runtime.service import Service
from repro_torch.wm import denoiser as dn
from repro_torch.wm import reward as rw

# Import-gated tracing (see transport.faults for the idiom).
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None

_NULL_CTX = contextlib.nullcontext()

SUCCESS_THRESHOLD = 0.9


def _frame_prefix(frames: torch.Tensor) -> torch.Tensor:
    """[B, F_env] -> [B, 1, FRONTEND_DIM] zero-padded stub embedding."""
    b, f = frames.shape
    pad = frames.new_zeros((b, FRONTEND_DIM - f))
    return torch.cat([frames, pad], dim=-1)[:, None, :]


def imagine_rollout(policy_params, obs_params, reward_params,
                    gen: Optional[torch.Generator], tokens: torch.Tensor,
                    frame0: torch.Tensor, step0: torch.Tensor, *,
                    cfg: ModelConfig, wm: WMConfig,
                    noise: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Horizon-H imagined rollout from real seed frames.

    tokens: [B, T_obs] (instruction — constant across the horizon);
    frame0: [B, F]; step0: [B]. Returns eq.-3 arrays with an H+1 slot.
    Noise comes from ``gen``, or from ``noise``: ``"gumbel"`` [H, A, B, Va]
    (each step's draws for ``sample_action_sequence``) and ``"x0"``
    [H, B, F] (each step's start for ``sample_next_frame``).
    """
    b = frame0.shape[0]
    hist = frame0[:, None, :].repeat(1, wm.history_frames, 1)
    frame, step = frame0, step0.to(torch.int32)
    p_cur = rw.reward_apply(reward_params, frame0)
    outs = []
    for t in range(wm.imagine_horizon):
        gumbel = None if noise is None else noise["gumbel"][t]
        x0 = None if noise is None else noise["x0"][t]
        actions, logp, value = sample_action_sequence(
            cfg, policy_params, gen, tokens, step, _frame_prefix(frame),
            gumbel=gumbel)
        frame_next = dn.sample_next_frame(obs_params, gen, hist, actions, wm,
                                          x0=x0)
        p_next = rw.reward_apply(reward_params, frame_next)
        outs.append(dict(
            frame=frame, actions=actions, logp=logp, value=value,
            reward=wm.reward_scale * (p_next - p_cur),        # eq. 4
            done=(p_next > SUCCESS_THRESHOLD).float(), step=step))
        hist = torch.cat([hist[:, 1:], frame_next[:, None]], dim=1)
        frame, step, p_cur = frame_next, step + 1, p_next

    # [B, H, ...]; append the H+1 bootstrap slot
    def stack(k):
        return torch.stack([o[k] for o in outs], dim=1)

    def with_slot(k, last):
        return torch.cat([stack(k), last[:, None]], dim=1)

    return {
        "frames": with_slot("frame", frame),                  # [B, H+1, F]
        "obs_tokens": tokens[:, None].repeat(1, wm.imagine_horizon + 1, 1),
        "actions": with_slot("actions", torch.zeros_like(actions)),
        "behavior_logp": with_slot("logp", torch.zeros_like(logp)),
        "behavior_value": with_slot("value", torch.zeros_like(value)),
        "rewards": stack("reward"),
        "dones": stack("done"),
        "steps": with_slot("step", step),
        "mask": torch.ones((b, wm.imagine_horizon), dtype=torch.float32,
                           device=frame0.device),
    }


def make_imagine_fn(cfg: ModelConfig, wm: WMConfig, *, device="cuda"):
    """Batched imagination entry point: numpy inputs in, ``imagine_rollout``
    on ``device`` under ``torch.inference_mode()``, numpy results out."""
    dev = resolve_device(device)

    def fn(policy_params, obs_params, reward_params, gen, tokens: np.ndarray,
           frame0: np.ndarray, step0: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            out = imagine_rollout(
                policy_params, obs_params, reward_params, gen,
                torch.as_tensor(tokens, dtype=torch.long, device=dev),
                torch.as_tensor(frame0, dtype=torch.float32, device=dev),
                torch.as_tensor(step0, dtype=torch.int32, device=dev),
                cfg=cfg, wm=wm)
            return {k: v.cpu().numpy() for k, v in out.items()}
    return fn


def imagine_segment(*args, **kwargs):
    """Alias kept for the public API (one τ̂ segment per call)."""
    return imagine_rollout(*args, **kwargs)


class ImaginationWorker(Service):
    """Generates imagined segments from real seed frames in B_wm and pushes
    them to B_img — the WM-mode replacement for environment interaction.
    An imagination *producer service* registered on the bus by the
    world-model attachment.

    Each call reads ``wm_params_ref["obs"]`` and ``["reward"]`` once; the
    world-model trainer never changes a tree it has bound there (it rebinds
    the entry to a new one), so one call dreams on one version throughout.
    """

    def __init__(self, worker_id: int, cfg: ModelConfig, wm: WMConfig,
                 store, wm_params_ref, frame_channel, img_channel, *,
                 batch: int = 16, seed: int = 0, device="cuda"):
        super().__init__(f"imagination-{worker_id}", role="imagination")
        self.cfg, self.wm = cfg, wm
        self.device = resolve_device(device)
        self.store = store                    # policy weight store
        self.wm_params_ref = wm_params_ref    # dict with obs/reward params
        self.frame_channel = frame_channel    # B_wm (real transitions)
        self.img_channel = img_channel        # B_img
        self.batch = batch
        self._fn = make_imagine_fn(cfg, wm, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 7777)

    @property
    def segments_done(self) -> int:
        return int(self.metrics.counter("segments"))

    @property
    def imagined_steps(self) -> int:
        return int(self.metrics.counter("imagined_steps"))

    def _run(self) -> None:
        while not self._stop.is_set():
            got = self.store.acquire(newer_than=-1, timeout=0.2)
            if got is None:
                continue
            params, version = got
            seeds = self.frame_channel.sample(self.batch)
            if seeds is None:
                time.sleep(0.05)
                continue
            tokens = np.stack([s["tokens"] for s in seeds])
            frames = np.stack([s["frame"] for s in seeds]).astype(np.float32)
            steps = np.array([s["step"] for s in seeds], np.int32)
            # the imagined batch's trace id: the policy version it was
            # dreamed under, so wm.imagine lines up with the
            # weights.publish flow on the Perfetto timeline
            with (_tel.span("wm.imagine", cat="wm", trace=int(version),
                            args={"batch": self.batch,
                                  "horizon": self.wm.imagine_horizon,
                                  "version": int(version)}, flow="step")
                  if _tel is not None else _NULL_CTX):
                with self.metrics.timer("busy_s"):
                    out = self._fn(params, self.wm_params_ref["obs"],
                                   self.wm_params_ref["reward"], self._gen,
                                   tokens, frames, steps)
            self.img_channel.put_many([{
                "obs_tokens": out["obs_tokens"][i],
                "frames": out["frames"][i],
                "actions": out["actions"][i],
                "behavior_logp": out["behavior_logp"][i],
                "behavior_value": out["behavior_value"][i],
                "rewards": out["rewards"][i],
                "dones": out["dones"][i],
                "steps": out["steps"][i],
                "mask": out["mask"][i],
                "policy_version": np.int32(version),
                "task_id": np.int32(0),
                "success": np.float32(0.0),
            } for i in range(self.batch)])
            self.metrics.inc("segments", self.batch)
            self.metrics.inc("imagined_steps",
                             self.batch * self.wm.imagine_horizon)
