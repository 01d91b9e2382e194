"""Built-in multi-task manipulation suite (the LIBERO stand-in), a copy of
the reference ``repro/envs/toy_manipulation.py`` (numpy only): the same
``seed`` and the same actions give the same observations, rewards, ``done``
and ``info``.

A 2-D tabletop: the agent moves, grips an object, and delivers it to a goal.
Four task suites mirror LIBERO's axes of variation:

  * ``spatial`` — goal position varies per task
  * ``object``  — object position varies
  * ``goal``    — both vary
  * ``long``    — two objects must be delivered sequentially (long horizon)

Design choices matched to the paper's experimental structure:
  * observations are a *pixel-interface frame* (coarse 8×8×3 render,
    flattened) consumed by the policy as a prefix embedding and by the world
    model as its native space, plus static instruction tokens — so
    imagination rollouts close the loop without a simulator;
  * rewards are sparse success by default (the regime where the WM's dense
    potential-based rewards matter);
  * per-instance step latency is configurable (lognormal long tails) to
    reproduce the step-level / episode-level stragglers of §3.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

SUITES = ("spatial", "object", "goal", "long")
T_OBS = 12              # instruction token length
GRID = 8                # frame resolution
FRAME_DIM = GRID * GRID * 3
TASKS_PER_SUITE = 10


def _render(agent, obj, goal, obj2=None, goal2=None) -> np.ndarray:
    """Gaussian-blob render to [GRID, GRID, 3] -> flat float32."""
    xs = np.linspace(0, 1, GRID)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")

    def blob(p):
        return np.exp(-(((gx - p[0]) ** 2 + (gy - p[1]) ** 2) / 0.02))
    frame = np.stack([
        blob(agent),
        blob(obj) + (blob(obj2) if obj2 is not None else 0.0),
        blob(goal) + (blob(goal2) if goal2 is not None else 0.0),
    ], axis=-1)
    return np.clip(frame, 0, 1).astype(np.float32).reshape(-1)


class ManipulationEnv:
    """Single (non-vectorized) env instance — the paper's 'no natural
    batchability' regime."""

    def __init__(self, suite: str = "spatial", task_id: int = 0,
                 max_steps: int = 30, action_vocab: int = 64,
                 action_dim: int = 7, dense_reward: bool = False,
                 latency: Optional[Callable[[], float]] = None,
                 seed: int = 0):
        assert suite in SUITES, suite
        self.suite = suite
        self.task_id = task_id
        self.max_steps = max_steps
        self.action_vocab = action_vocab
        self.action_dim = action_dim
        self.dense_reward = dense_reward
        self.latency = latency
        self._rng = np.random.default_rng(seed)
        self.tol = 0.22
        self.reset(task_id)

    # -- task layout ---------------------------------------------------------
    def _layout(self, task_id: int):
        # zlib.crc32, NOT hash(): python salts str hashes per process, which
        # would make task layouts nondeterministic across runs
        import zlib
        seed = zlib.crc32(f"{self.suite}/{task_id}".encode()) % (2 ** 31)
        r = np.random.default_rng(seed)
        agent = np.array([0.5, 0.5])
        obj = np.array([0.25, 0.25])
        goal = np.array([0.75, 0.75])

        def apart(anchor, min_d=None):
            # resample until the point is a real task (not pre-solved)
            min_d = min_d if min_d is not None else 1.5 * self.tol
            for _ in range(100):
                p = r.uniform(0.15, 0.85, 2)
                if np.linalg.norm(p - anchor) >= min_d:
                    return p
            return p

        if self.suite == "spatial":
            goal = apart(obj)
        elif self.suite == "object":
            obj = apart(goal)
        elif self.suite == "goal":
            obj = r.uniform(0.15, 0.85, 2)
            goal = apart(obj)
        obj2 = goal2 = None
        if self.suite == "long":
            obj = r.uniform(0.15, 0.85, 2)
            goal = apart(obj)
            obj2 = r.uniform(0.15, 0.85, 2)
            goal2 = apart(obj2)
        return agent, obj, goal, obj2, goal2

    def reset(self, task_id: Optional[int] = None) -> Dict:
        if task_id is not None:
            self.task_id = task_id
        (self.agent, self.obj, self.goal,
         self.obj2, self.goal2) = self._layout(self.task_id)
        self.holding = 0          # 0 none, 1 obj, 2 obj2
        self.delivered = 0        # for the long suite
        self.t = 0
        return self._obs()

    def _instruction_tokens(self) -> np.ndarray:
        toks = np.zeros(T_OBS, np.int32)
        toks[0] = SUITES.index(self.suite) + 1
        toks[1] = 10 + (self.task_id % TASKS_PER_SUITE)
        toks[2] = 30 + self.delivered
        return toks

    def _obs(self) -> Dict:
        if self.suite == "long" and self.delivered >= 1:
            frame = _render(self.agent,
                            self.obj2, self.goal2)
        else:
            frame = _render(self.agent, self.obj, self.goal,
                            self.obj2, self.goal2)
        return {"tokens": self._instruction_tokens(),
                "frame": frame, "step": self.t}

    def _decode(self, action_tokens: np.ndarray) -> np.ndarray:
        a = np.asarray(action_tokens, np.float64)
        return (a / (self.action_vocab - 1)) * 2.0 - 1.0

    def _active_target(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.suite == "long" and self.delivered >= 1:
            return self.obj2, self.goal2
        return self.obj, self.goal

    def step(self, action_tokens: np.ndarray):
        if self.latency is not None:
            time.sleep(self.latency())
        a = self._decode(action_tokens)
        obj, goal = self._active_target()

        prev_potential = self._potential()
        self.agent = np.clip(self.agent + 0.18 * a[:2], 0, 1)
        grip = a[2] > 0
        if grip and np.linalg.norm(self.agent - obj) < self.tol:
            self.holding = 2 if (self.suite == "long"
                                 and self.delivered >= 1) else 1
        if not grip:
            self.holding = 0
        if self.holding:
            if self.holding == 1:
                self.obj = self.agent.copy()
            else:
                self.obj2 = self.agent.copy()

        obj, goal = self._active_target()
        success_now = np.linalg.norm(obj - goal) < self.tol
        reward, done, success = 0.0, False, False
        if success_now:
            if self.suite == "long" and self.delivered == 0:
                self.delivered = 1
                self.holding = 0
                reward = 0.5
            else:
                reward, done, success = 1.0, True, True
        if self.dense_reward:
            reward += self._potential() - prev_potential
        self.t += 1
        if self.t >= self.max_steps:
            done = True          # truncation: NOT a natural termination
        obs = self._obs()
        info = {"success": success,
                "truncated": self.t >= self.max_steps and not success}
        return obs, float(reward), bool(done), info

    def _potential(self) -> float:
        """Dense shaping potential (optional): progress toward subgoal."""
        obj, goal = self._active_target()
        d_ag = np.linalg.norm(self.agent - obj)
        d_og = np.linalg.norm(obj - goal)
        return -0.5 * d_ag - 1.0 * d_og

    def oracle_action(self) -> np.ndarray:
        """Scripted expert (for imitation baselines / WM pretraining data)."""
        obj, goal = self._active_target()
        if self.holding:
            target, grip = goal, 1.0
        elif np.linalg.norm(self.agent - obj) < self.tol * 0.8:
            target, grip = obj, 1.0      # close the gripper BEFORE moving
        else:
            target, grip = obj, -1.0
        delta = np.clip((target - self.agent) / 0.18, -1, 1)
        a = np.zeros(self.action_dim)
        a[:2] = delta
        a[2] = grip
        noise = self._rng.normal(0, 0.05, self.action_dim)
        tokens = np.round(((a + noise + 1) / 2) * (self.action_vocab - 1))
        return np.clip(tokens, 0, self.action_vocab - 1).astype(np.int32)


def lognormal_latency(mean_ms: float = 2.0, sigma: float = 1.0,
                      seed: int = 0) -> Callable[[], float]:
    """Long-tailed physics-step latency generator (§3 step-level tail)."""
    rng = np.random.default_rng(seed)
    mu = np.log(mean_ms / 1000.0)
    return lambda: float(rng.lognormal(mu, sigma))
