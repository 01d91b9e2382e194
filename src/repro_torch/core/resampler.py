"""Dynamic Weighted Resampling (paper App. D.4), a copy of the reference
``repro/core/resampler.py`` (numpy only).

Host-side task sampler: a circular success-history window per task; the
sampling weight is the Laplace-smoothed recent failure rate, so compute is
steered toward lagging tasks while ``eps`` keeps every task alive
(anti-forgetting).
"""
from __future__ import annotations

import threading

import numpy as np


class DynamicWeightedResampler:
    def __init__(self, num_tasks: int, window_size: int = 100,
                 eps: float = 1.0, seed: int = 0):
        self.num_tasks = num_tasks
        self.window_size = window_size
        self.eps = eps
        # Initialized to ones to prevent early bias against unattempted tasks.
        self.history = np.ones((num_tasks, window_size))
        self.ptr = np.zeros(num_tasks, dtype=np.int64)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def update_history(self, task_idx: int, success_flag: float) -> None:
        with self._lock:
            self.history[task_idx, self.ptr[task_idx]] = success_flag
            self.ptr[task_idx] = (self.ptr[task_idx] + 1) % self.window_size

    def probabilities(self) -> np.ndarray:
        with self._lock:
            success_counts = self.history.sum(axis=1)
        failure_counts = self.window_size - success_counts
        weights = failure_counts + self.eps
        return weights / weights.sum()

    def sample_task(self) -> int:
        return int(self._rng.choice(self.num_tasks, p=self.probabilities()))
