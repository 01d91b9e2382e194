"""Inference-as-a-Service pool (paper §3.2), as in the reference
``repro/runtime/inference.py``.

Rollout workers submit per-env observation requests and suspend; every
inference worker drains a shared request queue and triggers a batched
forward pass under the dynamic window rule (eq. 1):

    Trigger = (|Q| >= B) ∨ (t_now − t_first >= T_max)

Dynamic batches are padded up to the nearest bucket size, as in the
reference, so the set of batch shapes the kernels see stays small.

The drain protocol (App. D.6): when the weight store raises its drain flag,
workers stop scheduling NEW batches, finish the in-flight one, then swap
weights before resuming — update atomicity + version consistency.

The pool runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
PyTorch route). Sampling noise comes from one ``torch.Generator`` per
batch, seeded from the service's own generator under a lock.
"""
from __future__ import annotations

import queue
import statistics
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.models.policy import make_inference_fn
from repro_torch.models.transformer import FRONTEND_DIM
from repro_torch.runtime.service import Service
from repro_torch.runtime.weight_store import VersionedWeightStore


class _Request:
    __slots__ = ("obs_tokens", "frame", "step", "future", "t_arrival")

    def __init__(self, obs_tokens, frame, step):
        self.obs_tokens = obs_tokens        # [T_obs] i32
        self.frame = frame                  # [F] f32 or None
        self.step = step                    # int
        self.future: Future = Future()
        self.t_arrival = time.monotonic()


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests. ``n`` larger than the
    biggest bucket is the caller's bug — windows must be split first
    (``split_window``)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"window of {n} requests exceeds the largest batch bucket "
        f"{buckets[-1]}; split the window before padding")


def split_window(n: int, buckets: Sequence[int]) -> List[int]:
    """Chunk an ``n``-request window into bucket-sized pieces: full largest
    buckets, then one bucket-padded remainder."""
    top = buckets[-1]
    sizes = [top] * (n // top)
    if n % top:
        sizes.append(n % top)
    return sizes


class InferenceService(Service):
    """Centralized inference pool: one shared queue, N worker threads."""

    def __init__(self, cfg: ModelConfig, store: VersionedWeightStore,
                 rt: RuntimeConfig, *, temperature: float = 1.0, seed: int = 0,
                 device="cuda"):
        super().__init__("inference", role="inference")
        self.cfg = cfg
        self.store = store
        self.rt = rt
        self.device = resolve_device(device)
        self._fn = make_inference_fn(cfg, temperature, device=self.device)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._gen = torch.Generator().manual_seed(seed)
        self._key_lock = threading.Lock()
        # live eq.-1 window parameters (schedulers may re-shape these)
        self.window_batch = rt.inference_batch
        self.window_wait_s = rt.inference_max_wait_s

    # -- registry-backed counters ----------------------------------------------
    @property
    def batches_run(self) -> int:
        return int(self.metrics.counter("batches"))

    @property
    def requests_served(self) -> int:
        return int(self.metrics.counter("requests"))

    @property
    def padded_slots(self) -> int:
        return int(self.metrics.counter("padded_slots"))

    @property
    def weight_swaps(self) -> int:
        return int(self.metrics.counter("weight_swaps"))

    @property
    def degenerate_batches(self) -> int:
        return int(self.metrics.counter("degenerate_batches"))

    # -- client API -----------------------------------------------------------
    def submit(self, obs_tokens: np.ndarray, frame: Optional[np.ndarray],
               step: int) -> Future:
        """Asynchronous request; the rollout worker suspends on the future."""
        req = _Request(obs_tokens, frame, step)
        self._q.put(req)
        return req.future

    # -- service surface --------------------------------------------------------
    def _thread_targets(self):
        return [self._run] * self.rt.num_inference_workers

    # -- worker loop --------------------------------------------------------------
    def _next_generator(self) -> torch.Generator:
        """A fresh generator on the service's device for one batch (the
        reference splits its PRNG key here)."""
        with self._key_lock:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _collect_window(self) -> List[_Request]:
        """Dynamic-window batching, eq. 1. The T_max timer anchors to
        collection start, not the first request's arrival, so a request
        that sat queued during the previous batch cannot expire the window
        the moment it is picked up. Queue wait is the ``queue_wait_s``
        series."""
        reqs: List[_Request] = []
        t_start = None
        while not self._stop.is_set():
            b, t_max = self.window_batch, self.window_wait_s
            timeout = 0.002 if t_start is None else max(
                0.0, t_max - (time.monotonic() - t_start))
            try:
                r = self._q.get(timeout=max(timeout, 1e-4))
                now = time.monotonic()
                if t_start is None:
                    t_start = now
                reqs.append(r)
                wait = max(now - r.t_arrival, 0.0)
                self.metrics.record("queue_wait_s", wait)
                self.metrics.observe("queue_wait_s", wait)
            except queue.Empty:
                pass
            if reqs and (len(reqs) >= b or
                         time.monotonic() - t_start >= t_max):
                self.metrics.observe("window_fill_s",
                                     time.monotonic() - t_start)
                return reqs
        return reqs

    def _note_swap(self, version: int) -> None:
        self.metrics.inc("weight_swaps")
        self.metrics.set_gauge("weight_version", float(version))

    def _run(self) -> None:
        params, version = None, -1
        while not self._stop.is_set():
            # drain protocol: no NEW batch while the trainer is publishing
            if self.store.draining or params is None:
                got = self.store.acquire(newer_than=version, timeout=0.1)
                if got is not None:
                    params, version = got
                    self._note_swap(version)
                if params is None:
                    continue
            reqs = self._collect_window()
            if not reqs:
                continue
            # a window carved AFTER the drain signal is a NEW batch and
            # must wait for the swap (no batch starts on stale weights)
            while self.store.draining and not self._stop.is_set():
                got = self.store.acquire(newer_than=version, timeout=0.1)
                if got is not None:
                    params, version = got
                    self._note_swap(version)
                    break
            # a publish that landed while the window was being carved is
            # picked up too: the reference swaps only on an observed drain
            # flag, and so served such a window on the old weights
            got = self.store.acquire(newer_than=version, timeout=0)
            if got is not None:
                params, version = got
                self._note_swap(version)
            if len(reqs) == 1:
                self.metrics.inc("degenerate_batches")
            self.metrics.set_gauge("queue_depth", float(self._q.qsize()))
            # oversized windows are split into bucket-sized chunks
            start = 0
            for size in split_window(len(reqs), self.rt.batch_buckets):
                self._run_batch(reqs[start:start + size], params, version)
                start += size

    def _run_batch(self, reqs: List[_Request], params, version: int) -> None:
        t0 = time.monotonic()
        with self.metrics.timer("busy_s"):
            n = len(reqs)
            nb = pad_to_bucket(n, self.rt.batch_buckets)
            self.metrics.inc("padded_slots", nb - n)
            self.metrics.set_gauge("window_fill", n / nb)
            obs = np.stack([r.obs_tokens for r in reqs] +
                           [reqs[-1].obs_tokens] * (nb - n))
            steps = np.array([r.step for r in reqs] +
                             [reqs[-1].step] * (nb - n), np.int32)
            prefix = None
            if reqs[0].frame is not None:
                fr = np.stack([r.frame for r in reqs] +
                              [reqs[-1].frame] * (nb - n))
                prefix = _frame_to_prefix(fr)
            tokens, logps, values = self._fn(params, self._next_generator(),
                                             obs, steps, prefix)
            for i, r in enumerate(reqs):
                r.future.set_result({
                    "actions": tokens[i], "logp": logps[i],
                    "value": float(values[i]), "policy_version": version,
                })
            self.metrics.inc("batches")
            self.metrics.inc("requests", n)
        # per-batch latency: window carved -> results on the host; its
        # median over the recent window as a gauge, which a remote
        # worker's report carries to the parent (series cross as
        # count/mean/last only)
        self.metrics.record("batch_s", time.monotonic() - t0)
        self.metrics.set_gauge(
            "batch_s_p50", statistics.median(self.metrics.series("batch_s")))


def _frame_to_prefix(frames: np.ndarray) -> np.ndarray:
    """[B, F_env] env frame -> [B, 1, FRONTEND_DIM] stub frontend embedding
    (zero-padded — the allowed modality-frontend carve-out)."""
    b, f = frames.shape
    out = np.zeros((b, 1, FRONTEND_DIM), np.float32)
    out[:, 0, :min(f, FRONTEND_DIM)] = frames[:, :FRONTEND_DIM]
    return out
