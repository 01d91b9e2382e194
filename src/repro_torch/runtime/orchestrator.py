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
reference's keys (``pipeline_*`` when the trainer runs the pipelined
executor) and the full per-service snapshot under ``metrics()["services"]``.

The system runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
plain PyTorch route): the inference pool, the trainer and ``evaluate`` all
run there, and on CUDA the kernels are built before any service starts.

Remote rollout workers (``rt.transport``) run as in the reference: a
:class:`~repro_torch.runtime.transport.TransportServer` registered first
hosts the experience channel and the weight store; one
:class:`~repro_torch.runtime.transport.Supervisor` owns the spawned
(``remote_rollout_workers``, ``spawn`` children) and connected
(``connect_rollout_workers``, dialed in by ``repro_torch.launch.worker``)
slots, whose children serve their own policy on the system's device and
pull every published version over the wire. Their env steps and
snapshots join ``metrics()`` under the reference's keys. The supervisor
registers before the trainer (unlike the reference, whose children
could be left redialing a stopped server): stopping in reverse, the
trainer stops first, then the supervisor waits up to
``Supervisor.STOP_GRACE_S`` for its children to exit while the inference
pool and the server still answer their last requests.

The rest of the transport, as in the reference:

  * ``journal_dir`` write-ahead journals the experience channel and every
    weight publish (``transport/resilience.py``); ``resume_journal``
    adopts a previous run's journal before anything starts, the newest
    publish decoded onto the system's device;
  * ``inference_plane="host"`` serves remote rollout workers' action
    requests from this process's own pool (the ``infer.*`` endpoints);
    ``"spawn"`` runs the shared pool in a supervised child of its own on
    a fixed port, which acquires each version once. Either way the
    rollout children hold no policy and no CUDA context;
  * ``supervision.max_workers > 0`` arms the elastic autoscaler on the
    experience queue's depth, the slowest worker's policy lag and the
    inference tier's gauges;
  * ``rt.telemetry.sink`` (or ``REPRO_TRACE``) registers a
    :class:`~repro_torch.runtime.telemetry.TelemetrySink`, served through
    the server's ``metrics.snapshot``.
"""
from __future__ import annotations

import dataclasses
import os
import socket
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


class AcceRLSystem:
    def __init__(self, cfg: ModelConfig, rl: RLConfig, rt: RuntimeConfig, *,
                 suite: str = "spatial", segment_horizon: int = 8,
                 max_episode_steps: int = 30, batch_episodes: int = 8,
                 latency=None, transport=None, seed: int = 0,
                 collect_frames: bool = False,
                 remote_latency_ms=None, remote_latency_sigma: float = 1.0,
                 device="cuda"):
        self.device = resolve_device(device)
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
        tcfg = rt.transport
        self.transport_server = None
        self.supervisor = None
        self.journal = None
        self.remote_hosts: List = []
        self.inference_plane_host = None
        self.infer_address = None
        n_remote = tcfg.remote_rollout_workers + tcfg.connect_rollout_workers
        if n_remote > 0:
            # registered FIRST: the wire endpoint starts before any child
            # spawns and stops last, so shutdown stays cooperative
            from repro_torch.runtime.transport import TransportServer
            from repro_torch.runtime.transport.channel import parse_address
            host, port = tcfg.host, tcfg.port
            if tcfg.listen_addr:
                host, port = parse_address(tcfg.listen_addr)
            if tcfg.journal_dir:
                # resilient control plane: wrap the experience channel so
                # every accepted put / pop is write-ahead journaled, and
                # journal weight publishes through the store hook — BEFORE
                # the trainer and server capture channel references
                from repro_torch.runtime.transport import TransportJournal
                self.journal = TransportJournal(
                    tcfg.journal_dir,
                    compact_bytes=tcfg.journal_compact_bytes,
                    resume=tcfg.resume_journal)
                self.journal.attach_store(self.store)
                self.experience = self.journal.wrap("experience",
                                                    self.experience)
            self.transport_server = self.registry.register(TransportServer(
                host=host, port=port,
                shm_threshold=tcfg.shm_threshold_bytes, token=tcfg.token,
                journal=self.journal,
                weight_lane_bytes=tcfg.weight_lane_bytes))
            self.transport_server.add_channel("experience", self.experience)
            if self.frame_channel is not None:
                self.transport_server.add_channel("frames",
                                                  self.frame_channel)
            self.transport_server.set_store(self.store)
            if self.journal is not None and tcfg.resume_journal:
                # adopt the previous incarnation's state before anything
                # starts: channels refill, stream watermarks rebuild (so
                # redialing producers replay exactly-once), the newest
                # recovered weights republish onto this system's device
                self.transport_server.resume_from_journal(device=self.device)
        self.inference = self.registry.register(
            InferenceService(cfg, self.store, rt, seed=seed,
                             device=self.device))
        if (self.transport_server is not None
                and tcfg.inference_plane == "host"):
            # host mode: the parent's own pool serves remote workers'
            # action requests through the infer.* endpoints — continuous
            # batching across every local AND remote rollout worker
            from repro_torch.runtime.transport import InferenceBroker
            self.transport_server.set_inference(
                InferenceBroker(self.inference))
        if n_remote > 0:
            # registered before the trainer: the registry stops in
            # reverse, so the trainer (no more publishes) stops first,
            # then the supervisor waits for its children to exit while
            # the inference pool and the server still answer them
            self._add_remote_slots(n_remote, remote_latency_ms,
                                   remote_latency_sigma)
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
        # observability plane: a TelemetrySink samples the registry into
        # timestamped history (and serves metrics.snapshot when a
        # TransportServer is up). Armed by config or by the REPRO_TRACE
        # env so traced runs get the sink without extra flags; the
        # telemetry module import is deliberately lazy — untraced,
        # unsinked runs never load it.
        tel = rt.telemetry
        self.telemetry_sink = None
        if tel.sink or os.environ.get("REPRO_TRACE"):
            from repro_torch.runtime.telemetry import TelemetrySink
            self.telemetry_sink = self.registry.register(TelemetrySink(
                self.registry, interval_s=tel.sink_interval_s,
                history=tel.sink_history, path=tel.sink_path))
            if self.transport_server is not None:
                self.transport_server.snapshot_provider = \
                    self.telemetry_sink.sample

    # ----------------------------------------------------------- remote slots
    def _add_remote_slots(self, n_remote: int, latency_ms,
                          latency_sigma: float) -> None:
        """ONE Supervisor owns every non-local worker slot: spawned (child
        process) and connected (dialed in from another host) incarnations
        run the same worker body under the same RestartPolicy."""
        from repro_torch.runtime.transport import (RemoteWorkerSpec,
                                                   RestartPolicy, Supervisor)
        rt, tcfg = self.rt, self.rt.transport
        sup = tcfg.supervision
        policy = RestartPolicy(
            mode=sup.restart, max_restarts=sup.max_restarts,
            window_s=sup.window_s, backoff_initial_s=sup.backoff_initial_s,
            backoff_factor=sup.backoff_factor,
            backoff_max_s=sup.backoff_max_s)
        self.supervisor = self.registry.register(
            Supervisor(self.transport_server, policy))

        if tcfg.inference_plane == "spawn":
            # pre-allocate the tier's FIXED port so every restart
            # incarnation rebinds the same address (SO_REUSEADDR on the
            # server listener) and workers simply redial
            from repro_torch.runtime.transport.channel import parse_address
            infer_host, infer_port = "127.0.0.1", 0
            if tcfg.infer_listen_addr:
                infer_host, infer_port = parse_address(
                    tcfg.infer_listen_addr)
            if infer_port == 0:
                probe = socket.socket()
                probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                probe.bind((infer_host, 0))
                infer_port = probe.getsockname()[1]
                probe.close()
            self.infer_address = (infer_host, infer_port)

        def make_spec(name: str, idx: int) -> RemoteWorkerSpec:
            return RemoteWorkerSpec(
                name=name, cfg=self.cfg, rl=self.rl, rt=rt,
                address=self.transport_server.address,
                channel="experience",
                frame_channel=("frames" if self.frame_channel is not None
                               else None),
                suite=self.suite, segment_horizon=self.segment_horizon,
                max_episode_steps=self.max_episode_steps,
                num_envs=tcfg.envs_per_worker,
                seed=self.seed * 1000 + rt.num_rollout_workers + idx,
                use_shm=(tcfg.kind == "shm"),
                use_ring=(tcfg.kind == "ring"),
                ring_bytes=tcfg.ring_bytes,
                put_window=tcfg.put_window,
                adaptive_window=tcfg.adaptive_put_window,
                use_weight_lane=(tcfg.weight_lane_bytes > 0),
                shm_threshold=tcfg.shm_threshold_bytes,
                connect_timeout_s=tcfg.connect_timeout_s,
                latency_mean_ms=latency_ms, latency_sigma=latency_sigma,
                heartbeat_s=tcfg.heartbeat_s, token=tcfg.token,
                reconnect_attempts=tcfg.reconnect_attempts,
                reconnect_backoff_s=tcfg.reconnect_backoff_s,
                inference=("remote" if tcfg.inference_plane else "local"),
                infer_address=self.infer_address,
                device=str(self.device))

        if self.infer_address is not None:
            # the tier slot registers BEFORE rollout slots so it is
            # already coming up while they dial; kept out of remote_hosts
            # (it contributes no env steps to metrics())
            plane_spec = dataclasses.replace(
                make_spec("inference-plane", -1), kind="inference",
                infer_listen=self.infer_address)
            self.inference_plane_host = self.registry.register(
                self.supervisor.add_spawned(plane_spec))

        for i in range(tcfg.remote_rollout_workers):
            spec = make_spec(f"remote-rollout-{i}", i)
            self.remote_hosts.append(self.registry.register(
                self.supervisor.add_spawned(spec)))
        for i in range(tcfg.connect_rollout_workers):
            spec = make_spec(f"connect-rollout-{i}",
                             tcfg.remote_rollout_workers + i)
            self.remote_hosts.append(self.registry.register(
                self.supervisor.add_connected(
                    spec, liveness_timeout_s=sup.liveness_timeout_s,
                    liveness_heartbeats=sup.liveness_heartbeats,
                    liveness_floor_s=sup.liveness_floor_s)))
        if sup.max_workers > 0:
            self._enable_elastic(make_spec, n_remote)

    # --------------------------------------------------------------- elastic
    def _enable_elastic(self, make_spec, n_static: int) -> None:
        """Arm the supervisor's autoscaler with signals derived from
        state already on the bus: experience-queue depth fraction, the
        weight-version lag of the slowest live worker (the
        ``policy_version``/``weight_version`` gauges each report
        bridges), and the inference tier's pressure (its bridged gauges
        when the plane is spawned, the parent's pool otherwise)."""
        from repro_torch.runtime.transport import ElasticPolicy
        sup = self.rt.transport.supervision
        tcfg = self.rt.transport
        policy = ElasticPolicy(
            min_workers=sup.min_workers,
            max_workers=max(sup.max_workers, n_static),
            interval_s=sup.elastic_interval_s,
            scale_up_depth=sup.scale_up_depth,
            scale_down_depth=sup.scale_down_depth,
            staleness_cap=sup.staleness_cap,
            tier_queue_hot=sup.tier_queue_hot,
            tier_fill_hot=sup.tier_fill_hot,
            drain_timeout_s=sup.drain_timeout_s)

        def elastic_spec(seq: int):
            return make_spec(f"elastic-rollout-{seq}", n_static + seq)

        def elastic_signals() -> Dict[str, float]:
            depth_frac = (len(self.experience)
                          / max(self.rt.replay_capacity, 1))
            published = self.store.version()
            versions = []
            for slot in self.supervisor.slots:
                if slot.error is not None or slot.phase == "done":
                    continue
                g = slot.metrics.snapshot()["gauges"]
                v = g.get("policy_version", g.get("weight_version"))
                if v is not None:
                    versions.append(float(v))
            staleness = (published - min(versions)
                         if versions and published >= 0 else 0.0)
            # inference-tier pressure: prefer the disaggregated tier's
            # bridged gauges (spawn mode) over the parent's local pool
            src = (self.inference_plane_host.metrics
                   if self.inference_plane_host is not None
                   else self.inference.metrics)
            g = src.snapshot()["gauges"]
            return {"depth_frac": float(depth_frac),
                    "staleness": float(max(staleness, 0.0)),
                    "infer_queue_depth": float(g.get("queue_depth", 0.0)),
                    "infer_window_fill": float(g.get("window_fill", 0.0))}

        def register_slot(slot) -> None:
            # NOT on the ServiceRegistry: this runs on the supervision
            # thread mid-run and the registry dict is not thread-safe.
            # remote_hosts is enough — metrics aggregation reads it, and
            # supervisor.on_stop raises every slot's stop flag.
            slot.start()
            self.remote_hosts.append(slot)

        self.supervisor.enable_elastic(
            policy, elastic_spec, elastic_signals,
            mode=("connect" if (tcfg.connect_rollout_workers
                                and not tcfg.remote_rollout_workers)
                  else "spawn"),
            register=register_slot)

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
        if self.remote_hosts:
            raise RuntimeError(
                "the synchronous baseline is single-process: remote "
                "rollout workers (rt.transport.remote_rollout_workers / "
                "connect_rollout_workers) free-run and cannot join the "
                "step/episode barriers")
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
        registries; attachments extend it in place. Remote rollout hosts
        mirror their child's counters, so they aggregate exactly like
        local workers — the schema does not change with the topology."""
        rollouts = self.workers + self.remote_hosts
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
        if self.trainer.pipeline is not None:
            pipe = self.trainer.pipeline
            m["pipeline_rounds"] = pipe.rounds
            m["pipeline_bubble"] = dict(pipe.last_bubble)
            m["pipeline_peak_grad_bytes"] = pipe.peak_grad_bytes
        for attachment in self.attachments:
            attachment.extend_metrics(m, self)
        return m
