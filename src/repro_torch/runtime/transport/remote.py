"""Remote worker process body: ``worker_main`` + its picklable spec, as in
the reference ``repro/runtime/transport/remote.py``.

The paper's *physical isolation* claim means rollout/inference workers in
their own OS processes. This module is the CHILD side of that boundary —
a self-contained worker (local :class:`~repro_torch.runtime.inference.InferenceService`
pulling weights through a :class:`WeightStoreTransport`, plus N
:class:`~repro_torch.runtime.rollout.RolloutWorker` envs pushing segments
through a Socket/Shm channel) that heartbeats ``worker.report`` frames
back to the parent. How such a worker *comes to exist* and how it is
*supervised* live in :mod:`repro_torch.runtime.transport.supervision`:

  * a :class:`~repro_torch.runtime.transport.supervision.SpawnedEndpoint`
    runs ``worker_main`` in a ``spawn``-start-method child (CUDA cannot be
    used in a forked child);
  * a :class:`~repro_torch.runtime.transport.supervision.ConnectedEndpoint`
    waits for the SAME body to dial in from anywhere — the
    ``repro_torch.launch.worker`` CLI performs the ``worker.hello`` token
    handshake, receives its spec over the wire (``spec_from_wire``), and
    calls ``worker_main``. One worker body, two lifecycles.

Every heartbeat carries the worker's *incarnation* id, so a restarted
worker's reports are distinguishable from its dead predecessor's: the
parent slot drops stale-incarnation reports (idempotent bridging) and the
report *reply* tells a superseded incarnation to stop.

The port's child serves its own policy on ``spec.device`` (a field the
reference lacks: its child takes JAX's default device): the colocated
:class:`~repro_torch.runtime.inference.InferenceService` runs there and
every acquired version is decoded onto it. On the CPU each child keeps to
one torch thread. Each acquire's seconds land in the service's registry
(``weight_acquire_s`` histogram, ``weight_acquire_s_v<version>`` gauges),
and the launches of the serving kernels K1 and K2 in the child as the
counters ``launches.flash_attention`` and ``launches.decode_attention``,
which the report bridges to the parent. Not ported yet (ROADMAP A6b): the
``"inference"`` kind (the shared inference tier), ``inference="remote"``
and the child's trace spans.
"""
from __future__ import annotations

import dataclasses
import random
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs.base import (HybridConfig, ModelConfig, MoEConfig,
                                      RLConfig, RuntimeConfig, SSMConfig,
                                      SupervisionConfig, TelemetryConfig,
                                      TransportConfig)
from repro_torch.runtime.service import Service, _hist_merge
from repro_torch.runtime.transport.channel import (ChannelClosed, ShmChannel,
                                                   ShmRingChannel,
                                                   SocketChannel,
                                                   TransportError, WireClient)
from repro_torch.runtime.transport.weights import WeightStoreTransport

_A6B = "is not ported yet: ROADMAP A6b"

__all__ = ["RemoteWorkerSpec", "worker_main", "spec_to_wire",
           "spec_from_wire"]


@dataclasses.dataclass
class RemoteWorkerSpec:
    """Everything a remote worker needs — plain picklable data only (no
    callables: env latency travels as (mean_ms, sigma), not a closure).
    Also JSON-serializable via ``spec_to_wire`` so connect-mode workers
    can receive it over the ``worker.hello`` handshake."""

    name: str
    cfg: ModelConfig
    rl: RLConfig
    rt: RuntimeConfig
    address: Tuple[str, int]
    kind: str = "rollout"             # {"rollout", "inference"}
    channel: str = "experience"
    frame_channel: Optional[str] = None
    suite: str = "spatial"
    segment_horizon: int = 8
    max_episode_steps: int = 30
    num_envs: int = 1
    seed: int = 0
    use_shm: bool = False
    # streaming data plane: use_ring routes segments through persistent
    # SHM rings (ShmRingChannel); put_window > 0 pipelines flushes
    # through a windowed-ack PutStream (works with any channel kind)
    use_ring: bool = False
    ring_bytes: int = 8 << 20
    put_window: int = 0
    # adaptive streaming: the PutStream tunes its effective window / ack
    # cadence online from observed ack RTT; put_window stays the upper bound
    adaptive_window: bool = False
    # weight broadcast lane: the parent advertises blob positions in its
    # persistent lane ring and this worker reads them positionally
    # (same-host fan-out without per-acquire SHM segments)
    use_weight_lane: bool = False
    shm_threshold: int = 1 << 16
    connect_timeout_s: float = 20.0
    latency_mean_ms: Optional[float] = None
    latency_sigma: float = 1.0
    heartbeat_s: float = 0.25
    temperature: float = 1.0
    # supervision: which incarnation of its slot this worker is — echoed
    # in every report so the parent can drop stale reports and stop
    # superseded workers
    incarnation: int = 0
    token: str = ""
    # wire-client resilience: transparent redial budget after a
    # server-side connection drop (0 = fail fast)
    reconnect_attempts: int = 0
    reconnect_backoff_s: float = 0.1
    # -- disaggregated inference plane ---------------------------------------
    # rollout children: inference="remote" swaps the colocated
    # InferenceService for a RemoteInferenceClient dialing infer_address
    # (the parent server in host mode, the tier child in spawn mode).
    # kind="inference" children: infer_listen is the FIXED bind address of
    # the tier's own TransportServer — baked into the spec so a supervised
    # restart rebinds the same port and workers redial transparently.
    inference: str = "local"          # {"local", "remote"}
    infer_address: Optional[Tuple[str, int]] = None
    infer_listen: Optional[Tuple[str, int]] = None
    # the device the child serves on ("cuda", "cuda:1", "cpu")
    device: str = "cuda"


# ---------------------------------------------------------------------------
# spec <-> wire (the worker.hello reply carries the spec as plain JSON)
# ---------------------------------------------------------------------------

def spec_to_wire(spec: RemoteWorkerSpec) -> Dict:
    """Flatten a spec into JSON-safe nested dicts (tuples become lists on
    the wire; ``spec_from_wire`` restores them)."""
    return dataclasses.asdict(spec)


def spec_from_wire(wire: Dict) -> RemoteWorkerSpec:
    """Rebuild a :class:`RemoteWorkerSpec` from its wire dict."""
    d = dict(wire)
    cfg = dict(d["cfg"])
    for key, cls in (("moe", MoEConfig), ("ssm", SSMConfig),
                     ("hybrid", HybridConfig)):
        if cfg.get(key) is not None:
            cfg[key] = cls(**cfg[key])
    d["cfg"] = ModelConfig(**cfg)
    d["rl"] = RLConfig(**d["rl"])
    rt = dict(d["rt"])
    transport = dict(rt["transport"])
    transport["supervision"] = SupervisionConfig(**transport["supervision"])
    rt["transport"] = TransportConfig(**transport)
    if rt.get("telemetry") is not None:
        rt["telemetry"] = TelemetryConfig(**rt["telemetry"])
    rt["batch_buckets"] = tuple(rt["batch_buckets"])
    d["rt"] = RuntimeConfig(**rt)
    d["address"] = (str(d["address"][0]), int(d["address"][1]))
    for key in ("infer_address", "infer_listen"):
        if d.get(key) is not None:
            d[key] = (str(d[key][0]), int(d[key][1]))
    return RemoteWorkerSpec(**d)


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

def _merge_snapshots(snaps: List[Dict]) -> Dict:
    """Fold per-service snapshots into one: counters sum, gauges last-wins,
    series summaries combine count-weighted, histograms add bucketwise."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    series: Dict[str, Dict] = {}
    hists: Dict[str, Dict] = {}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + v
        gauges.update(snap.get("gauges", {}))
        for k, s in snap.get("series", {}).items():
            cur = series.setdefault(k, {"count": 0, "mean": 0.0,
                                        "last": 0.0})
            total = cur["count"] + s["count"]
            if s["count"]:
                cur["mean"] = (cur["mean"] * cur["count"]
                               + s["mean"] * s["count"]) / total
                cur["count"] = total
                cur["last"] = s["last"]
        for k, h in snap.get("hists", {}).items():
            hists[k] = _hist_merge(hists.get(k), h)
    return {"counters": counters, "gauges": gauges, "series": series,
            "hists": hists}


def _build_report(services: List[Service]) -> Dict:
    healthy = all(s.error is None for s in services)
    first_error = next((repr(s.error) for s in services
                        if s.error is not None), None)
    report = {
        "health": {"healthy": healthy,
                   "state": "failed" if not healthy else "running",
                   "error": first_error},
        "services": {s.name: {"health": s.health(),
                              "metrics": s.metrics.snapshot()}
                     for s in services},
        "merged": _merge_snapshots([s.metrics.snapshot()
                                    for s in services]),
    }
    return report


def _report_once(spec: RemoteWorkerSpec, control: WireClient,
                 services: List[Service],
                 before: Optional[Callable[[], None]] = None) -> Dict:
    if before is not None:
        before()
    report = _build_report(services)
    resp, _ = control.request({"m": "worker.report",
                               "worker": spec.name,
                               "incarnation": spec.incarnation,
                               "report": report})
    return {"report": report, "resp": resp}


def _heartbeat_loop(spec: RemoteWorkerSpec, control: WireClient,
                    services: List[Service],
                    before: Optional[Callable[[], None]] = None) -> int:
    """Shared child report loop (rollout and inference-tier children):
    heartbeat until the parent says stop, the wire dies, or a local
    service fails; ``before`` runs ahead of each report. Returns the exit
    code."""
    while True:
        try:
            got = _report_once(spec, control, services, before)
        except (TransportError, ChannelClosed):
            return 0                        # parent gone — shut down
        if got["resp"].get("stop"):
            return 0
        if not got["report"]["health"]["healthy"]:
            return 3                        # parent saw the report; die loud
        # ±25% jitter: N workers' heartbeats (and their redials after
        # a server replacement) decorrelate instead of arriving as
        # one synchronized burst per period
        time.sleep(spec.heartbeat_s * (0.75 + 0.5 * random.random()))


def worker_main(spec: RemoteWorkerSpec) -> int:
    """Remote-worker entry: build the service set, run it, report.

    ``spec.kind`` ``"rollout"``: env workers with a colocated inference
    pool on ``spec.device``. Returns the exit code (0 clean stop, 3
    internal service failure). Heavy imports live here, not at module
    scope — the parent never pays for them and the child initializes its
    own CUDA context.
    """
    if spec.kind == "inference":
        raise NotImplementedError(f"the inference-tier worker {_A6B}")
    if spec.inference == "remote":
        raise NotImplementedError(
            f"inference='remote' (the disaggregated inference plane) {_A6B}")
    import torch
    from repro_torch import resolve_device
    from repro_torch.envs.toy_manipulation import (TASKS_PER_SUITE,
                                                   lognormal_latency)
    from repro_torch.core.resampler import DynamicWeightedResampler
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.runtime.inference import InferenceService
    from repro_torch.runtime.rollout import RolloutWorker

    device = resolve_device(spec.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    wire_kw = dict(connect_timeout=spec.connect_timeout_s,
                   reconnect_attempts=spec.reconnect_attempts,
                   reconnect_backoff_s=spec.reconnect_backoff_s,
                   shm_threshold=spec.shm_threshold)
    if spec.use_ring:
        Channel = ShmRingChannel
        chan_kw = dict(wire_kw, ring_bytes=spec.ring_bytes,
                       put_window=(spec.put_window or 32),
                       adaptive_window=spec.adaptive_window)
    else:
        Channel = ShmChannel if spec.use_shm else SocketChannel
        chan_kw = dict(wire_kw, put_window=spec.put_window,
                       adaptive_window=spec.adaptive_window)
    experience = Channel(spec.address, spec.channel, **chan_kw)
    frames = (Channel(spec.address, spec.frame_channel, **chan_kw)
              if spec.frame_channel else None)
    control = WireClient(spec.address,
                         connect_timeout=spec.connect_timeout_s,
                         reconnect_attempts=spec.reconnect_attempts,
                         reconnect_backoff_s=spec.reconnect_backoff_s)

    # the weight wire either rides the per-message SHM path or (with
    # use_weight_lane) reads blobs positionally out of the parent's
    # persistent broadcast lane ring — one publish serves N same-host
    # readers with zero per-acquire segment churn
    store = WeightStoreTransport(
        spec.address, use_shm=spec.use_shm or spec.use_ring,
        shm_threshold=spec.shm_threshold,
        connect_timeout=spec.connect_timeout_s,
        reconnect_attempts=spec.reconnect_attempts,
        reconnect_backoff_s=spec.reconnect_backoff_s,
        use_lane=spec.use_weight_lane, device=device)
    inference = InferenceService(spec.cfg, store, spec.rt,
                                 temperature=spec.temperature,
                                 seed=spec.seed, device=device)
    store.metrics = inference.metrics

    latency = (lognormal_latency(spec.latency_mean_ms,
                                 sigma=spec.latency_sigma, seed=spec.seed)
               if spec.latency_mean_ms else None)
    # task selection is resampled locally per child — each process keeps
    # its own success history (no cross-process resampler sync)
    resampler = DynamicWeightedResampler(TASKS_PER_SUITE, seed=spec.seed)
    workers = [
        RolloutWorker(i, spec.cfg, inference, experience, suite=spec.suite,
                      resampler=resampler,
                      segment_horizon=spec.segment_horizon,
                      max_steps=spec.max_episode_steps, latency=latency,
                      seed=spec.seed * 1000 + i, frame_channel=frames)
        for i in range(spec.num_envs)
    ]
    services: List[Service] = [inference] + list(workers)

    # the serving kernels' launches (K1 prefill, K2 decode) counted in
    # this process: zeroed here and mirrored into the inference service's
    # counters ``launches.<wrapper>`` ahead of every report, so the
    # parent reads what this child launched
    kernels = {"flash_attention": flash_attention,
               "decode_attention": decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    mirrored = dict.fromkeys(kernels, 0)

    def mirror_launches() -> None:
        for name, fn in kernels.items():
            n = fn.launches
            inference.metrics.inc(f"launches.{name}", n - mirrored[name])
            mirrored[name] = n

    for s in services:
        s.start()

    try:
        exit_code = _heartbeat_loop(spec, control, services,
                                    mirror_launches)
    finally:
        for s in reversed(services):
            s.stop()
        for s in services:
            s.join(timeout=5.0)
        try:                                # best-effort final numbers
            _report_once(spec, control, services, mirror_launches)
        except (TransportError, ChannelClosed):
            pass
        for closable in (experience, frames, store, control):
            if closable is not None:
                closable.close()
    return exit_code


def _child_entry(spec: RemoteWorkerSpec) -> None:
    sys.exit(worker_main(spec))
