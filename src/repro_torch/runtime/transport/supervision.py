"""Supervision layer: worker LIFECYCLE decoupled from worker TRANSPORT, as
in the reference ``repro/runtime/transport/supervision.py``. It keeps two
orthogonal questions apart — *how a worker comes to exist* and *how it is
supervised*:

  * :class:`WorkerEndpoint` answers the first question for ONE incarnation
    of a worker. :class:`SpawnedEndpoint` is a ``spawn``-start-method
    child process (CUDA needs ``spawn``; liveness = the process object);
    :class:`ConnectedEndpoint` is the multi-host lifecycle (a worker
    started elsewhere — ``python -m repro_torch.launch.worker`` — dials the
    :class:`~repro_torch.runtime.transport.server.TransportServer`, authenticates
    with the shared token, and receives its spec; liveness = the heartbeat
    report stream).

  * :class:`Supervisor` answers the second. It is ONE service owning N
    :class:`SupervisedWorker` slots; its thread runs the shared state
    machine (launch → up → failure → backoff → relaunch | FAILED) under a
    declarative :class:`RestartPolicy`. ``never``: any failure marks the
    slot FAILED and schedulers fail fast;
    ``on_failure`` respawns (spawn mode) or re-opens the slot for a redial
    (connect mode) with exponential backoff, up to ``max_restarts`` within
    a sliding ``window_s`` — exhausting the budget surfaces FAILED with
    the same fail-fast behavior.

Each relaunch/re-accept begins a new *incarnation*: the slot's bridged
:class:`~repro_torch.runtime.service.MetricsRegistry` folds the dead
incarnation's counters into a monotone base (``begin_remote_incarnation``)
so ``metrics()["services"]`` keeps ONE coherent, monotonically-counting
entry per worker across restarts, and stale-incarnation reports are
dropped (and answered with ``stop``) rather than corrupting the bridge.

On top of the restart machine, an elastic autoscaler
(:class:`ElasticPolicy`, :meth:`Supervisor.enable_elastic`) adds and
drains worker slots from caller-supplied signals, as the reference's
does.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import threading
import time
from typing import Dict, List, Optional

from repro_torch.runtime.service import Service
from repro_torch.runtime.transport.remote import (RemoteWorkerSpec,
                                                  _child_entry, spec_to_wire)

__all__ = ["RestartPolicy", "ElasticPolicy", "WorkerEndpoint",
           "SpawnedEndpoint", "ConnectedEndpoint", "SupervisedWorker",
           "Supervisor"]

RESTART_MODES = ("never", "on_failure")


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Declarative restart semantics for a supervised worker slot.

    ``never`` — any failure is terminal . ``on_failure`` —
    up to ``max_restarts`` relaunches within a sliding ``window_s``;
    restarts outside the window stop counting against the budget, so a
    long-lived worker that crashes once a day never exhausts it. Backoff
    before the k-th restart in the window is
    ``backoff_initial_s * backoff_factor**(k-1)`` capped at
    ``backoff_max_s``."""

    mode: str = "never"
    max_restarts: int = 2
    window_s: float = 60.0
    backoff_initial_s: float = 0.1
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0

    def __post_init__(self):
        if self.mode not in RESTART_MODES:
            raise ValueError(f"restart mode {self.mode!r} not in "
                             f"{RESTART_MODES}")

    def backoff_s(self, restarts_in_window: int) -> float:
        return min(self.backoff_initial_s
                   * self.backoff_factor ** max(restarts_in_window - 1, 0),
                   self.backoff_max_s)


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Declarative autoscaling for the supervisor's worker fleet.

    Signals come from a caller-supplied ``signal_fn`` (the orchestrator
    derives them from state already in ``metrics()["services"]``):

      * ``depth_frac`` — experience-queue depth / capacity. Near 0 the
        trainer is starving (pops outrun puts): scale UP. Above
        ``scale_down_depth`` producers are outrunning the trainer and
        extra workers only feed the drop policy: scale DOWN.
      * ``staleness`` — published weight version minus the oldest policy
        version any live worker is acting on. Beyond ``staleness_cap``
        the fleet is too large for the publish cadence (more workers =
        more off-policy lag), so it also gates scale-up and forces
        scale-down.
      * ``infer_queue_depth`` / ``infer_window_fill`` — inference-tier
        pressure (the pool's own autoscaling gauges). A tier at/above
        ``tier_queue_hot`` requests or ``tier_fill_hot`` window fill is
        *saturated*: demand is outrunning serving capacity, so the
        autoscaler treats it as an additional scale-up trigger and never
        scales down while it persists (either threshold at 0 disables
        that signal).

    Scale-down never kills a worker mid-flight: the slot enters a
    ``draining`` phase — the stop flag rides the next report reply, the
    worker body stops its services and ``close()``s its channels (which
    flushes the PutStream window), and only when the endpoint observes
    the exit (or ``drain_timeout_s`` lapses) is the slot retired. A
    drained slot is NOT a failure: no restart budget is charged and no
    error is surfaced to schedulers."""

    min_workers: int = 1
    max_workers: int = 4
    interval_s: float = 2.0        # cooldown between scaling decisions
    scale_up_depth: float = 0.25   # depth_frac at/below → scale up
    scale_down_depth: float = 0.9  # depth_frac at/above → scale down
    staleness_cap: float = 0.0     # 0 = staleness signal unused
    tier_queue_hot: float = 0.0    # infer queue depth at/above → saturated
    tier_fill_hot: float = 0.0     # infer window fill at/above → saturated
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        if self.min_workers < 0 or self.max_workers < self.min_workers:
            raise ValueError(
                f"need 0 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")
        if not 0.0 <= self.scale_up_depth < self.scale_down_depth <= 1.0:
            raise ValueError(
                f"need 0 <= scale_up_depth < scale_down_depth <= 1, got "
                f"{self.scale_up_depth}/{self.scale_down_depth}")
        if self.tier_queue_hot < 0:
            raise ValueError(
                f"tier_queue_hot must be >= 0, got {self.tier_queue_hot}")
        if not 0.0 <= self.tier_fill_hot <= 1.0:
            raise ValueError(
                f"tier_fill_hot must be in [0, 1], got "
                f"{self.tier_fill_hot}")


# ---------------------------------------------------------------------------
# endpoints: how one incarnation of a worker comes to exist
# ---------------------------------------------------------------------------

class WorkerEndpoint:
    """One incarnation's existence + liveness. Stateless about policy —
    restarts, budgets, and backoff belong to the :class:`Supervisor`."""

    mode = "abstract"

    def launch(self, spec: RemoteWorkerSpec) -> None:
        """Begin an incarnation (spawn a child / open the slot for a
        dial-in)."""
        raise NotImplementedError

    def failure(self) -> Optional[str]:
        """Why the current incarnation is dead, or None while it lives
        (a connect slot still waiting inside its attach window is alive)."""
        raise NotImplementedError

    def note_report(self) -> None:
        """A heartbeat report from the current incarnation arrived."""

    def shutdown(self, timeout: float = 5.0) -> None:
        """Reap the incarnation if this side owns it (terminate → kill for
        a spawned child; nothing to do for a dialed-in peer — the stop
        flag in its report replies is the only lever)."""


class SpawnedEndpoint(WorkerEndpoint):
    """The worker is a ``spawn``-context child process of this host."""

    mode = "spawn"

    def __init__(self):
        self.process: Optional[multiprocessing.process.BaseProcess] = None

    def launch(self, spec: RemoteWorkerSpec) -> None:
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(target=_child_entry, args=(spec,),
                           name=spec.name, daemon=True)
        proc.start()
        self.process = proc              # only a started child is reaped

    def failure(self) -> Optional[str]:
        if self.process is None:
            return "never launched"
        if self.process.is_alive():
            return None
        return f"process died (exitcode={self.process.exitcode})"

    def shutdown(self, timeout: float = 5.0) -> None:
        proc = self.process
        if proc is None:
            return
        proc.join(timeout=timeout)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=2.0)
        if proc.is_alive():                # pragma: no cover — last resort
            proc.kill()
            proc.join(timeout=2.0)


class ConnectedEndpoint(WorkerEndpoint):
    """Multi-host lifecycle: the worker lives elsewhere and dials in.

    ``launch`` only opens the slot (arms the attach window); the
    :class:`Supervisor`'s hello handler calls :meth:`attach` when a worker
    completes the token handshake. Liveness afterwards is the heartbeat
    stream: a report gap beyond ``liveness_timeout_s`` is this lifecycle's
    equivalent of a dead process (the peer may be SIGKILLed, partitioned,
    or wedged — indistinguishable from here, all handled by re-accepting
    a redial under the restart budget)."""

    mode = "connect"

    def __init__(self, *, liveness_timeout_s: float,
                 attach_timeout_s: float):
        self.liveness_timeout_s = liveness_timeout_s
        self.attach_timeout_s = attach_timeout_s
        self.attached_incarnation: Optional[int] = None
        self.last_report_t: Optional[float] = None
        self._opened_t: Optional[float] = None

    def launch(self, spec: RemoteWorkerSpec) -> None:
        self._opened_t = time.monotonic()
        self.attached_incarnation = None
        self.last_report_t = None

    def attach(self, incarnation: int) -> None:
        self.attached_incarnation = incarnation
        self.last_report_t = time.monotonic()

    def note_report(self) -> None:
        self.last_report_t = time.monotonic()

    def failure(self) -> Optional[str]:
        now = time.monotonic()
        if self.attached_incarnation is None:
            if (self._opened_t is not None
                    and now - self._opened_t > self.attach_timeout_s):
                return (f"no worker dialed in within "
                        f"{self.attach_timeout_s:.1f}s")
            return None                    # still inside the attach window
        if (self.last_report_t is not None
                and now - self.last_report_t > self.liveness_timeout_s):
            return (f"report stream stalled for more than "
                    f"{self.liveness_timeout_s:.1f}s (worker died or "
                    f"partitioned)")
        return None


# ---------------------------------------------------------------------------
# the supervised slot: one bus entry per worker, stable across incarnations
# ---------------------------------------------------------------------------

class SupervisedWorker(Service):
    """Passive Service (no thread of its own): the per-worker entry on the
    bus. It carries the slot's identity (`name`), the bridged metrics
    registry, and the report sink across every incarnation the Supervisor
    runs through its endpoint — so ``metrics()["services"]`` shows a
    single coherent worker entry no matter how many times the underlying
    process was replaced."""

    def __init__(self, spec: RemoteWorkerSpec, endpoint: WorkerEndpoint,
                 server, *, role: str = "rollout"):
        super().__init__(spec.name, role=role)
        self.spec = spec
        self.endpoint = endpoint
        self.server = server
        server.register_worker_sink(spec.name, self)
        self.lock = threading.Lock()
        self.incarnation = 0               # 0 = nothing launched yet
        self.restarts = 0
        self.phase = "new"         # new|up|waiting|backoff|draining|done
        self.relaunch_at = 0.0
        # elastic bookkeeping: True for slots the autoscaler added (only
        # those are eligible for scale-down), drain_deadline bounds how
        # long a draining worker may take to flush and exit
        self.elastic = False
        self.drain_deadline = 0.0
        self.restart_times: List[float] = []
        self._stop_remote = False
        self._remote_error: Optional[str] = None
        self.reports_seen = 0
        self.remote_health: Dict = {}
        self.remote_services: Dict = {}

    def _thread_targets(self):
        return []                          # the Supervisor is the actor

    # -- report sink (called from a server connection thread) -----------------
    @property
    def stop_requested(self) -> bool:
        return self._stop_remote or self._stop.is_set()

    def stop_for(self, incarnation: int) -> bool:
        """Per-incarnation stop verdict for the report reply: superseded
        incarnations and exhausted slots are told to exit."""
        with self.lock:
            return (self.stop_requested or self.error is not None
                    or incarnation != self.incarnation)

    def apply_report(self, report: Dict, incarnation: int = 0) -> None:
        with self.lock:
            if incarnation != self.incarnation:
                return                     # stale incarnation — drop
            self.endpoint.note_report()
            if (self.phase == "waiting" and incarnation > 0
                    and getattr(self.endpoint, "attached_incarnation",
                                incarnation) is None):
                # the incarnation we presumed dead resumed reporting — it
                # was a stall, not a death: re-adopt it in place (the
                # restart the stall charged stays on the budget) instead
                # of stranding a live worker while the attach window
                # burns the rest of the budget
                self.endpoint.attach(incarnation)
                self.phase = "up"
            self.remote_health = report.get("health", {})
            self.remote_services = report.get("services", {})
            self.metrics.apply_remote(report.get("merged", {}))
            self.reports_seen += 1
            if not self.remote_health.get("healthy", True):
                self._remote_error = (self.remote_health.get("error")
                                      or "remote service failed")

    # -- lifecycle ------------------------------------------------------------
    def on_stop(self) -> None:
        self._stop_remote = True

    def join(self, timeout: float = 5.0) -> None:
        self.endpoint.shutdown(timeout=timeout)
        super().join(timeout=1.0)

    # -- the orchestrator's rollout-aggregation surface ------------------------
    @property
    def process(self):
        """The current incarnation's process (spawn mode; None otherwise)."""
        return getattr(self.endpoint, "process", None)

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
        s = self.metrics.snapshot()["series"].get("return")
        if not s or not s["count"]:
            return []
        # the child ships a count/mean summary; expanding it preserves the
        # count-weighted global mean the orchestrator computes
        return [s["mean"]] * int(s["count"])


# ---------------------------------------------------------------------------
# the supervisor: one state machine for every non-local worker
# ---------------------------------------------------------------------------

class Supervisor(Service):
    """Owns N supervised worker slots under one :class:`RestartPolicy`.

    The single supervision thread launches each slot's endpoint, watches
    its liveness (process for spawn, heartbeat stream for connect), and on
    failure either relaunches within the restart budget (new incarnation,
    metrics folded monotonically) or marks the slot FAILED so schedulers
    fail fast."""

    def __init__(self, server, policy: RestartPolicy, *,
                 name: str = "supervisor", poll_s: float = 0.02):
        super().__init__(name, role="supervision")
        self.server = server
        self.policy = policy
        self.poll_s = poll_s
        self.slots: List[SupervisedWorker] = []
        # elastic autoscaling (enable_elastic arms it)
        self.elastic: Optional[ElasticPolicy] = None
        self._spec_factory = None
        self._signal_fn = None
        self._elastic_mode = "spawn"
        self._register = None
        self._elastic_seq = 0
        self._last_scale_t = 0.0
        server.set_hello_handler(self.handle_hello)

    # -- slot construction ----------------------------------------------------
    def add_spawned(self, spec: RemoteWorkerSpec) -> SupervisedWorker:
        """A slot whose incarnations are child processes of this host."""
        slot = SupervisedWorker(spec, SpawnedEndpoint(), self.server)
        self.slots.append(slot)
        return slot

    def add_connected(self, spec: RemoteWorkerSpec, *,
                      liveness_timeout_s: float = 0.0,
                      liveness_heartbeats: float = 10.0,
                      liveness_floor_s: float = 2.0) -> SupervisedWorker:
        """A slot filled by a worker dialing in (``repro_torch.launch.worker``).
        ``liveness_timeout_s`` 0 = auto: ``liveness_heartbeats`` missed
        heartbeats, floored at ``liveness_floor_s`` (both flow from
        :class:`~repro_torch.configs.base.SupervisionConfig`, so deployments on
        jittery networks can widen the stall window without slowing the
        heartbeat itself)."""
        timeout = liveness_timeout_s or max(
            liveness_heartbeats * spec.heartbeat_s, liveness_floor_s)
        endpoint = ConnectedEndpoint(
            liveness_timeout_s=timeout,
            attach_timeout_s=spec.connect_timeout_s)
        slot = SupervisedWorker(spec, endpoint, self.server)
        self.slots.append(slot)
        return slot

    # -- elastic autoscaling ---------------------------------------------------
    def enable_elastic(self, policy: ElasticPolicy, spec_factory,
                       signal_fn, *, mode: str = "spawn",
                       register=None) -> None:
        """Arm the autoscaler. ``spec_factory(seq)`` builds the spec for a
        new elastic worker; ``signal_fn()`` returns the current signal
        dict (``depth_frac``, ``staleness`` — see
        :class:`ElasticPolicy`); ``register(slot)`` lets the caller put a
        freshly added slot on its service registry. ``mode`` picks the
        endpoint lifecycle for scale-ups (``spawn`` or ``connect``)."""
        if mode not in ("spawn", "connect"):
            raise ValueError(f"elastic mode {mode!r} not in "
                             f"('spawn', 'connect')")
        self.elastic = policy
        self._spec_factory = spec_factory
        self._signal_fn = signal_fn
        self._elastic_mode = mode
        self._register = register

    # -- the worker.hello responder (runs on a server connection thread) ------
    def handle_hello(self, header: Dict) -> Dict:
        """Assign the dialing worker a free connect slot (optionally the
        specific one it asked for) and ship its spec. The server has
        already verified the shared token."""
        want = header.get("worker")
        for slot in self.slots:
            if slot.endpoint.mode != "connect":
                continue
            if want and slot.name != want:
                continue
            assigned = self._try_attach(slot)
            if assigned is not None:
                return assigned
        detail = f" {want!r}" if want else ""
        return {"err": f"no open worker slot{detail} — every slot is "
                       f"live, failed, or stopping (redial after the "
                       f"liveness window if its worker just died)"}

    def _try_attach(self, slot: SupervisedWorker) -> Optional[Dict]:
        with slot.lock:
            endpoint = slot.endpoint
            if (slot.error is not None or slot.stop_requested
                    or slot.phase not in ("new", "waiting")):
                return None
            if endpoint.failure() is not None:
                # the attach window lapsed but the supervision thread has
                # not processed it yet — let it account for the failure
                # first so the budget stays exact
                return None
            slot.incarnation += 1
            if slot.incarnation > 1:
                slot.metrics.begin_remote_incarnation()
            slot._remote_error = None
            endpoint.attach(slot.incarnation)
            slot.phase = "up"
            spec = dataclasses.replace(slot.spec,
                                       incarnation=slot.incarnation)
            self.metrics.inc("attaches")
            return {"ok": True, "name": slot.name,
                    "incarnation": slot.incarnation,
                    "spec": spec_to_wire(spec)}

    # -- supervision state machine --------------------------------------------
    def _run(self) -> None:
        for slot in self.slots:
            with slot.lock:
                self._launch(slot)
        while not self._stop.is_set():
            now = time.monotonic()
            # list(): _elastic_step appends from this same thread
            for slot in list(self.slots):
                if slot.phase == "draining":
                    self._drain_step(slot, now)
                else:
                    self._step(slot, now)
            if self.elastic is not None:
                self._elastic_step(now)
            time.sleep(self.poll_s)

    def _launch(self, slot: SupervisedWorker) -> None:
        """Begin the next incarnation (caller holds ``slot.lock``)."""
        if slot.endpoint.mode == "spawn":
            slot.incarnation += 1
            if slot.incarnation > 1:
                slot.metrics.begin_remote_incarnation()
            slot._remote_error = None
            slot.endpoint.launch(dataclasses.replace(
                slot.spec, incarnation=slot.incarnation))
            slot.phase = "up"
        elif (slot.endpoint.attached_incarnation is None
              or slot.endpoint.failure() is not None):
            # connect mode: (re)open the slot; handle_hello does the
            # attach (launch drops any dead attachment)
            slot.endpoint.launch(slot.spec)
            slot.phase = "waiting"
        else:
            slot.phase = "up"      # a worker dialed in before this loop
                                   # first ran — keep the live attachment

    def _step(self, slot: SupervisedWorker, now: float) -> None:
        with slot.lock:
            if slot.error is not None or slot.phase == "done":
                return
            if slot.stop_requested:
                slot.phase = "done"
                return
            if slot.phase == "backoff":
                if (slot.endpoint.mode == "connect"
                        and slot.endpoint.attached_incarnation
                        == slot.incarnation
                        and slot.endpoint.failure() is None):
                    slot.phase = "up"      # the stalled worker's reports
                    return                 # resumed before the relaunch
                if now >= slot.relaunch_at:
                    self._launch(slot)
                return
            if slot._remote_error is not None:
                reason = (f"reported a failed service: "
                          f"{slot._remote_error}")
            else:
                reason = slot.endpoint.failure()
            if reason is None:
                return
            self._on_failure(slot, reason, now)

    def _on_failure(self, slot: SupervisedWorker, reason: str,
                    now: float) -> None:
        """Policy decision for a dead incarnation (caller holds the lock)."""
        self.metrics.inc("failures")
        slot._remote_error = None
        slot.endpoint.shutdown(timeout=0.2)   # reap a dead child quickly
        if self.policy.mode != "on_failure":
            self._fail(slot, reason)
            return
        slot.restart_times = [t for t in slot.restart_times
                              if now - t <= self.policy.window_s]
        if len(slot.restart_times) >= self.policy.max_restarts:
            self._fail(slot, f"restart budget exhausted "
                             f"({len(slot.restart_times)} restart(s) in "
                             f"{self.policy.window_s:.0f}s); last failure: "
                             f"{reason}")
            return
        slot.restart_times.append(now)
        slot.restarts += 1
        slot.metrics.inc("restarts")
        self.metrics.inc("restarts")
        delay = self.policy.backoff_s(len(slot.restart_times))
        slot.relaunch_at = now + delay
        slot.phase = "backoff"

    def _fail(self, slot: SupervisedWorker, reason: str) -> None:
        slot.phase = "done"
        slot.mark_failed(RuntimeError(
            f"remote worker {slot.name!r} {reason}"))

    # -- elastic steps (supervision thread only) ------------------------------
    def _elastic_step(self, now: float) -> None:
        pol = self.elastic
        if now - self._last_scale_t < pol.interval_s:
            return
        try:
            signals = dict(self._signal_fn() or {})
        except Exception:              # noqa: BLE001 — a flaky signal
            return                     # source must not kill supervision
        active = [s for s in self.slots
                  if s.error is None and s.phase != "done"]
        draining = any(s.phase == "draining" for s in active)
        n = len(active)
        depth = float(signals.get("depth_frac", 0.5))
        staleness = float(signals.get("staleness", 0.0))
        stale = pol.staleness_cap > 0 and staleness > pol.staleness_cap
        infer_depth = float(signals.get("infer_queue_depth", 0.0))
        infer_fill = float(signals.get("infer_window_fill", 0.0))
        # inference-tier pressure: a hot tier means demand is outrunning
        # serving capacity — an extra scale-up trigger that also pins the
        # fleet (no scale-down) while the pressure lasts
        saturated = ((pol.tier_queue_hot > 0
                      and infer_depth >= pol.tier_queue_hot)
                     or (pol.tier_fill_hot > 0
                         and infer_fill >= pol.tier_fill_hot))
        self.metrics.set_gauge("elastic_workers", float(n))
        self.metrics.set_gauge("elastic_depth_frac", depth)
        self.metrics.set_gauge("elastic_staleness", staleness)
        self.metrics.set_gauge("elastic_infer_queue_depth", infer_depth)
        self.metrics.set_gauge("elastic_infer_window_fill", infer_fill)
        self.metrics.set_gauge("elastic_tier_saturated", float(saturated))
        if draining:
            return                     # one transition at a time
        if (n < pol.max_workers and not stale
                and (depth <= pol.scale_up_depth or saturated)):
            self._scale_up()
            self._last_scale_t = now
        elif (n > pol.min_workers and not saturated
              and (depth >= pol.scale_down_depth or stale)):
            self._scale_down(now)
            self._last_scale_t = now

    def _elastic_add(self, spec: RemoteWorkerSpec) -> SupervisedWorker:
        """Build the slot for a scale-up (seam: tests override this to
        inject fake endpoints)."""
        if self._elastic_mode == "connect":
            return self.add_connected(spec)
        return self.add_spawned(spec)

    def _scale_up(self) -> None:
        self._elastic_seq += 1
        spec = self._spec_factory(self._elastic_seq)
        slot = self._elastic_add(spec)
        slot.elastic = True
        if self._register is not None:
            try:
                self._register(slot)
            except Exception:          # noqa: BLE001 — registry hiccup
                pass                   # must not kill supervision
        with slot.lock:
            self._launch(slot)
        self.metrics.inc("scale_ups")

    def _scale_down(self, now: float) -> None:
        """Begin draining the NEWEST live elastic slot (LIFO keeps the
        stable core fleet untouched). The worker is told to stop via its
        next report reply; it flushes its in-flight segments in close()
        and exits — _drain_step retires the slot when the exit lands."""
        for slot in reversed(self.slots):
            if not slot.elastic or slot.error is not None:
                continue
            if slot.phase not in ("up", "waiting"):
                continue
            with slot.lock:
                slot.phase = "draining"
                slot._stop_remote = True
                slot.drain_deadline = now + self.elastic.drain_timeout_s
            self.metrics.inc("scale_downs")
            return

    def _drain_step(self, slot: SupervisedWorker, now: float) -> None:
        """Retire a draining slot once its worker exited (or the drain
        deadline passed). Deliberately NOT a failure: no budget charge,
        no error — schedulers keep running."""
        with slot.lock:
            if slot.phase != "draining":
                return
            endpoint = slot.endpoint
            exited = (endpoint.failure() is not None
                      or (endpoint.mode == "connect"
                          and endpoint.attached_incarnation is None))
            if not exited and now < slot.drain_deadline:
                return
            endpoint.shutdown(timeout=1.0)
            slot.phase = "done"
        self.metrics.inc("drains_completed")

    #: how long ``on_stop`` waits for the spawned workers to exit (a
    #: straggler is reaped by its slot's ``join``)
    STOP_GRACE_S = 15.0

    def on_stop(self) -> None:
        # raise every slot's cooperative stop flag even if the registry
        # stops the supervisor first — no slot may be relaunched past here
        for slot in self.slots:
            slot._stop_remote = True
        # each spawned worker learns of the stop from its next report
        # reply; the orchestrator stops the supervisor after the trainer
        # and before the server and inference pool, so the workers' last
        # flushes, requests and reports are still answered while they exit
        deadline = time.monotonic() + self.STOP_GRACE_S
        for slot in list(self.slots):
            proc = slot.process
            if proc is not None:
                proc.join(timeout=max(deadline - time.monotonic(), 0.0))
