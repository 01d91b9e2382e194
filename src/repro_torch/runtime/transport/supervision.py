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

The reference's elastic autoscaler (``ElasticPolicy``,
``Supervisor.enable_elastic``) is not ported yet: ROADMAP A6b.
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

__all__ = ["RestartPolicy", "WorkerEndpoint", "SpawnedEndpoint",
           "ConnectedEndpoint", "SupervisedWorker", "Supervisor"]

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
        self.phase = "new"         # new|up|waiting|backoff|done
        self.relaunch_at = 0.0
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

    def enable_elastic(self, *args, **kwargs) -> None:
        """The reference arms its elastic autoscaler here."""
        raise NotImplementedError(
            "the elastic autoscaler is not ported yet: ROADMAP A6b")

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
            for slot in self.slots:
                self._step(slot, now)
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

    def on_stop(self) -> None:
        # raise every slot's cooperative stop flag even if the registry
        # stops the supervisor first — no slot may be relaunched past here
        for slot in self.slots:
            slot._stop_remote = True
