"""Service layer: the uniform lifecycle every runtime component implements.

The async pipeline (paper §3) is a set of free-running components — rollout
workers, the inference pool, trainer loops, imagination workers, world-model
trainers. Before this layer each of them hand-rolled its own
``threading.Thread`` + stop-event + ad-hoc counters; the orchestrator had to
know every component's private start/stop dance, and the synchronous
baseline re-implemented the whole loop inline.

:class:`Service` gives all of them one contract:

  * ``start() / stop() / join()`` with an explicit :class:`ServiceState`
    machine (``stop`` is a signal, ``join`` the rendezvous — schedulers own
    the ordering);
  * crash containment — a thread that raises marks the service ``FAILED``
    and records the exception instead of dying silently;
  * a per-service :class:`MetricsRegistry` (counters / gauges / series /
    busy-timers) that ``AcceRLSystem.metrics()`` is rebuilt on, so every
    benchmark and launcher consumes one schema.

:class:`ServiceRegistry` is the bus the orchestrator and schedulers drive:
services register in dependency order, start in that order, stop in
reverse. World-model attachment (paper §4 "plug-and-play") is literally
``system.attach(...)`` registering more services on this bus.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
import traceback
from typing import Callable, Dict, Iterable, List, Optional


class ServiceState:
    """String states — cheap to compare, JSON-friendly in health reports."""

    NEW = "new"
    RUNNING = "running"
    STOPPING = "stopping"
    STOPPED = "stopped"
    FAILED = "failed"


#: recent-value window kept per series (``record``); the exact all-time
#: count/total ride alongside, so ``series_mean`` covers every observation
#: while memory stays O(window) over arbitrarily long runs
SERIES_WINDOW = 512

#: log2 histogram layout: bucket 0 holds v < 2^HIST_MIN_EXP (and v <= 0),
#: bucket i holds [2^(HIST_MIN_EXP+i-1), 2^(HIST_MIN_EXP+i)), the top
#: bucket is open-ended. 46 buckets span ~1 µs to ~16e6 — seconds-scale
#: latencies and version/count-scale lags share one fixed layout, which is
#: what makes histograms from different incarnations mergeable bucketwise.
HIST_MIN_EXP = -20
HIST_BUCKETS = 46


def _hist_bucket(value: float) -> int:
    if value <= 0.0 or value < 2.0 ** HIST_MIN_EXP:
        return 0
    idx = int(math.floor(math.log2(value))) - HIST_MIN_EXP + 1
    return max(0, min(idx, HIST_BUCKETS - 1))


def _hist_copy(h: Dict) -> Dict:
    out = dict(h)
    out["buckets"] = {str(k): int(v) for k, v in h.get("buckets",
                                                       {}).items()}
    return out


def _hist_merge(a: Optional[Dict], b: Optional[Dict]) -> Dict:
    """Bucketwise sum of two histogram summaries (either may be None).
    Pure addition — the merge is associative and commutative, so folds
    across incarnations and across services cannot double-count."""
    if not a:
        return _hist_copy(b or {"count": 0, "sum": 0.0, "min": 0.0,
                                "max": 0.0, "buckets": {}})
    if not b:
        return _hist_copy(a)
    out = _hist_copy(a)
    out["count"] = int(a.get("count", 0)) + int(b.get("count", 0))
    out["sum"] = float(a.get("sum", 0.0)) + float(b.get("sum", 0.0))
    out["min"] = min(a.get("min", b.get("min", 0.0)), b.get("min", 0.0))
    out["max"] = max(a.get("max", b.get("max", 0.0)), b.get("max", 0.0))
    for k, v in b.get("buckets", {}).items():
        k = str(k)
        out["buckets"][k] = out["buckets"].get(k, 0) + int(v)
    return out


class _SeriesStore:
    """Bounded series storage: exact cumulative count/total plus a recent
    window — ``series_mean`` stays the mean over ALL observations while a
    week-long run no longer grows a per-observation list."""

    __slots__ = ("count", "total", "window")

    def __init__(self, window: int = SERIES_WINDOW):
        self.count = 0
        self.total = 0.0
        self.window: "collections.deque[float]" = collections.deque(
            maxlen=window)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.window.append(value)


class MetricsRegistry:
    """Thread-safe counters, gauges, scalar series and histograms for one
    service.

    Counters are monotone floats (``inc``); gauges are last-write-wins;
    series accumulate observations (episode returns, policy lag) into a
    bounded window + exact running mean and snapshot as count/mean/last;
    histograms (``observe``) bucket observations into a fixed log2 layout
    so distributions (queue waits, batch ages, policy lag) survive the
    wire and merge across worker incarnations without double-counting.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._series: Dict[str, _SeriesStore] = {}
        self._hists: Dict[str, Dict] = {}
        # cross-process bridge: counters/gauges/series/hists adopted from a
        # remote replica (a supervised worker slot mirrors its child
        # through these). Counters are split into the CURRENT incarnation's
        # absolute values plus a base folded in at each restart
        # (``begin_remote_incarnation``), so a worker that restarts and
        # re-reports from zero aggregates monotonically instead of
        # rewinding or double-counting.
        self._remote_counters: Dict[str, float] = {}
        self._remote_counter_base: Dict[str, float] = {}
        self._remote_gauges: Dict[str, float] = {}
        self._remote_series: Dict[str, Dict] = {}
        self._remote_series_base: Dict[str, Dict] = {}
        self._remote_hists: Dict[str, Dict] = {}
        self._remote_hist_base: Dict[str, Dict] = {}

    # -- counters -----------------------------------------------------------
    def inc(self, key: str, by: float = 1.0) -> float:
        with self._lock:
            val = self._counters.get(key, 0.0) + by
            self._counters[key] = val
            return val

    def counter(self, key: str, default: float = 0.0) -> float:
        with self._lock:
            if (key not in self._counters
                    and key not in self._remote_counters
                    and key not in self._remote_counter_base):
                return default
            return (self._counters.get(key, 0.0)
                    + self._remote_counter_base.get(key, 0.0)
                    + self._remote_counters.get(key, 0.0))

    # -- gauges -------------------------------------------------------------
    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = float(value)

    def gauge(self, key: str, default: float = 0.0) -> float:
        with self._lock:
            if key in self._remote_gauges:
                return self._remote_gauges[key]
            return self._gauges.get(key, default)

    # -- series -------------------------------------------------------------
    def record(self, key: str, value: float) -> None:
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _SeriesStore()
            s.add(float(value))

    def series(self, key: str) -> List[float]:
        """The recent window of observations (newest last) — bounded at
        ``SERIES_WINDOW``; use ``series_mean``/``snapshot`` for all-time
        aggregates."""
        with self._lock:
            s = self._series.get(key)
            return list(s.window) if s is not None else []

    def series_mean(self, key: str, default: float = 0.0) -> float:
        with self._lock:
            s = self._series.get(key)
            if s is not None and s.count:
                return s.total / s.count
            remote = self._merged_remote_series().get(key)
            return remote["mean"] if remote else default

    # -- histograms ---------------------------------------------------------
    def observe(self, key: str, value: float) -> None:
        """Add one observation to the fixed log2-bucket histogram ``key``
        (see ``HIST_MIN_EXP``/``HIST_BUCKETS``). Bucket keys are strings
        so summaries survive JSON framing and the journal unchanged."""
        value = float(value)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = {"count": 0, "sum": 0.0,
                                        "min": value, "max": value,
                                        "buckets": {}}
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            b = str(_hist_bucket(value))
            h["buckets"][b] = h["buckets"].get(b, 0) + 1

    def hist(self, key: str, default: Optional[Dict] = None
             ) -> Optional[Dict]:
        """Merged histogram summary (local + every remote incarnation):
        ``{"count", "sum", "min", "max", "buckets": {str(idx): n}}``."""
        with self._lock:
            out = self._merged_remote_hists().get(key)
            local = self._hists.get(key)
            if local:
                out = _hist_merge(out, local)
            return out if out else default

    # -- cross-process bridging ---------------------------------------------
    def apply_remote(self, snapshot: Dict) -> None:
        """Adopt a snapshot reported by a remote (cross-process) replica:
        the remote is the source of truth for its counters/gauges, and
        series arrive pre-summarized (count/mean/last), feeding
        ``snapshot()`` / ``series_mean()``.

        Re-applying the same snapshot is idempotent (absolute values, not
        deltas); counters from a NEW incarnation of the worker must be
        preceded by :meth:`begin_remote_incarnation` so the previous
        incarnation's totals fold into a base instead of being rewound."""
        with self._lock:
            for k, v in snapshot.get("counters", {}).items():
                self._remote_counters[k] = float(v)
            for k, v in snapshot.get("gauges", {}).items():
                self._remote_gauges[k] = float(v)
            self._remote_series = {k: dict(v) for k, v in
                                   snapshot.get("series", {}).items()}
            self._remote_hists = {k: _hist_copy(v) for k, v in
                                  snapshot.get("hists", {}).items()}

    def begin_remote_incarnation(self) -> None:
        """A supervised worker is being restarted: fold the dead
        incarnation's counters/series into the monotone base (so totals
        never rewind or double-count when the replacement re-reports from
        zero) and reset its gauges (a gauge describes the live process —
        there is none until the replacement reports)."""
        with self._lock:
            for k, v in self._remote_counters.items():
                self._remote_counter_base[k] = (
                    self._remote_counter_base.get(k, 0.0) + v)
            self._remote_counters = {}
            self._remote_gauges = {}
            self._remote_series_base = self._merged_remote_series()
            self._remote_series = {}
            self._remote_hist_base = self._merged_remote_hists()
            self._remote_hists = {}

    def _merged_remote_series(self) -> Dict[str, Dict]:
        """Count-weighted fold of the base (dead incarnations) and current
        series summaries. Caller holds the lock."""
        merged = {k: dict(v) for k, v in self._remote_series_base.items()}
        for k, cur in self._remote_series.items():
            base = merged.get(k)
            if base is None or not base["count"]:
                merged[k] = dict(cur)
                continue
            total = base["count"] + cur["count"]
            if cur["count"]:
                merged[k] = {
                    "count": total,
                    "mean": (base["mean"] * base["count"]
                             + cur["mean"] * cur["count"]) / total,
                    "last": cur["last"],
                }
        return merged

    def _merged_remote_hists(self) -> Dict[str, Dict]:
        """Bucketwise fold of the base (dead incarnations) and current
        remote histograms. Caller holds the lock."""
        merged = {k: _hist_copy(v) for k, v in
                  self._remote_hist_base.items()}
        for k, cur in self._remote_hists.items():
            merged[k] = _hist_merge(merged.get(k), cur)
        return merged

    # -- timers -------------------------------------------------------------
    @contextlib.contextmanager
    def timer(self, key: str):
        """Accumulate elapsed wall seconds into counter ``key``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.inc(key, time.monotonic() - t0)

    def snapshot(self) -> Dict:
        with self._lock:
            series = self._merged_remote_series()
            series.update({
                k: {"count": s.count,
                    "mean": (s.total / s.count) if s.count else 0.0,
                    "last": s.window[-1] if s.window else 0.0}
                for k, s in self._series.items()
            })
            hists = self._merged_remote_hists()
            for k, h in self._hists.items():
                hists[k] = _hist_merge(hists.get(k), h)
            counters = dict(self._counters)
            for k in set(self._remote_counters) | set(
                    self._remote_counter_base):
                counters[k] = (counters.get(k, 0.0)
                               + self._remote_counter_base.get(k, 0.0)
                               + self._remote_counters.get(k, 0.0))
            return {
                "counters": counters,
                "gauges": {**self._gauges, **self._remote_gauges},
                "series": series,
                "hists": hists,
            }


class RolloutGate:
    """Pacing hook a scheduler hands to rollout-style producer loops.

    The free-running (async) pipeline uses :class:`NullGate`; the
    synchronous baseline's barrier gate
    implements the paper's step/episode barriers behind the same calls, so
    the producer loop itself is identical in both modes.
    """

    def begin_episode(self, stop: threading.Event) -> bool:
        """Block until an episode may start; False means shutting down."""
        raise NotImplementedError

    def before_step(self, stop: threading.Event) -> None:
        """Called before every env step (sync mode: the step barrier)."""
        raise NotImplementedError

    def end_episode(self) -> None:
        """Called exactly once per ``begin_episode`` that returned True."""
        raise NotImplementedError


class NullGate(RolloutGate):
    """Free-running: never blocks (the fully asynchronous mode)."""

    def begin_episode(self, stop: threading.Event) -> bool:
        return not stop.is_set()

    def before_step(self, stop: threading.Event) -> None:
        pass

    def end_episode(self) -> None:
        pass


NULL_GATE = NullGate()


class Service:
    """Base class for every runtime component (rollout, inference, trainer,
    imagination, WM trainers). Subclasses implement ``_run`` (or override
    ``_thread_targets`` for multi-threaded pools) plus optional
    ``on_start`` / ``on_stop`` hooks."""

    def __init__(self, name: str, *, role: str = "service"):
        self.name = name
        self.role = role
        self.metrics = MetricsRegistry(name)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._state = ServiceState.NEW
        self._state_lock = threading.Lock()
        self.error: Optional[BaseException] = None
        #: structured record of the crash that FAILED this service (None
        #: while healthy): service/incarnation/timestamps/traceback —
        #: surfaced through ``health()`` and the telemetry sink instead of
        #: living only on a stderr nobody captured
        self.crash: Optional[Dict] = None
        self.started_at: Optional[float] = None

    # -- subclass surface ---------------------------------------------------
    def _run(self) -> None:
        raise NotImplementedError

    def _thread_targets(self) -> List[Callable[[], None]]:
        return [self._run]

    def on_start(self) -> None:
        """Hook run before threads spawn (publish weights, start helpers)."""

    def on_stop(self) -> None:
        """Hook run when stop is signalled (stop helpers)."""

    # -- lifecycle ----------------------------------------------------------
    @property
    def status(self) -> str:
        with self._state_lock:
            return self._state

    def _set_state(self, state: str) -> None:
        with self._state_lock:
            # FAILED is terminal — a crashed thread must stay visible
            if self._state != ServiceState.FAILED:
                self._state = state

    def start(self) -> "Service":
        if self.status != ServiceState.NEW:
            raise RuntimeError(
                f"service {self.name!r} already started (state={self.status})")
        self.started_at = time.monotonic()
        self.on_start()
        for i, target in enumerate(self._thread_targets()):
            t = threading.Thread(target=self._guard, args=(target,),
                                 daemon=True, name=f"{self.name}-{i}"
                                 if i else self.name)
            t.start()
            self._threads.append(t)
        self._set_state(ServiceState.RUNNING)
        return self

    def _crash_record(self, error: BaseException,
                      tb: Optional[str] = None) -> Dict:
        return {
            "service": self.name,
            "incarnation": int(getattr(self, "incarnation", 0)),
            "t_mono": time.monotonic(),
            "time": time.time(),
            "thread": threading.current_thread().name,
            "error": repr(error),
            "traceback": tb if tb is not None else "".join(
                traceback.format_exception(type(error), error,
                                           error.__traceback__)),
        }

    def _guard(self, target: Callable[[], None]) -> None:
        try:
            target()
        except BaseException as e:   # noqa: BLE001 — surface crashes as health
            self.error = e
            self.crash = self._crash_record(e, traceback.format_exc())
            with self._state_lock:
                self._state = ServiceState.FAILED
            traceback.print_exc()    # stderr stays useful for foreground runs

    def mark_failed(self, error: BaseException) -> None:
        """Mark this service FAILED from outside its own threads — how a
        supervisor surfaces a failure that happened in another process
        (or on the wire) with the exact semantics of a local crash."""
        self.error = error
        self.crash = self._crash_record(error)
        with self._state_lock:
            self._state = ServiceState.FAILED

    def stop(self) -> None:
        """Signal shutdown (non-blocking; pair with ``join``)."""
        if self.status == ServiceState.NEW:
            self._set_state(ServiceState.STOPPED)
            return
        self._stop.set()
        self._set_state(ServiceState.STOPPING)
        self.on_stop()

    def join(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        if self.status == ServiceState.STOPPING and not any(
                t.is_alive() for t in self._threads):
            self._set_state(ServiceState.STOPPED)

    # -- health + metrics ---------------------------------------------------
    @property
    def healthy(self) -> bool:
        return self.error is None and self.status in (ServiceState.NEW,
                                                     ServiceState.RUNNING,
                                                     ServiceState.STOPPING,
                                                     ServiceState.STOPPED)

    def health(self) -> Dict:
        return {"state": self.status, "healthy": self.healthy,
                "uptime_s": self.uptime_s,
                "error": repr(self.error) if self.error else None,
                "crash": self.crash}

    @property
    def uptime_s(self) -> float:
        if self.started_at is None:
            return 0.0
        return time.monotonic() - self.started_at

    def utilization(self) -> float:
        """busy_s / uptime — services time hot sections into ``busy_s``."""
        if self.started_at is None:
            return 0.0
        return self.metrics.counter("busy_s") / max(self.uptime_s, 1e-9)


class ServiceRegistry:
    """Ordered service bus: register in dependency order, start in that
    order, stop in reverse. The orchestrator owns one; attachments (the
    world model) register additional services on it."""

    def __init__(self):
        self._services: Dict[str, Service] = {}

    def register(self, service: Service) -> Service:
        if service.name in self._services:
            raise ValueError(f"duplicate service name {service.name!r}")
        self._services[service.name] = service
        return service

    def deregister(self, name: str) -> Optional[Service]:
        return self._services.pop(name, None)

    def get(self, name: str) -> Service:
        return self._services[name]

    def __contains__(self, name: str) -> bool:
        return name in self._services

    def all(self, *, role: Optional[str] = None,
            exclude_roles: Iterable[str] = ()) -> List[Service]:
        ex = set(exclude_roles)
        return [s for s in self._services.values()
                if (role is None or s.role == role) and s.role not in ex]

    # -- bulk lifecycle -----------------------------------------------------
    def start_all(self, *, exclude_roles: Iterable[str] = ()) -> None:
        for s in self.all(exclude_roles=exclude_roles):
            s.start()

    def stop_all(self) -> None:
        for s in reversed(list(self._services.values())):
            s.stop()

    def join_all(self, timeout: float = 5.0) -> None:
        for s in reversed(list(self._services.values())):
            s.join(timeout=timeout)

    # -- reporting ----------------------------------------------------------
    def health(self) -> Dict[str, Dict]:
        return {name: s.health() for name, s in self._services.items()}

    def snapshot(self) -> Dict[str, Dict]:
        return {name: s.metrics.snapshot()
                for name, s in self._services.items()}
