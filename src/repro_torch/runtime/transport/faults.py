"""FaultPlan: deterministic fault injection for the transport layer, as in
the reference ``repro/runtime/transport/faults.py`` (the same grammar, and
the same decisions for the same spec and seed).

Chaos tests must *prove* the recovery invariants (journal replay is
exactly-once, workers redial, torn ring tails are discarded) rather than
hope a wall-clock race hits the window. This module injects faults at
named points in the server/client hot paths, at deterministic hit counts,
configured entirely through one environment variable:

    REPRO_FAULTS="kill@server.stream_applied:nth=40;delay@server.frame:every=8,ms=20"

Grammar — ``;``-separated directives, each ``kind@point[:k=v[,k=v...]]``:

  ==========  =============================================================
  ``reset``   raise :class:`InjectedReset` (a ``ConnectionResetError``):
              the surrounding connection handler treats it as the peer
              vanishing — exercises redial/replay paths
  ``delay``   sleep ``ms`` milliseconds (default 50): delayed acks,
              heartbeat jitter, slow-consumer windows
  ``torn``    raise :class:`InjectedTorn` (a
              :class:`~repro_torch.runtime.transport.ring.RingError`): at the
              ring commit point this leaves a reserved-but-uncommitted
              record — the torn tail :meth:`ShmRing.recover` discards
  ``kill``    ``SIGKILL`` the current process — the real crash the
              journal/resume machinery exists for
  ==========  =============================================================

Trigger args: ``nth=K`` fires on exactly the K-th hit of the point (once);
``every=N`` fires on every N-th hit; ``prob=P`` fires each hit with
probability P from a per-point deterministic stream (``seed=S``, default
0 — same spec, same decisions, every run). Default with no args: every
hit.

**Inertness.** Hot modules gate the import itself::

    if os.environ.get("REPRO_FAULTS"):
        from repro_torch.runtime.transport.faults import fault_point as _fault
    else:
        _fault = None

so with the gate off this module is never imported (tests assert it is
absent from ``sys.modules``) and every fault site costs one ``is None``
check.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional

from repro_torch.runtime.transport.ring import RingError

__all__ = ["FaultError", "InjectedReset", "InjectedTorn", "FaultRule",
           "FaultPlan", "fault_point", "reset_plan"]

ENV_VAR = "REPRO_FAULTS"
KINDS = ("reset", "delay", "torn", "kill")


class FaultError(RuntimeError):
    """Base for injected faults (never raised itself)."""


class InjectedReset(ConnectionResetError):
    """Injected connection reset — caught by every ``OSError`` handler
    on the transport data path, exactly like a real peer death."""


class InjectedTorn(RingError):
    """Injected ring failure — raised BEFORE the commit-offset store, so
    the reserved record stays uncommitted (a torn write)."""


class FaultRule:
    """One parsed directive: a kind, a point, and a trigger."""

    __slots__ = ("kind", "point", "nth", "every", "prob", "delay_ms",
                 "_rng", "fired")

    def __init__(self, kind: str, point: str, args: Dict[str, str],
                 seed: int):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (not in {KINDS})")
        self.kind = kind
        self.point = point
        self.nth = int(args["nth"]) if "nth" in args else 0
        self.every = int(args["every"]) if "every" in args else 0
        self.prob = float(args["prob"]) if "prob" in args else 0.0
        self.delay_ms = float(args.get("ms", 50.0))
        # per-rule deterministic stream: same spec -> same decisions
        self._rng = random.Random(f"{seed}:{kind}@{point}")
        self.fired = 0

    def should_fire(self, hit: int) -> bool:
        if self.nth:
            return hit == self.nth
        if self.every:
            return hit % self.every == 0
        if self.prob:
            return self._rng.random() < self.prob
        return True


def _parse(spec: str, *, seed: int = 0) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for directive in spec.split(";"):
        directive = directive.strip()
        if not directive:
            continue
        head, _, argstr = directive.partition(":")
        kind, sep, point = head.partition("@")
        if not sep or not point:
            raise ValueError(f"bad fault directive {directive!r} "
                             f"(want kind@point[:k=v,...])")
        args: Dict[str, str] = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"bad fault arg {kv!r} in {directive!r}")
            args[k.strip()] = v.strip()
        rules.append(FaultRule(kind.strip(), point.strip(), args,
                               int(args.get("seed", seed))))
    return rules


class FaultPlan:
    """The parsed plan: per-point hit counters + the rules they trigger."""

    def __init__(self, rules: List[FaultRule]):
        self._rules: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self._rules.setdefault(r.point, []).append(r)
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        return cls(_parse(spec, seed=seed))

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls.from_spec(os.environ.get(ENV_VAR, ""))

    def hit(self, point: str) -> None:
        """Register one pass through ``point``; fire any matching rule."""
        with self._lock:
            hit = self._hits[point] = self._hits.get(point, 0) + 1
            rules = self._rules.get(point, ())
            fire = [r for r in rules if r.should_fire(hit)]
            for r in fire:
                r.fired += 1
        for r in fire:
            self._execute(r)

    def _execute(self, rule: FaultRule) -> None:
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1e3)
        elif rule.kind == "reset":
            raise InjectedReset(
                f"injected reset at {rule.point} (hit "
                f"{self._hits.get(rule.point)})")
        elif rule.kind == "torn":
            raise InjectedTorn(f"injected torn write at {rule.point}")
        elif rule.kind == "kill":          # pragma: no cover — kills us
            os.kill(os.getpid(), signal.SIGKILL)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Hit/fire counts per point (test observability)."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for point, hits in self._hits.items():
                out[point] = {"hits": hits,
                              "fired": sum(r.fired for r in
                                           self._rules.get(point, ()))}
            for point, rules in self._rules.items():
                out.setdefault(point, {"hits": 0, "fired": 0})
            return out


_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def fault_point(point: str) -> None:
    """The module-level injection hook the gated hot paths call. Builds
    the plan from :data:`ENV_VAR` on first use."""
    global _plan
    plan = _plan
    if plan is None:
        with _plan_lock:
            if _plan is None:
                _plan = FaultPlan.from_env()
            plan = _plan
    plan.hit(point)


def reset_plan() -> None:
    """Drop the cached plan (tests that mutate the env var)."""
    global _plan
    with _plan_lock:
        _plan = None
