"""Pipeline-wide observability: cross-process trace spans + Perfetto export,
as in the reference ``repro/runtime/telemetry.py`` (the same events, fields
and export format, so one dump may hold both packages' processes).

The async pipeline's whole claim (paper §3) is overlap — rollouts,
inference, and training proceeding without barriers. Counters can say the
overlap exists; only a *timeline* can show where it breaks. This module is
the span recorder behind that timeline:

  * **Import-gated like ``transport/faults.py``** — hot modules do::

        if os.environ.get("REPRO_TRACE"):
            from repro_torch.runtime import telemetry as _tel
        else:
            _tel = None

    so with ``REPRO_TRACE`` unset this module is *never imported* and
    every instrumentation site costs one ``is None`` check. Spawned child
    processes inherit ``os.environ``, so one env var lights up the whole
    process tree.

  * **Per-thread append-only ring buffers** — :func:`span` /
    :func:`instant` append one small dict to a thread-local ring (no
    locks on the hot path; the registration of a NEW thread's buffer is
    the only locked step). The ring bounds memory: a long run keeps the
    newest ``REPRO_TRACE_BUF`` events per thread.

  * **Trace context that crosses the wire** — :func:`context` installs a
    ``(trace, span)`` pair thread-locally; :func:`wire_ctx` reads it back
    as JSON-safe header fields (``tr``/``sp``). PutStream frames,
    ``infer.submit`` requests, and ``worker.report`` payloads carry these
    ids, so one experience flush is followable rollout worker → wire →
    TransportServer → replay → trainer collate, and one weight version
    publish → acquire → first action (the policy-lag path).

  * **Chrome-trace-event export** — :func:`dump` writes
    ``{"traceEvents": [...]}`` that loads directly in Perfetto
    (ui.perfetto.dev) or ``chrome://tracing``. Complete events (``ph:X``)
    carry ``args.trace``; flow events (``s``/``t``/``f``) with
    ``id = trace`` draw the cross-process arrows. Timestamps are epoch
    microseconds (``time.time_ns() // 1000``) so events from different
    processes land on one comparable axis.

**Spans time the host.** A span opens and closes on the host's clock and
never synchronizes a device: where its body only enqueues CUDA work (a
kernel launch, a non-blocking copy), the span closes when the enqueue
returns, before the device has run it. The instrumented sites whose work
ends on the host (the served batch's results, a decoded weight tree, a
collated numpy batch) say so where they record.

Child-process buffers travel to the parent as the ``trace`` key of
``worker.report`` payloads (see ``transport/remote.py``); the server folds
them into the parent's collector via :func:`extend_foreign`, so one
``trace.dump`` sees the whole tree.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.runtime.service import Service as _ServiceBase

ENV_VAR = "REPRO_TRACE"

#: per-thread ring capacity (events); the cap bounds a long run's memory
BUF_EVENTS = int(os.environ.get("REPRO_TRACE_BUF", "65536") or "65536")
#: cap on events adopted from child processes (oldest dropped first)
FOREIGN_EVENTS = 4 * BUF_EVENTS

_pid = os.getpid()


def enabled() -> bool:
    """Whether recording is on. Gated importers never load this module
    when off, but direct importers (tests, exporters) may call it."""
    return bool(os.environ.get(ENV_VAR))


def now_us() -> int:
    """Epoch microseconds — the one clock every process shares, so spans
    from different processes align on a single Perfetto axis."""
    return time.time_ns() // 1000


def new_id() -> int:
    """A fresh 63-bit trace/span id (positive, JSON/int64-safe)."""
    return int.from_bytes(os.urandom(8), "big") >> 1


class _Buf:
    """One thread's append-only event ring (no lock: single writer)."""

    __slots__ = ("events", "idx", "dropped", "tid")

    def __init__(self, tid: int):
        self.events: List[Dict] = []
        self.idx = 0                       # next overwrite slot once full
        self.dropped = 0
        self.tid = tid

    def append(self, ev: Dict) -> None:
        if len(self.events) < BUF_EVENTS:
            self.events.append(ev)
        else:                              # ring wrap: newest wins
            self.events[self.idx] = ev
            self.idx = (self.idx + 1) % BUF_EVENTS
            self.dropped += 1

    def drain(self) -> List[Dict]:
        out = self.events[self.idx:] + self.events[:self.idx]
        self.events, self.idx = [], 0
        return out


_local = threading.local()
_reg_lock = threading.Lock()
_bufs: List[_Buf] = []
_foreign: List[Dict] = []
_foreign_dropped = 0


def _buf() -> _Buf:
    b = getattr(_local, "buf", None)
    if b is None:
        b = _Buf(threading.get_ident())
        with _reg_lock:
            _bufs.append(b)
        _local.buf = b
    return b


# -- trace context ------------------------------------------------------------
def current() -> Optional[Tuple[int, int]]:
    """The installed ``(trace, span)`` pair for this thread, or None."""
    stack = getattr(_local, "ctx", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def context(trace: int, span: int = 0) -> Iterator[None]:
    """Install a trace context for the dynamic extent — spans opened
    inside inherit ``trace`` and parent onto ``span``; :func:`wire_ctx`
    reads it for header stamping."""
    stack = getattr(_local, "ctx", None)
    if stack is None:
        stack = _local.ctx = []
    stack.append((int(trace), int(span)))
    try:
        yield
    finally:
        stack.pop()


def wire_ctx() -> Dict[str, int]:
    """The current context as JSON-safe frame-header fields (``tr`` /
    ``sp``) — {} when no context is installed."""
    cur = current()
    if cur is None:
        return {}
    return {"tr": cur[0], "sp": cur[1]}


# -- recording ----------------------------------------------------------------
_FLOW_PH = {"start": "s", "step": "t", "end": "f"}


def _flow_event(name: str, trace: int, ts: int, flow: str,
                tid: int) -> Dict:
    ev = {"name": name, "cat": "flow", "ph": _FLOW_PH[flow],
          "id": trace, "ts": ts, "pid": _pid, "tid": tid}
    if flow != "start":
        ev["bp"] = "e"                     # bind to the enclosing slice
    return ev


#: span ids only disambiguate parent/child within one process's trace
#: view, so a counter off a random base beats an urandom syscall per span
_sid_counter = itertools.count(int.from_bytes(os.urandom(6), "big"))


class _Span:
    """Class-based context manager for :func:`span` — the put-path hot
    wrapper, so no generator-contextmanager machinery."""

    __slots__ = ("name", "cat", "trace", "parent", "args", "flow",
                 "sid", "buf", "t0", "_stack")

    def __init__(self, name, cat, trace, parent, args, flow):
        self.name, self.cat, self.flow = name, cat, flow
        self.trace, self.parent, self.args = trace, parent, args

    def __enter__(self) -> Tuple[int, int]:
        cur = current()
        if self.trace is None:
            self.trace = cur[0] if cur else new_id()
        if self.parent is None and cur is not None:
            self.parent = cur[1]
        self.sid = next(_sid_counter)
        stack = getattr(_local, "ctx", None)
        if stack is None:
            stack = _local.ctx = []
        stack.append((int(self.trace), self.sid))
        self._stack = stack
        self.buf = _buf()
        self.t0 = now_us()
        return (self.trace, self.sid)

    def __exit__(self, *exc) -> None:
        buf, t0 = self.buf, self.t0
        a: Dict[str, Any] = {"trace": int(self.trace), "span": self.sid}
        if self.parent:
            a["parent"] = int(self.parent)
        if self.args:
            a.update(self.args)
        buf.append({"name": self.name, "cat": self.cat, "ph": "X",
                    "ts": t0, "dur": max(now_us() - t0, 1), "pid": _pid,
                    "tid": buf.tid, "args": a})
        if self.flow is not None:
            buf.append(_flow_event(self.name, self.trace, t0, self.flow,
                                   buf.tid))
        self._stack.pop()


def span(name: str, *, cat: str = "repro", trace: Optional[int] = None,
         parent: Optional[int] = None, args: Optional[Dict] = None,
         flow: Optional[str] = None) -> _Span:
    """Record a complete event (``ph:X``) around the body and install its
    ``(trace, span)`` as the thread context. ``trace=None`` inherits the
    installed context (new root trace otherwise). ``flow`` in
    {"start","step","end"} additionally emits a flow event with
    ``id = trace`` — the Perfetto arrow tying this slice to its
    cross-process siblings. Yields ``(trace, span_id)``."""
    return _Span(name, cat, trace, parent, args, flow)


def instant(name: str, *, cat: str = "repro", trace: Optional[int] = None,
            args: Optional[Dict] = None, flow: Optional[str] = None) -> None:
    """Record a point event (``ph:i``); same trace/flow semantics as
    :func:`span` without a duration or context install."""
    cur = current()
    if trace is None and cur is not None:
        trace = cur[0]
    buf = _buf()
    ts = now_us()
    a: Dict[str, Any] = {} if trace is None else {"trace": int(trace)}
    if args:
        a.update(args)
    buf.append({"name": name, "cat": cat, "ph": "i", "s": "t", "ts": ts,
                "pid": _pid, "tid": buf.tid, "args": a})
    if flow is not None and trace is not None:
        buf.append(_flow_event(name, trace, ts, flow, buf.tid))


# -- collection / export ------------------------------------------------------
def extend_foreign(events: List[Dict]) -> None:
    """Adopt events shipped from another process (``worker.report``'s
    ``trace`` payload). Bounded: oldest foreign events drop first."""
    global _foreign_dropped
    if not events:
        return
    with _reg_lock:
        _foreign.extend(e for e in events if isinstance(e, dict))
        excess = len(_foreign) - FOREIGN_EVENTS
        if excess > 0:
            del _foreign[:excess]
            _foreign_dropped += excess


def drain(clear: bool = True) -> List[Dict]:
    """Collect every buffered event (all threads + foreign), clearing the
    buffers by default. ``clear=False`` copies without consuming."""
    with _reg_lock:
        bufs = list(_bufs)
        if clear:
            foreign, _foreign[:] = list(_foreign), []
        else:
            foreign = list(_foreign)
    out: List[Dict] = []
    for b in bufs:
        if clear:
            out.extend(b.drain())
        else:
            out.extend(b.events[b.idx:] + b.events[:b.idx])
    out.extend(foreign)
    return out


def dump(path: str, events: Optional[List[Dict]] = None,
         *, process_name: str = "") -> int:
    """Write a Chrome-trace-event JSON file (open in Perfetto). Drains
    the buffers unless ``events`` is given. Returns the event count."""
    if events is None:
        events = drain()
    meta: List[Dict] = []
    if process_name:
        meta.append({"name": "process_name", "ph": "M", "pid": _pid,
                     "tid": 0, "args": {"name": process_name}})
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return len(events)


def reset() -> None:
    """Drop every buffered event and foreign record (test isolation)."""
    global _foreign_dropped
    with _reg_lock:
        for b in _bufs:
            b.events, b.idx, b.dropped = [], 0, 0
        _foreign[:] = []
        _foreign_dropped = 0


class TelemetrySink(_ServiceBase):
    """A Service that samples the :class:`ServiceRegistry` into timestamped
    history — the scrape target behind the ``metrics.snapshot`` wire
    endpoint and the optional JSONL file.

    Each sample is ``{"t": epoch_s, "services": registry.snapshot(),
    "health": registry.health()}`` — counters, gauges, series summaries,
    histograms, and any structured crash records, at one instant. The
    in-memory history is bounded (``history`` samples); ``path`` appends
    one JSON line per sample for offline analysis. Unlike the span
    recorder this needs no env gating: it samples at ``interval_s``, not
    per operation.

    Declared here (not ``service.py``) so the observability plane stays
    one module; imported lazily by the orchestrator to keep gated-off
    processes from loading it as a side effect.
    """

    def __init__(self, registry, *, interval_s: float = 1.0,
                 history: int = 256, path: str = ""):
        super().__init__("telemetry", role="observability")
        self._registry = registry
        self._interval = max(float(interval_s), 0.05)
        self._history_cap = max(int(history), 1)
        self._path = path
        self._samples: List[Dict] = []
        self._samples_lock = threading.Lock()
        self._file = None

    def on_start(self) -> None:
        if self._path:
            self._file = open(self._path, "a")

    def sample(self) -> Dict:
        """Take (and retain) one sample now — also the wire endpoint's
        body via :meth:`latest`."""
        s = {"t": time.time(),
             "services": self._registry.snapshot(),
             "health": self._registry.health()}
        with self._samples_lock:
            self._samples.append(s)
            if len(self._samples) > self._history_cap:
                del self._samples[:len(self._samples) - self._history_cap]
        if self._file is not None:
            try:
                self._file.write(json.dumps(s, default=str) + "\n")
                self._file.flush()
            except OSError:
                pass
        return s

    def latest(self) -> Optional[Dict]:
        with self._samples_lock:
            return self._samples[-1] if self._samples else None

    def tail(self, n: int = 0) -> List[Dict]:
        with self._samples_lock:
            return list(self._samples[-n:] if n else self._samples)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.sample()

    def on_stop(self) -> None:
        self.sample()                      # final sample: shutdown state
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None
