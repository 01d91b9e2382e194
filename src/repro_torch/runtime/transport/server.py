"""TransportServer: the parent-process endpoint of the transport layer, as
in the reference ``repro/runtime/transport/server.py`` (the same wire
protocol: a reference client talks to a port server and the reverse).

One listening socket serves every remote worker of a system. It is itself
a :class:`~repro_torch.runtime.service.Service` (role ``transport``) registered
FIRST on the bus, so it starts before any remote host spawns a child and
stops after every child has been told to exit.

Exposed endpoints (JSON header ``m`` field):

  ======================  ==================================================
  ``chan.put``            push one encoded item into a hosted channel —
                          the channel's own backpressure policy answers
  ``chan.put_many``       one codec blob carrying a whole flush (an
                          episode's segments); per-item verdict vector back
  ``chan.put_stream``     one pipelined put-stream frame: applied at most
                          once per ``(chan, stream, seq)`` — replayed
                          frames are re-ACKed from the stored verdicts,
                          never re-applied (exactly-once across reconnects)
  ``chan.pop``            blocking ``pop_batch(n, timeout)`` (bounded
                          slices; clients long-poll)
  ``chan.pop_many``       coalesced drain: up to ``n`` items, ONE blob —
                          blocks only for the first item
  ``chan.len/stats``      depth / stats snapshot
  ``stream.open``         put-stream handshake: registers the dedup state
                          and (ring mode) attaches the client→server ring
  ``ring.open``           attaches this connection's server→client ring
                          for ``want_ring`` pop replies
  ``store.acquire``       newest weights with version > ``newer_than``
                          (encoded once per version, then cache-served)
  ``store.state``         (version, draining) — the drain protocol's poll
  ``store.drain``         remote ``begin_publish`` (drain signal)
  ``store.publish``       remote publish (a trainer across the wire)
  ``worker.hello``        connect-mode handshake: shared-token auth, then
                          the supervisor assigns a slot and ships its spec
  ``worker.report``       child → parent metrics/health bridge; the reply
                          carries the per-incarnation stop flag
  ``server.stats``        the server's counters and gauges
  ``metrics.snapshot``    remote scrape of the server's registry
  ``ping``                liveness probe
  ======================  ==================================================

Not ported yet (ROADMAP A6b), each raising or answering an error that
names it: the ``infer.*`` endpoints of the disaggregated inference plane
(``set_inference``), the write-ahead journal (``journal``,
``resume_from_journal``), the ``trace.dump`` endpoint and the fault
points.

Weights are planned once per published version (:meth:`_weights_plan`):
a tree of CUDA tensors crosses to the host in one pass of copies into one
pinned buffer (``codec._host_leaves``). The lane's record is written from
that plan straight into shared memory; the blob that socket and
per-message-segment acquirers receive is materialised once, on the first
such acquire. The registry times both (``weight_encode_s``,
``weight_lane_publish_s``). With a lane, a second thread creates it at
start and touches its pages once (``weight_lane_warm_s``, then
``lane_ready`` is set): a first write to a shared-memory page costs
several times a rewrite, and that cost then overlaps the workers'
start-up instead of landing on the first acquires.

Every connection gets its own handler thread; blocking pops therefore
never head-of-line-block other clients. Large response bodies go
out-of-band via shared memory when the client asks (``want_shm``) — the
server defers the unlink until the same connection's next frame, which is
the client's implicit ack — or through the connection's persistent ring
(``want_ring``), which needs no per-message ack at all.

Orphan sweep: a client that dies between creating a request SHM segment
and unlinking it (creator-unlinks-after-ack) leaks the segment — its own
resource tracker is shared with the parent and therefore outlives it. The
server remembers every client-created segment name it has seen and
unlinks any still present when it closes. Ring segments need no LRU:
their lifetime IS the connection's, so the handler sweeps its own rings
in ``finally`` (the creator's unlink having won is fine — both sides
tolerate the name being gone).

Segment-churn accounting: the registry counters
``shm_segments_created`` / ``shm_segments_attached`` /
``shm_segments_unlinked`` (per-message data plane) vs
``ring_records_in/out`` + ``rings_opened`` (persistent data plane) make
the ring-vs-segment trade observable in ``metrics()["services"]``, not
just in the benchmark.
"""
from __future__ import annotations

import collections
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.runtime.service import Service
from repro_torch.runtime.transport.channel import (shared_memory, shm_read,
                                                   shm_write)
from repro_torch.runtime.transport.codec import (decode_pytree, plan_pytree,
                                                 encode_pytree, recv_frame,
                                                 send_frame)
from repro_torch.runtime.transport.ring import (RingError, ShmRing,
                                                refuse_unported_gates,
                                                sweep_stale_shm)

_A6B = "is not ported yet: ROADMAP A6b"

__all__ = ["TransportServer"]


class _ConnContext:
    """Per-connection transport state: the attached ring endpoints."""

    __slots__ = ("c2s", "s2c")

    def __init__(self):
        self.c2s: Optional[ShmRing] = None    # put-stream payloads in
        self.s2c: Optional[ShmRing] = None    # pop replies out

    def rings(self) -> List[ShmRing]:
        return [r for r in (self.c2s, self.s2c) if r is not None]


class _StreamState:
    """Dedup state for one put stream, keyed by (channel, stream id).

    Survives the stream's connection (that is the point: a reconnect
    replays the window and the state says what was already applied).
    ``acks`` keeps the last few windows of verdicts so a replayed frame
    can be re-ACKed faithfully.
    """

    __slots__ = ("last_seq", "acks", "keep", "lock", "ack_every",
                 "pending_acks", "window")

    def __init__(self, window: int, ack_every: int = 1):
        self.window = window
        self.last_seq = -1
        self.acks: "collections.OrderedDict[int, List[bool]]" = \
            collections.OrderedDict()
        self.keep = max(4 * window, 64)
        # cumulative acking: reply once per `ack_every` frames (a reply
        # per frame costs the producer a receiver-thread wakeup per
        # flush); duplicates and stream.flush force an immediate drain
        self.ack_every = max(1, min(ack_every, max(window // 2, 1)))
        self.pending_acks: Dict[int, List[bool]] = {}
        # serializes dedup-check + apply: a frame replayed on a fresh
        # connection must not race its original, still stalled on the
        # dying one (e.g. a block-policy put)
        self.lock = threading.Lock()

    def record(self, seq: int, verdicts: List[bool]) -> None:
        self.last_seq = seq
        self.acks[seq] = verdicts
        self.pending_acks[seq] = verdicts
        while len(self.acks) > self.keep:
            self.acks.popitem(last=False)

    def drain_acks(self) -> Dict[str, List[bool]]:
        out = {str(k): v for k, v in self.pending_acks.items()}
        self.pending_acks = {}
        return out


class TransportServer(Service):
    """Serves channels + the weight store to remote worker processes."""

    #: how many client-created SHM segment names to remember for the
    #: orphan sweep (normal clients unlink promptly, so the live set is
    #: tiny; the bound only caps pathological churn)
    SHM_SWEEP_LIMIT = 4096

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 shm_threshold: int = 1 << 16, name: str = "transport",
                 token: str = "", journal: Any = None,
                 weight_lane_bytes: int = 0):
        refuse_unported_gates()
        if journal is not None:
            raise NotImplementedError(f"the transport journal {_A6B}")
        super().__init__(name, role="transport")
        self._channels: Dict[str, Any] = {}
        self._store = None
        self._sinks: Dict[str, Any] = {}          # worker name -> host
        self._token = token
        self._hello: Optional[Callable[[Dict], Dict]] = None
        self._shm_threshold = shm_threshold
        # put-stream dedup state, keyed by (chan, stream id); survives the
        # stream's connection so replays after a reconnect are applied at
        # most once (bounded LRU: streams are few and long-lived)
        self._streams: "collections.OrderedDict[Tuple[str, str], _StreamState]" = \
            collections.OrderedDict()
        self._streams_lock = threading.Lock()
        self._conns: list = []
        self._conn_lock = threading.Lock()
        # client-created SHM segments seen on requests, for the orphan
        # sweep at close (an OrderedDict doubles as a bounded LRU set)
        self._client_shm: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._client_shm_lock = threading.Lock()
        # weights are encoded once per published version, then cache-served
        # to every remote consumer (the LlamaRL-style broadcast amortized):
        # (version, encode plan, blob or None until a non-lane acquire);
        # the lock makes concurrent acquirers of a new version wait for
        # the one encode instead of each paying it
        self._weights_cache: Tuple[int, Any, Optional[bytearray]] = (
            -1, None, None)
        self._cache_lock = threading.Lock()
        # broadcast weight lane: one persistent ShmRing holding the newest
        # version's encoded blob; same-host readers attach by NAME and
        # copy by absolute POSITION from the acquire reply — no
        # per-acquire segment churn, no per-reader ring state
        self._lane_bytes = int(weight_lane_bytes)
        self._lane: Optional[ShmRing] = None
        self._lane_info: Tuple[int, Optional[Dict]] = (-1, None)
        self._lane_lock = threading.Lock()
        self.lane_ready = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))         # bound at construction so
        self._listener.listen(64)                 # specs can carry the port
        self._listener.settimeout(0.2)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]

    # -- endpoint registration ------------------------------------------------
    def add_channel(self, name: str, channel: Any) -> None:
        self._channels[name] = channel

    def set_store(self, store: Any) -> None:
        self._store = store

    def register_worker_sink(self, name: str, host: Any) -> None:
        """Route ``worker.report`` frames for ``name`` to ``host``."""
        self._sinks[name] = host

    def set_hello_handler(self, handler: Callable[[Dict], Dict]) -> None:
        """Install the ``worker.hello`` responder (the Supervisor): gets
        the authenticated request header, answers the slot assignment."""
        self._hello = handler

    def set_inference(self, broker: Any) -> None:
        """The reference installs the ``infer.*`` responder here (the
        disaggregated inference plane)."""
        raise NotImplementedError(f"the inference plane {_A6B}")

    # -- service surface ------------------------------------------------------
    def _thread_targets(self):
        if self._lane_bytes > 0 and shared_memory is not None:
            return [self._run, self._warm_lane]
        return [self._run]

    def _warm_lane(self) -> None:
        """Create the weight lane and touch its pages, holding the lane
        lock (a publish waits for it rather than racing the zeros)."""
        with self._lane_lock, self.metrics.timer("weight_lane_warm_s"):
            try:
                if self._lane is None:
                    self._lane = ShmRing.create(self._lane_bytes)
                warm = self._lane.prefault(stop=self._stop)
            except (RingError, OSError):
                return                  # the publish path retries, or falls
        if warm:                        # back to the socket body
            self.lane_ready.set()

    def _run(self) -> None:
        # a SIGKILLed previous incarnation cannot run its own finally
        # blocks — sweep its leaked rings/segments before serving (names
        # encode the creator pid; only dead-creator segments are touched)
        swept = sweep_stale_shm()
        if swept:
            self.metrics.inc("shm_stale_swept", float(swept))
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:            # listener closed during shutdown
                break
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.append(conn)
            self.metrics.inc("connections")
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name=f"{self.name}-conn").start()

    def on_stop(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._sweep_orphan_shm()
        with self._lane_lock:
            lane, self._lane = self._lane, None
        if lane is not None:
            lane.close()
            lane.unlink()

    def _note_client_shm(self, name: str) -> None:
        with self._client_shm_lock:
            self._client_shm[name] = None
            self._client_shm.move_to_end(name)
            while len(self._client_shm) > self.SHM_SWEEP_LIMIT:
                self._client_shm.popitem(last=False)

    def _sweep_orphan_shm(self) -> None:
        """Unlink client-created segments whose creator died before its
        post-ack unlink (e.g. a SIGKILLed producer). Normal segments are
        long gone — attach fails and the name is skipped."""
        if shared_memory is None:
            return
        with self._client_shm_lock:
            names, self._client_shm = list(self._client_shm), \
                collections.OrderedDict()
        for name in names:
            try:
                seg = shared_memory.SharedMemory(name=name)
            except (FileNotFoundError, OSError):
                continue
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
            self.metrics.inc("shm_orphans_swept")

    # -- connection loop ------------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        pending_shm = None                 # reply segment awaiting its ack
        ctx = _ConnContext()
        # buffered reads: a pipelined producer's back-to-back frames are
        # consumed per-buffer, not per-syscall
        rfile = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                frame = recv_frame(rfile)
                if pending_shm is not None:
                    # the next frame (or EOF) is the client's implicit ack
                    pending_shm.close()
                    try:
                        pending_shm.unlink()
                        self.metrics.inc("shm_segments_unlinked")
                    except FileNotFoundError:
                        pass
                    pending_shm = None
                if frame is None:
                    break
                header, body = frame
                if header.get("shm"):      # request body arrived via SHM
                    self._note_client_shm(header["shm"])
                    self.metrics.inc("shm_segments_attached")
                    body = shm_read(header["shm"], header["shm_size"])
                self.metrics.inc("requests")
                self.metrics.inc("rx_bytes", float(len(body)))
                resp, resp_body = self._dispatch(header, body, ctx)
                if resp is None:           # cumulative-ack frame: no reply
                    continue
                if resp_body:
                    # the ring (persistent, no per-message ack) wins over
                    # per-message segments when the connection has one
                    if (header.get("want_ring") and ctx.s2c is not None
                            and ctx.s2c.push(resp_body, timeout=2.0)):
                        self.metrics.inc("ring_records_out")
                        self.metrics.inc("ring_bytes_out",
                                         float(len(resp_body)))
                        resp = {**resp, "ring_nbytes": len(resp_body)}
                        resp_body = b""
                    elif (header.get("want_shm")
                            and shared_memory is not None
                            and len(resp_body) >= self._shm_threshold):
                        pending_shm = shm_write(resp_body)
                        self.metrics.inc("shm_segments_created")
                        resp = {**resp, "shm": pending_shm.name,
                                "shm_size": len(resp_body)}
                        resp_body = b""
                self.metrics.inc(
                    "tx_bytes", float(send_frame(conn, resp, resp_body)))
        except (OSError, ValueError, RingError):
            pass                           # peer vanished — their problem
        finally:
            if pending_shm is not None:
                pending_shm.close()
                try:
                    pending_shm.unlink()
                    self.metrics.inc("shm_segments_unlinked")
                except FileNotFoundError:
                    pass
            # ring lifetime == connection lifetime: sweep this handler's
            # rings (the creator's own unlink having won is fine)
            for ring in ctx.rings():
                ring.close()
                ring.unlink()
                self.metrics.inc("rings_swept")
            for closer in (rfile.close, conn.close):
                try:
                    closer()
                except OSError:
                    pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- put-stream dedup state ----------------------------------------------
    #: put-stream dedup states kept (LRU). Evicting a LIVE stream's state
    #: forfeits its exactly-once guarantee on the next replay, so the
    #: bound sits far above any real topology (streams ≈ 2 per worker)
    #: and evictions are surfaced as a counter.
    STREAM_STATE_LIMIT = 4096

    def _stream_state(self, chan: str, stream: str, window: int = 32,
                      ack_every: int = 1) -> _StreamState:
        key = (chan, stream)
        with self._streams_lock:
            st = self._streams.get(key)
            if st is None:
                st = self._streams[key] = _StreamState(window, ack_every)
            self._streams.move_to_end(key)
            while len(self._streams) > self.STREAM_STATE_LIMIT:
                self._streams.popitem(last=False)
                self.metrics.inc("stream_states_evicted")
            return st

    # -- request dispatch -----------------------------------------------------
    def _dispatch(self, h: Dict, body: bytes,
                  ctx: Optional[_ConnContext] = None) -> Tuple[Dict, bytes]:
        ctx = ctx if ctx is not None else _ConnContext()
        try:
            m = h.get("m")
            if m == "chan.put":
                ok = self._channels[h["chan"]].put(decode_pytree(body))
                return {"ok": bool(ok)}, b""
            if m == "chan.put_many":
                items = decode_pytree(body)
                chan = self._channels[h["chan"]]
                verdicts = [bool(v) for v in
                            self._apply_put(chan, items, body)]
                return {"ok": all(verdicts),
                        "verdicts": verdicts}, b""
            if m == "ring.open":
                # client-created rings for this connection; re-open on the
                # same connection (shouldn't happen) replaces cleanly
                if h.get("c2s"):
                    if ctx.c2s is not None:
                        ctx.c2s.close()
                    ctx.c2s = ShmRing.attach(h["c2s"])
                if h.get("s2c"):
                    if ctx.s2c is not None:
                        ctx.s2c.close()
                    ctx.s2c = ShmRing.attach(h["s2c"])
                self.metrics.inc("rings_opened")
                return {"ok": True}, b""
            if m == "stream.open":
                if h["chan"] not in self._channels:
                    return {"err": f"unknown channel {h['chan']!r}"}, b""
                st = self._stream_state(h["chan"], h["stream"],
                                        int(h.get("window", 32)),
                                        int(h.get("ack_every", 1)))
                if h.get("ring"):
                    if ctx.c2s is not None:
                        ctx.c2s.close()
                    ctx.c2s = ShmRing.attach(h["ring"])
                    self.metrics.inc("rings_opened")
                return {"ok": True, "last_seq": st.last_seq}, b""
            if m == "stream.flush":
                st = self._stream_state(h["chan"], h["stream"])
                with st.lock:
                    return {"ok": True, "acks": st.drain_acks()}, b""
            if m == "stream.tune":
                # adaptive streaming: the client retunes the server's ack
                # cadence online (bounded by the handshake window, like
                # stream.open); pending acks drain immediately so a
                # shrunken window frees itself without waiting out the
                # OLD cadence
                st = self._stream_state(h["chan"], h["stream"])
                with st.lock:
                    st.ack_every = max(1, min(int(h.get("ack_every", 1)),
                                              max(st.window // 2, 1)))
                    acks = st.drain_acks() if st.pending_acks else None
                self.metrics.inc("stream_tunes")
                if acks:
                    return {"ok": True, "acks": acks}, b""
                return None, b""
            if m == "chan.put_stream":
                # ring payloads are consumed UNCONDITIONALLY (records and
                # frames must stay aligned), dedup decides application
                if h.get("ring_nbytes") is not None:
                    if ctx.c2s is None:
                        return {"err": "put_stream ring frame without an "
                                       "attached ring"}, b""
                    body = ctx.c2s.pop(timeout=5.0)
                    if body is None or len(body) != h["ring_nbytes"]:
                        return {"err": "put ring record missing or "
                                       "truncated"}, b""
                    self.metrics.inc("ring_records_in")
                    self.metrics.inc("ring_bytes_in", float(len(body)))
                    # the ingest pop is a genuine copy (decoded items are
                    # stored long-lived in the hosted channel, so they
                    # must not view the reclaimable ring) — counted so
                    # the zero-copy claim is auditable end to end
                    self.metrics.inc("bytes_copied", float(len(body)))
                st = self._stream_state(h["chan"], h["stream"])
                seq = int(h["seq"])
                with st.lock:
                    if seq <= st.last_seq:   # replayed, already applied
                        self.metrics.inc("stream_dup_frames")
                        acks = st.drain_acks()
                        acks[str(seq)] = st.acks.get(seq, [])
                        return {"ok": True, "dup": True, "acks": acks}, b""
                    items = decode_pytree(body)
                    chan = self._channels[h["chan"]]
                    verdicts = [bool(v) for v in
                                self._apply_put(chan, items, body)]
                    st.record(seq, verdicts)
                    acks = (st.drain_acks()
                            if len(st.pending_acks) >= st.ack_every
                            else None)
                self.metrics.inc("stream_frames")
                self.metrics.inc("stream_items", float(len(verdicts)))
                if acks is None:
                    return None, b""          # cumulative: ack later
                return {"ok": True, "acks": acks}, b""
            if m == "chan.pop":
                got = self._channels[h["chan"]].pop_batch(
                    h["n"], timeout=h.get("timeout", 0.0))
                if got is None:
                    return {"ok": False}, b""
                return {"ok": True}, encode_pytree(got)
            if m == "chan.pop_many":
                chan = self._channels[h["chan"]]
                pop_many = getattr(chan, "pop_many", None)
                if pop_many is not None:
                    got = pop_many(h["n"], timeout=h.get("timeout", 0.0))
                else:
                    got = chan.pop_batch(
                        min(h["n"], max(len(chan), 1)),
                        timeout=h.get("timeout", 0.0))
                if got is None:
                    return {"ok": False}, b""
                return {"ok": True, "count": len(got)}, encode_pytree(got)
            if m == "chan.len":
                return {"len": len(self._channels[h["chan"]])}, b""
            if m == "chan.stats":
                return {"stats": self._channels[h["chan"]].stats()}, b""
            if m == "store.acquire":
                raw = self._store.acquire_raw(
                    newer_than=h.get("newer_than", -1),
                    timeout=h.get("timeout", 0.0))
                if raw is None:
                    return {"ok": False}, b""
                payload, version = raw
                plan = self._weights_plan(payload, version)
                if h.get("want_lane"):
                    # broadcast lane: the reply carries only the blob's
                    # POSITION in the persistent lane ring — the reader
                    # copies it out positionally (torn reads detected
                    # client-side fall back to a no_lane re-acquire)
                    info = self._lane_publish(version, plan)
                    if info is not None:
                        self.metrics.inc("weight_lane_serves")
                        return {"ok": True, "version": version,
                                **info}, b""
                return ({"ok": True, "version": version},
                        self._weights_blob(version, plan))
            if m == "store.state":
                return {"version": self._store.version(),
                        "draining": self._store.draining}, b""
            if m == "store.drain":
                self._store.begin_publish()
                return {"ok": True}, b""
            if m == "store.publish":
                self._store.publish(decode_pytree(body, copy=True),
                                    h["version"])
                return {"ok": True}, b""
            if m in ("infer.open", "infer.submit", "infer.result",
                     "trace.dump"):
                return {"err": f"{m}: the endpoint {_A6B}"}, b""
            if m == "worker.hello":
                if self._token and h.get("token") != self._token:
                    self.metrics.inc("auth_failures")
                    return {"err": "worker.hello: bad or missing token"}, b""
                if self._hello is None:
                    return {"err": "this server hosts no connect-mode "
                                   "worker slots"}, b""
                return dict(self._hello(h)), b""
            if m == "worker.report":
                host = self._sinks.get(h["worker"])
                if host is None:
                    return {"err": f"unknown worker {h['worker']!r}"}, b""
                incarnation = int(h.get("incarnation", 0))
                report = h.get("report", {})
                if isinstance(report, dict):
                    report.pop("trace", None)     # a traced child's spans
                host.apply_report(report, incarnation=incarnation)
                # per-incarnation stop verdict: a superseded or
                # budget-exhausted incarnation is told to exit even while
                # the slot itself lives on
                stop_for = getattr(host, "stop_for", None)
                stop = (stop_for(incarnation) if stop_for is not None
                        else host.stop_requested)
                return {"stop": bool(stop)}, b""
            if m == "server.stats":
                snap = self.metrics.snapshot()
                stats = dict(snap.get("counters", {}))
                stats.update(snap.get("gauges", {}))
                return {"ok": True, "stats": stats}, b""
            if m == "metrics.snapshot":
                # the server's own registry (the reference serves its
                # telemetry sink's sample here when one is set: A6b)
                return {"ok": True, "sample": {
                    "services": {self.name: self.metrics.snapshot()},
                    "health": {self.name: self.health()}}}, b""
            if m == "ping":
                return {"ok": True}, b""
            return {"err": f"unknown method {m!r}"}, b""
        except Exception as e:  # noqa: BLE001 — fault goes back to the caller
            return {"err": f"{type(e).__name__}: {e}"}, b""

    @staticmethod
    def _apply_put(chan: Any, items: List[Any], body: bytes) -> List[Any]:
        """Route a decoded flush into ``chan``."""
        put_many = getattr(chan, "put_many", None)
        if put_many is not None:
            return put_many(items)
        return [chan.put(x) for x in items]

    def resume_from_journal(self):
        """The reference adopts a journal directory's state here."""
        raise NotImplementedError(f"resume_from_journal {_A6B}")

    def _weights_plan(self, payload: Any, version: int):
        """The encode plan of ``version`` (its leaves on the host), made
        on the first acquire of it (the caller's thread) and cached."""
        with self._cache_lock:
            if self._weights_cache[0] == version:
                return self._weights_cache[1]
            self._weights_cache = (-1, None, None)   # free the old first
            with self.metrics.timer("weight_encode_s"):
                plan = plan_pytree(self._store.transport.recv(payload))
            self._weights_cache = (version, plan, None)
            self.metrics.inc("weight_encodes")
            return plan

    def _weights_blob(self, version: int, plan) -> bytearray:
        """The encoded blob of ``version``, written once from its plan."""
        with self._cache_lock:
            cached_version, cached_plan, blob = self._weights_cache
            if cached_version == version and blob is not None:
                return blob
            blob = bytearray(plan.nbytes)
            plan.write_into(blob)
            if cached_version == version:      # not superseded meanwhile
                self._weights_cache = (version, cached_plan, blob)
            return blob

    def _lane_publish(self, version: int, plan) -> Optional[Dict]:
        """Write ``version``'s blob from its ``plan`` into the broadcast
        lane (once per version) and return the positional descriptor for
        acquire replies — or None when the lane is disabled, unavailable,
        or too small for this blob (callers fall back to the socket/SHM
        body)."""
        if self._lane_bytes <= 0 or shared_memory is None:
            return None
        with self._lane_lock:
            if self._lane_info[0] == version:
                return self._lane_info[1]
            try:
                if self._lane is None:
                    self._lane = ShmRing.create(self._lane_bytes)
                if plan.nbytes > self._lane.max_record():
                    return None
                with self.metrics.timer("weight_lane_publish_s"):
                    pos, seq = self._lane.publish_into(plan.nbytes,
                                                       plan.write_into)
            except (RingError, OSError):
                return None
            info = {"lane": self._lane.name, "lane_pos": int(pos),
                    "lane_seq": int(seq), "lane_nbytes": plan.nbytes}
            self._lane_info = (version, info)
        self.metrics.inc("weight_lane_publishes")
        self.metrics.inc("weight_lane_bytes", float(plan.nbytes))
        return info
