"""Client-side transport channels: the ExperienceChannel contract over a
process boundary, as in the reference ``repro/runtime/transport/channel.py``
(and speaking its wire protocol: a port client talks to a reference
server and the reverse).

A :class:`SocketChannel` is a proxy for a channel hosted by a
:class:`~repro_torch.runtime.transport.server.TransportServer` in another
process. It implements the same ``put`` / ``pop_batch`` surface as
:class:`~repro_torch.runtime.experience.FifoChannel`, with the same backpressure
semantics — the *server-side* channel's policy decides, and the boolean
verdict (accepted / dropped / block-timed-out) crosses the wire:

  * ``put`` returns False iff the remote channel rejected the item;
  * ``pop_batch(n, timeout)`` blocks up to ``timeout`` (None = forever),
    long-polling the server in short slices so a concurrent ``close()``
    always unblocks it promptly (it returns None, like a timeout);
  * after ``close()``, ``put`` returns False and ``pop_batch`` returns
    None — shutdown is a data-plane no-op, not an exception storm.

:class:`ShmChannel` speaks the identical protocol but moves large payloads
out-of-band through POSIX shared memory: the socket carries only the
segment name, the bytes never transit the TCP stack. Ownership rule:
whoever *creates* a segment unlinks it, after the consuming side has
acknowledged (the reply for requests; the next frame on the same
connection for responses).

The STREAMING data plane layers two upgrades on top:

  * :class:`PutStream` — a pipelined fire-and-forget put path with
    windowed acks: sequence-numbered ``chan.put_stream`` frames go out
    without waiting for the reply, up to ``window`` frames in flight;
    backpressure verdicts come back asynchronously and are applied to
    the stream's counters instead of blocking each flush. A dropped
    connection replays the unacked window after the redial, and the
    server dedups by ``(channel, stream, seq)`` — upgrading the
    reconnect path from at-least-once to exactly-once.
  * :class:`ShmRingChannel` — per-message SHM segments replaced by TWO
    persistent :class:`~repro_torch.runtime.transport.ring.ShmRing` segments
    per channel (client→server for streamed puts, server→client for pop
    replies): payloads cross at memcpy speed with zero per-message
    ``shm_open``/``unlink`` churn, and the server sweeps only the ring.
"""
from __future__ import annotations

import binascii
import collections
import os
import random
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.runtime.experience import ExperienceChannel
from repro_torch.runtime.transport.codec import (decode_pytree,
                                                 encode_pytree, frame_bytes,
                                                 plan_pytree, recv_frame,
                                                 send_frame)
from repro_torch.runtime.transport.ring import (RingError, RingView, ShmRing,
                                                shm_name)

try:
    from multiprocessing import shared_memory
except ImportError:  # pragma: no cover — stdlib on every target platform
    shared_memory = None

# import-gated fault injection (see transport.faults): inert — not even
# imported — unless REPRO_FAULTS is set
if os.environ.get("REPRO_FAULTS"):
    from repro_torch.runtime.transport.faults import fault_point as _fault
else:
    _fault = None

# import-gated tracing (see runtime.telemetry, same idiom): when on, the
# active trace context rides put-frame headers (``tr``/``sp``) so the
# server can join its apply span to the producer's flush span
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:
    _tel = None

POLL_S = 0.5          # per-RPC slice of a long pop/acquire wait


def _jittered(delay: float) -> float:
    """±25% jitter on a backoff delay: N workers redialing a replaced
    server spread their attempts instead of thundering-herd the listener
    in exponential lockstep."""
    return delay * (0.75 + 0.5 * random.random())

__all__ = ["TransportError", "ChannelClosed", "WireClient", "long_poll",
           "PutStream", "SocketChannel", "ShmChannel", "ShmRingChannel",
           "RingLease", "release_lease", "shm_read", "shm_write",
           "parse_address"]


class RingLease:
    """Refcounted handle over one leased pop-reply ring record.

    A zero-copy pop decodes N items whose array leaves all view the SAME
    :class:`~repro_torch.runtime.transport.ring.RingView`; each item carries
    this lease under ``"_lease"`` and the underlying view is released
    only when every item has been consumed (copied into a staging
    buffer) and released. Idempotent per item; thread-safe."""

    __slots__ = ("_view", "_refs", "_lock")

    def __init__(self, view: RingView, refs: int):
        self._view = view
        self._refs = max(int(refs), 1)
        self._lock = threading.Lock()

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            done = self._refs == 0
        if done:
            self._view.release()


def release_lease(item: Any) -> None:
    """Release ``item``'s ring lease, if it carries one (consumer-side
    helper: call AFTER the item's arrays have been copied out — the views
    die with the lease)."""
    if isinstance(item, dict):
        lease = item.pop("_lease", None)
        if lease is not None:
            lease.release()


def parse_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)``; a bare ``":port"``/``"port"``
    falls back to loopback. The one parser every CLI/config shares."""
    host, _, port = address.rpartition(":")
    return (host or "127.0.0.1", int(port))


class TransportError(RuntimeError):
    """A wire-level failure (server error, protocol violation)."""


class ChannelClosed(TransportError):
    """The connection is gone — closed locally or by the peer."""


def shm_write(data: bytes) -> "shared_memory.SharedMemory":
    """Create a shared-memory segment holding ``data`` (caller unlinks).

    Segments carry the ``acrl<pid>x…`` naming scheme so a later server
    incarnation can sweep any that a SIGKILLed creator leaked
    (:func:`repro_torch.runtime.transport.ring.sweep_stale_shm`)."""
    if shared_memory is None:
        raise TransportError("shared memory unavailable on this platform")
    while True:
        try:
            shm = shared_memory.SharedMemory(name=shm_name(), create=True,
                                             size=max(len(data), 1))
            break
        except FileExistsError:            # 32-bit token collision
            continue
    shm.buf[:len(data)] = data
    return shm


def shm_read(name: str, size: int) -> bytes:
    """Copy ``size`` bytes out of segment ``name`` (no unlink — the
    creator owns the lifetime).

    No resource-tracker compensation is needed even though attaching
    registers the name on CPython < 3.13: spawned workers INHERIT the
    parent's tracker process, so the attach registration collapses into
    the creator's (the tracker cache is a set) and the creator's unlink
    removes the single entry. A worker killed while holding segments
    leaves them to that same tracker's exit cleanup — which is the
    tracker working as intended, not a leak."""
    if shared_memory is None:
        raise TransportError("shared memory unavailable on this platform")
    shm = shared_memory.SharedMemory(name=name)
    try:
        return bytes(shm.buf[:size])
    finally:
        shm.close()


def _dial(address: Tuple[str, int], timeout: float,
          closed=lambda: False) -> socket.socket:
    """Connect with retry-until-deadline (the server may still be
    binding), then switch to blocking + NODELAY. ``closed()`` true ends
    the retries at once: a client closed while it redials a peer that is
    gone (a stopped inference tier) does not hold its caller for the
    rest of ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(address,
                                            timeout=max(timeout, 0.05))
            break
        except OSError as e:
            if time.monotonic() >= deadline or closed():
                raise TransportError(
                    f"cannot connect to transport server at "
                    f"{address}: {e}") from e
            time.sleep(0.05)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class WireClient:
    """One blocking request/response connection with a call lock.

    Each proxy object owns one connection; concurrent callers serialize on
    the lock (requests are short except deliberately-bounded long-polls).
    ``close()`` from any thread shuts the socket down, which unblocks a
    caller parked in ``recv`` with :class:`ChannelClosed`.

    With ``reconnect_attempts > 0`` the client survives a *server-side*
    connection drop: a failed round-trip redials with exponential backoff
    and re-issues the request up to that many times before surfacing
    :class:`ChannelClosed`. Retried requests are at-least-once — most
    server endpoints are either idempotent (``worker.report``,
    ``store.publish`` by version, ``store.state``) or tolerant of a
    duplicate (``chan.put``/``put_many``: a re-accepted segment is
    ordinary replay data). The exception is ``chan.pop``: if the reply is
    lost AFTER the server popped, the retry pops a fresh batch and the
    first one is gone — equivalent to a channel drop, acceptable for
    experience data (and remote pops are off the training hot path:
    remote workers produce, the trainer pops locally). ``on_reconnect``
    fires after each successful redial, under the call lock — proxies use
    it to bust version caches so state (e.g. the newest weight version)
    is re-acquired on the fresh connection.
    """

    def __init__(self, address: Tuple[str, int], *,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 reconnect_backoff_max_s: float = 2.0,
                 on_reconnect=None):
        self.address = tuple(address)
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._shm_threshold = shm_threshold
        self._reconnect_attempts = reconnect_attempts
        self._reconnect_backoff_s = reconnect_backoff_s
        self._reconnect_backoff_max_s = reconnect_backoff_max_s
        self._on_reconnect = on_reconnect
        self.reconnects = 0
        self.closed = False
        self._sock = self._dial(connect_timeout)

    def _dial(self, timeout: float) -> socket.socket:
        return _dial(self.address, timeout, lambda: self.closed)

    def raw_request(self, header: Dict, body: bytes = b"") -> Tuple[Dict,
                                                                    bytes]:
        """One UNLOCKED, no-retry round-trip on the current socket.

        Only for ``on_reconnect`` hooks, which already run under the call
        lock: a hook that needs to re-establish per-connection state
        (e.g. re-opening a ring) cannot call :meth:`request` without
        deadlocking on its own lock."""
        send_frame(self._sock, header, body)
        resp = recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("server closed during handshake")
        rh, rbody = resp
        if rh.get("err"):
            raise TransportError(rh["err"])
        return rh, rbody

    def _redial(self, attempt: int) -> bool:
        """One backoff-then-reconnect try (caller holds the lock)."""
        delay = min(self._reconnect_backoff_s * (2 ** (attempt - 1)),
                    self._reconnect_backoff_max_s)
        time.sleep(_jittered(delay))
        if self.closed:
            return False
        try:
            sock = self._dial(self._connect_timeout)
        except TransportError:
            return False
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = sock
        self.reconnects += 1
        if self._on_reconnect is not None:
            try:
                self._on_reconnect()
            except Exception:          # noqa: BLE001 — a cache-bust hook
                pass                   # must never poison the data path
        return True

    def request(self, header: Dict, body: bytes = b"", *,
                oob: bool = False) -> Tuple[Dict, bytes]:
        """One round-trip. ``oob=True`` routes a large body through shared
        memory instead of the socket (the SHM data plane)."""
        shm = None
        if (oob and shared_memory is not None
                and len(body) >= self._shm_threshold):
            shm = shm_write(body)
            header = {**header, "shm": shm.name, "shm_size": len(body)}
            body = b""
        try:
            with self._lock:
                if self.closed:
                    raise ChannelClosed("transport client is closed")
                resp = None
                last: Optional[Exception] = None
                for attempt in range(self._reconnect_attempts + 1):
                    if attempt and (self.closed or not self._redial(attempt)):
                        break
                    try:
                        if _fault is not None:
                            _fault("client.request")
                        send_frame(self._sock, header, body)
                        resp = recv_frame(self._sock)
                        if resp is None:   # clean EOF: peer closed on us
                            raise ConnectionError(
                                "server closed the connection")
                        break
                    except (OSError, ValueError) as e:
                        last = e
                        resp = None
                if resp is None:
                    self.close()
                    raise ChannelClosed(
                        f"transport connection lost: {last}") from last
            rh, rbody = resp
            if rh.get("err"):
                raise TransportError(rh["err"])
            if rh.get("shm"):          # out-of-band response body
                rbody = shm_read(rh["shm"], rh["shm_size"])
            return rh, rbody
        finally:
            if shm is not None:
                shm.close()
                try:                   # server consumed it during the RTT
                    shm.unlink()
                except FileNotFoundError:
                    pass

    def close(self) -> None:
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def long_poll(client: WireClient, make_header,
              timeout: Optional[float]) -> Optional[Tuple[Dict, bytes]]:
    """Blocking-request idiom shared by pop_batch and acquire: re-issue
    the request in bounded ``POLL_S`` slices until the server answers
    ``ok``, the deadline passes, or the client closes (→ None, so a
    concurrent ``close()`` always unblocks the caller within one slice).
    ``make_header(slice_timeout)`` builds each request; a ``timeout`` of 0
    still makes exactly one non-blocking attempt."""
    deadline = None if timeout is None else time.monotonic() + timeout
    first = True
    while not client.closed:
        remaining = (None if deadline is None
                     else deadline - time.monotonic())
        if not first and remaining is not None and remaining <= 0:
            return None
        t = (POLL_S if remaining is None
             else max(min(POLL_S, remaining), 0.0))
        first = False
        try:
            resp, body = client.request(make_header(t))
        except ChannelClosed:
            return None
        if resp.get("ok"):
            return resp, body
    return None


class PutStream:
    """Pipelined put path: fire-and-forget frames, windowed async acks.

    The synchronous ``put_many`` pays one full round-trip per flush — the
    producer idles for an RTT while the server decodes. A PutStream keeps
    up to ``window`` sequence-numbered frames in flight on a DEDICATED
    connection; a receiver thread drains the CUMULATIVE acks (the server
    replies once per ``ack_every`` frames, carrying every covered frame's
    verdicts; duplicates and ``stream.flush`` force an immediate drain)
    and applies the per-item backpressure verdicts to the stream
    counters. ``put_many`` therefore blocks only when the window is full,
    which is exactly the server falling behind — backpressure propagates
    through the window, not through per-flush latency. Frames produced
    back-to-back are additionally burst-coalesced into one ``sendall``
    (syscall + receiver wakeup dominate small frames, not bytes).

    With ``ring_bytes > 0`` the frame bodies travel through a persistent
    client→server :class:`~repro_torch.runtime.transport.ring.ShmRing` instead
    of the socket: the frame header carries only ``ring_nbytes`` and the
    encoded blob is written straight into the ring reservation
    (:func:`~repro_torch.runtime.transport.codec.plan_pytree`, no intermediate
    copy).

    **Delivery semantics.** Frames are idempotent by ``(channel, stream
    id, seq)``: after a connection drop the stream redials (up to
    ``reconnect_attempts``, exponential backoff), re-opens its state, and
    replays the unacked window in order; the server re-acks frames it
    already applied WITHOUT re-applying them — each flush lands in the
    channel exactly once across any number of mid-stream reconnects. A
    fresh ring is created per connection, so ring records and frames can
    never desynchronize across a replay.

    ``put_many`` returns provisional all-True verdicts for enqueued items
    (all-False once the stream is closed or failed); the authoritative
    accept/reject counts are in :meth:`stats` after the acks land —
    producers that care should ``flush()`` and read them.

    **Ownership (ring mode).** Like any zero-copy send API, a ring-mode
    stream borrows the items' array leaves until their frame is ACKED:
    the replay window keeps the encode *plan* (leaf references), so a
    reconnect re-serializes the arrays as they are THEN. Do not mutate
    or reuse buffers handed to a streamed ``put_many`` (rollout flushes
    allocate fresh segment arrays per episode, so this holds naturally).
    """

    def __init__(self, address: Tuple[str, int], chan: str, *,
                 window: int = 32, ring_bytes: int = 0,
                 ack_every: int = 0,
                 adaptive: bool = False,
                 connect_timeout: float = 20.0,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 reconnect_backoff_max_s: float = 2.0,
                 stream_id: Optional[str] = None):
        self.address = tuple(address)
        self.chan = chan
        self.window = max(int(window), 1)
        # cumulative acks: one reply per `ack_every` frames — a reply per
        # frame costs a receiver-thread wakeup (GIL handoff) per flush,
        # which measurably throttles the producer. 0 = auto (window/4),
        # capped at window/2 so acks always free the window in time.
        if ack_every <= 0:
            ack_every = max(self.window // 4, 1)
        self.ack_every = max(1, min(ack_every, max(self.window // 2, 1)))
        # adaptive streaming: tune the EFFECTIVE window/ack cadence online
        # from observed cumulative-ack RTT. The configured values are hard
        # BOUNDS — the effective window starts at the upper bound (steady
        # RTT therefore never throttles below static behavior), halves on
        # verdict pressure or an RTT spike vs the EWMA, and recovers
        # multiplicatively on low occupancy / settled RTT.
        self.adaptive = bool(adaptive)
        self._win_min = max(1, self.window // 8)
        self.window_effective = self.window
        self.ack_every_effective = self.ack_every
        self._ack_every_sent = self.ack_every   # what the server applies
        self._rtt_ewma = 0.0
        self.window_backoffs = 0
        self.stream_id = stream_id or binascii.hexlify(os.urandom(8)).decode()
        self._ring_bytes = int(ring_bytes)
        self._connect_timeout = connect_timeout
        self._reconnect_attempts = reconnect_attempts
        self._reconnect_backoff_s = reconnect_backoff_s
        self._reconnect_backoff_max_s = reconnect_backoff_max_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # seq -> (encoded blob, item count, trace ctx or None, time sent);
        # kept until acked so a reconnect can replay the window — the ctx
        # rides along so replayed frames keep their trace ids
        self._pending: "collections.OrderedDict[int, Tuple]" = \
            collections.OrderedDict()
        self._next_seq = 0
        self.closed = False
        self.failed: Optional[str] = None
        self._ring: Optional[ShmRing] = None
        # burst coalescing: frames produced back-to-back are shipped
        # several per sendall — the syscall + receiver wakeup, not the
        # bytes, dominate small frames (see _maybe_flush_sendbuf)
        self._sendbuf = bytearray()
        self._sendbuf_frames = 0
        self._last_append = 0.0
        self.items_enqueued = 0
        self.items_acked = 0
        self.items_accepted = 0
        self.items_rejected = 0
        self.frames_sent = 0
        self.replayed_frames = 0
        self.reconnects = 0
        self._sock = _dial(self.address, connect_timeout)
        # buffered ack reader: many small acks per recv syscall
        self._rfile = self._sock.makefile("rb")
        self._open()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"putstream-{chan}")
        self._recv_thread.start()
        self._flush_thread = threading.Thread(
            target=self._flush_loop, daemon=True,
            name=f"putstream-flush-{chan}")
        self._flush_thread.start()

    # -- connection (re)establishment -----------------------------------------
    def _open(self) -> None:
        """Handshake the stream on the current socket: announce the
        stream id (dedup key) and, in ring mode, a FRESH ring."""
        ring = None
        if self._ring_bytes:
            ring = ShmRing.create(self._ring_bytes)
        header = {"m": "stream.open", "chan": self.chan,
                  "stream": self.stream_id, "window": self.window,
                  "ack_every": self.ack_every_effective}
        self._ack_every_sent = self.ack_every_effective
        if ring is not None:
            header["ring"] = ring.name
        try:
            # bounded handshake: _open may run under the stream lock (a
            # reconnect), so a server dying mid-accept must not wedge it
            self._sock.settimeout(max(self._connect_timeout, 1.0))
            send_frame(self._sock, header)
            resp = recv_frame(self._rfile)
            if resp is None:
                raise ConnectionError("server closed during stream.open")
            if resp[0].get("err"):
                raise TransportError(resp[0]["err"])
            self._sock.settimeout(None)
        except BaseException:
            if ring is not None:
                ring.close()
                ring.unlink()
            raise
        old, self._ring = self._ring, ring
        if old is not None:
            old.close()
            old.unlink()

    def _flush_sendbuf(self) -> None:
        """Ship every coalesced frame in one sendall (caller holds the
        lock)."""
        if self._sendbuf:
            buf, self._sendbuf = self._sendbuf, bytearray()
            self._sendbuf_frames = 0
            self._sock.sendall(buf)

    def _send_frame(self, seq: int, payload, count: int,
                    ctx: Optional[Dict] = None) -> None:
        """Caller holds the lock. Ring mode writes the encoded blob
        straight into the ring reservation (``payload`` is an
        :class:`~repro_torch.runtime.transport.codec.EncodePlan`, no
        intermediate ``bytes``) and commits BEFORE the frame that
        references it goes out; socket mode carries ``payload`` bytes as
        the frame body. Frames are appended to the coalescing buffer —
        :meth:`_maybe_flush_sendbuf` / :meth:`_flush_sendbuf` ship it."""
        if _fault is not None:
            _fault("client.stream_send")
        header = {"m": "chan.put_stream", "chan": self.chan,
                  "stream": self.stream_id, "seq": seq, "count": count}
        if ctx:
            header.update(ctx)             # tr/sp trace ids ride the frame
        if self._ring is not None:
            view = self._ring.reserve(payload.nbytes, timeout=0)
            if view is None:
                # ring full: the server can only drain records whose
                # control frames it has SEEN — ship the coalescing
                # buffer before blocking, or a replay (many reserves,
                # frames all buffered) wedges against its own ring
                self._flush_sendbuf()
                view = self._ring.reserve(payload.nbytes, timeout=30.0)
            if view is None:
                raise RingError("put ring stalled (server not draining)")
            try:
                payload.write_into(view)
            finally:
                view.release()
            self._ring.commit()
            header["ring_nbytes"] = payload.nbytes
            self._sendbuf += frame_bytes(header)
            self._sendbuf_frames += 1
        elif len(payload) > (1 << 16):
            # big body: no copy into the buffer — flush and send direct
            self._flush_sendbuf()
            send_frame(self._sock, header, payload)
        else:
            self._sendbuf += frame_bytes(header, payload)
            self._sendbuf_frames += 1
        self.frames_sent += 1

    #: burst-coalescing caps: ship after this many frames or bytes. Each
    #: sendall is a syscall AND a peer wakeup (which on a busy box can
    #: preempt the producer), so bigger bursts help until the window
    #: (acks lag a full burst) or latency (one burst of staging) bind.
    COALESCE_FRAMES = 16
    COALESCE_BYTES = 1 << 17

    def _maybe_flush_sendbuf(self) -> None:
        """Burst-aware shipping (caller holds the lock): coalesce frames
        while puts arrive back-to-back (< 2 ms apart); a put after a
        pause ships immediately, so a slow producer (one episode at a
        time) never sees added latency. A burst's unshipped tail is
        bounded by :meth:`_flush_loop` (≈2 ms), a window wait,
        ``flush()``, or ``close()``."""
        now = time.monotonic()
        if (self._sendbuf_frames >= min(self.COALESCE_FRAMES, self.window)
                or len(self._sendbuf) >= self.COALESCE_BYTES
                or now - self._last_append > 0.002):
            self._flush_sendbuf()
        self._last_append = now

    def _flush_loop(self) -> None:
        """Deadline flusher: a burst's tail must not sit in the
        coalescing buffer waiting for the NEXT put — a producer that
        bursts then goes quiet (several envs flushing together, then a
        long episode) would otherwise strand committed experience
        client-side indefinitely. Idle cost is one 4 Hz poll."""
        with self._cv:
            while not self.closed:
                if not self._sendbuf:
                    self._cv.wait(timeout=0.25)
                    continue
                self._cv.wait(timeout=0.002)
                if (self._sendbuf and not self.closed
                        and time.monotonic() - self._last_append >= 0.002):
                    try:
                        self._flush_sendbuf()
                    except (OSError, ValueError):
                        pass           # the recv loop owns the redial

    # -- producer surface -----------------------------------------------------
    def put_many(self, items: List[Any]) -> List[bool]:
        """Enqueue one flush; blocks only while the ack window is full.
        Verdicts are provisional (see class docstring)."""
        items = list(items)
        if not items:
            return []
        # ring mode keeps the PLAN (schema + leaf refs) pending, not a
        # serialized copy — the bytes only ever materialize inside the
        # ring; socket mode needs real bytes for the frame body
        payload = (plan_pytree(items) if self._ring_bytes
                   else encode_pytree(items))
        # oversize is a CONFIG error (ring too small for one flush), not
        # a transport failure — surface it loudly instead of retrying
        if self._ring is not None and (payload.nbytes
                                       > self._ring.max_record()):
            raise RingError(
                f"flush of {payload.nbytes} bytes exceeds ring record "
                f"max {self._ring.max_record()}; raise ring_bytes or "
                f"flush smaller batches")
        with self._cv:
            waited = 0.0
            while (len(self._pending) >= self.window_effective
                   and not self.closed and self.failed is None):
                try:                       # acks can't arrive for frames
                    self._flush_sendbuf()  # still sitting in the buffer
                except OSError:
                    pass                   # recv loop owns the redial
                self._cv.wait(timeout=0.1)
                waited += 0.1
                if waited >= 0.5:          # defensive nudge: force a
                    self._request_acks()   # cumulative-ack drain
                    waited = 0.0
            if self.closed or self.failed is not None:
                return [False] * len(items)
            ctx = _tel.wire_ctx() if _tel is not None else None
            seq = self._next_seq
            self._next_seq += 1
            self._pending[seq] = (payload, len(items), ctx,
                                  time.monotonic())
            self.items_enqueued += len(items)
            try:
                self._send_frame(seq, payload, len(items), ctx)
                self._maybe_flush_sendbuf()
                if self._sendbuf:          # wake the deadline flusher so
                    self._cv.notify_all()  # a burst tail ships in ~2ms
            except (OSError, ValueError, RingError):
                # leave the frame pending: wake the receiver, which owns
                # the redial-and-replay path
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        return [True] * len(items)

    def put(self, item: Any) -> bool:
        return self.put_many([item])[0]

    def _request_acks(self) -> None:
        """Ask the server to drain its accumulated cumulative acks now
        (caller holds the lock; idempotent, loss-tolerant). Ships any
        coalesced frames first so the drain covers them."""
        try:
            self._flush_sendbuf()
            send_frame(self._sock, {"m": "stream.flush", "chan": self.chan,
                                    "stream": self.stream_id})
        except (OSError, ValueError):
            pass                           # the recv loop handles redials

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every in-flight frame is acked; False on timeout or
        stream failure (unacked frames remain in :meth:`stats`). Sends a
        ``stream.flush`` nudge so a tail shorter than ``ack_every`` is
        acked immediately rather than lingering."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        last_nudge = 0.0
        with self._cv:
            while (self._pending and self.failed is None
                   and not self.closed):
                now = time.monotonic()
                if now - last_nudge >= 0.2:
                    self._request_acks()
                    last_nudge = now
                remaining = (None if deadline is None
                             else deadline - now)
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(timeout=(0.05 if remaining is None
                                       else min(0.05, remaining)))
            return not self._pending

    # -- ack receiver ---------------------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            try:
                frame = recv_frame(self._rfile)
            except (OSError, ValueError):
                frame = None
            if frame is None:
                with self._cv:
                    if self.closed:
                        return
                if not self._reconnect():
                    return
                continue
            rh, _ = frame
            if rh.get("err"):
                with self._cv:
                    self.failed = str(rh["err"])
                    self._cv.notify_all()
                return
            acks = rh.get("acks")
            if not acks:
                continue                   # stream.open reply / empty drain
            with self._cv:
                now = time.monotonic()
                rtt = None
                rejected = 0
                for key, verdicts in acks.items():
                    entry = self._pending.pop(int(key), None)
                    if entry is None:
                        continue
                    count = entry[1]
                    rtt = now - entry[3]   # newest ack wins: one sample
                    verdicts = [bool(v) for v in verdicts]
                    verdicts += [False] * (count - len(verdicts))
                    accepted = sum(verdicts[:count])
                    self.items_acked += count
                    self.items_accepted += accepted
                    self.items_rejected += count - accepted
                    rejected += count - accepted
                if self.adaptive and rtt is not None:
                    self._tune(rtt, rejected)
                self._cv.notify_all()

    def _tune(self, rtt: float, rejected: int) -> None:
        """One adaptive-window step (caller holds the lock; one call per
        cumulative-ack batch). Backoff halves the effective window on
        verdict pressure (the server channel is shedding load — pushing a
        deeper pipeline at it only grows the replay window) or an RTT
        spike past 2x the EWMA (the server stopped keeping up); recovery
        is multiplicative, on low window occupancy or on RTT back at/below
        the EWMA. The server's ack cadence follows via ``stream.tune`` so
        a shrunken window still gets acks in time to free itself."""
        ewma = self._rtt_ewma
        self._rtt_ewma = rtt if ewma <= 0.0 else 0.8 * ewma + 0.2 * rtt
        eff = self.window_effective
        if rejected or (ewma > 0.0 and rtt > 2.0 * ewma):
            eff = max(self._win_min, eff // 2)
            if eff < self.window_effective:
                self.window_backoffs += 1
        elif (len(self._pending) * 2 <= eff or rtt <= self._rtt_ewma):
            eff = min(self.window, max(eff + 1, (eff * 3) // 2))
        self.window_effective = eff
        self.ack_every_effective = max(
            1, min(self.ack_every, max(eff // 2, 1)))
        if self.ack_every_effective != self._ack_every_sent:
            self._ack_every_sent = self.ack_every_effective
            try:
                self._sendbuf += frame_bytes(
                    {"m": "stream.tune", "chan": self.chan,
                     "stream": self.stream_id,
                     "ack_every": self.ack_every_effective})
                self._sendbuf_frames += 1
                self._flush_sendbuf()
            except (OSError, ValueError):
                pass                       # the recv loop owns the redial

    def _reconnect(self) -> bool:
        """Redial with backoff, re-open the stream, replay the unacked
        window in order (receiver thread only). The server dedups by
        seq, so already-applied frames are re-acked, not re-applied."""
        for attempt in range(1, self._reconnect_attempts + 1):
            time.sleep(_jittered(min(
                self._reconnect_backoff_s * (2 ** (attempt - 1)),
                self._reconnect_backoff_max_s)))
            with self._cv:
                if self.closed:
                    return False
            try:
                sock = _dial(self.address, self._connect_timeout)
            except TransportError:
                continue
            with self._cv:
                if self.closed:
                    sock.close()
                    return False
                for closer in (self._rfile.close, self._sock.close):
                    try:
                        closer()
                    except OSError:
                        pass
                self._sock = sock
                self._rfile = sock.makefile("rb")
                # frames parked in the coalescing buffer died with the
                # old socket; they are still pending, so the replay below
                # re-serializes them
                self._sendbuf = bytearray()
                self._sendbuf_frames = 0
                try:
                    self._open()
                    now = time.monotonic()
                    for seq, entry in list(self._pending.items()):
                        payload, count, ctx = entry[0], entry[1], entry[2]
                        # refresh t_sent: a replayed frame's RTT clock
                        # starts at the replay, not the original send
                        self._pending[seq] = (payload, count, ctx, now)
                        self._send_frame(seq, payload, count, ctx)
                        self.replayed_frames += 1
                    self._flush_sendbuf()
                except (OSError, ValueError, TransportError, RingError):
                    continue
                self.reconnects += 1
                self._cv.notify_all()
                return True
        with self._cv:
            if self.failed is None:
                self.failed = "connection lost (reconnect budget exhausted)"
            self._cv.notify_all()
        return False

    # -- introspection / lifecycle --------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "items_enqueued": float(self.items_enqueued),
                "items_acked": float(self.items_acked),
                "items_accepted": float(self.items_accepted),
                "items_rejected": float(self.items_rejected),
                "frames_sent": float(self.frames_sent),
                "frames_unacked": float(len(self._pending)),
                "replayed_frames": float(self.replayed_frames),
                "reconnects": float(self.reconnects),
                "window": float(self.window),
                "window_effective": float(self.window_effective),
                "ack_every_effective": float(self.ack_every_effective),
                "window_backoffs": float(self.window_backoffs),
                "rtt_ewma_s": float(self._rtt_ewma),
            }
        return out

    def close(self, flush_timeout: float = 5.0) -> None:
        """Drain the window (best effort), then tear down the connection
        and unlink the ring."""
        self.flush(flush_timeout)
        with self._cv:
            if self.closed:
                return
            self.closed = True
            self._cv.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._recv_thread.join(timeout=5.0)
        self._flush_thread.join(timeout=5.0)
        for closer in (self._rfile.close, self._sock.close):
            try:
                closer()
            except OSError:
                pass
        if self._ring is not None:
            self._ring.close()
            self._ring.unlink()


class SocketChannel(ExperienceChannel):
    """Remote ExperienceChannel proxy: TCP data plane.

    ``put_window > 0`` switches the put path from one round-trip per
    flush to a :class:`PutStream` (pipelined frames, windowed async
    acks) on a dedicated second connection — ``put``/``put_many`` then
    return provisional verdicts and the authoritative accept/reject
    counts live in ``stream_stats()``.
    """

    #: whether payload bodies travel out-of-band (overridden by ShmChannel)
    oob = False

    def __init__(self, address: Tuple[str, int], name: str, *,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 put_window: int = 0,
                 ring_bytes: int = 0,
                 adaptive_window: bool = False):
        self.name = name
        self.address = tuple(address)
        self._connect_timeout = connect_timeout
        self._reconnect_attempts = reconnect_attempts
        self._reconnect_backoff_s = reconnect_backoff_s
        self._put_window = int(put_window)
        self._ring_bytes = int(ring_bytes)
        self._adaptive_window = bool(adaptive_window)
        self._stream: Optional[PutStream] = None
        self._stream_failed_at = 0.0
        self._stream_lock = threading.Lock()
        self._client = WireClient(address, connect_timeout=connect_timeout,
                                  shm_threshold=shm_threshold,
                                  reconnect_attempts=reconnect_attempts,
                                  reconnect_backoff_s=reconnect_backoff_s,
                                  on_reconnect=self._on_wire_reconnect)

    # hooks the ring subclass overrides ---------------------------------------
    def _on_wire_reconnect(self) -> None:
        """Re-establish per-connection server state after a redial."""

    def _pop_request_extra(self) -> Dict:
        return {}

    def _pop_payload(self, resp: Dict, body: bytes) -> bytes:
        return body

    def _decode_pop(self, resp: Dict, body: bytes) -> List[Any]:
        """Decode one pop reply (hook: the ring subclass decodes straight
        out of a leased ring view when zero-copy pops are enabled)."""
        return decode_pytree(self._pop_payload(resp, body))

    # -- streaming put path ---------------------------------------------------
    def _put_stream(self) -> PutStream:
        with self._stream_lock:
            if self._stream is None:
                if self._client.closed:
                    raise ChannelClosed("transport client is closed")
                # a failed construction already ate a full dial deadline;
                # fail fast for a holdoff instead of re-paying it on
                # every flush while the server is down
                if time.monotonic() - self._stream_failed_at < 5.0:
                    raise ChannelClosed(
                        "put stream unavailable (recent dial failure)")
                try:
                    self._stream = PutStream(
                        self.address, self.name, window=self._put_window,
                        ring_bytes=self._ring_bytes,
                        adaptive=self._adaptive_window,
                        connect_timeout=self._connect_timeout,
                        reconnect_attempts=self._reconnect_attempts,
                        reconnect_backoff_s=self._reconnect_backoff_s)
                except (TransportError, OSError):
                    self._stream_failed_at = time.monotonic()
                    raise
            return self._stream

    def stream_stats(self) -> Optional[Dict[str, float]]:
        """The put stream's counters (None before the first streamed
        put): authoritative accepted/rejected once acks land."""
        with self._stream_lock:
            return None if self._stream is None else self._stream.stats()

    # -- ExperienceChannel surface -------------------------------------------
    def put(self, item: Any) -> bool:
        if self._put_window > 0:
            try:
                return self._put_stream().put(item)
            except (TransportError, OSError):
                return False
        header = {"m": "chan.put", "chan": self.name}
        if _tel is not None:
            header.update(_tel.wire_ctx())
        try:
            resp, _ = self._client.request(header, encode_pytree(item),
                                           oob=self.oob)
        except ChannelClosed:
            return False
        return bool(resp.get("ok"))

    def put_many(self, items: List[Any]) -> List[bool]:
        """Batched put: ONE codec blob + one round-trip for the whole
        flush; the server answers a per-item verdict vector from the
        hosted channel's own backpressure policy. With ``put_window``
        the flush is instead pipelined through the put stream."""
        items = list(items)
        if not items:
            return []
        if self._put_window > 0:
            try:
                return self._put_stream().put_many(items)
            except RingError:
                raise                 # config error: surface it loudly
            except (TransportError, OSError):
                return [False] * len(items)
        header = {"m": "chan.put_many", "chan": self.name,
                  "count": len(items)}
        if _tel is not None:
            header.update(_tel.wire_ctx())
        try:
            resp, _ = self._client.request(header, encode_pytree(items),
                                           oob=self.oob)
        except ChannelClosed:
            return [False] * len(items)
        verdicts = [bool(v) for v in resp.get("verdicts", ())]
        # a malformed reply must not fabricate acceptance
        verdicts += [False] * (len(items) - len(verdicts))
        return verdicts[:len(items)]

    def pop_batch(self, n: int, timeout: Optional[float] = None
                  ) -> Optional[List[Any]]:
        got = long_poll(
            self._client,
            lambda t: {"m": "chan.pop", "chan": self.name, "n": n,
                       "timeout": t, "want_shm": self.oob,
                       **self._pop_request_extra()},
            timeout)
        if got is None:
            return None
        return self._decode_pop(*got)

    def pop_many(self, max_items: int, timeout: Optional[float] = None
                 ) -> Optional[List[Any]]:
        """Coalesced drain: everything available (≤ ``max_items``) in ONE
        RPC and one codec blob — no per-item round-trips, no separate
        ``len`` probe. Blocks up to ``timeout`` only for the first item."""
        got = long_poll(
            self._client,
            lambda t: {"m": "chan.pop_many", "chan": self.name,
                       "n": max_items, "timeout": t, "want_shm": self.oob,
                       **self._pop_request_extra()},
            timeout)
        if got is None:
            return None
        return self._decode_pop(*got)

    def __len__(self) -> int:
        try:
            resp, _ = self._client.request({"m": "chan.len",
                                            "chan": self.name})
        except ChannelClosed:
            return 0
        return int(resp["len"])

    def stats(self) -> Dict[str, float]:
        try:
            resp, _ = self._client.request({"m": "chan.stats",
                                            "chan": self.name})
        except ChannelClosed:
            return {"depth": 0.0}
        return {k: float(v) for k, v in resp["stats"].items()}

    # -- lifecycle ------------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._client.closed

    def close(self) -> None:
        """Tear the connection down; a blocked ``pop_batch`` returns None
        within one poll slice, subsequent ``put``s return False."""
        with self._stream_lock:
            stream, self._stream = self._stream, None
        if stream is not None:
            stream.close()
        self._client.close()


class ShmChannel(SocketChannel):
    """SocketChannel with a shared-memory data plane for large payloads.

    The control messages (verdicts, lengths, small items under the
    threshold) still ride the socket; anything bigger moves through a
    per-message SHM segment, so segment batches and weight payloads cross
    the boundary at memcpy speed.
    """

    oob = True

    def __init__(self, address: Tuple[str, int], name: str, *,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 put_window: int = 0,
                 adaptive_window: bool = False):
        if shared_memory is None:
            raise TransportError(
                "ShmChannel needs multiprocessing.shared_memory")
        super().__init__(address, name, connect_timeout=connect_timeout,
                         shm_threshold=shm_threshold,
                         reconnect_attempts=reconnect_attempts,
                         reconnect_backoff_s=reconnect_backoff_s,
                         put_window=put_window,
                         adaptive_window=adaptive_window)


class ShmRingChannel(SocketChannel):
    """SocketChannel with a PERSISTENT shared-memory ring data plane.

    Where :class:`ShmChannel` creates/attaches/unlinks one SHM segment
    per message, this channel creates exactly TWO ring segments at
    construction and reuses them for every payload:

      * puts are always streamed (:class:`PutStream` with a
        client→server ring): encoded flushes are written straight into
        the ring reservation and the socket frames carry only
        ``(seq, ring_nbytes)``;
      * pop replies travel through a server→client ring (``want_ring``):
        the server pushes the blob and answers ``ring_nbytes``; if the
        ring is unavailable (stalled or not yet re-opened after a
        redial) the reply transparently falls back in-band.

    Rings live exactly as long as their connection: a reconnect creates
    fresh rings (the unacked put window is replayed into the new one),
    and whichever side outlives the other unlinks — the server sweeps a
    dead client's rings when the connection dies, instead of keeping an
    LRU of per-message orphan names.
    """

    oob = False    # payload never rides per-message segments here

    def __init__(self, address: Tuple[str, int], name: str, *,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 put_window: int = 32,
                 ring_bytes: int = 8 << 20,
                 adaptive_window: bool = False,
                 zero_copy_pop: bool = False):
        if shared_memory is None:
            raise TransportError(
                "ShmRingChannel needs multiprocessing.shared_memory")
        self._s2c: Optional[ShmRing] = None
        # opt-in zero-copy pops: decoded items view the ring in place and
        # carry a RingLease the CONSUMER must release after copying the
        # arrays out (the Prefetcher does, after collate). Off by
        # default: a consumer that drops items on the floor would pin the
        # ring and stall subsequent pop replies.
        self.zero_copy_pop = bool(zero_copy_pop)
        super().__init__(address, name, connect_timeout=connect_timeout,
                         shm_threshold=shm_threshold,
                         reconnect_attempts=reconnect_attempts,
                         reconnect_backoff_s=reconnect_backoff_s,
                         put_window=max(int(put_window), 1),
                         ring_bytes=int(ring_bytes),
                         adaptive_window=adaptive_window)
        self._open_pop_ring(self._client.request)

    def _open_pop_ring(self, request) -> None:
        """Create a fresh pop-reply ring and hand it to the server side
        of the CURRENT connection (``request`` is ``client.request`` at
        construction, ``client.raw_request`` from the reconnect hook)."""
        ring = ShmRing.create(self._ring_bytes)
        try:
            request({"m": "ring.open", "s2c": ring.name})
        except BaseException:
            ring.close()
            ring.unlink()
            raise
        old, self._s2c = self._s2c, ring
        if old is not None:
            old.close()
            old.unlink()

    def _on_wire_reconnect(self) -> None:
        # runs under the WireClient call lock → must use raw_request
        self._open_pop_ring(self._client.raw_request)

    def _pop_request_extra(self) -> Dict:
        return {"want_ring": True} if self._s2c is not None else {}

    def _pop_payload(self, resp: Dict, body: bytes) -> bytes:
        nbytes = resp.get("ring_nbytes")
        if nbytes is None:
            return body               # server fell back in-band
        got = self._s2c.pop(timeout=5.0)
        if got is None or len(got) != nbytes:
            raise TransportError(
                f"pop reply ring record missing/short (want {nbytes})")
        return got

    def _decode_pop(self, resp: Dict, body: bytes) -> List[Any]:
        """Zero-copy decode path: lease the pop-reply ring record in
        place, decode over the live view, and stamp each item with the
        shared :class:`RingLease`. Wraparound-split records come back
        already copied (the lease is a no-op); non-dict items cannot
        carry a lease and fall back to an owned copy."""
        nbytes = resp.get("ring_nbytes")
        if not self.zero_copy_pop or nbytes is None:
            return super()._decode_pop(resp, body)
        view = self._s2c.pop_view(timeout=5.0)
        if view is None or view.nbytes != nbytes:
            if view is not None:
                view.release()
            raise TransportError(
                f"pop reply ring record missing/short (want {nbytes})")
        if view.copied:               # split fallback: owned bytes already
            return decode_pytree(view.data)
        items = decode_pytree(view.data)
        if not items or not all(isinstance(it, dict) for it in items):
            out = decode_pytree(bytes(view.data))
            view.release()
            return out
        lease = RingLease(view, len(items))
        for item in items:
            item["_lease"] = lease
        return items

    def ring_stats(self) -> Dict[str, float]:
        return {} if self._s2c is None else self._s2c.stats()

    def close(self) -> None:
        super().close()
        if self._s2c is not None:
            self._s2c.close()
            self._s2c.unlink()
