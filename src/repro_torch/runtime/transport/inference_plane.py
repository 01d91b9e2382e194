"""Disaggregated inference plane: shared continuous batching over the wire,
as in the reference ``repro/runtime/transport/inference_plane.py`` (the
same ``infer.*`` protocol: a port client talks to a reference broker and
the reverse).

The paper's third isolation axis — inference physically decoupled from
rollouts — becomes a transport concern here. Instead of every remote
worker process hosting its own colocated
:class:`~repro_torch.runtime.inference.InferenceService` (whose eq.-1 dynamic
window only ever sees ONE worker's requests), many rollout workers submit
action requests to one shared pool that continuously batches across all
of them:

  ``RolloutWorker`` ─ submit() ─▶ :class:`RemoteInferenceClient`
        │  (unchanged: same ``submit(...) -> Future`` contract)
        ▼  ``infer.submit`` / ``infer.result`` frames
  :class:`~repro_torch.runtime.transport.server.TransportServer`
        ▼
  :class:`InferenceBroker` ─▶ shared ``InferenceService`` pool
        ▲                          │ weights / drain flag
        └── results (seq-tagged)   ▼
                         ``WeightStoreTransport`` ─▶ parent weight store

Wire protocol (PutStream-shaped: seq-numbered frames, cumulative acks,
reconnect replay):

  ``infer.open``    {client} → {ok, epoch, known_seq} — handshake; the
                    broker's ``epoch`` identifies its incarnation and
                    ``known_seq`` its dedup watermark for this client, so
                    a reconnecting client replays exactly the requests
                    the (possibly restarted) broker has never seen.
  ``infer.submit``  {client, seq} + encoded request body → {ok[, dup]} —
                    enqueue-only; a frame at-or-below the watermark is
                    re-ACKed, never re-executed (at-most-once per epoch).
  ``infer.result``  {client, ack, timeout} → {ok, base, epoch} + encoded
                    result list — long-poll delivery; ``ack`` is the
                    client's cumulative delivery index, results stay in
                    the outbox until acked so a lost reply is redelivered.

Exactly-once result delivery is the composition: the broker dedups
submits by seq within an epoch, redelivers un-acked results, and the
client resolves each pending future at most once (first delivery wins) —
so a mid-episode tier kill costs only re-execution, never a double or
dropped resolve.

Deployment shapes (``TransportConfig.inference_plane``):

  * ``"host"``  — the broker wraps the parent's own pool on the parent's
    ``TransportServer``; workers share the trainer host's accelerator.
  * ``"spawn"`` — :class:`InferencePlaneService` runs in a supervised
    child process with its OWN ``TransportServer`` (fixed port, so a
    restarted incarnation rebinds the same address and workers redial)
    and pulls weights from the parent through ``WeightStoreTransport``
    — the drain protocol rides the existing ``store.state`` poll.

**The card.** Only the pool touches it: in host mode the parent's own
pool, in spawn mode the tier's, which holds the tier process's one CUDA
context and acquires each version once, decoded onto its device
(through the parent's weight lane when there is one). The pool's results
are host values (numpy actions and log-probs, a float value), so the
broker encodes them without a device synchronisation of its own. The
client and the broker import nothing of the device: a rollout process
under ``inference="remote"`` holds the env, the codec, the channel and
this client only, and never creates a CUDA context.
"""
from __future__ import annotations

import collections
import os
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.service import Service
from repro_torch.runtime.transport.channel import (POLL_S, ChannelClosed,
                                                   TransportError, WireClient,
                                                   shared_memory)
from repro_torch.runtime.transport.codec import decode_pytree, encode_pytree
from repro_torch.runtime.transport.ring import ShmRing

# Import-gated tracing (see transport.faults for the idiom): trace ids
# ride infer.submit headers so a broker-side span joins the caller's
# trace across the process boundary.
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None

__all__ = ["InferenceBroker", "RemoteInferenceClient",
           "InferencePlaneService"]


class _ClientState:
    """Per-client stream state: submit dedup watermark + result outbox.

    Outlives any single connection (that is the point — a redialing
    client finds its watermark and un-acked results still here)."""

    __slots__ = ("last_seq", "next_idx", "outbox", "cv")

    def __init__(self):
        self.last_seq = -1                 # submit dedup watermark
        self.next_idx = 0                  # next result delivery index
        # (delivery_idx, result dict) — pruned by cumulative acks
        self.outbox: "collections.deque[Tuple[int, Dict]]" = \
            collections.deque()
        self.cv = threading.Condition()


class InferenceBroker:
    """Server-side bridge from ``infer.*`` frames to a shared pool.

    Wraps anything with the ``submit(obs_tokens, frame, step) -> Future``
    contract (the local :class:`InferenceService` in host mode, the plane
    child's own pool in spawn mode). Stateless about connections: all
    stream state is per-client and keyed by the client id, so the same
    client may redial any number of times.
    """

    def __init__(self, service: Any):
        self._service = service
        # epoch identifies THIS broker incarnation: a client that sees a
        # new epoch knows every in-flight request and ack is void
        self.epoch = uuid.uuid4().hex[:16]
        self._clients: Dict[str, _ClientState] = {}
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = collections.defaultdict(float)

    def _client(self, name: str) -> _ClientState:
        with self._lock:
            st = self._clients.get(name)
            if st is None:
                st = self._clients[name] = _ClientState()
            return st

    # -- stats -----------------------------------------------------------------
    def _inc(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._stats[key] += by

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._stats)
        out["clients"] = float(len(self._clients))
        out["outbox_depth"] = float(sum(
            len(st.outbox) for st in list(self._clients.values())))
        return out

    # -- endpoint handlers -----------------------------------------------------
    def handle_open(self, h: Dict) -> Dict:
        st = self._client(str(h["client"]))
        self._inc("opens")
        return {"ok": True, "epoch": self.epoch, "known_seq": st.last_seq}

    def handle_submit(self, h: Dict, body: bytes) -> Dict:
        st = self._client(str(h["client"]))
        seq = int(h["seq"])
        with st.cv:
            if seq <= st.last_seq:         # replayed frame: already queued
                self._inc("dup_submits")
                return {"ok": True, "dup": True}
            st.last_seq = seq
        if _tel is not None and h.get("tr") is not None:
            # joins the submitting client's trace across the wire
            _tel.instant("broker.submit", cat="inference",
                         trace=int(h["tr"]),
                         args={"client": str(h["client"]), "seq": seq},
                         flow="step")
        req = decode_pytree(body, copy=True)
        fut = self._service.submit(np.asarray(req["obs"]),
                                   None if req["frame"] is None
                                   else np.asarray(req["frame"]),
                                   int(req["step"]))
        fut.add_done_callback(
            lambda f, st=st, seq=seq: self._deliver(st, seq, f))
        self._inc("submits")
        return {"ok": True}

    def _deliver(self, st: _ClientState, seq: int, fut: Future) -> None:
        err = fut.exception()
        if err is not None:
            res: Dict = {"seq": seq, "error": f"{type(err).__name__}: {err}"}
        else:
            res = dict(fut.result())
            res["seq"] = seq
        with st.cv:
            st.outbox.append((st.next_idx, res))
            st.next_idx += 1
            st.cv.notify_all()

    def handle_result(self, h: Dict) -> Tuple[Dict, bytes]:
        st = self._client(str(h["client"]))
        ack = int(h.get("ack", 0))
        timeout = float(h.get("timeout", 0.0))
        deadline = time.monotonic() + timeout
        with st.cv:
            # cumulative ack prunes delivered results; an ack beyond what
            # this broker ever delivered is a stale-epoch client's — the
            # client resets to 0 once it sees our epoch, so just ignore it
            if ack <= st.next_idx:
                while st.outbox and st.outbox[0][0] < ack:
                    st.outbox.popleft()
                    self._inc("results_acked")
            while not st.outbox:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                st.cv.wait(remaining)
            if not st.outbox:
                return {"ok": False, "epoch": self.epoch}, b""
            base = st.outbox[0][0]
            items = [r for _, r in st.outbox]
        self._inc("results_sent", float(len(items)))
        return ({"ok": True, "base": base, "count": len(items),
                 "epoch": self.epoch}, encode_pytree(items))


class RemoteInferenceClient:
    """Client half of the inference plane: ``submit(...) -> Future`` over
    the wire, drop-in for :class:`InferenceService` in rollout workers.

    Two connections: submits ride a request/response wire (large bodies
    out-of-band via per-message SHM, like ``ShmChannel``), results arrive
    on a dedicated long-poll wire so a parked result poll never blocks a
    submit. With ``use_ring=True`` result payloads travel through a
    persistent server→client SHM ring (the ``want_ring`` data plane) —
    worthwhile for same-host workers with large action payloads.

    Replay discipline (both redial paths end at the same invariant —
    every pending seq the broker has not seen gets re-submitted):

      * submit-wire reconnect → the ``on_reconnect`` hook re-runs the
        ``infer.open`` handshake and replays pending > ``known_seq``;
      * ANY poll reply — including an empty ``ok: False`` one — carrying
        a new epoch (tier restarted and the poll wire redialed first) →
        reset the ack to 0 and re-submit every pending request through
        the submit wire (the broker's per-epoch seq dedup makes
        overlapping replays harmless). Empty polls matter: when every
        pending request was in flight at the kill, no result will ever
        arrive for the old epoch and the empty poll is the only signal.

    Futures resolve exactly once: results are popped from the pending map
    under the lock, so a redelivered result finds no future and is
    dropped (counted as ``duplicates``). ``stats()`` carries, beside the
    reference's keys, ``submitted`` (the requests this client numbered)
    and ``failed`` (futures failed: the pool stopped before serving them,
    the tier unreachable, or the client closed), so
    ``results + pending + failed == submitted``.
    """

    def __init__(self, address: Tuple[str, int], *, client_id: str,
                 connect_timeout: float = 20.0,
                 shm_threshold: int = 1 << 16,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 use_ring: bool = False,
                 ring_bytes: int = 2 << 20):
        self._id = client_id
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[bytes, Future]] = {}
        self._next_seq = 0
        self._ack = 0
        self._epoch: Optional[str] = None
        self._closed = threading.Event()
        self.replays = 0
        self.epoch_changes = 0
        self.results = 0
        self.duplicates = 0
        self.failed = 0
        self._ring: Optional[ShmRing] = None
        self._ring_bytes = int(ring_bytes)
        self._use_ring = bool(use_ring and shared_memory is not None)
        wire_kw = dict(connect_timeout=connect_timeout,
                       shm_threshold=shm_threshold,
                       reconnect_attempts=reconnect_attempts,
                       reconnect_backoff_s=reconnect_backoff_s)
        self._wire = WireClient(address, on_reconnect=self._resync,
                                **wire_kw)
        self._poll = WireClient(address, on_reconnect=self._poll_reconnect,
                                **wire_kw)
        rh, _ = self._wire.request({"m": "infer.open", "client": self._id})
        self._epoch = rh["epoch"]
        self._next_seq = int(rh.get("known_seq", -1)) + 1
        if self._use_ring:
            self._open_result_ring(self._poll.request)
        self._thread = threading.Thread(target=self._poll_loop, daemon=True,
                                        name=f"infer-client-{client_id}")
        self._thread.start()

    # -- submit path -----------------------------------------------------------
    def submit(self, obs_tokens: np.ndarray, frame: Optional[np.ndarray],
               step: int) -> Future:
        """Asynchronous request; the rollout worker suspends on the future.
        Same contract as ``InferenceService.submit``."""
        body = encode_pytree({
            "obs": np.asarray(obs_tokens),
            "frame": None if frame is None else np.asarray(frame),
            "step": int(step),
        })
        fut: Future = Future()
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._pending[seq] = (body, fut)
        # the wire lock is NOT held while registering pending (the
        # reconnect hook runs under it and takes self._lock — registering
        # first, sending after keeps the order consistent)
        header = {"m": "infer.submit", "client": self._id, "seq": seq}
        if _tel is not None:
            header.update(_tel.wire_ctx())
        try:
            self._wire.request(header, body, oob=True)
        except (TransportError, ChannelClosed) as e:
            with self._lock:
                if self._pending.pop(seq, None) is not None:
                    self.failed += 1
            if not fut.done():
                fut.set_exception(e)
        return fut

    def _resync(self) -> None:
        """Submit-wire reconnect hook (runs under the wire's call lock →
        raw_request only): re-handshake, then replay every pending seq
        the broker's watermark says it never received."""
        rh, _ = self._wire.raw_request({"m": "infer.open",
                                        "client": self._id})
        known = int(rh.get("known_seq", -1))
        with self._lock:
            if rh["epoch"] != self._epoch:
                self._epoch = rh["epoch"]
                self._ack = 0
                self.epoch_changes += 1
            replay = sorted((s, b) for s, (b, _f) in self._pending.items()
                            if s > known)
        for seq, body in replay:
            self._wire.raw_request({"m": "infer.submit", "client": self._id,
                                    "seq": seq}, body)
            self.replays += 1

    # -- result path -----------------------------------------------------------
    def _open_result_ring(self, request) -> None:
        ring = ShmRing.create(self._ring_bytes)
        try:
            request({"m": "ring.open", "s2c": ring.name})
        except BaseException:
            ring.close()
            ring.unlink()
            raise
        old, self._ring = self._ring, ring
        if old is not None:
            old.close()
            old.unlink()

    def _poll_reconnect(self) -> None:
        # fresh connection → the server side lost its ring attachment;
        # hand it a fresh one (raw_request: we are under the call lock)
        if self._use_ring:
            self._open_result_ring(self._poll.raw_request)

    def _result_header(self, slice_timeout: float) -> Dict:
        h = {"m": "infer.result", "client": self._id, "ack": self._ack,
             "timeout": slice_timeout}
        if self._ring is not None:
            h["want_ring"] = True
        return h

    def _poll_loop(self) -> None:
        # NOT the shared long_poll idiom: that helper discards ok:False
        # replies, and an EMPTY poll against a restarted tier is the only
        # epoch-change signal when every pending request was in flight at
        # the kill (the old results died with the old broker, and rollout
        # workers parked on those futures submit nothing new — so nothing
        # else would ever trigger the replay).
        while not self._closed.is_set():
            try:
                resp, body = self._poll.request(self._result_header(POLL_S))
            except (TransportError, ChannelClosed):
                if self._poll.closed and not self._closed.is_set():
                    # redial budget exhausted — fail fast so rollout
                    # workers are not parked on futures that cannot resolve
                    self._fail_pending(ChannelClosed(
                        "inference plane unreachable"))
                    return
                time.sleep(0.05)
                continue
            self._check_epoch(str(resp["epoch"]))
            if not resp.get("ok"):
                continue
            if resp.get("ring_nbytes") is not None:
                body = self._ring.pop(timeout=5.0)
                if body is None or len(body) != resp["ring_nbytes"]:
                    continue               # torn ring record: redelivered
            self._consume(resp, decode_pytree(body, copy=True))

    def _check_epoch(self, epoch: str) -> None:
        """A reply carrying an unfamiliar epoch means the tier restarted:
        void the ack (delivery indices reset with the broker) and
        re-submit everything still pending (per-epoch seq dedup on the
        broker makes overlapping replays harmless)."""
        with self._lock:
            if epoch == self._epoch:
                return
            self._epoch = epoch
            self._ack = 0
            self.epoch_changes += 1
            replay = sorted((s, b) for s, (b, _f) in self._pending.items())
        for seq, body in replay:
            try:
                self._wire.request({"m": "infer.submit",
                                    "client": self._id, "seq": seq}, body,
                                   oob=True)
                self.replays += 1
            except (TransportError, ChannelClosed):
                return                      # the submit wire's own hook
                                            # will retry on its next redial

    def _consume(self, resp: Dict, items: List[Dict]) -> None:
        with self._lock:
            futs = []
            for i, item in enumerate(items):
                item = dict(item)
                seq = int(item.pop("seq"))
                got = self._pending.pop(seq, None)
                if got is not None:
                    futs.append((got[1], item))
                else:
                    self.duplicates += 1
                self._ack = max(self._ack, int(resp["base"]) + i + 1)
        for fut, item in futs:              # resolve outside the lock
            if fut.done():
                continue
            if "error" in item:
                fut.set_exception(TransportError(item["error"]))
                with self._lock:
                    self.failed += 1
            else:
                fut.set_result(item)
                self.results += 1

    def _fail_pending(self, err: Exception) -> None:
        with self._lock:
            pending, self._pending = list(self._pending.values()), {}
            self.failed += len(pending)
        for _body, fut in pending:
            if not fut.done():
                fut.set_exception(err)

    # -- introspection ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            pending = len(self._pending)
            submitted = self._next_seq
        return {"pending": float(pending), "submitted": float(submitted),
                "failed": float(self.failed),
                "duplicates": float(self.duplicates),
                "replays": float(self.replays),
                "epoch_changes": float(self.epoch_changes),
                "results": float(self.results),
                "reconnects": float(self._wire.reconnects
                                    + self._poll.reconnects)}

    def close(self) -> None:
        self._closed.set()
        self._wire.close()
        self._poll.close()                 # unblocks the parked long-poll
        self._thread.join(timeout=5.0)
        self._fail_pending(ChannelClosed("inference client closed"))
        if self._ring is not None:
            self._ring.close()
            self._ring.unlink()
            self._ring = None


class InferencePlaneService(Service):
    """The spawn-mode inference tier: a shared pool + broker behind its
    own ``TransportServer``, pulling weights from the parent store.

    Binds its listener at CONSTRUCTION (like ``TransportServer``), so a
    supervised restart of the same spec rebinds the same fixed port and
    workers redial transparently. The service thread bridges the pool's
    autoscaling gauges (queue depth, window fill) and the broker's stream
    counters into this service's registry — in spawn mode that registry
    is what ``worker.report`` ships to the parent, which is how
    ``ElasticPolicy`` sees the shared tier's pressure.

    The pool serves on ``device``; every acquire decodes the version
    there (``use_lane``: read from the parent's weight lane) and its
    seconds land in the pool's registry (``weight_acquire_s``,
    ``weight_acquire_s_v<version>``).
    """

    def __init__(self, cfg, rt, parent_address: Tuple[str, int], *,
                 listen: Tuple[str, int] = ("127.0.0.1", 0),
                 temperature: float = 1.0, seed: int = 0,
                 use_shm: bool = False, shm_threshold: int = 1 << 16,
                 connect_timeout: float = 20.0,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 0.1,
                 token: str = "", use_lane: bool = False, device="cuda"):
        super().__init__("inference-plane", role="inference")
        from repro_torch.runtime.inference import InferenceService
        from repro_torch.runtime.transport.server import TransportServer
        from repro_torch.runtime.transport.weights import WeightStoreTransport
        self.store = WeightStoreTransport(
            parent_address, use_shm=use_shm, shm_threshold=shm_threshold,
            connect_timeout=connect_timeout,
            reconnect_attempts=reconnect_attempts,
            reconnect_backoff_s=reconnect_backoff_s, use_lane=use_lane,
            device=device)
        self.pool = InferenceService(cfg, self.store, rt,
                                     temperature=temperature, seed=seed,
                                     device=device)
        self.store.metrics = self.pool.metrics
        self.server = TransportServer(host=listen[0], port=listen[1],
                                      shm_threshold=shm_threshold,
                                      name="infer-wire", token=token)
        self.broker = InferenceBroker(self.pool)
        self.server.set_inference(self.broker)
        self.address: Tuple[str, int] = self.server.address

    # -- service surface -------------------------------------------------------
    def on_start(self) -> None:
        self.pool.start()
        self.server.start()

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            snap = self.pool.metrics.snapshot()
            for key in ("queue_depth", "window_fill", "weight_version"):
                if key in snap["gauges"]:
                    self.metrics.set_gauge(key, snap["gauges"][key])
            for key, val in self.broker.stats().items():
                self.metrics.set_gauge(f"broker_{key}", val)

    def on_stop(self) -> None:
        self.server.stop()
        self.pool.stop()
        self.server.join(timeout=5.0)
        self.pool.join(timeout=5.0)
        self.store.close()

    def utilization(self) -> float:
        return self.pool.utilization()
