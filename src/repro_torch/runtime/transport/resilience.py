"""Resilient control plane: journaled TransportServer state + recovery, as
in the reference ``repro/runtime/transport/resilience.py``, in its file
format: a journal of numpy items is byte for byte the reference's, and
each package recovers the other's journal.

Workers are disposable (restart budgets, redial-to-rejoin, exactly-once
stream replay), but without a journal the parent ``TransportServer``
would be a single point of failure: its death loses every hosted
channel, the weight store, and all per-stream dedup watermarks. This
module removes that: a write-ahead **journal** records every state
mutation the server hosts, periodic **compacting snapshots** bound replay
time, and a replacement server (``resume_journal``) recovers to the last
committed record — so an in-flight
:class:`~repro_torch.runtime.transport.channel.PutStream` window replays
exactly-once across a server *death*, not just a connection drop.

**Weights on the card.** :meth:`TransportJournal.note_publish` receives
the published tree, on the trainer's device: a tree of CUDA tensors is
encoded through the codec's one pass of copies into one pinned buffer
(``codec._host_leaves``), not leaf by leaf, with bf16 carried as its
bits. :meth:`RecoveredState.store_params` decodes the newest publish onto
``device`` (the card unless the caller asks for the CPU), bit for bit.

**Large publishes** (unlike the reference, which writes every publish as
one record and so cannot journal a tree past ``MAX_RECORD``): a blob over
``PUBLISH_PIECE`` bytes is journaled as ``publish_part`` records of at
most that size, written one by one, each holding the journal lock only
for its own write — a reply flush waits for one piece, never for the
encode or the whole tree. :func:`recover` reassembles a version whose
parts all arrived in order; an interrupted one is ignored, as a torn
record is. A blob of ``PUBLISH_PIECE`` or less is the reference's one
``publish`` record, byte for byte; the reference's ``recover`` skips
``publish_part`` records (it ignores ops it does not know). No record
over ``MAX_RECORD`` is ever written: :func:`_record_head` raises.

File format (``<dir>/log-<gen>.bin`` + ``snap-<gen>.bin``, both starting
with the 8-byte magic)::

    record := u32 payload_len | u32 crc32(payload) | payload
    payload := u32 header_len | header_json | body

``header_json`` carries ``{"op": ..., ...}``; ``body`` is an opaque codec
blob. Appends **group-commit**: records accumulate in a pending buffer
and are written — one ``write(2)`` for the whole batch — at every commit
point: before any wire reply or cumulative stream ack leaves the server,
after a journaled pop hands items to a local consumer, on weight
publishes, and on an idle-tick timer. Between commit points nothing
external depends on a buffered record, so a crash loses only frames
whose ack never left — which the producer replays. The page cache is
the durability domain: it survives a SIGKILLed *process*, which is the
failure this journal defends — machine-level durability would need
``fsync`` per commit and is deliberately out of scope (snapshots DO
fsync). A torn final record (crc or length mismatch) marks the end of
the committed prefix and is discarded on recovery.

Journaled operations and their replay semantics:

  ============  ===========================================================
  ``chan_meta``  declares a channel's capacity + backpressure policy so
                 replay can emulate evictions
  ``put``        the ACCEPTED items of one flush (rejected items never
                 enter the journal); replay appends and applies
                 ``drop_oldest`` eviction at capacity. A streamed flush
                 FUSES its dedup watermark into the same record
                 (``stream``/``seq``/``verdicts`` header keys): one
                 append per frame, and items + watermark are atomic by
                 construction — a crash can never recover the items
                 without the watermark that dedups their replay
  ``pop``        ``n`` items left the front of the channel
  ``stream``     a put-stream dedup watermark ``(chan, stream, seq)``
                 + its verdicts alone (streamed frames into channels the
                 journal does not wrap) — replay keeps the max seq
                 (idempotent)
  ``stream_snap``  a full stream-state capture (snapshot compaction)
  ``publish``    a weight-store publish: version + encoded params blob
                 — replay keeps the newest version (idempotent)
  ``publish_part``  one piece of a publish over ``PUBLISH_PIECE``
                 (``version``, ``part``, ``parts``, ``bytes``); replay
                 applies the version once its last part lands in order
  ``snap_end``   snapshot validity marker (a snapshot without one is an
                 interrupted compaction and is ignored)
  ============  ===========================================================

**Write ordering.** Every mutation is *apply-then-append* under a
per-channel wrapper lock (:class:`JournaledChannel`), so the journal
never claims an op the in-memory state has not performed. The one
crash window this leaves — applied but not yet journaled, then SIGKILL —
is healed by the data path itself: the producer never received an ack
for that frame, so it replays it to the replacement server, whose
recovered watermark does not cover it, and it is applied exactly once.
Wire pops are at-most-once across a server death (a reply lost after the
journal append loses that batch — equivalent to a channel drop, which
experience data tolerates by design).

**Compaction.** ``compact()`` takes every channel wrapper lock (sorted
order — the global lock order is ``stream lock < channel wrapper lock <
journal lock``), rotates to a fresh log generation, captures channel
contents while still holding the locks (so no put/pop can straddle the
rotation), then captures stream/store state *after* the rotation —
those records are idempotent, so one landing in the soon-deleted old log
is covered by the later capture. The snapshot is written to a temp file,
fsynced, renamed, and only then are older generations deleted — a crash
at any point leaves a recoverable chain (``snap-g`` + ``log-g`` +
``log-g+1``…).

Also exported here, as the reference does: the ``acrl<pid>x<token>`` SHM
naming scheme and :func:`sweep_stale_shm` (the port keeps both in
``transport/ring.py``), which a starting server runs to unlink segments
and rings leaked by a SIGKILLed previous incarnation (only names whose
creator pid is dead are touched, so concurrent runs on one host are
safe).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.runtime.transport.codec import decode_pytree, encode_pytree
from repro_torch.runtime.transport.ring import (SHM_NAME_PREFIX, shm_name,
                                                sweep_stale_shm)

__all__ = ["JOURNAL_MAGIC", "MAX_RECORD", "PUBLISH_PIECE",
           "TransportJournal", "JournaledChannel", "RecoveredState",
           "read_records", "recover", "shm_name", "sweep_stale_shm",
           "SHM_NAME_PREFIX"]

JOURNAL_MAGIC = b"ACRLJRN1"
_REC = struct.Struct("<II")                    # payload_len, crc32
_HLEN = struct.Struct("<I")                    # header_json length
_GEN_RE = re.compile(r"^(log|snap)-(\d{8})\.bin$")

#: hard ceiling on one record's payload: recovery reads a longer one as
#: corruption (a torn tail), so no record past it is ever written
MAX_RECORD = 1 << 31

#: a publish blob over this many bytes is journaled in pieces of at most
#: this size (``publish_part``)
PUBLISH_PIECE = 64 << 20


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

def _payload_head(op: str, header: Optional[Dict], nbytes: int) -> bytes:
    """The payload's header bytes (its length, then its JSON) for a body
    of ``nbytes``. Raises ``ValueError`` for a payload over
    ``MAX_RECORD``, which recovery could not read back."""
    hdr = dict(header or ())
    hdr["op"] = op
    hjson = json.dumps(hdr, separators=(",", ":")).encode()
    head = _HLEN.pack(len(hjson)) + hjson
    if len(head) + nbytes > MAX_RECORD:
        raise ValueError(
            f"journal record {op!r} of {len(head) + nbytes} bytes exceeds "
            f"MAX_RECORD ({MAX_RECORD}): recovery would read it as a torn "
            f"tail")
    return head


def _record_head(op: str, header: Optional[Dict], body) -> bytes:
    """The bytes of one record that precede its ``body`` (length, crc,
    header). The crc runs over the header, then the body in place: a
    large body is never copied to be framed."""
    nbytes = memoryview(body).nbytes
    head = _payload_head(op, header, nbytes)
    return (_REC.pack(len(head) + nbytes,
                      zlib.crc32(body, zlib.crc32(head))) + head)


def _record_bytes(op: str, header: Optional[Dict] = None,
                  body: bytes = b"") -> bytes:
    return _record_head(op, header, body) + body


def _write_all(f, *bufs) -> int:
    """Write every buffer in full to the unbuffered file ``f``."""
    n = 0
    for buf in bufs:
        view = memoryview(buf).cast("B")
        while view:
            k = f.write(view)
            view = view[k:]
            n += k
    return n


def _publish_records(version: int, blob) -> List[Tuple[str, Dict, Any]]:
    """The records of one publish: the reference's single ``publish``
    record, or ``publish_part`` pieces of a blob over ``PUBLISH_PIECE``
    (views into ``blob``, not copies)."""
    n = len(blob)
    if n <= PUBLISH_PIECE:
        return [("publish", {"version": version}, blob)]
    view = memoryview(blob)
    parts = -(-n // PUBLISH_PIECE)
    return [("publish_part", {"version": version, "part": i, "parts": parts,
                              "bytes": n},
             view[i * PUBLISH_PIECE:(i + 1) * PUBLISH_PIECE])
            for i in range(parts)]


def read_records(path: pathlib.Path
                 ) -> Tuple[List[Tuple[Dict, memoryview]], bool, int]:
    """Parse one journal/snapshot file. Returns ``(records, torn,
    valid_bytes)`` — ``torn`` is True iff the file ends in a partial or
    corrupt record; ``valid_bytes`` is the length of the committed prefix
    (magic included), i.e. where an append may safely continue. Bodies
    are views into the file's bytes, not copies."""
    data = memoryview(path.read_bytes())
    if len(data) < len(JOURNAL_MAGIC) or \
            data[:len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        return [], bool(data), 0
    records: List[Tuple[Dict, memoryview]] = []
    off = len(JOURNAL_MAGIC)
    while off < len(data):
        if off + _REC.size > len(data):
            return records, True, off
        plen, crc = _REC.unpack_from(data, off)
        start, end = off + _REC.size, off + _REC.size + plen
        if plen < _HLEN.size or plen > MAX_RECORD or end > len(data):
            return records, True, off
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            return records, True, off
        hlen, = _HLEN.unpack_from(payload, 0)
        if _HLEN.size + hlen > plen:
            return records, True, off
        try:
            hdr = json.loads(bytes(payload[_HLEN.size:_HLEN.size + hlen]))
        except ValueError:
            return records, True, off
        records.append((hdr, payload[_HLEN.size + hlen:]))
        off = end
    return records, False, off


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def _scan_generations(directory: pathlib.Path) -> Dict[str, List[int]]:
    gens: Dict[str, List[int]] = {"log": [], "snap": []}
    if directory.is_dir():
        for p in directory.iterdir():
            m = _GEN_RE.match(p.name)
            if m:
                gens[m.group(1)].append(int(m.group(2)))
    gens["log"].sort()
    gens["snap"].sort()
    return gens


class TransportJournal:
    """Sequenced append log + compacting snapshots for hosted state.

    Thread-safe: appends serialize on an internal lock; channel mutations
    additionally serialize apply-then-append on their
    :class:`JournaledChannel` wrapper lock. ``resume=True`` continues an
    existing directory (truncating a torn tail before appending);
    ``resume=False`` on a non-empty journal directory raises rather than
    silently shadowing recoverable state."""

    def __init__(self, directory, *, compact_bytes: int = 64 << 20,
                 resume: bool = False):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.compact_bytes = int(compact_bytes)
        self._lock = threading.Lock()
        self._compact_lock = threading.Lock()
        self._pub_lock = threading.Lock()
        # one publish's pieces at a time, so they lie in order in the log
        self._pub_write_lock = threading.Lock()
        self._channels: Dict[str, "JournaledChannel"] = {}
        self._last_publish: Optional[Tuple[int, bytes]] = None
        self._pending = bytearray()
        self.records_appended = 0
        self.flushes = 0
        self.compactions = 0
        self.torn_truncated = 0
        self.closed = False
        gens = _scan_generations(self.directory)
        existing = gens["log"] or gens["snap"]
        if existing and not resume:
            raise ValueError(
                f"journal directory {self.directory} already holds "
                f"state (gen {max(gens['log'] + gens['snap'])}); pass "
                f"resume=True (resume_journal) to continue it, or "
                f"point journal_dir at a fresh directory")
        self.gen = max(gens["log"] + gens["snap"], default=0)
        self._file: Optional[Any] = None
        self._log_bytes = 0
        self._open_log(self.gen, fresh=not existing)

    # -- file plumbing --------------------------------------------------------
    def _log_path(self, gen: int) -> pathlib.Path:
        return self.directory / f"log-{gen:08d}.bin"

    def _snap_path(self, gen: int) -> pathlib.Path:
        return self.directory / f"snap-{gen:08d}.bin"

    def _open_log(self, gen: int, *, fresh: bool) -> None:
        """Open ``log-<gen>`` for appending (caller holds ``_lock`` or is
        ``__init__``). An existing log is truncated to its committed
        prefix first — appending after a torn tail would hide every
        record that follows it from recovery."""
        path = self._log_path(gen)
        if not fresh and path.exists():
            _, torn, keep = read_records(path)
            if torn:
                with path.open("r+b") as f:
                    f.truncate(keep)
                self.torn_truncated += 1
            f = path.open("ab", buffering=0)
            if keep == 0:                  # empty/garbage file: re-magic
                f.write(JOURNAL_MAGIC)
            self._log_bytes = max(keep, len(JOURNAL_MAGIC))
        else:
            f = path.open("wb", buffering=0)
            f.write(JOURNAL_MAGIC)
            self._log_bytes = len(JOURNAL_MAGIC)
        self._file = f

    #: a pending buffer past this size is flushed inline by ``append``
    #: (bounds group-commit memory under a burst with no ack boundary)
    FLUSH_BYTES = 1 << 20

    # -- append path ----------------------------------------------------------
    def append(self, op: str, header: Optional[Dict] = None,
               body: bytes = b"") -> None:
        """Append one record to the pending group-commit buffer.

        Records hit the file (page cache — the durability domain, see
        module docstring) at the next :meth:`flush`, which callers make
        at every COMMIT POINT: before a wire reply or stream ack leaves
        the server, and after a journaled pop hands items to a local
        consumer. Between commit points nothing external depends on the
        buffered records — a crash loses only frames whose ack never
        left (the producer replays them) — so a windowed-ack stream
        pays one ``write(2)`` per ack batch, not per frame. Raises
        ``ValueError`` for a record over ``MAX_RECORD``."""
        rec = _record_bytes(op, header, body)
        with self._lock:
            if self._file is None:
                return                     # closed — shutdown race, drop
            self._pending += rec
            self._log_bytes += len(rec)
            self.records_appended += 1
            if len(self._pending) >= self.FLUSH_BYTES:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._pending and self._file is not None:
            self._file.write(self._pending)
            self._pending = bytearray()
            self.flushes += 1

    def flush(self) -> None:
        """Write the pending buffer: the group-commit boundary."""
        with self._lock:
            self._flush_locked()

    def note_publish(self, params: Any, version: int) -> None:
        """Journal a weight-store publish (the store's ``on_publish``
        hook): the encoded blob is both the journal body and the cached
        newest-version state a snapshot captures. A tree of CUDA tensors
        crosses to the host in one pinned pass (``encode_pytree``).

        Publishes are rare commit points: the pending buffer is written
        first, then each record of the publish straight from the blob
        (no copy into the buffer). The encode and every crc run outside
        the journal lock, and the lock is released between pieces, so a
        reply flush waits for at most one ``PUBLISH_PIECE`` write."""
        version = int(version)
        blob = encode_pytree(params)
        with self._pub_lock:
            cur = self._last_publish
            if cur is None or version >= cur[0]:
                self._last_publish = (version, blob)
        with self._pub_write_lock:
            for op, hdr, body in _publish_records(version, blob):
                head = _record_head(op, hdr, body)
                with self._lock:
                    if self._file is None:
                        return             # closed — shutdown race, drop
                    self._flush_locked()
                    self._log_bytes += _write_all(self._file, head, body)
                    self.records_appended += 1
                    self.flushes += 1

    def attach_store(self, store) -> None:
        """Install :meth:`note_publish` as ``store.on_publish``."""
        store.on_publish = self.note_publish

    # -- channel registration -------------------------------------------------
    def wrap(self, name: str, inner) -> "JournaledChannel":
        """Wrap ``inner`` (a FIFO-style channel) so every accepted put
        and every pop is journaled under ``name``."""
        chan = JournaledChannel(inner, self, name)
        self._channels[name] = chan
        return chan

    # -- size / compaction ----------------------------------------------------
    @property
    def log_bytes(self) -> int:
        with self._lock:
            return self._log_bytes

    def should_compact(self) -> bool:
        return not self.closed and self.log_bytes >= self.compact_bytes

    def compact(self, extra_records_fn: Optional[
            Callable[[], Iterable[Tuple[str, Dict, bytes]]]] = None) -> int:
        """Rotate the log and write a snapshot of current state (channel
        contents under their wrapper locks; stream/store records from
        ``extra_records_fn``, captured post-rotation — idempotent, see
        module docstring). Returns the new generation."""
        with self._compact_lock:
            chans = sorted(self._channels.items())
            for _, c in chans:
                c.journal_lock.acquire()
            try:
                with self._lock:
                    if self._file is None:
                        return self.gen
                    self._flush_locked()
                    self.gen += 1
                    gen = self.gen
                    self._file.close()
                    self._open_log(gen, fresh=True)
                records: List[Tuple[str, Dict, bytes]] = []
                for name, c in chans:
                    records.append(("chan_meta",
                                    {"chan": name, "capacity": c.capacity,
                                     "policy": c.policy}, b""))
                    items = c.peek_all()
                    if items:
                        records.append(("put",
                                        {"chan": name, "count": len(items)},
                                        encode_pytree(items)))
            finally:
                for _, c in chans:
                    c.journal_lock.release()
            if extra_records_fn is not None:
                records.extend(extra_records_fn())
            with self._pub_lock:
                lp = self._last_publish
            if lp is not None:
                records.extend(_publish_records(*lp))
            tmp = self._snap_path(gen).with_suffix(".tmp")
            with tmp.open("wb", buffering=0) as f:
                f.write(JOURNAL_MAGIC)
                for op, hdr, body in records:
                    _write_all(f, _record_head(op, hdr, body), body)
                f.write(_record_bytes("snap_end", {}))
                f.flush()
                os.fsync(f.fileno())
            tmp.rename(self._snap_path(gen))
            # only after the rename is the old chain redundant
            for p in list(self.directory.iterdir()):
                m = _GEN_RE.match(p.name)
                if m and int(m.group(2)) < gen:
                    try:
                        p.unlink()
                    except OSError:
                        pass
            self.compactions += 1
            return gen

    def stats(self) -> Dict[str, float]:
        return {"journal_gen": float(self.gen),
                "journal_log_bytes": float(self.log_bytes),
                "journal_records": float(self.records_appended),
                "journal_flushes": float(self.flushes),
                "journal_compactions": float(self.compactions),
                "journal_torn_truncated": float(self.torn_truncated)}

    def close(self) -> None:
        with self._lock:
            self.closed = True
            if self._file is not None:
                self._flush_locked()
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# the journaled channel wrapper
# ---------------------------------------------------------------------------

class JournaledChannel:
    """Wraps a FIFO-style channel so {mutate, journal} is atomic.

    Blocking surface ops (``pop_batch``/``pop_many`` with a timeout) are
    re-expressed as polling loops of non-blocking inner ops, so the
    wrapper lock is never held across a wait — a blocked consumer can
    never deadlock a producer (or a compaction) out of the lock.

    The ``block`` backpressure policy is rejected at wrap time: its puts
    park *inside* the inner buffer waiting for pops, which cannot be made
    atomic with the journal append without serializing producers against
    consumers. The journaled channels (the experience
    plane) default to ``drop_oldest``.
    """

    #: poll granularity for the blocking pop surface
    POLL_S = 0.002

    def __init__(self, inner, journal: TransportJournal, name: str):
        if getattr(inner, "policy", None) == "block":
            raise ValueError(
                "JournaledChannel does not support the 'block' "
                "backpressure policy (its puts wait inside the buffer; "
                "journal atomicity would serialize producers against "
                "consumers) — use drop_oldest/drop_newest")
        if not hasattr(inner, "peek_all"):
            raise TypeError(f"{type(inner).__name__} has no peek_all(); "
                            f"snapshots need a non-destructive capture")
        self.inner = inner
        self.journal = journal
        self.name = name
        # RLock: compact() holds it while calling peek_all()
        self.journal_lock = threading.RLock()
        journal.append("chan_meta", {"chan": name,
                                     "capacity": self.capacity,
                                     "policy": self.policy})

    # -- metadata delegation --------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(getattr(self.inner, "capacity", 0))

    @property
    def policy(self) -> str:
        return str(getattr(self.inner, "policy", "drop_oldest"))

    @property
    def total_pushed(self) -> int:
        return int(getattr(self.inner, "total_pushed", 0))

    @property
    def total_dropped(self) -> int:
        return int(getattr(self.inner, "total_dropped", 0))

    # -- producer surface -----------------------------------------------------
    def put(self, item: Any) -> bool:
        return self.put_many([item])[0]

    def put_many(self, items: List[Any], *,
                 encoded: Optional[bytes] = None,
                 stream_meta: Optional[Dict] = None) -> List[bool]:
        """Apply-then-append under the wrapper lock. ``encoded`` is the
        already-encoded blob of ``items`` when the caller has one (the
        server's put path received it on the wire) — reused verbatim iff
        every item was accepted, so the streaming hot path never pays a
        second encode. ``stream_meta`` (``{"stream", "seq", "window",
        "ack_every"}``) fuses the flush's dedup watermark into the SAME
        record — one append per streamed frame, and a recovered server
        can never hold the items without the watermark that dedups
        their replay (the verdicts are filled in here)."""
        items = list(items)
        if not items:
            return []
        # encoded before anything is applied, so a flush too large to
        # journal is refused whole (ValueError) rather than held in
        # memory unjournaled
        full = encoded if encoded is not None else encode_pytree(items)
        _payload_head("put", {"chan": self.name, "count": len(items),
                              **(stream_meta or {}),
                              "verdicts": [False] * len(items)},
                      memoryview(full).nbytes)
        with self.journal_lock:
            verdicts = [bool(v) for v in self.inner.put_many(items)]
            accepted = [it for it, v in zip(items, verdicts) if v]
            if accepted or stream_meta is not None:
                hdr = {"chan": self.name, "count": len(accepted)}
                if stream_meta is not None:
                    hdr.update(stream_meta)
                    hdr["verdicts"] = verdicts
                blob = b"" if not accepted else (
                    full if all(verdicts) else encode_pytree(accepted))
                self.journal.append("put", hdr, blob)
        return verdicts

    def put_many_encoded(self, items: List[Any], body: bytes,
                         stream_meta: Optional[Dict] = None) -> List[bool]:
        """The server dispatch's entry: items + their wire encoding."""
        return self.put_many(items, encoded=body, stream_meta=stream_meta)

    # -- consumer surface -----------------------------------------------------
    def _journaled_take(self, take: Callable[[], Optional[List[Any]]],
                        timeout: Optional[float]) -> Optional[List[Any]]:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self.journal_lock:
                got = take()
                if got:
                    self.journal.append("pop", {"chan": self.name,
                                                "n": len(got)})
                    # handing items to a local consumer is a commit
                    # point: flush so a crash cannot resurrect them
                    # (pops are coalesced, so this write is rare)
                    self.journal.flush()
                    return got
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.POLL_S)

    def pop_batch(self, n: int, timeout: Optional[float] = None
                  ) -> Optional[List[Any]]:
        return self._journaled_take(
            lambda: self.inner.pop_batch(n, timeout=0), timeout)

    def pop_many(self, max_items: int, timeout: Optional[float] = None
                 ) -> Optional[List[Any]]:
        return self._journaled_take(
            lambda: self.inner.pop_many(max_items, timeout=0), timeout)

    def drain(self) -> List[Any]:
        with self.journal_lock:
            got = self.inner.drain()
            if got:
                self.journal.append("pop", {"chan": self.name,
                                            "n": len(got)})
                self.journal.flush()
            return got

    # -- snapshot/restore -----------------------------------------------------
    def peek_all(self) -> List[Any]:
        with self.journal_lock:
            return self.inner.peek_all()

    def restore(self, items: List[Any]) -> int:
        """Refill the inner channel WITHOUT journaling: the items came
        *from* the journal, so they are already represented in the chain
        recovery replays."""
        accepted = 0
        for item in items:
            accepted += bool(self.inner.put(item))
        return accepted

    # -- passthrough ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.inner)

    def stats(self) -> Dict[str, float]:
        out = dict(self.inner.stats())
        out["journaled"] = 1.0
        return out


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveredState:
    """What a journal chain replays to: channel contents, stream dedup
    watermarks, and the newest weight-store version."""

    channels: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    streams: Dict[Tuple[str, str], Dict] = dataclasses.field(
        default_factory=dict)
    store: Optional[Tuple[int, bytes]] = None
    base_gen: int = 0
    records: int = 0
    torn_tail: bool = False
    puts: int = 0
    pops: int = 0
    items_in: int = 0
    items_out: int = 0
    # the publish being reassembled from its ``publish_part`` records:
    # [version, next part, parts, buffer, bytes filled]
    _partial: Optional[List] = dataclasses.field(default=None, repr=False)

    def channel_items(self, name: str) -> List[Any]:
        return self.channels.get(name, {}).get("items", [])

    def store_params(self, device="cuda") -> Optional[Tuple[Any, int]]:
        """The newest recovered publish as ``(params, version)``: tensors
        on ``device`` (bf16 from its bits), the card unless the caller
        asks for the CPU."""
        device = resolve_device(device)
        if self.store is None:
            return None
        version, blob = self.store
        return decode_pytree(blob, copy=True, device=device), version


def _chan_entry(state: RecoveredState, name: str) -> Dict:
    return state.channels.setdefault(
        name, {"capacity": 0, "policy": "drop_oldest", "items": []})


def _stream_entry(state: RecoveredState, chan: str, stream: str) -> Dict:
    return state.streams.setdefault(
        (chan, stream), {"last_seq": -1, "acks": {}, "window": 32,
                         "ack_every": 1})


def _apply_stream_hdr(state: RecoveredState, hdr: Dict) -> None:
    """Fold one watermark header (a ``stream`` record, or the fused keys
    of a streamed ``put``) into the stream state — idempotent, max-seq."""
    s = _stream_entry(state, hdr["chan"], hdr["stream"])
    s["window"] = int(hdr.get("window", s["window"]))
    s["ack_every"] = int(hdr.get("ack_every", s["ack_every"]))
    seq = int(hdr["seq"])
    if seq > s["last_seq"]:
        s["last_seq"] = seq
    s["acks"][seq] = [bool(v) for v in hdr.get("verdicts", ())]
    keep = max(4 * s["window"], 64)
    while len(s["acks"]) > keep:
        del s["acks"][min(s["acks"])]


def _apply_part(state: RecoveredState, hdr: Dict, body) -> None:
    """Fold one ``publish_part`` into the publish being reassembled. Part
    0 starts a version; a part out of order (the rest of a publish whose
    start a compaction covered, or one cut by a crash) drops it."""
    version, part = int(hdr["version"]), int(hdr["part"])
    parts, nbytes = int(hdr["parts"]), int(hdr["bytes"])
    cur = state._partial
    if part == 0:
        cur = state._partial = [version, 0, parts, bytearray(nbytes), 0]
    if cur is None or cur[:3] != [version, part, parts] or \
            cur[4] + len(body) > len(cur[3]):
        state._partial = None
        return
    buf, off = cur[3], cur[4]
    buf[off:off + len(body)] = body
    cur[1] += 1
    cur[4] += len(body)
    if cur[1] == parts:
        state._partial = None
        if cur[4] == len(buf) and (state.store is None
                                   or version >= state.store[0]):
            state.store = (version, buf)


def _apply_record(state: RecoveredState, hdr: Dict, body: bytes) -> None:
    op = hdr.get("op")
    if op == "chan_meta":
        e = _chan_entry(state, hdr["chan"])
        e["capacity"] = int(hdr.get("capacity", 0))
        e["policy"] = str(hdr.get("policy", "drop_oldest"))
    elif op == "put":
        e = _chan_entry(state, hdr["chan"])
        if body:
            items = decode_pytree(body, copy=True)
            e["items"].extend(items)
            state.puts += 1
            state.items_in += len(items)
            cap = e["capacity"]
            if (cap and e["policy"] == "drop_oldest"
                    and len(e["items"]) > cap):
                del e["items"][:len(e["items"]) - cap]
        if "stream" in hdr:                # fused watermark (one record
            _apply_stream_hdr(state, hdr)  # per streamed frame)
    elif op == "pop":
        e = _chan_entry(state, hdr["chan"])
        n = int(hdr["n"])
        del e["items"][:n]
        state.pops += 1
        state.items_out += n
    elif op == "stream":
        _apply_stream_hdr(state, hdr)
    elif op == "stream_snap":
        s = _stream_entry(state, hdr["chan"], hdr["stream"])
        s["window"] = int(hdr.get("window", s["window"]))
        s["ack_every"] = int(hdr.get("ack_every", s["ack_every"]))
        seq = int(hdr.get("seq", -1))
        if seq > s["last_seq"]:
            s["last_seq"] = seq
        for k, v in hdr.get("acks", {}).items():
            s["acks"][int(k)] = [bool(x) for x in v]
        keep = max(4 * s["window"], 64)
        while len(s["acks"]) > keep:
            del s["acks"][min(s["acks"])]
    elif op == "publish":
        version = int(hdr["version"])
        if state.store is None or version >= state.store[0]:
            state.store = (version, bytes(body))
    elif op == "publish_part":
        _apply_part(state, hdr, body)
    elif op == "snap_end":
        pass
    state.records += 1


def recover(directory) -> RecoveredState:
    """Replay the newest valid snapshot + every log generation from it
    on: the state a replacement server resumes with. A torn final log
    record ends the committed prefix (flagged in ``torn_tail``); an
    interrupted (marker-less) snapshot is skipped in favor of the
    previous chain, whose logs are only deleted after a snapshot rename.
    """
    directory = pathlib.Path(directory)
    state = RecoveredState()
    gens = _scan_generations(directory)
    base = 0
    for g in reversed(gens["snap"]):
        records, torn, _ = read_records(directory / f"snap-{g:08d}.bin")
        if torn or not records or records[-1][0].get("op") != "snap_end":
            continue                       # interrupted compaction
        for hdr, body in records:
            _apply_record(state, hdr, body)
        base = g
        break
    state.base_gen = base
    for g in gens["log"]:
        if g < base:
            continue
        records, torn, _ = read_records(directory / f"log-{g:08d}.bin")
        for hdr, body in records:
            _apply_record(state, hdr, body)
        state.torn_tail = state.torn_tail or torn
    return state
