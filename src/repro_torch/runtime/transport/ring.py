"""Persistent shared-memory ring buffer: the streaming data plane, as in
the reference ``repro/runtime/transport/ring.py``, with the same segment
layout, so a reader in one package reads a writer in the other.

The per-message SHM path (:class:`~repro_torch.runtime.transport.channel.ShmChannel`)
pays a ``shm_open`` + ``mmap`` + ``unlink`` syscall trio for every payload
and forces the server to keep an LRU of orphan segment names. A
:class:`ShmRing` replaces that churn with ONE segment per channel
direction, created at connect time and reused for every record — payloads
cross the boundary at memcpy speed and the only thing the server ever has
to sweep is the ring itself.

Layout (one 64-byte header cacheline, then ``capacity`` data bytes)::

    0   8s  magic "ACRLRNG1"
    8   u64 capacity                (data bytes; multiple of 16)
    16  u64 write   — RESERVE offset: monotone byte offset the producer
                      has claimed (advanced BEFORE the payload memcpy)
    24  u64 commit  — COMMIT offset: records below it are fully written;
                      the consumer never reads past it (torn-write guard)
    32  u64 read    — consumer offset (monotone)
    40  u64 items_committed
    48  u64 items_read
    56  u64 torn_discards          (recover() bumps it per discarded tail)

Records are ``[u64 seq | u32 nbytes | u32 flags | payload]`` padded to 8
bytes. A :meth:`reserve`-based record that would straddle the end of the
data area is preceded by a WRAP marker (``nbytes = 0xFFFFFFFF``) and
restarts at offset 0 (writers get one contiguous view); a :meth:`push`
record instead *splits* — header contiguous, payload tail wrapping to
offset 0, flagged ``FLAG_SPLIT`` — so the tail bytes are not wasted. A
tail shorter than a record header is skipped implicitly by both sides.
Offsets are monotone (never wrapped), so ``free = capacity - (write -
read)`` with no ambiguity between full and empty.

Consumers have two pop flavors. :meth:`pop` is the classic copying pop.
:meth:`pop_view` is the zero-copy ingest path: it returns a
:class:`RingView` over the committed region WITHOUT advancing the read
offset — the producer cannot reclaim the bytes under a live view (a full
ring simply refuses the push) until the consumer calls
:meth:`RingView.release`. Releases are ordered: the read offset advances
over the released *prefix* only, so out-of-order releases are safe.
Split records cannot be viewed contiguously and fall back to a two-piece
copy (``RingView.copied`` is True); the per-ring ``bytes_copied`` /
``views_served`` counters make the copy-elimination observable.

Torn-write protection is the two-offset header: the producer publishes
``write`` (reserve) before the memcpy and ``commit`` only after it, so a
producer dying mid-copy leaves ``write > commit`` — the consumer never
sees the partial record, and the next producer to take over the ring
calls :meth:`recover` to discard the uncommitted tail. Each record also
carries its sequence number (``items_committed`` at reserve time); a
mismatch against ``items_read`` on the consumer side means the ring was
corrupted and raises :class:`RingError` instead of yielding garbage.

Discipline: single producer, single consumer (one process each side) —
exactly the shape of one transport connection. Both sides may live in
the same process (tests, benchmarks).

Segment names follow the reference's sweepable ``acrl<pidhex>x<token>``
scheme (``shm_name``, ``sweep_stale_shm``; the reference keeps them in its
resilience module, which re-exports these). With ``REPRO_FAULTS`` set,
:meth:`ShmRing.commit` is the ``ring.commit`` fault point
(``transport/faults.py``).
"""
from __future__ import annotations

import binascii
import mmap
import os
import pathlib
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

try:
    from multiprocessing import shared_memory
except ImportError:  # pragma: no cover — stdlib on every target platform
    shared_memory = None

MAGIC = b"ACRLRNG1"
HEADER_SIZE = 64
RECORD_HEADER = struct.Struct("<QII")          # seq, nbytes, flags
WRAP = 0xFFFFFFFF                              # nbytes sentinel: skip to 0
FLAG_SPLIT = 0x1                               # payload wraps to offset 0

_U64 = struct.Struct("<Q")
_OFF_CAPACITY = 8
_OFF_WRITE = 16
_OFF_COMMIT = 24
_OFF_READ = 32
_OFF_ITEMS_COMMITTED = 40
_OFF_ITEMS_READ = 48
_OFF_TORN = 56

#: polling granularity of blocking push/pop waits — the ring is a hot
#: path, so the sleep is short; close()/deadlines bound every wait
POLL_S = 0.0005

__all__ = ["RingError", "RingView", "ShmRing", "MAGIC", "HEADER_SIZE",
           "WRAP", "FLAG_SPLIT"]


class RingError(RuntimeError):
    """Structural ring failure: bad magic, oversized record, corruption."""


# import-gated fault injection (see transport.faults): inert — not even
# imported — unless REPRO_FAULTS is set. The gate sits below RingError
# because faults.py imports it from this (then partially-initialized)
# module.
if os.environ.get("REPRO_FAULTS"):
    from repro_torch.runtime.transport.faults import fault_point as _fault
else:
    _fault = None


SHM_NAME_PREFIX = "acrl"


def shm_name() -> str:
    """A segment name that encodes its creator pid (``acrl<pidhex>x<tok>``)
    so :func:`sweep_stale_shm` can tell live segments from leaks."""
    return (f"{SHM_NAME_PREFIX}{os.getpid():x}x"
            f"{binascii.hexlify(os.urandom(4)).decode()}")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:                    # exists, owned by someone else
        return True
    return True


def sweep_stale_shm() -> int:
    """Unlink ``acrl``-named SHM segments whose creator pid is dead — the
    rings and payload segments a SIGKILLed previous server (or worker)
    leaked. Linux-only (``/dev/shm``); a no-op elsewhere. Returns the
    number of segments removed."""
    base = pathlib.Path("/dev/shm")
    if not base.is_dir():
        return 0
    swept = 0
    for p in base.glob(SHM_NAME_PREFIX + "*"):
        pid_hex, sep, _ = p.name[len(SHM_NAME_PREFIX):].partition("x")
        if not sep:
            continue
        try:
            pid = int(pid_hex, 16)
        except ValueError:
            continue
        if pid <= 0 or _pid_alive(pid):
            continue
        try:
            p.unlink()
            swept += 1
        except OSError:
            pass
    return swept


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class RingView:
    """A popped-but-not-yet-released record (zero-copy ingest lease).

    ``data`` is a read-only memoryview straight into the committed ring
    region (``copied`` False) or reassembled bytes when the record was
    wraparound-split (``copied`` True). The ring's read offset does NOT
    advance until :meth:`release` — while the lease is live the producer
    sees the bytes as occupied and a full ring refuses to overwrite them.
    Releases may arrive out of order; the ring advances over the released
    prefix only. Usable as a context manager; release is idempotent.
    """

    __slots__ = ("data", "seq", "nbytes", "copied", "_ring", "_end",
                 "_released")

    def __init__(self, ring: "ShmRing", data, seq: int, end: int, *,
                 copied: bool):
        self.data = data
        self.seq = seq
        self.nbytes = len(data)
        self.copied = copied
        self._ring = ring
        self._end = end
        self._released = False

    def release(self) -> None:
        """Return the leased region to the producer (idempotent)."""
        if self._released:
            return
        self._released = True
        if not self.copied:
            data, self.data = self.data, bytes()
            try:
                data.release()               # drop the SHM buffer pin
            except BufferError:
                # numpy views decoded over the lease still export the
                # buffer; by the lease contract their CONTENTS are dead
                # now (the consumer copied what it needed) — the mapping
                # pin itself dies with the arrays via refcounting
                pass
            except AttributeError:  # pragma: no cover - bytes fallback
                pass
        self._ring._advance_released()

    def __len__(self) -> int:
        return self.nbytes

    def __enter__(self) -> "RingView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _map_populated(shm) -> Optional[mmap.mmap]:
    """``shm``'s segment mapped once more with ``MAP_POPULATE`` where Linux
    offers it (None elsewhere): its pages are mapped in one call instead
    of one fault at a time. On some hosts a first touch of a shared page
    costs several times a rewrite, and a weight blob of 3.6 GB is 900K
    pages."""
    flag = getattr(mmap, "MAP_POPULATE", 0)
    path = os.path.join("/dev/shm", shm.name.lstrip("/"))
    if not flag or not os.path.exists(path):
        return None
    fd = os.open(path, os.O_RDWR)
    try:
        return mmap.mmap(fd, shm.size, flags=mmap.MAP_SHARED | flag)
    finally:
        os.close(fd)


class ShmRing:
    """Single-producer single-consumer byte ring over one SHM segment."""

    def __init__(self, shm: "shared_memory.SharedMemory", *, created: bool):
        self._shm = shm
        self._mm = _map_populated(shm)
        self._buf = shm.buf if self._mm is None else memoryview(self._mm)
        self.created = created
        self.closed = False
        buf = self._buf
        if bytes(buf[:8]) != MAGIC:
            raise RingError(f"bad ring magic in segment {shm.name!r}")
        self.capacity = _U64.unpack_from(buf, _OFF_CAPACITY)[0]
        if HEADER_SIZE + self.capacity > len(buf):
            raise RingError(f"ring segment {shm.name!r} truncated")
        # consumer-side zero-copy state (per attachment, not in the SHM
        # header: leases are a property of THIS consumer's mapping)
        self._view_lock = threading.Lock()
        self._pending_views: List[RingView] = []
        self.views_served = 0        # zero-copy pops (no payload memcpy)
        self.bytes_copied = 0        # payload bytes memcpy'd on the pop path
        self.split_fallbacks = 0     # pop_view forced to copy (FLAG_SPLIT)

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, capacity: int, name: Optional[str] = None) -> "ShmRing":
        """Create a fresh ring with at least ``capacity`` data bytes."""
        if shared_memory is None:
            raise RingError("shared memory unavailable on this platform")
        capacity = max(_pad8(capacity), 4 * RECORD_HEADER.size)
        capacity = (capacity + 15) & ~15               # multiple of 16
        if name is None:
            # default to the sweepable acrl<pid>x… scheme so a later
            # server incarnation can reclaim rings a SIGKILL leaked
            while True:
                try:
                    shm = shared_memory.SharedMemory(
                        create=True, size=HEADER_SIZE + capacity,
                        name=shm_name())
                    break
                except FileExistsError:    # 32-bit token collision
                    continue
        else:
            shm = shared_memory.SharedMemory(
                create=True, size=HEADER_SIZE + capacity, name=name)
        shm.buf[:HEADER_SIZE] = bytes(HEADER_SIZE)     # zero all offsets
        shm.buf[:8] = MAGIC
        _U64.pack_into(shm.buf, _OFF_CAPACITY, capacity)
        return cls(shm, created=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        """Attach to a ring created by the peer (no unlink duty)."""
        if shared_memory is None:
            raise RingError("shared memory unavailable on this platform")
        return cls(shared_memory.SharedMemory(name=name), created=False)

    @property
    def name(self) -> str:
        return self._shm.name

    # -- header accessors (each field is ONE aligned u64 write: no tearing
    # across fields, and an 8-byte aligned store is atomic on every target)
    def _get(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    def _set(self, off: int, value: int) -> None:
        _U64.pack_into(self._buf, off, value)

    # -- producer -------------------------------------------------------------
    def max_record(self) -> int:
        """Largest payload a push can ever carry (sized so one record plus
        its worst-case wrap skip always fits an empty ring)."""
        return self.capacity // 2 - RECORD_HEADER.size

    def reserve(self, nbytes: int,
                timeout: Optional[float] = None) -> Optional[memoryview]:
        """Claim space for one ``nbytes`` record; returns a writable view
        of the payload area (None on timeout). The reservation is
        published BEFORE the caller copies — :meth:`commit` makes it
        visible to the consumer; an uncommitted reservation is what
        :meth:`recover` discards."""
        if self.closed:
            return None
        if nbytes > self.max_record():
            raise RingError(f"record of {nbytes} bytes exceeds ring "
                            f"max {self.max_record()} (capacity "
                            f"{self.capacity})")
        need = RECORD_HEADER.size + _pad8(nbytes)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        buf = self._buf
        while True:
            if self.closed:
                return None
            write = self._get(_OFF_WRITE)
            pos = write % self.capacity
            rem = self.capacity - pos
            if rem < RECORD_HEADER.size:
                skip, marker = rem, False          # implicit tail skip
            elif rem < need:
                skip, marker = rem, True           # WRAP marker, restart at 0
            else:
                skip, marker = 0, False
            free = self.capacity - (write - self._get(_OFF_READ))
            if free >= skip + need:
                break
            if self.closed or (deadline is not None
                               and time.monotonic() >= deadline):
                return None
            time.sleep(POLL_S)
        if marker:
            RECORD_HEADER.pack_into(buf, HEADER_SIZE + pos, 0, WRAP, 0)
        start = (write + skip) % self.capacity
        RECORD_HEADER.pack_into(buf, HEADER_SIZE + start,
                                self._get(_OFF_ITEMS_COMMITTED), nbytes, 0)
        self._reserved_end = write + skip + need
        self._set(_OFF_WRITE, self._reserved_end)  # reserve BEFORE payload
        data0 = HEADER_SIZE + start + RECORD_HEADER.size
        return buf[data0:data0 + nbytes]

    def commit(self) -> None:
        """Publish the record reserved by the last :meth:`reserve`."""
        if _fault is not None:
            # firing here (InjectedTorn) leaves the reservation
            # uncommitted — exactly the torn write recover() discards
            _fault("ring.commit")
        self._set(_OFF_ITEMS_COMMITTED,
                  self._get(_OFF_ITEMS_COMMITTED) + 1)
        self._set(_OFF_COMMIT, self._reserved_end)

    def push(self, payload, timeout: Optional[float] = None) -> bool:
        """Copy + commit one record; False on timeout (full).

        Unlike :meth:`reserve` (which must hand back ONE contiguous
        writable view and therefore wastes the tail behind a WRAP
        marker), push owns the memcpy and can *split* a record that
        would straddle the end of the data area: header contiguous at
        the tail, payload remainder wrapping to offset 0, flagged
        ``FLAG_SPLIT``. Consumers reassemble split records by copy —
        :meth:`pop_view` falls back to a two-piece copy for them.
        """
        data = memoryview(payload)
        nbytes = len(data)
        if nbytes > self.max_record():
            raise RingError(f"record of {nbytes} bytes exceeds ring "
                            f"max {self.max_record()} (capacity "
                            f"{self.capacity})")
        need = RECORD_HEADER.size + _pad8(nbytes)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        buf = self._buf
        while True:
            if self.closed:
                return False
            write = self._get(_OFF_WRITE)
            pos = write % self.capacity
            rem = self.capacity - pos
            if rem < RECORD_HEADER.size:
                skip, split = rem, False           # implicit tail skip
            elif rem < need:
                skip, split = 0, True              # wraparound-split record
            else:
                skip, split = 0, False
            free = self.capacity - (write - self._get(_OFF_READ))
            if free >= skip + need:
                break
            if self.closed or (deadline is not None
                               and time.monotonic() >= deadline):
                return False                       # full — e.g. live views
            time.sleep(POLL_S)
        start = (write + skip) % self.capacity
        RECORD_HEADER.pack_into(buf, HEADER_SIZE + start,
                                self._get(_OFF_ITEMS_COMMITTED), nbytes,
                                FLAG_SPLIT if split else 0)
        self._reserved_end = write + skip + need
        self._set(_OFF_WRITE, self._reserved_end)  # reserve BEFORE payload
        data0 = HEADER_SIZE + start + RECORD_HEADER.size
        if split:
            head = (self.capacity - start) - RECORD_HEADER.size
            buf[data0:data0 + head] = data[:head]
            buf[HEADER_SIZE:HEADER_SIZE + nbytes - head] = data[head:]
        else:
            buf[data0:data0 + nbytes] = data
        self.commit()
        return True

    # -- consumer -------------------------------------------------------------
    def _skip(self, read: int, by: int) -> None:
        """Advance the consumer cursor over a WRAP marker / implicit tail.
        With live views pending, the read offset must not move (the
        producer would reclaim leased bytes) — fold the skip into the
        newest lease's extent so its release covers it."""
        with self._view_lock:
            if self._pending_views:
                self._pending_views[-1]._end = read + by
            else:
                self._set(_OFF_READ, read + by)

    def _cursor(self) -> int:
        """Next unconsumed offset: past the newest lease when any are
        live, the shared read offset otherwise."""
        with self._view_lock:
            if self._pending_views:
                return self._pending_views[-1]._end
        return self._get(_OFF_READ)

    def _advance_released(self) -> None:
        """Publish the released prefix of the lease queue: the shared
        read offset (and items_read) jump over every leading lease whose
        consumer is done with it."""
        with self._view_lock:
            while self._pending_views and self._pending_views[0]._released:
                view = self._pending_views.pop(0)
                self._set(_OFF_ITEMS_READ,
                          self._get(_OFF_ITEMS_READ) + 1)
                self._set(_OFF_READ, view._end)

    def _pop_record(self,
                    timeout: Optional[float] = None) -> Optional[RingView]:
        """Shared pop core: locate + lease the oldest committed record.
        Contiguous records come back as an unreleased zero-copy lease;
        wraparound-split records are reassembled by copy and their lease
        auto-released (the ordered prefix rule still holds). Only
        committed records are ever visible — a torn (reserved, never
        committed) tail is invisible by construction."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        buf = self._buf
        while True:
            if self.closed:
                return None
            read = self._cursor()
            if read < self._get(_OFF_COMMIT):
                pos = read % self.capacity
                rem = self.capacity - pos
                if rem < RECORD_HEADER.size:       # implicit tail skip
                    self._skip(read, rem)
                    continue
                seq, nbytes, flags = RECORD_HEADER.unpack_from(
                    buf, HEADER_SIZE + pos)
                if nbytes == WRAP:
                    self._skip(read, rem)
                    continue
                # bound by what a producer can legally have written AND
                # by the mapping — a corrupt length must raise, never
                # yield a silently clamped short read
                if (nbytes > self.max_record()
                        or (not flags & FLAG_SPLIT
                            and pos + RECORD_HEADER.size + nbytes
                            > self.capacity)):
                    raise RingError(f"corrupt ring record: {nbytes} bytes "
                                    f"claimed at offset {read}")
                with self._view_lock:
                    expect = (self._get(_OFF_ITEMS_READ)
                              + len(self._pending_views))
                if seq != expect:
                    raise RingError(f"corrupt ring: record seq {seq} != "
                                    f"expected {expect}")
                end = read + RECORD_HEADER.size + _pad8(nbytes)
                data0 = HEADER_SIZE + pos + RECORD_HEADER.size
                if flags & FLAG_SPLIT:
                    head = rem - RECORD_HEADER.size
                    data = (bytes(buf[data0:data0 + head])
                            + bytes(buf[HEADER_SIZE:
                                        HEADER_SIZE + nbytes - head]))
                    self.bytes_copied += nbytes
                    self.split_fallbacks += 1
                    view = RingView(self, data, seq, end, copied=True)
                else:
                    mv = buf[data0:data0 + nbytes].toreadonly()
                    view = RingView(self, mv, seq, end, copied=False)
                with self._view_lock:
                    self._pending_views.append(view)
                if view.copied:
                    # nothing pins the ring for a copied record; ordered
                    # advance still waits for earlier live leases
                    view.release()
                return view
            if self.closed or (deadline is not None
                               and time.monotonic() >= deadline):
                return None
            time.sleep(POLL_S)

    def pop(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Pop the oldest committed record as owned bytes (None on
        timeout) — the classic copying pop."""
        view = self._pop_record(timeout=timeout)
        if view is None:
            return None
        if view.copied:
            return view.data                       # already owned bytes
        out = bytes(view.data)
        self.bytes_copied += len(out)
        view.release()
        return out

    def pop_view(self, timeout: Optional[float] = None) -> Optional[RingView]:
        """Zero-copy pop: lease the oldest committed record in place (see
        :class:`RingView`). The caller MUST release the view — the
        producer blocks on the leased bytes until then. Split records
        fall back to an (auto-released) copy."""
        view = self._pop_record(timeout=timeout)
        if view is not None and not view.copied:
            self.views_served += 1
        return view

    # -- recovery -------------------------------------------------------------
    def recover(self) -> bool:
        """Discard an uncommitted (torn) reservation left by a producer
        that died mid-copy: reset ``write`` back to ``commit``. Call
        before producing into a ring taken over from a dead peer.
        Returns True iff a torn tail was discarded."""
        write, commit = self._get(_OFF_WRITE), self._get(_OFF_COMMIT)
        if write == commit:
            return False
        self._set(_OFF_WRITE, commit)
        self._set(_OFF_TORN, self._get(_OFF_TORN) + 1)
        return True

    # -- broadcast lane (single writer, many positional readers) --------------
    def publish_blob(self, payload) -> Tuple[int, int]:
        """Broadcast-lane write: one record per published version, located
        by absolute position instead of popped. Readers never advance the
        ring's read offset, so the writer reclaims EVERYTHING unread
        before each write (a reader mid-copy of an old version detects
        the overwrite via :meth:`read_at`'s header re-check and falls
        back). Returns ``(header_pos, seq)`` for the acquire reply."""
        data = memoryview(payload)

        def fill(view):
            view[:] = data
        return self.publish_into(len(data), fill)

    def publish_into(self, nbytes: int, fill) -> Tuple[int, int]:
        """:meth:`publish_blob` with the record's ``nbytes`` written by
        ``fill(view)`` straight into the lane (an encode plan's
        ``write_into``: no intermediate blob)."""
        self._set(_OFF_ITEMS_READ, self._get(_OFF_ITEMS_COMMITTED))
        self._set(_OFF_READ, self._get(_OFF_COMMIT))
        seq = self._get(_OFF_ITEMS_COMMITTED)
        view = self.reserve(nbytes, timeout=0)
        if view is None:  # reclaim guarantees room up to max_record
            raise RingError(f"weight-lane reserve of {nbytes} bytes "
                            f"failed (max {self.max_record()})")
        need = RECORD_HEADER.size + _pad8(nbytes)
        pos = (self._reserved_end - need) % self.capacity
        try:
            fill(view)
        finally:
            view.release()
        self.commit()
        return pos, seq

    def view_at(self, pos: int, seq: int,
                nbytes: int) -> Optional[memoryview]:
        """A read-only view of the broadcast-lane record at ``pos`` while
        its header says ``(seq, nbytes)``, else None. The writer may
        reclaim it for a newer version at any time: a reader copies out
        of the view, then confirms with :meth:`still_at`."""
        hdr = RECORD_HEADER.size
        if pos < 0 or pos + hdr + nbytes > self.capacity:
            return None
        if not self.still_at(pos, seq, nbytes):
            return None
        start = HEADER_SIZE + pos + hdr
        return self._buf[start:start + nbytes].toreadonly()

    def still_at(self, pos: int, seq: int, nbytes: int) -> bool:
        """The record header at ``pos`` still says ``(seq, nbytes)`` (seqs
        are monotone and never reused, so a reclaimed record fails)."""
        rseq, rnbytes, _ = RECORD_HEADER.unpack_from(self._buf,
                                                     HEADER_SIZE + pos)
        return rseq == seq and rnbytes == nbytes

    def read_at(self, pos: int, seq: int, nbytes: int) -> Optional[bytes]:
        """Positional broadcast-lane read with torn-read detection: the
        record header at ``pos`` is validated before AND after the copy.
        The writer reclaiming the lane for a newer version mid-copy
        changes the header, so a torn copy comes back as None and the
        caller falls back to the socket body."""
        view = self.view_at(pos, seq, nbytes)
        if view is None:
            return None
        out = bytes(view)
        view.release()
        return out if self.still_at(pos, seq, nbytes) else None

    def prefault(self, stop=None, chunk: int = 64 << 20) -> bool:
        """Write zeros over the whole data area once, before any record,
        so that records land on pages that already exist: a first write
        to a shared-memory page costs several times a rewrite. Stops
        early (returning False) when ``stop`` (an Event) is set."""
        buf = self._buf
        zeros = bytes(min(chunk, self.capacity))
        end = HEADER_SIZE + self.capacity
        for off in range(HEADER_SIZE, end, chunk):
            if stop is not None and stop.is_set():
                return False
            n = min(chunk, end - off)
            buf[off:off + n] = zeros[:n]
        return True

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        """Committed-but-unread records."""
        return int(self._get(_OFF_ITEMS_COMMITTED)
                   - self._get(_OFF_ITEMS_READ))

    def stats(self) -> Dict[str, float]:
        return {
            "capacity_bytes": float(self.capacity),
            "used_bytes": float(self._get(_OFF_COMMIT)
                                - self._get(_OFF_READ)),
            "items_pushed": float(self._get(_OFF_ITEMS_COMMITTED)),
            "items_popped": float(self._get(_OFF_ITEMS_READ)),
            "depth_items": float(len(self)),
            "torn_discards": float(self._get(_OFF_TORN)),
            "views_served": float(self.views_served),
            "bytes_copied": float(self.bytes_copied),
            "split_fallbacks": float(self.split_fallbacks),
            "views_live": float(len(self._pending_views)),
        }

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        """Unmap (both sides); a blocked push/pop returns within one poll
        slice. Unlinking is the creator's job (:meth:`unlink`)."""
        if self.closed:
            return
        self.closed = True
        # give any same-process waiter a chance to observe `closed` before
        # the mapping disappears under it
        time.sleep(POLL_S)
        for view in list(self._pending_views):
            view.release()       # drop SHM pins so the unmap can proceed
        if self._mm is not None:
            try:
                self._buf.release()
                self._mm.close()
            except (OSError, BufferError):
                pass             # a live view: the map dies with it
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        """Remove the segment name (idempotent; creator-owns-lifetime,
        but the server may sweep a dead creator's ring — both tolerate
        the other having gone first)."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
