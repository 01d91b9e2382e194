"""Pytree wire codec: zero-copy-friendly serialization for the transport
layer, as in the reference ``repro/runtime/transport/codec.py`` and
wire-compatible with it: the same preamble, header JSON and 64-byte
alignment, so a numpy pytree encodes to the same bytes in both packages
and each decodes the other's blobs.

Everything the runtime moves across a process boundary — trajectory
segments (numpy pytrees), policy weights (trees of tensors, incl. bf16),
and imagined frames — is a nested structure of dict / list / tuple /
scalars over array leaves. The codec flattens that structure into one
self-describing blob:

    MAGIC "ACRL" | u16 wire version | u32 header len | u64 total len
    header JSON  { schema, leaves: [{dtype, shape, offset, nbytes}, ...] }
    leaf buffers, each 64-byte aligned

Design points:

  * **zero-copy decode** — by default leaf arrays are ``np.frombuffer``
    views over the received buffer (pass ``copy=True`` for independent
    arrays). The 64-byte alignment keeps the views cacheline friendly,
    so decoded segments feed ``np.stack`` collation with no intermediate
    copy per leaf.
  * **torch leaves** — a tensor leaf (CUDA included) is encoded from a
    host copy; :func:`_host_leaves` moves a tree's CUDA leaves in one pass
    of non-blocking copies into one pinned buffer and one synchronize
    (the server encodes each published version once this way).
    ``decode_pytree(blob, device=...)`` returns every array leaf as a
    tensor on that device — the weight path; numpy stays the default,
    for experience.
  * **bf16 without ml_dtypes** — dtypes are carried by name, and a bf16
    leaf goes out as ``"bfloat16"`` with its bits, as the reference sends
    an ``ml_dtypes.bfloat16`` array. numpy cannot hold bf16 without
    ``ml_dtypes``, which the port never imports, so a ``"bfloat16"`` leaf
    always decodes to a ``torch.bfloat16`` tensor (on the CPU when no
    device is asked for), built from the bits. This is the one place the
    decoded tree differs from the reference's.
  * **versioned, schema-first header** — a decoder never guesses: wrong
    magic, wire version, or a truncated body is a :class:`CodecError`,
    not silent garbage.

The framing helpers (``send_frame`` / ``recv_frame``) wrap the same
preamble around RPC messages: a small JSON header plus an optional binary
body (itself usually an encoded pytree).
"""
from __future__ import annotations

import json
import socket
import struct
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

MAGIC = b"ACRL"
WIRE_VERSION = 1
ALIGNMENT = 64

# magic, wire version, header length, total/body length
_PREAMBLE = struct.Struct("!4sHIQ")
PREAMBLE_SIZE = _PREAMBLE.size

__all__ = ["CodecError", "encode_pytree", "decode_pytree", "plan_pytree",
           "EncodePlan", "send_frame", "recv_frame", "recv_exact",
           "MAGIC", "WIRE_VERSION", "PREAMBLE_SIZE"]

_BF16 = "bfloat16"


class CodecError(ValueError):
    """Malformed wire data: bad magic/version, truncation, unknown dtype."""


def _contiguous(x: Any) -> np.ndarray:
    # NOT np.ascontiguousarray — that promotes 0-d arrays/scalars to 1-d,
    # which would break scalar round-trips; 0-d is always contiguous
    arr = np.asarray(x)
    return arr if arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(arr)


def _dtype_from_name(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are viewed as: bf16 as ``int16``
    bits (rebuilt as ``torch.bfloat16`` by the caller)."""
    if name == _BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise CodecError(f"cannot resolve wire dtype {name!r}: {e}") from e


def _host_array(node: Any) -> Tuple[str, np.ndarray]:
    """(wire dtype name, C-contiguous host array) of one array leaf; a
    bf16 leaf (tensor or ``ml_dtypes`` array) as its ``int16`` bits."""
    if isinstance(node, torch.Tensor):
        t = node.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        arr = t.numpy()
        return arr.dtype.name, arr
    arr = _contiguous(node)
    if arr.dtype.name == _BF16:
        return _BF16, arr.view(np.int16)
    return arr.dtype.name, arr


def _host_leaves(tree: Any) -> Any:
    """``tree`` with every CUDA tensor leaf copied to the host: one pass of
    non-blocking copies into one pinned buffer, then one synchronize.
    Other leaves pass through. The copies view the pinned buffer."""
    cuda = [t for t in _tensor_leaves(tree) if t.device.type == "cuda"]
    if not cuda:
        return tree
    offsets, total = {}, 0
    for t in cuda:
        offsets[id(t)] = total
        total = _align(total + t.numel() * t.element_size())
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    hosts = {}
    for t in cuda:
        off, n = offsets[id(t)], t.numel() * t.element_size()
        dst = pinned[off:off + n].view(t.dtype).view(t.shape)
        dst.copy_(t.detach(), non_blocking=True)
        hosts[id(t)] = dst
    torch.cuda.synchronize()
    return _map_tensors(tree, lambda t: hosts.get(id(t), t))


def _tensor_leaves(node: Any) -> List[torch.Tensor]:
    if isinstance(node, torch.Tensor):
        return [node]
    if isinstance(node, dict):
        return [t for v in node.values() for t in _tensor_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _tensor_leaves(v)]
    return []


def _map_tensors(node: Any, fn) -> Any:
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(v, fn) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_map_tensors(v, fn) for v in node)
    if isinstance(node, list):
        return [_map_tensors(v, fn) for v in node]
    return node


def _build_schema(node: Any, leaves: List[np.ndarray],
                  recs: List[Dict]) -> Dict:
    """Recursively replace array leaves with indices into ``leaves``."""
    if node is None:
        return {"t": "none"}
    if isinstance(node, (bool, int, float, str)):
        # bool first — it is an int subclass; JSON carries all of these
        return {"t": "py", "v": node}
    if isinstance(node, np.generic):       # 0-d numpy scalar (np.int32(3))
        name, arr = _host_array(node)
        recs.append({"d": name, "s": list(arr.shape), "g": 1})
        leaves.append(arr)
        return {"t": "arr", "i": len(leaves) - 1}
    if isinstance(node, (np.ndarray, torch.Tensor)):
        name, arr = _host_array(node)
        recs.append({"d": name, "s": list(node.shape)})
        leaves.append(arr)
        return {"t": "arr", "i": len(leaves) - 1}
    if isinstance(node, dict):
        keys = list(node.keys())
        if not all(isinstance(k, str) for k in keys):
            raise CodecError("wire pytrees support str dict keys only")
        return {"t": "dict", "k": keys,
                "c": [_build_schema(node[k], leaves, recs) for k in keys]}
    if isinstance(node, tuple):
        return {"t": "tuple",
                "c": [_build_schema(v, leaves, recs) for v in node]}
    if isinstance(node, list):
        return {"t": "list",
                "c": [_build_schema(v, leaves, recs) for v in node]}
    raise CodecError(f"cannot encode leaf of type {type(node).__name__}")


def _align(n: int) -> int:
    return (n + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT


class EncodePlan:
    """A sized, ready-to-write encoding of one pytree.

    Splitting serialization into *plan* (size known) and *write* lets a
    caller reserve exactly ``nbytes`` in a preallocated destination — a
    :class:`~repro_torch.runtime.transport.ring.ShmRing` reservation — and
    materialize the blob in place, skipping the intermediate ``bytes``
    copy that ``encode_pytree`` pays on the socket path.
    """

    __slots__ = ("nbytes", "_header", "_recs", "_leaves", "_data_start")

    def __init__(self, header: bytes, recs: List[Dict],
                 leaves: List[np.ndarray]):
        self._header = header
        self._recs = recs
        self._leaves = leaves
        self._data_start = _align(PREAMBLE_SIZE + len(header))
        data = _align(recs[-1]["o"] + recs[-1]["n"]) if recs else 0
        self.nbytes = self._data_start + data

    def write_into(self, out, offset: int = 0) -> int:
        """Write the full blob at ``out[offset:]``; returns ``nbytes``.
        Padding bytes are written as zeros, as a fresh buffer holds."""
        view = memoryview(out).cast("B")
        _PREAMBLE.pack_into(view, offset, MAGIC, WIRE_VERSION,
                            len(self._header), self.nbytes)
        h0 = offset + PREAMBLE_SIZE
        view[h0:h0 + len(self._header)] = self._header
        pos = h0 + len(self._header)
        base = offset + self._data_start
        for rec, arr in zip(self._recs, self._leaves):
            start = base + rec["o"]
            view[pos:start] = bytes(start - pos)
            if rec["n"]:
                # ONE memcpy leaf → destination; planned leaves are
                # C-contiguous numeric arrays (bf16 as its int16 bits)
                view[start:start + rec["n"]] = memoryview(
                    arr.reshape(-1).view(np.uint8))
            pos = start + rec["n"]
        view[pos:offset + self.nbytes] = bytes(offset + self.nbytes - pos)
        return self.nbytes


def plan_pytree(tree: Any) -> EncodePlan:
    """Stage one of :func:`encode_pytree`: flatten + size (CUDA leaves are
    copied to the host here, through :func:`_host_leaves`)."""
    tree = _host_leaves(tree)
    leaves: List[np.ndarray] = []
    recs: List[Dict] = []
    schema = _build_schema(tree, leaves, recs)
    offset = 0
    for rec, arr in zip(recs, leaves):
        rec["o"] = offset
        rec["n"] = int(arr.nbytes)
        offset = _align(offset + arr.nbytes)
    header = json.dumps({"schema": schema, "leaves": recs},
                        separators=(",", ":")).encode()
    return EncodePlan(header, recs, leaves)


def encode_pytree(tree: Any) -> bytearray:
    """Serialize a pytree into one self-describing, aligned blob: the
    reference's bytes, returned as the ``bytearray`` they were written
    into (the reference copies them into ``bytes`` once more).

    Leaf offsets are relative to the data section (which starts at the
    first alignment boundary after the header), so the header never
    depends on its own serialized length.
    """
    plan = plan_pytree(tree)
    buf = bytearray(plan.nbytes)
    plan.write_into(buf)
    return buf


def _rebuild(schema: Dict, arrays: List[Any]) -> Any:
    t = schema["t"]
    if t == "none":
        return None
    if t == "py":
        return schema["v"]
    if t == "arr":
        return arrays[schema["i"]]
    if t == "dict":
        return {k: _rebuild(c, arrays)
                for k, c in zip(schema["k"], schema["c"])}
    if t == "tuple":
        return tuple(_rebuild(c, arrays) for c in schema["c"])
    if t == "list":
        return [_rebuild(c, arrays) for c in schema["c"]]
    raise CodecError(f"unknown schema node type {t!r}")


def _bf16(arr: np.ndarray) -> torch.Tensor:
    """A bf16 leaf's ``int16`` bits as a CPU ``torch.bfloat16`` tensor
    that owns its memory."""
    return torch.from_numpy(np.array(arr)).view(torch.bfloat16)


def _tensor(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """An array leaf as a tensor on ``device`` that owns its memory."""
    with warnings.catch_warnings():   # a read-only view, copied at once
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if name == _BF16:
        t = t.view(torch.bfloat16)
    if torch.device(device).type == "cpu":
        return t.clone()
    return t.to(device)


def decode_pytree(buf: Union[bytes, bytearray, memoryview], *,
                  copy: bool = False, device=None) -> Any:
    """Decode a blob produced by :func:`encode_pytree` (of either
    package).

    Without ``device``, array leaves come back as numpy: with
    ``copy=False`` (default) as views into ``buf`` — zero-copy; the views
    keep ``buf`` alive — and with ``copy=True`` as independent arrays. A
    ``"bfloat16"`` leaf comes back as a CPU ``torch.bfloat16`` tensor of
    its own. With ``device``, every array leaf comes back as a tensor on
    that device that owns its memory (0-d numpy scalars stay scalars).
    """
    view = memoryview(buf)
    if len(view) < PREAMBLE_SIZE:
        raise CodecError(f"blob shorter than preamble ({len(view)} bytes)")
    magic, version, hlen, total = _PREAMBLE.unpack_from(view, 0)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != WIRE_VERSION:
        raise CodecError(f"wire version {version} unsupported "
                         f"(speak {WIRE_VERSION})")
    if len(view) < total:
        raise CodecError(f"truncated blob: {len(view)} < {total} bytes")
    header = json.loads(bytes(view[PREAMBLE_SIZE:PREAMBLE_SIZE + hlen]))
    data_start = _align(PREAMBLE_SIZE + hlen)
    arrays: List[Any] = []
    for rec in header["leaves"]:
        dt = _dtype_from_name(rec["d"])
        start = data_start + rec["o"]
        raw = view[start:start + rec["n"]]
        arr = np.frombuffer(raw, dtype=dt).reshape(rec["s"])
        if rec.get("g"):                   # round-trip 0-d numpy scalars
            arrays.append(arr.copy()[()])
        elif device is not None:
            arrays.append(_tensor(arr, rec["d"], device))
        elif rec["d"] == _BF16:
            arrays.append(_bf16(arr))
        else:
            arrays.append(arr.copy() if copy else arr)
    return _rebuild(header["schema"], arrays)


# ---------------------------------------------------------------------------
# message framing (RPC envelope: JSON header + optional binary body)
# ---------------------------------------------------------------------------

#: bodies up to this size are coalesced into the preamble+header sendall
#: — one syscall (and one thread wake on the receiver) per frame instead
#: of two; bigger bodies go separately to avoid the concat copy
_SEND_COALESCE_MAX = 1 << 18


def recv_exact(stream, n: int) -> Optional[bytearray]:
    """Read exactly ``n`` bytes; None on clean EOF before any byte.

    ``stream`` is a socket OR any buffered reader with ``readinto``
    (e.g. ``sock.makefile("rb")``) — a streaming consumer reads many
    small frames per syscall through the buffer, which is most of the
    pipelined put path's win on the ack stream.
    """
    buf = bytearray(n)
    view = memoryview(buf)
    reader = getattr(stream, "recv_into", None) or stream.readinto
    got = 0
    while got < n:
        k = reader(view[got:])
        if not k:
            if got == 0:
                return None
            raise CodecError(f"connection closed mid-frame "
                             f"({got}/{n} bytes)")
        got += k
    return buf


def frame_bytes(header: Dict, body: Union[bytes, memoryview] = b"") -> bytes:
    """One framed message as bytes — for senders that coalesce several
    frames into a single ``sendall`` (the pipelined put stream)."""
    hj = json.dumps(header, separators=(",", ":")).encode()
    pre = _PREAMBLE.pack(MAGIC, WIRE_VERSION, len(hj), len(body))
    return pre + hj + bytes(body)


def send_frame(sock: socket.socket, header: Dict,
               body: Union[bytes, memoryview] = b"") -> int:
    """Write one framed message; returns bytes sent."""
    hj = json.dumps(header, separators=(",", ":")).encode()
    pre = _PREAMBLE.pack(MAGIC, WIRE_VERSION, len(hj), len(body))
    if 0 < len(body) <= _SEND_COALESCE_MAX:
        if not isinstance(body, bytes):
            body = bytes(body)
        sock.sendall(pre + hj + body)
    else:
        sock.sendall(pre + hj)
        if len(body):
            sock.sendall(body)
    return len(pre) + len(hj) + len(body)


def recv_frame(stream) -> Optional[Tuple[Dict, bytes]]:
    """Read one framed message (socket or buffered reader — see
    :func:`recv_exact`); None when the peer closed cleanly."""
    pre = recv_exact(stream, PREAMBLE_SIZE)
    if pre is None:
        return None
    magic, version, hlen, blen = _PREAMBLE.unpack_from(pre, 0)
    if magic != MAGIC:
        raise CodecError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise CodecError(f"frame wire version {version} unsupported")
    hdr = recv_exact(stream, hlen)
    if hdr is None:
        raise CodecError("connection closed before frame header")
    header = json.loads(bytes(hdr))
    body = b""
    if blen:
        got = recv_exact(stream, blen)
        if got is None:
            raise CodecError("connection closed before frame body")
        body = bytes(got)
    return header, body
