"""The port's transport (``repro_torch.runtime.transport``) against the
reference's (``repro.runtime.transport``), in one process: the codec's
blobs byte for byte (numpy trees, and bridged bf16 trees of tensors) and
each package decoding the other's; an ``ShmRing`` written by one package
and read by the other; port channels (``SocketChannel``,
``ShmRingChannel``, ``PutStream``) against a reference ``TransportServer``
and the reverse, segments equal field for field; the weight wire both
ways and through the port's lane; ``RestartPolicy``'s decisions on
scripted exit sequences; the serialized and disk weight transports bit
for bit; and the fault/trace gates raising. Exact: every comparison is of
bytes, bits or values."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import experience as jexp
from repro.runtime import transport as jtr
from repro.runtime.transport import ring as jring
from repro.runtime.transport import supervision as jsup
from repro.runtime.weight_store import VersionedWeightStore as JStore
from repro_torch.runtime import (DiskTransport, SerializedTransport,
                                 VersionedWeightStore)
from repro_torch.runtime import experience as texp
from repro_torch.runtime import transport as ttr
from repro_torch.runtime.rollout import episode_to_segments
from repro_torch.runtime.transport import codec as tcodec
from repro_torch.runtime.transport import ring as tring
from repro_torch.runtime.transport import supervision as tsup

shared_memory = pytest.importorskip("multiprocessing.shared_memory")


def _numpy_tree(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i64": np.arange(7, dtype=np.int64),
        "empty": np.zeros((0, 4), np.float16),
        "zero_d": np.array(2.5),
        "flags": rng.integers(0, 2, 9).astype(bool),
        "scalar": np.int32(3),
        "nested": [(None, True, 1.5, "x"), {"u8": np.arange(5, dtype=np.uint8)}],
        "bf16": rng.standard_normal((17, 3)).astype(ml_dtypes.bfloat16),
    }


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_codec_numpy_trees_encode_to_the_same_bytes():
    rng = np.random.default_rng(0)
    tree = _numpy_tree(rng)
    blob = jtr.encode_pytree(tree)
    assert tcodec.encode_pytree(tree) == blob
    plan = tcodec.plan_pytree(tree)
    buf = bytearray(b"\xee" * (plan.nbytes + 8))
    plan.write_into(buf, 8)                  # in place, over stale bytes
    assert bytes(buf[8:]) == blob
    # the port decodes the reference's blob: numpy, bf16 as a tensor
    got = tcodec.decode_pytree(blob)
    np.testing.assert_array_equal(got["f32"], tree["f32"])
    assert got["scalar"] == 3 and isinstance(got["scalar"], np.int32)
    assert got["nested"][0] == (None, True, 1.5, "x")
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got["bf16"]),
                                  _bf16_bits(tree["bf16"]))
    with pytest.raises(tcodec.CodecError):
        tcodec.decode_pytree(blob[:-64])


def test_codec_bridged_bf16_trees_cross_both_ways_bit_for_bit():
    rng = np.random.default_rng(1)
    ref = {"w": rng.standard_normal((33, 8)).astype(ml_dtypes.bfloat16),
           "b": rng.standard_normal(8).astype(np.float32),
           "layers": {"wq": rng.standard_normal((2, 8, 4))
                      .astype(ml_dtypes.bfloat16)},
           "step": np.array(4, np.int32)}
    port = {"w": torch.from_numpy(ref["w"].view(np.int16)).view(
                torch.bfloat16),
            "b": torch.from_numpy(ref["b"]),
            "layers": {"wq": torch.from_numpy(
                ref["layers"]["wq"].view(np.int16)).view(torch.bfloat16)},
            "step": torch.tensor(4, dtype=torch.int32)}
    blob = tcodec.encode_pytree(port)
    assert blob == jtr.encode_pytree(ref)
    back = jtr.decode_pytree(blob)               # the reference reads it
    assert back["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bf16_bits(back["w"]), _bf16_bits(ref["w"]))
    on_dev = tcodec.decode_pytree(jtr.encode_pytree(ref), device="cpu")
    for key in ("w", "b", "step"):
        assert isinstance(on_dev[key], torch.Tensor)
        assert on_dev[key].dtype == port[key].dtype
    assert torch.equal(on_dev["w"].view(torch.int16),
                       port["w"].view(torch.int16))
    assert torch.equal(on_dev["layers"]["wq"].view(torch.int16),
                       port["layers"]["wq"].view(torch.int16))
    assert on_dev["w"].untyped_storage().data_ptr() != \
        port["w"].untyped_storage().data_ptr()


@pytest.mark.parametrize("writer,reader", [(tring, jring), (jring, tring)])
def test_ring_written_by_one_package_reads_in_the_other(writer, reader):
    w = writer.ShmRing.create(1 << 12)
    r = reader.ShmRing.attach(w.name)
    try:
        rng = np.random.default_rng(2)
        payloads = [rng.bytes(int(n)) for n in rng.integers(1, 1500, 40)]
        got = []
        for p in payloads:                   # wraps and splits records
            assert w.push(p, timeout=1.0)
            got.append(r.pop(timeout=1.0))
        assert got == payloads
        view = w.reserve(100, timeout=1.0)   # the reserve/commit path
        view[:] = b"\x07" * 100
        view.release()
        w.commit()
        assert r.pop(timeout=1.0) == b"\x07" * 100
        assert r.stats()["items_popped"] == len(payloads) + 1
        pos, seq = w.publish_blob(b"lane blob")  # the broadcast lane
        assert r.read_at(pos, seq, 9) == b"lane blob"
    finally:
        r.close()
        w.close()
        w.unlink()


def _segments(n_episodes=3, horizon=4, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for ep in range(n_episodes):
        t = int(rng.integers(3, 10))
        traj = {
            "obs_tokens": [rng.integers(0, 256, 12).astype(np.int32)
                           for _ in range(t + 1)],
            "frames": [rng.random(192).astype(np.float32)
                       for _ in range(t + 1)],
            "actions": [rng.integers(0, 64, 7).astype(np.int32)
                        for _ in range(t + 1)],
            "behavior_logp": [np.log(rng.uniform(0.05, 0.9, 7))
                              .astype(np.float32) for _ in range(t + 1)],
            "values": [float(v) for v in rng.standard_normal(t + 1)],
            "rewards": [float(r) for r in rng.uniform(-1, 1, t)],
            "dones": [0.0] * (t - 1) + [1.0],
            "steps": list(range(t + 1)),
            "policy_version": ep, "task_id": ep % 10, "success": 0.0,
        }
        segs += episode_to_segments(traj, horizon)
    return segs


def _assert_segments_equal(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert sorted(g) == sorted(e)
        for k in e:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(e[k]), err_msg=k)


# server package, client package
PAIRS = [((jtr, jexp), (ttr, texp)), ((ttr, texp), (jtr, jexp))]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS,
                         ids=["port-clients", "reference-clients"])
def test_channels_cross_the_packages_field_for_field(server_pkg,
                                                     client_pkg):
    (s_tr, s_exp), (c_tr, _) = server_pkg, client_pkg
    chan = s_exp.FifoChannel(256)
    server = s_tr.TransportServer().start()
    server.add_channel("experience", chan)
    segs = _segments()
    clients = []
    try:
        sock = c_tr.SocketChannel(server.address, "experience")
        clients.append(sock)
        assert sock.put_many(segs[:4]) == [True] * 4
        assert sock.put(segs[4])
        assert len(sock) == 5
        _assert_segments_equal(sock.pop_batch(5, timeout=2.0), segs[:5])
        ring = c_tr.ShmRingChannel(server.address, "experience",
                                   ring_bytes=1 << 20, put_window=4)
        clients.append(ring)
        ring.put_many(segs[5:])
        assert ring._put_stream().flush(timeout=5.0)   # then the next stream
        stream = c_tr.PutStream(server.address, "experience", window=2)
        clients.append(stream)
        stream.put_many(segs[:3])
        assert stream.flush(timeout=5.0)
        assert stream.stats()["items_accepted"] == 3
        got = ring.pop_many(64, timeout=2.0)
        while len(got) < len(segs) - 5 + 3:
            got += ring.pop_many(64, timeout=2.0)
        _assert_segments_equal(got, segs[5:] + segs[:3])
        assert server.metrics.counter("ring_records_in") > 0
        assert server.metrics.counter("ring_records_out") > 0
    finally:
        for c in clients:
            c.close()
        server.stop()
        server.join()


def _weights(rng):
    return {"embed": {"table": rng.standard_normal((40, 8))
                      .astype(ml_dtypes.bfloat16)},
            "head": {"w": rng.standard_normal((8, 6)).astype(np.float32)}}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(tree)


def test_weight_wire_crosses_the_packages_bit_for_bit():
    rng = np.random.default_rng(3)
    ref_params = _weights(rng)
    port_params = _as_tensors(ref_params)
    # a port client against a reference server
    jstore = JStore()
    jserver = jtr.TransportServer().start()
    jserver.set_store(jstore)
    jstore.publish(ref_params, 1)
    client = ttr.WeightStoreTransport(jserver.address, device="cpu")
    try:
        got, version = client.acquire(newer_than=0, timeout=5.0)
        assert version == 1 and client.version() == 1
        assert torch.equal(got["embed"]["table"].view(torch.int16),
                           port_params["embed"]["table"].view(torch.int16))
        assert torch.equal(got["head"]["w"], port_params["head"]["w"])
    finally:
        client.close()
        jserver.stop()
        jserver.join()
    # a reference client against a port server, and the port's lane
    store = VersionedWeightStore()
    server = ttr.TransportServer(weight_lane_bytes=1 << 16).start()
    assert server.lane_ready.wait(timeout=5.0)      # warmed at start
    server.set_store(store)
    store.publish(port_params, 2)
    jclient = jtr.WeightStoreTransport(server.address)
    lane = ttr.WeightStoreTransport(server.address, use_lane=True,
                                    device="cpu")
    try:
        got, version = jclient.acquire(newer_than=-1, timeout=5.0)
        assert version == 2
        np.testing.assert_array_equal(
            _bf16_bits(got["embed"]["table"]),
            _bf16_bits(ref_params["embed"]["table"]))
        got, _ = lane.acquire(newer_than=1, timeout=5.0)
        assert lane.lane_hits == 1
        assert torch.equal(got["embed"]["table"].view(torch.int16),
                           port_params["embed"]["table"].view(torch.int16))
        assert server.metrics.counter("weight_encodes") == 1
    finally:
        jclient.close()
        lane.close()
        server.stop()
        server.join()


class _FakeServer:
    def register_worker_sink(self, name, host):
        pass

    def set_hello_handler(self, handler):
        pass


class _ScriptedEndpoint:
    """A spawned incarnation whose liveness follows a script: each
    ``failure()`` call pops the next verdict (None = alive)."""

    mode = "spawn"

    def __init__(self, verdicts):
        self.verdicts = list(verdicts)
        self.launches = 0

    def launch(self, spec):
        self.launches += 1

    def failure(self):
        return self.verdicts.pop(0) if self.verdicts else None

    def note_report(self):
        pass

    def shutdown(self, timeout=5.0):
        pass


def _script(tr, sup_mod, policy_kw, verdicts, clock):
    spec = tr.RemoteWorkerSpec(name="w", cfg=None, rl=None, rt=None,
                               address=("127.0.0.1", 1))
    sup = sup_mod.Supervisor(_FakeServer(), sup_mod.RestartPolicy(**policy_kw))
    endpoint = _ScriptedEndpoint(verdicts)
    slot = sup_mod.SupervisedWorker(spec, endpoint, _FakeServer())
    sup.slots.append(slot)
    with slot.lock:
        sup._launch(slot)
    trace = []
    for now in clock:
        sup._step(slot, now)
        trace.append((slot.phase, slot.restarts, slot.incarnation,
                      round(slot.relaunch_at, 9), endpoint.launches,
                      None if slot.error is None else str(slot.error)))
    return trace


@pytest.mark.parametrize("policy_kw,verdicts", [
    (dict(mode="never"), [None, "died (1)"]),
    (dict(mode="on_failure", max_restarts=2, backoff_initial_s=0.1),
     [None, "died (1)", None, "died (2)", None, None, "died (3)"]),
    (dict(mode="on_failure", max_restarts=2, window_s=0.5,
          backoff_initial_s=0.05, backoff_factor=3.0, backoff_max_s=0.1),
     ["died", None, "died", None, None, "died", None, "died"]),
    (dict(mode="on_failure", max_restarts=0), ["died"]),
])
def test_restart_policy_decisions_equal_the_references(policy_kw, verdicts):
    clock = [0.1 * i for i in range(1, 14)]
    assert _script(ttr, tsup, policy_kw, verdicts, clock) == \
        _script(jtr, jsup, policy_kw, verdicts, clock)
    for k in range(1, 5):
        assert tsup.RestartPolicy(**policy_kw).backoff_s(k) == \
            jsup.RestartPolicy(**policy_kw).backoff_s(k)
    with pytest.raises(ValueError):
        tsup.RestartPolicy(mode="always")


def test_serialized_and_disk_transports_round_trip_bit_for_bit(tmp_path):
    params = _as_tensors(_weights(np.random.default_rng(4)))
    for transport in (SerializedTransport(), DiskTransport(str(tmp_path))):
        store = VersionedWeightStore(transport=transport)
        store.publish(params, 0)
        got, version = store.acquire(timeout=1.0)
        assert version == 0
        for group in params:
            for k, x in params[group].items():
                y = got[group][k]
                assert y.dtype == x.dtype and y.device == x.device
                assert torch.equal(y.view(torch.int16) if y.dtype ==
                                   torch.bfloat16 else y,
                                   x.view(torch.int16) if x.dtype ==
                                   torch.bfloat16 else x)
    tree = {"w": np.arange(6, dtype=np.float32)}
    got = SerializedTransport().recv(SerializedTransport().send(tree))
    assert isinstance(got["w"], np.ndarray)


@pytest.mark.parametrize("var", ["REPRO_FAULTS", "REPRO_TRACE"])
def test_unported_gates_raise(monkeypatch, var):
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match="A6b"):
        ttr.TransportServer()
    with pytest.raises(NotImplementedError, match="A6b"):
        ttr.ShmRing.create(1 << 10)
    monkeypatch.delenv(var)
    server = ttr.TransportServer().start()
    try:
        with pytest.raises(NotImplementedError, match="A6b"):
            server.set_inference(object())
        with pytest.raises(NotImplementedError, match="A6b"):
            server.resume_from_journal()
        client = ttr.WireClient(server.address)
        with pytest.raises(ttr.TransportError, match="A6b"):
            client.request({"m": "infer.open"})
        client.close()
    finally:
        server.stop()
        server.join()


def test_prefetcher_releases_zero_copy_ring_leases():
    from repro_torch.data.prefetch import Prefetcher
    from repro_torch.runtime.trainer import collate_segments
    chan = texp.FifoChannel(64)
    server = ttr.TransportServer().start()
    server.add_channel("experience", chan)
    segs = _segments(n_episodes=4)[:8]
    for seg in segs:
        assert chan.put(seg)
    source = ttr.ShmRingChannel(server.address, "experience",
                                ring_bytes=1 << 20, zero_copy_pop=True)
    pf = Prefetcher(source, 4, collate_segments, device="cpu").start()
    try:
        got = [pf.get(timeout=5.0) for _ in range(2)]
        want = [collate_segments(segs[:4]), collate_segments(segs[4:])]
        for g, w in zip(got, want):
            for field, x, y in zip(w._fields, g, w):
                np.testing.assert_array_equal(x, y, err_msg=field)
        assert pf.views_served == len(segs)
        assert pf.metrics()["views_served"] == len(segs)
        stats = source.ring_stats()
        assert stats["views_served"] >= 1 and stats["views_live"] == 0
    finally:
        pf.stop()
        source.close()
        server.stop()
        server.join()
