"""The port's journal, fault plan and elastic autoscaler against the
reference's: ``FaultPlan`` fires on the same hits for the same spec and seed
(``nth``, ``every``, ``prob``); a journal driven through both packages with
the same seeded operations is byte for byte the same file, and every
committed prefix of it (a torn final record included, and a snapshot plus
any prefix of the log after a compaction) recovers the state of a plain
model that never crashed, through either package's ``recover``; journals
cross between the packages (numpy items, bf16 by bits, a bf16 tensor tree
published from the port); compaction keeps the newest publish; a port
server resumes a journal over the wire; an injected reset drives the
client's redial; and a scripted signal sequence gives the same scale-ups,
drains and retirements from both packages' ``Supervisor``. Exact: every
comparison is of bytes, bits or values."""
import random
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.runtime import experience as jexp
from repro.runtime.transport import faults as jfaults
from repro.runtime.transport import resilience as jres
from repro.runtime.transport import supervision as jsup
from repro_torch.runtime import experience as texp
from repro_torch.runtime.transport import faults as tfaults
from repro_torch.runtime.transport import resilience as tres
from repro_torch.runtime.transport import supervision as tsup

PKGS = {"port": (tres, texp), "reference": (jres, jexp)}


def _item(i):
    return {"i": np.int32(i), "x": np.full(3, i, np.float32)}


def _ids(items):
    return [int(x["i"]) for x in items]


def _store_params(state):
    """The newest recovered publish, the port's onto the CPU (its default
    is the card)."""
    if isinstance(state, tres.RecoveredState):
        return state.store_params(device="cpu")
    return state.store_params()


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "delay@p:nth=3,ms=0",
    "delay@p:every=4,ms=0;delay@q:nth=1,ms=0",
    "delay@p:prob=0.3,ms=0,seed=5;delay@q:prob=0.7,ms=0",
    "delay@p:ms=0",
])
def test_fault_plans_fire_on_the_same_hits(spec):
    fired = {}
    for side, mod in (("port", tfaults), ("reference", jfaults)):
        plan = mod.FaultPlan.from_spec(spec, seed=11)
        seq = []
        for hit in range(64):
            point = "p" if hit % 3 else "q"
            before = plan.snapshot().get(point, {"fired": 0})["fired"]
            plan.hit(point)
            seq.append(plan.snapshot()[point]["fired"] - before)
        fired[side] = (seq, plan.snapshot())
    assert fired["port"] == fired["reference"]
    assert any(fired["port"][0])


def test_fault_kinds_and_grammar_match_the_reference():
    from repro_torch.runtime.transport.ring import RingError
    plan = tfaults.FaultPlan.from_spec("reset@a:nth=2;torn@b")
    plan.hit("a")
    with pytest.raises(tfaults.InjectedReset):
        plan.hit("a")
    with pytest.raises(tfaults.InjectedTorn):
        plan.hit("b")
    assert isinstance(tfaults.InjectedReset(""), ConnectionResetError)
    assert isinstance(tfaults.InjectedTorn(""), RingError)
    for bad in ("boom@p", "reset", "reset@p:nth"):
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError):
                mod.FaultPlan.from_spec(bad)


def test_an_injected_reset_drives_the_client_redial(monkeypatch):
    """A reset at the server's frame point (armed through the module
    seam the env gate populates) kills the connection before dispatch;
    the client's reconnect budget absorbs it and nothing is applied
    twice."""
    from repro_torch.runtime.transport import SocketChannel, TransportServer
    from repro_torch.runtime.transport import server as server_mod
    monkeypatch.setenv(tfaults.ENV_VAR, "reset@server.frame:nth=3")
    tfaults.reset_plan()
    monkeypatch.setattr(server_mod, "_fault", tfaults.fault_point)
    srv = TransportServer()
    local = texp.FifoChannel(256)
    srv.add_channel("exp", local)
    srv.start()
    try:
        chan = SocketChannel(srv.address, "exp", reconnect_attempts=10,
                             reconnect_backoff_s=0.01)
        for i in range(6):
            assert chan.put(_item(i))
        assert _ids(local.drain()) == list(range(6))
        assert chan._client.reconnects >= 1
        chan.close()
    finally:
        srv.stop()
        srv.join()
        tfaults.reset_plan()


# ---------------------------------------------------------------------------
# the journal: byte parity, prefixes, snapshots, torn tails, compaction
# ---------------------------------------------------------------------------

def _drive(res, exp, directory, seed, n_ops, compact_at=None):
    """Seeded ops through a journaled FIFO of capacity 8 (puts, pops,
    stream watermarks, publishes), mirrored on a plain model; returns the
    model's state after every record appended to the log in use at the
    end (the first entry is the state the log starts from)."""
    rng = random.Random(seed)
    journal = res.TransportJournal(directory, compact_bytes=1 << 30)
    chan = journal.wrap("exp", exp.FifoChannel(8, policy="drop_oldest"))
    state = {"items": [], "next": 0, "seq": -1, "version": 0}
    expected = [dict(state, items=[])]
    for op_no in range(n_ops):
        if op_no == compact_at:
            journal.compact(lambda: [
                ("stream_snap", {"chan": "exp", "stream": "s0",
                                 "seq": state["seq"], "acks": {},
                                 "window": 8, "ack_every": 1}, b"")])
            expected = [dict(state, items=list(state["items"]))]
        op = rng.choice(["put", "put", "put", "pop", "stream", "publish"])
        if op == "put":
            k = rng.randint(1, 4)
            items = [_item(state["next"] + j) for j in range(k)]
            state["next"] += k
            assert chan.put_many(items) == [True] * k
            state["items"] = (state["items"] + _ids(items))[-8:]
        elif op == "pop":
            got = chan.pop_batch(rng.randint(1, 3), timeout=0)
            if got is None:
                continue
            assert _ids(got) == state["items"][:len(got)]
            del state["items"][:len(got)]
        elif op == "stream":
            state["seq"] += 1
            journal.append("stream", {"chan": "exp", "stream": "s0",
                                      "seq": state["seq"],
                                      "verdicts": [True], "window": 8,
                                      "ack_every": 1})
        else:
            state["version"] += 1
            journal.note_publish(
                {"w": np.full(4, state["version"], np.float32),
                 "b": np.full(2, state["version"], ml_dtypes.bfloat16)},
                state["version"])
        expected.append(dict(state, items=list(state["items"])))
    journal.close()
    return expected


def _offsets(path):
    """Every record boundary of a journal file."""
    data = path.read_bytes()
    off, out = len(tres.JOURNAL_MAGIC), [len(tres.JOURNAL_MAGIC)]
    while off < len(data):
        off += 8 + struct.unpack_from("<I", data, off)[0]
        out.append(off)
    assert off == len(data)
    return out


def _matches(got, want):
    assert _ids(got.channel_items("exp")) == want["items"]
    if want["seq"] >= 0:
        assert got.streams[("exp", "s0")]["last_seq"] == want["seq"]
    else:
        assert ("exp", "s0") not in got.streams
    if want["version"] > 0:
        assert got.store[0] == want["version"]
    else:
        assert got.store is None


def test_journals_are_byte_for_byte_the_reference(tmp_path):
    for side, (res, exp) in PKGS.items():
        _drive(res, exp, tmp_path / side, seed=3, n_ops=40, compact_at=25)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "reference")
                           .iterdir()) == ["log-00000001.bin",
                                           "snap-00000001.bin"]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "reference" / name).read_bytes())


@pytest.mark.parametrize("compact_at", [None, 20])
def test_every_journal_prefix_recovers_the_model_state(tmp_path,
                                                       compact_at):
    """Without a compaction, the log alone; with one, the snapshot plus
    any prefix of the log after it. Each prefix recovers through both
    packages' ``recover``; a cut inside the last record recovers the
    state before it, flagged torn."""
    d = tmp_path / "j"
    expected = _drive(tres, texp, d, seed=7, n_ops=45,
                      compact_at=compact_at)
    gen = 0 if compact_at is None else 1
    log = d / f"log-{gen:08d}.bin"
    offsets = _offsets(log)
    meta = 1 if compact_at is None else 0        # wrap()'s chan_meta
    assert len(offsets) == len(expected) + meta
    raw = log.read_bytes()
    pdir = tmp_path / "prefix"
    pdir.mkdir()
    if compact_at is not None:
        snap = d / f"snap-{gen:08d}.bin"
        (pdir / snap.name).write_bytes(snap.read_bytes())
    plog = pdir / log.name
    for k in range(1 + meta, len(offsets) + 1):
        plog.write_bytes(raw[:offsets[k - 1]])
        for res in (tres, jres):
            got = res.recover(pdir)
            assert got.base_gen == gen and not got.torn_tail
            _matches(got, expected[k - 1 - meta])
    for cut in (1, 7, offsets[-1] - offsets[-2] - 1):
        plog.write_bytes(raw[:offsets[-2] + cut])
        for res in (tres, jres):
            got = res.recover(pdir)
            assert got.torn_tail
            _matches(got, expected[-2])


def test_resume_truncates_a_torn_tail_and_continues(tmp_path):
    d = tmp_path / "j"
    journal = tres.TransportJournal(d)
    chan = journal.wrap("exp", texp.FifoChannel(64))
    chan.put_many([_item(i) for i in range(4)])
    journal.close()
    with pytest.raises(ValueError, match="resume"):
        tres.TransportJournal(d)
    with (d / "log-00000000.bin").open("ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")     # a half-written record
    assert tres.recover(d).torn_tail
    j2 = tres.TransportJournal(d, resume=True)
    assert j2.torn_truncated == 1
    j2.wrap("exp", texp.FifoChannel(64)).put_many(
        [_item(i) for i in range(4, 7)])
    j2.close()
    for res in (tres, jres):
        got = res.recover(d)
        assert _ids(got.channel_items("exp")) == list(range(7))
        assert not got.torn_tail


def test_compaction_keeps_the_newest_publish(tmp_path):
    d = tmp_path / "j"
    journal = tres.TransportJournal(d, compact_bytes=256)
    chan = journal.wrap("exp", texp.FifoChannel(8))
    journal.note_publish({"w": np.arange(4, dtype=np.float32)}, 1)
    journal.note_publish({"w": np.arange(4, dtype=np.float32) * 2}, 2)
    compactions = 0
    for i in range(20):
        chan.put_many([_item(i)])
        if journal.should_compact():
            journal.compact()
            compactions += 1
    journal.close()
    assert compactions >= 2
    gens = {int(p.name.split("-")[1][:8]) for p in d.iterdir()}
    assert len(gens) <= 2, sorted(p.name for p in d.iterdir())
    for res in (tres, jres):
        got = res.recover(d)
        assert _ids(got.channel_items("exp")) == list(range(12, 20))
        params, version = _store_params(got)
        assert version == 2
        np.testing.assert_array_equal(params["w"],
                                      np.arange(4, dtype=np.float32) * 2)


def _bf16_tree(n, seed):
    bits = np.random.default_rng(seed).integers(
        -2 ** 15, 2 ** 15, n).astype(np.int16)
    return {"w": torch.from_numpy(bits).view(torch.bfloat16),
            "f": torch.arange(3, dtype=torch.float32)}


def test_a_large_publish_is_journaled_in_pieces(tmp_path, monkeypatch):
    """A publish over ``PUBLISH_PIECE`` goes in ``publish_part`` records
    that the port reassembles bit for bit (from the log and from a
    snapshot); a publish cut short by a crash is ignored, as a torn
    record is, and a later complete one is recovered past it. The
    reference's ``recover`` skips the pieces and keeps the rest."""
    monkeypatch.setattr(tres, "PUBLISH_PIECE", 512)
    d = tmp_path / "j"
    journal = tres.TransportJournal(d)
    chan = journal.wrap("exp", texp.FifoChannel(16))
    chan.put_many([_item(i) for i in range(3)])
    journal.note_publish({"w": np.arange(4, dtype=np.float32)}, 1)
    big = _bf16_tree(2000, 0)
    journal.note_publish(big, 2)
    chan.put_many([_item(3)])
    journal.close()
    log = d / "log-00000000.bin"
    recs, torn, _ = tres.read_records(log)
    ops = [h["op"] for h, _ in recs]
    parts = [h for h, _ in recs if h["op"] == "publish_part"]
    assert not torn and ops.count("publish") == 1 and len(parts) >= 8
    assert [h["part"] for h in parts] == list(range(parts[0]["parts"]))
    assert all(len(b) <= 512 for h, b in recs if h["op"] == "publish_part")

    def check(state, version, tree, ids):
        params, got_v = _store_params(state)
        assert got_v == version
        np.testing.assert_array_equal(_bits(params["w"]), _bits(tree["w"]))
        assert _ids(state.channel_items("exp")) == ids

    check(tres.recover(d), 2, big, [0, 1, 2, 3])
    check(jres.recover(d), 1, {"w": np.arange(4, dtype=np.float32)},
          [0, 1, 2, 3])
    # a crash after three parts of the publish: the pieces recover
    # nothing, and a resumed journal's complete publish is recovered
    cut = _offsets(log)[ops.index("publish_part") + 3]
    log.write_bytes(log.read_bytes()[:cut])
    state = tres.recover(d)
    assert not state.torn_tail
    check(state, 1, {"w": np.arange(4, dtype=np.float32)}, [0, 1, 2])
    journal = tres.TransportJournal(d, resume=True)
    big3 = _bf16_tree(1500, 1)
    journal.note_publish(big3, 3)
    check(tres.recover(d), 3, big3, [0, 1, 2])
    journal.wrap("exp", texp.FifoChannel(16))
    journal.compact()
    journal.close()
    snap = d / "snap-00000001.bin"
    assert sum(h["op"] == "publish_part"
               for h, _ in tres.read_records(snap)[0]) >= 6
    state = tres.recover(d)
    assert state.base_gen == 1
    check(state, 3, big3, [])


def test_a_record_over_max_record_is_refused(tmp_path, monkeypatch):
    """No record the recovery would read as torn is ever written: an
    oversized put is refused before the channel takes it, an oversized
    record or single-record publish raises, and the journal resumes with
    no torn tail to truncate."""
    monkeypatch.setattr(tres, "MAX_RECORD", 1024)
    d = tmp_path / "j"
    journal = tres.TransportJournal(d)
    chan = journal.wrap("exp", texp.FifoChannel(16))
    chan.put_many([_item(i) for i in range(2)])
    big_item = {"i": np.int32(9), "x": np.zeros(1024, np.float32)}
    with pytest.raises(ValueError, match="MAX_RECORD"):
        chan.put_many([big_item])
    assert _ids(chan.peek_all()) == [0, 1]
    with pytest.raises(ValueError, match="MAX_RECORD"):
        journal.append("put", {"chan": "exp", "count": 1}, b"\0" * 2048)
    tree = _bf16_tree(2000, 2)
    with pytest.raises(ValueError, match="MAX_RECORD"):
        journal.note_publish(tree, 1)
    monkeypatch.setattr(tres, "PUBLISH_PIECE", 512)
    journal.note_publish(tree, 2)
    journal.close()
    resumed = tres.TransportJournal(d, resume=True)
    assert resumed.torn_truncated == 0
    resumed.close()
    state = tres.recover(d)
    assert not state.torn_tail and _ids(state.channel_items("exp")) == [0, 1]
    params, version = _store_params(state)
    assert version == 2
    np.testing.assert_array_equal(_bits(params["w"]), _bits(tree["w"]))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_journals_cross_between_the_packages(tmp_path):
    """A reference journal (numpy items, an ml_dtypes bf16 publish)
    recovered by the port, onto the CPU as tensors bit for bit; a port
    journal (numpy items, a bf16 tensor tree published) recovered by the
    reference, its bf16 leaves as ml_dtypes arrays of the same bits."""
    rng = np.random.default_rng(0)
    bf16 = rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16)
    items = [dict(_item(i), b=bf16[i]) for i in range(5)]
    for writer, reader in ((jres, tres), (tres, jres)):
        d = tmp_path / writer.__name__
        journal = writer.TransportJournal(d)
        exp = jexp if writer is jres else texp
        chan = journal.wrap("exp", exp.FifoChannel(8))
        chan.put_many(items)
        chan.pop_batch(2, timeout=0)
        if writer is jres:
            journal.note_publish({"w": bf16, "f": np.ones(2, np.float32)},
                                 4)
        else:
            journal.note_publish({"w": torch.from_numpy(
                bf16.view(np.int16)).view(torch.bfloat16),
                "f": torch.ones(2)}, 4)
        journal.close()
        got = reader.recover(d)
        assert _ids(got.channel_items("exp")) == [2, 3, 4]
        for x, want in zip(got.channel_items("exp"), items[2:]):
            np.testing.assert_array_equal(_bits(x["b"]), _bits(want["b"]))
        params, version = _store_params(got)
        assert version == 4
        np.testing.assert_array_equal(_bits(params["w"]), _bits(bf16))
        np.testing.assert_array_equal(np.asarray(params["f"]), np.ones(2))
        if reader is tres:
            on_cpu, _ = got.store_params(device="cpu")
            assert on_cpu["w"].dtype == torch.bfloat16
            assert torch.equal(on_cpu["w"].view(torch.int16),
                               torch.from_numpy(bf16.view(np.int16)))
            assert on_cpu["f"].dtype == torch.float32


def test_a_port_server_resumes_its_journal_over_the_wire(tmp_path):
    from repro_torch.runtime import VersionedWeightStore
    from repro_torch.runtime.transport import (PutStream, TransportServer,
                                               WireClient)
    from repro_torch.runtime.transport.codec import encode_pytree

    def journaled(resume):
        journal = tres.TransportJournal(tmp_path / "j", resume=resume)
        store = VersionedWeightStore()
        journal.attach_store(store)
        chan = journal.wrap("exp", texp.FifoChannel(4096))
        srv = TransportServer(journal=journal)
        srv.add_channel("exp", chan)
        srv.set_store(store)
        return srv, chan, store

    srv, chan, store = journaled(False)
    srv.start()
    s = PutStream(srv.address, "exp", window=4, stream_id="t1")
    for base in range(0, 20, 4):
        s.put_many([_item(base + j) for j in range(4)])
    assert s.flush(10.0)
    s.close()
    w = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    store.publish({"w": w}, 3)
    srv.stop()
    srv.join()

    srv2, chan2, store2 = journaled(True)
    state = srv2.resume_from_journal(device="cpu")
    assert _ids(chan2.peek_all()) == list(range(20))
    params, version = store2.acquire(timeout=1.0)
    assert version == 3 and params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"].view(torch.int16), w.view(torch.int16))
    assert state.streams[("exp", "t1")]["last_seq"] == 4
    srv2.start()
    c = WireClient(srv2.address)
    try:
        resp, _ = c.request({"m": "stream.open", "chan": "exp",
                             "stream": "t1", "window": 4})
        assert resp["last_seq"] == 4
        resp, _ = c.request({"m": "chan.put_stream", "chan": "exp",
                             "stream": "t1", "seq": 4},
                            encode_pytree([_item(16 + j) for j in range(4)]))
        assert resp.get("dup") is True and len(chan2) == 20
        resp, _ = c.request({"m": "server.stats"})
        assert resp["stats"]["journal_recovered_items"] == 20.0
        assert resp["stats"]["journal_recovered_streams"] == 1.0
    finally:
        c.close()
        srv2.stop()
        srv2.join()


def test_journaled_channel_contract(tmp_path):
    d = tmp_path / "j"
    journal = tres.TransportJournal(d)
    with pytest.raises(ValueError, match="block"):
        journal.wrap("b", texp.FifoChannel(4, policy="block"))
    with pytest.raises(TypeError, match="peek_all"):
        journal.wrap("r", texp.RingChannel(4))
    chan = journal.wrap("exp", texp.FifoChannel(2, policy="drop_newest"))
    items = [_item(i) for i in range(4)]
    assert chan.put_many(items) == [True, True, False, False]
    assert _ids(chan.pop_batch(1, timeout=0)) == [0]
    t0 = time.monotonic()
    assert chan.pop_many(3, timeout=0.05) == [items[1]]
    assert chan.pop_batch(1, timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04
    assert chan.restore([_item(9)]) == 1 and len(chan) == 1
    assert chan.stats()["journaled"] == 1.0
    journal.close()
    for res in (tres, jres):
        assert res.recover(d).channel_items("exp") == []


# ---------------------------------------------------------------------------
# the elastic autoscaler
# ---------------------------------------------------------------------------

class _StubServer:
    def register_worker_sink(self, name, host):
        pass

    def set_hello_handler(self, fn):
        pass


def _elastic_supervisor(sup, cfgs):
    class FakeEndpoint(sup.WorkerEndpoint):
        mode = "spawn"

        def __init__(self):
            self._failure = None

        def launch(self, spec):
            self._failure = None

        def failure(self):
            return self._failure

    class Elastic(sup.Supervisor):
        def _elastic_add(self, spec):
            slot = sup.SupervisedWorker(spec, FakeEndpoint(), self.server)
            slot.start()
            self.slots.append(slot)
            return slot

    def spec(seq):
        return sup.RemoteWorkerSpec(
            name=f"elastic-{seq}", cfg=cfgs.reduced(
                cfgs.get_config("deepseek-7b")), rl=cfgs.RLConfig(),
            rt=cfgs.RuntimeConfig(), address=("127.0.0.1", 1))
    return Elastic(_StubServer(), sup.RestartPolicy()), spec


def test_elastic_decisions_equal_the_reference():
    """One scripted signal sequence (starving, saturated tier, stale,
    backed up, quiet) and one worker exit, through both packages."""
    script = (
        [{"depth_frac": 0.0}] * 3
        + [{"depth_frac": 0.5, "infer_queue_depth": 9.0}] * 2
        + [{"depth_frac": 0.0, "staleness": 5.0}]
        + [{"depth_frac": 1.0}] * 3
        + [{"depth_frac": 0.95, "infer_window_fill": 0.99}]
        + [{"depth_frac": 0.5}, "exit", {"depth_frac": 1.0}, "flaky",
           {"depth_frac": 1.0}, "exit", {"depth_frac": 0.5}])
    runs = {}
    for side, sup, cfgs in (("port", tsup, tconfigs),
                            ("reference", jsup, jconfigs)):
        supervisor, spec = _elastic_supervisor(sup, cfgs)
        signals = {}

        def signal_fn():
            if signals.get("flaky"):
                raise RuntimeError("signal source down")
            return signals["now"]
        registered = []
        supervisor.enable_elastic(
            sup.ElasticPolicy(min_workers=1, max_workers=3, interval_s=1.0,
                              staleness_cap=2.0, tier_queue_hot=8.0,
                              tier_fill_hot=0.98, drain_timeout_s=30.0),
            spec, signal_fn, register=registered.append)
        trace, now = [], 100.0
        for step in script:
            now += 1.5
            signals["flaky"] = step == "flaky"
            if step == "exit":
                for slot in supervisor.slots:
                    if slot.phase == "draining":
                        slot.endpoint._failure = "exited"
                        supervisor._drain_step(slot, now)
                trace.append(("exit", [s.phase for s in supervisor.slots]))
                continue
            if isinstance(step, dict):
                signals["now"] = step
            supervisor._elastic_step(now)
            trace.append(([s.name for s in supervisor.slots],
                          [s.phase for s in supervisor.slots],
                          [s._stop_remote for s in supervisor.slots],
                          supervisor.metrics.snapshot()))
        assert [s.name for s in registered] == [
            s.name for s in supervisor.slots]
        runs[side] = trace
    assert runs["port"] == runs["reference"]
    counters = runs["port"][-1][3]["counters"]
    assert counters["scale_ups"] >= 2 and counters["scale_downs"] >= 2
    assert counters["drains_completed"] >= 1
    with pytest.raises(ValueError):
        tsup.ElasticPolicy(min_workers=3, max_workers=1)
    with pytest.raises(ValueError):
        tsup.ElasticPolicy(tier_fill_hot=1.5)
