"""The port's telemetry (``repro_torch.runtime.telemetry``) against the
reference's (``repro.runtime.telemetry``): with the clock, the trace ids and
the span ids fed from one shared sequence, the same calls record the same
events, field for field and in order, and dump the same Chrome trace; the
per-thread ring and the foreign-event buffer keep the same newest events at
their bounds; the ``TelemetrySink`` sample carries the reference's keys,
and the server serves it on ``metrics.snapshot`` (and ``trace.dump``); the
hot modules of both packages bind their trace hooks only under
``REPRO_TRACE``; and, in a process of its own with ``REPRO_TRACE`` set, a
``run_async`` on reduced deepseek-7b with one spawned rollout child and no
local rollout worker dumps one trace in which the child's ``rollout.put``
joins the parent's ``server.apply`` (and the trainer's pop and collate) on
one trace id, and a version's publish, acquire and first action share its
id. Exact: every comparison is of values."""
import itertools
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from repro.runtime import service as jservice
from repro.runtime import telemetry as jtel
from repro_torch.runtime import service as tservice
from repro_torch.runtime import telemetry as ttel

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = {"port": ttel, "reference": jtel}


@pytest.fixture(autouse=True)
def _clean():
    for mod in MODULES.values():
        mod.reset()
    yield
    for mod in MODULES.values():
        mod.reset()


def _shared_clock(monkeypatch):
    """Both modules' ``now_us``, ``new_id`` and span-id counter fed from
    sequences that restart for each module (the same values in the same
    order)."""
    for mod in MODULES.values():
        clock = itertools.count(1_000_000, 7)
        ids = itertools.count(1 << 40)
        monkeypatch.setattr(mod, "now_us", lambda c=clock: next(c))
        monkeypatch.setattr(mod, "new_id", lambda i=ids: next(i))
        monkeypatch.setattr(mod, "_sid_counter", itertools.count(500))


def _script(tel):
    """The same calls on either module: nested spans with flows and args,
    instants inside and outside a context, an explicit trace id."""
    with tel.span("rollout.put", cat="rollout", args={"worker": 3},
                  flow="start") as (trace, sid):
        tel.instant("hop", args={"k": 1}, flow="step")
        with tel.span("inner") as (t2, s2):
            assert (t2, tel.current()) == (trace, (t2, s2))
            assert tel.wire_ctx() == {"tr": trace, "sp": s2}
    with tel.context(42, 7):
        tel.instant("in.context", flow="end")
        with tel.span("child", flow="step"):
            pass
    tel.instant("weights.publish", cat="weights", trace=3,
                args={"version": 3}, flow="start")
    tel.instant("bare")
    assert tel.current() is None and tel.wire_ctx() == {}


def test_events_and_dump_equal_the_reference(monkeypatch, tmp_path):
    _shared_clock(monkeypatch)
    events, docs = {}, {}
    for side, tel in MODULES.items():
        _script(tel)
        events[side] = tel.drain(clear=False)
        path = tmp_path / f"{side}.json"
        n = tel.dump(str(path), process_name="unit")
        assert n == len(events[side])
        docs[side] = json.loads(path.read_text())
        assert tel.drain() == []                 # dump drained the rings
    assert events["port"] == events["reference"]
    assert [e["ph"] for e in events["port"]] == [
        "i", "t", "X", "X", "s", "i", "f", "X", "t", "i", "s", "i"]
    assert docs["port"] == docs["reference"]
    assert docs["port"]["traceEvents"][0] == {
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": "unit"}}


def test_ring_and_foreign_bounds_equal_the_reference(monkeypatch):
    _shared_clock(monkeypatch)
    got = {}
    for side, tel in MODULES.items():
        monkeypatch.setattr(tel, "BUF_EVENTS", 8)
        monkeypatch.setattr(tel, "FOREIGN_EVENTS", 4)
        for i in range(20):
            tel.instant(f"e{i}")
        ring = tel.drain()
        tel.extend_foreign([{"name": f"f{i}", "ph": "i"} for i in range(10)]
                           + ["not an event"])
        got[side] = (ring, tel.drain())
    assert got["port"] == got["reference"]
    ring, foreign = got["port"]
    assert [e["name"] for e in ring] == [f"e{i}" for i in range(12, 20)]
    assert [e["name"] for e in foreign] == ["f6", "f7", "f8", "f9"]


def test_a_new_thread_gets_its_own_ring():
    def record():
        ttel.instant("from.thread")
    t = threading.Thread(target=record)
    t.start()
    t.join()
    ttel.instant("from.main")
    events = ttel.drain()
    assert {e["name"]: e["tid"] for e in events} == {
        "from.thread": t.ident, "from.main": threading.get_ident()}


def test_sink_sample_has_the_reference_keys(tmp_path):
    samples = {}
    for side, svc, tel in (("port", tservice, ttel),
                           ("reference", jservice, jtel)):
        registry = svc.ServiceRegistry()
        worker = registry.register(svc.Service("worker"))
        worker.metrics.inc("steps", 3)
        worker.metrics.set_gauge("depth", 0.5)
        worker.metrics.observe("lat_s", 0.01)
        path = tmp_path / f"{side}.jsonl"
        sink = tel.TelemetrySink(registry, interval_s=0.05, history=2,
                                 path=str(path))
        sink.on_start()
        for _ in range(3):
            sink.sample()
        assert len(sink.tail()) == 2 and sink.latest() is sink.tail()[-1]
        sink.on_stop()
        assert len(path.read_text().splitlines()) == 4   # stop samples too
        samples[side] = sink.latest()
    port, ref = samples["port"], samples["reference"]
    assert set(port) == set(ref) == {"t", "services", "health"}
    assert port["services"] == ref["services"]
    assert set(port["health"]["worker"]) == set(ref["health"]["worker"])


_GATING = r"""
import importlib, sys
sys.path.insert(0, "src")
hot = ("runtime.rollout", "runtime.trainer", "runtime.experience",
       "runtime.inference", "runtime.transport.channel",
       "runtime.transport.server", "runtime.transport.remote",
       "runtime.transport.weights", "runtime.transport.inference_plane",
       "runtime.pipeline_exec", "wm.imagination")
bound = {}
for pkg in ("repro_torch", "repro"):
    for m in hot:
        mod = importlib.import_module(f"{pkg}.{m}")
        bound[pkg, m] = mod._tel is not None
    bound[pkg] = f"{pkg}.runtime.telemetry" in sys.modules
print(bound)
want = sys.argv[1] == "on"
assert all(v == want for v in bound.values()), bound
"""


@pytest.mark.parametrize("gate", ["off", "on"])
def test_hot_modules_bind_tracing_only_when_gated(gate):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
           "JAX_PLATFORMS": "cpu"}
    if gate == "on":
        env["REPRO_TRACE"] = "1"
    res = subprocess.run([sys.executable, "-c", _GATING, gate], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_TRACED_RUN = r"""
import dataclasses, json, os, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig, RuntimeConfig, TransportConfig
from repro_torch.runtime import AcceRLSystem, telemetry

cfg = reduced(get_config("deepseek-7b"), layers=2, d_model=64)
rt = RuntimeConfig(num_rollout_workers=0, inference_batch=4,
                   transport=TransportConfig(remote_rollout_workers=1,
                                             kind="ring", heartbeat_s=0.1))
system = AcceRLSystem(cfg, RLConfig(grad_accum=1), rt, suite="spatial",
                      segment_horizon=4, max_episode_steps=8,
                      batch_episodes=4, device="cpu")
m = system.run_async(train_steps=2, wall_timeout_s=25.0)
assert m["train_steps"] >= 2, m
n = telemetry.dump(sys.argv[1], process_name="train-parent")
print(json.dumps({"pid": os.getpid(), "events": n,
                  "child": system.remote_hosts[0].process.pid,
                  "folded": system.transport_server.metrics.counter(
                      "trace_events_folded"),
                  "sink": system.telemetry_sink is not None}))
"""


def _by_trace(events, name):
    """trace id -> the pids of ``name``'s events on it."""
    out = {}
    for e in events:
        if e.get("name") == name and e.get("ph") in ("X", "i"):
            t = e.get("args", {}).get("trace")
            if t is not None:
                out.setdefault(t, set()).add(e["pid"])
    return out


def test_a_child_put_joins_the_parent_apply_in_one_trace(tmp_path):
    """No local rollout worker, so every segment the trainer sees crossed
    the wire: the join cannot rest on a race with local producers."""
    path = tmp_path / "trace.json"
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "REPRO_TRACE": "1",
           "TMPDIR": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", _TRACED_RUN, str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=50)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    run = json.loads(res.stdout.strip().splitlines()[-1])
    assert run["sink"] and run["folded"] > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert events[0]["args"] == {"name": "train-parent"}
    for e in events[1:]:
        assert {"name", "ph", "ts", "pid"} <= set(e)
        assert isinstance(e["ts"], int)
    parent, child = run["pid"], run["child"]
    puts = _by_trace(events, "rollout.put")
    applies = _by_trace(events, "server.apply")
    assert puts and all(p == {child} for p in puts.values())
    joined = [t for t in puts if applies.get(t) == {parent}]
    assert joined, "no child rollout.put joined a parent server.apply"
    trainer_side = set(_by_trace(events, "trainer.collate")) | set(
        _by_trace(events, "replay.pop"))
    assert set(joined) & trainer_side
    # the policy-lag flow: the parent publishes, the child's pool
    # acquires over the wire and serves its first action on that version
    # (the parent's own pool, idle without local workers, acquires too)
    pub = _by_trace(events, "weights.publish")
    wire = _by_trace(events, "weights.wire_acquire")
    acq = _by_trace(events, "weights.acquire")
    first = _by_trace(events, "infer.first_action")
    chain = set(pub) & set(wire) & set(acq) & set(first)
    assert chain
    v = min(chain)
    assert pub[v] == {parent} and first[v] == wire[v] == {child}
    assert child in acq[v]


def test_server_serves_the_sink_sample_and_its_trace():
    """``metrics.snapshot`` serves the sink's sample once the orchestrator
    points ``snapshot_provider`` at it (the server's own registry before);
    ``trace.dump`` answers, here untraced, that recording is off — as the
    reference's server does."""
    from repro_torch.runtime.transport import TransportServer, WireClient
    srv = TransportServer().start()
    try:
        client = WireClient(srv.address)
        own, _ = client.request({"m": "metrics.snapshot"})
        assert set(own["sample"]["services"]) == {srv.name}
        registry = tservice.ServiceRegistry()
        registry.register(tservice.Service("worker")).metrics.inc("steps")
        srv.snapshot_provider = ttel.TelemetrySink(registry).sample
        got, _ = client.request({"m": "metrics.snapshot"})
        assert set(got["sample"]) == {"t", "services", "health"}
        assert got["sample"]["services"]["worker"]["counters"] == {
            "steps": 1.0}
        dump, _ = client.request({"m": "trace.dump"})
        assert dump == {"ok": True, "enabled": False, "events": []}
        client.close()
    finally:
        srv.stop()
        srv.join()
