"""The port's inference plane (``repro_torch.runtime.transport.
inference_plane``) against the reference's: the broker's dedup, acks and
redelivery step for step with the reference broker on the same frames (the
encoded result lists byte for byte); the client's round trip over the
result ring against a port server and a reference server; an unconfigured
server refusing ``infer.*``; replay across a tier restart on the same port,
every future resolved once; a publish landing while the shared pool carves
a window, held through the broker (ROADMAP C1: the port serves the new
version, the reference the old); and host-mode ``run_async`` on reduced
deepseek-7b with one spawned rollout child and no local rollout worker,
every request served by the parent's pool. Exact: every comparison is of
bytes or values."""
import dataclasses
import threading
from concurrent.futures import Future

import numpy as np
import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.runtime.transport import codec as jcodec
from repro.runtime.transport import inference_plane as jplane
from repro.runtime.transport import server as jserver
from repro_torch.runtime.transport import codec as tcodec
from repro_torch.runtime.transport import inference_plane as tplane
from repro_torch.runtime.transport import server as tserver
from repro_torch.runtime.transport.channel import (TransportError,
                                                   WireClient,
                                                   shared_memory)


class _EchoPool:
    """Resolves every request at once, its observation and step echoed."""

    def __init__(self):
        self.submits = 0

    def submit(self, obs, frame, step):
        self.submits += 1
        fut = Future()
        fut.set_result({"actions": np.asarray(obs),
                        "logp": np.full(2, -0.5, np.float32),
                        "value": float(step), "policy_version": 1})
        return fut


class _HeldPool(_EchoPool):
    """Holds every future until ``release`` (an in-flight batch)."""

    def __init__(self, release_now=False):
        super().__init__()
        self.held, self.release_now = [], release_now
        self.lock = threading.Lock()

    def submit(self, obs, frame, step):
        with self.lock:
            if self.release_now:
                return super().submit(obs, frame, step)
            fut = Future()
            self.held.append(fut)
            return fut


def _body(codec, seq):
    return codec.encode_pytree({"obs": np.arange(4, dtype=np.int32) + seq,
                                "frame": None, "step": seq})


def test_broker_steps_equal_the_reference():
    """open, submits (a replayed one among them), result polls without
    and with cumulative acks, a stale-epoch ack and the empty outbox: the
    same replies from both brokers, epochs aside, and the same bytes."""
    script = [("open", {}), ("submit", 0), ("submit", 0), ("submit", 1),
              ("open", {}), ("result", 0), ("result", 0), ("result", 1000),
              ("submit", 2), ("result", 1), ("result", 3), ("open", {})]
    runs = {}
    for side, plane, codec in (("port", tplane, tcodec),
                               ("reference", jplane, jcodec)):
        pool = _EchoPool()
        broker = plane.InferenceBroker(pool)
        out = []
        for op, arg in script:
            h = {"client": "w0"}
            if op == "open":
                resp = broker.handle_open(h)
                body = b""
            elif op == "submit":
                resp = broker.handle_submit(dict(h, seq=arg),
                                            _body(codec, arg))
                body = b""
            else:
                resp, body = broker.handle_result(dict(h, ack=arg,
                                                       timeout=0.0))
            assert resp.pop("epoch", broker.epoch) == broker.epoch
            out.append((op, resp, bytes(body)))
        out.append(("pool", pool.submits, broker.stats()))
        runs[side] = out
    assert runs["port"] == runs["reference"]
    replies = [r for op, r, _ in runs["port"][:-1] if op == "result"]
    assert [(r.get("base"), r.get("count")) for r in replies] == [
        (0, 2), (0, 2), (0, 2), (1, 2), (None, None)]
    assert runs["port"][-1][1] == 3                 # the replay ran once


@pytest.mark.parametrize("server_side", ["port", "reference"])
def test_client_round_trip_over_the_result_ring(server_side):
    plane = tplane if server_side == "port" else jplane
    srv_mod = tserver if server_side == "port" else jserver
    pool = _EchoPool()
    srv = srv_mod.TransportServer()
    srv.set_inference(plane.InferenceBroker(pool))
    srv.start()
    try:
        cli = tplane.RemoteInferenceClient(
            srv.address, client_id="w0", use_ring=shared_memory is not None)
        futs = [cli.submit(np.arange(4, dtype=np.int32) * i, None, i)
                for i in range(10)]
        for i, f in enumerate(futs):
            res = f.result(timeout=15.0)
            assert res["value"] == float(i) and res["policy_version"] == 1
            np.testing.assert_array_equal(res["actions"], np.arange(4) * i)
        cli.close()
        stats = cli.stats()
        assert stats["results"] == stats["submitted"] == 10
        assert stats["pending"] == stats["duplicates"] == 0
        assert srv.metrics.counter("infer_submits") == 10
    finally:
        srv.stop()
        srv.join(timeout=5.0)


def test_unconfigured_server_refuses_infer():
    srv = tserver.TransportServer().start()
    try:
        cli = WireClient(srv.address)
        for m in ("infer.open", "infer.submit", "infer.result"):
            with pytest.raises(TransportError, match="no inference plane"):
                cli.request({"m": m, "client": "w0", "seq": 0})
        cli.close()
    finally:
        srv.stop()
        srv.join(timeout=5.0)


def test_replay_across_a_tier_restart_resolves_each_future_once():
    pool1 = _HeldPool()
    srv1 = tserver.TransportServer()
    srv1.set_inference(tplane.InferenceBroker(pool1))
    srv1.start()
    host, port = srv1.address
    cli = tplane.RemoteInferenceClient((host, port), client_id="w0",
                                       reconnect_attempts=40,
                                       reconnect_backoff_s=0.05)
    futs = [cli.submit(np.full(3, i, np.int32), None, i) for i in range(6)]
    assert not any(f.done() for f in futs)
    srv1.stop()                             # the tier dies, results lost
    srv1.join(timeout=5.0)
    pool2 = _HeldPool(release_now=True)
    srv2 = tserver.TransportServer(host=host, port=port)
    srv2.set_inference(tplane.InferenceBroker(pool2))
    srv2.start()
    try:
        for i, f in enumerate(futs):
            assert f.result(timeout=30.0)["value"] == float(i)
        late = cli.submit(np.full(3, 9, np.int32), None, 9)
        assert late.result(timeout=15.0)["value"] == 9.0
        stats = cli.stats()
        assert stats["results"] == stats["submitted"] == 7
        assert stats["pending"] == 0 and stats["epoch_changes"] >= 1
        assert pool2.submits == 7               # each replayed once
        cli.close()
    finally:
        srv2.stop()
        srv2.join(timeout=5.0)


@pytest.mark.parametrize("side,served", [("port", 1), ("reference", 0)])
def test_publish_landing_while_a_window_is_carved_through_the_broker(
        side, served):
    """ROADMAP C1 through the plane: a whole publish lands while the
    shared pool holds a remote request in an open window (batch 4, T_max
    far away); the port's pool takes the newer version before the batch,
    the reference's serves it on the old one. Each side's client, broker,
    server and pool are its own package's."""
    if side == "port":
        from repro_torch.models.policy import init_policy_params
        from repro_torch.runtime import (InferenceService,
                                         VersionedWeightStore)
        cfgs, plane, srv_mod, kw = tconfigs, tplane, tserver, {
            "device": "cpu"}

        def init(cfg, seed):
            return init_policy_params(cfg, seed, device="cpu")
    else:
        import jax
        from repro.models.policy import init_policy_params
        from repro.runtime import InferenceService, VersionedWeightStore
        cfgs, plane, srv_mod, kw = jconfigs, jplane, jserver, {}

        def init(cfg, seed):
            return init_policy_params(cfg, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(
        cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64),
        num_prefix_tokens=1)
    rt = cfgs.RuntimeConfig(num_inference_workers=1, inference_batch=4,
                            inference_max_wait_s=60.0)
    store = VersionedWeightStore()
    store.publish(init(cfg, 0), 0)
    params1 = init(cfg, 1)
    pool = InferenceService(cfg, store, rt, **kw).start()
    srv = srv_mod.TransportServer()
    srv.set_inference(plane.InferenceBroker(pool))
    srv.start()
    rng = np.random.default_rng(0)
    cli = plane.RemoteInferenceClient(srv.address, client_id="w0")

    def submit():
        return cli.submit(rng.integers(0, cfg.vocab_size, 12).astype(
            np.int32), rng.random(192).astype(np.float32), 3)
    try:
        futures = [submit()]
        for _ in range(3000):          # the pool's worker holds it
            if pool.metrics.snapshot()["series"].get("queue_wait_s"):
                break
            threading.Event().wait(0.01)
        assert pool._q.qsize() == 0
        store.begin_publish()
        store.publish(params1, 1)
        futures += [submit() for _ in range(3)]
        results = [f.result(timeout=120) for f in futures]
        cli.close()
    finally:
        srv.stop()
        srv.join(timeout=5.0)
        pool.stop()
        pool.join(timeout=10)
    assert pool.batches_run == 1
    assert [r["policy_version"] for r in results] == [served] * 4
    for r in results:
        assert r["actions"].shape == (cfg.action_dim,)
        assert isinstance(r["value"], float)


def test_host_mode_serves_the_remote_child_from_the_parent_pool():
    from repro_torch.runtime import AcceRLSystem
    tc = tconfigs
    cfg = tc.reduced(tc.get_config("deepseek-7b"), layers=2, d_model=64)
    rt = tc.RuntimeConfig(
        num_rollout_workers=0, inference_batch=4,
        transport=tc.base.TransportConfig(
            remote_rollout_workers=1, kind="ring", heartbeat_s=0.1,
            inference_plane="host"))
    system = AcceRLSystem(cfg, tc.RLConfig(grad_accum=1), rt,
                          suite="spatial", segment_horizon=4,
                          max_episode_steps=8, batch_episodes=4,
                          device="cpu")
    m = system.run_async(train_steps=2, wall_timeout_s=25.0)
    assert m["train_steps"] >= 2
    assert all(h["healthy"] and h["state"] == "stopped"
               for h in system.health().values())
    child = system.remote_hosts[0]
    assert child.process.exitcode == 0
    g = child.metrics.snapshot()["gauges"]
    srv = system.transport_server.metrics
    served = system.inference.requests_served
    # every result the child took came from the parent's pool (there is
    # no other), sent once; a request in flight as the child closed fails
    assert (0 < g["infer_client_results"] <= srv.counter("infer_results")
            <= served <= srv.counter("infer_submits")
            <= g["infer_client_submitted"])
    assert g["infer_client_failed"] <= 4        # one an env at most
    assert g["infer_client_duplicates"] == g["infer_client_pending"] == 0
    assert (g["infer_client_results"] + g["infer_client_failed"]
            == g["infer_client_submitted"])
    assert child.env_steps > 0 and "infer_client_submitted" not in (
        system.inference.metrics.snapshot()["gauges"])
