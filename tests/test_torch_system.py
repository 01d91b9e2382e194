"""The trainer half of the port's asynchronous system and the whole system,
on the CPU: ``TrainerWorker.train_on_batch`` against the JAX package's
from the same state and batch, the published snapshot that must not alias
the live params, the ``Prefetcher`` against the reference's, and
``AcceRLSystem.run_async`` / ``run_sync`` / ``evaluate`` end to end on
reduced deepseek-7b, with the branches not ported yet raising; the
trainer's checkpoints restoring its state (one more step from the
restored state bit for bit that from the live one), and ``run_async``
with a rollout worker in a spawned child process and with one dialed in
through ``repro_torch.launch.worker``, each with the reference's metric
keys and the remote snapshot's counters.

Tolerance: the train step's metrics within rtol 1e-4 / atol 1e-5, the bar
of ``test_torch_train.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data.prefetch import Prefetcher as JPrefetcher
from repro.runtime import experience as jexp
from repro.runtime.trainer import TrainerWorker as JTrainerWorker
from repro.runtime.trainer import collate_segments as jcollate
from repro.runtime.weight_store import VersionedWeightStore as JStore
from repro_torch.bridge import params_from_numpy
from repro_torch.core.advnorm import AdvNormState
from repro_torch.core.train_step import TrainState
from repro_torch.data.prefetch import Prefetcher
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import AcceRLSystem, TrainerWorker
from repro_torch.runtime import experience as texp
from repro_torch.runtime.rollout import episode_to_segments
from repro_torch.runtime.trainer import collate_segments
from repro_torch.runtime.weight_store import VersionedWeightStore
from repro_torch.tree import tree_leaves_with_path

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
RL_KW = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
             entropy_coef=0.01)


def _cfg(cfgs, arch="deepseek-7b"):
    # the system gives a text backbone its one frame-embedding token
    return dataclasses.replace(
        cfgs.reduced(cfgs.get_config(arch), layers=2, d_model=64),
        num_prefix_tokens=1)


def _segments(n_episodes, horizon=4, seed=0):
    """Rollout segments of seeded episodes of 3 to 9 steps."""
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
            "dones": [0.0] * (t - 1) + [float(ep % 2)],
            "steps": list(range(t + 1)),
            "policy_version": 0, "task_id": ep % 10, "success": 0.0,
        }
        segs += episode_to_segments(traj, horizon)
    return segs


def _carry(jstate) -> TrainState:
    """The reference's TrainState through the bridge, leaf by leaf."""
    s = jax.tree.map(np.asarray, jstate)
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return TrainState(
        params=params_from_numpy(s.params, device="cpu"),
        opt=AdamWState(step=as_t(s.opt.step),
                       mu=params_from_numpy(s.opt.mu, device="cpu"),
                       nu=params_from_numpy(s.opt.nu, device="cpu")),
        adv_norm=AdvNormState(*(as_t(x) for x in s.adv_norm)),
        version=as_t(s.version))


def test_trainer_step_matches_reference_and_publishes_a_snapshot():
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    jrl, trl = jconfigs.RLConfig(**RL_KW), tconfigs.RLConfig(**RL_KW)
    jtrainer = JTrainerWorker(jcfg, jrl, jconfigs.RuntimeConfig(),
                              jexp.FifoChannel(8), JStore(),
                              batch_episodes=4)
    store = VersionedWeightStore()
    trainer = TrainerWorker(tcfg, trl, tconfigs.RuntimeConfig(),
                            texp.FifoChannel(8), store, batch_episodes=4,
                            device="cpu")
    trainer.state = _carry(jtrainer.state)
    jtrainer.begin_inline()
    trainer.begin_inline()
    v0, version = store.acquire(timeout=1.0)
    assert version == 0
    v0_copy = {p: x.clone() for p, x in tree_leaves_with_path(v0)}
    live0 = {p: x.clone() for p, x in tree_leaves_with_path(
        trainer.state.params)}

    batch = collate_segments(_segments(3)[:4])
    exp = jtrainer.train_on_batch(batch)
    got = trainer.train_on_batch(batch)
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], err_msg=k, **METRIC_TOL)
    assert trainer.steps_done == 1 and store.version() == 1
    assert int(trainer.state.version) == 1
    assert trainer.samples_seen == int(batch.mask.sum())

    live = dict(tree_leaves_with_path(trainer.state.params))
    ptrs = {x.untyped_storage().data_ptr() for x in live.values()}
    v1, _ = store.acquire(timeout=1.0)
    for snap in (v0, v1):
        for path, x in tree_leaves_with_path(snap):
            assert x.untyped_storage().data_ptr() not in ptrs, path
    for path, x in tree_leaves_with_path(v0):
        assert torch.equal(x, v0_copy[path]), path      # v0 left as it was
    for path, x in tree_leaves_with_path(v1):
        assert torch.equal(x, live[path]), path         # v1 = the new params
    assert not torch.equal(live[("action_head", "w")],
                           live0[("action_head", "w")])


def test_trainer_step_on_the_moe_backbone_matches_reference():
    """Reduced granite-moe-1b-a400m: the trainer's step carries the moe
    metrics (``moe_load_balance``, ``moe_dropped_frac``) as the
    reference's does, within METRIC_TOL."""
    jcfg, tcfg = (_cfg(c, "granite-moe-1b-a400m")
                  for c in (jconfigs, tconfigs))
    jrl, trl = jconfigs.RLConfig(**RL_KW), tconfigs.RLConfig(**RL_KW)
    jtrainer = JTrainerWorker(jcfg, jrl, jconfigs.RuntimeConfig(),
                              jexp.FifoChannel(8), JStore(),
                              batch_episodes=4)
    trainer = TrainerWorker(tcfg, trl, tconfigs.RuntimeConfig(),
                            texp.FifoChannel(8), VersionedWeightStore(),
                            batch_episodes=4, device="cpu")
    trainer.state = _carry(jtrainer.state)
    assert trainer.state.params["layers"]["moe"]["router"].dtype \
        == torch.float32
    jtrainer.begin_inline()
    trainer.begin_inline()
    batch = collate_segments(_segments(3)[:4])
    exp = jtrainer.train_on_batch(batch)
    got = trainer.train_on_batch(batch)
    assert {"moe_load_balance", "moe_dropped_frac"} <= set(exp)
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], err_msg=k, **METRIC_TOL)


def _prefetched(prefetcher, n):
    """``n`` batches, each leaf copied before the next get recycles its
    slab."""
    out = []
    prefetcher.start()
    try:
        for _ in range(n):
            batch = prefetcher.get(timeout=30.0)
            assert isinstance(batch.obs_tokens, np.ndarray)
            out.append([None if x is None else np.array(x) for x in batch])
    finally:
        prefetcher.stop()
    return out


def test_prefetcher_builds_the_reference_batches():
    segs = _segments(12, seed=3)
    n = len(segs) // 2

    def source(mod):
        chan = mod.FifoChannel(64)
        chan.put_many(segs)
        return chan

    ref = JPrefetcher(source(jexp), 2, jcollate, stage_batches=True)
    port = Prefetcher(source(texp), 2, collate_segments, stage_batches=True)
    exp, got = _prefetched(ref, n), _prefetched(port, n)
    for g, e in zip(got, exp):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    m, rm = port.metrics(), ref.metrics()
    assert m["batches_built"] == rm["batches_built"] == n
    assert m["bytes_copied"] == rm["bytes_copied"]
    assert m["staging_reuse"] >= 1 and m["staging_slabs"] < n


def test_prefetcher_to_device_on_the_cpu_is_a_no_op(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call on the CPU ingest path")
    for name in ("Stream", "Event", "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    segs = _segments(6, seed=4)
    chan = texp.FifoChannel(64)
    chan.put_many(segs)
    pf = Prefetcher(chan, 2, collate_segments, to_device=True, device="cpu")
    assert pf.stage_batches and pf._stream is None
    n = len(segs) // 2
    got = _prefetched(pf, n)
    for i, batch in enumerate(got):
        exp = collate_segments(segs[2 * i:2 * i + 2])
        for a, b in zip(batch, exp):
            np.testing.assert_array_equal(a, b)
    assert pf.metrics()["batches_built"] == n


def test_prefetcher_delivers_every_segment_once_under_thread_switching():
    """More producer threads than cores put numbered segments while the
    prefetcher stages batches through its slab pool, the interpreter
    switching threads every 10 µs: every segment arrives exactly once, and
    no recycled slab overwrites a batch before the next get."""
    import os
    import sys
    import threading
    n_threads, per_thread, batch = 2 * (os.cpu_count() or 4), 24, 4
    seg = _segments(1, seed=5)[0]
    chan = texp.FifoChannel(10 ** 6)
    pf = Prefetcher(chan, batch, collate_segments, stage_batches=True,
                    staging_slabs=2)

    def produce(t):
        for i in range(per_thread):
            s = dict(seg, obs_tokens=np.full_like(seg["obs_tokens"],
                                                  t * per_thread + i))
            assert chan.put(s)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=produce, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        got = _prefetched(pf, n_threads * per_thread // batch)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    ids = [int(x) for b in got for x in b[0][:, 0, 0]]
    for b in got:                       # each segment's tokens all its id
        assert (b[0] == b[0][:, :1, :1]).all()
    assert sorted(ids) == list(range(n_threads * per_thread))
    assert pf.metrics()["staging_reuse"] >= 1


def _system(cfgs, seed=0, **extra):
    cfg = cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64)
    rl = cfgs.RLConfig(grad_accum=1, lr_policy=1e-4, lr_value=1e-3)
    rt = cfgs.RuntimeConfig(num_rollout_workers=3, inference_batch=6)
    if cfgs is jconfigs:
        from repro.runtime import AcceRLSystem as JSystem
        return JSystem(cfg, rl, rt, suite="spatial", segment_horizon=4,
                       max_episode_steps=8, batch_episodes=4, seed=seed)
    return AcceRLSystem(cfg, rl, rt, suite="spatial", segment_horizon=4,
                        max_episode_steps=8, batch_episodes=4, seed=seed,
                        device="cpu", **extra)


def _check_run(system, m, steps):
    assert m["train_steps"] >= steps
    assert m["env_steps"] > 0 and m["episodes"] > 0
    assert m["inference_batches"] > 0
    assert 0 <= m["mean_policy_lag"] < 50
    for s in system.registry.all():
        assert s.healthy and s.status == "stopped", (s.name, s.health())
    log = system.trainer.metrics_log
    assert len(log) == m["train_steps"]
    assert all(np.isfinite(v) for entry in log for v in entry.values())


@pytest.fixture(scope="module")
def reference_keys():
    return set(_system(jconfigs).metrics(1.0))


def test_run_async_reaches_its_budget_with_the_reference_keys(
        reference_keys):
    system = _system(tconfigs, collect_frames=True)
    m = system.run_async(train_steps=2, wall_timeout_s=120.0)
    _check_run(system, m, 2)
    assert 0 < system.frame_channel.total_pushed <= m["env_steps"]
    assert set(m) == reference_keys
    assert not any(k.startswith("pipeline_") for k in m)
    assert system.inference.weight_swaps >= 2
    assert system.store.version() == m["train_steps"]
    ev = system.evaluate(episodes=2)
    assert 0.0 <= ev["success_rate"] <= 1.0
    assert np.isfinite(ev["mean_return"])


def test_run_sync_reaches_its_budget_with_the_reference_keys(reference_keys):
    system = _system(tconfigs, seed=1)
    m = system.run_sync(train_steps=2, wall_timeout_s=120.0)
    _check_run(system, m, 2)
    assert set(m) == reference_keys
    assert m["train_steps"] == 2 and m["mean_policy_lag"] == 0.0
    assert m["episodes"] == 16                  # two rounds of 8 episodes
    assert system.trainer.status == "stopped"   # stepped inline, never run


def test_a_failing_step_stops_every_service():
    system = _system(tconfigs)

    def boom(batch):
        raise RuntimeError("step failed")
    system.trainer.train_on_batch = boom
    with pytest.raises(RuntimeError, match="step failed"):
        system.run_sync(train_steps=1, episodes_per_round=2,
                        wall_timeout_s=60.0)
    assert all(s.status == "stopped" for s in system.registry.all())


def test_unported_branches_raise(monkeypatch):
    tc = tconfigs
    base = tc.RuntimeConfig(num_rollout_workers=1)
    tcfg = tc.base.TransportConfig
    for rt, item in (
            (dataclasses.replace(base, transport=tcfg(
                supervision=tc.base.SupervisionConfig(max_workers=2))),
             "A6b"),
            (dataclasses.replace(base, telemetry=tc.base.TelemetryConfig(
                sink=True)), "A6b"),
            (dataclasses.replace(base, transport=tcfg(
                remote_rollout_workers=1, journal_dir="journal")), "A6b"),
            (dataclasses.replace(base, transport=tcfg(
                remote_rollout_workers=1, inference_plane="host")), "A6b"),
            (dataclasses.replace(base, pipeline=True), "A7")):
        cfg = tc.reduced(tc.get_config("deepseek-7b"), layers=2, d_model=64)
        with pytest.raises(NotImplementedError, match=item):
            AcceRLSystem(cfg, tc.RLConfig(), rt, device="cpu")
    monkeypatch.setenv("REPRO_TRACE", "1")
    with pytest.raises(NotImplementedError, match="A6b"):
        AcceRLSystem(cfg, tc.RLConfig(), base, device="cpu")
    monkeypatch.delenv("REPRO_TRACE")
    with pytest.raises(RuntimeError, match="needs a world model"):
        _system(tc).run_wm(train_steps=1)


def test_trainer_checkpoints_restore_its_state(tmp_path):
    from repro_torch.data import checkpoint
    from repro_torch.data.checkpoint import _flatten_with_path
    from repro_torch.data.trajectory import dummy_batch
    tc = tconfigs
    cfg = _cfg(tc)
    trainer = TrainerWorker(cfg, tc.RLConfig(**RL_KW), tc.RuntimeConfig(),
                            texp.FifoChannel(1), VersionedWeightStore(),
                            batch_episodes=4, checkpoint_dir=str(tmp_path),
                            checkpoint_interval=1, device="cpu")
    batches = [dummy_batch(4, 3, 6, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size, num_prefix=1, seed=s)
               for s in range(3)]
    for b in batches[:2]:
        trainer.train_on_batch(b)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    template = trainer.state._replace(params=jax.tree.map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        trainer.state.params))
    restored = checkpoint.restore(str(tmp_path), template, device="cpu")
    again, m_again = trainer._step_fn(restored, batches[2])
    live, m_live = trainer._step_fn(trainer.state, batches[2])
    assert {k: float(v) for k, v in m_again.items()} == \
        {k: float(v) for k, v in m_live.items()}
    for (key, x), (_, y) in zip(_flatten_with_path(again),
                                _flatten_with_path(live)):
        assert torch.equal(x, y), key


def _remote_system(seed, **transport):
    tc = tconfigs
    cfg = tc.reduced(tc.get_config("deepseek-7b"), layers=2, d_model=64)
    rl = tc.RLConfig(grad_accum=1, lr_policy=1e-4, lr_value=1e-3)
    rt = tc.RuntimeConfig(
        num_rollout_workers=0, inference_batch=4,
        transport=tc.base.TransportConfig(token="e2e-token", **transport))
    return AcceRLSystem(cfg, rl, rt, suite="spatial", segment_horizon=4,
                        max_episode_steps=8, batch_episodes=4, seed=seed,
                        device="cpu")


def _check_remote_run(system, m, reference_keys, name):
    """As the reference's transport e2e test holds its remote run."""
    assert m["train_steps"] >= 2 and m["env_steps"] > 0
    assert set(m) == reference_keys
    remote = m["services"][name]
    for key in ("env_steps", "segments", "weight_swaps"):
        assert remote["counters"].get(key, 0) > 0, key
    host = system.remote_hosts[0]
    assert host.env_steps > 0 and host.reports_seen > 0
    assert m["env_steps"] >= host.env_steps
    assert {"inference", "rollout-0"} <= set(host.remote_services)
    health = system.health()
    assert all(h["state"] == "stopped" for h in health.values()), health
    assert system.trainer.samples_seen > 0
    assert system.experience.total_pushed >= 8       # 2 steps x 4, all wired


def test_run_async_with_a_spawned_rollout_child(reference_keys):
    system = _remote_system(seed=0, remote_rollout_workers=1)
    m = system.run_async(train_steps=2, wall_timeout_s=30.0)
    _check_remote_run(system, m, reference_keys, "remote-rollout-0")
    host = system.remote_hosts[0]
    assert host.process.exitcode == 0
    assert "weight_acquire_s_v0" in m["services"]["remote-rollout-0"][
        "gauges"]
    # the child's kernel launches are bridged: none on the CPU's plain route
    counters = m["services"]["remote-rollout-0"]["counters"]
    assert counters["launches.flash_attention"] == 0
    assert counters["launches.decode_attention"] == 0
    with pytest.raises(RuntimeError, match="single-process"):
        system.run_sync(train_steps=1)


def _dial_in(address, token):
    """A connected worker's process body (module level: spawn pickles
    it)."""
    import sys
    from repro_torch.launch.worker import run
    sys.exit(run(f"{address[0]}:{address[1]}", token=token,
                 hello_timeout_s=30.0, retry_s=0.2))


def test_run_async_with_a_connected_rollout_worker(reference_keys):
    import multiprocessing
    system = _remote_system(seed=1, connect_rollout_workers=1)
    proc = multiprocessing.get_context("spawn").Process(
        target=_dial_in, args=(system.transport_server.address,
                               "e2e-token"), daemon=True)
    proc.start()
    try:
        m = system.run_async(train_steps=2, wall_timeout_s=30.0)
    finally:
        proc.join(timeout=10.0)
        if proc.is_alive():
            proc.terminate()
    _check_remote_run(system, m, reference_keys, "connect-rollout-0")
    assert proc.exitcode == 0
    assert system.supervisor.metrics.counter("attaches") == 1
