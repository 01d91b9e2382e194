"""The rollout half of the port's asynchronous system against the JAX
package's, on the CPU: the numpy copies (the manipulation env, the task
resampler, the replay buffers) and the host modules (the experience
channels, episode segmentation, collation and the rollout worker), fed the
same seeds and the same inputs, must give equal results field for field.
"""
import concurrent.futures

import numpy as np
import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core.resampler import DynamicWeightedResampler as JResampler
from repro.data import replay as jreplay
from repro.envs import toy_manipulation as jenv
from repro.runtime import experience as jexp
from repro.runtime import rollout as jrollout
from repro.runtime.trainer import collate_segments as jcollate
from repro_torch.core.resampler import DynamicWeightedResampler as TResampler
from repro_torch.data import replay as treplay
from repro_torch.envs import toy_manipulation as tenv
from repro_torch.runtime import experience as texp
from repro_torch.runtime import rollout as trollout
from repro_torch.runtime.trainer import collate_segments as tcollate


def _equal(got, exp, where=""):
    """Field-for-field equality of nested dicts / lists / arrays / scalars,
    dtypes included."""
    if isinstance(exp, dict):
        assert isinstance(got, dict) and got.keys() == exp.keys(), where
        for k in exp:
            _equal(got[k], exp[k], f"{where}.{k}")
    elif isinstance(exp, (list, tuple)):
        assert len(got) == len(exp), where
        for i, (g, e) in enumerate(zip(got, exp)):
            _equal(g, e, f"{where}[{i}]")
    elif isinstance(exp, (np.ndarray, np.generic)):
        assert type(got) is type(exp), (where, type(got), type(exp))
        assert got.dtype == exp.dtype and got.shape == exp.shape, where
        np.testing.assert_array_equal(got, exp, err_msg=where)
    else:
        assert type(got) is type(exp) and got == exp, (where, got, exp)


def test_env_constants_equal_reference():
    for name in ("SUITES", "T_OBS", "GRID", "FRAME_DIM", "TASKS_PER_SUITE"):
        assert getattr(tenv, name) == getattr(jenv, name), name


@pytest.mark.parametrize("suite", jenv.SUITES)
@pytest.mark.parametrize("dense", [False, True])
def test_env_matches_reference_over_seeded_actions(suite, dense):
    """Random actions, then the scripted expert (its noise from the env's
    own rng), across resets of every task: every observation, reward,
    ``done`` and ``info`` equal."""
    kw = dict(suite=suite, max_steps=12, dense_reward=dense, seed=3)
    envs = (jenv.ManipulationEnv(**kw), tenv.ManipulationEnv(**kw))
    rng = np.random.default_rng(7)
    for task in range(jenv.TASKS_PER_SUITE):
        _equal(envs[1].reset(task), envs[0].reset(task), f"reset {task}")
        for t in range(12):
            if task % 2:
                act = rng.integers(0, 64, 7).astype(np.int32)
            else:
                act = envs[0].oracle_action()
                _equal(envs[1].oracle_action(), act, f"oracle {task}/{t}")
            out = [e.step(act) for e in envs]
            _equal(out[1], out[0], f"step {task}/{t}")
            if out[0][2]:
                break


def test_lognormal_latency_matches_reference():
    a = jenv.lognormal_latency(3.0, 0.5, seed=4)
    b = tenv.lognormal_latency(3.0, 0.5, seed=4)
    assert [b() for _ in range(20)] == [a() for _ in range(20)]


def test_resampler_draws_match_reference():
    rs = (JResampler(10, window_size=5, seed=2),
          TResampler(10, window_size=5, seed=2))
    rng = np.random.default_rng(0)
    for _ in range(40):
        task, flag = int(rng.integers(0, 10)), float(rng.random() < 0.4)
        for r in rs:
            r.update_history(task, flag)
        _equal(rs[1].probabilities(), rs[0].probabilities())
        assert rs[1].sample_task() == rs[0].sample_task()
    _equal(rs[1].history, rs[0].history)
    _equal(rs[1].ptr, rs[0].ptr)


def _script_buffer(buf):
    """One push/pop script over a FIFOReplayBuffer; returns what it saw."""
    seen = []
    for i in range(5):
        seen.append(buf.push({"i": np.int32(i)}, timeout=0.01))
    seen.append(len(buf))
    seen.append(buf.pop_batch(2, timeout=0.01))
    for i in range(5, 8):
        seen.append(buf.push({"i": np.int32(i)}, timeout=0.01))
    seen.append(buf.peek_all())
    seen.append(buf.pop_upto(2, timeout=0.01))
    seen.append(buf.pop_batch(9, timeout=0.01))      # times out: None
    seen.append(buf.drain())
    seen.append(buf.pop_upto(3, timeout=0.01))        # empty: None
    seen.append((buf.total_pushed, buf.total_dropped, buf.peek_depth()))
    return seen


@pytest.mark.parametrize("policy", jreplay.BACKPRESSURE_POLICIES)
def test_fifo_buffer_matches_reference(policy):
    assert treplay.BACKPRESSURE_POLICIES == jreplay.BACKPRESSURE_POLICIES
    _equal(_script_buffer(treplay.FIFOReplayBuffer(4, policy=policy)),
           _script_buffer(jreplay.FIFOReplayBuffer(4, policy=policy)))
    with pytest.raises(ValueError):
        treplay.FIFOReplayBuffer(4, policy="bogus")


def test_ring_buffer_matches_reference():
    bufs = (jreplay.RingReplayBuffer(5, seed=1),
            treplay.RingReplayBuffer(5, seed=1))
    for b in bufs:
        assert b.sample(3) is None
    for i in range(12):
        for b in bufs:
            b.push(i)
        _equal(bufs[1].sample(4), bufs[0].sample(4))
        assert len(bufs[1]) == len(bufs[0])
    assert bufs[1].total_pushed == bufs[0].total_pushed == 12


def _script_channels(mod):
    """One put/pop script over the FIFO and ring channels and a mixed
    source composing two FIFO channels."""
    seen = []
    fifo = mod.FifoChannel(3, policy="drop_oldest")
    seen.append(fifo.put_many([{"x": np.float32(i)} for i in range(5)]))
    seen.append((fifo.policy, fifo.capacity, fifo.stats()))
    seen.append(fifo.pop_many(2, timeout=0.01))
    seen.append(fifo.peek_all())
    seen.append(fifo.pop_batch(1, timeout=0.01))
    seen.append(fifo.drain())
    ring = mod.RingChannel(4, seed=5)
    seen.append([ring.put(i) for i in range(6)])
    seen.append((ring.sample(5), len(ring), ring.stats()))
    real, img = mod.FifoChannel(10), mod.FifoChannel(10)
    mixed = mod.MixedExperienceSource(real, img, real_fraction=0.25)
    real.put_many([("r", i) for i in range(6)])
    img.put_many([("i", i) for i in range(3)])
    seen.append(mixed.pop_batch(4, timeout=0.05))
    seen.append(mixed.pop_many(3, timeout=0.05))
    seen.append(mixed.pop_batch(5, timeout=0.02))     # starved: None
    seen.append(mixed.stats())
    real.put(("r", 99))
    seen.append(mixed.pop_batch(2, timeout=0.05))     # carries the partial
    pinned = mod.MixedExperienceSource(real, img, real_fraction=0.0)
    img.put(("i", 7))
    seen.append(pinned.pop_many(4, timeout=0.02))
    seen.append(len(pinned))
    return seen


def test_channels_and_mixed_source_match_reference():
    assert texp.__all__ == jexp.__all__
    _equal(_script_channels(texp), _script_channels(jexp))
    with pytest.raises(ValueError):
        texp.MixedExperienceSource(texp.FifoChannel(1), texp.FifoChannel(1),
                                   real_fraction=1.5)


def _episode(t, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs_tokens": [rng.integers(0, 99, 12).astype(np.int32)
                       for _ in range(t + 1)],
        "frames": [rng.random(192).astype(np.float32) for _ in range(t + 1)],
        "actions": [rng.integers(0, 64, 7).astype(np.int32)
                    for _ in range(t + 1)],
        "behavior_logp": [np.log(rng.uniform(0.1, 1, 7)).astype(np.float32)
                          for _ in range(t + 1)],
        "values": [float(v) for v in rng.standard_normal(t + 1)],
        "rewards": [float(r) for r in rng.random(t)],
        "dones": [0.0] * (t - 1) + [1.0],
        "steps": list(range(t + 1)),
        "policy_version": 3, "task_id": 4, "success": 1.0,
    }


@pytest.mark.parametrize("t,horizon", [(10, 4), (8, 8), (3, 8)])
def test_segments_and_collate_match_reference(t, horizon):
    traj = _episode(t, seed=t)
    segs = trollout.episode_to_segments(traj, horizon)
    _equal(segs, jrollout.episode_to_segments(traj, horizon))
    got, exp = tcollate(segs), jcollate(segs)
    assert type(got).__name__ == type(exp).__name__ == "TrajectoryBatch"
    assert got._fields == exp._fields
    _equal(list(got), list(exp))


class _StubService:
    """Answers every request at once with actions, log-probs, a value and
    a version drawn from a numpy seed; ``oracle`` answers with the
    worker's env's scripted expert instead (episodes then succeed)."""

    def __init__(self, seed, oracle_env=None):
        self.rng = np.random.default_rng(seed)
        self.oracle_env = oracle_env
        self.requests = []

    def submit(self, tokens, frame, step):
        self.requests.append((tokens.copy(), frame.copy(), step))
        acts = (self.oracle_env.oracle_action() if self.oracle_env
                else self.rng.integers(0, 64, 7).astype(np.int32))
        fut = concurrent.futures.Future()
        fut.set_result({
            "actions": acts,
            "logp": np.log(self.rng.uniform(0.05, 1, 7)).astype(np.float32),
            "value": float(self.rng.standard_normal()),
            "policy_version": int(self.rng.integers(0, 5))})
        return fut


@pytest.mark.parametrize("suite,oracle", [("spatial", False),
                                          ("long", True), ("goal", True)])
def test_rollout_worker_episode_matches_reference(suite, oracle):
    """One ``RolloutWorker._episode`` in each package against the same
    scripted service: equal segments, frame-channel items, resampler
    history and counters."""
    out = []
    for cfgs, exp_mod, roll_mod, res_cls in (
            (jconfigs, jexp, jrollout, JResampler),
            (tconfigs, texp, trollout, TResampler)):
        cfg = cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2,
                           d_model=64)
        chan, frames = exp_mod.FifoChannel(64), exp_mod.RingChannel(256)
        resampler = res_cls(10, seed=1)
        worker = roll_mod.RolloutWorker(
            2, cfg, None, chan, suite=suite, resampler=resampler,
            segment_horizon=5, max_steps=14, seed=11, frame_channel=frames)
        worker.inference = _StubService(
            9, oracle_env=worker.env if oracle else None)
        worker._episode(3)
        worker._episode(7)
        out.append(dict(
            segments=chan.drain(), frames=list(frames._buf._items),
            requests=worker.inference.requests,
            history=resampler.history,
            counters=(worker.env_steps, worker.episodes_done,
                      worker.successes, worker.returns,
                      worker.metrics.counter("segments"),
                      worker.metrics.gauge("policy_version"))))
    _equal(out[1], out[0])
    assert out[0]["segments"] and out[0]["frames"]
    if oracle:
        assert out[0]["counters"][2] >= 1          # an episode succeeded
