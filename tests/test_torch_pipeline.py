"""The port's pipelined executor (``runtime/pipeline_exec.py``) against
the JAX package's and against its own fused step, on the CPU:

  * schedules instruction for instruction the reference's, the validator's
    stats and its four refusals, the host micro-batch slicing;
  * a pipelined round bit for bit the fused step (k = 1, 2, 4; two rounds
    in a row), the WM stage on its own thread, one micro-batch's grads
    live at a time, the bubble histogram; a disjoint two-entry layout;
  * the round against the reference's ``PipelineExecutor.run_round`` on
    the same numpy weights and batch, within ``test_torch_train.py``'s
    tolerances;
  * the wiring: ``TrainerWorker`` with ``rt.pipeline`` equal to the
    default worker, the ``set_wm_stage`` guard, and ``AcceRLWMSystem``
    whose WM trainer only the executor drives.
"""
import importlib
import json
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RLConfig as JRLConfig
from repro.data.trajectory import dummy_batch as jdummy_batch
from repro.runtime import pipeline_exec as jpe
from repro.runtime.step_program import (
    build_train_step_program as jbuild_program)
from repro_torch.bridge import batch_from_numpy, params_from_numpy
from repro_torch.configs import WMConfig, get_config, reduced
from repro_torch.configs.base import RLConfig, RuntimeConfig
from repro_torch.core import advnorm
from repro_torch.core.train_step import (TrainState, _microbatches,
                                         init_train_state)
from repro_torch.data.checkpoint import _flatten_with_path
from repro_torch.data.trajectory import dummy_batch
from repro_torch.optim import adamw
from repro_torch.runtime import FifoChannel, TrainerWorker
from repro_torch.runtime import pipeline_exec as tpe
from repro_torch.runtime.service import MetricsRegistry
from repro_torch.runtime.step_program import build_train_step_program
from repro_torch.runtime.weight_store import VersionedWeightStore
from repro_torch.tree import tree_leaves, tree_leaves_with_path

jts = importlib.import_module("repro.core.train_step")
ROOT = pathlib.Path(__file__).resolve().parents[1]

CFG = reduced(get_config("deepseek-7b"), layers=2, d_model=64)
CPU = tpe.local_devices("cpu")
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _deterministic():
    """The CPU's ``index_put_`` with accumulate (the embedding table's
    backward) adds in parallel in no fixed order, so two runs of one step
    may differ in the last bit; bit-for-bit comparisons take its
    deterministic form."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(autouse=True)
def _no_group_left():
    """A pipelined trainer starts a single-rank group in process: take it
    down after the test that started it."""
    before = dist.is_initialized()
    yield
    if dist.is_initialized() and not before:
        dist.destroy_process_group()


def _batch(b=4, seed=0):
    return dummy_batch(b, 4, 12, CFG.action_dim, CFG.vocab_size,
                       CFG.action_vocab_size, seed=seed)


def _bits_equal(a, b) -> bool:
    fa, fb = list(_flatten_with_path(a)), list(_flatten_with_path(b))
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def _feeds(k, wm=0):
    return (["host:policy:state"]
            + [f"host:policy:micro{m}" for m in range(k)]
            + [f"host:wm:micro{m}" for m in range(wm)])


COLLECTS = ["pipe:policy:state", "pipe:policy:metrics", "pipe:wm:out"]


def _fields(ins):
    return (int(ins.op), ins.stage, ins.inputs, ins.outputs, ins.buffer,
            ins.micro, ins.tag, repr(ins))


# ---------------------------------------------------------------------------
# static schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,wm", [(1, 0), (2, 1), (4, 3), (8, 2)])
def test_schedules_equal_reference(k, wm):
    want = jpe.build_train_schedules(k, wm)
    got = tpe.build_train_schedules(k, wm)
    assert set(got) == set(want) == {"policy", "wm"}
    for name in want:
        assert [_fields(i) for i in got[name]] == \
            [_fields(i) for i in want[name]], name
    stats = tpe.validate_schedules(got, feeds=_feeds(k, wm),
                                   collects=COLLECTS)
    assert stats == jpe.validate_schedules(want, feeds=_feeds(k, wm),
                                           collects=COLLECTS)
    assert stats["policy"]["peak_micro_grads"] == 1


def _broken(mod):
    I, Op = mod.Instruction, mod.PipelineOp
    return [
        ({"s": (I(Op.RECV, buffer="x", tag="host:x"), I(Op.FREE, buffer="x"),
                I(Op.RUN, stage="f", inputs=("x",), outputs=("y",)),
                I(Op.FREE, buffer="y"))}, ["host:x"], "dead"),
        ({"s": (I(Op.RECV, buffer="x", tag="host:x"),)}, ["host:x"], "leak"),
        ({"s": (I(Op.RECV, buffer="x", tag="nobody:sends"),
                I(Op.FREE, buffer="x"))}, ["host:x"], "never fed"),
        ({"s": (I(Op.RECV, buffer="x", tag="host:x"),
                I(Op.SEND, buffer="x", tag="pipe:orphan"),
                I(Op.FREE, buffer="x"))}, ["host:x"], "never consumed"),
    ]


@pytest.mark.parametrize("case", range(4))
def test_validator_refuses_what_the_reference_refuses(case):
    (jsch, feeds, match), (tsch, _, _) = _broken(jpe)[case], \
        _broken(tpe)[case]
    with pytest.raises(ValueError, match=match) as j_err:
        jpe.validate_schedules(jsch, feeds=feeds, collects=[])
    with pytest.raises(ValueError, match=match) as t_err:
        tpe.validate_schedules(tsch, feeds=feeds, collects=[])
    assert str(t_err.value) == str(j_err.value)


def test_host_microbatches_equal_fused_slicing():
    batch = _batch(b=9, seed=5)                 # a tail of 1 is dropped
    for src in (batch, batch_from_numpy(batch, device="cpu")):
        slice_i, _ = _microbatches(src, 4)
        micros = tpe.host_microbatches(src, 4)
        assert len(micros) == 4
        for i, m in enumerate(micros):
            for x, y in zip(m, slice_i(i)):
                assert (x is None and y is None) or np.array_equal(
                    np.asarray(x), np.asarray(y))
    jmicros = jpe.host_microbatches(
        jdummy_batch(9, 4, 12, CFG.action_dim, CFG.vocab_size,
                     CFG.action_vocab_size, seed=5), 4)
    for m, jm in zip(tpe.host_microbatches(batch, 4), jmicros):
        assert np.array_equal(m.obs_tokens, np.asarray(jm.obs_tokens))
    with pytest.raises(ValueError, match="too small"):
        tpe.host_microbatches(_batch(b=2), 4)


# ---------------------------------------------------------------------------
# the round against the fused step
# ---------------------------------------------------------------------------

def _rl(k):
    return RLConfig(grad_accum=k, lr_policy=1e-4, lr_value=1e-3)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_round_equals_fused_step_bit_for_bit(k):
    """Pipelined rounds == fused steps at a fixed seed, two rounds in a
    row, with the WM stage running on the second stream (k >= 2)."""
    prog = build_train_step_program(CFG, _rl(k), device="cpu")
    fused = prog.fused()
    s_ref = init_train_state(CFG, 0, device="cpu")
    s_pipe = init_train_state(CFG, 0, device="cpu")
    wm_calls = []

    def wm_stage(b):
        wm_calls.append((threading.current_thread().name,
                         torch.ones(1).device))
        return {"seen": len(b)}

    feed = iter([[{"x": 1}, {"x": 2}], [{"x": 3}], [{"x": 4}] * 3])
    ex = tpe.PipelineExecutor(prog, tpe.SubmeshLayout.split(CPU))
    if k > 1:
        ex.set_wm_stage(wm_stage, lambda: next(feed, None), wm_micro=2)
    try:
        for r in range(2):
            batch = _batch(b=2 * k, seed=100 + r)
            s_ref, m_ref = fused(s_ref, batch)
            s_pipe, m_pipe, wm_out = ex.run_round(s_pipe, batch)
            assert _bits_equal(s_ref, s_pipe), r
            assert {n: float(v) for n, v in m_ref.items()} == \
                {n: float(v) for n, v in m_pipe.items()}
    finally:
        ex.close()
    assert int(s_pipe.version) == 2 and ex.rounds == 2
    if k > 1:
        # round 1 ran two WM micro-batches, round 2 the one the feed had
        assert wm_out == {"seen": 3}
        assert wm_calls == [("pipeline-wm", torch.device("cpu"))] * 3


def test_live_grads_stay_at_one_micro_batch():
    """Peak live gradient bytes == ONE micro-batch's grad tree, however
    deep the accumulation window (the 1F1B claim)."""
    state = init_train_state(CFG, 0, device="cpu")
    tree_bytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(state.params))
    peaks = {}
    for k in (2, 4):
        ex = tpe.PipelineExecutor(
            build_train_step_program(CFG, _rl(k), device="cpu"),
            tpe.SubmeshLayout.split(CPU))
        try:
            ex.run_round(init_train_state(CFG, 0, device="cpu"),
                         _batch(b=8, seed=1))
        finally:
            ex.close()
        peaks[k] = ex.peak_grad_bytes
        assert ex.peak_live_bytes["policy"] > tree_bytes
    assert peaks[2] == peaks[4] == tree_bytes


def test_bubble_histogram_recorded():
    metrics = MetricsRegistry("t")
    ex = tpe.PipelineExecutor(
        build_train_step_program(CFG, _rl(2), device="cpu"),
        tpe.SubmeshLayout.split(CPU), metrics=metrics)
    state = init_train_state(CFG, 0, device="cpu")
    try:
        state, _, _ = ex.run_round(state, _batch())
        ex.run_round(state, _batch())
    finally:
        ex.close()
    assert set(ex.last_bubble) == {"policy"}    # no WM stage attached
    assert 0.0 <= ex.last_bubble["policy"] <= 1.0
    h = metrics.hist("pipeline_bubble_frac")
    assert h is not None and h["count"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        ex.run_round(state, _batch())


def test_disjoint_layout_places_the_round_on_the_policy_submesh():
    """A two-entry device list splits into disjoint submeshes; RECVs move
    the state and micro-batches onto the policy submesh (``.to``, numpy
    through the bridge), the WM stage runs with its submesh's device
    entered, and the round still equals the fused step."""
    layout = tpe.SubmeshLayout.split(("cpu", "cpu"))
    assert layout.disjoint and len(layout.policy.devices) == 1
    prog = build_train_step_program(CFG, _rl(2), device="cpu")
    s_ref, m_ref = prog.fused()(init_train_state(CFG, 0, device="cpu"),
                                _batch(seed=3))
    seen = []
    ex = tpe.PipelineExecutor(prog, layout)
    ex.set_wm_stage(lambda b: seen.append(torch.zeros(1).device) or b,
                    lambda: [{"x": 1}])
    try:
        s_pipe, m_pipe, wm_out = ex.run_round(
            init_train_state(CFG, 0, device="cpu"), _batch(seed=3))
    finally:
        ex.close()
    assert _bits_equal(s_ref, s_pipe)
    assert float(m_ref["loss"]) == float(m_pipe["loss"])
    assert seen == [layout.wm.device] and wm_out == [{"x": 1}]
    assert all(x.device == layout.policy.device
               for x in tree_leaves(s_pipe.params))


_TRACED_ROUNDS = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core.train_step import init_train_state
from repro_torch.data.trajectory import dummy_batch
from repro_torch.runtime import pipeline_exec as pe, telemetry
from repro_torch.runtime.step_program import build_train_step_program

cfg = reduced(get_config("deepseek-7b"), layers=2, d_model=64)
ex = pe.PipelineExecutor(
    build_train_step_program(cfg, RLConfig(grad_accum=2), device="cpu"),
    pe.SubmeshLayout.split(pe.local_devices("cpu")))
ex.set_wm_stage(lambda b: b, lambda: [1])
state = init_train_state(cfg, 0, device="cpu")
for seed in range(2):
    state, _, _ = ex.run_round(state, dummy_batch(
        4, 3, 6, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
        seed=seed))
ex.close()
print(json.dumps([(e["name"], e["ph"], e.get("args", {}))
                  for e in telemetry.drain()
                  if e["name"] in ("train.stage", "pipeline.round")]))
"""


def test_traced_rounds_record_stage_spans_and_round_instants():
    """Under ``REPRO_TRACE`` (a process of its own) every RUN records a
    ``train.stage`` span naming its stage, submesh and micro-batch, and
    every round a ``pipeline.round`` instant with its wall and bubbles."""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "REPRO_TRACE": "1",
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", _TRACED_ROUNDS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    events = json.loads(res.stdout.strip().splitlines()[-1])
    stages = [(a["stage"], a["submesh"], a["micro"])
              for name, ph, a in events if name == "train.stage"]
    per_round = [("grad_reduce/init", "policy", -1),
                 ("fwd_bwd", "policy", 0), ("grad_reduce", "policy", 0),
                 ("fwd_bwd", "policy", 1), ("grad_reduce", "policy", 1),
                 ("optim_update", "policy", -1), ("wm_update", "wm", 0)]
    assert sorted(stages) == sorted(per_round * 2)
    assert all(ph == "X" for name, ph, _ in events if name == "train.stage")
    rounds = [a for name, ph, a in events if name == "pipeline.round"]
    assert [a["round"] for a in rounds] == [1, 2]
    assert all({"wall_s", "bubble_policy", "bubble_wm"} <= set(a)
               for a in rounds)


# ---------------------------------------------------------------------------
# the round against the reference's executor
# ---------------------------------------------------------------------------

def test_round_matches_the_reference_executor():
    """One pipelined round (grad_accum 2) of the reference and of the port
    from the same numpy weights on the same batch: metrics within rtol
    1e-4 / atol 1e-5, AdamW moments and the Welford state within rtol
    1e-5 / atol 1e-6, params within test_torch_train.py's lr bars."""
    kw = dict(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2,
              entropy_coef=0.01)
    jcfg = jreduced(jget_config("deepseek-7b"), layers=2, d_model=64)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                device="cpu")
    tstate = TrainState(tparams, adamw.init(tparams),
                        advnorm.init_adv_state(device="cpu"),
                        torch.zeros((), dtype=torch.int32))
    args = (4, 3, 6, CFG.action_dim, CFG.vocab_size, CFG.action_vocab_size)
    jex = jpe.PipelineExecutor(jbuild_program(jcfg, JRLConfig(**kw)),
                               jpe.SubmeshLayout.split(jax.devices()))
    tex = tpe.PipelineExecutor(
        build_train_step_program(CFG, RLConfig(**kw), device="cpu"),
        tpe.SubmeshLayout.split(CPU))
    try:
        js, jm, _ = jex.run_round(jstate, jdummy_batch(*args, seed=2))
        ts, tm, _ = tex.run_round(tstate, dummy_batch(*args, seed=2))
    finally:
        jex.close()
        tex.close()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    for tree_t, tree_j in ((ts.opt.mu, js.opt.mu), (ts.opt.nu, js.opt.nu)):
        j = {tuple(p.key for p in path): np.asarray(x) for path, x in
             jax.tree_util.tree_leaves_with_path(tree_j)}
        for path, x in tree_leaves_with_path(tree_t):
            np.testing.assert_allclose(x.numpy(), j[path], err_msg=str(path),
                                       **STATE_TOL)
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(float(getattr(ts.adv_norm, f)),
                                   float(getattr(js.adv_norm, f)),
                                   err_msg=f, **STATE_TOL)
    assert int(ts.opt.step) == int(js.opt.step) == 1
    assert int(ts.version) == int(js.version) == 1
    j = {tuple(p.key for p in path): np.asarray(x) for path, x in
         jax.tree_util.tree_leaves_with_path(js.params)}
    for path, x in tree_leaves_with_path(ts.params):
        lr = kw["lr_value"] / 2 if path[0] == "value_head" \
            else kw["lr_policy"] / 2
        diff = np.abs(x.numpy() - j[path])
        assert diff.max() <= 0.1 * lr, (path, diff.max() / lr)


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

def _worker(rt):
    return TrainerWorker(CFG, _rl(2), rt, FifoChannel(1),
                         VersionedWeightStore(), batch_episodes=4,
                         device="cpu")


def test_trainer_worker_pipeline_equals_the_default_worker():
    ref = _worker(RuntimeConfig())
    pipe = _worker(RuntimeConfig(pipeline=True))
    assert ref.pipeline is None and pipe.pipeline is not None
    assert [s.name for s in pipe.program.stages] == \
        [s.name for s in ref.program.stages]
    assert pipe._mesh.mesh_dim_names == ("data", "model")
    published = {w: [] for w in ("ref", "pipe")}
    ref.store.on_publish = lambda p, v: published["ref"].append(v)
    pipe.store.on_publish = lambda p, v: published["pipe"].append(v)
    try:
        ref.begin_inline()
        pipe.begin_inline()
        for r in range(2):
            batch = _batch(b=4, seed=50 + r)
            assert ref.train_on_batch(batch) == pipe.train_on_batch(batch)
        assert _bits_equal(ref.state, pipe.state)
        assert pipe.steps_done == 2 and pipe.pipeline.rounds == 2
        assert published["ref"] == published["pipe"] == [0, 1, 2]
        h = pipe.metrics.hist("pipeline_bubble_frac")
        assert h is not None and h["count"] >= 2
    finally:
        ref.stop()
        pipe.stop()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.pipeline.run_round(pipe.state, _batch())


def test_trainer_worker_set_wm_stage_guard():
    ref = _worker(RuntimeConfig())
    try:
        with pytest.raises(RuntimeError, match="rt.pipeline"):
            ref.set_wm_stage(lambda b: None, lambda: None)
    finally:
        ref.stop()


def test_wm_system_with_pipeline_drives_its_wm_trainer(monkeypatch):
    """``AcceRLWMSystem`` with ``rt.pipeline``: the WM trainer is driven,
    every M_obs update comes from the executor's WM stream (at most one
    cycle a round, obs updates growing with them), never from the
    trainer's own loop, and ``metrics()`` carries the pipeline keys."""
    from repro_torch.wm import AcceRLWMSystem, WorldModelTrainer
    calls = []
    cycle = WorldModelTrainer.train_cycle

    def traced(self, batch):
        out = cycle(self, batch)
        calls.append((threading.current_thread().name,
                      self.updates["obs"]))
        return out
    monkeypatch.setattr(WorldModelTrainer, "train_cycle", traced)
    wm = WMConfig(imagine_horizon=2, history_frames=2, diffusion_steps=4,
                  obs_train_interval=1)
    rt = RuntimeConfig(num_rollout_workers=2, inference_batch=4,
                       pipeline=True)
    system = AcceRLWMSystem(CFG, _rl(2), rt, wm, suite="spatial",
                            segment_horizon=4, max_episode_steps=8,
                            imagination_batch=4, batch_episodes=4,
                            device="cpu")
    assert system.wm_trainer.driven
    m = system.run_wm(train_steps=4, wall_timeout_s=120.0)
    assert m["train_steps"] >= 4
    assert m["pipeline_rounds"] == system.trainer.pipeline.rounds >= 4
    assert set(m["pipeline_bubble"]) <= {"policy", "wm"}
    assert m["pipeline_peak_grad_bytes"] > 0
    assert calls and all(t == "pipeline-wm" for t, _ in calls)
    assert [n for _, n in calls] == list(range(1, len(calls) + 1))
    assert len(calls) <= m["pipeline_rounds"]
    assert m["wm_updates"]["obs"] == system.wm_trainer.cycles == len(calls)
