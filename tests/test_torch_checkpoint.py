"""The port's checkpoints (``repro_torch.data.checkpoint``) against the
reference's (``repro.data.checkpoint``): the same ``.npz`` members with
the same bytes for the same state (f32 and bf16 leaves), each package
restoring the other's files, bf16 carried bit for bit where the reference
cannot restore it (ROADMAP C5), pruning, ``latest_step``, and the
trainer's checkpoint interval. Exact: every comparison is of bytes or
bits."""
import dataclasses
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core.train_step import init_train_state as j_init_train_state
from repro.data import checkpoint as jck
from repro_torch.bridge import params_from_numpy
from repro_torch.core.advnorm import AdvNormState
from repro_torch.core.train_step import TrainState
from repro_torch.data import checkpoint as tck
from repro_torch.data.checkpoint import _flatten_with_path
from repro_torch.data.trajectory import dummy_batch
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import (FifoChannel, TrainerWorker,
                                 VersionedWeightStore)


def _cfg(cfgs, dtype):
    return dataclasses.replace(
        cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64),
        param_dtype=dtype, compute_dtype=dtype, num_prefix_tokens=1)


def _ref_state(dtype, seed=0):
    """The reference's reduced deepseek-7b train state with every leaf
    drawn (moments, Welford state and version nonzero)."""
    rng = np.random.default_rng(seed)
    js = j_init_train_state(_cfg(jconfigs, dtype), jax.random.PRNGKey(seed))
    draw = lambda x: rng.standard_normal(x.shape).astype(np.float32)  # noqa
    return js._replace(
        opt=js.opt._replace(step=np.int32(3),
                            mu=jax.tree.map(draw, js.opt.mu),
                            nu=jax.tree.map(lambda x: np.abs(draw(x)),
                                            js.opt.nu)),
        adv_norm=type(js.adv_norm)(*(np.float32(v) for v in (5, .25, 2))),
        version=np.int32(7))


def _bridge(js) -> TrainState:
    """The reference's state through the bridge, leaf by leaf."""
    s = jax.tree.map(np.asarray, js)
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return TrainState(
        params=params_from_numpy(s.params, device="cpu"),
        opt=AdamWState(step=as_t(s.opt.step),
                       mu=params_from_numpy(s.opt.mu, device="cpu"),
                       nu=params_from_numpy(s.opt.nu, device="cpu")),
        adv_norm=AdvNormState(*(as_t(x) for x in s.adv_norm)),
        version=as_t(s.version))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bits_equal(a, b):
    fa, fb = list(_flatten_with_path(a)), list(_flatten_with_path(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(_bits(x), _bits(y)), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_writes_the_reference_members_byte_for_byte(tmp_path, dtype):
    js = _ref_state(dtype)
    p_ref = jck.save(str(tmp_path / "ref"), 5, js)
    p_port = tck.save(str(tmp_path / "port"), 5, _bridge(js))
    z_ref, z_port = zipfile.ZipFile(p_ref), zipfile.ZipFile(p_port)
    assert z_port.namelist() == z_ref.namelist()
    assert any(n.startswith("opt::mu::") for n in z_ref.namelist())
    for name in z_ref.namelist():
        assert z_port.read(name) == z_ref.read(name), name
    if dtype == "bfloat16":
        assert b"'descr': '<V2'" in z_port.read("params::embed::table.npy")
    meta = json.loads((tmp_path / "port" / "ckpt_0000000005.json")
                      .read_text())
    assert meta["step"] == 5


def test_reference_restores_the_ports_f32_checkpoint(tmp_path):
    js = _ref_state("float32")
    tck.save(str(tmp_path), 2, _bridge(js))
    got = jck.restore(str(tmp_path), js)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_restores_the_references_bf16_checkpoint_bit_for_bit(tmp_path):
    js = _ref_state("bfloat16")
    jck.save(str(tmp_path), 4, js)
    with pytest.raises(ValueError):          # C5: no cast to bf16 in numpy
        jck.restore(str(tmp_path), js)
    live = _bridge(js)
    meta = jax.tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), live)
    got = tck.restore(str(tmp_path), meta, device="cpu")
    assert got.params["embed"]["table"].dtype == torch.bfloat16
    assert got.params["embed"]["table"].device.type == "cpu"
    _assert_bits_equal(got, live)
    # a live template
    again = tck.restore(str(tmp_path), live, step=4, device="cpu")
    _assert_bits_equal(again, live)


def test_prune_latest_step_and_missing_directory(tmp_path):
    state = _bridge(_ref_state("float32"))
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), state, device="cpu")
    assert tck.latest_step(str(tmp_path)) is None
    for step in (1, 2, 3, 4):
        tck.save(str(tmp_path), step, state, keep=2,
                 metadata={"note": step})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_0000000003.json", "ckpt_0000000003.npz",
                     "ckpt_0000000004.json", "ckpt_0000000004.npz"]
    assert tck.latest_step(str(tmp_path)) == 4
    assert jck.latest_step(str(tmp_path)) == 4
    with pytest.raises(NotImplementedError, match="A7"):
        tck.restore(str(tmp_path), state, shardings=object(),
                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.restore(str(tmp_path), state._replace(
            version=torch.zeros(2, dtype=torch.int32)), device="cpu")


def test_trainer_saves_every_interval_and_its_state_restores(tmp_path):
    cfg = _cfg(tconfigs, "bfloat16")
    rt = tconfigs.RuntimeConfig()
    rl = tconfigs.RLConfig(grad_accum=1, lr_policy=1e-3, warmup_steps=1)
    trainer = TrainerWorker(cfg, rl, rt, FifoChannel(1),
                            VersionedWeightStore(), batch_episodes=2,
                            checkpoint_dir=str(tmp_path),
                            checkpoint_interval=2, device="cpu")
    for seed in range(3):
        trainer.train_on_batch(dummy_batch(
            2, 3, 6, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
            num_prefix=1, seed=seed))
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "ckpt_0000000002.npz"]
    trainer.train_on_batch(dummy_batch(
        2, 3, 6, cfg.action_dim, cfg.vocab_size, cfg.action_vocab_size,
        num_prefix=1, seed=3))
    assert tck.latest_step(str(tmp_path)) == 4
    _assert_bits_equal(tck.restore(str(tmp_path), trainer.state,
                                   device="cpu"),
                       trainer.state)
    assert int(trainer.state.version) == 4
