"""The launchers' pieces against the JAX package, on the CPU.

  * ``prefill_step`` and ``serve_step`` on reduced deepseek-7b and
    openvla-7b (prefix tokens), the prompt longer than ``block`` (the
    blockwise path, S ragged), into a cache of ``cache_len >= T`` and of
    ``cache_len < T`` (the ring), then three decode steps scattered and
    uniform: logits and caches against the reference's within rtol 1e-4 /
    atol 1e-5 (f32), uniform and scatter bit for bit in the port.
  * ``choose_accum``, ``long_context_window`` and ``effective_cache_len``
    equal the reference's for every registered arch x ``INPUT_SHAPES`` on
    16 x 16; ``train_specs``, ``prefill_specs`` and ``serve_specs`` spec for
    spec (and tree for tree, shapes and dtypes) the reference's.
  * The CLIs: ``train --local`` and ``serve --local`` run in a subprocess
    on the CPU; the production mesh refuses to start without its 256
    ranks; ``--pipeline``, ``--remote-rollout`` and ``--serve-workers``
    (which run systems of processes) have their argv -> config mapping held
    against the reference's, each side's system constructor captured
    before it starts anything.
"""
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jtransformer
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.sharding import rules as trules

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
MESH = ((16, 16), ("data", "model"))
ARCHS = list(jconfigs.ASSIGNED_ARCHS) + ["openvla-7b"]
SPEC_ARCHS = ["openvla-7b", "deepseek-7b", "mamba2-2.7b", "zamba2-1.2b",
              "granite-moe-1b-a400m", "dbrx-132b", "musicgen-medium"]


def _cache_np(cache):
    """Copies of a cache's leaves (the port's decode writes in place)."""
    return [np.array(x, copy=True) for part in cache if part is not None
            for x in part]


@functools.lru_cache(maxsize=None)
def _serve(arch, cache_len):
    """Prefill (T = 40 + prefix, block 16) and three decode steps in both
    packages from the same bridged backbone, and the port's decode again
    with ``uniform``."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch), layers=2, d_model=64)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), layers=2, d_model=64)
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    prefix = (rng.standard_normal((2, jcfg.num_prefix_tokens, 1024))
              .astype(np.float32) if jcfg.num_prefix_tokens else None)
    jpre = jax.jit(functools.partial(jsteps.prefill_step, cfg=jcfg,
                                     window=None, cache_len=cache_len,
                                     block=16))
    jlog, jcache = jpre(jp, jnp.asarray(tokens),
                        None if prefix is None else jnp.asarray(prefix))
    jdec = jax.jit(functools.partial(jsteps.serve_step, cfg=jcfg,
                                     window=None))
    with torch.no_grad():
        tlog, tcache = tsteps.prefill_step(
            tp, torch.from_numpy(tokens),
            None if prefix is None else torch.from_numpy(prefix), cfg=tcfg,
            window=None, cache_len=cache_len, block=16)
    out = dict(jlog=[np.asarray(jlog)], tlog=[tlog.numpy()],
               jcache=[_cache_np(jcache)], tcache=[_cache_np(tcache)])
    ucache = type(tcache)(*(None if part is None else type(part)(
        *(x.clone() for x in part)) for part in tcache))
    toks = [rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
            for _ in range(3)]
    ulog = []
    for tok in toks:
        jlog, jcache = jdec(jp, jnp.asarray(tok), jcache)
        with torch.no_grad():
            tlog, tcache = tsteps.serve_step(tp, torch.from_numpy(tok),
                                             tcache, cfg=tcfg, window=None)
            ul, ucache = tsteps.serve_step(tp, torch.from_numpy(tok),
                                           ucache, cfg=tcfg, window=None,
                                           uniform=True)
        out["jlog"].append(np.asarray(jlog))
        out["tlog"].append(tlog.numpy())
        out["jcache"].append(_cache_np(jcache))
        out["tcache"].append(_cache_np(tcache))
        ulog.append((tlog, ul, _cache_np(tcache), _cache_np(ucache)))
    out["uniform"] = ulog
    return out


@pytest.mark.parametrize("cache_len", [56, 32], ids=["full", "ring"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "openvla-7b"])
def test_prefill_and_serve_steps_match_reference(arch, cache_len):
    r = _serve(arch, cache_len)
    for i, (a, b) in enumerate(zip(r["tlog"], r["jlog"])):
        np.testing.assert_allclose(a, b, err_msg=f"logits {i}", **TOL)
    for i, (a, b) in enumerate(zip(r["tcache"], r["jcache"])):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape, (i, x.shape, y.shape)
            np.testing.assert_allclose(x, y, err_msg=f"cache {i}", **TOL)


@pytest.mark.parametrize("cache_len", [56, 32], ids=["full", "ring"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "openvla-7b"])
def test_uniform_decode_is_the_scatter_path_bit_for_bit(arch, cache_len):
    for tlog, ul, tc, uc in _serve(arch, cache_len)["uniform"]:
        assert torch.equal(tlog, ul)
        assert all(np.array_equal(x, y) for x, y in zip(tc, uc))


def test_accum_windows_and_cache_lengths_equal_reference():
    jm, tm = JAbstractMesh(*MESH), trules.AbstractMesh(*MESH)
    for arch in jconfigs.list_archs():
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for js, ts in zip(jconfigs.INPUT_SHAPES, tconfigs.INPUT_SHAPES):
            assert js.name == ts.name
            assert tsteps.long_context_window(tcfg, ts) == \
                jsteps.long_context_window(jcfg, js), (arch, js.name)
            assert tsteps.effective_cache_len(tcfg, ts) == \
                jsteps.effective_cache_len(jcfg, js), (arch, js.name)
            for pure_dp in (False, True):
                assert tsteps.choose_accum(tcfg, ts, tm, pure_dp=pure_dp) \
                    == jsteps.choose_accum(jcfg, js, jm, pure_dp=pure_dp), \
                    (arch, js.name, pure_dp)


def _jleaves(tree):
    """(spec or (shape, dtype)) leaves of a reference tree, in order."""
    def leaf(x):
        if isinstance(x, JNamedSharding):
            return tuple(x.spec)
        return tuple(x.shape), str(x.dtype)
    return [leaf(x) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))]


def _tleaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tleaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [s for f in tree._fields for s in _tleaves(getattr(tree, f))]
    if isinstance(tree, trules.NamedSharding):
        return [tuple(tree.spec)]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_spec_builders_equal_reference(arch):
    jm, tm = JAbstractMesh(*MESH), trules.AbstractMesh(*MESH)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shapes = {s.name: (s, t) for s, t in zip(jconfigs.INPUT_SHAPES,
                                             tconfigs.INPUT_SHAPES)}
    js, ts = shapes["train_4k"]
    for kw in ({"accum": 1}, {"accum": 8}, {"pure_dp": True},
               {"accum": 2, "fsdp_model": True},
               {"zero3_axis": "data", "pure_dp": True}):
        want = jsteps.train_specs(jcfg, js, jm, **kw)
        got = tsteps.train_specs(tcfg, ts, tm, **kw)
        for i, (w, g) in enumerate(zip(want, got)):
            assert _tleaves(g) == _jleaves(w), (arch, kw, i)
    serve_kws = ({}, {"seq_shard": True})
    for name, builder, kws in (("prefill_32k", "prefill_specs", ({},)),
                               ("decode_32k", "serve_specs", serve_kws),
                               ("long_500k", "serve_specs", serve_kws)):
        js, ts = shapes[name]
        for kw in kws:
            want = getattr(jsteps, builder)(jcfg, js, jm, **kw)
            got = getattr(tsteps, builder)(tcfg, ts, tm, **kw)
            assert (got["window"], got["cache_len"]) == \
                (want["window"], want["cache_len"])
            for key in want:
                if key in ("window", "cache_len"):
                    continue
                assert _tleaves(got[key]) == _jleaves(want[key]), \
                    (arch, name, kw, key)


def _cli(*argv, timeout=120):
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                               "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_local_runs_on_the_cpu():
    res = _cli("repro_torch.launch.train", "--local", "--steps", "3",
               "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("mesh {'data': 1, 'model': 1} | accum 1")
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_serve_cli_local_runs_on_the_cpu():
    res = _cli("repro_torch.launch.serve", "--local", "--tokens", "4",
               "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == ("arch internlm2-1.8b | cache_len 64 | window None | "
                        "batch 2")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        f"decode {i}" for i in range(4)]


def test_train_cli_without_local_needs_the_production_group():
    res = _cli("repro_torch.launch.train", "--steps", "1", "--device", "cpu")
    assert res.returncode != 0
    assert "needs a process group of 256 ranks" in res.stderr


class _Captured(Exception):
    pass


def _capture(store):
    def ctor(*args, **kwargs):
        store.append((args, kwargs))
        raise _Captured
    return ctor


def _configs(args, kwargs):
    out = [dataclasses.asdict(a) for a in args]
    return out, {k: v for k, v in kwargs.items() if k != "device"}


@pytest.mark.parametrize("argv", [
    ["--pipeline", "--steps", "2", "--no-fused-loss", "--trace-out",
     "trace.json", "--kernel-dispatch", "jnp"],
    ["--remote-rollout", "2", "--remote-transport", "ring", "--restart",
     "on_failure", "--max-restarts", "3", "--elastic-workers", "4",
     "--inference-plane", "spawn", "--journal-dir", "j", "--resume-journal",
     "--put-window", "4"],
    ["--serve-workers", "1", "--listen", "127.0.0.1:5555", "--token", "t",
     "--trace-out", "t.json"],
], ids=["pipeline", "remote-rollout", "serve-workers"])
def test_system_modes_map_argv_as_the_reference(argv, monkeypatch):
    """The reference's and the port's ``_run_pipeline`` /
    ``_run_remote_rollout`` on the same flags build the same configs; each
    side's system constructor is captured before it starts anything."""
    import repro.runtime
    import repro.wm.wm_system
    import repro_torch.runtime
    import repro_torch.wm.wm_system
    from repro_torch.kernels import dispatch
    got, want = [], []
    name = "AcceRLWMSystem" if "--pipeline" in argv else "AcceRLSystem"
    mods = ((repro.wm.wm_system, repro_torch.wm.wm_system)
            if name == "AcceRLWMSystem" else (repro.runtime,
                                              repro_torch.runtime))
    monkeypatch.setattr(mods[0], name, _capture(want))
    monkeypatch.setattr(mods[1], name, _capture(got))
    args = ttrain.parser().parse_args(argv + ["--device", "cpu"])
    run = "_run_pipeline" if name == "AcceRLWMSystem" else \
        "_run_remote_rollout"
    with pytest.raises(_Captured):
        getattr(jtrain, run)(args)
    try:
        with pytest.raises(_Captured):
            ttrain.main(argv + ["--device", "cpu"])
        assert dispatch._override == ttrain.DISPATCH_MODES[
            args.kernel_dispatch]
    finally:
        dispatch.set_mode(None)
    assert _configs(*got[0]) == _configs(*want[0])
    assert got[0][1]["device"] == torch.device("cpu")
