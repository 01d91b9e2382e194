"""The port's distribution layer against the JAX package, on the CPU.

  * Specs, spec for spec, against the reference's own rules on shape-only
    meshes (16 x 16 and 2 x 16 x 16): ``param_specs`` for every assigned
    arch and openvla-7b (``fsdp`` None / True, ``tp=False``,
    ``ATTN_PREFER_DMODEL`` on musicgen), ``shard_moments_spec``,
    ``data_spec`` over the input shapes, ``cache_specs`` on four decode
    caches at batch 128 and length 4096 (the port's trees on ``meta``).
  * Placements and bytes with no memory: a fake process group of 256 (or
    512) ranks in a subprocess per mesh; full-depth openvla-7b and
    dbrx-132b placed through ``init_train_state(mesh=)`` on ``meta``,
    every local region held against DTensor's own, the realized moment
    bytes per device against the specs' exact figure and, where every
    leaf found a divisible axis, the analytic one.
  * ZeRO-2 at run time: two gloo ranks (a subprocess each, over a
    ``FileStore``): realized moment bytes at D = 2, and one fused step of
    reduced deepseek-7b from the placed state bit for bit the one-rank
    step.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro.optim import zero as jzero
from repro.sharding import rules as jrules
import repro_torch.configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttransformer
from repro_torch.models.policy import init_policy_params
from repro_torch.optim import zero as tzero
from repro_torch.sharding import rules as trules
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list(jconfigs.ASSIGNED_ARCHS) + ["openvla-7b"]
CACHE_ARCHS = ["granite-20b", "zamba2-1.2b", "mamba2-2.7b", "dbrx-132b"]


def _jspecs(tree):
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _tspecs(tree):
    """Spec leaves of a tree of dicts and NamedTuples (a spec is a plain
    tuple), in JAX's leaf order; ``None`` subtrees are empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tspecs(tree[k])]
    if hasattr(tree, "_fields"):
        return [s for f in tree._fields for s in _tspecs(getattr(tree, f))]
    assert isinstance(tree, trules.PartitionSpec), tree
    return [tuple(tree)]


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The reference's abstract param tree and the port's on meta."""
    return (jsteps.param_structs(jconfigs.get_config(arch)),
            init_policy_params(tconfigs.get_config(arch), device="meta"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshapes, tshapes = _shapes(arch)
    jm, tm = JAbstractMesh(*MESHES[mesh]), trules.AbstractMesh(*MESHES[mesh])
    for kw in ({}, {"fsdp": False}, {"fsdp": True}, {"tp": False}):
        want = _jspecs(jrules.param_specs(jcfg, jshapes, jm, **kw))
        got = _tspecs(trules.param_specs(tcfg, tshapes, tm, **kw))
        assert got == want, (arch, mesh, kw)
    assert [x.shape for x in jax.tree.leaves(jshapes)] == [
        tuple(x.shape) for x in tree_leaves(tshapes)]


def test_attn_prefer_dmodel_on_musicgen(monkeypatch):
    """musicgen's 24 heads do not divide the model axis: the toggle moves
    its attention weights from head_dim to d_model, in both packages."""
    arch = "musicgen-medium"
    jshapes, tshapes = _shapes(arch)
    jm, tm = JAbstractMesh(*MESHES["16x16"]), trules.AbstractMesh(
        *MESHES["16x16"])
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    off = _tspecs(trules.param_specs(tcfg, tshapes, tm))
    monkeypatch.setattr(jrules, "ATTN_PREFER_DMODEL", True)
    monkeypatch.setattr(trules, "ATTN_PREFER_DMODEL", True)
    on = _tspecs(trules.param_specs(tcfg, tshapes, tm))
    assert on == _jspecs(jrules.param_specs(jcfg, jshapes, jm))
    assert on != off


@pytest.mark.parametrize("arch", ARCHS)
def test_moment_specs_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshapes, tshapes = _shapes(arch)
    jm, tm = JAbstractMesh(*MESHES["16x16"]), trules.AbstractMesh(
        *MESHES["16x16"])
    for fsdp in (None, True):
        jp = jrules.param_specs(jcfg, jshapes, jm, fsdp=fsdp)
        tp = trules.param_specs(tcfg, tshapes, tm, fsdp=fsdp)
        want = _jspecs(jzero.shard_moments_spec(jshapes, jp,
                                                data_axis="data",
                                                data_size=16))
        got = _tspecs(tzero.shard_moments_spec(tshapes, tp,
                                               data_axis="data",
                                               data_size=16))
        assert got == want, (arch, fsdp)


@pytest.mark.parametrize("shape", jconfigs.INPUT_SHAPES,
                         ids=lambda s: s.name)
def test_data_spec_and_batch_axes_equal_reference(shape):
    for name in MESHES:
        jm = JAbstractMesh(*MESHES[name])
        tm = trules.AbstractMesh(*MESHES[name])
        assert trules.batch_axes(tm) == jrules.batch_axes(jm)
        for ndim, kw in ((2, {"seq_axis": 1, "seq_len": shape.seq_len}),
                         (3, {})):
            want = jrules.data_spec(jm, shape.global_batch, ndim, **kw)
            got = trules.data_spec(tm, shape.global_batch, ndim, **kw)
            assert tuple(got) == tuple(want), (name, ndim)
        assert tuple(trules.replicated(tm).spec) == tuple(
            jrules.replicated(jmesh.make_local_mesh()).spec)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jcache = jax.eval_shape(
        lambda: jtransformer.init_decode_cache(jcfg, 128, 4096))
    tcache = ttransformer.init_decode_cache(tcfg, 128, 4096, device="meta")
    for name in MESHES:
        jm = JAbstractMesh(*MESHES[name])
        tm = trules.AbstractMesh(*MESHES[name])
        for batch, seq_model in ((128, False), (1, False), (1, True)):
            want = _jspecs(jrules.cache_specs(jcfg, jcache, jm, batch, 4096,
                                              seq_shard_model=seq_model))
            got = _tspecs(trules.cache_specs(tcfg, tcache, tm, batch, 4096,
                                             seq_shard_model=seq_model))
            assert got == want, (name, batch, seq_model)


def test_mesh_constants_are_the_h100s():
    assert (tmesh.SINGLE_POD, tmesh.MULTI_POD) == (jmesh.SINGLE_POD,
                                                   jmesh.MULTI_POD)
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == tmesh.ICI_BW == 50e9
    assert tmesh.num_chips(trules.AbstractMesh(*MESHES["16x16"])) == 256
    assert tmesh.num_chips(trules.AbstractMesh(*MESHES["2x16x16"])) == 512


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


# One process per mesh: the fake group is process-global.
_FAKE_SCRIPT = r"""
import json, math, sys
import torch, torch.distributed as dist
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.core.train_step import init_train_state
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.policy import init_policy_params
from repro_torch.optim import adamw, zero
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

mesh_name, rank = sys.argv[1], int(sys.argv[2])
multi = mesh_name == "2x16x16"
dist.init_process_group("fake", store=FakeStore(), rank=rank,
                        world_size=512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi, device="cpu")
sizes = rules.mesh_shape(mesh)

def check_region(t, spec):
    plc = rules.placements(spec, mesh)
    assert tuple(t.placements) == plc, (t.placements, plc)
    want = compute_local_shape_and_global_offset(t.shape, mesh, plc)
    got = rules.local_region(t.shape, mesh, plc)
    assert (tuple(want[0]), tuple(want[1])) == got, (spec, want, got)
    assert tuple(t.to_local().shape) == got[0]

def exact_bytes(shapes, specs, nbytes):
    return sum(math.prod(s.shape) * nbytes // math.prod(
        sizes[n] for e in sp if e is not None
        for n in (e if isinstance(e, tuple) else (e,)))
        for s, sp in zip(tree_leaves(shapes), tree_leaves(specs)))

out = {}
for arch in ("openvla-7b", "dbrx-132b"):
    cfg = get_config(arch)
    st = init_train_state(cfg, 0, mesh=mesh, device="meta")
    shapes = init_policy_params(cfg, device="meta")
    pspec = rules.param_specs(cfg, shapes, mesh)
    mspec = zero.shard_moments_spec(shapes, pspec,
                                    data_size=sizes["data"])
    tree_map(check_region, st.params, pspec)
    tree_map(check_region, st.opt.mu, mspec)
    realized = zero.realized_moments_bytes_per_device(st.opt)
    assert realized == exact_bytes(shapes, mspec, 8), realized
    # pure ZeRO (params replicated): the analytic claim over the leaves
    # that found an axis divisible by data; the others stay whole
    pure = zero.shard_opt_state(adamw.init(shapes), mesh)
    pspec0 = tree_map(lambda s: rules.P(), shapes)
    m0 = zero.shard_moments_spec(shapes, pspec0, data_size=sizes["data"])
    got0 = zero.realized_moments_bytes_per_device(pure)
    assert got0 == exact_bytes(shapes, m0, 8)
    fit = {"/".join(k): ("data" in sp, math.prod(x.shape)) for (k, x), sp
           in zip(tree_leaves_with_path(shapes), tree_leaves(m0))}
    n_fit = sum(n for ok, n in fit.values() if ok)
    n_rest = sum(n for ok, n in fit.values() if not ok)
    analytic = (zero.moments_bytes_per_device(n_fit, sizes["data"], True)
                + zero.moments_bytes_per_device(n_rest, sizes["data"],
                                                False))
    assert got0 == analytic, (got0, analytic)
    params = sum(x.to_local().numel() * x.to_local().element_size()
                 for x in tree_leaves(st.params))
    out[arch] = {"params": params, "moments": realized, "pure": got0,
                 "count": n_fit + n_rest,
                 "unfit": sorted(k for k, (ok, _) in fit.items() if not ok)}
if multi:
    # ("pod", "data") on one tensor dim: pod major, data minor
    cfg = get_config("granite-20b")
    cache = transformer.init_decode_cache(cfg, 128, 4096, device="meta")
    specs = rules.cache_specs(cfg, cache, mesh, 128, 4096)
    assert tuple(specs.attn.k)[1] == ("pod", "data")
    for t, sp in ((cache.attn.k, specs.attn.k), (cache.attn.v, specs.attn.v)):
        check_region(rules.place(t, rules.NamedSharding(mesh, sp)), sp)
print(json.dumps(out))
"""


@pytest.mark.parametrize("mesh,rank", [("16x16", 0), ("16x16", 201),
                                       ("2x16x16", 389)])
def test_placed_state_bytes_on_a_fake_group(mesh, rank):
    """Full-depth openvla-7b and dbrx-132b placed on ``meta`` over a fake
    16 x 16 (2 x 16 x 16) group: every region is DTensor's own, and the
    realized moment bytes per device equal the specs' exact figure; with
    params replicated (pure ZeRO) they equal the analytic figure over the
    leaves that found an axis divisible by ``data``, plus the whole of the
    one leaf that did not (the value head's [1] bias)."""
    res = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT, mesh,
                          str(rank)], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for arch in ("openvla-7b", "dbrx-132b"):
        got = out[arch]
        assert got["unfit"] == ["value_head/mlp_b2"]
        assert got["moments"] < got["pure"] < 8 * got["count"] / 15
    # openvla-7b: 16 B a parameter is ~106 GB of training state; placed,
    # a device holds what fits beside an 80 GB card's activations
    assert out["openvla-7b"]["params"] + out["openvla-7b"]["moments"] < 2e9


_ZERO_SCRIPT = r"""
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core.train_step import init_train_state, make_train_step
from repro_torch.data.trajectory import dummy_batch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import adamw, zero
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_leaves_with_path

path, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2)
mesh = make_local_mesh(device="cpu")
assert rules.mesh_shape(mesh) == {"data": 2, "model": 1}

# every axis divisible by D: the analytic figure is met exactly, and the
# unsharded moments really are D times bigger
params = {"w1": torch.zeros(64, 32), "w2": torch.zeros(16, 128),
          "b": torch.zeros(256)}
count = sum(p.numel() for p in tree_leaves(params))
opt = zero.shard_opt_state(adamw.init(params), mesh)
assert zero.realized_moments_bytes_per_device(opt) == \
    zero.moments_bytes_per_device(count, 2, zero=True)
assert zero.realized_moments_bytes_per_device(adamw.init(params)) == \
    zero.moments_bytes_per_device(count, 2, zero=False)

cfg = reduced(get_config("deepseek-7b"), layers=2, d_model=64)
rl = RLConfig(grad_accum=2, lr_policy=1e-3, lr_value=1e-2, warmup_steps=2)
plain = init_train_state(cfg, 0, device="cpu")
placed = init_train_state(cfg, 0, mesh=mesh, device="cpu")
assert all(rules.is_dtensor(x) for x in tree_leaves(placed.opt.mu))
count = sum(p.numel() for p in tree_leaves(plain.params))
half = zero.realized_moments_bytes_per_device(placed.opt)
assert half < zero.realized_moments_bytes_per_device(plain.opt)
step = make_train_step(cfg, rl, device="cpu")
batch = dummy_batch(4, 3, 6, cfg.action_dim, cfg.vocab_size,
                    cfg.action_vocab_size, seed=1)
plain, m1 = step(plain, batch)
placed, m2 = step(placed, batch)
assert {k: float(v) for k, v in m1.items()} == \
    {k: float(v) for k, v in m2.items()}
got = dict(tree_leaves_with_path(placed.params))
for key, x in tree_leaves_with_path(plain.params):
    assert torch.equal(rules.full_tensor(got[key]), x), key
for tree_p, tree_1 in ((placed.opt.mu, plain.opt.mu),
                       (placed.opt.nu, plain.opt.nu)):
    got = dict(tree_leaves_with_path(tree_p))
    for key, x in tree_leaves_with_path(tree_1):
        m = got[key]
        shape, off = rules.local_region(x.shape, mesh, m.placements)
        assert torch.equal(m.to_local(), rules.region(x, shape, off)), key
print("OK", rank, half)
"""


def test_zero2_step_on_two_gloo_ranks_equals_the_one_rank_step(tmp_path):
    """ZeRO-2 at run time on two gloo ranks: realized moment bytes equal
    the analytic figure at D = 2 (the unsharded moments are twice as
    big), and one fused step of reduced deepseek-7b from the placed state
    equals the one-rank step bit for bit in the params and the metrics,
    each rank's moment shards the matching slices of the one-rank
    moments."""
    store = str(tmp_path / "store")
    env = _env()
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, "-c", _ZERO_SCRIPT, store,
                               str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert out.startswith("OK")
