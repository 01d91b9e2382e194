"""The placed step programs split over a mesh (``repro_torch.sharding.spmd``)
against the JAX package, on the CPU, over gloo ranks in subprocesses.

The parent draws the port's params (seed 0) and numpy batches whose second
data rank's rows keep fewer mask entries than the first's (the weighting
of each rank's masked means is what gets tested), and saves them for the
ranks. Two groups run at once, each rank a subprocess over a ``FileStore``
(``GLOO_SOCKET_IFNAME=lo``, one thread): two ranks building the meshes
2 x 1 and 1 x 2 (``launch.mesh.make_mesh``), four building 2 x 2. On every
mesh each rank places the state (``train.init_state``), takes its rows
(``spmd.rows``) and runs ``seq_train_step``; prefill and three decodes run
from the placed params on 2 x 1 and 1 x 2. Rank 0 saves the metrics, the
Welford state, the first moments and params gathered whole, and the
logits gathered over data.

  * Reduced deepseek-7b and openvla-7b (its 8 prefix tokens; heads 4,
    ``d_ff`` 256 and vocab 512, all split on ``model``), ``accum`` 1 and
    2, on all three meshes: ``seq_train_step`` against the reference's
    jitted single-device one (``test_torch_steps.py``'s METRIC_TOL, its
    moment bar and its params rule) and against the port's one-rank step
    (metrics, Welford state and each moment leaf within 1e-5 of its
    largest value; the params as against the reference).
  * Prefill and decode of both on 2 x 1 and 1 x 2 against the reference's
    ``prefill_step`` / ``serve_step`` (logits within 1e-4 of the largest).
  * The data split alone: reduced mamba2-2.7b (T = 64, two SSD chunks) and
    granite-moe-1b-a400m (1024 tokens a micro-batch: the reference's two
    capacity groups, one a rank; the load-balance and router-z terms over
    the global batch) on 2 x 1.
  * A one-rank mesh issues no collective in any step program (the c10d
    record of ``roofline.analysis.terms_from_program``).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RLConfig as JRLConfig
from repro.core.advnorm import init_adv_state as j_init_adv_state
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_to_numpy
from repro_torch.configs.base import RLConfig
from repro_torch.core.advnorm import init_adv_state
from repro_torch.launch import steps as tsteps
from repro_torch.models.policy import init_policy_params
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)        # test_torch_steps.py's
LR = 1e-3
RL_KW = dict(lr_policy=LR, warmup_steps=2)
B = 8
# (arch, accum, S, meshes)
DENSE = ("deepseek-7b", "openvla-7b")
CASES = [(a, acc, 40, ("2x1", "1x2", "2x2")) for a in DENSE
         for acc in (1, 2)] + [
    ("mamba2-2.7b", 1, 64, ("2x1",)),
    ("granite-moe-1b-a400m", 1, 128, ("2x1",)),
]
SERVE_PROMPT, SERVE_DECODES, CACHE_LEN = 12, 3, 16


def _cfg(arch, pkg=tconfigs):
    return pkg.reduced(pkg.get_config(arch), layers=2, d_model=64)


def _case_id(case):
    return f"{case[0]}-accum{case[1]}"


def _batch(cfg, accum, s, seed=0):
    """A numpy batch (leading [accum] where accum > 1). Rows of the second
    half of each micro-batch, the second data rank's on 2 x 1 and 2 x 2,
    keep about 40% of the first half's mask entries."""
    rng = np.random.default_rng(seed)
    lead = (accum, B // accum) if accum > 1 else (B,)
    mask = (rng.random(lead + (s - 1,)) < 0.9).astype(np.float32)
    half = (slice(None),) * (len(lead) - 1) + (slice(lead[-1] // 2, None),)
    mask[half] *= rng.random(mask[half].shape) < 0.4
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, lead + (s,)
                               ).astype(np.int32),
        "behavior_logp": (rng.standard_normal(lead + (s,)) * 0.3
                          - np.log(cfg.action_vocab_size)).astype(np.float32),
        "rewards": rng.standard_normal(lead + (s - 1,)).astype(np.float32),
        "dones": (rng.random(lead + (s - 1,)) < 0.1).astype(np.float32),
        "mask": mask,
    }
    if cfg.num_prefix_tokens:
        out["prefix"] = rng.standard_normal(
            lead + (cfg.num_prefix_tokens, 1024)).astype(np.float32)
    return out


def _serve_inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, SERVE_PROMPT)
                                  ).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab_size, (SERVE_DECODES, B)
                                  ).astype(np.int32)}
    if cfg.num_prefix_tokens:
        out["prefix"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, 1024)).astype(np.float32)
    return out


_RANK = r"""
import dataclasses, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config, get_shape, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.policy import init_policy_params
from repro_torch.sharding import rules, spmd
from repro_torch.tree import tree_map

store, rank, world, path, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
inp = torch.load(path, weights_only=False)
meshes = ["2x1", "1x2"] if world == 2 else ["2x2"]
res = {}


def whole(tree):
    return tree_map(lambda x: spmd.gather(x).clone(), tree)


def over_data(x, mesh):
    data = spmd.DataAxes(mesh)
    if data.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(data.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts)


for tag in meshes:
    d, m = map(int, tag.split("x"))
    mesh = make_mesh(d, m, device="cpu")
    for key, case in inp["cases"].items():
        if tag not in case["meshes"]:
            continue
        cfg = reduced(get_config(case["arch"]), layers=2, d_model=64)
        rl = RLConfig(**inp["rl"])
        accum, batch = case["accum"], case["batch"]
        lead = batch["tokens"].shape
        b, s = (lead[0] * lead[1], lead[2]) if accum > 1 else lead
        shape = dataclasses.replace(get_shape("train_4k"), global_batch=b,
                                    seq_len=s)
        _, _, sspec, _ = steps.train_specs(cfg, shape, mesh, accum=accum)
        state = train.init_state(cfg, mesh, sspec, "cpu")
        lay = spmd.layout(cfg, state.params)
        rows = spmd.rows(batch, mesh, dim=1 if accum > 1 else 0)
        state, metrics = steps.seq_train_step(
            state, rows, cfg=cfg, rl=rl, accum=accum,
            grad_shardings=sspec.params)
        got = dict(metrics={k: float(v) for k, v in metrics.items()},
                   adv=[float(x) for x in state.adv_norm],
                   mu=whole(state.opt.mu), params=whole(state.params),
                   tp=lay.tensor_parallel())
        serve = case.get("serve")
        if serve is not None and tag != "2x2":
            p0 = init_policy_params(cfg, 0, device="cpu")
            placed = rules.place_tree(p0, mesh,
                                      rules.param_specs(cfg, p0, mesh))
            toks = spmd.rows(serve["tokens"], mesh)
            prefix = None if serve.get("prefix") is None else spmd.rows(
                serve["prefix"], mesh)
            logits, cache = steps.prefill_step(
                placed, toks, prefix, cfg=cfg, window=None,
                cache_len=inp["cache_len"], block=None)
            out_logits = [over_data(logits, mesh)]
            for tok in serve["decode"]:
                logits, cache = steps.serve_step(
                    placed, spmd.rows(tok, mesh), cache, cfg=cfg,
                    window=None)
                out_logits.append(over_data(logits, mesh))
            got["serve"] = torch.stack(out_logits)
            got["kv_heads"] = cache.attn.k.shape[3]
        res[(key, tag)] = got
if rank == 0:
    torch.save(res, out)
print("OK", rank)
"""


def _group(world, store, path, out, env):
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, store, str(r), str(world), path, out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs saved, the two groups run, each group's rank-0 results."""
    tmp = tmp_path_factory.mktemp("spmd")
    cases = {}
    for arch, accum, s, meshes in CASES:
        cfg = _cfg(arch)
        case = dict(arch=arch, accum=accum, meshes=meshes,
                    batch={k: torch.from_numpy(v) for k, v in
                           _batch(cfg, accum, s).items()})
        if arch in DENSE and accum == 1:
            case["serve"] = {k: torch.from_numpy(v) for k, v in
                             _serve_inputs(cfg).items()}
        cases[_case_id((arch, accum))] = case
    path = str(tmp / "inputs.pt")
    torch.save({"cases": cases, "rl": RL_KW, "cache_len": CACHE_LEN}, path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    outs = {w: str(tmp / f"out{w}.pt") for w in (2, 4)}
    procs = [p for w in (2, 4)
             for p in _group(w, str(tmp / f"store{w}"), path, outs[w], env)]
    logs = []
    try:
        # the references while the ranks run
        for arch, accum, s, _ in CASES:
            _references(arch, accum, s)
        for arch in DENSE:
            _reference_serving(arch)
        for p in procs:
            logs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err[-6000:]
    res = {}
    for w in (2, 4):
        res.update(torch.load(outs[w], weights_only=False))
    return cases, res


def _jflat(tree):
    return {tuple(getattr(p, "key", None) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {path: x.detach().float().numpy()
            for path, x in tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _references(arch, accum, s):
    """The reference's jitted single-device ``seq_train_step`` and the
    port's one-rank step, from the port's seed-0 params and the same
    numpy batch."""
    tcfg, jcfg = _cfg(arch), _cfg(arch, jconfigs)
    tp = init_policy_params(tcfg, 0, device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    nb = _batch(tcfg, accum, s)
    jstate = jsteps.SeqTrainState(jp, jadamw.init(jp), j_init_adv_state())
    js, jm = jax.jit(functools.partial(
        jsteps.seq_train_step, cfg=jcfg, rl=JRLConfig(**RL_KW),
        accum=accum))(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    ts, tm = tsteps.seq_train_step(
        tsteps.SeqTrainState(tp, adamw.init(tp), init_adv_state("cpu")),
        {k: torch.from_numpy(v) for k, v in nb.items()}, cfg=tcfg,
        rl=RLConfig(**RL_KW), accum=accum)
    return (dict(metrics={k: float(v) for k, v in jm.items()},
                 adv=[float(x) for x in js.adv_norm], mu=_jflat(js.opt.mu),
                 params=_jflat(js.params)),
            dict(metrics={k: float(v) for k, v in tm.items()},
                 adv=[float(x) for x in ts.adv_norm], mu=_tflat(ts.opt.mu),
                 params=_tflat(ts.params)))


def _hold(got, want, *, moment_bar):
    """Metrics and Welford state within METRIC_TOL; each first-moment leaf
    within ``moment_bar(leaf)``; the params within 0.1 lr, 2 lr where the
    wanted moment is within its bar of 0 (AdamW's first step moves an
    element by about lr whatever its gradient)."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k,
                                   **METRIC_TOL)
    np.testing.assert_allclose(got["adv"], want["adv"], **METRIC_TOL)
    mu, params = _tflat(got["mu"]), _tflat(got["params"])
    assert mu.keys() == want["mu"].keys()
    lr = LR / RL_KW["warmup_steps"]
    for path, e in want["mu"].items():
        bar = moment_bar(e)
        diff = float(np.abs(mu[path] - e).max())
        assert diff <= bar, (path, diff, bar)
        moved = np.abs(params[path] - want["params"][path])
        held = np.where(np.abs(e) > bar, 0.1 * lr, 2 * lr + 1e-7)
        assert (moved <= held).all(), (path, float(moved.max()))


def _train_cases():
    return [(a, acc, s, m) for a, acc, s, ms in CASES for m in ms]


@pytest.mark.parametrize("arch,accum,s,mesh", _train_cases(),
                         ids=lambda x: str(x))
def test_placed_train_step_matches_reference_and_one_rank(runs, arch, accum,
                                                          s, mesh):
    """``seq_train_step`` on the mesh, each rank fed its rows of a batch
    whose data ranks hold unequal mask counts: against the reference's
    single-device step (test_torch_steps.py's bars) and the port's
    one-rank step (1e-5 of each moment leaf's largest value). The dense
    family splits attention, the MLP and the embedding over model where
    the mesh has a model axis; the others split the data alone."""
    _, res = runs
    got = res[(_case_id((arch, accum)), mesh)]
    model = int(mesh.split("x")[1])
    want_tp = ["attn", "mlp", "vocab"] if arch in DENSE and model > 1 \
        else []
    assert got["tp"] == want_tp
    jref, tref = _references(arch, accum, s)
    _hold(got, jref, moment_bar=lambda e: 1e-5 * 0.1
          + 1e-4 * float(np.abs(e).max()))
    _hold(got, tref, moment_bar=lambda e: 1e-5 * float(np.abs(e).max()))


@functools.lru_cache(maxsize=None)
def _reference_serving(arch):
    """The reference's ``prefill_step`` and three ``serve_step``s from the
    port's seed-0 params: the logits of each, stacked."""
    tcfg, jcfg = _cfg(arch), _cfg(arch, jconfigs)
    tp = init_policy_params(tcfg, 0, device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    jp = {k: v for k, v in jp.items() if k != "value_head"}
    inp = _serve_inputs(tcfg)
    prefix = inp.get("prefix")
    logits, cache = jsteps.prefill_step(
        jp, jnp.asarray(inp["tokens"]),
        None if prefix is None else jnp.asarray(prefix), cfg=jcfg,
        window=None, cache_len=CACHE_LEN, block=None)
    out = [np.asarray(logits)]
    for tok in inp["decode"]:
        logits, cache = jsteps.serve_step(jp, jnp.asarray(tok), cache,
                                          cfg=jcfg, window=None)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("arch", DENSE)
def test_placed_prefill_and_decode_match_reference(runs, arch, mesh):
    """``prefill_step`` and three ``serve_step``s from the placed params,
    each rank on its rows and (on 1 x 2) its query and KV heads: the
    logits of every rank's rows against the reference's."""
    _, res = runs
    got = res[(_case_id((arch, 1)), mesh)]
    want = _reference_serving(arch)
    heads = _cfg(arch).num_kv_heads // int(mesh.split("x")[1])
    assert got["kv_heads"] == heads
    g = got["serve"].numpy()
    assert g.shape == want.shape
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


_ONE_RANK = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config, get_shape, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.roofline.analysis import terms_from_program
from repro_torch.sharding import rules

mesh = make_local_mesh(device="cpu")
cfg = reduced(get_config("openvla-7b"), layers=2, d_model=64)
shape = dataclasses.replace(get_shape("train_4k"), global_batch=4,
                            seq_len=24)
out = {}
for placed in (False, True):
    _, structs, sspec, _ = steps.train_specs(cfg, shape, mesh, accum=2)
    state = train.init_state(cfg, mesh, sspec, "cpu")
    if placed:
        # DTensors on the one-rank mesh, as a larger mesh would place them
        state = state._replace(
            params=rules.place_tree(state.params, mesh,
                                    rules.spec_tree(sspec.params)),
            opt=state.opt._replace(
                mu=rules.place_tree(state.opt.mu, mesh,
                                    rules.spec_tree(sspec.opt.mu)),
                nu=rules.place_tree(state.opt.nu, mesh,
                                    rules.spec_tree(sspec.opt.nu))))
    batch = train.synthetic_batch(cfg, structs, "cpu")
    t = terms_from_program(steps.seq_train_step, state, batch, cfg=cfg,
                           rl=RLConfig(), accum=2,
                           grad_shardings=sspec.params)
    params = state.params
    toks = torch.zeros((2, 12), dtype=torch.int32)
    prefix = torch.zeros((2, cfg.num_prefix_tokens, 1024))
    with torch.no_grad():
        p = terms_from_program(steps.prefill_step, params, toks, prefix,
                               cfg=cfg, window=None, cache_len=16)
        _, cache = steps.prefill_step(params, toks, prefix, cfg=cfg,
                                      window=None, cache_len=16)
        d = terms_from_program(steps.serve_step, params, toks[:, 0], cache,
                               cfg=cfg, window=None)
    out[str(placed)] = [t["counts"], p["counts"], d["counts"]]
print(json.dumps(out))
"""


def test_one_rank_mesh_issues_no_collective():
    """On the one-rank mesh (``make_local_mesh``, a gloo group of one in a
    subprocess) the train, prefill and decode programs record no c10d
    collective: with the state as ``train.init_state`` leaves it (plain
    tensors) and placed as DTensors on that mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ONE_RANK], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) == {"False", "True"}
    for counts in out.values():
        for c in counts:
            assert c and not any(c.values()), counts
