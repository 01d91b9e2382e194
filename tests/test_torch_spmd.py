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
  * The other families split over model, on 1 x 2 and 2 x 2 with ``accum``
    1 and 2, held as the dense family is: reduced mamba2-2.7b (4 SSD heads,
    two a rank, K6/K7's plain versions on each rank's heads), zamba2-1.2b
    (its Mamba2 blocks so, its shared attention + MLP block on heads and
    ``d_ff``), granite-moe-1b-a400m (4 experts top-2, two a rank; at
    ``accum`` 2, 4 rows of T = 256 a micro-batch keep its two capacity
    groups) and granite-20b, whose MQA (4 query heads, 1 KV head) puts
    ``wk``/``wv`` on ``head_dim`` on a ``model`` of 2: each rank projects
    the one KV head from them whole. Reduced mamba2's fused ``in_proj`` has
    292 columns, 146 a rank, against the z | x boundary at 128 (its conv's
    160 channels, 80 a rank, against 64 x channels a rank plus B and C), so
    a rank's shards do not hold its heads' columns: the misaligned leaves
    are gathered whole and the rank takes its columns of them. Prefill and
    three decodes of each on 1 x 2 against the reference's, the cache
    holding the rank's region as ``rules.cache_specs`` places it. Reduced
    mamba2 with its ``in_proj`` unfused (``in_proj_z`` / ``in_proj_x`` /
    ``in_proj_dt``, the layout the reference's rules also place) runs the
    same on 1 x 2 at ``accum`` 1: ``in_proj_x``'s 160 columns, 80 a rank,
    against 64 x columns a rank plus B and C.
  * The gradient rule for leaves used whole inside a split block (summed
    over model once a step): on 1 x 2 the router's, mamba2's ``in_proj``
    B/C columns, ``A_log``, granite-20b's ``wk`` on ``head_dim`` and the
    block norm's scale against the one-rank program's, and the global grad
    norm (a part summed twice, or not at all, is off by a whole part).
  * A one-rank mesh issues no collective in any step program (the c10d
    record of ``roofline.analysis.terms_from_program``), for every family.
"""
import dataclasses
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
SPLIT = ("mamba2-2.7b", "zamba2-1.2b", "granite-moe-1b-a400m", "granite-20b")
UNFUSED = "mamba2-2.7b+unfused"     # its Mamba2 in_proj as three leaves
_SEQ = {"mamba2-2.7b": (64, 64), "zamba2-1.2b": (64, 64),
        "granite-moe-1b-a400m": (128, 256), "granite-20b": (40, 40)}
CASES = [(a, acc, 40, ("2x1", "1x2", "2x2")) for a in DENSE
         for acc in (1, 2)] + [
    ("mamba2-2.7b", 1, 64, ("2x1", "1x2", "2x2")),
    ("granite-moe-1b-a400m", 1, 128, ("2x1", "1x2", "2x2")),
] + [(a, acc, _SEQ[a][acc - 1], ("1x2", "2x2")) for acc in (1, 2)
     for a in SPLIT if (a, acc) not in (("mamba2-2.7b", 1),
                                        ("granite-moe-1b-a400m", 1))] + [
    (UNFUSED, 1, 64, ("1x2",))]
# the block kinds split over a model axis of 2
WANT_TP = {"mamba2-2.7b": ["ssm", "vocab"], UNFUSED: ["ssm", "vocab"],
           "zamba2-1.2b": ["attn", "mlp", "ssm", "vocab"],
           "granite-moe-1b-a400m": ["attn", "moe", "vocab"],
           "granite-20b": ["attn", "mlp", "vocab"],
           **{a: ["attn", "mlp", "vocab"] for a in DENSE}}
# the gradient rule's leaves (path, columns of the last axis or None)
RULE_LEAVES = {
    "mamba2-2.7b": [(("layers", "ssm", "in_proj"), (256, 288)),
                    (("layers", "ssm", "A_log"), None),
                    (("layers", "norm", "scale"), None)],
    "granite-moe-1b-a400m": [(("layers", "moe", "router"), None),
                             (("layers", "attn_norm", "scale"), None)],
    "granite-20b": [(("layers", "attn", "wk"), None),
                    (("layers", "attn", "wv"), None),
                    (("layers", "attn_norm", "scale"), None)],
}
SERVE_PROMPT, SERVE_DECODES, CACHE_LEN = 12, 3, 16


def _cfg(arch, pkg=tconfigs):
    """The reduced config of ``arch``; ``<arch>+unfused`` with its Mamba2
    ``in_proj`` as three leaves."""
    name, _, unfused = arch.partition("+")
    cfg = pkg.reduced(pkg.get_config(name), layers=2, d_model=64)
    if unfused:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, fused_in_proj=False))
    return cfg


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
from repro_torch.optim import adamw
from repro_torch.sharding import rules, spmd
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_map_with_path

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
        name, _, unfused = case["arch"].partition("+")
        cfg = reduced(get_config(name), layers=2, d_model=64)
        if unfused:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, fused_in_proj=False))
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
        rule = None
        if case.get("rule") and tag == "1x2":
            grads, _, _ = steps.seq_grads(state.params, rows, state.adv_norm,
                                          cfg=cfg, rl=rl, accum=accum)
            rule = dict(grads=whole(grads),
                        norm=float(adamw.global_norm(grads)),
                        summed=sorted(lay.summed))
        state, metrics = steps.seq_train_step(
            state, rows, cfg=cfg, rl=rl, accum=accum,
            grad_shardings=sspec.params)
        placements = {"/".join(p): [x.dim if x.is_shard() else None
                                    for x in v.placements]
                      for p, v in tree_leaves_with_path(state.params)}
        got = dict(metrics={k: float(v) for k, v in metrics.items()},
                   adv=[float(x) for x in state.adv_norm],
                   mu=whole(state.opt.mu), params=whole(state.params),
                   tp=lay.tensor_parallel(), placements=placements,
                   rule=rule)
        serve = case.get("serve")
        if serve is not None and tag in case["serve_meshes"]:
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
            shapes = {}
            tree_map_with_path(
                lambda p, x: shapes.__setitem__("/".join(p), tuple(x.shape)),
                cache)
            got["cache"] = shapes
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
        if accum == 1 and (arch in DENSE or "1x2" in meshes):
            case["serve"] = {k: torch.from_numpy(v) for k, v in
                             _serve_inputs(cfg).items()}
            case["serve_meshes"] = ("2x1", "1x2") if arch in DENSE \
                else ("1x2",)
        case["rule"] = accum == 1 and arch in RULE_LEAVES
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
        for arch in DENSE + SPLIT + (UNFUSED,):
            _reference_serving(arch)
        for arch in RULE_LEAVES:
            _one_rank_grads(arch)
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
    # copies: on the CPU jnp.asarray may alias the numpy views of ``tp``,
    # which the port's step below updates in place while the jitted
    # reference may still be running
    jp = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                      params_to_numpy(tp))
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
    one-rank step (1e-5 of each moment leaf's largest value). Where the
    mesh has a model axis every block of every family splits over it
    (``WANT_TP``): granite-20b's attention with ``wk``/``wv`` on
    ``head_dim``; on 2 x 1 the batch alone is split."""
    _, res = runs
    got = res[(_case_id((arch, accum)), mesh)]
    model = int(mesh.split("x")[1])
    assert got["tp"] == (WANT_TP[arch] if model > 1 else [])
    if arch == "granite-20b" and model > 1:
        # [L, d, KV, head_dim]: the one KV head does not split, head_dim
        # does (the mesh's model dim is its last)
        for leaf in ("wk", "wv"):
            assert got["placements"][f"layers/attn/{leaf}"][-1] == 3
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


def _hold_serving(got, arch):
    want = _reference_serving(arch)
    g = got["serve"].numpy()
    assert g.shape == want.shape
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("arch", DENSE)
def test_placed_prefill_and_decode_match_reference(runs, arch, mesh):
    """``prefill_step`` and three ``serve_step``s from the placed params,
    each rank on its rows and (on 1 x 2) its query and KV heads: the
    logits of every rank's rows against the reference's."""
    _, res = runs
    got = res[(_case_id((arch, 1)), mesh)]
    heads = _cfg(arch).num_kv_heads // int(mesh.split("x")[1])
    assert got["cache"]["attn/k"][3] == heads
    _hold_serving(got, arch)


@pytest.mark.parametrize("arch", SPLIT + (UNFUSED,))
def test_split_families_prefill_and_decode_match_reference(runs, arch):
    """The same on 1 x 2 for the families split over model: each rank's
    cache holds its region as ``rules.cache_specs`` places it (the Mamba2
    state's heads, a contiguous chunk of the conv tail's channels, the KV
    heads or, for granite-20b's one KV head, its ``head_dim`` slice)."""
    _, res = runs
    got = res[(_case_id((arch, 1)), "1x2")]
    cfg = _cfg(arch)
    cache = got["cache"]
    if cfg.ssm is not None:
        nh = cfg.ssm.num_heads(cfg.d_model)
        ch = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.state_dim
        assert cache["ssm/ssm"][2] == nh // 2
        assert cache["ssm/conv"][3] == ch // 2
    if cfg.num_heads:
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        want = (kv // 2, hd) if kv % 2 == 0 else (kv, hd // 2)
        assert cache["attn/k"][3:] == cache["attn/v"][3:] == want
    _hold_serving(got, arch)


@functools.lru_cache(maxsize=None)
def _one_rank_grads(arch):
    """The port's one-rank ``seq_grads`` (seed-0 params, the accum-1 batch)
    and their global norm."""
    cfg = _cfg(arch)
    tp = init_policy_params(cfg, 0, device="cpu")
    s = next(c[2] for c in CASES if c[0] == arch and c[1] == 1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, s).items()}
    grads, _, _ = tsteps.seq_grads(tp, batch, init_adv_state("cpu"),
                                   cfg=cfg, rl=RLConfig(**RL_KW))
    return _tflat(grads), float(adamw.global_norm(grads))


@pytest.mark.parametrize("arch", list(RULE_LEAVES))
def test_grads_of_leaves_used_whole_inside_a_split_block(runs, arch):
    """On 1 x 2 each rank back-propagates its own heads or experts only, so
    its gradient of a leaf used whole inside the block is a part, summed
    over model once a step (``Layout.summed``); a leaf read before the
    block's ``_Enter`` (the norm scale, the router) gives every rank the
    whole gradient and is not summed. Each leaf against the one-rank
    program's within 1e-5 of its largest value (a part summed twice, or
    not at all, is off by at least one whole rank's part), and the global
    grad norm within 1e-5."""
    _, res = runs
    rule = res[(_case_id((arch, 1)), "1x2")]["rule"]
    want, norm = _one_rank_grads(arch)
    got = _tflat(rule["grads"])
    summed = set(rule["summed"])
    for path, cols in RULE_LEAVES[arch]:
        key = "/".join(path)
        assert (key in summed) == (path[-1] not in ("scale", "router")), key
        g, w = got[path], want[path]
        if cols is not None:
            g, w = g[..., cols[0]:cols[1]], w[..., cols[0]:cols[1]]
        scale = float(np.abs(w).max())
        assert scale > 0, key
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, key
    assert abs(rule["norm"] - norm) <= 1e-5 * norm


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
shape = dataclasses.replace(get_shape("train_4k"), global_batch=4,
                            seq_len=24)
out = {}
for arch, placed in [(a, p) for a in sys.argv[1].split(",")
                     for p in (False, True)]:
    cfg = reduced(get_config(arch), layers=2, d_model=64)
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
    prefix = torch.zeros((2, cfg.num_prefix_tokens, 1024)) \
        if cfg.num_prefix_tokens else None
    with torch.no_grad():
        p = terms_from_program(steps.prefill_step, params, toks, prefix,
                               cfg=cfg, window=None, cache_len=16)
        _, cache = steps.prefill_step(params, toks, prefix, cfg=cfg,
                                      window=None, cache_len=16)
        d = terms_from_program(steps.serve_step, params, toks[:, 0], cache,
                               cfg=cfg, window=None)
    out[f"{arch} {placed}"] = [t["counts"], p["counts"], d["counts"]]
print(json.dumps(out))
"""


def test_one_rank_mesh_issues_no_collective():
    """On the one-rank mesh (``make_local_mesh``, a gloo group of one in a
    subprocess) the train, prefill and decode programs of every family
    (reduced openvla-7b, mamba2-2.7b, zamba2-1.2b, granite-moe-1b-a400m,
    granite-20b) record no c10d collective: with the state as
    ``train.init_state`` leaves it (plain tensors) and placed as DTensors
    on that mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    archs = ("openvla-7b",) + SPLIT
    res = subprocess.run([sys.executable, "-c", _ONE_RANK, ",".join(archs)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) == {f"{a} {p}" for a in archs for p in (False, True)}
    for counts in out.values():
        for c in counts:
            assert c and not any(c.values()), counts
