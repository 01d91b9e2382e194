"""The roofline and the dry run (``repro_torch.roofline.analysis``,
``repro_torch.launch.dryrun``) against the JAX package, on the CPU.

  * The roofline's arithmetic (``model_flops`` for every arch x shape,
    ``combine_layer_delta``, ``roofline_from_terms`` with the reference's
    constants, ``collective_bytes`` on a record against the reference's
    parse of the same collectives in HLO text) equals the reference's.
  * ``terms_from_program``: the FLOPs of a reduced dense prefill step equal
    the analytic count of its products; the layer-delta extrapolation from
    1 and 2 layers equals the 4-layer program's count (FLOPs and bytes).
  * ``lower_one`` on reduced configs on a fake group of 256 ranks (a
    subprocess: the group is process-global) returns the reference's record
    keys (those of ``experiments/dryrun/16x16/deepseek-7b__train_4k.json``
    for a train, and the reference's ``state_bytes_per_dev`` for a decode),
    the placed state's bytes, and the collectives the placed step issues
    (all-gather and all-reduce only). The split program: each rank's FLOPs
    against the whole program's (the same step on one device, the global
    batch, counted in the same subprocess): within 10% of its 1/256 where
    heads, ``d_ff`` and vocab divide 16 (reduced deepseek-7b at 16 heads,
    d 256, 4 layers: every block split over model), and between its 1/256
    and its 1/16 at the reduced configs' 4 heads, where attention is
    gathered whole on every model rank. A reduced mamba2-2.7b (16 SSD
    heads, ``in_proj`` and the conv dividing 16) and a reduced
    granite-moe-1b-a400m (16 experts, 16 query heads over 8 KV heads):
    every block split over model (Mamba2 on heads, MoE on experts,
    attention on query heads with ``wk``/``wv`` used whole and their
    grads summed), no expert, ``out_proj`` or ``norm_scale`` leaf
    gathered, each rank's FLOPs between the whole program's 1/256 and
    1/16.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.configs as jconfigs
from repro.launch import mesh as jmesh
from repro.roofline import analysis as janalysis
import repro_torch.configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttransformer
from repro_torch.roofline import analysis as tanalysis

ROOT = pathlib.Path(__file__).resolve().parents[1]
TERMS = [
    {"flops": 3.0e12, "bytes": 2.0e11,
     "coll": {"all-gather": 1.0e9, "all-reduce": 4.0e8, "reduce-scatter": 0.0,
              "all-to-all": 0.0, "collective-permute": 2.0e6},
     "counts": {"all-gather": 10, "all-reduce": 3, "reduce-scatter": 0,
                "all-to-all": 0, "collective-permute": 1}},
    {"flops": 5.5e12, "bytes": 3.1e11,
     "coll": {"all-gather": 1.8e9, "all-reduce": 4.0e8, "reduce-scatter": 0.0,
              "all-to-all": 0.0, "collective-permute": 1.0e6},
     "counts": {"all-gather": 19, "all-reduce": 3, "reduce-scatter": 0,
                "all-to-all": 0, "collective-permute": 1}},
]


def test_model_flops_equal_reference():
    for arch in jconfigs.list_archs():
        for js, ts in zip(jconfigs.INPUT_SHAPES, tconfigs.INPUT_SHAPES):
            assert tanalysis.model_flops(tconfigs.get_config(arch), ts) == \
                janalysis.model_flops(jconfigs.get_config(arch), js)


@pytest.mark.parametrize("n_units", [1.0, 32.0, 6.5])
def test_combine_and_roofline_equal_reference(n_units, monkeypatch):
    want = janalysis.combine_layer_delta(*TERMS, n_units)
    got = tanalysis.combine_layer_delta(*TERMS, n_units)
    assert got == want
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(tanalysis, name, getattr(jmesh, name))
    for arch, shape in (("deepseek-7b", "train_4k"),
                        ("openvla-7b", "decode_32k")):
        w = janalysis.roofline_from_terms(
            want, jconfigs.get_config(arch), jconfigs.get_shape(shape), 256,
            scale=4)
        g = tanalysis.roofline_from_terms(
            got, tconfigs.get_config(arch), tconfigs.get_shape(shape), 256,
            scale=4)
        assert g.as_dict() == w.as_dict()


def test_roofline_uses_the_h100_constants():
    t = tanalysis.roofline_from_terms(TERMS[0], tconfigs.get_config(
        "deepseek-7b"), tconfigs.get_shape("train_4k"), 1)
    assert t.compute_s == TERMS[0]["flops"] / 989e12
    assert t.memory_s == TERMS[0]["bytes"] / 3.35e12
    assert t.collective_s == t.coll_bytes / 50e9


def test_collective_bytes_equal_reference_parse():
    record = [("all-gather", 100), ("all-reduce", 8), ("all-gather", 4),
              ("collective-permute", 12)]
    hlo = "\n".join([
        "%ag = f32[25]{0} all-gather(f32[5]{0} %p), dimensions={0}",
        "%ar = f32[2]{0} all-reduce(f32[2]{0} %q), to_apply=%add",
        "%ag2 = s8[4]{0} all-gather(s8[1]{0} %r), dimensions={0}",
        "%cp = s32[3]{0} collective-permute(s32[3]{0} %s)",
    ])
    assert tanalysis.collective_bytes(record) == \
        janalysis.collective_bytes(hlo)


def _prefill_terms(cfg, b, t):
    params = ttransformer.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens = torch.zeros((b, t), dtype=torch.int32)
    with torch.no_grad():
        return tanalysis.terms_from_program(
            tsteps.prefill_step, params, tokens, None, cfg=cfg, window=None,
            cache_len=t, block=None)


def test_program_flops_equal_the_analytic_count():
    """Reduced deepseek-7b (MHA, no prefix): per layer the q/k/v/o
    projections, the scores and the value product over all T x T pairs
    (the dense plain route), the SwiGLU's three products; then the head."""
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), layers=2,
                           d_model=64)
    b, t = 2, 40
    h, kv, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    per_layer = (2 * b * t * dm * d * (2 * h + 2 * kv)
                 + 2 * 2 * b * t * t * h * d
                 + 3 * 2 * b * t * dm * cfg.d_ff)
    want = cfg.num_layers * per_layer + 2 * b * t * dm * cfg.action_vocab_size
    terms = _prefill_terms(cfg, b, t)
    assert terms["flops"] == want
    assert terms["bytes"] > 0
    assert terms["counts"] == dict.fromkeys(tanalysis.COLLECTIVE_OPS, 0)


def test_layer_delta_equals_the_full_programs_count():
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), layers=4,
                           d_model=64)
    one, two, four = (_prefill_terms(dataclasses.replace(cfg, num_layers=n),
                                     2, 24) for n in (1, 2, 4))
    got = tanalysis.combine_layer_delta(one, two, 4.0)
    assert got["flops"] == four["flops"]
    assert got["bytes"] == four["bytes"]


_LOWER = r"""
import dataclasses, functools, json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import get_config, get_shape, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun, steps
from repro_torch.roofline.analysis import terms_from_program
from repro_torch.sharding.rules import AbstractMesh


def whole(cfg, shape):
    # the same step on one device over the global batch (plain meta trees)
    state, batch, _, _ = steps.train_specs(
        cfg, get_shape(shape), AbstractMesh((1, 1), ("data", "model")))
    fn = functools.partial(steps.seq_train_step, cfg=cfg, rl=RLConfig())
    with dispatch.forced("torch"), torch.no_grad():
        return terms_from_program(fn, state, batch)["flops"]


small = reduced(get_config("deepseek-7b"), layers=2, d_model=64)
tp = dataclasses.replace(reduced(get_config("deepseek-7b"), layers=4,
                                 d_model=256),
                         num_heads=16, num_kv_heads=16, head_dim_override=16)
# Mamba2 at d 256: 16 SSD heads of 32, in_proj's 1072 columns and the
# conv's 544 channels all divide 16
ssm = reduced(get_config("mamba2-2.7b"), layers=2, d_model=256)
# 16 experts top-2; 16 query heads over 8 KV heads (wk/wv on head_dim)
gm = reduced(get_config("granite-moe-1b-a400m"), layers=2, d_model=256)
moe = dataclasses.replace(
    gm, num_heads=16, num_kv_heads=8, head_dim_override=16,
    moe=dataclasses.replace(gm.moe, num_experts=16, capacity_factor=8.0))
out = {"train_4k": dryrun.lower_one("deepseek-7b", "train_4k", cfg=small),
       "ssm": dryrun.lower_one("mamba2-2.7b", "train_4k", cfg=ssm),
       "moe": dryrun.lower_one("granite-moe-1b-a400m", "train_4k", cfg=moe),
       "decode_32k": dryrun.lower_one(
           "openvla-7b", "decode_32k",
           cfg=reduced(get_config("openvla-7b"), layers=2, d_model=64)),
       "train_4k_tp": dryrun.lower_one("deepseek-7b", "train_4k", cfg=tp)}
out["whole"] = {"train_4k": whole(small, "train_4k"),
                "train_4k_tp": whole(tp, "train_4k"),
                "ssm": whole(ssm, "train_4k"), "moe": whole(moe, "train_4k")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    res = subprocess.run([sys.executable, "-c", _LOWER], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)},
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_lower_one_train_record_has_the_reference_keys(records):
    want = json.loads((ROOT / "experiments" / "dryrun" / "16x16" /
                       "deepseek-7b__train_4k.json").read_text())
    rec = records["train_4k"]
    assert set(want) <= set(rec)
    for key in ("memory", "roofline"):
        assert set(want[key]) == set(rec[key])
    assert set(want["roofline"]["coll_by_kind"]) == \
        set(rec["roofline"]["coll_by_kind"])
    assert (rec["mesh"], rec["chips"], rec["kind"], rec["accum"]) == \
        ("16x16", 256, "train", 1)
    # the placed state (params over model, moments also over data) and the
    # collectives of the placed step: the params gathered whole, the
    # updated slices all-gathered over data, the grad norm's all-reduces
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > rec["param_bytes_per_dev"] \
        + rec["moment_bytes_per_dev"] > 0
    assert mem["total_hbm_bytes"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"]
    counts = rec["roofline"]["coll_by_kind"]["counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert not any(counts[k] for k in ("reduce-scatter", "all-to-all",
                                       "collective-permute"))
    # the split program: the rank's rows; the MLP and the embedding split
    # over model, attention (4 heads on 16) gathered whole on every rank
    assert "the rank's rows" in rec["program"]
    assert "the MLP on d_ff" in rec["program"]
    assert "attention on heads" not in rec["program"]
    whole = records["whole"]["train_4k"]
    assert whole / 256 < rec["roofline"]["flops"] < whole / 16


def test_lower_one_tensor_parallel_record(records):
    """Heads, d_ff and vocab divide 16: every block split over model and the
    batch over data, each rank's FLOPs within 10% of the whole program's
    1/256 (the replicated heads and loss are the rest)."""
    rec = records["train_4k_tp"]
    assert rec["accum"] == 1 and rec["fits"]
    for part in ("attention on heads", "the MLP on d_ff",
                 "the embedding on vocab", "the rank's rows"):
        assert part in rec["program"], part
    flops = rec["roofline"]["flops"]
    want = records["whole"]["train_4k_tp"] / 256
    assert abs(flops - want) <= 0.1 * want, (flops, want)
    counts = rec["roofline"]["coll_by_kind"]["counts"]
    assert set(k for k, v in counts.items() if v) == {"all-gather",
                                                      "all-reduce"}


def test_lower_one_decode_record(records):
    rec = records["decode_32k"]
    assert rec["kind"] == "decode" and "accum" not in rec
    assert rec["state_bytes_per_dev"] > 0
    assert rec["roofline"]["model_flops"] == 2.0 * rec[
        "active_param_count"] * 128


@pytest.mark.parametrize("family", ["ssm", "moe"])
def test_lower_one_split_family_records(records, family):
    """A reduced mamba2-2.7b (16 SSD heads, ``in_proj`` and the conv
    dividing 16) and a reduced granite-moe-1b-a400m (16 experts top-2, 16
    query heads over 8 KV heads) on the fake 16 x 16 group: the Mamba2
    blocks split on heads, the MoE blocks on experts, attention on query
    heads with ``wk``/``wv`` used whole; no expert, ``out_proj`` or
    ``norm_scale`` leaf gathered. Each rank's FLOPs below the whole
    program's 1/16 (what a rank running every head and expert, split over
    data alone, would count) and above its 1/256."""
    rec = records[family]
    program = rec["program"]
    want = {"ssm": ["Mamba2 on heads", "the embedding on vocab"],
            "moe": ["MoE on experts", "attention on query heads",
                    "the embedding on vocab"]}[family]
    for part in want + ["the rank's rows"]:
        assert part in program, part
    assert "not split over model" not in program
    gathered = program.split("gathered whole before use: ")[1].split(";")[0]
    for leaf in ("moe/w_gate", "moe/w_up", "moe/w_down", "ssm/out_proj",
                 "ssm/norm_scale"):
        assert leaf not in gathered, (leaf, gathered)
    summed = {"ssm": "ssm/in_proj", "moe": "attn/wk"}[family]
    assert summed in program.split("summed over model once a step: ")[1]
    flops = rec["roofline"]["flops"]
    whole = records["whole"][family]
    assert whole / 256 < flops < whole / 16, (flops, whole)
    counts = rec["roofline"]["coll_by_kind"]["counts"]
    assert set(k for k, v in counts.items() if v) == {"all-gather",
                                                      "all-reduce"}
