"""Multi-pod dry-run driver, as in the reference ``repro/launch/dryrun.py``.

For every (architecture × input shape × mesh): run the port's step
program with the production placements on a FAKE process group of 256
ranks (512 with ``--multi-pod``; ``FakeStore``, backend ``"fake"``: its
collectives move nothing) over trees on ``meta`` (no memory, no
arithmetic), and record its memory fit, its roofline terms and its
collectives. Host-only: it needs no card, and each (arch × shape × mesh)
runs in a process of its own (the group is process-global; none starts
at import).

The reference lowers and compiles with XLA and reads ``memory_analysis()``
and ``cost_analysis()``. The port measures the program it runs instead:

  * **fit**: the production program's peak from
    ``torch.distributed._tools.mem_tracker.MemTracker`` (what the program
    allocates: gathered parameters, activations, grads, the emitted cache)
    plus the exact per-device bytes of the placed state it is given
    (``_sharded_bytes``);
  * **cost**: ``roofline.analysis.terms_from_program`` (FLOPs by
    ``FlopCounterMode``, each op's bytes, the c10d collectives) on a
    1-unit and a 2-unit layer-delta surrogate (``_layer_units``), scaled
    to the full depth and, for trains, by ``accum`` (one micro-batch is
    measured, as the reference measures one).

The records keep the reference's keys. The program is the split one of
``sharding/spmd.py``: each rank takes its rows of the batch (``spmd.rows``,
where ``spmd.splits`` puts the batch on the data axes), every block whose
leaves sit on their split axes runs on the rank's shards over ``model``
(attention on query heads, the MLP on ``d_ff``, MoE on experts, Mamba2 on
heads, the embedding on vocab), the leaves used whole inside a split block
have their grads summed over ``model``, and every other leaf is gathered
whole. The ``program`` field says, per arch and shape, what ran
(``spmd.program``): the split, the tensor-parallel blocks, the summed and
the gathered leaves; attention, the SSD scan and the loss are counted on
their plain PyTorch versions (the card runs K1–K4, K6 and K7 on the same
products). The dry run does not estimate what the port does not run.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json;
cached pairs are skipped (--force recomputes). ``--table`` prints the
saved records beside the reference's deepseek-7b x train_4k record
(``experiments/dryrun/<mesh>/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_shape)
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, num_chips
from repro_torch.roofline.analysis import (
    combine_layer_delta,
    roofline_from_terms,
    terms_from_program,
)
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import FSDP_PARAM_THRESHOLD
from repro_torch.tree import tree_map_with_path

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"
DEVICE_BYTES = 80e9                    # one NVIDIA H100 80GB

def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (rank 0),
    started once: placements and collectives with no peers."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is running; this mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _sharded_bytes(structs, shardings) -> float:
    """Exact per-device bytes of a tree under its NamedShardings."""
    total = [0.0]

    def add(_, t, sh):
        sizes = rules.mesh_shape(sh.mesh)
        div = 1
        for ax in sh.spec:
            for a in rules._names(ax):
                div *= sizes[a]
        total[0] += t.numel() * t.element_size() / div
    tree_map_with_path(add, structs, shardings)
    return float(total[0])


def _tree_bytes(tree) -> float:
    total = [0.0]

    def add(_, t):
        total[0] += t.numel() * t.element_size()
    tree_map_with_path(add, tree)
    return total[0]


def _layer_units(cfg: ModelConfig) -> Tuple[int, float]:
    """(layers per delta-unit, number of units incl. fractional remainder).

    Hybrids repeat in macro groups of ``shared_every`` Mamba2 layers behind
    one shared-attention application, so the unit is one macro group."""
    if cfg.arch_type == "hybrid":
        g = cfg.hybrid.shared_every
        n_macro, rem = divmod(cfg.num_layers, g)
        return g, n_macro + (rem / g if rem else 0.0)
    return 1, float(cfg.num_layers)


def _surrogate(cfg: ModelConfig, n_units: int, unit: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=n_units * unit)


# --- §Perf hillclimb variants (the reference's, toggle for toggle) ----------
VARIANTS = {
    "baseline": {},
    "attn_dshard": {"attn_prefer_dmodel": True},
    "split_inproj": {"split_inproj": True},
    "uniform_decode": {"uniform_decode": True},
    "uniform+dshard": {"uniform_decode": True, "attn_prefer_dmodel": True},
    "pad_heads": {"pad_heads": 32},
    "pure_dp": {"pure_dp": True, "zero2_grads": True},
    "pure_dp_chunk64": {"pure_dp": True, "zero2_grads": True, "chunk": 64},
    "zero2_grads": {"zero2_grads": True},
    "fsdp_model": {"fsdp_model": True, "zero2_grads": True,
                   "split_inproj": True},
    "pure_dp_zero3": {"pure_dp": True, "zero2_grads": True,
                      "zero3_axis": "data"},
    "cache_seqshard": {"cache_seqshard": True, "uniform_decode": True},
}


def _variant_cfg(cfg: ModelConfig, opts) -> ModelConfig:
    if opts.get("split_inproj") and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, fused_in_proj=False))
    if opts.get("pad_heads"):
        hp = opts["pad_heads"]
        cfg = dataclasses.replace(
            cfg, num_heads=hp,
            num_kv_heads=hp if cfg.num_kv_heads == cfg.num_heads
            else cfg.num_kv_heads,
            head_dim_override=cfg.head_dim)
    if opts.get("chunk") and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=opts["chunk"]))
    return cfg


def _place(tree, shardings, mesh):
    return rules.place_tree(tree, mesh, rules.spec_tree(shardings))


def _peak_bytes(fn, *args) -> float:
    """The most memory ``fn(*args)`` holds at once on any device, by
    ``MemTracker`` (the tensors it allocates; its inputs are not
    counted)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    tracker = MemTracker()
    with tracker:
        fn(*args)
    peak = tracker.get_tracker_snapshot("peak")
    return float(max((snap["Total"] for snap in peak.values()), default=0))


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              rl: Optional[RLConfig] = None, variant: str = "baseline",
              cfg: Optional[ModelConfig] = None) -> Dict:
    """Run one (arch, shape, mesh) on the fake group (started here, in
    this process, if none is running) and return its record. ``cfg``
    replaces ``get_config(arch)`` (a reduced config, for tests)."""
    opts = VARIANTS[variant]
    cfg = _variant_cfg(cfg or get_config(arch), opts)
    pure_dp = bool(opts.get("pure_dp"))
    zero3_axis = opts.get("zero3_axis")
    fsdp_model = bool(opts.get("fsdp_model"))
    zero2_grads = bool(opts.get("zero2_grads"))
    cache_seqshard = bool(opts.get("cache_seqshard"))
    uniform_decode = bool(opts.get("uniform_decode"))
    rules.ATTN_PREFER_DMODEL = bool(opts.get("attn_prefer_dmodel"))
    shape = get_shape(shape_name)
    rl = rl or RLConfig()
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = num_chips(mesh)
    fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
    extra: Dict = {}

    row_tokens = shape.seq_len + cfg.num_prefix_tokens

    def build_train(c: ModelConfig, accum: int, surrogate: bool):
        # surrogate cost programs run ONE micro-batch (scaled by ``accum``
        # afterwards); the production program runs the full window. Each
        # rank is given its rows of every micro-batch.
        eff_shape = dataclasses.replace(
            shape, global_batch=shape.global_batch // max(accum, 1)) \
            if surrogate else shape
        use_accum = 1 if surrogate else accum
        state, batch, sspec, _ = steps.train_specs(
            c, eff_shape, mesh, accum=use_accum, fsdp=fsdp, pure_dp=pure_dp,
            fsdp_model=fsdp_model, zero3_axis=zero3_axis)
        placed = state._replace(
            params=_place(state.params, sspec.params, mesh),
            opt=state.opt._replace(
                mu=_place(state.opt.mu, sspec.opt.mu, mesh),
                nu=_place(state.opt.nu, sspec.opt.nu, mesh)))
        split = spmd.splits(c, mesh, eff_shape.global_batch // use_accum,
                            row_tokens)
        batch = spmd.rows(batch, mesh, dim=1 if use_accum > 1 else 0,
                          split=split)
        fn = functools.partial(
            steps.seq_train_step, cfg=c, rl=rl, accum=use_accum,
            grad_shardings=sspec.opt.mu if zero2_grads else sspec.params,
            data_split=split)
        held = _sharded_bytes(state, sspec) + _tree_bytes(batch)
        if not surrogate:
            extra["param_bytes_per_dev"] = _sharded_bytes(state.params,
                                                          sspec.params)
            extra["moment_bytes_per_dev"] = (
                _sharded_bytes(state.opt.mu, sspec.opt.mu)
                + _sharded_bytes(state.opt.nu, sspec.opt.nu))
        desc = spmd.program(c, spmd.layout(c, placed.params), placed.params,
                            "train", split)
        return fn, (placed, batch), held, desc

    def build_prefill(c: ModelConfig, surrogate: bool):
        sp = steps.prefill_specs(c, shape, mesh, fsdp=fsdp)
        sh = sp["shardings"]
        split = spmd.splits(c, mesh, shape.global_batch, row_tokens)
        fn = functools.partial(steps.prefill_step, cfg=c,
                               window=sp["window"],
                               cache_len=sp["cache_len"], data_split=split)
        params = _place(sp["params"], sh["params"], mesh)
        tokens = spmd.rows(sp["tokens"], mesh, split=split)
        prefix = spmd.rows(sp["prefix"], mesh, split=split)
        held = _sharded_bytes(sp["params"], sh["params"]) + _tree_bytes(
            {"t": tokens, **({"p": prefix} if prefix is not None else {})})
        desc = spmd.program(c, spmd.layout(c, params), params, "prefill",
                            split)
        return fn, (params, tokens, prefix), held, desc

    def build_serve(c: ModelConfig, surrogate: bool):
        sp = steps.serve_specs(c, shape, mesh, fsdp=fsdp,
                               seq_shard=cache_seqshard)
        sh = sp["shardings"]
        split = spmd.splits(c, mesh, shape.global_batch, 1)
        fn = functools.partial(steps.serve_step, cfg=c, window=sp["window"],
                               uniform=uniform_decode, data_split=split)
        params = _place(sp["params"], sh["params"], mesh)
        lay = spmd.layout(c, params)
        token = spmd.rows(sp["token"], mesh, split=split)
        cache = spmd.local_cache(sp["cache"], lay, split=split)
        held = (_sharded_bytes(sp["params"], sh["params"])
                + _tree_bytes(cache) + _tree_bytes({"t": token}))
        desc = spmd.program(c, lay, params, "decode", split)
        return fn, (params, token, cache), held, desc

    from repro_torch.kernels import dispatch
    t0 = time.time()
    with dispatch.forced("torch"), torch.no_grad():
        accum = steps.choose_accum(cfg, shape, mesh, pure_dp=pure_dp) \
            if shape.kind == "train" else 1
        build = {"train": lambda c, s: build_train(c, accum, s),
                 "prefill": build_prefill,
                 "decode": build_serve}[shape.kind]

        # --- (a) production program: the memory-fit proof ---------------
        fn, args, held, program = build(cfg, False)
        t_lower = time.time() - t0
        peak = _peak_bytes(fn, *args)
        t_compile = time.time() - t0 - t_lower
        del fn, args

        # --- (b) roofline cost via layer-delta surrogates ----------------
        t1 = time.time()
        unit, n_units = _layer_units(cfg)
        t_one = terms_from_program(*_call(build(_surrogate(cfg, 1, unit),
                                                True)))
        t_two = terms_from_program(*_call(build(_surrogate(cfg, 2, unit),
                                                True)))
    rules.ATTN_PREFER_DMODEL = False   # reset the toggle
    cost_terms = combine_layer_delta(t_one, t_two, n_units)
    extra["cost_compile_s"] = round(time.time() - t1, 2)
    if shape.kind == "train":
        extra["accum"] = accum
    terms = roofline_from_terms(cost_terms, cfg, shape, chips, scale=accum)

    if shape.kind in ("prefill", "decode"):
        # exact resident state (params + cache) under the specs: what a
        # placed state would hold a device
        builder = (steps.prefill_specs if shape.kind == "prefill"
                   else steps.serve_specs)
        sp2 = builder(cfg, shape, mesh, fsdp=fsdp)
        extra["state_bytes_per_dev"] = (
            _sharded_bytes(sp2["params"], sp2["shardings"]["params"])
            + _sharded_bytes(sp2["cache"], sp2["shardings"]["cache"]))

    mem = {"generated_code_size_in_bytes": 0.0,
           "argument_size_in_bytes": held,
           "output_size_in_bytes": 0.0,     # in place, or inside the peak
           "alias_size_in_bytes": 0.0,
           "temp_size_in_bytes": peak}
    mem["total_hbm_bytes"] = held + peak
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": shape.kind, "fsdp": fsdp,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": mem,
        "roofline": terms.as_dict(),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        **extra,
        "fits": mem["total_hbm_bytes"] <= DEVICE_BYTES,
        "program": program,
    }


def _call(built):
    fn, args, *_ = built
    return (fn,) + tuple(args)


def lower_isolated(arch: str, shape_name: str, *, multi_pod: bool = False,
                   variant: str = "baseline") -> Dict:
    """``lower_one`` in a process of its own (the fake group is
    process-global); the record, or a RuntimeError with the child's
    error."""
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--one",
           "--arch", arch, "--shape", shape_name, "--variant", variant]
    if multi_pod:
        cmd.append("--multi-pod")
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(ROOT))
    if res.returncode:
        raise RuntimeError(f"dry run of {arch} × {shape_name} failed:\n"
                           + res.stderr[-4000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def run_and_save(arch: str, shape_name: str, *, multi_pod: bool,
                 force: bool = False, variant: str = "baseline") -> Dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    out_dir = OUT_DIR / mesh_tag
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    path = out_dir / f"{arch}__{shape_name}{suffix}.json"
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if "error" not in rec:
            print(f"[skip] {arch} × {shape_name} ({mesh_tag}) — cached")
            return rec
    print(f"[dryrun] {arch} × {shape_name} ({mesh_tag}) ...", flush=True)
    try:
        rec = lower_isolated(arch, shape_name, multi_pod=multi_pod,
                             variant=variant)
    except Exception as e:  # noqa: BLE001 — record it, keep sweeping
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "variant": variant, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        path.write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {arch} × {shape_name}: {e}")
        return rec
    path.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"  ok: run {rec['compile_s']}s+{rec['cost_compile_s']}s | "
          f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
          f"collective {r['collective_s']:.3e}s -> {r['dominant']}-bound | "
          f"useful {r['useful_ratio']:.2f} | "
          f"hbm/dev {rec['memory']['total_hbm_bytes'] / 2**30:.2f} GiB")
    return rec


def table(multi_pod: bool = False) -> None:
    """The saved records of a mesh, one line each, beside the reference's
    deepseek-7b x train_4k record: fit, bytes and FLOPs a device, the
    useful ratio, collective bytes by kind."""
    tag = "2x16x16" if multi_pod else "16x16"
    ref_path = ROOT / "experiments" / "dryrun" / tag / \
        "deepseek-7b__train_4k.json"
    recs = [("reference deepseek-7b__train_4k",
             json.loads(ref_path.read_text()))]
    recs += [(p.stem, json.loads(p.read_text()))
             for p in sorted((OUT_DIR / tag).glob("*.json"))]
    ref_flops = recs[0][1]["roofline"]["flops"]
    print(f"{'record (' + tag + ')':44s} {'fits':>5s} {'GB/dev':>8s} "
          f"{'FLOPs/dev':>10s} {'x ref':>6s} {'useful':>7s} "
          f"{'all-gather GB':>13s} {'all-reduce GB':>13s} {'other GB':>8s}")
    for name, r in recs:
        if "error" in r:
            print(f"{name:44s} error: {r['error'][:60]}")
            continue
        rf, mem = r["roofline"], r["memory"]
        coll = rf["coll_by_kind"]
        other = sum(v for k, v in coll.items()
                    if k not in ("all-gather", "all-reduce", "counts"))
        fits = r.get("fits", mem["total_hbm_bytes"] <= DEVICE_BYTES)
        print(f"{name:44s} {str(fits):>5s} "
              f"{mem['total_hbm_bytes'] / 1e9:8.2f} {rf['flops']:10.4e} "
              f"{rf['flops'] / ref_flops:6.3f} {rf['useful_ratio']:7.4f} "
              f"{coll['all-gather'] / 1e9:13.2f} "
              f"{coll['all-reduce'] / 1e9:13.2f} {other / 1e9:8.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["openvla-7b"])
    ap.add_argument("--shape", choices=[s.name for s in INPUT_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--table", action="store_true",
                    help="print the saved records beside the reference's "
                         "deepseek-7b x train_4k record")
    ap.add_argument("--one", action="store_true",
                    help="run one pair in this process and print its record "
                         "as JSON on the last line (no file)")
    args = ap.parse_args(argv)

    if args.table:
        table(args.multi_pod)
        return
    if args.one:
        print(json.dumps(lower_one(args.arch, args.shape,
                                   multi_pod=args.multi_pod,
                                   variant=args.variant)))
        return
    if args.all:
        pairs = [(a, s.name) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in pairs:
        rec = run_and_save(arch, shape, multi_pod=args.multi_pod,
                           force=args.force, variant=args.variant)
        failures += "error" in rec
    print(f"\n{len(pairs) - failures}/{len(pairs)} ran OK")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
