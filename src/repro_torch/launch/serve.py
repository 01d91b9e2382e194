"""Production serving launcher: prefill + decode against the placed
KV/state cache, as in the reference ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --tokens 16 --local

Runs on the card unless ``--device cpu``. ``--local`` reduces the config
and runs on the local one-rank mesh; without it the production mesh needs
a process group of 256 ranks (512 with ``--multi-pod``) started first,
and each rank decodes its rows against its part of the cache
(``sharding.spmd``: its rows, and where a block is split over ``model``
its region of that block's cache: KV heads or their ``head_dim`` slices,
Mamba2 heads, a chunk of the conv tail's channels).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shape, reduced
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     num_chips)
from repro_torch.sharding import rules, spmd
from repro_torch.tree import tree_map_with_path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", default="decode_32k",
                    choices=("decode_32k", "long_500k"))
    ap.add_argument("--tokens", type=int, default=8,
                    help="tokens to decode")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def configure(args):
    """(cfg, shape) the flags select: ``--local`` reduces both, as the
    reference does."""
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    if args.local:
        cfg = reduced(cfg, layers=2, d_model=128)
        shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
    return cfg, shape


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, shape = configure(args)
    mesh = (make_local_mesh(dev) if args.local
            else make_production_mesh(multi_pod=args.multi_pod, device=dev))

    window = steps.long_context_window(cfg, shape)
    cache_len = steps.effective_cache_len(cfg, shape)
    print(f"arch {cfg.name} | cache_len {cache_len} | "
          f"window {window} | batch {shape.global_batch}")

    sp = steps.serve_specs(cfg, shape, mesh)
    sh = sp["shardings"]
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    batch, split = shape.global_batch, True
    if num_chips(mesh) > 1:
        # the params placed under their specs; each rank its rows and its
        # part of the cache (built on ``meta``, then made on the device).
        # On one device placement is a no-op.
        params = rules.place_tree(params, mesh, rules.spec_tree(sh["params"]))
        split = spmd.splits(cfg, mesh, batch, 1)
        whole = transformer.init_decode_cache(cfg, batch, cache_len,
                                              window=window, device="meta")
        cache = tree_map_with_path(
            lambda path, x: torch.full(
                x.shape, -1 if path[-1] == "positions" else 0,
                dtype=x.dtype, device=dev),
            spmd.local_cache(whole, spmd.layout(cfg, params), split=split))
        batch = (cache.attn or cache.ssm).length.shape[1]   # its rows
    else:
        cache = transformer.init_decode_cache(cfg, batch, cache_len,
                                              window=window, device=dev)
    token = torch.zeros((batch,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for i in range(args.tokens):
            t0 = time.perf_counter()
            logits, cache = steps.serve_step(params, token, cache, cfg=cfg,
                                             window=window, data_split=split)
            token = torch.argmax(logits, -1).to(torch.int32)
            first = int(token[0])              # waits for the step
            print(f"decode {i}: token[0]={first} "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")



if __name__ == "__main__":
    main()
