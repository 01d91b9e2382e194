"""Production serving launcher: prefill + decode against the placed
KV/state cache, as in the reference ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --tokens 16 --local

Runs on the card unless ``--device cpu``. ``--local`` reduces the config
and runs on the local one-rank mesh; without it the production mesh needs
a process group of 256 ranks (512 with ``--multi-pod``) started first.
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
from repro_torch.sharding import rules


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
    cache = transformer.init_decode_cache(cfg, shape.global_batch, cache_len,
                                          window=window, device=dev)
    if num_chips(mesh) > 1:
        # the params placed under their specs; decode reads the full value
        # of each (no tensor parallelism in the port), and the cache stays
        # whole on every rank (the port splits no batch). On one device
        # placement is a no-op.
        params = rules.full_tree(rules.place_tree(
            params, mesh, rules.spec_tree(sh["params"])))
    token = torch.zeros((shape.global_batch,), dtype=torch.int32,
                        device=dev)
    with torch.no_grad():
        for i in range(args.tokens):
            t0 = time.perf_counter()
            logits, cache = steps.serve_step(params, token, cache, cfg=cfg,
                                             window=window)
            token = torch.argmax(logits, -1).to(torch.int32)
            first = int(token[0])              # waits for the step
            print(f"decode {i}: token[0]={first} "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")



if __name__ == "__main__":
    main()
