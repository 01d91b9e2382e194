#!/usr/bin/env python3
"""granite-moe-1b-a400m's f32 no-drop system run at full depth, several
times, each with its step-1 replay and the replay's closest router gap.

    python3 scripts/moe_replay_gaps.py [--runs 3] [--layers 24]

Run from the root of a checkout on a machine with an H100. Each run is
``chip_smoke.py``'s system phase on the f32 copy of granite-moe-1b-a400m
at capacity factor E/k (no assignment drops; ``MOE_NO_DROPS``): 3 steps
of ``run_async``, then step 1 replayed on the plain route from the
published v0 snapshot, with the KL of v0 against the served μ held to
``REPLAY_KL_BOUND``. The replay's line also carries the smallest gap
between a token's k-th and (k+1)-th router logit over every MoE call of
the replay, and how many gaps fall under 1e-5: a near-tie there lets the
serving and training routes choose different experts for one token.
Prints each run's verdict and goes on; exits 1 if any run failed. The
first line is the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_replay_gaps: CUDA is not available", file=sys.stderr)
        return 1
    import argparse
    import chip_smoke as cs
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--layers", type=int, default=24)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, smi = cs.phase_device()
    print(smi, flush=True)
    wrappers = {"flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_policy_loss_fwd": gl.policy_loss_fwd,
                "fused_policy_loss_bwd": gl.policy_loss_bwd,
                "gipo_head_loss_fwd": gl.gipo_head_fwd,
                "gipo_head_loss_bwd": gl.gipo_head_bwd,
                "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
                "ssd_scan tensor-core body": ssd_scan.tc,
                "fused_policy_loss_fwd tensor-core body":
                    gl.policy_loss_fwd.tc,
                "fused_policy_loss_bwd tensor-core body":
                    gl.policy_loss_bwd.tc}
    failed = 0
    for i in range(args.runs):
        t0 = time.perf_counter()
        try:
            cs.phase_system(
                dev, smi, {k: (fn, 0) for k, fn in wrappers.items()},
                arch=cs.MOE_ARCH, n_layers=args.layers, sync=False,
                checks=cs.MOE_NO_DROPS,
                edit=lambda c: cs._f32_copy(c, drops=False),
                note=f", f32 copy without drops, {args.layers} layers, "
                     f"run {i}")
            verdict = "passed"
        except AssertionError:
            failed += 1
            verdict = "FAILED: " + traceback.format_exc(limit=1)[-600:]
        print(f"[moe gaps] run {i} at {args.layers} layers {verdict} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    print(f"[moe gaps] {args.runs - failed} of {args.runs} runs passed | "
          f"{smi}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
