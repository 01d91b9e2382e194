#!/usr/bin/env python3
"""Time K4, the fused action head + GIPO loss, on the card at the main
paths' shapes, beside its plain version and the unfused route.

    python3 scripts/time_policy_loss.py [--tree DIR]

Run from the root of a checkout on a machine with an H100. ``--tree``
times the ``repro_torch`` of another checkout (an older commit unpacked
beside this one) with this script's cases and clock, so that two trees
compare within one call. For N 224 token rows (the train step's
micro-batch) at d 4096, 2560 and 2048 (openvla-7b, mamba2-2.7b,
zamba2-1.2b) and 6144 (the widest configs, e.g. starcoder2-15b), and N
3584 at d 4096, Va 256, bf16, live behaviour
log-probs: the forward and the backward are first held against the plain
version (as ``chip_smoke.py`` holds them), then timed as ``chip_smoke.py``
times kernels (median of CUDA events, L2 flushed before each call), with
the plain version and the unfused route a user would otherwise write
(cuBLAS's product to bf16 logits and K5; backward: the product, K5's
backward and the two products of dh and dw): ``chip_smoke._time_policy``
prints one line a case and pass, with the body the tree's K4 took. The
first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = [(224, 4096), (224, 2560), (224, 2048), (224, 6144), (3584, 4096)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_policy_loss: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import gipo_loss as gl
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"[tree] {args.tree.resolve()}: repro_torch from "
          f"{pathlib.Path(gl.__file__).resolve()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, d in CASES:
        c = cs._policy_case(gen, dev, n, d, 256, torch.bfloat16)
        rows = [c[x] for x in ("h", "w", "tg", "lo", "ad", "mk")]
        got = gl._finalize(gl.policy_loss_fwd(*rows, 0.2).sum(0))
        exp = gl._finalize(gl._plain_policy_loss_fwd(*rows, 0.2).sum(0))
        ferr = max(abs(x.item() - y.item()) / max(abs(y.item()), 1.0)
                   for x, y in zip(list(got[:3]) + list(got[3].values()),
                                   list(exp[:3]) + list(exp[3].values())))
        if not ferr <= cs.F32_MAX_ERR:
            raise AssertionError(f"N={n} d={d}: forward rel err {ferr}")
        res = [cs._check_grad(f"N={n} d={d} {nm}", x, y, torch.bfloat16)
               for nm, x, y in zip(
                   ("dh", "dw"),
                   gl.policy_loss_bwd(*rows, 0.2, c["coefs"]),
                   gl._plain_policy_loss_bwd(*rows, 0.2, c["coefs"]))]
        print(f"[check] N={n} d={d}: forward rel err {ferr:.3e} | dh, dw "
              f"beyond one bf16 ulp, of the largest value "
              f"{max(r[1] for r in res):.3e}")
        cs._time_policy(c, l2.zero_)      # prints a line a pass
        del c, rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
