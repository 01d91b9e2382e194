#!/usr/bin/env python3
"""Time K6, the SSD scan forward, on the card at the SSD shapes of the main
paths, beside its FMA body where the tree has one to select.

    python3 scripts/time_ssd_fwd.py [--runs 25]

Run from the root of a checkout on a machine with an H100. For mamba2-2.7b
(H 80, P 64, N 128) and zamba2-1.2b (H 64, P 64, N 64), chunk 128, bf16:
serving B8 T256, training B36 T256 with entering states, the env's B8 T12
and B36 T19 (with states). Each case is first held against the plain
version (f32 outputs within 1e-4 of the largest value), then timed as
``chip_smoke.py`` times kernels (median of CUDA events, L2 flushed before
each call). A tree whose ``ssd_scan`` has no ``body`` argument (before the
tensor-core body) prints its one body. Prints one line a case and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = [(label, h, p, n, b, t, states)
         for label, h, p, n in (("mamba2", 80, 64, 128),
                                ("zamba2", 64, 64, 64))
         for b, t, states in ((8, 256, False), (36, 256, True),
                              (8, 12, False), (36, 19, True))]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_ssd_fwd: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import plain_ssd_scan, ssd_scan
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=25)
    runs = ap.parse_args().runs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    has_body = "body" in inspect.signature(ssd_scan).parameters
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, h, p, n, b, t, states in CASES:
        args = cs._ssd_case(gen, dev, b, t, h, p, n, torch.bfloat16)
        got = ssd_scan(*args, chunk=128, return_states=states)
        exp = plain_ssd_scan(*args, 128, states)
        errs = [cs._check_f32_out(nm, x, e)[1]
                for nm, x, e in zip(("y", "s_final", "s_enter"), got, exp)]
        del got, exp
        bodies = {"auto": {}}
        if has_body:
            bodies["fma"] = {"body": "fma"}
        times = {name: cs._median_ms(
            lambda kw=kw: ssd_scan(*args, chunk=128, return_states=states,
                                   **kw), runs=runs, flush=l2.zero_)[0]
            for name, kw in bodies.items()}
        body = "one body"
        if has_body:
            from repro_torch.kernels.ssd_scan import fwd_body
            body = fwd_body(args[0], args[3], 128)
        print(f"[ssd_fwd] {label} B={b} T={t} H={h} P={p} N={n} bf16"
              + (" +states" if states else "")
              + f": kernel {times['auto']:.4f} ms ({body})"
              + (f" | FMA body {times['fma']:.4f} ms" if has_body else "")
              + f" | err of the largest value {max(errs):.2e}")
        del args
    return 0


if __name__ == "__main__":
    sys.exit(main())
