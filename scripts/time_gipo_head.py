#!/usr/bin/env python3
"""Time K5, the GIPO loss over given logits, on the card at every shape
``chip_smoke.py`` runs it, beside its plain version.

    python3 scripts/time_gipo_head.py [--tree DIR]

Run from the root of a checkout on a machine with an H100. ``--tree``
times the ``repro_torch`` of another checkout (an older commit unpacked
beside this one) with this script's cases and clock, so that two trees
compare within one call. For each of ``chip_smoke.K5_SHAPES`` in f32 and
bf16, on live behaviour log-probs (``chip_smoke._head_case``): the forward
and the backward are first held against the plain version (by
``chip_smoke.py``'s own checks), then timed as ``chip_smoke.py`` times kernels
(median of CUDA events, L2 flushed before each call): ``chip_smoke._time_head``
prints one line a case and pass, with the bound and the share of it
reached. The body the tree's K5 took is printed where the tree can say
(``gipo_loss.head_body``). A ``[flush]`` line a case then times both passes
again after a flush that leaves the L2 cache clean (reading 128 MB, where
``chip_smoke.py`` writes them: its reads must first write the dirty lines
back), beside ``logits.amax()`` after either flush, a plain PyTorch read of
the same bytes: the yardstick of what a read of the logits costs under each
flush. The first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_gipo_head: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import gipo_loss as gl
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"[tree] {args.tree.resolve()}: repro_torch from "
          f"{pathlib.Path(gl.__file__).resolve()}")
    dev = torch.device("cuda", 0)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    body = getattr(gl, "head_body", lambda _: "one body")

    def clean():                  # evict the cache with clean lines
        l2.view(torch.int32).amax()
    for n, v in cs.K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            case = cs._head_case(gen, dev, n, v, dtype, False)
            coefs = torch.tensor(cs.K5_COEFS[-1], device=dev) / n
            shape = f"N={n} V={v} {str(dtype)[6:]}"
            ferr = cs._head_fwd_err(shape, case,
                                    gl.gipo_head_fwd(*case, 0.2))[0]
            derr = cs._head_bwd_err(shape, case, coefs,
                                    gl.gipo_head_bwd(*case, 0.2, coefs))[1]
            print(f"[check] {shape} ({body(case[0])}): forward rel err "
                  f"{ferr:.3e} | d_logits err beyond the bar's rounding "
                  f"term, of the largest value {derr:.3e}")
            cs._time_head(case, coefs, l2.zero_)   # prints a line a pass
            ms = {}
            for tag, fl in (("dirty", l2.zero_), ("clean", clean)):
                for name, fn in (
                        ("fwd", lambda: gl.gipo_head_fwd(*case, 0.2)),
                        ("bwd", lambda: gl.gipo_head_bwd(*case, 0.2, coefs)),
                        ("read", lambda: case[0].amax())):
                    ms[tag, name] = cs._median_ms(fn, flush=fl)[0]
            print(f"[flush] {shape}: "
                  + " | ".join(f"L2 {tag}: fwd {ms[tag, 'fwd']:.4f} bwd "
                               f"{ms[tag, 'bwd']:.4f} logits.amax() "
                               f"{ms[tag, 'read']:.4f} ms"
                               for tag in ("dirty", "clean")))
            del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
