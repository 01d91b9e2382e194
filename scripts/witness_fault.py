#!/usr/bin/env python3
"""What a model's f32 witness reads over steps 1-3 when K4's backward is
wrong.

    python3 scripts/witness_fault.py [--arch openvla-7b|granite-moe-1b-a400m]

Run from the root of a checkout on a machine with an H100. Runs steps 1-3
of the model's f32 copy on both routes from the same seed, as
``chip_smoke.py``'s witness runs them (openvla-7b: 8 layers and the
env's 12 + 1 + 7 tokens, held by ``OVLA_F32_BOUNDS``; granite-moe-1b-a400m:
24 layers and 256 tokens, ``MOE_F32_BOUNDS``; full width), and compares
them with the bounds: first as the code stands, then with a fault planted
at run time in the kernel route's K4 backward (its dh scaled by 1 + 1e-3;
its k3-KL coefficient 1% off). Prints chip_smoke's line of readings for
each, a comparison past its bound as FAIL, and goes on. The first line is
the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("witness_fault: CUDA is not available", file=sys.stderr)
        return 1
    import argparse
    import chip_smoke as cs
    from repro_torch.configs import RLConfig, get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="openvla-7b",
                    choices=("openvla-7b", cs.MOE_ARCH))
    arch = ap.parse_args().arch
    layers, obs_len, bounds = {
        "openvla-7b": (cs.TRAIN_LAYERS, 12, cs.OVLA_F32_BOUNDS),
        cs.MOE_ARCH: (24, cs.MOE_OBS - 7, cs.MOE_F32_BOUNDS)}[arch]
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.kernels import gipo_loss as gl
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    np_batch = dummy_batch(8, 8, obs_len, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    plain = cs._run_steps(dev, cfg, rl, np_batch, "torch", remat=True)[0]
    sound_bwd = gl.policy_loss_bwd
    for tag, dh_scale, kl_scale in (("sound", 1.0, 1.0),
                                    ("K4 dh x (1 + 1e-3)", 1 + 1e-3, 1.0),
                                    ("K4 c_kl x 1.01", 1.0, 1.01)):
        def bwd(hidden, w, targets, logp_old, adv, mask, sigma, coefs):
            coefs = coefs * torch.tensor([1.0, kl_scale, 1.0],
                                         device=coefs.device)
            dh, dw = sound_bwd(hidden, w, targets, logp_old, adv, mask,
                               sigma, coefs)
            return dh * dh_scale, dw
        bwd.launches, bwd.tc = 0, sound_bwd.tc    # the wrapper's counters
        gl.policy_loss_bwd = bwd
        try:
            kern = cs._run_steps(dev, cfg, rl, np_batch, "cuda",
                                 remat=True)[0]
        finally:
            gl.policy_loss_bwd = sound_bwd
        try:
            cs._compare_steps(f"{arch} f32 copy, {tag}", kern, plain,
                              bounds[2])
        except AssertionError as e:
            print(f"FAIL {e}")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
