#!/usr/bin/env python3
"""K4's precision on the card, and the route comparisons that its order of
arithmetic can move.

    python3 scripts/policy_loss_precision.py

Run from the root of a checkout (or of a copy with K4's sum order changed)
on a machine with an H100. Prints, each line tagged:

  [k4]    K4 at N 224, Va 256, bf16, live behaviour log-probs (as
          chip_smoke.py makes them), at d 4096, 2560 and 2048: the loss
          terms and metrics against the plain version in f64 on the same
          inputs (largest relative error, floored at 1), and dh and dw
          (bf16) against it: the mean signed error in the direction of the
          value ("toward |e|"; negative: shrunk toward zero), the mean and
          the largest error, as fractions of the mean or the largest |e|.
  [train] as chip_smoke.py runs and compares them, with its bounds:
          openvla-7b's step 1 on the dummy batch's stale behaviour
          log-probs (loss, metrics, grad norm within ROUTE_BOUND; the
          gradients per leaf and layer), and steps 1-3 from seed 0 on both
          routes for openvla-7b (8 layers) and mamba2-2.7b (16 layers) on
          stale and live behaviour log-probs, zamba2-1.2b (full depth) on
          stale ones. A comparison past its bound prints FAIL and the run
          goes on.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _errors(got, exp):
    d = got.double() - exp
    return ((d * exp.sign()).mean() / exp.abs().mean()).item(), \
        (d.abs().mean() / exp.abs().mean()).item(), \
        (d.abs().max() / exp.abs().max()).item()


def k4(dev):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import gipo_loss as gl
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (4096, 2560, 2048):
        c = cs._policy_case(gen, dev, 224, d, 256, torch.bfloat16)
        h, w, tg, lo, ad, mk = (c[x] for x in ("h", "w", "tg", "lo", "ad",
                                               "mk"))
        rows = [tg, lo.double(), ad.double(), mk.double()]
        coefs = c["coefs"]
        logits = h.double() @ w.double()
        got = gl._finalize(gl.policy_loss_fwd(h, w, tg, lo, ad, mk, 0.2)
                           .sum(0))
        exp = gl._finalize(gl._fwd_partials(logits, *rows, 0.2))
        ferr = max(abs(x.item() - y.item()) / max(abs(y.item()), 1.0)
                   for x, y in zip(list(got[:3]) + list(got[3].values()),
                                   list(exp[:3]) + list(exp[3].values())))
        dl = gl._block_dlogits(logits, *rows, 0.2, *coefs.double())
        dh, dw = gl.policy_loss_bwd(h, w, tg, lo, ad, mk, 0.2, coefs)
        eh, ew = _errors(dh, dl @ w.double().T), _errors(dw, h.double().T
                                                         @ dl)
        print(f"[k4] N=224 d={d} Va=256 bf16 ({gl.policy_body(h, w)}): "
              f"forward rel err {ferr:.3e} | dh toward |e| {eh[0]:+.3e} "
              f"mean {eh[1]:.3e} max {eh[2]:.3e} | dw toward |e| "
              f"{ew[0]:+.3e} mean {ew[1]:.3e} max {ew[2]:.3e}")


def steps(dev, arch, n_layers, remat, plain_remat, bound, live,
          step1_bounds=None):
    import torch
    import chip_smoke as cs
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs import RLConfig, get_config
    from repro_torch.core import train_step as ts
    from repro_torch.data.trajectory import dummy_batch
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    obs = 12 if arch == "openvla-7b" else cs.SSM_OBS - cfg.action_dim
    np_batch = dummy_batch(8, 8, obs, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    if step1_bounds is not None:
        state = ts.init_train_state(cfg, 0, device=dev)
        try:
            cs._compare_step1(f"{arch} bf16", cfg, rl, state,
                              batch_from_numpy(np_batch, device=dev),
                              (remat, remat or plain_remat), step1_bounds)
        except AssertionError as e:
            print(f"FAIL {e}")
        del state
        torch.cuda.empty_cache()
    for tag, kw, bounds in (("stale", {}, bound),
                            ("live", {"live": True}, cs.LIVE_STEPS_BOUND)):
        if tag == "live" and not live:
            continue
        hist = {mode: cs._run_steps(
            dev, cfg, rl, np_batch, mode, **kw,
            remat=remat or (mode == "torch" and plain_remat))[0]
            for mode in ("cuda", "torch")}
        try:
            cs._compare_steps(f"{arch} {tag}", hist["cuda"], hist["torch"],
                              bounds)
        except AssertionError as e:
            print(f"FAIL {e}")
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("policy_loss_precision: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    k4(dev)
    steps(dev, "openvla-7b", cs.TRAIN_LAYERS, False, False, cs.STEPS_BOUND,
          False, step1_bounds=(cs.ROUTE_BOUND, cs.LEAF_BOUND))
    steps(dev, "mamba2-2.7b", cs.SSM_TRAIN_LAYERS, False, True,
          cs.SSM_STEPS_BOUND, True)
    steps(dev, "zamba2-1.2b", 38, True, False, cs.HYB_STEPS_BOUND, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
