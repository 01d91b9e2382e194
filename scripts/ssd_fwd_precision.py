#!/usr/bin/env python3
"""K6's precision on the card, and the route comparisons it can move.

    python3 scripts/ssd_fwd_precision.py

Run from the root of a checkout (or of a copy with K6's sum order changed)
on a machine with an H100. Prints, each line tagged:

  [bias]  K6's y and final state against the chunked form in f64 on the
          same bf16 inputs (B8 T256, mamba2-2.7b's and zamba2-1.2b's SSD
          shapes): the mean signed error in the direction of the value
          ("toward |e|", negative: shrunk toward zero), the mean and the
          largest error, each as a fraction of the mean or largest |e|; for
          the body the C entry picks and for the FMA body.
  [prec]  the same for y on mamba2-2.7b's own SSD inputs, captured from the
          16 layers of the train step's forward (dummy batch, seed 0), and
          the RMS gap of the action log-probs between the kernel and the
          plain route there.
  [train] steps 1-3 from seed 0 on both routes, as chip_smoke.py runs and
          compares them (its _run_steps and _compare_steps, its bounds):
          mamba2-2.7b at 16 layers on the dummy batch's stale behaviour
          log-probs and on live ones, zamba2-1.2b at full depth on stale
          ones. A comparison past its bound prints FAIL and the run goes on.
"""
from __future__ import annotations

import dataclasses
import importlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def chunked_f64(x, dt, A, Bm, Cm, q):
    """The chunked SSD form in f64, chunk ``q`` dividing T: (y, final
    state)."""
    import torch
    b, t, h, p = x.shape
    n, nc = Bm.shape[-1], t // q
    xc = x.double().reshape(b, nc, q, h, p)
    dtc = dt.double().reshape(b, nc, q, h)
    bc = Bm.double().reshape(b, nc, q, n)
    cc = Cm.double().reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * A.double(), dim=2)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    g = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    w = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None] * g \
        * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                           torch.exp(cum[:, :, -1:] - cum) * dtc, bc, xc)
    s = torch.zeros((b, h, p, n), dtype=torch.float64, device=x.device)
    enter = []
    for c in range(nc):
        enter.append(s)
        s = torch.exp(cum[:, c, -1])[:, :, None, None] * s + s_chunk[:, c]
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", cc,
                         torch.stack(enter, 1), torch.exp(cum))
    return y.reshape(b, t, h, p), s


def _errors(got, exp):
    d = got.double() - exp
    return ((d * exp.sign()).mean() / exp.abs().mean()).item(), \
        (d.abs().mean() / exp.abs().mean()).item(), \
        (d.abs().max() / exp.abs().max()).item()


def _fmt(e):
    return f"toward |e| {e[0]:+.3e} mean {e[1]:.3e} max {e[2]:.3e}"


def bias(dev):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=dev).manual_seed(0)
    for h, p, n in ((80, 64, 128), (64, 64, 64)):
        args = cs._ssd_case(gen, dev, 8, 256, h, p, n, torch.bfloat16)
        exp = chunked_f64(*args, 128)
        main = ssd_scan(*args, chunk=128)
        fma = ssd_scan(*args, chunk=128, body="fma")
        for name, x, xf, e in zip(("y", "s_final"), main, fma, exp):
            print(f"[bias] N={n} {name}: main {_fmt(_errors(x, e))} | FMA "
                  f"{_fmt(_errors(xf, e))}")


def model_inputs(dev):
    import torch
    import chip_smoke as cs
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core import train_step as ts
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.kernels import dispatch
    from repro_torch.models.policy import action_log_prob
    k6 = importlib.import_module("repro_torch.kernels.ssd_scan")
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              num_layers=cs.SSM_TRAIN_LAYERS)
    np_batch = dummy_batch(8, 8, cs.SSM_OBS - cfg.action_dim, cfg.action_dim,
                           cfg.vocab_size, cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    state = ts.init_train_state(cfg, 0, device=dev)
    batch = batch_from_numpy(np_batch, device=dev)
    captured, kernel = [], dispatch._kernel_ssd_scan

    def capture(*args, **kw):
        captured.append([a.clone() for a in args])
        return kernel(*args, **kw)
    logp = {}
    with torch.no_grad():
        for mode in ("cuda", "torch"):
            dispatch._kernel_ssd_scan = capture if mode == "cuda" else kernel
            try:
                with dispatch.forced(mode):
                    hidden, _, _ = ts._score_batch_hidden(
                        cfg, state.params, batch, remat=False)
            finally:
                dispatch._kernel_ssd_scan = kernel
            logits = hidden.float() @ state.params["action_head"]["w"].float()
            logp[mode] = action_log_prob(logits, batch.actions).float()
        gap = logp["cuda"] - logp["torch"]
        print(f"[prec] mamba2-2.7b x {cfg.num_layers} layers, action "
              f"log-probs kernel vs plain route: rms "
              f"{gap.pow(2).mean().sqrt().item():.4e}, max "
              f"{gap.abs().max().item():.4e} over {gap.numel()}")
        rows = {"main": [], "FMA": [], "plain": []}
        for args in captured:
            exp = chunked_f64(*args, cfg.ssm.chunk)[0]
            for name, y in (
                    ("main", k6.ssd_scan(*args, chunk=cfg.ssm.chunk)[0]),
                    ("FMA", k6.ssd_scan(*args, chunk=cfg.ssm.chunk,
                                        body="fma")[0]),
                    ("plain", k6.plain_ssd_scan(*args, cfg.ssm.chunk)[0])):
                rows[name].append(_errors(y, exp))
    for name, errs in rows.items():
        print(f"[prec] y on its {len(errs)} layers' inputs, {name}: toward "
              f"|e| {sum(e[0] for e in errs) / len(errs):+.3e} (mean over "
              f"layers), mean {sum(e[1] for e in errs) / len(errs):.3e}, max "
              f"{max(e[2] for e in errs):.3e} (worst layer)")


def steps(dev, arch, n_layers, remat, plain_remat, bound, live):
    import torch
    import chip_smoke as cs
    from repro_torch.configs import RLConfig, get_config
    from repro_torch.data.trajectory import dummy_batch
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    np_batch = dummy_batch(8, 8, cs.SSM_OBS - cfg.action_dim, cfg.action_dim,
                           cfg.vocab_size, cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
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
        print("ssd_fwd_precision: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bias(dev)
    model_inputs(dev)
    steps(dev, "mamba2-2.7b", cs.SSM_TRAIN_LAYERS, False, True,
          cs.SSM_STEPS_BOUND, True)
    steps(dev, "zamba2-1.2b", 38, True, False, cs.HYB_STEPS_BOUND, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
