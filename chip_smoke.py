#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line of its numbers:

  1. device: the card, its power limit, the torch/CUDA versions; builds the
     CUDA kernels from ``src/repro_torch/csrc`` (timed).
  2. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the slice's shapes, in f32 and bf16; the bf16 bodies also against
     the kernels' own order of arithmetic, to within the output's rounding;
     each timed beside the plain version and one PyTorch library call.
  3. model: openvla-7b at full width (bf16, random weights from a seed),
     prefill + 7 decode steps on the kernel route, replayed on the plain
     route; every step's action logits compared.
  4. serving: the InferenceService answering 24 requests from 4 client
     threads across a drain-protocol weight swap, with the kernels' launch
     counts proving every layer went through both kernels.

Every check raises on failure, so the script exits non-zero. The line
before the last is a JSON summary of every kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
F32_MAX_ERR = 1e-4
BF16_TOL = 2e-2
# bf16 kernel bodies against the kernels' own order of arithmetic
# (kernels/ref.py::tiled_softmax_attention) on inputs whose q.k sums are
# exact in f32: the rounded P then agree bit for bit, so the bf16 output may
# differ from the f32 reference by its own rounding (half an ulp, <= 2^-8
# relative) plus f32 reordering error, held at 1e-5.
ORDER_RTOL = 2.0 ** -8
ORDER_ATOL = 1e-5
# Kernel route vs plain route, max |Δ action logit| over prefill + 7 decode
# steps of openvla-7b in bf16. Measured 0.031 on the H100 with logits of
# magnitude ~3: the two routes round the attention output to bf16 at
# different points, and that difference passes through 32 bf16 layers.
# The bound leaves ~3x room over the measurement.
MODEL_LOGIT_BOUND = 0.1
ROOT = pathlib.Path(__file__).resolve().parent


def _median_ms(fn, *, runs: int = 25, warmup: int = 5, flush=None):
    """Median device time of ``fn`` in ms over ``runs`` calls, from CUDA
    events around each call, and the host's time to enqueue one call.

    Before the timed calls the device sleeps for about twice the time the
    host needs to enqueue all of them, so every call is queued before the
    device reaches it: the events then bracket device work only, not the
    host's launch overhead. ``flush`` runs before each call, outside the
    events."""
    import torch

    def call():
        if flush is not None:
            flush()
        fn()
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(int(2 * runs * host_s * 2e9) + 10 ** 6)  # <= 2 GHz
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in events),
            host_s * 1e3)


def _bound(nbytes: int, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _check_close(name, got, exp, dtype) -> float:
    import torch
    err = (got.float() - exp.float()).abs().max().item()
    if dtype == torch.float32:
        if not err <= F32_MAX_ERR:
            raise AssertionError(f"{name}: f32 max abs err {err} > "
                                 f"{F32_MAX_ERR}")
    else:
        torch.testing.assert_close(got.float(), exp.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL, msg=lambda m: f"{name}: {m}")
    return err


def _exact_qk(gen, shape, dtype, dev):
    """Values n / 8 with |n| <= 16: every product and partial sum of a q.k
    dot is exact in f32, whatever the order of the sum."""
    import torch
    return torch.randint(-16, 17, shape, generator=gen,
                         device=dev).to(dtype) / 8


def _check_order(name, got, exp) -> float:
    """A bf16 kernel output against the tiled f32 reference; returns the
    largest error beyond the output's own rounding."""
    excess = ((got.float() - exp).abs() - ORDER_RTOL * exp.abs()).max().item()
    if not excess <= ORDER_ATOL:
        raise AssertionError(f"{name}: {excess} beyond half a bf16 ulp of the "
                             f"kernel-order reference > {ORDER_ATOL}")
    return excess


def phase_device():
    import torch
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build.load()
    t_build = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.build_log.splitlines()
            if "registers" in ln]
    print(f"[device] {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"kernel build {t_build:.1f} s")
    for ln in regs:
        print(f"[build] {ln}")
    return name, smi


def _time_flash(case, flush):
    """Kernel, plain version and library call on one bf16 causal case."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_plain_dense,
                                                     flash_attention)
    q, k, v = case["q"], case["k"], case["v"]
    b, t, h, d = q.shape
    ms, host_ms = _median_ms(lambda: flash_attention(q, k, v), flush=flush)
    plain_ms, _ = _median_ms(lambda: _plain_dense(q, k, v), flush=flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms, _ = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush=flush)
    pairs = t * (t + 1) // 2                       # causal (q, k) pairs
    bound_ms, bound_by = _bound(_nbytes(q, k, v, q),
                                4.0 * d * pairs * b * h, "bfloat16")
    shape = f"B={b} T=S={t} H={h} KV={k.shape[2]} D={d} bf16"
    print(f"[kernels] flash {shape}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | sdpa {lib_ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms ({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def _time_decode(case, flush):
    """Kernel, plain version and library call on one bf16 decode case."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention)
    q, k, v, valid = case["q"], case["k"], case["v"], case["valid"]
    b, _, h, d = q.shape
    ms, host_ms = _median_ms(lambda: decode_attention(q, k, v, valid),
                             flush=flush)
    plain_ms, _ = _median_ms(lambda: _plain_decode(q, k, v, valid),
                             flush=flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = valid[:, None, None, :]
    lib_ms, _ = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), flush=flush)
    # the output needs K and V rows of this run's valid slots only
    n_valid = int(valid.sum().item())
    kv_row = k.shape[2] * d * k.element_size()
    bound_ms, bound_by = _bound(_nbytes(q, valid, q) + 2 * n_valid * kv_row,
                                4.0 * d * h * n_valid, "bfloat16")
    shape = f"B={b} S={k.shape[1]} H={h} KV={k.shape[2]} D={d} bf16"
    print(f"[kernels] decode {shape}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | sdpa {lib_ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms ({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def phase_kernels(dev):
    """Each kernel against its plain version; returns the JSON entries."""
    import torch
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention)
    from repro_torch.kernels.flash_attention import (_plain_dense,
                                                     flash_attention)
    from repro_torch.kernels.ref import tiled_softmax_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # --- K1 flash attention -------------------------------------------------
    k1 = {}
    for (b, t, h, kv, d, window) in [(8, 268, 32, 32, 128, None),
                                     (8, 268, 32, 8, 128, None),
                                     (8, 268, 32, 32, 128, 64),
                                     (8, 13, 32, 32, 128, None)]:
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(b, t, h, d, dtype=dtype)
            k = rand(b, t, kv, d, dtype=dtype)
            v = rand(b, t, kv, d, dtype=dtype)
            out, lse = flash_attention(q, k, v, window=window,
                                       return_lse=True)
            exp, exp_lse = _plain_dense(q, k, v, window=window,
                                        return_lse=True)
            torch.cuda.synchronize()
            tag = f"flash B={b} T=S={t} H={h} KV={kv} D={d} w={window} " \
                  f"{str(dtype)[6:]}"
            err = _check_close(tag, out, exp, dtype)
            lse_err = (lse - exp_lse).abs().max().item()
            if not lse_err <= 1e-3:
                raise AssertionError(f"{tag}: lse err {lse_err}")
            order = ""
            if dtype == torch.bfloat16:
                qe = _exact_qk(gen, (b, t, h, d), dtype, dev)
                ke = _exact_qk(gen, (b, t, kv, d), dtype, dev)
                pos = torch.arange(t, device=dev)
                ok = pos[None, :] <= pos[:, None]
                if window is not None:
                    ok &= (pos[:, None] - pos[None, :]) < window
                got = flash_attention(qe, ke, v, window=window)
                ref, _ = tiled_softmax_attention(qe, ke, v, ok[None, None])
                excess = _check_order(tag, got, ref)
                order = (f" | kernel order: max abs err "
                         f"{(got.float() - ref).abs().max().item():.3e}, "
                         f"beyond half an ulp {excess:.3e}")
            print(f"[kernels] {tag}: max abs err {err:.3e} lse {lse_err:.3e}"
                  f"{order}")
            if (kv, window, dtype) == (32, None, torch.bfloat16):
                k1[t] = dict(q=q, k=k, v=v, err=err)
    entries = [dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:40",
                    launches=None, max_abs_err=k1[268]["err"],
                    **_time_flash(k1[268], flush),
                    service=_time_flash(k1[13], flush))]

    # --- K2 decode attention ------------------------------------------------
    k2 = {}
    for (b, s, h, kv, d) in [(8, 275, 32, 32, 128), (8, 275, 32, 8, 128),
                             (8, 20, 32, 32, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(b, 1, h, d, dtype=dtype)
            k = rand(b, s, kv, d, dtype=dtype)
            v = rand(b, s, kv, d, dtype=dtype)
            valid = torch.rand(b, s, generator=gen, device=dev) > 0.3
            valid[:, 0] = True
            out = decode_attention(q, k, v, valid)
            exp = _plain_decode(q, k, v, valid)
            torch.cuda.synchronize()
            tag = f"decode B={b} S={s} H={h} KV={kv} D={d} {str(dtype)[6:]}"
            err = _check_close(tag, out, exp, dtype)
            order = ""
            if dtype == torch.bfloat16:
                qe = _exact_qk(gen, (b, 1, h, d), dtype, dev)
                ke = _exact_qk(gen, (b, s, kv, d), dtype, dev)
                got = decode_attention(qe, ke, v, valid)
                ref, _ = tiled_softmax_attention(
                    qe, ke, v, valid[:, None, None, :])
                excess = _check_order(tag, got, ref)
                order = (f" | kernel order: max abs err "
                         f"{(got.float() - ref).abs().max().item():.3e}, "
                         f"beyond half an ulp {excess:.3e}")
            print(f"[kernels] {tag}: max abs err {err:.3e}{order}")
            if (kv, dtype) == (32, torch.bfloat16):
                k2[s] = dict(q=q, k=k, v=v, valid=valid, err=err)
    entries.append(dict(name="decode_attention", route="cuda",
                        source="src/repro_torch/csrc/decode_attention.cu",
                        replaces="src/repro/kernels/decode_attention.py:38",
                        launches=None, max_abs_err=k2[275]["err"],
                        **_time_decode(k2[275], flush),
                        service=_time_decode(k2[20], flush)))
    del l2
    return entries


def _replay(cfg, params, obs, prefix, tokens):
    """Prefill + one decode per given action token. Returns the action
    logits before each token and after the last ([A + 1] x [B, Va] f32),
    and the host-clock seconds of the prefill and of all decode steps."""
    import torch
    from repro_torch.models import transformer
    cache_len = prefix.shape[1] + obs.shape[1] + tokens.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, cache = transformer.prefill(cfg, params, obs, prefix,
                                     cache_len=cache_len)
    logits = [out["logits"][:, -1]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(tokens.shape[1]):
        dec, cache = transformer.decode(cfg, params, tokens[:, i].long(),
                                        cache)
        logits.append(dec["logits"][:, -1])
    torch.cuda.synchronize()
    return logits, t1 - t0, time.perf_counter() - t1


def phase_model(dev, cfg, params):
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.policy import gumbel_noise, sample_action_sequence
    gen = torch.Generator(device=dev).manual_seed(1)
    b, a = 8, cfg.action_dim
    obs = torch.randint(0, cfg.vocab_size, (b, 12), generator=gen, device=dev)
    prefix = torch.randn(b, cfg.num_prefix_tokens, 1024, generator=gen,
                         device=dev)
    steps = torch.arange(b, device=dev)
    noise = gumbel_noise(gen, (a, b, cfg.action_vocab_size), dev)
    with torch.inference_mode():
        with dispatch.forced("cuda"):
            n0 = (flash_attention.launches, decode_attention.launches)
            tok, logp, val = sample_action_sequence(
                cfg, params, None, obs, steps, prefix, gumbel=noise)
            n1 = (flash_attention.launches, decode_attention.launches)
        if (n1[0] - n0[0], n1[1] - n0[1]) != (cfg.num_layers,
                                              cfg.num_layers * a):
            raise AssertionError(f"launches {n0} -> {n1}")
        runs = {"torch": [], "cuda": []}
        for mode in ("torch", "cuda", "cuda", "torch"):
            with dispatch.forced(mode):
                runs[mode].append(_replay(cfg, params, obs, prefix, tok))
    lk, lp = runs["cuda"][0][0], runs["torch"][0][0]
    if tok.shape != (b, a) or int(tok.min()) < 0 \
            or int(tok.max()) >= cfg.action_vocab_size:
        raise AssertionError(f"tokens out of range: {tok}")
    if not (torch.isfinite(logp).all() and (logp <= 0).all()
            and torch.isfinite(val).all()):
        raise AssertionError("logp must be finite and <= 0, values finite")
    # the kernel-route replay reproduces the sampler's own logp
    replay_logp = torch.stack([torch.log_softmax(lk[i], -1).gather(
        -1, tok[:, i:i + 1].long())[:, 0] for i in range(a)], 1)
    torch.testing.assert_close(replay_logp, logp, atol=1e-5, rtol=0)
    diffs = [(x - y).abs().max().item() for x, y in zip(lk, lp)]
    scale = max(x.abs().max().item() for x in lp)
    print(f"[model] openvla-7b bf16 B={b} T={prefix.shape[1] + 12} "
          f"cache={prefix.shape[1] + 12 + a}: max |logit kernel - plain| "
          f"per step {[f'{x:.4f}' for x in diffs]} (bound "
          f"{MODEL_LOGIT_BOUND}, max |logit| {scale:.3f})")
    for mode, name in (("cuda", "kernel"), ("torch", "plain")):
        times = ", ".join(f"prefill {r[1] * 1e3:.1f} ms + 7 decodes "
                          f"{r[2] * 1e3:.1f} ms" for r in runs[mode])
        print(f"[model] {name} route, two replays: {times}")
    if not max(diffs) <= MODEL_LOGIT_BOUND:
        raise AssertionError(f"model logits differ by {max(diffs)}")


def phase_serving(dev, cfg, params0, params1):
    import numpy as np
    import torch
    from repro_torch.configs import RuntimeConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.runtime import InferenceService, VersionedWeightStore
    rt = RuntimeConfig(num_inference_workers=1, inference_batch=8,
                       inference_max_wait_s=0.02)
    store = VersionedWeightStore()
    store.publish(params0, 0)
    service = InferenceService(cfg, store, rt, device=dev)
    rng = np.random.default_rng(0)
    lock = threading.Lock()
    futures = []

    def client(i):
        for _ in range(3):
            with lock:
                obs = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
                frame = rng.random(192).astype(np.float32)
            fut = service.submit(obs, frame, int(i))
            with lock:
                futures.append(fut)

    def wave():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                raise AssertionError("client thread hung")

    flash_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    service.start()
    try:
        wave()
        first = [f.result(timeout=300) for f in list(futures)]
        store.begin_publish()              # drain: no new batch starts
        wave()                             # these wait for the swap
        store.publish(params1, 1)
        results = first + [f.result(timeout=300) for f in futures[12:]]
        wall = time.perf_counter() - t0
    finally:
        service.stop()
        service.join(timeout=30)
    if not service.healthy:
        raise AssertionError(f"service failed: {service.error!r}")
    launches = (flash_attention.launches, decode_attention.launches)
    for r in results:
        act = r["actions"]
        if act.shape != (cfg.action_dim,) or act.min() < 0 \
                or act.max() >= cfg.action_vocab_size:
            raise AssertionError(f"bad actions {act}")
        if not (np.isfinite(r["logp"]).all() and (r["logp"] <= 0).all()
                and np.isfinite(r["value"])):
            raise AssertionError(f"bad logp/value {r}")
    versions = [r["policy_version"] for r in results]
    if set(versions[:12]) != {0} or set(versions[12:]) != {1}:
        raise AssertionError(f"versions served {versions}")
    nb = service.batches_run
    if service.requests_served != 24 or service.weight_swaps != 2 \
            or nb < 3:
        raise AssertionError(
            f"counters: requests {service.requests_served}, swaps "
            f"{service.weight_swaps}, batches {nb}")
    if launches != (cfg.num_layers * nb, cfg.num_layers * cfg.action_dim
                    * nb):
        raise AssertionError(f"launches {launches} for {nb} batches")
    lat = service.metrics.series("batch_s")
    print(f"[serving] openvla-7b bf16: 24 requests, {nb} batches, versions "
          f"{sorted(set(versions))}, swaps {service.weight_swaps} | "
          f"launches flash {launches[0]} decode {launches[1]} | batch p50 "
          f"{statistics.median(lat) * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}"
          f", max {max(lat) * 1e3:.1f}) | {24 / wall:.2f} req/s over "
          f"{wall:.2f} s incl. the swap")
    return launches


def phase_trace(dev, cfg, params):
    """One serving-shape batch (B=8, 12 tokens + 1 frame token, 7 decode
    steps) under torch.profiler: wall time, device busy time, and the
    kernels that take it. After the serving phase, so no launch it makes
    is counted there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.policy import sample_action_sequence
    gen = torch.Generator(device=dev).manual_seed(2)
    obs = torch.randint(0, cfg.vocab_size, (8, 12), generator=gen, device=dev)
    prefix = torch.zeros(8, 1, 1024, device=dev)
    prefix[:, 0, :192] = torch.rand(8, 192, generator=gen, device=dev)
    steps = torch.arange(8, device=dev)

    def batch():
        sample_action_sequence(cfg, params, gen, obs, steps, prefix)
        torch.cuda.synchronize()

    with torch.inference_mode():
        batch()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batch()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print(f"[trace] one serving batch: wall {wall_ms:.1f} ms traced; "
              f"device time not measured (the profiler saw no kernels)")
        return
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{name[:48]} {ms:.2f} ms x{n}" for name, ms, n
                    in rows[:6])
    print(f"[trace] one serving batch B=8 T=13 + 7 decodes, traced: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% | top: {top}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models.policy import init_policy_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    name, _ = phase_device()
    entries = phase_kernels(dev)

    cfg = get_config("openvla-7b")
    t0 = time.perf_counter()
    params0 = init_policy_params(cfg, 0, device=dev)
    params1 = init_policy_params(cfg, 1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params0))
    print(f"[model] openvla-7b: {n_params / 1e9:.3f} B parameters x 2 "
          f"versions initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s | allocated "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB")
    phase_model(dev, cfg, params0)

    launches = phase_serving(dev, cfg, params0, params1)
    entries[0]["launches"], entries[1]["launches"] = launches
    phase_trace(dev, cfg, params0)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
