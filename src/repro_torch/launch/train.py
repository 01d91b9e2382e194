"""Production training launcher, as in the reference
``repro/launch/train.py``.

It runs ``seq_train_step`` over the production mesh (a process group of
256 ranks, 512 with ``--multi-pod``, started by the caller), each rank fed
only its rows of the batch (``sharding.spmd.rows``); ``--local`` runs the
same program on the local one-rank mesh with a reduced config — the code
path is identical, only the mesh and scale differ. Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --shape train_4k --steps 3 --local

``--remote-rollout N`` switches to the asynchronous runtime demo instead:
an :class:`AcceRLSystem` with N rollout worker processes hosted by the
Supervisor behind the transport subsystem (socket channels + weight-store
wire), trained for ``--steps`` policy updates on a reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --remote-rollout 2 \
        --steps 3

``--serve-workers N`` is the two-terminal multi-host demo: this process
binds ``--listen`` and waits for N connect-mode workers to dial in with
``--token``; each worker is a separate ``repro_torch.launch.worker``
process (any reachable host):

    # terminal 1
    PYTHONPATH=src python -m repro_torch.launch.train --serve-workers 1 \
        --listen 127.0.0.1:5555 --token sekrit --steps 3
    # terminal 2
    PYTHONPATH=src python -m repro_torch.launch.worker \
        --address 127.0.0.1:5555 --token sekrit

``--restart on_failure`` puts either flavor under a restart budget: a
killed worker is respawned (spawn mode) or its slot re-opened for a
redial (connect mode) instead of failing the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

# --trace-out arms the observability plane. Tracing is IMPORT-gated (every
# instrumented module binds its _tel at import time, keeping the off path
# free), so the env flag must be up before ANY repro_torch import below —
# argparse has not run yet, scan argv directly.
if any(a == "--trace-out" or a.startswith("--trace-out=")
       for a in sys.argv[1:]):
    os.environ.setdefault("REPRO_TRACE", "1")

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shape, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     num_chips)
from repro_torch.sharding import rules, spmd

#: ``--kernel-dispatch`` (the reference's names) -> ``dispatch.set_mode``
DISPATCH_MODES = {"auto": None, "pallas": "cuda", "jnp": "torch"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--local", action="store_true",
                    help="reduced config on the local device mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fused-loss", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the action head + GIPO loss tail fused (K4, "
                         "kernels/dispatch.py) — no [B,S,Va] logits in "
                         "device memory; default ON, --no-fused-loss opts "
                         "out")
    ap.add_argument("--kernel-dispatch", default="auto",
                    choices=tuple(DISPATCH_MODES),
                    help="hot-op routing: by the tensor's device (auto), "
                         "or force the CUDA kernels (pallas) or the plain "
                         "PyTorch versions (jnp); the reference's names")
    ap.add_argument("--remote-rollout", type=int, default=0, metavar="N",
                    help="run the async AcceRLSystem demo with N rollout "
                         "worker processes spawned under the Supervisor "
                         "(reduced config; ignores --shape)")
    ap.add_argument("--serve-workers", type=int, default=0, metavar="N",
                    help="host N connect-mode worker slots and wait for "
                         "repro_torch.launch.worker processes to dial in "
                         "(two-terminal multi-host demo)")
    ap.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="TransportServer bind address for --serve-workers")
    ap.add_argument("--token", default="",
                    help="shared worker.hello secret for --serve-workers")
    ap.add_argument("--restart", default="never",
                    choices=("never", "on_failure"),
                    help="supervision policy for remote/connect workers")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="restart budget per worker slot (with "
                         "--restart on_failure)")
    ap.add_argument("--remote-transport", default="socket",
                    choices=("socket", "shm", "ring"),
                    help="experience/weight wire for --remote-rollout: "
                         "per-message sockets, per-message SHM segments, "
                         "or persistent SHM rings (streaming data plane)")
    ap.add_argument("--put-window", type=int, default=0, metavar="W",
                    help="pipeline rollout flushes through a PutStream "
                         "with W frames in flight (0 = one RPC per flush; "
                         "ring transport always streams)")
    ap.add_argument("--journal-dir", default="", metavar="DIR",
                    help="write-ahead journal the TransportServer's hosted "
                         "state (channel contents, stream watermarks, "
                         "weight publishes) into DIR so a replacement "
                         "server can recover it")
    ap.add_argument("--resume-journal", action="store_true",
                    help="recover --journal-dir's state at startup (the "
                         "replacement-server path after a crash) instead "
                         "of requiring the directory to be fresh")
    ap.add_argument("--elastic-workers", type=int, default=0, metavar="MAX",
                    help="autoscale the remote worker fleet up to MAX "
                         "slots from queue-depth/weight-staleness signals "
                         "(0 = fixed fleet)")
    ap.add_argument("--inference-plane", default="", metavar="MODE",
                    choices=("", "host", "spawn"),
                    help="disaggregated inference for remote workers: "
                         "'host' serves the parent's pool behind the "
                         "transport, 'spawn' runs a supervised shared "
                         "inference tier process; default: each worker "
                         "keeps a colocated pool")
    ap.add_argument("--pipeline", action="store_true",
                    help="run the pipelined training-runtime demo: policy "
                         "trainer + world-model trainer as pipeline stages "
                         "on submeshes of the local device set, driven by "
                         "the static RUN/SEND/RECV/FREE schedules "
                         "(runtime/pipeline_exec.py); reduced config, "
                         "ignores --shape")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome-trace-event JSON (open in "
                         "Perfetto / chrome://tracing) covering every "
                         "process of the run; also arms the REPRO_TRACE "
                         "span recorder and the telemetry sink")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def configure(args):
    """(cfg, shape, rl) of the step loop the flags select: ``--local``
    reduces the config and the shape, as the reference does."""
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    if shape.kind != "train":
        raise ValueError("use repro_torch.launch.serve for decode shapes")
    if args.local:
        cfg = reduced(cfg, layers=2, d_model=128)
        shape = dataclasses.replace(shape, seq_len=256, global_batch=4)
    rl = RLConfig(fused_loss=args.fused_loss,
                  kernel_dispatch=args.kernel_dispatch)
    return cfg, shape, rl


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume_journal and not args.journal_dir:
        ap.error("--resume-journal needs --journal-dir")
    dev = resolve_device(args.device)
    if args.kernel_dispatch != "auto":
        # process-wide routing so attention / ssd_scan inside the
        # transformer follow the same side as the loss tail
        from repro_torch.kernels import dispatch
        dispatch.set_mode(DISPATCH_MODES[args.kernel_dispatch])

    if args.pipeline:
        _run_pipeline(args, dev)
        return
    if args.remote_rollout or args.serve_workers:
        _run_remote_rollout(args, dev)
        return

    cfg, shape, rl = configure(args)
    mesh = (make_local_mesh(dev) if args.local
            else make_production_mesh(multi_pod=args.multi_pod, device=dev))
    accum = steps.choose_accum(cfg, shape, mesh)
    _, batch_structs, sspec, _ = steps.train_specs(cfg, shape, mesh,
                                                   accum=accum)
    print(f"mesh {rules.mesh_shape(mesh)} | accum "
          f"{accum} | params {cfg.param_count() / 1e6:.1f}M")

    state = init_state(cfg, mesh, sspec, dev)
    split = spmd.splits(cfg, mesh, shape.global_batch // accum,
                        shape.seq_len + cfg.num_prefix_tokens)
    batch = synthetic_batch(cfg, batch_structs, dev, mesh=mesh, accum=accum,
                            split=split)
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = steps.seq_train_step(
            state, batch, cfg=cfg, rl=rl, accum=accum,
            grad_shardings=sspec.params, data_split=split)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"step {i}: loss {loss:.4f} gnorm {gnorm:.2f} "
              f"({time.perf_counter() - t0:.2f}s)")


def init_state(cfg, mesh, sspec, dev) -> steps.SeqTrainState:
    """Policy params from seed 0, zero AdamW moments and an empty Welford
    state on ``dev``; on a mesh of more than one device the params are
    placed under ``sspec.params`` and the moments under ``sspec.opt.mu``
    (ZeRO-2). On one device placement is a no-op."""
    from repro_torch.core.advnorm import init_adv_state
    from repro_torch.models.policy import init_policy_params
    from repro_torch.optim import adamw
    params = init_policy_params(cfg, 0, device=dev)
    opt = adamw.init(params)
    if num_chips(mesh) > 1:
        def place(tree, shardings):
            return rules.place_tree(tree, mesh, rules.spec_tree(shardings))
        params = place(params, sspec.params)
        opt = opt._replace(mu=place(opt.mu, sspec.opt.mu),
                           nu=place(opt.nu, sspec.opt.nu))
    return steps.SeqTrainState(params=params, opt=opt,
                               adv_norm=init_adv_state(dev))


def synthetic_batch(cfg, batch_structs, dev, *, mesh=None, accum: int = 1,
                    split: bool = True):
    """The reference's synthetic batch: integer leaves drawn in
    [0, vocab), float leaves 0.1 × a standard normal, from seed 0. With
    ``mesh``, the global batch is drawn on the host and only the rank's
    rows (``spmd.rows``; all of them where ``split`` is False) go to
    ``dev``."""
    rng = np.random.default_rng(0)
    out = {}
    for k, v in batch_structs.items():
        shape = tuple(v.shape)
        if v.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        else:
            a = rng.standard_normal(shape).astype(np.float32) * 0.1
        out[k] = torch.from_numpy(a)
    if mesh is not None:
        out = spmd.rows(out, mesh, dim=1 if accum > 1 else 0, split=split)
    return {k: v.to(dev) for k, v in out.items()}


def _run_pipeline(args, dev) -> None:
    """Pipelined training-runtime demo (reduced config): the world-model
    system with ``rt.pipeline`` on — the policy trainer's optimizer step
    and the WM trainer run as pipeline stages on submeshes of the local
    device list, one static instruction schedule per submesh."""
    from repro_torch.configs.base import (RuntimeConfig, TelemetryConfig,
                                          WMConfig)
    from repro_torch.wm.wm_system import AcceRLWMSystem

    cfg = reduced(get_config(args.arch), layers=2, d_model=64)
    rl = RLConfig(grad_accum=2, lr_policy=1e-4, lr_value=1e-3,
                  fused_loss=args.fused_loss,
                  kernel_dispatch=args.kernel_dispatch)
    rt = RuntimeConfig(num_rollout_workers=2, inference_batch=4,
                       pipeline=True,
                       telemetry=TelemetryConfig(sink=bool(args.trace_out),
                                                 trace_out=args.trace_out))
    wm = WMConfig(imagine_horizon=2, history_frames=2, diffusion_steps=4,
                  obs_train_interval=2, reward_train_interval=5)
    system = AcceRLWMSystem(cfg, rl, rt, wm, suite="spatial",
                            segment_horizon=4, max_episode_steps=8,
                            imagination_batch=4, device=dev)
    layout = system.trainer._layout
    print(f"pipeline: policy submesh {[str(d) for d in layout.policy.devices]}"
          f" | wm submesh {[str(d) for d in layout.wm.devices]}"
          f" | disjoint={layout.disjoint} | K={rl.grad_accum}")
    t0 = time.time()
    m = system.run_wm(train_steps=args.steps, wall_timeout_s=300.0)
    pipe = system.trainer.pipeline
    print(f"trained {m['train_steps']} policy steps "
          f"({pipe.rounds} pipeline rounds) in {time.time() - t0:.1f}s | "
          f"imagined {m['imagined_steps']} steps | "
          f"wm updates {m['wm_updates']}")
    print(f"bubble frac {pipe.last_bubble} | "
          f"peak live grad bytes {pipe.peak_grad_bytes}")
    if args.trace_out:
        from repro_torch.runtime import telemetry
        n = telemetry.dump(args.trace_out, process_name="train-pipeline")
        print(f"trace: {n} events -> {args.trace_out}")


def _run_remote_rollout(args, dev) -> None:
    """Asynchronous-system demo with supervised remote rollout workers —
    spawned child processes and/or connect-mode workers dialing in."""
    from repro_torch.configs.base import (RuntimeConfig, SupervisionConfig,
                                          TelemetryConfig, TransportConfig)
    from repro_torch.runtime import AcceRLSystem

    cfg = reduced(get_config(args.arch), layers=2, d_model=64)
    rl = RLConfig(grad_accum=1, lr_policy=1e-4, lr_value=1e-3,
                  fused_loss=args.fused_loss,
                  kernel_dispatch=args.kernel_dispatch)
    rt = RuntimeConfig(
        num_rollout_workers=1, inference_batch=4,
        transport=TransportConfig(
            remote_rollout_workers=args.remote_rollout,
            connect_rollout_workers=args.serve_workers,
            kind=args.remote_transport,
            put_window=args.put_window,
            listen_addr=args.listen if args.serve_workers else "",
            token=args.token,
            journal_dir=args.journal_dir,
            resume_journal=args.resume_journal,
            inference_plane=args.inference_plane,
            reconnect_attempts=(20 if args.inference_plane else 0),
            supervision=SupervisionConfig(
                restart=args.restart,
                max_restarts=args.max_restarts,
                max_workers=args.elastic_workers,
                min_workers=(1 if args.elastic_workers else 0))),
        telemetry=TelemetryConfig(sink=bool(args.trace_out),
                                  trace_out=args.trace_out))
    system = AcceRLSystem(cfg, rl, rt, suite="spatial", segment_horizon=4,
                          max_episode_steps=12, batch_episodes=4, device=dev)
    host, port = system.transport_server.address
    print(f"async system: 1 local + {args.remote_rollout} spawned + "
          f"{args.serve_workers} connect-mode rollout worker(s) over "
          f"{args.remote_transport} @ {host}:{port} "
          f"(restart={args.restart}"
          + (f", inference={args.inference_plane}" if args.inference_plane
             else "") + ")")
    if args.serve_workers:
        token_arg = f" --token {args.token}" if args.token else ""
        print(f"dial in from another terminal/host:\n"
              f"  PYTHONPATH=src python -m repro_torch.launch.worker "
              f"--address {host}:{port}{token_arg}")
    t0 = time.time()
    m = system.run_async(train_steps=args.steps, wall_timeout_s=300.0)
    print(f"trained {m['train_steps']} steps in {time.time() - t0:.1f}s | "
          f"env SPS {m['sps_env']:.1f} | policy lag "
          f"{m['mean_policy_lag']:.2f}")
    for name, h in system.health().items():
        line = f"  {name:20s} {h['state']}"
        snap = m["services"].get(name, {})
        counters = snap.get("counters", {})
        for key in ("env_steps", "steps", "batches", "requests"):
            if key in counters:
                line += f"  {key}={int(counters[key])}"
        print(line + (f"  error={h['error']}" if h["error"] else ""))
    if args.trace_out:
        # one file covers every process: the parent's own buffers plus
        # the child events the server folded in from worker.report
        from repro_torch.runtime import telemetry
        n = telemetry.dump(args.trace_out, process_name="train-parent")
        print(f"trace: {n} events -> {args.trace_out}")


if __name__ == "__main__":
    main()
