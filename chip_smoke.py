#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line of its numbers:

  1. device: the card, its power limit, the torch/CUDA versions; builds the
     CUDA kernels from ``src/repro_torch/csrc`` (timed).
  2. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the slices' shapes, in f32 and bf16: K1 flash forward and K2 decode
     (the bf16 bodies also against the kernels' own order of arithmetic, to
     within the output's rounding), K3 flash backward (timed as the
     wrapper's call and as its kernels' own device time), K4 fused policy
     loss forward and backward (ragged; d 4096, 2560 and 2048; behaviour
     log-probs live, ω mean above 0.5, and once stale; the body that ran
     printed; timed beside the unfused route of cuBLAS's product and K5),
     K5 the GIPO
     loss over given logits, forward and backward (the reference tests'
     ragged shapes, the action head's N 224 x V 256 and
     benchmarks/fused_loss.py's FULL_SHAPES, all on its register body and
     also against its order of arithmetic; the backward twice, bit for
     bit; timed with the share of its bound), K1/K2/K3 again at
     zamba2-1.2b's attention (head_dim 64, MHA; K1 also without the causal
     mask) and at granite-moe-1b-a400m's (16 query heads over 8 KV heads
     of 64, at its serving, training and system shapes; K4 at its d
     1024), K6 SSD scan (with and without entering
     states; which body ran printed, and its bf16 tensor-core body timed
     beside its FMA body) and K7 its backward (run twice, bit for bit) at
     mamba2-2.7b's and zamba2-1.2b's SSD shapes; each timed beside the
     plain version and, where one PyTorch call computes the same function,
     that call (grouped K/V passed as they are, ``enable_gqa``).
  3. model: openvla-7b at full width (bf16, random weights from a seed),
     prefill + 7 decode steps on the kernel route, replayed on the plain
     route; every step's action logits compared.
  4. serving: the InferenceService answering 24 requests from 4 client
     threads across a drain-protocol weight swap, with the kernels' launch
     counts proving every layer went through both kernels.
  5. training: openvla-7b at full width and 8 of its 32 layers (bf16, random
     weights from a seed), three GIPO train steps (fused loss, grad_accum 2)
     on the kernel route, with launch counts proving every attention
     backward ran on K3 and every loss on K4's tensor-core body; every
     gradient leaf nonzero;
     step 1's metrics and gradients (per leaf and layer) compared with the
     plain route's, on the dummy batch's stale behaviour log-probs and
     again on live ones (the plain route's own plus 0.1 noise, ω mean
     above 0.5); the three steps replayed on the plain route from the
     same seed and compared; the three steps once more on both routes with
     live behaviour log-probs at every step (ω mean above 0.5 at each); step
     1 and steps 1-3 again on an f32 copy, the witness of the bf16 gaps,
     each bf16 route's step 1 printed against it.
  6. mamba2-2.7b: phases 3-5 again for the ssm family: full depth (64
     layers) on 256-token prompts and on the toy env's 12-token prompts, K6
     on every layer of every prefill, the routes also compared on an f32
     copy of the model; training at full width and 16 of its 64 layers, K6/K7
     on every layer and K4 on every loss, the plain route checkpointing each
     layer, with step 1 and steps 1-3 again on an f32 copy as the witness of
     the bf16 gaps, steps 1-3 also on live behaviour log-probs; one more
     step on the env's 19-token sequences.
  7. zamba2-1.2b: phases 3-5 again for the hybrid family, at full width and
     full depth (38 Mamba2 layers, the shared attention block applied 7
     times): serving on 256-token and the env's 12-token prompts, K1 on
     every application and K6 on every layer of every prefill, K2 on every
     application of every decode, the routes also compared on an f32 copy;
     three train steps checkpointing each block (K1 and K6 again in the
     backward), K3/K7 on every application and layer, K4 on every loss,
     every gradient leaf nonzero (the shared block's too), step 1 and steps
     1-3 held against the plain route (stale and live behaviour log-probs)
     and again on an f32 copy; one more step on the env's 19-token
     sequences.
  8. the kernel-ops entry point (``repro_torch.kernels.ops``), the one path
     that runs K5: every op on CUDA tensors, its kernel launch counted and
     its result held against the plain route; the two K5 ops on zamba2's
     full-depth f32 action logits of one train micro-batch, against
     ``ref.reference_gipo_loss``, the plain route's autograd, and K4 on the
     same hidden states and head weight.
  9. granite-moe-1b-a400m (moe: 24 layers, d 1024, 32 experts top-8):
     one MoE layer at full width on the card and on a CPU copy (f32: the
     same expert choices and keep masks; bf16: the differing ones
     printed), its dispatch and combine products timed at the training
     shape; phases 3-5 again at full width and full depth (256-token and
     the env's 12-token prompts, K1 and K2 on every layer; three train
     steps of 36 x 256 tokens against the plain route, stale and live μ,
     and an f32 copy; one step on the env's sequences), each printing per
     layer the share of expert choices that agree between the routes and
     the dropped share of assignments.
 10. system: the asynchronous AcceRL system (``AcceRLSystem``) on
     openvla-7b at full width and 8 layers, with no route forced: eight
     rollout workers stepping the toy env against the inference service,
     the prefetcher's pinned copies to the card on a side stream, the
     trainer publishing a snapshot each step; ``run_async`` for 3 steps,
     then ``run_sync`` for 2 on a fresh system. Budgets reached, services
     healthy, weights swapped and fresh, no published leaf aliasing the
     live params, K1-K4's launches at least what the batches and steps
     need, peak memory under 70 GB; step 1 replayed on the plain route
     from the published v0 snapshot (its KL, entropy and grad norm held as
     phase 5 holds live step 1's). One ``[system]`` line a run with
     sps_env, sps_train, the utilisations, the policy lag and the batch
     latency beside the card's name and power limit.
 11. wm: the world-model mode (paper §4) on the system phase's model: the
     world model pre-trained on the card (50 oracle trajectories, 100
     steps; its losses finite and the denoiser's falling), one M_obs and
     one M_reward step held against a CPU copy on the same noise, then
     ``AcceRLWMSystem`` (one imagination worker of batch 16, horizon 2,
     the pure-imagination diet) and ``run_wm`` for 3 steps: the system
     phase's checks, no real segment trained on, imagination behind every
     step (K1 and K2 on every imagined step's prefill and decodes), M_obs
     updated, the WM trees an imagination call may hold never written;
     step 1 replayed on the plain route. One ``[wm]`` line with imagined
     steps per second, the real-env-steps-per-update ratio and the rest.
 12. pipeline (``[pipeline]`` lines): the pipelined executor
     (``rt.pipeline``) on the same model: (a) a pipelined ``TrainerWorker``
     beside a default one from the same seed, three rounds on the training
     phase's batch, each bit for bit the fused step (params, moments,
     Welford state, metrics) with K1/K3/K4 launched as a fused step
     launches them; the bubble, peak micro-grad and live bytes and each
     round's wall printed; (b) ``run_wm`` with ``rt.pipeline``: phase 11's
     checks with every WM cycle run by the executor's WM stream and the
     ``pipeline_*`` metrics; (c) the disjoint layout ``(cuda:0, cpu)``:
     the policy on the card, a toy WM stage on the CPU, the round bit for
     bit the fused step; (d) the 16 x 16 plan's bytes per device for
     full-depth openvla-7b and dbrx-132b (a fake process group in a
     subprocess, trees on ``meta``) beside the card's 80 GB, and the
     one-rank NCCL mesh.
 13. checkpoint: a ``TrainerWorker`` on openvla-7b at full width and 2
     layers (bf16 params, f32 moments) saves its state after each of two
     steps into the temp dir (the reference's ``.npz`` format); the
     state restored onto a meta template equals the live one bit for bit,
     and one more step from each is bit for bit the same. Save and restore
     seconds and GB/s.
 14. sync (the paper's Table 8): publish -> acquire of the system phase's
     weights (3.59 GB of bf16) through the direct, serialized and disk
     transports and over the wire (``WeightStoreTransport`` against a
     ``TransportServer`` through the weight lane, every acquire read from
     the lane), five times each, the acquired tree on the card bit for
     bit; median, p90 and GB/s.
 15. remote: ``AcceRLSystem`` on the system phase's model with two
     spawned rollout children (four envs each, serving on the card:
     their own CUDA contexts) and no local rollout worker, segments over
     the ring data plane and weights over the lane, ``run_async`` for 3
     steps: phase 10's checks with the children's bridged swaps, every
     segment over the wire, every acquire read from the lane, the
     in-process run's metric keys, children exiting 0, /dev/shm left as
     found, step 1 replayed on the plain route; the children's K1/K2
     launches counted in each child and bridged through its reports, at
     least what its batches need.
 16. system on granite-moe-1b-a400m at MOE_SYSTEM_LAYERS of its 24
     layers (cut from full depth to keep the run in its time limit):
     ``run_async`` for 3
     steps, held as phase 10 holds openvla-7b's, with the moe metrics at
     every step; step 1 replayed on the kernel route, the KL of v0 against
     the served μ printed. Then the same on an f32 copy, and on an f32
     copy at capacity_factor E/k, where no assignment drops: there step 1
     is replayed on the plain route, and that KL held as phase 10 holds
     it.
 17. plane (after phase 15, whose figures its first line prints beside
     its own; ``[plane]``, ``[telemetry]``, ``[journal]`` lines): the
     remote phase's two children with no policy and no CUDA context
     (``inference_plane``): (a) host mode, the parent's pool serving
     every request over the server's ``infer.*`` endpoints, 3 steps held
     as phase 10's with K1/K2 counted in the parent alone, nvidia-smi's
     compute processes and the children's memory maps sampled through
     the run, step 1 replayed; (b) a spawned tier (``restart=
     "on_failure"``) SIGKILLed mid-episode and respawned on its port,
     every request resolved once, its acquire seconds and the respawn's
     wall printed; (c) (a) again in a process of its own under
     ``REPRO_TRACE=1``, its dump joining a child's ``rollout.put`` to the
     parent's ``server.apply`` and a version's publish, acquire and first
     action; (d) the journal at 2 layers: a crash-consistent copy taken
     mid-run and a new system with ``resume_journal``, the newest publish
     on the card bit for bit and the items as journaled.

Every check raises on failure, so the script exits non-zero. The line
before the last is a JSON summary of every kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import signal
import statistics
import subprocess
import sys
import threading
import time
import typing

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
# K5's register body against its order of arithmetic
# (kernels/ref.py::tiled_gipo_head_loss, computed on the card): the same
# exponentials and sums in the same order, so the partial rows and f32
# d_logits differ only where the compiler fuses a multiply and an add,
# ~1e-7 of the largest value; held at 2e-6 of each partial column's largest
# value and of d's largest value (bf16 d: plus ORDER_RTOL of each value,
# the kernel rounding its f32 d once).
K5_ORDER_ATOL = 2e-6
# Kernel route vs plain route, max |Δ action logit| over prefill + 7 decode
# steps of openvla-7b in bf16. Measured 0.031 on the H100 with logits of
# magnitude ~3: the two routes round the attention output to bf16 at
# different points, and that difference passes through 32 bf16 layers.
# The bound leaves ~3x room over the measurement.
MODEL_LOGIT_BOUND = 0.1
# K3 and K4 in bf16 against their plain versions (both f32 inside, from the
# same bf16 inputs): the outputs may differ by their own bf16 rounding, one
# ulp (2^-7 relative), plus f32 reordering error, held at 1e-4 of the
# largest value.
BWD_BF16_RTOL = 2.0 ** -7
BWD_BF16_ATOL = 1e-4
# Training phase: openvla-7b at full width and 8 of its 32 layers (the f32
# moments and grad accumulator of the full depth do not fit one card).
TRAIN_LAYERS = 8
TRAIN_MEM_LIMIT = 70e9
# The system phase: train steps of run_async, then of run_sync.
SYSTEM_STEPS = (3, 2)
# The checkpoint phase: openvla-7b at full width and CKPT_LAYERS layers,
# CKPT_STEPS trainer steps each saved (interval 1); keep = CKPT_STEPS
# checkpoints must fit in CKPT_DISK_SHARE of the free disk.
CKPT_LAYERS = 2
CKPT_STEPS = 2
CKPT_DISK_SHARE = 0.25
# The sync phase (the paper's Table 8): publish -> acquire, SYNC_ITERS
# times a transport, on the system tree (openvla-7b, TRAIN_LAYERS layers).
SYNC_ITERS = 5
# The remote phase: run_async's train steps with REMOTE_WORKERS spawned
# rollout children of REMOTE_ENVS envs each on the system tree; the ring
# data plane and the weight lane, which /dev/shm must hold SHM_HEADROOM
# times over (the sync phase's lane too).
REMOTE_STEPS = 3
REMOTE_WORKERS = 2
REMOTE_ENVS = 4
SHM_HEADROOM = 2
PLANE_SMI_PERIOD_S = 1.0          # the plane phase's CUDA-holder sampling
# The world-model phase: run_wm's train steps, the imagination batch, and
# the card-vs-CPU bar of one WM step (of each leaf's largest value, f32).
WM_STEPS = 3
WM_IMAGINATION_BATCH = 16
WM_PARITY_TOL = 1e-4
# The pipeline phase: rounds of the pipelined trainer (openvla-7b at
# TRAIN_LAYERS, each held bit for bit against the fused step), and the
# device memory of one H100 that the 16 x 16 plan's bytes are printed
# beside.
PIPE_ROUNDS = 3
H100_BYTES = 80e9
# Step 1 on the kernel route vs the plain route: the largest relative
# difference over the loss, every metric and the grad norm (denominators
# floored at ROUTE_FLOOR). Measured 4.8e-4 on the H100 (adv_mean_raw; the
# loss 4.0e-4): the routes round attention outputs and gradients to bf16 at
# different points through 8 bf16 layers. The bound leaves ~3x room.
ROUTE_BOUND = 1.5e-3
ROUTE_FLOOR = 1e-3
# Step 1's gradients, kernel vs plain route, per leaf and per layer of each
# stacked leaf: |g_kernel - g_plain| / |g_plain| (Frobenius norms), so a
# wrong dq/dk/dv in one layer cannot hide under the leaves that dominate the
# global norm. Held for every leaf that the kernels' backward reaches, i.e.
# all but the value head, whose input is detached: its gradient sees the
# kernels only through the forward's bf16 rounding of the action tokens'
# hidden states, which is printed beside it. Measured 1.6e-2 on the H100
# (layers.attn.wq[7]); the bound leaves ~3x room. (The value head's
# attention-pool projection measured 0.22: its gradient is a product of the
# action hiddens centred over the 7 positions, 3% of their norm, so their
# 5.6e-3 difference between the routes becomes 0.16 there.)
LEAF_BOUND = 5e-2
# Step 1 again on openvla-7b with live behaviour log-probs: the plain
# route's own action log-probs of the batch plus 0.1 N(0, 1), so ω is near
# 0.9 and the surrogate's gradient, which the stale dummy μ hides (ω ≈ 0),
# carries weight. Set before the first run: the routes' action log-probs
# differ by ~5e-3 (the action hiddens' 5.6e-3), so the near-zero pg loss
# (a mean of ±A over 1568 tokens, ~0.03) and the k3-KL (~5e-3) may differ
# by ~1e-2 relative; the per-leaf bound doubles the stale one's, as the pg
# gradient now adds the routes' log-prob differences.
LIVE_ROUTE_BOUND = 3e-2
LIVE_LEAF_BOUND = 0.1
# Steps 1-3 again on each model with live behaviour log-probs at every step
# (each route's own parameters scored by the plain route, plus the same 0.1
# noise), so that ω stays near 0.9 (held above 0.5 at every step on both
# routes) and no step runs on a blown-up k3-KL. Step 1 holds
# LIVE_ROUTE_BOUND's reasoning; steps 2-3 add the routes' parameter gaps
# after one and two updates, whose per-leaf gradient gaps measured up to
# 6e-2 (zamba2, stale μ), so the step metrics may differ by a few 1e-2: 0.1
# leaves ~2-5x room and still fails a wrong gradient, which moves them by
# O(1). The loss is printed, not held: on live μ its terms nearly cancel
# (mamba2-2.7b's step 1 reads 0.024), so its relative difference measures
# the cancellation, not the kernels (0.109 there with K7's FMA body too).
STEP_KEYS = ("loss", "kl", "entropy", "grad_norm")
LIVE_KEYS = ("kl", "entropy", "grad_norm")
LIVE_STEPS_BOUND = [dict.fromkeys(LIVE_KEYS, LIVE_ROUTE_BOUND)] + [
    dict.fromkeys(LIVE_KEYS, 0.1)] * 2
# The system's step 1 trains on a batch whose behaviour log-probs μ the
# kernel route served (or imagined) from v0, so the step's own k3-KL of v0
# against μ measures only the routes' action log-prob gap Δ (~5e-3, as
# above): KL ≈ E[Δ²]/2 ≈ 1.3e-5, and ω's mean is 1 to within ~|Δ|. Read
# 1.0e-5 to 2.1e-5 (kernel and plain route) and ω 0.9995-0.9998 in the
# system and world-model phases on the H100 (set after those readings).
# The bounds leave ~10x and ~20x room; a serving or imagination kernel that
# is wrong at its shape moves log-probs by O(0.1), a KL of O(1e-3) or more.
REPLAY_KL_BOUND = 2e-4
REPLAY_OMEGA_TOL = 1e-2
# Steps 1-3 from the same seed-0 state on both routes: the largest relative
# difference of the loss, KL, entropy and grad norm per step. Measured
# 6.1e-2 on the H100 (step 2's loss and KL, 6.0e7 vs 5.7e7: the step-2 jump
# amplifies step 1's 4e-4); the bound leaves ~3x room.
STEPS_BOUND = [dict.fromkeys(STEP_KEYS, 0.2)] * 3       # per step, per key
# mamba2-2.7b: serving at full depth (64 layers) on prompts of SSM_OBS
# tokens (two SSD chunks of 128); training at full width and
# SSM_TRAIN_LAYERS of its 64 layers on sequences of SSM_OBS tokens
# (249 observation + 7 action tokens). Full depth would need ~43 GB of
# bf16 params and grads and f32 moments and accumulator before activations.
# Both paths also run on the toy manipulation env's own lengths
# (src/repro/envs/toy_manipulation.py: 12-token prompts, so 12 + 7 = 19
# train tokens), where the SSD kernels take one short chunk.
SSM_OBS = 256
SSM_ENV_OBS = 12
SSM_TRAIN_LAYERS = 16
# Kernel route vs plain route for mamba2-2.7b. The two routes differ only
# in the SSD scan (K6 against the plain chunked form, both f32 inside from
# the same bf16 inputs); bf16 roundings of the block outputs that land on
# either side of a tie then pass through the layers. Serving logits
# measured 0.148 apart on the H100 over 64 layers (max |logit| 3.6; 0.121
# on the env's 12-token prompts), while an f32 copy of the same model gives
# 2.3e-5 between the routes and 0.19 between itself and the bf16 kernel
# route: the gap is bf16 rounding carried through 64 layers, not the
# kernel. Step 1 of training (16 layers): 1.31e-2 over the metrics
# (adv_mean_raw, from the value head, whose input differs by 2e-2; one step
# on the env's 19-token sequences: 1.14e-3) and 5.1e-2 per leaf and layer
# (dt_bias, A_log: per-head sums over every token). Steps 1-3 from the same
# seed: steps 1-2 within 1.03e-2 in loss, KL, entropy and grad norm; by
# step 3 the entropy has collapsed (5.16 -> 1.31) on both routes, which
# still agree to 6e-3 in entropy and 7.9e-2 in grad norm, while the k3-KL
# against the dummy behaviour log-probs, exponential in the log-ratio,
# differs 2x (26.8 vs 13.5, and the loss with it): step 3's loss and KL are
# printed here and held on the f32 copy below. Each bound leaves ~3x room
# over its measurement.
SSM_LOGIT_BOUND = 0.45
SSM_F32_LOGIT_BOUND = 1e-4
SSM_ROUTE_BOUND = 4e-2
SSM_LEAF_BOUND = 0.15
SSM_STEPS_BOUND = [dict.fromkeys(STEP_KEYS, 3e-2)] * 2 + [
    {"entropy": 0.25, "grad_norm": 0.25}]
# The witness for those bf16 gaps: step 1 and steps 1-3 again on an f32
# copy of the 16-layer model, both routes checkpointing each layer, at SSD
# chunk 64 (K7's f32 tiles at chunk 128 need ~280 KB of shared memory).
# The routes then differ only in the order of f32 sums, so every key of
# every step is held, step 3's loss and KL included. Measured on the H100:
# step 1's metrics 1.09e-6 apart (adv_mean_raw), its gradients 1.07e-5 per
# leaf and layer (dt_bias[15]), steps 1-3 5.5e-5 (step 3's loss; its KL
# 5.2e-5, where bf16 gives 2x). The bounds leave ~5x room.
SSM_F32_CHUNK = 64
SSM_F32_BOUNDS = (5e-6, 5e-5, [dict.fromkeys(STEP_KEYS, 3e-4)] * 3)
# zamba2-1.2b (hybrid): serving and training at full depth (38 Mamba2
# layers; the shared attention + MLP block applied 7 times, before every
# 6th layer and once more before the last 2), bf16, on SSM_OBS-token
# prompts and train sequences and on the env's lengths, as mamba2-2.7b; the
# state (~18 GB of bf16 params and f32 moments and accumulator) fits one
# card, and training checkpoints each block on both routes. The routes
# differ in the SSD scan and in the attention kernels' roundings, carried
# through 45 bf16 blocks; the f32 copy (chunk 128: K7's f32 tiles fit at N
# 64) is the witness that those gaps are rounding. The first run held
# mamba2's bounds (0.45, 4e-2, 0.15, SSM_STEPS_BOUND; f32 copy 1e-4, and
# 1e-4 / 1e-3 / 1e-2 for training) and measured on the H100: serving logits
# 0.0357 apart (f32 copy 4.59e-6); step 1 1.49e-3 over the metrics (grad
# norm), 5.95e-2 per leaf and layer (conv_w[25]); steps 1-2 4.1e-3, step 3
# entropy 4.2e-4 and grad norm 3.0e-2; the env step 1.94e-3; the f32 copy
# 1.56e-6 over the metrics, 8.0e-6 per leaf and layer, 3.3e-5 over steps
# 1-3. The bounds below are ~5x those readings (the per-leaf bf16 one stays
# at mamba2's 0.15, 2.5x).
HYB_LOGIT_BOUND = 0.2
HYB_F32_LOGIT_BOUND = 2.5e-5
HYB_ROUTE_BOUND = 1e-2
HYB_LEAF_BOUND = 0.15
HYB_STEPS_BOUND = [dict.fromkeys(STEP_KEYS, 2e-2)] * 2 + [
    {"entropy": 0.15, "grad_norm": 0.15}]
HYB_F32_BOUNDS = (1e-5, 5e-5, [dict.fromkeys(STEP_KEYS, 2e-4)] * 3)
# The witness for openvla-7b's bf16 gaps (its stale step 1 read 1.26e-3
# against ROUTE_BOUND after the Hopper K1/K3 bodies, 4.77e-4 before): step
# 1 and steps 1-3 again on an f32 copy of the 8-layer model, both routes
# checkpointing each layer, where they differ only in the order of f32 sums
# (K1, K3 and K4 run their f32 FMA bodies). Step 1 set before its first
# run as zamba2-1.2b's (1e-5, 5e-5), from the other witnesses' readings
# (mamba2-2.7b 1.09e-6 over the metrics and 1.07e-5 per leaf and layer,
# zamba2-1.2b 1.56e-6 and 8.0e-6). Measured on the H100: step 1 8.36e-7,
# 3.6e-6 per leaf and layer; steps 1-3 8.2e-6 (step 3's grad norm). With
# K4's dh planted 1e-3 too large (scripts/witness_fault.py) steps 1-3 read
# 8.2e-4, 5.9e-4 and 4.3e-4 at most (each the grad norm), so steps 1-3
# are held at 5e-5: ~6x the sound reading, ~9x below the fault's smallest
# step. Each bf16 route's step 1 is also printed against the f32 copy's, to
# tell rounding from a fault in the bf16 gap.
OVLA_F32_BOUNDS = (1e-5, 5e-5, [dict.fromkeys(STEP_KEYS, 5e-5)] * 3)
# granite-moe-1b-a400m (moe: 24 layers, d 1024, 16 query heads over 8 KV
# heads of 64, 32 experts top-8 of expert width 512, capacity_factor 1.25):
# serving and training at full width and full depth, bf16, on MOE_OBS-token
# prompts and train sequences (36 x 256 tokens a micro-batch: 18 groups of
# 512, capacity 160 an expert) and on the env's lengths (one group). The
# state (~2.7 GB of bf16 params, ~16 GB of f32 moments and accumulator)
# fits one card; the plain route checkpoints each layer (both routes' step-1
# gradients are held at once). The routes differ in the attention kernels'
# roundings before each router, so a near-tie in a token's top-8 can flip
# a choice, and through the capacity cumsum shift later tokens' drops. With
# the reference's init (expert weights at fan-in E: ROADMAP C6) a flip
# moves its token by as much as the token itself, so the bf16 routes drift
# apart layer by layer: on the H100 their choices agreed on 99.74-99.77% of
# the first layer's (token, choice) pairs and 67.8% of the last's, and
# their action logits differed by 2.4-3.5 (max |logit| 3.3-3.7). The bf16
# logits are therefore printed, not held; the first layer's agreement is
# held (MOE_AGREE[0]), and the f32 copy, whose routes agreed on every
# choice of the served replays and on >= 99.91% in training, carries the
# route checks (MOE_AGREE[1]; logits read 1.7e-5-4.2e-5 apart). Training
# in bf16, step 1 read 6.76e-2 over the metrics (kl; loss 6.5e-2) and 1.25
# per leaf and layer (moe.router[0]: past the first layers the gradients
# are of different routings, so this bound only catches a blown-up
# gradient), steps 1-3 6.8e-2, 2.1e-2 and 0.194 (grad norm), the env step
# 0.110 (kl); on live μ, scored on each route's own log-probs (ω 0.68-0.79;
# the plain route's log-probs gave the kernel route ω 0.39), entropy within
# 1.4e-3 and grad norm within 0.172, the KL (0.017-0.064) 0.30-1.60 apart,
# printed. The f32 copy's step 1: 2.06e-3 over the metrics (ratio_mean)
# and 2.8e-2 per leaf and layer (attn.wk[20], from the few deep choices
# that flip in f32 too); steps 1-3 from the same seed: step 1's loss and KL
# 1.9e-5, entropy 2.5e-6, grad norm 1.98e-4, while K4's dh planted 1e-3
# too large read 1.20e-3 and its KL coefficient 1% off 1.02e-2 there
# (scripts/witness_fault.py --arch granite-moe-1b-a400m); steps 2-3 read
# 3.0e-2-1.7e-1 sound and planted alike (one update moves each weight by
# ~lr, which flips choices), so they are printed. Bounds are ~3x the
# readings (f32 step 1's grad norm 3x, 2x below the dh fault).
MOE_ARCH = "granite-moe-1b-a400m"
MOE_HEADS = (16, 8, 64)                      # query heads, KV heads, D
MOE_OBS = 256
MOE_AGREE = (0.99, 0.997)                    # bf16 first layer, f32 every
MOE_F32_LOGIT_BOUND = 2e-4
MOE_ROUTE_BOUND = 0.3
MOE_LEAF_BOUND = 4.0
MOE_STEPS_BOUND = [dict.fromkeys(STEP_KEYS, 0.2)] * 2 + [
    dict.fromkeys(STEP_KEYS, 0.6)]
MOE_LIVE_STEPS_BOUND = [{"entropy": 5e-3, "grad_norm": 0.5}] * 3
# granite's three system runs (phase 15) at 12 of its 24 layers, for the
# run's time alone: at full depth they took ~104 s on one H100, and the
# whole run went past 900 s with the plane phase added. At 24 layers the f32
# no-drop replay held its bounds in 3 of 3 runs of a separate call, its
# closest router boundary gap printed (ROADMAP C8)
MOE_SYSTEM_LAYERS = 12
MOE_F32_BOUNDS = (6e-3, 0.1, [{"loss": 1e-4, "kl": 1e-4, "entropy": 1e-5,
                               "grad_norm": 6e-4}, {}, {}])


class Checks(typing.NamedTuple):
    """What the shared phases hold of one model, chosen once in main (a
    dense model's are the defaults). ``agree``: the floors of the routes'
    expert-choice agreement (as MOE_AGREE), or None where no MoE layer
    routes. ``live_own``: live behaviour log-probs scored on each route's
    own run (else on the plain route). ``replay``: the route of the
    system's step-1 replay. ``hold_served``: hold the KL of v0 against the
    served μ (REPLAY_KL_BOUND). ``metric_keys``: metrics every system step
    must carry."""
    agree: tuple | None = None
    live_own: bool = False
    replay: str = "torch"
    hold_served: bool = True
    metric_keys: tuple = ()


DENSE = Checks()
# granite-moe-1b-a400m: its bf16 routes drift apart (above), and in the
# system a serving batch forms other MoE groups than a training
# micro-batch, so other assignments drop: the served-μ KL is printed, and
# step 1 is replayed on the kernel route. The witness of that cause: the
# same on an f32 copy (printed), then on an f32 copy at capacity_factor
# E/k (``_f32_copy(drops=False)``), where every group keeps every
# assignment: MOE_NO_DROPS, replayed on the plain route with the served-μ
# KL held.
MOE = Checks(agree=MOE_AGREE, live_own=True, replay="cuda",
             hold_served=False,
             metric_keys=("moe_load_balance", "moe_dropped_frac"))
MOE_NO_DROPS = MOE._replace(replay="torch", hold_served=True)
# kernel-name patterns that group a traced train step's device time
TRACE_GROUPS = (("K1 flash fwd", ("flash_fwd",)),
                ("K3 flash bwd", ("flash_bwd",)),
                ("K4 policy loss", ("policy_rows", "policy_cluster",
                                    "policy_dw")),
                ("K5 gipo head loss", ("gipo_head",)),
                ("K6 ssd fwd", ("ssd_fwd",)),
                ("K7 ssd bwd", ("ssd_bwd",)),
                ("K7 head sum", ("ssd_head_sum",)),
                ("GEMM", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce",)),
                ("index/embedding", ("index", "embedding", "scatter",
                                     "gather")))
# parameter subtrees stacked on a leading layer axis
STACKED = ("layers", "layers_rem")
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
    print(f"[device] {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"kernel build {t_build:.1f} s")
    for ln in _ptxas_kernels(build.build_log):
        print(f"[build] {ln}")
    return name, smi


def _ptxas_kernels(log: str):
    """One line a kernel from ptxas -v's output: its mangled name's
    readable part, registers, stack frame and spills."""
    import re
    out, fn, frame = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        if "spill stores" in ln:
            frame = ln.strip()
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            out.append(f"{_kernel_name(fn)}: {m.group(1)} registers | "
                       f"{frame}")
            fn, frame = None, ""
    return out


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled function and its template
    arguments as mangled (``policy_cluster_kernel<Lb1E>``)."""
    import re
    i, name = 2 + (mangled[2:3] == "N"), mangled
    while True:
        m = re.match(r"\d+", mangled[i:])
        if not m:
            break
        n = int(m.group())
        name = mangled[i + len(m.group()):i + len(m.group()) + n]
        i += len(m.group()) + n
    if mangled[i:i + 1] == "I":
        name += "<" + mangled[i + 1:mangled.find("E", i) + 1] + ">"
    return name


def _lib_layout(*ts):
    """[B, T, H, D] tensors as the library's [B, H, T, D], contiguous."""
    return [x.transpose(1, 2).contiguous() for x in ts]


# the library's fused attention backends, in the order the GQA timings try
# them with grouped K/V as they are (enable_gqa=True)
SDPA_FUSED = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def _time_sdpa(q, k, v, flush, **kw):
    """Median device ms of the library's attention on [B, T, H, D] inputs
    (``kw``: ``is_causal`` or ``attn_mask``), the form that ran, and for
    grouped K/V the same call on K/V repeated to the query heads
    beforehand (the repeat not timed; else None). Equal head counts: one
    call, the library choosing its backend. Grouped K/V: ``enable_gqa`` on
    K/V as they are, under the first of SDPA_FUSED that takes the call;
    only if none does, the repeated form."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = _lib_layout(q, k, v)
    if k.shape[2] == q.shape[2]:
        return _median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), flush=flush)[0], "sdpa", None
    rep = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
    rep_ms = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kr, vr, **kw), flush=flush)[0]
    for name in SDPA_FUSED:
        with sdpa_kernel([getattr(SDPBackend, name)]), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a backend's refusal
            try:
                F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                               **kw)
            except RuntimeError:
                continue
            return _median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **kw), flush=flush)[0], \
                f"sdpa gqa {name.lower()}", rep_ms
    return rep_ms, "sdpa, K/V repeated", None


def _lib_line(lib, lib_ms, rep_ms):
    """The library's time for a kernel's line; the repeated form beside
    the grouped one."""
    return f"{lib} {lib_ms:.4f} ms" + (
        "" if rep_ms is None else f" (K/V repeated beforehand {rep_ms:.4f})")


def _time_flash(case, flush, *, lse: bool = False):
    """Kernel, plain version and library call on one bf16 causal case;
    ``lse`` times the training forward, which also writes the LSE."""
    from repro_torch.kernels.flash_attention import (_plain_dense,
                                                     flash_attention)
    q, k, v = case["q"], case["k"], case["v"]
    b, t, h, d = q.shape
    ms, host_ms = _median_ms(lambda: flash_attention(q, k, v, return_lse=lse),
                             flush=flush)
    plain_ms, _ = _median_ms(lambda: _plain_dense(q, k, v, return_lse=lse),
                             flush=flush)
    lib_ms, lib, rep_ms = _time_sdpa(q, k, v, flush, is_causal=True)
    pairs = t * (t + 1) // 2                       # causal (q, k) pairs
    bound_ms, bound_by = _bound(_nbytes(q, k, v, q) + lse * b * t * h * 4,
                                4.0 * d * pairs * b * h, "bfloat16")
    shape = f"B={b} T=S={t} H={h} KV={k.shape[2]} D={d} bf16" \
        + (" +lse" if lse else "")
    print(f"[kernels] flash {shape}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | {_lib_line(lib, lib_ms, rep_ms)} | bound "
          f"{bound_ms:.4f} ms ({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, library=lib,
                library_repeated_ms=rep_ms)


def _time_decode(case, flush):
    """Kernel, plain version and library call on one bf16 decode case."""
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention)
    q, k, v, valid = case["q"], case["k"], case["v"], case["valid"]
    b, _, h, d = q.shape
    ms, host_ms = _median_ms(lambda: decode_attention(q, k, v, valid),
                             flush=flush)
    plain_ms, _ = _median_ms(lambda: _plain_decode(q, k, v, valid),
                             flush=flush)
    lib_ms, lib, rep_ms = _time_sdpa(q, k, v, flush,
                                     attn_mask=valid[:, None, None, :])
    # the output needs K and V rows of this run's valid slots only
    n_valid = int(valid.sum().item())
    kv_row = k.shape[2] * d * k.element_size()
    bound_ms, bound_by = _bound(_nbytes(q, valid, q) + 2 * n_valid * kv_row,
                                4.0 * d * h * n_valid, "bfloat16")
    shape = f"B={b} S={k.shape[1]} H={h} KV={k.shape[2]} D={d} bf16"
    print(f"[kernels] decode {shape}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | {_lib_line(lib, lib_ms, rep_ms)} | bound "
          f"{bound_ms:.4f} ms ({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, library=lib,
                library_repeated_ms=rep_ms)


def _time_flash_bwd(case, flush):
    """K3, its plain version and the library's flash backward (fed by the
    library's own forward, timed alone; grouped K/V as they are where the
    op takes them, else repeated) on one bf16 causal case. K3 is
    timed twice: the wrapper's call (everything it puts on the stream) and
    its kernels' own launch on buffers allocated beforehand; the gap is
    work outside the kernels."""
    import torch
    from repro_torch.kernels.flash_attention import (_launch_bwd,
                                                     _plain_flash_bwd,
                                                     flash_attention_bwd)
    q, k, v, o, lse, do = (case[x] for x in ("q", "k", "v", "o", "lse",
                                             "do"))
    b, t, h, d = q.shape
    ms, host_ms = _median_ms(
        lambda: flash_attention_bwd(q, k, v, o, lse, do), flush=flush)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    aux = torch.empty((2, b, h, -(-t // 64) * 64), dtype=torch.float32,
                      device=q.device)
    kernels_ms, _ = _median_ms(
        lambda: _launch_bwd(q, k, v, o, lse, do, aux, *grads, True, None),
        flush=flush)
    plain_ms, _ = _median_ms(
        lambda: _plain_flash_bwd(q, k, v, o, lse, do), flush=flush)
    qt, kt, vt, dot = _lib_layout(q, k, v, do)

    def lib_bwd(kt, vt):
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True)
        lo, llse, cq, ck, mq, mk, seed, offset = fwd[:8]
        return _median_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, lo, llse, cq, ck, mq, mk, 0.0, True, seed,
                offset), flush=flush)[0]
    rep_ms = None
    if k.shape[2] != h:
        rep_ms = lib_bwd(*(x.repeat_interleave(h // k.shape[2], dim=1)
                           for x in (kt, vt)))
    try:                    # grouped K/V as they are, where the op takes it
        lib_ms, lib = lib_bwd(kt, vt), "sdpa flash bwd"
    except RuntimeError:
        lib_ms, lib, rep_ms = rep_ms, "sdpa flash bwd, K/V repeated", None
    pairs = t * (t + 1) // 2                 # causal (q, k) pairs per head
    bound_ms, bound_by = _bound(
        _nbytes(q, k, v, o, lse, do) + _nbytes(q, k, v),
        10.0 * d * pairs * b * h, "bfloat16")
    shape = f"B={b} T=S={t} H={h} KV={k.shape[2]} D={d} bf16"
    print(f"[kernels] flash_bwd {shape}: kernel {ms:.4f} ms (its kernels' "
          f"own device time {kernels_ms:.4f}) | plain {plain_ms:.4f} ms | "
          f"{_lib_line(lib, lib_ms, rep_ms)} | bound {bound_ms:.4f} ms "
          f"({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, kernels_ms=kernels_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library=lib, library_repeated_ms=rep_ms)


def _time_policy(case, flush):
    """K4 forward and backward, their plain versions, and the unfused route
    a user would otherwise write (cuBLAS's product to bf16 logits, then K5;
    backward: the product, K5's backward and the two products of dh and
    dw) on one bf16 case. No single PyTorch call computes the fused head +
    GIPO loss, so there is no library time; the unfused route is the
    yardstick of fusion. The body is "one body" for a K4 that has no
    ``policy_body`` query (an older tree, timed by
    scripts/time_policy_loss.py)."""
    import torch
    from repro_torch.kernels import gipo_loss as gl
    args = [case[x] for x in ("h", "w", "tg", "lo", "ad", "mk")]
    coefs = case["coefs"]
    h, w, rows = args[0], args[1], args[2:]
    n, d = h.shape
    va = w.shape[1]
    query = getattr(gl, "policy_body", None)
    body = query(h, w) if query else "one body"

    def unfused_fwd():
        return gl.gipo_head_fwd(torch.matmul(h, w), *rows, 0.2)

    def unfused_bwd():
        dl = gl.gipo_head_bwd(torch.matmul(h, w), *rows, 0.2, coefs)
        return torch.matmul(dl, w.T), torch.matmul(h.T, dl)
    part_rows = gl.policy_loss_fwd(*args, 0.2).shape[0]
    out = {}
    for tag, kern, plain, extra, nflop, outs, unfused in (
            ("fwd", gl.policy_loss_fwd, gl._plain_policy_loss_fwd, (),
             2.0 * n * d * va, part_rows * 8 * 4, unfused_fwd),
            ("bwd", gl.policy_loss_bwd, gl._plain_policy_loss_bwd, (coefs,),
             6.0 * n * d * va, _nbytes(h, w), unfused_bwd)):
        ms, host_ms = _median_ms(lambda: kern(*args, 0.2, *extra),
                                 flush=flush)
        plain_ms, _ = _median_ms(lambda: plain(*args, 0.2, *extra),
                                 flush=flush)
        unfused_ms, _ = _median_ms(unfused, flush=flush)
        bound_ms, bound_by = _bound(_nbytes(*args, *extra) + outs, nflop,
                                    "bfloat16")
        shape = f"N={n} d={d} Va={va} bf16"
        print(f"[kernels] policy_loss_{tag} {shape}: kernel {ms:.4f} ms "
              f"({body}) | plain {plain_ms:.4f} ms | unfused cuBLAS + K5 "
              f"{unfused_ms:.4f} ms | library none | bound {bound_ms:.4f} ms "
              f"({bound_by}) | host enqueue {host_ms:.4f} ms")
        out[tag] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, unfused_ms=unfused_ms, body=body)
    return out


def _policy_case(gen, dev, n, d, va, dtype, *, stale=False):
    """K4's inputs. ``logp_old`` is the logits' own log-prob of the target
    plus 0.1 N(0, 1) (|log ρ| / σ about 0.5: ω near 0.9, the surrogate
    carries weight), or, ``stale``, -5 ± 0.3, far from the log-probs near
    -6 ± 1 (ω near 0)."""
    import torch
    from repro_torch.kernels.gipo_loss import _logits32
    h = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, va, generator=gen, device=dev) * d ** -0.5).to(dtype)
    tg = torch.randint(0, va, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    noise = torch.randn(n, generator=gen, device=dev)
    if stale:
        lo = noise * 0.3 - 5.0
    else:
        logp = torch.log_softmax(_logits32(h, w), dim=-1)
        lo = logp.gather(1, tg.long()[:, None])[:, 0] + 0.1 * noise
    return dict(
        h=h, w=w, tg=tg, lo=lo,
        ad=torch.randn(n, generator=gen, device=dev),
        mk=(torch.rand(n, generator=gen, device=dev) > 0.15).float(),
        coefs=torch.tensor([0.7, 0.1, -0.01], device=dev) / n)


def _check_grad(name, got, exp, dtype):
    """f32: max abs err <= F32_MAX_ERR, and <= F32_MAX_ERR of the largest
    value where that is below 1; bf16: within BWD_BF16_RTOL of each value
    (the output's own rounding) plus BWD_BF16_ATOL of the largest value
    (f32 reordering). Returns (max abs err, error beyond the bar's
    rounding term as a fraction of the largest value)."""
    import torch
    err = (got.float() - exp.float()).abs()
    scale = exp.float().abs().max().item()
    if dtype == torch.float32:
        worst = err.max().item()
        if not worst <= F32_MAX_ERR * min(1.0, scale):
            raise AssertionError(f"{name}: f32 max abs err {worst} > "
                                 f"{F32_MAX_ERR} x min(1, {scale})")
        return worst, worst / max(scale, 1e-30)
    excess = (err - BWD_BF16_RTOL * exp.float().abs()).max().item() \
        / max(scale, 1e-30)
    if not excess <= BWD_BF16_ATOL:
        raise AssertionError(f"{name}: bf16 error {excess} of the largest "
                             f"value beyond {BWD_BF16_RTOL} relative > "
                             f"{BWD_BF16_ATOL}")
    return err.max().item(), excess


def phase_kernels(dev):
    """Each kernel against its plain version; returns the JSON entries."""
    import torch
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention,
                                                      split_layout)
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
    # (36, 275): the training forward's shape; its checked inputs and
    # outputs feed K3's check and both timings at that shape. (16, 13):
    # imagination's prefill; (24, 20): the training forward on an imagined
    # micro-batch (8 segments x H+1 steps of 20 tokens)
    k1, train_in = {}, {}
    for (b, t, h, kv, d, window) in [(8, 268, 32, 32, 128, None),
                                     (8, 268, 32, 8, 128, None),
                                     (8, 268, 32, 32, 128, 64),
                                     (8, 13, 32, 32, 128, None),
                                     (16, 13, 32, 32, 128, None),
                                     (24, 20, 32, 32, 128, None),
                                     (36, 275, 32, 32, 128, None)]:
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
                # bf16 at D 128: the Hopper body's base-2 softmax
                ref, _ = tiled_softmax_attention(qe, ke, v, ok[None, None],
                                                 base2=True)
                excess = _check_order(tag, got, ref)
                order = (f" | kernel order: max abs err "
                         f"{(got.float() - ref).abs().max().item():.3e}, "
                         f"beyond half an ulp {excess:.3e}")
            print(f"[kernels] {tag}: max abs err {err:.3e} lse {lse_err:.3e}"
                  f"{order}")
            if (kv, window, dtype) == (32, None, torch.bfloat16):
                k1[b, t] = dict(q=q, k=k, v=v, err=err)
            if b in (24, 36):
                train_in[b, dtype] = (q, k, v, out, lse)
            del q, k, v, out, lse, exp, exp_lse
    entries = [dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:40",
                    launches=None, max_abs_err=k1[8, 268]["err"],
                    **_time_flash(k1[8, 268], flush),
                    service=_time_flash(k1[8, 13], flush),
                    imagination=dict(_time_flash(k1[16, 13], flush),
                                     max_abs_err=k1[16, 13]["err"]),
                    train_shape=dict(_time_flash(k1[36, 275], flush,
                                                 lse=True),
                                     max_abs_err=k1[36, 275]["err"]),
                    imagined_train=dict(_time_flash(k1[24, 20], flush,
                                                    lse=True),
                                        max_abs_err=k1[24, 20]["err"]))]
    del k1

    # --- K2 decode attention ------------------------------------------------
    # (16, 20): imagination's decode over its 13 + 7 slot cache
    k2 = {}
    for (b, s, h, kv, d) in [(8, 275, 32, 32, 128), (8, 275, 32, 8, 128),
                             (8, 20, 32, 32, 128), (16, 20, 32, 32, 128)]:
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
                    qe, ke, v, valid[:, None, None, :],
                    split=split_layout(s)[1] * 64)
                excess = _check_order(tag, got, ref)
                order = (f" | kernel order: max abs err "
                         f"{(got.float() - ref).abs().max().item():.3e}, "
                         f"beyond half an ulp {excess:.3e}")
            print(f"[kernels] {tag}: max abs err {err:.3e}{order}")
            if (kv, dtype) == (32, torch.bfloat16):
                k2[b, s] = dict(q=q, k=k, v=v, valid=valid, err=err)
    entries.append(dict(name="decode_attention", route="cuda",
                        source="src/repro_torch/csrc/decode_attention.cu",
                        replaces="src/repro/kernels/decode_attention.py:38",
                        launches=None, max_abs_err=k2[8, 275]["err"],
                        **_time_decode(k2[8, 275], flush),
                        service=_time_decode(k2[8, 20], flush),
                        imagination=dict(_time_decode(k2[16, 20], flush),
                                         max_abs_err=k2[16, 20]["err"])))

    # --- K3 flash attention backward ----------------------------------------
    from repro_torch.kernels.flash_attention import (_plain_flash_bwd,
                                                     flash_attention_bwd)
    k3 = {}
    for (b, t, h, kv, d, window) in [(36, 275, 32, 32, 128, None),
                                     (24, 20, 32, 32, 128, None),
                                     (4, 275, 32, 8, 128, None),
                                     (2, 100, 8, 2, 64, 32),
                                     (3, 50, 4, 4, 128, None)]:
        for dtype in (torch.float32, torch.bfloat16):
            if b in (24, 36):              # K1's checked training cases
                q, k, v, o, lse = train_in.pop((b, dtype))
            else:
                q = rand(b, t, h, d, dtype=dtype)
                k = rand(b, t, kv, d, dtype=dtype)
                v = rand(b, t, kv, d, dtype=dtype)
                o, lse = flash_attention(q, k, v, window=window,
                                         return_lse=True)
            do = rand(b, t, h, d, dtype=dtype)
            got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
            exp = _plain_flash_bwd(q, k, v, o, lse, do, window=window)
            torch.cuda.synchronize()
            tag = f"flash_bwd B={b} T=S={t} H={h} KV={kv} D={d} " \
                  f"w={window} {str(dtype)[6:]}"
            res = [_check_grad(f"{tag} {n}", x, y, dtype)
                   for n, x, y in zip(("dq", "dk", "dv"), got, exp)]
            print(f"[kernels] {tag}: max abs err dq {res[0][0]:.3e} dk "
                  f"{res[1][0]:.3e} dv {res[2][0]:.3e} | beyond the bar's "
                  f"rounding term, of the largest value: "
                  f"{max(r[1] for r in res):.3e}")
            if b in (24, 36) and dtype == torch.bfloat16:
                k3[b] = dict(q=q, k=k, v=v, o=o, lse=lse, do=do,
                             err=max(r[0] for r in res))
            del q, k, v, do, o, lse, got, exp
    entries.append(dict(name="flash_attention_bwd", route="cuda",
                        source="src/repro_torch/csrc/flash_attention_bwd.cu",
                        replaces="src/repro/kernels/flash_attention.py:176",
                        launches=None, max_abs_err=k3[36]["err"],
                        **_time_flash_bwd(k3[36], flush),
                        imagined_train=dict(_time_flash_bwd(k3[24], flush),
                                            max_abs_err=k3[24]["err"])))
    del k3

    # --- K4 fused policy loss -----------------------------------------------
    from repro_torch.kernels import gipo_loss as gl
    k4 = {}
    # N 112: a micro-batch of imagined segments (8 x H 2 x 7 action
    # tokens), whose last 32-row tile is ragged
    for (n, d, va, stale) in [(224, 4096, 256, False),
                              (112, 4096, 256, False),
                              (3584, 4096, 256, False),
                              (224, 2560, 256, False),
                              (224, 2048, 256, False),
                              (224, 1024, 256, False), (300, 64, 48, False),
                              (37, 128, 128, False), (224, 4096, 256, True)]:
        for dtype in (torch.float32, torch.bfloat16):
            c = _policy_case(gen, dev, n, d, va, dtype, stale=stale)
            args = [c[x] for x in ("h", "w", "tg", "lo", "ad", "mk")]
            got = gl._finalize(gl.policy_loss_fwd(*args, 0.2).sum(0))
            exp = gl._finalize(gl._plain_policy_loss_fwd(*args, 0.2).sum(0))
            dh, dw = gl.policy_loss_bwd(*args, 0.2, c["coefs"])
            dh2, dw2 = gl.policy_loss_bwd(*args, 0.2, c["coefs"])
            edh, edw = gl._plain_policy_loss_bwd(*args, 0.2, c["coefs"])
            torch.cuda.synchronize()
            tag = f"policy_loss N={n} d={d} Va={va} " \
                  f"{'stale' if stale else 'live'} {str(dtype)[6:]}"
            omega = got[3]["omega_mean"].item()
            if not stale and not omega > 0.5:
                raise AssertionError(f"{tag}: omega mean {omega} <= 0.5: "
                                     f"the surrogate term is not live")
            vals = list(got[:3]) + [got[3][x] for x in sorted(got[3])]
            evals = list(exp[:3]) + [exp[3][x] for x in sorted(exp[3])]
            ferr = max(abs(x.item() - y.item()) / max(abs(y.item()), 1.0)
                       for x, y in zip(vals, evals))
            if not ferr <= F32_MAX_ERR:
                raise AssertionError(f"{tag}: forward rel err {ferr}")
            res = [_check_grad(f"{tag} {nm}", x, y, dtype)
                   for nm, x, y in (("dh", dh, edh), ("dw", dw, edw))]
            if not (torch.equal(dh, dh2) and torch.equal(dw, dw2)):
                raise AssertionError(f"{tag}: two backward runs differ")
            print(f"[kernels] {tag} ({gl.policy_body(c['h'], c['w'])}): "
                  f"omega mean {omega:.3f} | forward rel "
                  f"err {ferr:.3e} | max abs err dh {res[0][0]:.3e} dw "
                  f"{res[1][0]:.3e} | beyond the bar's rounding term, of the "
                  f"largest value: {max(r[1] for r in res):.3e} | two runs "
                  f"equal")
            if dtype == torch.bfloat16 and d >= 1024 and not stale:
                if gl.policy_body(c["h"], c["w"]) != "tensor cores":
                    raise AssertionError(f"{tag}: not on the tensor-core "
                                         f"body")
                k4[n, d] = dict(c, err=max([ferr] + [r[0] for r in res]))
            del c, args, dh, dw, dh2, dw2, edh, edw
    t224, t112, t3584, t2560, t2048, t1024 = (
        _time_policy(k4[key], flush) for key in
        ((224, 4096), (112, 4096), (3584, 4096), (224, 2560), (224, 2048),
         (224, 1024)))
    for tag in ("fwd", "bwd"):
        entries.append(dict(
            name=f"fused_policy_loss_{tag}", route="cuda",
            source="src/repro_torch/csrc/gipo_loss.cu",
            replaces=("src/repro/kernels/gipo_loss.py:301" if tag == "fwd"
                      else "src/repro/kernels/gipo_loss.py:312"),
            launches=None, max_abs_err=max(v["err"] for v in k4.values()),
            **t224[tag], imagined_batch=t112[tag], large_batch=t3584[tag],
            mamba2_width=t2560[tag],
            zamba2_width=t2048[tag], granite_moe_width=t1024[tag]))
    del k4
    entries += _gipo_head_kernels(gen, dev, flush)
    z = _zamba2_attention(gen, dev, flush)
    g = _granite_attention(gen, dev, flush)
    for e, key in zip(entries[:3], ("flash", "decode", "flash_bwd")):
        e["zamba2"], e["granite_moe"] = z[key], g[key]
        e["max_abs_err"] = max(e["max_abs_err"], z[key]["max_abs_err"],
                               g[key]["max_abs_err"])
    # mamba2-2.7b's SSD (H 80, P 64, N 128), then zamba2-1.2b's (H 64, P 64,
    # N 64: K7's f32 tiles fit chunk 128 there, 199 KB)
    k6, k7 = _ssd_kernels(gen, dev, flush, "mamba2", 80, 64, 128, 64)
    z6, z7 = _ssd_kernels(gen, dev, flush, "zamba2", 64, 64, 64, 128)
    entries += [
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:36", launches=None,
             **dict(k6, max_abs_err=max(k6["max_abs_err"],
                                        z6["max_abs_err"])),
             zamba2=z6),
        dict(name="ssd_scan_bwd", route="cuda",
             source="src/repro_torch/csrc/ssd_scan_bwd.cu",
             replaces="src/repro/kernels/ssd_scan.py:143", launches=None,
             **dict(k7, max_abs_err=max(k7["max_abs_err"],
                                        z7["max_abs_err"])),
             zamba2=z7)]
    del l2
    return entries


def _zamba2_attention(gen, dev, flush):
    """K1, K2 and K3 at zamba2-1.2b's shared attention block (32 heads MHA,
    head_dim 64), f32 and bf16, each against its plain version: K1 on the
    serving prompt (B8 T256, causal and not), the env's prompt (B8 T12) and
    the training shape (B36 T256, with the LSE), K3 at the training shape,
    K2 over the serving cache (B8 S263). Returns bf16 timings by kernel."""
    import torch
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention)
    from repro_torch.kernels.flash_attention import (_plain_dense,
                                                     _plain_flash_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    h, d = 32, 64
    keep, errs = {}, dict.fromkeys(("k1", "k2", "k3"), 0.0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for b, t, causal in ((8, 256, True), (8, 256, False),
                         (8, SSM_ENV_OBS, True), (36, 256, True)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rand(b, t, h, d, dtype=dtype) for _ in range(3))
            out, lse = flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
            exp, exp_lse = _plain_dense(q, k, v, causal=causal,
                                        return_lse=True)
            torch.cuda.synchronize()
            tag = f"zamba2 flash B={b} T=S={t} H={h} D={d} " \
                  f"causal={causal} {str(dtype)[6:]}"
            err = _check_close(tag, out, exp, dtype)
            lse_err = (lse - exp_lse).abs().max().item()
            if not lse_err <= 1e-3:
                raise AssertionError(f"{tag}: lse err {lse_err}")
            errs["k1"] = max(errs["k1"], err)
            print(f"[kernels] {tag}: max abs err {err:.3e} lse "
                  f"{lse_err:.3e}")
            if causal and dtype == torch.bfloat16:
                keep[b, t] = dict(q=q, k=k, v=v)
            if b == 36:
                do = rand(b, t, h, d, dtype=dtype)
                got = flash_attention_bwd(q, k, v, out, lse, do)
                exp = _plain_flash_bwd(q, k, v, out, lse, do)
                torch.cuda.synchronize()
                tag = f"zamba2 flash_bwd B={b} T=S={t} H={h} D={d} " \
                      f"{str(dtype)[6:]}"
                res = [_check_grad(f"{tag} {n}", x, y, dtype)
                       for n, x, y in zip(("dq", "dk", "dv"), got, exp)]
                errs["k3"] = max([errs["k3"]] + [r[0] for r in res])
                print(f"[kernels] {tag}: max abs err dq {res[0][0]:.3e} dk "
                      f"{res[1][0]:.3e} dv {res[2][0]:.3e} | beyond the "
                      f"bar's rounding term, of the largest value: "
                      f"{max(r[1] for r in res):.3e}")
                if dtype == torch.bfloat16:
                    keep["bwd"] = dict(q=q, k=k, v=v, o=out, lse=lse, do=do)
                del do, got
            del q, k, v, out, lse, exp, exp_lse
    b, s = 8, 256 + 7
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(b, 1, h, d, dtype=dtype)
        k, v = (rand(b, s, h, d, dtype=dtype) for _ in range(2))
        valid = torch.rand(b, s, generator=gen, device=dev) > 0.3
        valid[:, 0] = True
        got = decode_attention(q, k, v, valid)
        exp = _plain_decode(q, k, v, valid)
        torch.cuda.synchronize()
        tag = f"zamba2 decode B={b} S={s} H={h} KV={h} D={d} " \
              f"{str(dtype)[6:]}"
        errs["k2"] = max(errs["k2"], _check_close(tag, got, exp, dtype))
        print(f"[kernels] {tag}: max abs err {errs['k2']:.3e}")
        keep["decode"] = dict(q=q, k=k, v=v, valid=valid)
    return dict(
        flash=dict(_time_flash(keep[8, 256], flush), max_abs_err=errs["k1"],
                   env_prompt=_time_flash(keep[8, SSM_ENV_OBS], flush),
                   train_shape=_time_flash(keep[36, 256], flush, lse=True)),
        decode=dict(_time_decode(keep["decode"], flush),
                    max_abs_err=errs["k2"]),
        flash_bwd=dict(_time_flash_bwd(keep["bwd"], flush),
                       max_abs_err=errs["k3"]))


def _granite_attention(gen, dev, flush):
    """K1, K2 and K3 at granite-moe-1b-a400m's attention (16 query heads,
    8 KV heads, head_dim 64: GQA at D 64), f32 and bf16, each against its
    plain version: K1 on the serving prompts (B8 T256, the env's T12 and
    the system's T13: a frame and the env's 12 tokens) and the training
    shapes (B36 T256, the env's T19 and the system's T20, with the LSE),
    K3 at the three training shapes, K2 over the serving caches (B8 S263,
    S19 and the system's longest, S20). Returns bf16 timings by kernel."""
    import torch
    from repro_torch.kernels.decode_attention import (_plain_decode,
                                                      decode_attention)
    from repro_torch.kernels.flash_attention import (_plain_dense,
                                                     _plain_flash_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    h, kv, d = MOE_HEADS
    keep, errs = {}, dict.fromkeys(("k1", "k2", "k3"), 0.0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    sys_t = SSM_ENV_OBS + 1                  # the system's prompt
    for b, t in ((8, MOE_OBS), (8, SSM_ENV_OBS), (8, sys_t), (36, MOE_OBS),
                 (36, SSM_ENV_OBS + 7), (36, sys_t + 7)):
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(b, t, h, d, dtype=dtype)
            k, v = (rand(b, t, kv, d, dtype=dtype) for _ in range(2))
            out, lse = flash_attention(q, k, v, return_lse=True)
            exp, exp_lse = _plain_dense(q, k, v, return_lse=True)
            torch.cuda.synchronize()
            tag = f"granite flash B={b} T=S={t} H={h} KV={kv} D={d} " \
                  f"{str(dtype)[6:]}"
            err = _check_close(tag, out, exp, dtype)
            lse_err = (lse - exp_lse).abs().max().item()
            if not lse_err <= 1e-3:
                raise AssertionError(f"{tag}: lse err {lse_err}")
            errs["k1"] = max(errs["k1"], err)
            line = f"[kernels] {tag}: max abs err {err:.3e} lse {lse_err:.3e}"
            if dtype == torch.bfloat16:
                keep[b, t] = dict(q=q, k=k, v=v)
            if b == 36:
                do = rand(b, t, h, d, dtype=dtype)
                got = flash_attention_bwd(q, k, v, out, lse, do)
                exp = _plain_flash_bwd(q, k, v, out, lse, do)
                torch.cuda.synchronize()
                res = [_check_grad(f"{tag} {n}", x, y, dtype)
                       for n, x, y in zip(("dq", "dk", "dv"), got, exp)]
                errs["k3"] = max([errs["k3"]] + [r[0] for r in res])
                line += (f" | flash_bwd max abs err dq {res[0][0]:.3e} dk "
                         f"{res[1][0]:.3e} dv {res[2][0]:.3e}, beyond the "
                         f"bar's rounding term {max(r[1] for r in res):.3e}")
                if dtype == torch.bfloat16:
                    keep["bwd", t] = dict(q=q, k=k, v=v, o=out, lse=lse,
                                          do=do)
                del do, got
            print(line)
            del q, k, v, out, lse, exp, exp_lse
    for s_len in (MOE_OBS + 7, SSM_ENV_OBS + 7, sys_t + 7):
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(8, 1, h, d, dtype=dtype)
            k, v = (rand(8, s_len, kv, d, dtype=dtype) for _ in range(2))
            valid = torch.rand(8, s_len, generator=gen, device=dev) > 0.3
            valid[:, 0] = True
            err = _check_close(
                f"granite decode S={s_len}", decode_attention(q, k, v, valid),
                _plain_decode(q, k, v, valid), dtype)
            errs["k2"] = max(errs["k2"], err)
            print(f"[kernels] granite decode B=8 S={s_len} H={h} KV={kv} "
                  f"D={d} {str(dtype)[6:]}: max abs err {err:.3e}")
            keep["decode", s_len] = dict(q=q, k=k, v=v, valid=valid)
    env_t = SSM_ENV_OBS + 7
    return dict(
        flash=dict(_time_flash(keep[8, MOE_OBS], flush),
                   max_abs_err=errs["k1"],
                   env_prompt=_time_flash(keep[8, SSM_ENV_OBS], flush),
                   train_shape=_time_flash(keep[36, MOE_OBS], flush,
                                           lse=True),
                   env_train_shape=_time_flash(keep[36, env_t], flush,
                                               lse=True),
                   system=_time_flash(keep[8, sys_t], flush),
                   system_train_shape=_time_flash(keep[36, sys_t + 7], flush,
                                                  lse=True)),
        decode=dict(_time_decode(keep["decode", MOE_OBS + 7], flush),
                    max_abs_err=errs["k2"],
                    env_prompt=_time_decode(keep["decode", env_t], flush),
                    system=_time_decode(keep["decode", sys_t + 7], flush)),
        flash_bwd=dict(_time_flash_bwd(keep["bwd", MOE_OBS], flush),
                       max_abs_err=errs["k3"],
                       env_train_shape=_time_flash_bwd(keep["bwd", env_t],
                                                       flush),
                       system_train_shape=_time_flash_bwd(
                           keep["bwd", sys_t + 7], flush)))


# K5 at the reference tests' ragged shapes (tests/test_dispatch.py), the
# action head's one train micro-batch (N 224 x Va 256) and
# benchmarks/fused_loss.py's FULL_SHAPES
K5_SHAPES = ((257, 48), (300, 64), (100, 256), (224, 256), (16384, 256),
             (65536, 256), (16384, 1024))


# K5's backward is held under each loss term alone, so that none hides
# under another (on stale data the k3-KL's gradient dwarfs the rest), and
# under the three together: (c_pg, c_kl, c_ent) / N
K5_COEFS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
            (0.7, 0.1, -0.01))


def _head_case(gen, dev, n, v, dtype, stale):
    """K5's inputs: logits at the scale of a trained action head, row 0's
    target past V (the reference's one-hot matches nothing), row 1 masked.
    logp_old lies within 0.1 of the logits' own log-prob of the target
    (|log ρ| / σ about 0.5: ω near 1, the surrogate carries weight), or,
    ``stale``, at -3 ± 0.3, far from it (ω near 0, the k3-KL's gradient up
    to ~1e3)."""
    import torch
    from repro_torch.kernels.gipo_loss import _softmax_rows
    tg = torch.randint(0, v, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    tg[0] = v
    mk = (torch.rand(n, generator=gen, device=dev) > 0.15).float()
    mk[1] = 0.0
    logits = (torch.randn(n, v, generator=gen, device=dev) * 3).to(dtype)
    noise = torch.randn(n, generator=gen, device=dev)
    lo = (noise * 0.3 - 3.0 if stale
          else _softmax_rows(logits.float(), tg)[3] + 0.1 * noise)
    return [logits, tg, lo, torch.randn(n, generator=gen, device=dev), mk]


def _time_head(args, coefs, flush):
    """K5 forward and backward and their plain versions on one case, with
    their bounds: bytes (each input read once, each output written once)
    against operations on the f32 units (the row math is f32 whatever the
    logits' type: ~5 an element forward, ~15 backward). No single PyTorch
    call computes the loss with its analytic backward: no library time.
    The forward's output is the function's: its N_COLS f32 sums, whatever
    the partial rows a body writes on the way."""
    from repro_torch.kernels import gipo_loss as gl
    n, v = args[0].shape
    out = {}
    for tag, kern, plain, extra, nflop, outs in (
            ("fwd", gl.gipo_head_fwd, gl._plain_gipo_head_fwd, (),
             5.0 * n * v, gl.N_COLS * 4),
            ("bwd", gl.gipo_head_bwd, gl._plain_gipo_head_bwd, (coefs,),
             15.0 * n * v, _nbytes(args[0]))):
        ms, host_ms = _median_ms(lambda: kern(*args, 0.2, *extra),
                                 flush=flush)
        plain_ms, _ = _median_ms(lambda: plain(*args, 0.2, *extra),
                                 flush=flush)
        bound_ms, bound_by = _bound(_nbytes(*args, *extra) + outs, nflop,
                                    "float32")
        shape = f"N={n} V={v} {str(args[0].dtype)[6:]}"
        print(f"[kernels] gipo_head_{tag} {shape}: kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | library none | bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.0%} of it "
              f"reached | host enqueue {host_ms:.4f} ms")
        out[tag] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
    return out


def _head_fwd_err(tag, args, parts):
    """K5's forward, its partial rows ``parts`` summed, against the plain
    version on ``args``: the loss, entropy, KL and metrics within
    F32_MAX_ERR relative (floored at 1). Returns the error and the plain
    version's terms."""
    from repro_torch.kernels import gipo_loss as gl
    got = gl._finalize(parts.sum(0))
    exp = gl._finalize(gl._plain_gipo_head_fwd(*args, 0.2).sum(0))
    vals = list(got[:3]) + [got[3][x] for x in sorted(got[3])]
    evals = list(exp[:3]) + [exp[3][x] for x in sorted(exp[3])]
    ferr = max(abs(x.item() - y.item()) / max(abs(y.item()), 1.0)
               for x, y in zip(vals, evals))
    if not ferr <= F32_MAX_ERR:
        raise AssertionError(f"{tag}: forward rel err {ferr}")
    return ferr, exp


def _head_bwd_err(tag, args, coefs, d):
    """K5's d_logits ``d`` under ``coefs`` against the plain version: in
    the logits' dtype and shape, f32 within F32_MAX_ERR of the largest
    value (as the card tests hold it), bf16 as K4's outputs. Returns (max
    abs err, err beyond the bar's rounding term of the largest value)."""
    import torch
    from repro_torch.kernels import gipo_loss as gl
    ed = gl._plain_gipo_head_bwd(*args, 0.2, coefs)
    if d.dtype != args[0].dtype or d.shape != args[0].shape:
        raise AssertionError(f"{tag}: d_logits {d.dtype} {d.shape}")
    if d.dtype == torch.float32:
        return _check_f32_out(f"{tag} d_logits", d, ed)
    return _check_grad(f"{tag} d_logits", d, ed, d.dtype)


def _gipo_head_kernels(gen, dev, flush):
    """K5 forward and backward against their plain versions on the card,
    f32 and bf16 logits, at K5_SHAPES, on live and on stale logp_old
    (``_head_case``): the loss, entropy, KL and metrics within F32_MAX_ERR
    relative (floored at 1), ω's mean above 0.5 on the live data; the
    backward under each row of K5_COEFS (live data; the stale data under
    the last), f32 d_logits within F32_MAX_ERR of the largest value, bf16
    as K4's outputs, the masked row's d_logits zero, each run twice and
    compared bit for bit. Every case runs the register body, its partial
    rows as many as the C query ``gipo_head_partial_rows`` says, and is
    held against ``ref.tiled_gipo_head_loss`` at the layout it reports
    (K5_ORDER_ATOL). Each live case timed. Returns the two JSON entries,
    timed at N 224 V 256 f32 (what the kernel-ops phase runs), every case
    beside it."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.ref import tiled_gipo_head_loss
    cases, errs = [], {"fwd": 0.0, "bwd": 0.0}
    order_err = 0.0
    for n, v in K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for stale in (False, True):
                args = _head_case(gen, dev, n, v, dtype, stale)
                tag = (f"gipo_head N={n} V={v} {str(dtype)[6:]} "
                       + ("stale" if stale else "live"))
                lanes, block_rows = gl.head_layout(args[0])
                if gl.head_body(args[0]) != "registers":
                    raise AssertionError(f"{tag}: the streaming body")
                parts = gl.gipo_head_fwd(*args, 0.2)
                want = build.load().gipo_head_partial_rows(
                    n, v, 0 if dtype == torch.float32 else 1)
                if parts.shape != (want, 8):
                    raise AssertionError(f"{tag}: partials {parts.shape}, "
                                         f"the C query {want} rows")
                ferr, exp = _head_fwd_err(tag, args, parts)
                omega = exp[3]["omega_mean"].item()
                if not (stale or omega > 0.5):
                    raise AssertionError(f"{tag}: ω mean {omega}")
                rows, derrs = K5_COEFS[-1:] if stale else K5_COEFS, []
                for row in rows:
                    coefs = torch.tensor(row, device=dev) / n
                    d = gl.gipo_head_bwd(*args, 0.2, coefs)
                    again = gl.gipo_head_bwd(*args, 0.2, coefs)
                    torch.cuda.synchronize()
                    ctag = f"{tag} coefs {row}"
                    derrs.append(_head_bwd_err(ctag, args, coefs, d))
                    if not torch.equal(d, again):
                        raise AssertionError(f"{ctag}: two backward runs "
                                             f"differ")
                    if d[1].any():
                        raise AssertionError(f"{ctag}: the masked row's "
                                             f"d_logits")
                    # the register body's order of arithmetic
                    op, od = tiled_gipo_head_loss(
                        *args, 0.2, coefs, lanes=lanes,
                        block_rows=block_rows)
                    oerr = max(
                        ((parts - op).abs()
                         / op.abs().amax(0).clamp_min(1e-30)).max().item(),
                        (((d.float() - od).abs()
                          - (0.0 if dtype == torch.float32 else ORDER_RTOL)
                          * od.abs()).max() / od.abs().max()).item())
                    if not oerr <= K5_ORDER_ATOL:
                        raise AssertionError(
                            f"{ctag}: {oerr} of the largest value from "
                            f"ref.tiled_gipo_head_loss > {K5_ORDER_ATOL}")
                    order_err = max(order_err, oerr)
                    del d, again, op, od
                errs["fwd"] = max(errs["fwd"], ferr)
                errs["bwd"] = max(errs["bwd"], *(e[0] for e in derrs))
                print(f"[kernels] {tag}: register body, {lanes} lanes a "
                      f"row, {block_rows} rows a partial row, "
                      f"{parts.shape[0]} of them "
                      f"| ω mean {omega:.3f} | forward rel "
                      f"err {ferr:.3e} | d_logits max abs err under coefs "
                      + ", ".join(f"{r} {e[0]:.3e}"
                                  for r, e in zip(rows, derrs))
                      + " | beyond the bar's rounding term, of the largest "
                      f"value: {max(e[1] for e in derrs):.3e} | two runs "
                      f"equal | the masked row zero | from the kernel "
                      f"order, of the largest value: {order_err:.3e} so far")
                if not stale:
                    cases.append(_time_head(
                        args, torch.tensor(K5_COEFS[-1], device=dev) / n,
                        flush))
                del args, exp
    main = K5_SHAPES.index((224, 256)) * 2           # its f32 case
    return [dict(name=f"gipo_head_loss_{tag}", route="cuda",
                 source="src/repro_torch/csrc/gipo_loss.cu",
                 replaces=f"src/repro/kernels/gipo_loss.py:{line}",
                 launches=None, max_abs_err=errs[tag], **cases[main][tag],
                 shapes=[c[tag] for c in cases])
            for tag, line in (("fwd", 155), ("bwd", 164))]


def _ssd_case(gen, dev, b, t, h, p, n, dtype):
    """SSD scan inputs as the model makes them: dt post-softplus in
    [0.01, 0.1], A in [-1.5, -0.5]."""
    import torch
    return [torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype),
            torch.rand(b, t, h, generator=gen, device=dev) * 0.09 + 0.01,
            -(torch.rand(h, generator=gen, device=dev) + 0.5),
            torch.randn(b, t, n, generator=gen, device=dev).to(dtype),
            torch.randn(b, t, n, generator=gen, device=dev).to(dtype)]


def _ssd_flops(b, t, h, p, n, q, bwd: bool) -> float:
    """Operations the SSD scan needs (multiply and add counted apart) at
    chunk ``min(q, t)``, causal pairs of the sequence's own steps only (a
    short last chunk's padding is not counted). Forward: C.B^T and W.x over
    the pairs, C.S^T and the state update. Backward: C.B^T, dy.x^T, W^T.dy,
    dcb.B and dcb^T.C over the pairs, and B.M^T, dy.S, x.M and the carry of
    M."""
    q = min(q, t)
    total = 0
    for c0 in range(0, t, q):
        rows = min(q, t - c0)
        pairs = rows * (rows + 1) // 2
        total += (2 * pairs * (2 * n + 3 * p) + 8 * rows * n * p if bwd
                  else 2 * pairs * (n + p) + 4 * rows * n * p)
    return float(b * h * total)


def _check_f32_out(name, got, exp):
    """An f32 output of an f32-inside kernel: max abs err <= F32_MAX_ERR of
    the largest value, for f32 and bf16 inputs alike. Returns (max abs err,
    as a fraction of the largest value)."""
    err = (got.float() - exp.float()).abs().max().item()
    scale = exp.float().abs().max().item()
    if not err <= F32_MAX_ERR * scale:
        raise AssertionError(f"{name}: max abs err {err} > {F32_MAX_ERR} x "
                             f"{scale}")
    return err, err / max(scale, 1e-30)


def _ssd_kernels(gen, dev, flush, label, h, p, n, f32_chunk):
    """K6 at the serving (B8) and training (B36) batches of ``label`` (SSD
    heads ``h``, head width ``p``, state ``n``, chunk 128), on 256-token
    sequences (two chunks of 128) and on the env's (12-token prompts,
    19-token train sequences: one short chunk), f32 and bf16, with and
    without entering states; K7 at the training batch on both lengths
    (bf16; f32 at chunk ``f32_chunk`` on 256 tokens), run twice and compared
    bit for bit; each against its plain version. Returns (K6, K7) timings at
    the 256-token shapes with the env's shapes beside them."""
    import torch
    from repro_torch.kernels.ssd_scan import (fwd_body, plain_ssd_scan,
                                              plain_ssd_scan_bwd,
                                              ssd_scan, ssd_scan_bwd)
    q = 128
    k6 = {}
    for b, t in ((8, 256), (36, 256), (8, SSM_ENV_OBS),
                 (36, SSM_ENV_OBS + 7)):
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_case(gen, dev, b, t, h, p, n, dtype)
            for states in (False, True):
                got = ssd_scan(*args, chunk=q, return_states=states)
                exp = plain_ssd_scan(*args, q, states)
                torch.cuda.synchronize()
                tag = (f"{label} ssd_scan B={b} T={t} H={h} P={p} N={n} "
                       f"chunk={q} "
                       f"{str(dtype)[6:]}" + (" +states" if states else "")
                       + f" ({fwd_body(args[0], args[3], q)} body)")
                res = [_check_f32_out(f"{tag} {nm}", x, y) for nm, x, y in
                       zip(("y", "s_final", "s_enter"), got, exp)]
                print(f"[kernels] {tag}: max abs err "
                      + " ".join(f"{nm} {r[0]:.3e}" for nm, r in
                                 zip(("y", "s_final", "s_enter"), res))
                      + f" | of the largest value {max(r[1] for r in res):.3e}")
                # timed below: bf16, with states where training saves them
                if dtype == torch.bfloat16 and states == (b == 36):
                    k6[b, t] = dict(args=args, states=states,
                                    err=max(r[0] for r in res))
                del got, exp
            del args
    # K7: the training batch in bf16 (at N 128 f32 tiles at chunk 128
    # exceed shared memory: f32 is checked at f32_chunk, and on the env's 19
    # steps, which run as one chunk of 32), a nonzero ds_final
    k7 = {}
    for dtype, b, t, qq in ((torch.bfloat16, 36, 256, q),
                            (torch.float32, 8, 256, f32_chunk),
                            (torch.bfloat16, 36, SSM_ENV_OBS + 7, q),
                            (torch.float32, 36, SSM_ENV_OBS + 7, q)):
        args = (k6[b, t]["args"] if dtype == torch.bfloat16
                else _ssd_case(gen, dev, b, t, h, p, n, dtype))
        _, _, enter = ssd_scan(*args, chunk=qq, return_states=True)
        dy = torch.randn(b, t, h, p, generator=gen, device=dev)
        ds = torch.randn(b, h, p, n, generator=gen, device=dev)
        got = ssd_scan_bwd(*args, enter, dy, ds, chunk=qq)
        again = ssd_scan_bwd(*args, enter, dy, ds, chunk=qq)
        exp = plain_ssd_scan_bwd(*args, enter, dy, ds, qq)
        torch.cuda.synchronize()
        tag = f"{label} ssd_scan_bwd B={b} T={t} H={h} P={p} N={n} " \
              f"chunk={qq} {str(dtype)[6:]}"
        res = []
        for nm, x, y in zip(("dx", "ddt", "dA", "dB", "dC"), got, exp):
            if x.dtype != y.dtype or x.shape != y.shape:
                raise AssertionError(f"{tag} {nm}: {x.dtype} {x.shape} vs "
                                     f"{y.dtype} {y.shape}")
            res.append(_check_f32_out(f"{tag} {nm}", x, y)
                       if y.dtype == torch.float32
                       else _check_grad(f"{tag} {nm}", x, y, dtype))
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{tag}: two runs differ")
        print(f"[kernels] {tag}: max abs err " + " ".join(
            f"{nm} {r[0]:.3e}" for nm, r in zip(("dx", "ddt", "dA", "dB",
                                                 "dC"), res))
            + f" | beyond the bar's rounding term, of the largest value: "
            f"{max(r[1] for r in res):.3e} | two runs equal")
        if dtype == torch.bfloat16:
            k7[t] = dict(args=args, enter=enter, dy=dy, ds=ds,
                         err=max(r[0] for r in res))
        del got, again, exp, enter, dy, ds
    env_t = SSM_ENV_OBS + 7
    k6_times = dict(_time_ssd(k6[8, 256], flush),
                    max_abs_err=max(v["err"] for v in k6.values()),
                    train_shape=dict(_time_ssd(k6[36, 256], flush),
                                     max_abs_err=k6[36, 256]["err"]),
                    env_serving_shape=_time_ssd(k6[8, SSM_ENV_OBS], flush),
                    env_train_shape=_time_ssd(k6[36, env_t], flush))
    k7_times = dict(_time_ssd_bwd(k7[256], flush),
                    max_abs_err=max(v["err"] for v in k7.values()),
                    env_train_shape=_time_ssd_bwd(k7[env_t], flush))
    del k6, k7
    return k6_times, k7_times


def _time_ssd(case, flush):
    """K6 and its plain version on one bf16 case, and the FMA body (which
    f32 inputs run) on the same bf16 inputs; no single PyTorch call
    computes a chunked SSD scan, so there is no library time."""
    from repro_torch.kernels.ssd_scan import (fwd_body, plain_ssd_scan,
                                              ssd_scan)
    args, states = case["args"], case["states"]
    b, t, h, p = args[0].shape
    n, q = args[3].shape[-1], 128
    ms, host_ms = _median_ms(lambda: ssd_scan(
        *args, chunk=q, return_states=states), flush=flush)
    fma_ms, _ = _median_ms(lambda: ssd_scan(
        *args, chunk=q, return_states=states, body="fma"), flush=flush)
    plain_ms, _ = _median_ms(lambda: plain_ssd_scan(*args, q, states),
                             flush=flush)
    outs = 4 * (b * t * h * p + b * h * p * n
                + states * b * -(-t // q) * h * p * n)
    bound_ms, bound_by = _bound(_nbytes(*args) + outs,
                                _ssd_flops(b, t, h, p, n, q, False),
                                "bfloat16")
    shape = (f"B={b} T={t} H={h} P={p} N={n} chunk={q} bf16"
             + (" +states" if states else ""))
    body = fwd_body(args[0], args[3], q)
    print(f"[kernels] ssd_scan {shape}: kernel {ms:.4f} ms ({body} body) | "
          f"FMA body {fma_ms:.4f} ms | plain {plain_ms:.4f} ms | library "
          f"none | bound {bound_ms:.4f} ms ({bound_by}) | host enqueue "
          f"{host_ms:.4f} ms")
    return dict(shape=shape, body=body, ms=ms, fma_ms=fma_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _time_ssd_bwd(case, flush):
    """K7 and its plain version (autograd of the plain forward) on the bf16
    training case; no library time, as for K6."""
    from repro_torch.kernels.ssd_scan import (plain_ssd_scan_bwd,
                                              ssd_scan_bwd)
    args, enter, dy, ds = (case[k] for k in ("args", "enter", "dy", "ds"))
    b, t, h, p = args[0].shape
    n, q = args[3].shape[-1], 128
    ms, host_ms = _median_ms(lambda: ssd_scan_bwd(
        *args, enter, dy, ds, chunk=q), flush=flush)
    plain_ms, _ = _median_ms(lambda: plain_ssd_scan_bwd(
        *args, enter, dy, ds, q), runs=5, flush=flush)
    outs = _nbytes(args[0], args[1], args[3], args[4]) + 4 * h
    bound_ms, bound_by = _bound(_nbytes(*args, enter, dy, ds) + outs,
                                _ssd_flops(b, t, h, p, n, q, True),
                                "bfloat16")
    shape = f"B={b} T={t} H={h} P={p} N={n} chunk={q} bf16"
    print(f"[kernels] ssd_scan_bwd {shape}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | library none | bound {bound_ms:.4f} ms "
          f"({bound_by}) | host enqueue {host_ms:.4f} ms")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


@contextlib.contextmanager
def _moe_choices():
    """Wraps the port's ``moe._group_dispatch`` for the body of the
    ``with``: each call's expert choices (the top-k of the softmax of its
    f32 router logits, first choice first, as the call chose them) and its
    keep mask are appended, in call order, to the list it yields. The
    port's outputs are unchanged."""
    import torch
    from repro_torch.models import moe
    calls, inner = [], moe._group_dispatch

    def wrapped(params, xg, cfg, cap):
        out, logits, keep = inner(params, xg, cfg, cap)
        with torch.no_grad():
            idx = torch.topk(torch.softmax(logits.detach(), dim=-1),
                             cfg.top_k, dim=-1).indices
        calls.append((idx.to(torch.uint8), keep.detach().clone()))
        return out, logits, keep
    moe._group_dispatch = wrapped
    try:
        yield calls
    finally:
        moe._group_dispatch = inner


@contextlib.contextmanager
def _router_gaps():
    """Wraps the port's ``moe._group_dispatch`` for the body of the
    ``with``: for each call, the smallest gap between a token's k-th and
    (k+1)-th router logit (the top-k boundary, where a near-tie lets two
    routes choose different experts) and the count of gaps under 1e-5
    are appended to the list it yields, with the call's token count."""
    import torch
    from repro_torch.models import moe
    gaps, inner = [], moe._group_dispatch

    def wrapped(params, xg, cfg, cap):
        out, logits, keep = inner(params, xg, cfg, cap)
        with torch.no_grad():
            top = torch.topk(logits.detach().float(), cfg.top_k + 1,
                             dim=-1).values
            gap = top[..., -2] - top[..., -1]
            gaps.append((gap.min().item(), int((gap < 1e-5).sum()),
                         gap.numel()))
        return out, logits, keep
    moe._group_dispatch = wrapped
    try:
        yield gaps
    finally:
        moe._group_dispatch = inner


def _moe_agreement(label, kernel, plain, n_layers):
    """Per layer, between two runs' ``_moe_choices`` lists (the same calls
    in the same order: call i runs layer i % n_layers): the share of
    (token, choice) pairs whose expert the other run also chose for that
    token, the share whose expert sits at the same rank of the top-k
    (which the GShard priority reads), and each run's dropped share of
    assignments; printed. Returns the per-layer shares of the first kind."""
    import torch
    if len(kernel) != len(plain) or not kernel:
        raise AssertionError(f"{label}: {len(kernel)} vs {len(plain)} MoE "
                             f"calls")
    cols = ("same", "ranked", "total", "kernel", "plain")
    acc = {c: [0] * n_layers for c in cols}
    for i, ((ik, kk), (ip, kp)) in enumerate(zip(kernel, plain)):
        layer = i % n_layers
        e = int(max(ik.max(), ip.max())) + 1
        sets = [torch.zeros(ik.shape[:-1] + (e,), dtype=torch.bool,
                            device=ik.device).scatter_(-1, x.long(), True)
                for x in (ik, ip)]
        for c, v in (("same", (sets[0] & sets[1]).sum()),
                     ("ranked", (ik == ip).sum()), ("total", ik.numel()),
                     ("kernel", kk.sum()), ("plain", kp.sum())):
            acc[c][layer] += int(v)
    share = {c: [a / n for a, n in zip(acc[c], acc["total"])] for c in cols}
    print(f"{label}, per layer of {acc['total'][0]} (token, choice) pairs: "
          f"chosen on both routes {[f'{a:.4f}' for a in share['same']]} | "
          f"at the same rank {[f'{a:.4f}' for a in share['ranked']]} | "
          f"dropped share, kernel "
          f"{[f'{1 - x:.4f}' for x in share['kernel']]}, plain "
          f"{[f'{1 - x:.4f}' for x in share['plain']]}")
    return share["same"]


def _check_moe_agreement(cfg, agree, label, floors):
    """The routes' expert choices (``agree``: per layer, as
    ``_moe_agreement`` returns): in bf16 the first layer's agreement at
    least ``floors[0]`` (its router sees the routes' attention roundings
    only), in f32 every layer's at least ``floors[1]``."""
    if cfg.param_dtype == "float32":
        worst, floor = min(agree), floors[1]
    else:
        worst, floor = agree[0], floors[0]
    if not worst >= floor:
        raise AssertionError(f"{label}: expert choices agree on {worst} of "
                             f"the pairs (floor {floor})")


def _forward_calls(calls, n_layers, per_micro):
    """The forward calls of a train step's ``_moe_choices`` list, layer by
    layer a micro-batch: a checkpointed block runs its router again in the
    backward (``per_micro`` = 2 x layers), after the forward's."""
    out = []
    for m in range(0, len(calls), per_micro):
        out += calls[m:m + n_layers]
    return out


def phase_moe_layer(dev):
    """One granite-moe-1b-a400m MoE layer at full width (32 experts top-8,
    d 1024, expert width 512; weights from a seed) on 8 x MOE_OBS tokens
    (4 groups of 512, capacity 160), on the card and on a CPU copy of the
    same f32 weights and inputs: the expert choices and keep masks equal
    element for element, ``out`` within F32_MAX_ERR of its largest value,
    the aux terms within 1e-5 relative (the dropped share exactly). Again
    in bf16 (router f32), the differing choices and keep slots printed.
    Then the dispatch and combine products and the whole layer, forward
    and backward, timed at the training shape (36 x MOE_OBS tokens)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(3)
    p32 = moe.moe_init(gen, cfg.d_model, cfg.moe, torch.float32, dev)
    x32 = torch.randn(8, MOE_OBS, cfg.d_model, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: v if k == "router" else v.to(dtype) for k, v in p32.items()}
        x = x32.to(dtype)
        with torch.no_grad():
            with _moe_choices() as card:
                out_c, aux_c = moe.moe_forward(p, x, cfg.moe)
            with _moe_choices() as host:
                out_h, aux_h = moe.moe_forward(
                    tree_map(lambda v: v.cpu(), p), x.cpu(), cfg.moe)
        (ic, kc), (ih, kh) = card[0], host[0]
        n_choice = int((ic.cpu() != ih).sum())
        n_keep = int((kc.cpu() != kh).sum())
        scale = out_h.float().abs().max().item()
        err = (out_c.cpu().float() - out_h.float()).abs().max().item()
        aux_rel = {k: abs(aux_c[k].item() - aux_h[k].item())
                   / max(abs(aux_h[k].item()), 1e-30) for k in aux_h}
        tag = f"[moe] {cfg.name} layer, {str(dtype)[6:]}, card vs CPU"
        print(f"{tag}: {ih.numel()} (token, choice) pairs, {n_choice} "
              f"differ, {n_keep} keep slots differ | out max abs err "
              f"{err:.3e} of max |out| {scale:.3f} | aux "
              + ", ".join(f"{k} {aux_c[k].item():.6g} vs {aux_h[k].item():.6g}"
                          for k in aux_h)
              + f" (rel {max(aux_rel.values()):.2e})")
        if dtype == torch.float32 and not (
                n_choice == 0 and n_keep == 0
                and err <= F32_MAX_ERR * scale
                and aux_c["dropped_frac"].item()
                == aux_h["dropped_frac"].item()
                and max(aux_rel.values()) <= 1e-5):
            raise AssertionError(f"{tag}: the card and the CPU differ")
        del out_c, out_h, card, host
    # the training shape: 36 x MOE_OBS tokens, 18 groups of 512 (dense
    # products: their time does not depend on the one-hot values)
    p = {k: v if k == "router" else v.to(torch.bfloat16)
         for k, v in p32.items()}
    g, e, cap = 36 * MOE_OBS // 512, cfg.moe.num_experts, \
        moe.capacity(512, cfg.moe)
    x = torch.randn(g, 512, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    expert_out = torch.randn(g, e, cap, cfg.d_model, generator=gen,
                             device=dev).to(x.dtype)
    combine = torch.rand(g, 512, e, cap, generator=gen,
                         device=dev).to(x.dtype)
    dispatch = (combine > 0.5).to(x.dtype)
    xr = x.detach().requires_grad_(True)
    er = expert_out.detach().requires_grad_(True)
    cr = combine.detach().requires_grad_(True)

    def dispatch_fwd():
        return torch.einsum("...nd,...nec->...ecd", xr, dispatch)

    def combine_fwd():
        return torch.einsum("...ecd,...nec->...nd", er, cr)
    din, dout = dispatch_fwd(), combine_fwd()
    g_in, g_out = torch.randn_like(din), torch.randn_like(dout)
    t = {"dispatch fwd": _median_ms(dispatch_fwd)[0],
         "combine fwd": _median_ms(combine_fwd)[0],
         "dispatch bwd": _median_ms(lambda: torch.autograd.grad(
             din, xr, g_in, retain_graph=True))[0],
         "combine bwd": _median_ms(lambda: torch.autograd.grad(
             dout, (er, cr), g_out, retain_graph=True))[0]}
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xs = x.reshape(36, MOE_OBS, cfg.d_model).detach().requires_grad_(True)

    def layer_step():
        out, aux = moe.moe_forward(pr, xs, cfg.moe)
        loss = out.float().square().mean() + aux["load_balance"] \
            + aux["router_z"]
        return torch.autograd.grad(loss, [xs] + list(pr.values()))
    t["layer fwd+bwd"] = _median_ms(layer_step, runs=10, warmup=2)[0]
    per_step = 2 * cfg.num_layers                 # grad_accum 2
    einsums = sum(v for k, v in t.items() if k != "layer fwd+bwd")
    print(f"[moe] training shape (36 x {MOE_OBS} tokens, 18 groups of 512, "
          f"capacity {cap}), bf16, median device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f" | x {per_step} calls a step: dispatch + combine "
          f"{einsums * per_step:.1f} ms, the MoE layer "
          f"{t['layer fwd+bwd'] * per_step:.1f} ms | phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    del p32, x32, p, x, pr, xs, din, dout, xr, er, cr
    torch.cuda.empty_cache()
    return t


def _replay(cfg, params, obs, prefix, tokens):
    """Prefill + one decode per given action token. Returns the action
    logits before each token and after the last ([A + 1] x [B, Va] f32),
    and the host-clock seconds of the prefill and of all decode steps."""
    import torch
    from repro_torch.models import transformer
    cache_len = (0 if prefix is None else prefix.shape[1]) + obs.shape[1] \
        + tokens.shape[1]
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


def phase_model(dev, cfg, params, *, obs_len, counters, bound,
                f32_bound=None, agree=None):
    """``sample_action_sequence`` on the kernel route with its launches
    counted (``counters``: name -> (wrapper, launches per prefill + 7
    decodes)), then prefill + one decode per sampled token replayed on both
    routes and every step's action logits compared within ``bound`` (None:
    printed); with ``agree``, the routes' expert choices held by
    ``_check_moe_agreement``. With
    ``f32_bound``, the two replays again on an f32 copy of the model, held
    within ``f32_bound``: both routes compute the same function, and the
    bf16 difference is their roundings carried through the layers."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.policy import gumbel_noise, sample_action_sequence
    gen = torch.Generator(device=dev).manual_seed(1)
    b, a = 8, cfg.action_dim
    obs = torch.randint(0, cfg.vocab_size, (b, obs_len), generator=gen,
                        device=dev)
    prefix = (torch.randn(b, cfg.num_prefix_tokens, 1024, generator=gen,
                          device=dev) if cfg.num_prefix_tokens else None)
    n_prefix = cfg.num_prefix_tokens
    steps = torch.arange(b, device=dev)
    noise = gumbel_noise(gen, (a, b, cfg.action_vocab_size), dev)
    with torch.inference_mode():
        with dispatch.forced("cuda"):
            for fn, _ in counters.values():
                fn.launches = 0
            tok, logp, val = sample_action_sequence(
                cfg, params, None, obs, steps, prefix, gumbel=noise)
            got = {k: fn.launches for k, (fn, _) in counters.items()}
        if got != {k: want for k, (_, want) in counters.items()}:
            raise AssertionError(f"launches {got}")
        runs, choices = {"torch": [], "cuda": []}, {}
        for mode in ("torch", "cuda", "cuda", "torch"):
            with dispatch.forced(mode), _moe_choices() as calls:
                runs[mode].append(_replay(cfg, params, obs, prefix, tok))
            choices.setdefault(mode, calls)
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
    print(f"[model] {cfg.name} bf16 x {cfg.num_layers} layers B={b} "
          f"T={n_prefix + obs_len} cache={n_prefix + obs_len + a}: launches "
          f"{got} | max |logit kernel - plain| per step "
          f"{[f'{x:.4f}' for x in diffs]} (bound {bound}, max |logit| "
          f"{scale:.3f})")
    for mode, name in (("cuda", "kernel"), ("torch", "plain")):
        times = ", ".join(f"prefill {r[1] * 1e3:.1f} ms + 7 decodes "
                          f"{r[2] * 1e3:.1f} ms" for r in runs[mode])
        print(f"[model] {name} route, two replays: {times}")
    if agree is not None:
        _check_moe_agreement(cfg, _moe_agreement(
            f"[model] {cfg.name} bf16, prefill + 7 decodes",
            choices["cuda"], choices["torch"], cfg.num_layers),
            f"{cfg.name} bf16 replays", agree)
    if bound is not None and not max(diffs) <= bound:
        raise AssertionError(f"model logits differ by {max(diffs)}")
    if f32_bound is None:
        return
    import dataclasses
    from repro_torch.tree import tree_map
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda v: v.float(), params)
    with torch.inference_mode():
        logits, choices = {}, {}
        for mode in ("cuda", "torch"):
            with dispatch.forced(mode), _moe_choices() as calls:
                logits[mode] = _replay(cfg32, p32, obs, prefix, tok)[0]
            choices[mode] = calls
    del p32
    if agree is not None:
        _check_moe_agreement(cfg32, _moe_agreement(
            f"[model] {cfg.name} f32 copy, prefill + 7 decodes",
            choices["cuda"], choices["torch"], cfg.num_layers),
            f"{cfg.name} f32 replays", agree)
    d32 = [(x - y).abs().max().item()
           for x, y in zip(logits["cuda"], logits["torch"])]
    gap = max((x - y).abs().max().item()
              for x, y in zip(logits["cuda"], lk))
    print(f"[model] {cfg.name} f32 copy, same tokens: max |logit kernel - "
          f"plain| per step {[f'{x:.2e}' for x in d32]} (bound {f32_bound})"
          f" | f32 vs bf16 kernel route {gap:.4f}")
    if not max(d32) <= f32_bound:
        raise AssertionError(f"f32 model logits differ by {max(d32)}")


def phase_serving(dev, cfg, params0, params1, *, obs_len, frame, counters):
    """24 requests from 4 client threads across a drain swap; ``frame``:
    whether requests carry an env frame (the one prefix token);
    ``counters``: name -> (wrapper, launches per batch). Returns the
    launches by name."""
    import numpy as np
    import torch
    from repro_torch.configs import RuntimeConfig
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
                obs = rng.integers(0, cfg.vocab_size, obs_len).astype(
                    np.int32)
                env = rng.random(192).astype(np.float32) if frame else None
            fut = service.submit(obs, env, int(i))
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

    for fn, _ in counters.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, (fn, _) in counters.items()}
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
    if launches != {k: per * nb for k, (_, per) in counters.items()}:
        raise AssertionError(f"launches {launches} for {nb} batches")
    lat = service.metrics.series("batch_s")
    print(f"[serving] {cfg.name} bf16 x {cfg.num_layers} layers, "
          f"{obs_len} tokens{' + 1 frame token' if frame else ''}: 24 "
          f"requests, {nb} batches, versions "
          f"{sorted(set(versions))}, swaps {service.weight_swaps} | "
          f"launches {launches} | batch p50 "
          f"{statistics.median(lat) * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}"
          f", max {max(lat) * 1e3:.1f}) | {24 / wall:.2f} req/s over "
          f"{wall:.2f} s incl. the swap")
    return launches


def _device_time(prof):
    """(busy ms, kernel rows, time by kind) of a torch.profiler trace; only
    kernel rows count, as an operator's row repeats its kernels' time."""
    import torch
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    groups = {}
    for name, ms, n in rows:
        key = next((g for g, pats in TRACE_GROUPS if any(
            p in name for p in pats)), "other")
        t, c = groups.get(key, (0.0, 0))
        groups[key] = (t + ms, c + n)
    by_kind = "; ".join(f"{g} {t:.1f} ms x{c}" for g, (t, c) in sorted(
        groups.items(), key=lambda kv: -kv[1][0]))
    return sum(r[1] for r in rows), rows, by_kind


def phase_trace(dev, cfg, params, *, obs_len, frame):
    """One serving-shape batch (B=8, ``obs_len`` tokens and the frame token
    if ``frame``, 7 decode steps) under torch.profiler: wall time, device
    busy time, and the kernels that take it. After the serving phase, so
    no launch it makes is counted there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.policy import sample_action_sequence
    gen = torch.Generator(device=dev).manual_seed(2)
    obs = torch.randint(0, cfg.vocab_size, (8, obs_len), generator=gen,
                        device=dev)
    prefix = None
    if frame:
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
    busy_ms, rows, by_kind = _device_time(prof)
    label = (f"one {cfg.name} serving batch B=8 T={obs_len + frame} + 7 "
             f"decodes")
    if busy_ms == 0:
        print(f"[trace] {label}: wall {wall_ms:.1f} ms traced; device time "
              f"not measured (the profiler saw no kernels)")
        return
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{name[:48]} {ms:.2f} ms x{n}" for name, ms, n
                    in rows[:6])
    print(f"[trace] {label}, traced: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% | by kind: {by_kind} | top: "
          f"{top}")


def phase_train(dev, arch, n_layers, obs_len, counters, bounds, failures, *,
                remat=False, plain_remat=False, f32_witness=None,
                live_bounds=None, live_steps_bound=LIVE_STEPS_BOUND,
                checks=DENSE):
    """``arch`` at full width and ``n_layers`` layers, on ``dummy_batch``
    segments of ``obs_len`` observation tokens: the kernel route's
    step-1 gradients (every leaf nonzero) against the plain route's, then
    three train steps on the kernel route with their launches counted
    (``counters``: name -> (wrapper, launches per step)), a traced fourth
    step, and the three steps replayed on the plain route from the same
    seed. ``bounds``: the step-1 metric and per-leaf gradient bounds, and
    for each of steps 1-3 a bound for each key of STEP_KEYS it holds.
    ``remat`` checkpoints each block on both routes (the same arithmetic,
    recomputed in the backward: the kernel route's forward kernels launch
    again there), ``plain_remat`` on the plain route only, where its saved
    activations would not fit beside the kernel route's gradients.
    ``f32_witness``: (SSD chunk or None, bounds as ``bounds``) to run step
    1 and steps 1-3 again on an f32 copy of the model, both routes
    checkpointing each layer. ``live_bounds``: bounds as ``bounds[:2]``
    for one more step-1 comparison whose behaviour log-probs are live
    (``_live_behaviour``),
    with ω's mean held above 0.5. Then steps 1-3 run once more from seed 0
    on both routes with live behaviour log-probs at every step (scored on
    the plain route, or with ``checks.live_own`` on each run's own),
    ω's mean held above 0.5 at each, compared within
    ``live_steps_bound``; ``checks.agree`` holds step 1's expert choices
    (``_compare_step1``). A bf16 steps
    1-3 comparison that fails is appended to ``failures``, which main raises
    after the last phase, so that the rest of the run still reports; every
    other check raises at once.
    Returns the launches by name over the three steps."""
    import dataclasses
    import torch
    from repro_torch.configs import RLConfig, get_config
    from repro_torch.core import train_step as ts
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_leaves_with_path
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    route_bound, _, steps_bound = bounds
    # lr 1e-4: the default 3e-6 is below half a bf16 ulp of most weights
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, 0, device=dev)
    np_batch = dummy_batch(8, 8, obs_len, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    batch = batch_from_numpy(np_batch, device=dev)
    p0 = {path: x.clone() for path, x in tree_leaves_with_path(state.params)}
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in p0.values())
    print(f"[train] {arch} x {n_layers} layers: {n_params / 1e9:.3f}"
          f" B parameters, state on the card in "
          f"{time.perf_counter() - t0:.1f} s | allocated "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB")
    m_kernel, m_plain = _compare_step1(f"{arch} bf16", cfg, rl, state,
                                       batch, (remat, remat or plain_remat),
                                       bounds[:2], checks.agree)
    if live_bounds is not None:
        live = batch._replace(
            behavior_logp=_live_behaviour(cfg, state.params, batch))
        m_live, _ = _compare_step1(f"{arch} bf16, live behaviour "
                                   f"log-probs", cfg, rl, state, live,
                                   (remat, remat or plain_remat),
                                   live_bounds, checks.agree)
        omega = m_live["omega_mean"].item()
        print(f"[train] {arch} live behaviour log-probs: omega mean "
              f"{omega:.3f}, pg {m_live['pg_loss'].item():.5f}, kl "
              f"{m_live['kl'].item():.5f} (stale: omega "
              f"{m_kernel['omega_mean'].item():.3f}, pg "
              f"{m_kernel['pg_loss'].item():.5f})")
        if not omega > 0.5:
            raise AssertionError(f"{arch} live step 1: omega mean {omega}")
        del live, m_live
    compare_peak = torch.cuda.max_memory_allocated(dev)

    want = {k: per for k, (_, per) in counters.items()}
    totals = dict.fromkeys(counters, 0)
    step = ts.make_train_step(cfg, rl, remat=remat, device=dev)
    walls, hist = [], {"cuda": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(3):
        for fn, _ in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dispatch.forced("cuda"):
            state, metrics = step(state, np_batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: fn.launches for k, (fn, _) in counters.items()}
        if got != want:
            raise AssertionError(f"step {i + 1}: launches {got}, want "
                                 f"{want}")
        totals = {k: totals[k] + got[k] for k in totals}
        hist["cuda"].append({k: v.item() for k, v in metrics.items()})
        bad = [k for k, v in metrics.items() if not math.isfinite(v.item())]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite metrics {bad}")
        if i == 0:
            rel = abs(metrics["loss"].item() - m_kernel["loss"].item()) \
                / max(abs(m_kernel["loss"].item()), ROUTE_FLOOR)
            if not rel <= route_bound:
                raise AssertionError(f"step 1 loss {metrics['loss']} vs the "
                                     f"gradient pass {m_kernel['loss']}")
        print(f"[train] step {i + 1}: loss {metrics['loss'].item():.6f} | "
              f"pg {metrics['pg_loss'].item():.5f} value "
              f"{metrics['value_loss'].item():.5f} kl "
              f"{metrics['kl'].item():.5f} entropy "
              f"{metrics['entropy'].item():.5f} | grad norm "
              f"{metrics['grad_norm'].item():.4f}"
              + "".join(f" | {k} {metrics[k].item():.5f}" for k in
                        ("moe_load_balance", "moe_dropped_frac")
                        if k in metrics)
              + f" | launches {got} | wall {walls[-1] * 1e3:.1f} ms")
    if int(state.version) != 3 or int(state.opt.step) != 3:
        raise AssertionError(f"version {int(state.version)}, opt step "
                             f"{int(state.opt.step)}")
    flat_mu = [(p, x) for p, x in tree_leaves_with_path(state.opt.mu)]
    zero_mu = [".".join(p) for p, x in flat_mu if not bool((x != 0).any())]
    if zero_mu:
        raise AssertionError(f"first moments all zero: {zero_mu}")
    now = dict(tree_leaves_with_path(state.params))
    unchanged = [f"{'.'.join(path)}[{i}]" for path, x in now.items()
                 if path[0] in STACKED and x.ndim == 3
                 for i in range(x.shape[0])
                 if torch.equal(x[i], p0[path][i])]
    if unchanged or torch.equal(now[("action_head", "w")],
                                p0[("action_head", "w")]):
        raise AssertionError(f"unchanged after 3 steps: {unchanged} or the "
                             f"action head")
    peak = torch.cuda.max_memory_allocated(dev)
    seq = cfg.num_prefix_tokens + np_batch.obs_tokens.shape[2] \
        + cfg.action_dim
    micro = np_batch.obs_tokens.shape[0] // rl.grad_accum \
        * np_batch.obs_tokens.shape[1]
    print(f"[train] 3 steps: version 3, every first moment nonzero, every "
          f"layer matrix and the action head changed | step wall "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (host clock, "
          f"synchronized; {micro} sequences of {seq} tokens per micro-batch,"
          f" grad_accum {rl.grad_accum}) | max_memory_allocated "
          f"{peak / 1e9:.2f} GB")
    if not max(peak, compare_peak) < TRAIN_MEM_LIMIT:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB in the "
                             f"steps, {compare_peak / 1e9:.1f} GB in the "
                             f"step-1 comparison")
    _trace_train_step(dev, arch, step, state, np_batch)

    # the same three steps on the plain route, from a fresh seed-0 state
    del state, step, batch
    torch.cuda.empty_cache()
    hist["torch"], _ = _run_steps(dev, cfg, rl, np_batch, "torch",
                                  remat=remat or plain_remat, p0=p0)
    try:
        _compare_steps(f"{arch} bf16", hist["cuda"], hist["torch"],
                       steps_bound)
    except AssertionError as e:
        failures.append(str(e))
    # steps 1-3 again from seed 0 on live behaviour log-probs, both routes
    live = {mode: _run_steps(dev, cfg, rl, np_batch, mode, p0=p0,
                             live=mode if checks.live_own else "torch",
                             remat=remat or (mode == "torch" and plain_remat),
                             counters=counters if mode == "cuda" else None)[0]
            for mode in ("cuda", "torch")}
    del p0
    omegas = {mode: [m["omega_mean"] for m in h] for mode, h in live.items()}
    print(f"[train] {arch} live behaviour log-probs at every step: omega "
          f"mean " + " | ".join(f"{mode} " + ", ".join(f"{w:.3f}" for w in ws)
                                for mode, ws in omegas.items()))
    if not all(w > 0.5 for ws in omegas.values() for w in ws):
        raise AssertionError(f"{arch} live steps: omega means {omegas}")
    try:
        _compare_steps(f"{arch} bf16, live behaviour log-probs",
                       live["cuda"], live["torch"], live_steps_bound)
    except AssertionError as e:
        failures.append(str(e))
    if f32_witness is not None:
        _train_f32_witness(dev, cfg, rl, np_batch, *f32_witness,
                           bf16_step1=(m_kernel, m_plain),
                           agree=checks.agree)
    return totals


def _live_behaviour(cfg, params, batch, mode="torch"):
    """Behaviour log-probs [B, T+1, A] that a rollout one small update ago
    would have recorded: route ``mode``'s own action log-probs of ``batch``
    (the plain route's unless the caller asks for another) plus 0.1
    N(0, 1) (numpy, seed 1)."""
    import numpy as np
    import torch
    from repro_torch.core import train_step as ts
    from repro_torch.kernels import dispatch
    from repro_torch.models.policy import action_log_prob
    with torch.no_grad(), dispatch.forced(mode):
        hidden, _, _ = ts._score_batch_hidden(cfg, params, batch,
                                              remat=False)
        # the fused loss's own f32 logits of the action head
        logits = hidden.float() @ params["action_head"]["w"].float()
        logp = action_log_prob(logits, batch.actions)
    noise = np.random.default_rng(1).standard_normal(tuple(logp.shape))
    return logp + 0.1 * torch.from_numpy(noise.astype(np.float32)).to(
        logp.device)


def _step1_grads(cfg, rl, state, batch, mode, remat):
    """Step 1's grads, metrics and grad norm on one route (the stage
    functions that ``train_step`` composes, before the update)."""
    import torch
    from repro_torch.core import train_step as ts
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw
    slice_i, _ = ts._microbatches(batch, rl.grad_accum)
    acc = ts.zero_grads_like(state.params)
    stats = torch.zeros(3, device=batch.actions.device)
    with dispatch.forced(mode):
        for i in range(rl.grad_accum):
            g, (m, st) = ts.microbatch_grads(
                state.params, slice_i(i), state.adv_norm, cfg=cfg, rl=rl,
                remat=remat)
            acc, stats = ts.accumulate_grads(acc, g, stats, st,
                                             rl.grad_accum)
            del g
    return acc, dict(m, grad_norm=adamw.global_norm(acc))


def _compare_step1(label, cfg, rl, state, batch, remat, bounds, agree=None):
    """Step 1 on both routes (``remat``: (kernel, plain)): every gradient
    leaf nonzero on the kernel route; with ``agree``, the routes' expert
    choices in the micro-batches' forward held by ``_check_moe_agreement``;
    the gradients per leaf and layer within ``bounds[1]`` for every leaf
    the kernels' backward reaches, the value head's printed beside its
    input's difference; the loss, every metric and the grad norm within
    ``bounds[0]``. Returns both routes' metrics (kernel, plain)."""
    import torch
    from repro_torch.tree import tree_leaves_with_path
    route_bound, leaf_bound = bounds
    with _moe_choices() as calls_kernel:
        acc, m_kernel = _step1_grads(cfg, rl, state, batch, "cuda", remat[0])
    zero = [".".join(path) for path, g in tree_leaves_with_path(acc)
            if not bool((g != 0).any())]
    if zero:
        raise AssertionError(f"{label} kernel route: leaves with no "
                             f"gradient {zero}")
    n_leaves = len(list(tree_leaves_with_path(acc)))
    with _moe_choices() as calls_plain:
        acc_plain, m_plain = _step1_grads(cfg, rl, state, batch, "torch",
                                          remat[1])
    if agree is not None:
        n_l = cfg.num_layers
        _check_moe_agreement(cfg, _moe_agreement(
            f"[train] {label} step 1 (both micro-batches' forward)",
            *(_forward_calls(c, n_l, n_l * (1 + r))
              for c, r in ((calls_kernel, remat[0]), (calls_plain, remat[1]))),
            n_l), label, agree)
    del calls_kernel, calls_plain
    diffs = _leaf_grad_diff(acc, acc_plain)
    del acc, acc_plain
    held = [d for d in diffs if not d[1].startswith("value_head.")]
    value = [d for d in diffs if d[1].startswith("value_head.")]
    h_rel, c_rel, c_share = _action_hidden_diff(cfg, state.params, batch)
    print(f"[train] {label} step 1 gradients, kernel vs plain route, "
          f"|g_kernel - g_plain| / |g_plain| per leaf and per layer: "
          f"{len(held)} parts the kernels' backward reaches, worst "
          f"{', '.join(f'{k} {r:.3e}' for r, k in held[:3])} (bound "
          f"{leaf_bound}) | value head (input detached): "
          f"{', '.join(f'{k} {r:.3e}' for r, k in value)}; its input, the "
          f"action tokens' final hidden states: {h_rel:.3e} apart, "
          f"{c_rel:.3e} once centred over the action positions (the centred "
          f"part is {c_share:.3f} of the norm) | max_memory_allocated while "
          f"both are held {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not held[0][0] <= leaf_bound:
        raise AssertionError(f"{label} step 1 gradient of {held[0][1]} "
                             f"differs by {held[0][0]}")
    worst, worst_key = _worst_rel(m_kernel, m_plain, f"{label} step 1")
    print(f"[train] {label} step 1, kernel vs plain route: {n_leaves} "
          f"gradient leaves, all nonzero on the kernel route | max rel diff "
          f"over loss, {len(m_plain) - 1} metrics and grad norm {worst:.3e} "
          f"({worst_key}; bound {route_bound}) | loss "
          f"{m_kernel['loss'].item():.6f} vs {m_plain['loss'].item():.6f}, "
          f"grad norm {m_kernel['grad_norm'].item():.4f} vs "
          f"{m_plain['grad_norm'].item():.4f}")
    if not worst <= route_bound:
        raise AssertionError(f"{label} step 1 routes differ: {worst_key} by "
                             f"{worst}")
    return m_kernel, m_plain


def _worst_rel(got, exp, label):
    """The largest |got - exp| / max(|exp|, ROUTE_FLOOR) over the metrics
    (tensors or floats), and its key; raises on a non-finite value."""
    worst, worst_key = 0.0, None
    for k in exp:
        a, b = float(got[k]), float(exp[k])
        if not (math.isfinite(a) and math.isfinite(b)):
            raise AssertionError(f"{label} {k}: kernel {a}, plain {b}")
        rel = abs(a - b) / max(abs(b), ROUTE_FLOOR)
        if rel > worst:
            worst, worst_key = rel, k
    return worst, worst_key


def _run_steps(dev, cfg, rl, np_batch, mode, *, remat=False, n=3,
               counters=None, p0=None, live=None):
    """``n`` train steps on one route from a fresh seed-0 state
    (``p0``: the parameters it must start from). ``counters``: name ->
    (wrapper, launches per step), checked at every step. ``live`` (a
    route): each step's behaviour log-probs are ``_live_behaviour`` of the
    state it starts from, scored on that route. Returns each step's
    metrics and the launches by name over the steps."""
    import torch
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.core import train_step as ts
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_leaves_with_path
    counters = counters or {}
    state = ts.init_train_state(cfg, 0, device=dev)
    if p0 is not None and not all(
            torch.equal(x, p0[path])
            for path, x in tree_leaves_with_path(state.params)):
        raise AssertionError("seed-0 state differs from the first one")
    step = ts.make_train_step(cfg, rl, remat=remat, device=dev)
    hist, totals = [], dict.fromkeys(counters, 0)
    batch = batch_from_numpy(np_batch, device=dev) if live else np_batch
    for i in range(n):
        if live:
            batch = batch._replace(behavior_logp=_live_behaviour(
                cfg, state.params, batch, live))
        for fn, _ in counters.values():
            fn.launches = 0
        with dispatch.forced(mode):
            state, metrics = step(state, batch)
        got = {k: fn.launches for k, (fn, _) in counters.items()}
        if got != {k: per for k, (_, per) in counters.items()}:
            raise AssertionError(f"{mode} step {i + 1}: launches {got}")
        totals = {k: totals[k] + got[k] for k in totals}
        hist.append({k: v.item() for k, v in metrics.items()})
        if not all(math.isfinite(v) for v in hist[-1].values()):
            raise AssertionError(f"{mode} step {i + 1}: {hist[-1]}")
    del state, step
    torch.cuda.empty_cache()
    return hist, totals


def _compare_steps(label, hist_kernel, hist_plain, steps_bound):
    """Steps 1-3 of both routes from the same seed: each key of STEP_KEYS a
    step's bound names held within it, the others printed."""
    rows, over = [], []
    for i, (mk, mp) in enumerate(zip(hist_kernel, hist_plain)):
        rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), ROUTE_FLOOR)
               for k in STEP_KEYS}
        over += [(i + 1, k, r) for k, r in rel.items()
                 if k in steps_bound[i] and not r <= steps_bound[i][k]]
        rows.append(f"step {i + 1}: " + ", ".join(
            f"{k} {mk[k]:.6g} vs {mp[k]:.6g} (rel {rel[k]:.3e}"
            + (f", bound {steps_bound[i][k]})" if k in steps_bound[i]
               else ", printed)") for k in STEP_KEYS))
    print(f"[train] {label} steps 1-3 from the same seed-0 state, kernel vs "
          f"plain route: {' | '.join(rows)}")
    if over:
        raise AssertionError(f"{label} steps 1-3 differ between routes: "
                             f"{over}")


def _train_f32_witness(dev, cfg, rl, np_batch, chunk, bounds, *,
                       bf16_step1=None, agree=None):
    """Step 1 and steps 1-3 of ``cfg`` again on an f32 copy (the same seed,
    drawn in f32), both routes checkpointing each layer, at SSD chunk
    ``chunk`` (None: no SSM): both routes compute the same function, so
    what separates them in bf16 and not here is rounding. ``bounds`` as
    phase_train's. ``bf16_step1``: the bf16 routes' step-1 metrics (kernel,
    plain), each printed against the f32 copy's kernel route. ``agree``:
    as ``_compare_step1``'s."""
    import dataclasses
    import torch
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.core import train_step as ts
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    label = f"{cfg.name} f32 copy"
    if chunk is not None:
        cfg32 = dataclasses.replace(
            cfg32, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        label += f" (chunk {chunk})"
    torch.cuda.reset_peak_memory_stats(dev)
    state = ts.init_train_state(cfg32, 0, device=dev)
    batch = batch_from_numpy(np_batch, device=dev)
    m32, _ = _compare_step1(label, cfg32, rl, state, batch, (True, True),
                            bounds[:2], agree)
    if bf16_step1 is not None:
        rows = []
        for route, m16 in zip(("kernel", "plain"), bf16_step1):
            worst, key = _worst_rel(m16, m32, f"{label} vs bf16 {route}")
            gn = abs(float(m16["grad_norm"]) - float(m32["grad_norm"])) \
                / max(abs(float(m32["grad_norm"])), ROUTE_FLOOR)
            rows.append(f"bf16 {route} route {worst:.3e} ({key}), grad norm "
                        f"{gn:.3e}")
        print(f"[train] {cfg.name} step 1, each bf16 route against the f32 "
              f"copy's kernel route (max rel diff over loss, metrics and "
              f"grad norm; printed): {' | '.join(rows)}")
    del state, batch
    torch.cuda.empty_cache()
    hist = {mode: _run_steps(dev, cfg32, rl, np_batch, mode, remat=True)[0]
            for mode in ("cuda", "torch")}
    _compare_steps(label, hist["cuda"], hist["torch"], bounds[2])
    peak = torch.cuda.max_memory_allocated(dev)
    if not peak < TRAIN_MEM_LIMIT:
        raise AssertionError(f"{label}: peak memory {peak / 1e9:.1f} GB")


def phase_train_env(dev, arch, n_layers, obs_len, counters, route_bound, *,
                    remat=False):
    """One GIPO train step of ``arch`` (full width, ``n_layers`` layers) on
    ``dummy_batch`` segments of ``obs_len`` observation tokens, from a
    seed-0 state on each route (``remat``: checkpointing each block): the
    kernel route's launches counted (``counters`` as phase_train's), and
    the two routes' loss, metrics and grad norm within ``route_bound``.
    Returns the launches by name."""
    import dataclasses
    from repro_torch.configs import RLConfig, get_config
    from repro_torch.data.trajectory import dummy_batch
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    np_batch = dummy_batch(8, 8, obs_len, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    t0 = time.perf_counter()
    (mk,), launches = _run_steps(dev, cfg, rl, np_batch, "cuda", n=1,
                                 counters=counters, remat=remat)
    (mp,), _ = _run_steps(dev, cfg, rl, np_batch, "torch", n=1, remat=remat)
    worst, worst_key = _worst_rel(mk, mp, f"{arch} T={obs_len}")
    print(f"[train] {arch} x {n_layers} layers on the env's sequences "
          f"({obs_len} + {cfg.action_dim} tokens): one step from seed 0 on "
          f"each route, {time.perf_counter() - t0:.1f} s with the state "
          f"made twice | launches {launches} | max rel diff over loss, "
          f"metrics and grad norm {worst:.3e} ({worst_key}; bound "
          f"{route_bound}) | loss {mk['loss']:.6f} vs {mp['loss']:.6f}")
    if not worst <= route_bound:
        raise AssertionError(f"{arch} T={obs_len}: routes differ in "
                             f"{worst_key} by {worst}")
    return launches


def _leaf_grad_diff(got, exp):
    """|got - exp| / |exp| (Frobenius norms) for every leaf, taking each
    layer of a stacked leaf (``layers``, the hybrid's ``layers_rem``) on its
    own: [(value, leaf[layer])], largest first, NaN first of all."""
    import torch
    from repro_torch.tree import tree_leaves_with_path
    ref = dict(tree_leaves_with_path(exp))
    out = []
    for path, g in tree_leaves_with_path(got):
        parts = (enumerate(zip(g, ref[path])) if path[0] in STACKED
                 else [(None, (g, ref[path]))])
        for i, (a, b) in parts:
            rel = (torch.linalg.vector_norm(a - b)
                   / torch.linalg.vector_norm(b)).item()
            out.append((rel, ".".join(path)
                        + ("" if i is None else f"[{i}]")))
    return sorted(out, key=lambda d: (not math.isnan(d[0]), -d[0]))


def _action_hidden_diff(cfg, params, batch):
    """The value head's input, the final hidden states of the action
    tokens, from one no-grad forward of the first micro-batch's sequences on
    each route. Returns |h_kernel - h_plain| / |h_plain|, the same for h
    centred over the action positions, and |centred h| / |h| (plain)."""
    import torch
    from repro_torch.core.train_step import _flat
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    b, tp1, a = batch.actions.shape[:3]
    b //= 2
    tokens = torch.cat([_flat(batch.obs_tokens[:b], b, tp1),
                        _flat(batch.actions[:b], b, tp1)], 1)
    prefix = (None if batch.prefix_embeds is None
              else _flat(batch.prefix_embeds[:b], b, tp1))
    h = {}
    with torch.no_grad():
        for mode in ("cuda", "torch"):
            with dispatch.forced(mode):
                h[mode] = transformer.forward(
                    cfg, params, tokens, prefix,
                    head=False)["hidden"][:, -a:].float()
    c = {m: x - x.mean(1, keepdim=True) for m, x in h.items()}
    norm = torch.linalg.vector_norm
    return (*((norm(x["cuda"] - x["torch"]) / norm(x["torch"])).item()
              for x in (h, c)),
            (norm(c["torch"]) / norm(h["torch"])).item())


def _trace_train_step(dev, label, step, state, np_batch):
    """One more train step under torch.profiler: wall, device busy time and
    the kernels that take it, by kind. After the counted steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, np_batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, _, by_kind = _device_time(prof)
    if busy_ms == 0:
        print(f"[trace] one {label} train step: wall {wall_ms:.1f} ms traced;"
              f" device time not measured (the profiler saw no kernels)")
        return
    print(f"[trace] one {label} train step (4th), traced: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% | by kind: {by_kind}")


def _combine(pg, ent, kl):
    """A loss of the three differentiable outputs, so that each cotangent
    is nonzero."""
    return pg + 0.1 * kl - 0.01 * ent


def phase_ops(dev, cfg, counters):
    """The kernel-ops entry point (``repro_torch.kernels.ops``): every op
    once on CUDA tensors with the launches counted (``counters`` as
    phase_model's), then each result against the plain route. The two K5
    ops run on ``cfg``'s full-depth f32 action logits of one train
    micro-batch (seed-0 weights, ``dummy_batch`` of SSM_OBS-token
    sequences, the behaviour log-prob within 0.1 of the model's own, so
    that ω is near 1 and the surrogate carries weight): loss and metrics against ``ref.reference_gipo_loss`` and
    the plain route, d_logits (of the three terms together and of each
    alone) against the plain route's autograd, and K5 on hidden·w against
    K4 (``fused_policy_loss_op``) on the same hidden
    states and head weight. The attention and SSD ops run at ``cfg``'s
    shapes. Returns the launches by name."""
    import torch
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs import RLConfig
    from repro_torch.core import train_step as ts
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.kernels import dispatch, ops, ref
    from repro_torch.kernels.flash_attention import _plain_dense
    from repro_torch.kernels.ssd_scan import plain_ssd_scan
    from repro_torch.models.policy import init_policy_params
    rl = RLConfig()
    sigma = rl.gipo_sigma
    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_policy_params(cfg, 0, device=dev)
    np_batch = dummy_batch(8, 8, SSM_OBS - cfg.action_dim, cfg.action_dim,
                           cfg.vocab_size, cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)
    slice_i, _ = ts._microbatches(batch_from_numpy(np_batch, device=dev),
                                  rl.grad_accum)
    micro = slice_i(0)
    t = micro.horizon
    with torch.no_grad():
        hidden, _, _ = ts._score_batch_hidden(cfg, params, micro,
                                              remat=False)
    b, a = hidden.shape[0], micro.actions.shape[2]
    h = hidden[:, :t].reshape(b * t * a, -1).contiguous()
    w = params["action_head"]["w"]
    logits = h.float() @ w.float()
    del hidden, params

    def per_token(x):
        return x[..., None].expand(b, t, a).reshape(-1).contiguous()
    targets = micro.actions[:, :t].reshape(-1).to(torch.int32).contiguous()
    own = torch.log_softmax(logits, -1).gather(1, targets.long()[:, None])
    rows = [targets,
            own[:, 0] + 0.1 * torch.randn(own.shape[0], generator=gen,
                                          device=dev),
            per_token(torch.randn(b, t, generator=gen, device=dev)),
            per_token(micro.mask)]
    heads, dim = cfg.num_heads, cfg.head_dim
    qkv = [torch.randn(8, SSM_OBS, heads, dim, generator=gen,
                       device=dev).bfloat16() for _ in range(3)]
    n_ssd = cfg.ssm.num_heads(cfg.d_model)
    sargs = _ssd_case(gen, dev, 8, SSM_OBS, n_ssd, cfg.ssm.head_dim,
                      cfg.ssm.state_dim, torch.bfloat16)
    torch.cuda.synchronize()

    for fn, _ in counters.values():
        fn.launches = 0
    lg = logits.clone().requires_grad_()
    k5 = ops.gipo_head_loss_op(lg, *rows, sigma=sigma)
    _combine(*k5[:3]).backward(retain_graph=True)
    k5_pg, k5_m = ops.gipo_loss_op(logits, *rows, sigma=sigma)
    hh, ww = (x.detach().clone().requires_grad_() for x in (h, w))
    k4 = ops.fused_policy_loss_op(hh, ww, *rows, sigma=sigma)
    _combine(*k4[:3]).backward()
    att = {c: ops.flash_attention_op(*qkv, causal=c) for c in (True, False)}
    y, s_final = ops.ssd_scan_op(*sargs, chunk=cfg.ssm.chunk)
    torch.cuda.synchronize()
    got = {k: fn.launches for k, (fn, _) in counters.items()}
    if got != {k: want for k, (_, want) in counters.items()}:
        raise AssertionError(f"kernel-ops launches {got}")

    # the plain route: K5's autodiffed forward math, K4's, the unfused
    # oracle
    lp = logits.clone().requires_grad_()
    hp, wp = (x.detach().clone().requires_grad_() for x in (h, w))
    with dispatch.forced("torch"):
        plain = dispatch.gipo_loss(lp, *rows, sigma=sigma)
        _combine(*plain[:3]).backward(retain_graph=True)
        p4 = dispatch.policy_head_loss(hp, wp, *rows, sigma=sigma)
        _combine(*p4[:3]).backward()
    oracle_pg, oracle_m = ref.reference_gipo_loss(logits, *rows, sigma)

    def flat(out):
        return dict(zip(("pg", "entropy", "kl"), out[:3]), **out[3])
    pairs = [("gipo_head_loss_op vs plain", flat(k5), flat(plain)),
             ("gipo_loss_op vs plain",
              dict(k5_m, pg=k5_pg), dict(flat(plain))),
             ("gipo_loss_op vs reference_gipo_loss",
              dict(pg=k5_pg, ratio_mean=k5_m["ratio_mean"],
                   omega_mean=k5_m["omega_mean"]),
              dict(oracle_m, pg=oracle_pg)),
             ("K5 on hidden.w vs K4", flat(k5), flat(k4)),
             ("fused_policy_loss_op vs plain", flat(k4), flat(p4))]
    worst = {}
    for label, got_m, exp_m in pairs:
        if set(got_m) != set(exp_m):
            raise AssertionError(f"{label}: keys {sorted(got_m)} vs "
                                 f"{sorted(exp_m)}")
        rel = max(abs(got_m[k].item() - exp_m[k].item())
                  / max(abs(exp_m[k].item()), 1.0) for k in exp_m)
        if not rel <= F32_MAX_ERR:
            raise AssertionError(f"{label}: rel diff {rel}")
        worst[label] = rel
    omega = plain[3]["omega_mean"].item()
    if not omega > 0.5:
        raise AssertionError(f"kernel-ops: ω mean {omega}")
    d_err = _check_f32_out("gipo_head_loss_op d_logits", lg.grad, lp.grad)
    # each term's d_logits alone, so that none hides under another
    term_err = {}
    for i, term in enumerate(("pg", "entropy", "kl")):
        got_d, = torch.autograd.grad(k5[i], lg, retain_graph=True)
        exp_d, = torch.autograd.grad(plain[i], lp, retain_graph=True)
        term_err[term] = _check_f32_out(
            f"gipo_head_loss_op d_logits of {term}", got_d, exp_d)[0]
    k4_err = [_check_grad(f"fused_policy_loss_op {n}", x, y, torch.bfloat16)
              for n, x, y in (("dh", hh.grad, hp.grad),
                              ("dw", ww.grad, wp.grad))]
    att_err = {c: _check_close(f"flash_attention_op causal={c}", att[c],
                               _plain_dense(*qkv, causal=c), torch.bfloat16)
               for c in att}
    ey, es = plain_ssd_scan(*sargs, cfg.ssm.chunk)
    ssd_err = [_check_f32_out(f"ssd_scan_op {n}", x, e)
               for n, x, e in (("y", y, ey), ("s_final", s_final, es))]
    print(f"[ops] kernel-ops entry point on the card, {cfg.name}'s shapes: "
          f"launches {got} | K5 on the full-depth f32 action logits of one "
          f"train micro-batch (N={logits.shape[0]} Va={logits.shape[1]}): "
          f"loss {k5[0].item():.6f}, entropy {k5[1].item():.5f}, kl "
          f"{k5[2].item():.5f}, ω mean {omega:.4f}; max rel diff (bound {F32_MAX_ERR}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" | d_logits vs the plain route's autograd {d_err[0]:.3e} "
          f"({d_err[1]:.3e} of the largest), each term alone "
          + ", ".join(f"{k} {v:.3e}" for k, v in term_err.items())
          + f" | K4 dh {k4_err[0][0]:.3e} dw "
          f"{k4_err[1][0]:.3e} | flash causal/not {att_err[True]:.3e} / "
          f"{att_err[False]:.3e} | ssd y {ssd_err[0][0]:.3e} s_final "
          f"{ssd_err[1][0]:.3e}")
    return got


def _system_config(arch="openvla-7b", n_layers=TRAIN_LAYERS):
    """The system phases' model and settings: ``arch`` at full width and
    ``n_layers`` layers (openvla-7b: TRAIN_LAYERS), the training phase's
    RL settings, 8 rollout workers, inference batch 8, the prefetcher's
    pinned copies."""
    import dataclasses
    from repro_torch.configs import RLConfig, RuntimeConfig, get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4, grad_accum=2)
    rt = RuntimeConfig(num_rollout_workers=8, inference_batch=8,
                       prefetch_to_device=True)
    return cfg, rl, rt


def _run_system(dev, counters, tag, build, go, steps, floor, served=None):
    """Builds a system (``build``), drives it (``go``) and holds what every
    system run must: the budget reached with every service healthy, finite
    metrics, lag >= 0, at least two weight swaps in each serving service
    (``served(system)``: their (name, swaps, version served); the
    system's own inference service by default), each within one version
    of the last one published within the budget (the trainer may finish
    one more step while the scheduler stops it, after the rollouts have
    stopped asking), no published leaf sharing storage with the
    trainer's live params (an ``on_publish`` hook), each counter of
    ``counters`` (name -> (wrapper, _), set to 0 just before the run and
    read just after) risen by at least ``floor(system, m)[name]``, and peak
    memory under TRAIN_MEM_LIMIT. Returns (system, m, launches, peak,
    facts), ``facts`` holding the build time, the published versions, the
    version-0 snapshot and the memory allocated before the build."""
    import torch
    from repro_torch.tree import tree_leaves
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    system = build()
    torch.cuda.synchronize()
    facts = {"t_init": time.perf_counter() - t0, "before": before,
             "published": []}
    trainer = system.trainer
    aliased = []

    def on_publish(params, version):
        # trainer thread, right after the store took the snapshot
        live = {x.untyped_storage().data_ptr()
                for x in tree_leaves(trainer.state.params)}
        aliased.extend(version for x in tree_leaves(params)
                       if x.untyped_storage().data_ptr() in live)
        facts["published"].append(version)
        if version == 0:
            facts["v0"] = params
    system.store.on_publish = on_publish
    for fn, _ in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    m = go(system)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, (fn, _) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    bad = {k: h for k, h in system.health().items() if not h["healthy"]}
    if bad:
        raise AssertionError(f"{tag}: services failed {bad}")
    # batches served here and in any remote child or spawned inference
    # tier (bridged counters)
    hosts = list(system.remote_hosts)
    if system.inference_plane_host is not None:
        hosts.append(system.inference_plane_host)
    nb = m["inference_batches"] + sum(h.metrics.counter("batches")
                                      for h in hosts)
    done = m["train_steps"]
    log = trainer.metrics_log
    if done < steps or len(log) != done:
        raise AssertionError(f"{tag}: {done} train steps of {steps} "
                             f"({len(log)} logged) in {m['wall_s']:.1f} s")
    if not (m["env_steps"] > 0 and nb > 0):
        raise AssertionError(f"{tag}: env steps {m['env_steps']}, "
                             f"batches {nb}")
    nonfinite = [(i, k) for i, e in enumerate(log) for k, v in e.items()
                 if not math.isfinite(v)]
    lags = [e["policy_lag"] for e in log]
    if nonfinite or min(lags) < 0 or m["mean_policy_lag"] < 0:
        raise AssertionError(f"{tag}: non-finite metrics {nonfinite}, "
                             f"policy lags {lags}")
    last = min(system.store.version(), steps)
    for name, swaps, gauge in (served or _served_here)(system):
        if swaps < 2 or not gauge >= last - 1:
            raise AssertionError(f"{tag}: {name} {swaps} swaps, serving "
                                 f"v{gauge} while v{last} was published")
    if aliased:
        raise AssertionError(f"{tag}: published versions "
                             f"{sorted(set(aliased))} share storage with "
                             f"the live params")
    short = {k: (launches[k], n) for k, n in floor(system, m).items()
             if launches[k] < n}
    if short:
        raise AssertionError(f"{tag}: launches below what {nb} batches and "
                             f"{done} steps need (got, floor): {short}")
    if not peak < TRAIN_MEM_LIMIT:
        raise AssertionError(f"{tag}: peak memory {peak / 1e9:.1f} GB")
    return system, m, launches, peak, facts


def _served_here(system):
    """(name, weight swaps, version served) of the system's own inference
    service."""
    service = system.inference
    return [(service.name, service.weight_swaps,
             service.metrics.gauge("weight_version"))]


def _step_floor(n_l, ga, a, nb, done, tc=True):
    """The least launches ``nb`` served batches and ``done`` train steps
    make: K2 on every decode token's layers, K1 on every prefill's and
    every micro-batch's layers, K3 on every micro-batch's layers, K4
    (forward and backward; ``tc``: bf16, on the tensor-core body) on every
    micro-batch."""
    tc = ga * done if tc else 0
    return {"decode_attention": a * n_l * nb,
            "flash_attention": n_l * nb + n_l * ga * done,
            "flash_attention_bwd": n_l * ga * done,
            "fused_policy_loss_fwd": ga * done,
            "fused_policy_loss_bwd": ga * done,
            "fused_policy_loss_fwd tensor-core body": tc,
            "fused_policy_loss_bwd tensor-core body": tc}


def _replay_step1(dev, cfg, rl, tag, params0, first, log0, checks=DENSE):
    """Step 1 of a run replayed on route ``checks.replay`` from the
    published v0 snapshot, with fresh moments and Welford state, on the
    trainer's first batch, whose behaviour log-probs v0 itself served: the
    training phase's step-1 bounds on live behaviour log-probs hold
    (LIVE_STEPS_BOUND[0]: the KL, entropy and grad norm within
    LIVE_ROUTE_BOUND); the loss and the other metrics, whose terms nearly
    cancel on live log-probs, are printed, as there. With
    ``checks.hold_served``, on both runs the KL of v0 against the served μ
    is at most REPLAY_KL_BOUND and ω's mean within REPLAY_OMEGA_TOL of 1;
    else they are printed. Returns the replay's metrics."""
    import gc
    import torch
    from repro_torch.core import advnorm, train_step as ts
    from repro_torch.kernels import dispatch
    from repro_torch.optim import adamw
    state = ts.TrainState(params=params0, opt=adamw.init(params0),
                          adv_norm=advnorm.init_adv_state(dev),
                          version=torch.zeros((), dtype=torch.int32,
                                              device=dev))
    mode = checks.replay
    moe_gaps = (_router_gaps() if checks.agree is not None
                else contextlib.nullcontext(None))
    with moe_gaps as gaps, dispatch.forced(mode):
        m_replay = ts.make_train_step(cfg, rl, device=dev)(state, first)[1]
    m_replay = {k: v.item() for k, v in m_replay.items()}
    gap_note = "" if not gaps else (
        f" | the replay's closest router top-k boundary gap "
        f"{min(g[0] for g in gaps):.3e}, {sum(g[1] for g in gaps)} under "
        f"1e-5 of {sum(g[2] for g in gaps)} (token, call) pairs")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    worst, worst_key = _worst_rel(log0, m_replay, f"{tag} step-1 replay")
    held = LIVE_STEPS_BOUND[0]
    rel = {k: abs(log0[k] - v) / max(abs(v), ROUTE_FLOOR)
           for k, v in m_replay.items()}
    print(f"{tag} step 1 (kernel route, in the system) vs its replay on "
          f"the {'plain' if mode == 'torch' else 'kernel'} route from the "
          f"published v0 snapshot: "
          + ", ".join(f"{k} rel {rel[k]:.3e}" for k in held)
          + f" (bound {LIVE_ROUTE_BOUND}) | printed: max rel diff over "
          f"{len(m_replay)} metrics {worst:.3e} ({worst_key}), "
          + ", ".join(f"{k} {r:.3e}" for k, r in rel.items()
                      if k not in held)
          + f" | loss {log0['loss']:.6f} vs {m_replay['loss']:.6f}, omega "
          f"mean {log0['omega_mean']:.4f} vs {m_replay['omega_mean']:.4f}, "
          f"kl {log0['kl']:.3e} vs {m_replay['kl']:.3e}, grad norm "
          f"{log0['grad_norm']:.4f} vs {m_replay['grad_norm']:.4f} | batch "
          f"policy versions {sorted(set(first.policy_version.tolist()))} | "
          f"the KL of v0 against the served μ and ω's mean "
          f"{'held' if checks.hold_served else 'printed'} (bound "
          f"{REPLAY_KL_BOUND}, 1 ± {REPLAY_OMEGA_TOL})" + gap_note)
    over = {k: rel[k] for k, bound in held.items() if not rel[k] <= bound}
    if over:
        raise AssertionError(f"{tag} step-1 replay differs: {over}")
    for route, m in (("system's", log0), ("replay's", m_replay)):
        if checks.hold_served and not (
                m["kl"] <= REPLAY_KL_BOUND
                and abs(m["omega_mean"] - 1.0) <= REPLAY_OMEGA_TOL):
            raise AssertionError(
                f"{tag} step 1, the {route} run: kl {m['kl']} (bound "
                f"{REPLAY_KL_BOUND}), omega mean {m['omega_mean']} (1 ± "
                f"{REPLAY_OMEGA_TOL}): v0 did not serve the batch's μ")
    return m_replay


def phase_system(dev, smi, counters, *, arch="openvla-7b",
                 n_layers=TRAIN_LAYERS, sync=True, checks=DENSE, edit=None,
                 note="", async_keys=None):
    """The asynchronous system end to end: ``_system_config(arch,
    n_layers)``'s model (``edit``: a function of its config, to run a copy,
    named by ``note``) on the toy env's spatial suite, the inference service, the
    prefetcher's pinned H2D path and the trainer on one card, with no
    route forced. ``run_async`` for SYSTEM_STEPS[0] steps, then (``sync``)
    on a fresh system ``run_sync`` for SYSTEM_STEPS[1], each held by
    ``_run_system`` with ``_step_floor``'s launches; every step's metrics
    must carry ``checks.metric_keys``. Step 1 of the async run is replayed
    (``_replay_step1`` with ``checks``). ``async_keys``: a set to which
    the async run's metric keys are added. Returns the launches by name of
    each run."""
    import gc
    import torch
    from repro_torch.runtime import AcceRLSystem
    cfg, rl, rt = _system_config(arch, n_layers)
    if edit is not None:
        cfg = edit(cfg)
    n_l, ga, a = n_layers, rl.grad_accum, cfg.action_dim
    tc = cfg.compute_dtype == "bfloat16"     # K4's tensor-core body
    out = {}
    t_phase = time.perf_counter()

    def run(label, go, steps):
        system, m, launches, peak, facts = _run_system(
            dev, counters, f"[system] {label}",
            lambda: AcceRLSystem(cfg, rl, rt, suite="spatial",
                                 segment_horizon=8, max_episode_steps=16,
                                 batch_episodes=8, seed=0, device=dev),
            go, steps, lambda s, m: _step_floor(
                n_l, ga, a, m["inference_batches"], m["train_steps"], tc))
        trainer, service = system.trainer, system.inference
        done, log = m["train_steps"], trainer.metrics_log
        lat = service.metrics.series("batch_s")
        keys = checks.metric_keys
        if not all(k in e for e in log for k in keys):
            raise AssertionError(f"[system] {label}: metrics {keys} missing "
                                 f"from {[sorted(e) for e in log]}")
        keys_line = "".join(
            f" | {k} per step {[round(e[k], 5) for e in log]}" for k in keys)
        print(f"[system] {label}: {cfg.name} x {n_l} layers "
              f"({cfg.param_dtype}), 8 rollout "
              f"workers, inference batch 8, batch_episodes 8 x horizon 8, "
              f"grad_accum {ga} | system built in {facts['t_init']:.1f} s "
              f"| wall {m['wall_s']:.2f} s, {done} train steps, "
              f"{m['env_steps']} env steps, {m['episodes']} episodes | "
              f"sps_env {m['sps_env']:.2f}, sps_train {m['sps_train']:.2f} "
              f"| trainer_util {m['trainer_util']:.3f} (busy "
              f"{trainer.busy_s / done * 1e3:.1f} ms a step), "
              f"inference_util {m['inference_util']:.3f} | mean_policy_lag "
              f"{m['mean_policy_lag']:.3f} (per step "
              f"{[e['policy_lag'] for e in log]}) | inference batches "
              f"{m['inference_batches']}, batch_s p50 "
              f"{statistics.median(lat) * 1e3:.1f} ms, max "
              f"{max(lat) * 1e3:.1f} ms | swaps {service.weight_swaps}, "
              f"serving v{service.metrics.gauge('weight_version'):.0f}, "
              f"published {facts['published']}, sync latency "
              f"{m['sync_latency_s'] * 1e3:.2f} ms | prefetcher "
              f"{trainer.prefetcher.metrics()} | launches {launches} | "
              f"max_memory_allocated {peak / 1e9:.2f} GB (allocated "
              f"before the build {facts['before'] / 1e9:.2f} GB)"
              f"{keys_line} | {smi}")
        out[label] = launches
        if async_keys is not None and label.startswith("run_async"):
            async_keys.update(m)
        return system, facts

    system, facts = run("run_async" + note, lambda s: s.run_async(
        train_steps=SYSTEM_STEPS[0], wall_timeout_s=240.0), SYSTEM_STEPS[0])
    first, log0 = system.trainer.first_batch, system.trainer.metrics_log[0]
    params0 = facts.pop("v0")
    del system, facts
    gc.collect()
    torch.cuda.empty_cache()
    _replay_step1(dev, cfg, rl, f"[system] run_async{note}", params0, first,
                  log0, checks)
    del params0, first
    gc.collect()
    torch.cuda.empty_cache()
    if sync:
        system, _ = run("run_sync", lambda s: s.run_sync(
            train_steps=SYSTEM_STEPS[1], episodes_per_round=8,
            wall_timeout_s=240.0), SYSTEM_STEPS[1])
        del system
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[system] {cfg.name}{note} phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def _f32_copy(cfg, drops=True):
    """An f32 copy of ``cfg``; ``drops=False``: a moe config's at
    capacity_factor E/k, where an expert's capacity is its group's token
    count, so no assignment drops, whatever the groups."""
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if drops:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _wm_step_parity(dev, wm, pre, action_vocab, action_dim):
    """One M_obs step and one M_reward step from the pre-trained weights
    and moments, on the card and on a CPU copy, with the same batch and the
    same explicit noise (drawn on the CPU): every leaf of the new weights
    and moments, and each loss, within WM_PARITY_TOL of its largest value
    (f32; TF32 is off). Returns the worst ratio to that bar."""
    import torch
    from repro_torch.envs.toy_manipulation import FRAME_DIM
    from repro_torch.wm import denoiser as dn, reward as rw
    from repro_torch.wm.wm_system import _clone
    gen = torch.Generator().manual_seed(0)
    b = 32
    f0 = torch.rand(b, FRAME_DIM, generator=gen)
    batch = dict(
        f1=torch.rand(b, FRAME_DIM, generator=gen),
        hist=f0[:, None].repeat(1, wm.history_frames, 1),
        acts=torch.randint(0, action_vocab, (b, action_dim), generator=gen),
        succ=(torch.rand(b, generator=gen) > 0.5).float(),
        z_sigma=torch.randn(b, generator=gen),
        z_noise=torch.randn(b, FRAME_DIM, generator=gen))
    out = {}
    for where in (dev, torch.device("cpu")):
        x = {k: v.to(where) for k, v in batch.items()}
        obs, obs_opt, l_obs = dn.make_denoiser_train_step(wm)(
            _clone(pre["obs"], where), _clone(pre["obs_opt"], where),
            None, x["f1"], x["hist"], x["acts"], z_sigma=x["z_sigma"],
            z_noise=x["z_noise"])
        rew, rew_opt, l_rew = rw.make_reward_train_step()(
            _clone(pre["reward"], where),
            _clone(pre["reward_opt"], where), x["f1"], x["succ"])
        out[where.type] = {
            "loss": {"obs": l_obs, "reward": l_rew},
            "obs": obs, "obs mu": obs_opt.mu, "obs nu": obs_opt.nu,
            "reward": rew, "reward mu": rew_opt.mu, "reward nu": rew_opt.nu}
    worst, worst_key = 0.0, None
    for group, leaves in out["cpu"].items():
        for k, exp in leaves.items():
            got = out["cuda"][group][k].cpu()
            bar = WM_PARITY_TOL * max(float(exp.abs().max()), 1e-30)
            r = float((got - exp).abs().max()) / bar
            if not r <= worst:
                worst, worst_key = r, f"{group} {k}"
    if not worst <= 1.0:
        raise AssertionError(f"[wm] card vs CPU WM step: {worst_key} at "
                             f"{worst:.3f} x the bar")
    return worst, worst_key


def phase_wm(dev, smi, counters):
    """The world-model mode (paper §4) end to end on ``_system_config``'s
    model: the world model pre-trained on the card on the env's oracle
    trajectories (every loss finite, the denoiser's mean over its last 10
    steps below its first 10); one M_obs and one M_reward step held
    against a CPU copy (``_wm_step_parity``); then ``AcceRLWMSystem`` with
    one imagination worker (batch WM_IMAGINATION_BATCH, ``WMConfig()``'s
    horizon 2, 8 Euler steps) and the pure-imagination diet
    (``mix_real_fraction`` 0), ``run_wm`` for WM_STEPS steps, held by
    ``_run_system`` with ``_step_floor``'s launches plus K1 on H x layers
    and K2 on H x 7 x layers an imagination call. The mixed source must
    have taken no real segment, imagination must have made every trained
    step, the WM trainer must have updated M_obs, and the WM trees bound
    before the run must be bit-equal to their clones while the M_obs entry
    was rebound. Step 1 (an imagined batch dreamed under v0) is replayed
    on the plain route (``_replay_step1``, which also holds the KL of v0
    against the imagined μ and ω's mean near 1), ω mean above 0.5. One
    ``[wm]`` line (``_wm_run``). Returns the run's launches by name and the
    pre-trained world model."""
    from repro_torch.configs import WMConfig
    from repro_torch.wm.wm_system import pretrain_world_model
    t_phase = time.perf_counter()
    cfg, _, rt = _system_config()
    wm = WMConfig()
    a = cfg.action_dim

    t0 = time.perf_counter()
    pre = pretrain_world_model(
        "spatial", wm, trajectories=50, train_steps=100, batch=64,
        action_vocab=cfg.action_vocab_size, action_dim=a, device=dev)
    t_pre = time.perf_counter() - t0
    lo, lr_ = pre["losses"]["obs"], pre["losses"]["reward"]
    first10, last10 = statistics.fmean(lo[:10]), statistics.fmean(lo[-10:])
    print(f"[wm] pre-training on the card: {pre['transitions']} oracle "
          f"transitions of 50 trajectories, 100 steps of batch 64 in "
          f"{t_pre:.2f} s | denoiser loss {lo[0]:.4f} -> {lo[-1]:.4f}, mean "
          f"of the first 10 steps {first10:.4f}, of the last 10 "
          f"{last10:.4f} | reward loss {lr_[0]:.4f} -> {lr_[-1]:.4f}")
    if not all(math.isfinite(x) for x in lo + lr_) or not last10 < first10:
        raise AssertionError("[wm] pre-training: non-finite or no falling "
                             "denoiser loss")
    worst, worst_key = _wm_step_parity(dev, wm, pre, cfg.action_vocab_size,
                                       a)
    print(f"[wm] one M_obs and one M_reward step, card vs CPU on the same "
          f"noise: worst leaf at {worst:.3e} of the bar ({worst_key}; bar "
          f"{WM_PARITY_TOL} of each leaf's largest value)")

    launches = _wm_run(dev, smi, counters, pre, rt, "[wm] run_wm")
    print(f"[wm] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, pre


def _wm_run(dev, smi, counters, pre, rt, tag, *, alone=True, check=None):
    """``AcceRLWMSystem`` on ``_system_config``'s model with runtime config
    ``rt``, the pre-trained world model ``pre``, one imagination worker
    (batch WM_IMAGINATION_BATCH) and the pure-imagination diet: ``run_wm``
    for WM_STEPS steps held as ``phase_wm`` says, then (``alone``) one
    imagination call timed with the services stopped, one ``tag`` line,
    and step 1 replayed on the plain route. ``check(system, m)``: more
    checks on the run (raising), returning text for the line. Returns the
    run's launches by name."""
    import gc
    import torch
    from repro_torch.configs import WMConfig
    import numpy as np
    from repro_torch.wm import AcceRLWMSystem
    from repro_torch.wm.imagination import make_imagine_fn
    cfg, rl, _ = _system_config()
    wm = WMConfig()
    n_l, ga, a, h = (TRAIN_LAYERS, rl.grad_accum, cfg.action_dim,
                     wm.imagine_horizon)
    ib = WM_IMAGINATION_BATCH
    held = {}

    def go(system):
        for k in ("obs", "reward"):
            held[k] = system.wm_params[k]
            held[f"{k} clone"] = {n: x.clone() for n, x in held[k].items()}
        return system.run_wm(train_steps=WM_STEPS, wall_timeout_s=240.0)

    def floor(system, m):
        calls = sum(im.segments_done for im in system.imaginers) // ib
        f = _step_floor(n_l, ga, a, m["inference_batches"],
                        m["train_steps"])
        f["flash_attention"] += h * n_l * calls
        f["decode_attention"] += h * a * n_l * calls
        return f

    system, m, launches, peak, facts = _run_system(
        dev, counters, tag,
        lambda: AcceRLWMSystem(
            cfg, rl, rt, wm, wm_params=pre, num_imagination_workers=1,
            imagination_batch=ib, suite="spatial", segment_horizon=8,
            max_episode_steps=16, batch_episodes=8, seed=0, device=dev),
        go, WM_STEPS, floor)
    trainer, service = system.trainer, system.inference
    imaginer, src = system.imaginers[0], trainer.source
    done = m["train_steps"]
    calls = imaginer.segments_done // ib
    problems = []
    if not m["imagined_steps"] >= ib * h * done:
        problems.append(f"imagined steps {m['imagined_steps']}")
    if not m["img_train_steps"] >= done:
        problems.append(f"img_train_steps {m['img_train_steps']}")
    if not m["wm_updates"]["obs"] >= 1:
        problems.append(f"WM updates {m['wm_updates']}")
    if src.real_consumed != 0 or not src.imagined_consumed >= ib * done:
        problems.append(f"consumed real {src.real_consumed}, imagined "
                        f"{src.imagined_consumed}")
    changed = [f"{k} {n}" for k in ("obs", "reward")
               for n, x in held[k].items()
               if not torch.equal(x, held[f"{k} clone"][n])]
    if changed or system.wm_params["obs"] is held["obs"]:
        problems.append(f"bound WM trees written {changed} or M_obs not "
                        f"rebound")
    if problems:
        raise AssertionError(f"{tag}: {problems}")
    extra = "" if check is None else check(system, m)
    alone_note = ""
    if alone:
        # one imagination call alone, the services stopped: on v0, the WM
        # trees as the run left them, seeds from B_wm (median of 3 after
        # one)
        fn = make_imagine_fn(cfg, wm, device=dev)
        seeds = system.frame_channel.sample(ib)
        args = (np.stack([x["tokens"] for x in seeds]),
                np.stack([x["frame"] for x in seeds]).astype(np.float32),
                np.array([x["step"] for x in seeds], np.int32))
        gen = torch.Generator(device=dev).manual_seed(1)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            fn(facts["v0"], system.wm_params["obs"],
               system.wm_params["reward"], gen, *args)
            times.append(time.perf_counter() - t0)
        alone_note = (f" (alone, the services stopped: "
                      f"{statistics.median(times[1:]) * 1e3:.1f} ms)")
    wmt = system.wm_trainer
    n_upd = sum(m["wm_updates"].values())
    lat = service.metrics.series("batch_s")
    wall = m["wall_s"]
    print(f"{tag}: {cfg.name} x {n_l} layers, 8 rollout workers, "
          f"inference batch 8, 1 imagination worker of batch {ib}, horizon "
          f"{h}, {wm.diffusion_steps} Euler steps, mix_real_fraction "
          f"{m['mix_real_fraction']}, grad_accum {ga} | system built in "
          f"{facts['t_init']:.1f} s | wall {wall:.2f} s, {done} train "
          f"steps | imagined steps {m['imagined_steps']} "
          f"({m['imagined_steps'] / wall:.2f}/s) in {calls} calls, busy "
          f"{imaginer.metrics.counter('busy_s') / max(calls, 1) * 1e3:.1f} "
          f"ms a call{alone_note} | real env steps "
          f"{m['real_env_steps']}, sps_env "
          f"{m['sps_env']:.2f} | real_env_steps / img_train_steps "
          f"{m['real_env_steps'] / max(m['img_train_steps'], 1):.2f} | "
          f"sps_train {m['sps_train']:.2f}, trainer_util "
          f"{m['trainer_util']:.3f} (busy {trainer.busy_s / done * 1e3:.1f}"
          f" ms a step), inference_util {m['inference_util']:.3f} | "
          f"mean_policy_lag {m['mean_policy_lag']:.3f} (per step "
          f"{[e['policy_lag'] for e in trainer.metrics_log]}) | WM updates "
          f"{m['wm_updates']} in {wmt.cycles} cycles, wm-trainer busy "
          f"{wmt.metrics.counter('busy_s'):.2f} s "
          f"({wmt.metrics.counter('busy_s') / max(n_upd, 1) * 1e3:.1f} ms "
          f"an update, util {wmt.utilization():.3f}) | "
          f"consumed imagined {src.imagined_consumed}, real "
          f"{src.real_consumed} | img_buffer_dropped "
          f"{m['img_buffer_dropped']} | inference batches "
          f"{m['inference_batches']}, batch_s p50 "
          f"{statistics.median(lat) * 1e3:.1f} ms | swaps "
          f"{service.weight_swaps}, published {facts['published']} | "
          f"launches {launches} | max_memory_allocated {peak / 1e9:.2f} GB "
          f"{extra}| {smi}")
    first, log0 = trainer.first_batch, trainer.metrics_log[0]
    params0 = facts.pop("v0")
    del system, facts, held, src, trainer, service, imaginer, wmt
    gc.collect()
    torch.cuda.empty_cache()
    _replay_step1(dev, cfg, rl, tag, params0, first, log0)
    if not log0["omega_mean"] > 0.5:
        raise AssertionError(f"{tag} step 1 omega mean {log0['omega_mean']}")
    del params0, first
    gc.collect()
    torch.cuda.empty_cache()
    return launches


_PLAN_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.core.train_step import init_train_state
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import zero
from repro_torch.tree import tree_leaves

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device="cpu")
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch)
    st = init_train_state(cfg, 0, mesh=mesh, device="meta")
    local = lambda t: t.to_local().numel() * t.to_local().element_size()
    params = sum(local(t) for t in tree_leaves(st.params))
    count = sum(t.numel() for t in tree_leaves(st.params))
    out[arch] = {"count": count,
                 "state": sum(t.numel() * t.element_size()
                              for t in tree_leaves(st.params)) + 8 * count,
                 "params": params,
                 "moments": zero.realized_moments_bytes_per_device(st.opt),
                 "analytic": zero.moments_bytes_per_device(count, 16, True)}
print(json.dumps(out))
"""


@contextlib.contextmanager
def _wm_cycle_threads():
    """The names of the threads that run ``WorldModelTrainer.train_cycle``
    while the block runs (the class's method wrapped in the script
    only)."""
    import threading
    from repro_torch.wm.wm_system import WorldModelTrainer
    cycle = WorldModelTrainer.train_cycle
    names = []

    def traced(self, batch):
        names.append(threading.current_thread().name)
        return cycle(self, batch)
    WorldModelTrainer.train_cycle = traced
    try:
        yield names
    finally:
        WorldModelTrainer.train_cycle = cycle


def phase_pipeline(dev, smi, counting, pre):
    """The pipelined executor (``rt.pipeline``) on the card, after
    ``phase_wm`` (whose pre-trained world model ``pre`` it reuses):

    (a) a ``TrainerWorker`` with ``rt.pipeline`` on openvla-7b at full
        width and TRAIN_LAYERS layers (grad_accum 2) beside a default one
        from the same seed, PIPE_ROUNDS rounds on the training phase's
        batch: each round bit for bit the fused step (params, moments,
        Welford state, metrics), K1/K3/K4 launched as a fused step
        launches them; per round the bubble, the peak micro-grad and live
        bytes and the round's wall;
    (b) ``AcceRLWMSystem.run_wm`` with ``rt.pipeline`` (``_wm_run``): the
        world-model phase's checks, every WM cycle run by the executor's
        WM stream (one a round, none by the WM trainer's own loop), the
        ``pipeline_*`` keys in ``metrics()``;
    (c) the disjoint layout ``(cuda:0, cpu)``: the policy on the card, a
        toy WM stage on the CPU; the round bit for bit the fused step, the
        state returned on the card;
    (d) the 16 x 16 plan's bytes per device for full-depth openvla-7b and
        dbrx-132b (a fake process group of 256 ranks in a subprocess, the
        trees on ``meta``) beside the card's 80 GB, and the one-rank NCCL
        mesh of ``make_local_mesh``.

    Returns the launches by path."""
    import dataclasses
    import gc
    import threading
    import torch
    import torch.distributed as dist
    from repro_torch.configs import RLConfig, RuntimeConfig, get_config
    from repro_torch.data.checkpoint import _flatten_with_path
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import (FifoChannel, TrainerWorker,
                                     VersionedWeightStore)
    from repro_torch.runtime import pipeline_exec as pe
    t_phase = time.perf_counter()
    out = {}
    cfg = dataclasses.replace(get_config("openvla-7b"),
                              num_layers=TRAIN_LAYERS)
    rl = RLConfig(warmup_steps=1, lr_policy=1e-4)
    ga = rl.grad_accum
    per_round = counting(flash_attention=TRAIN_LAYERS * ga,
                         flash_attention_bwd=TRAIN_LAYERS * ga,
                         fused_policy_loss_fwd=ga, fused_policy_loss_bwd=ga)
    want = {k: n for k, (_, n) in per_round.items()}
    np_batch = dummy_batch(8, 8, 12, cfg.action_dim, cfg.vocab_size,
                           cfg.action_vocab_size,
                           num_prefix=cfg.num_prefix_tokens, seed=0)

    # (a) pipelined rounds against the fused step
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    workers = {mode: TrainerWorker(cfg, rl, RuntimeConfig(pipeline=mode),
                                   FifoChannel(1), VersionedWeightStore(),
                                   batch_episodes=8, seed=0, device=dev)
               for mode in (True, False)}
    pipe, fused = workers[True], workers[False]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if not _bits_equal(pipe.state, fused.state):
        raise AssertionError("[pipeline] the two workers' seed-0 states "
                             "differ")
    totals = dict.fromkeys(per_round, 0)
    for r in range(PIPE_ROUNDS):
        t0 = time.perf_counter()
        m_fused = fused.train_on_batch(np_batch)
        t_fused = time.perf_counter() - t0
        for fn, _ in per_round.values():
            fn.launches = 0
        t0 = time.perf_counter()
        m_pipe = pipe.train_on_batch(np_batch)
        t_pipe = time.perf_counter() - t0
        got = {k: fn.launches for k, (fn, _) in per_round.items()}
        totals = {k: totals[k] + got[k] for k in totals}
        ex = pipe.pipeline
        print(f"[pipeline] (a) round {r + 1}: bubble "
              f"{ {k: round(v, 4) for k, v in ex.last_bubble.items()} }, "
              f"peak_grad_bytes {ex.peak_grad_bytes / 1e9:.3f} GB, "
              f"peak_live_bytes "
              f"{ {k: round(v / 1e9, 3) for k, v in ex.peak_live_bytes.items()} }"
              f" GB | wall {t_pipe * 1e3:.1f} ms (the fused step "
              f"{t_fused * 1e3:.1f} ms), both with a publish | launches "
              f"{ {k: v for k, v in got.items() if want[k]} } | loss "
              f"{m_pipe['loss']:.6f}")
        if got != want:
            raise AssertionError(f"[pipeline] round {r + 1}: launches {got}"
                                 f", a fused step makes {want}")
        if m_pipe != m_fused or not _bits_equal(pipe.state, fused.state):
            raise AssertionError(f"[pipeline] round {r + 1} differs from "
                                 f"the fused step: {m_pipe} vs {m_fused}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[pipeline] (a) {cfg.name} x {TRAIN_LAYERS} layers, grad_accum "
          f"{ga}, {PIPE_ROUNDS} rounds each bit for bit the fused step "
          f"(params, moments, Welford state, metrics) | both workers built "
          f"in {t_build:.1f} s | mesh {pipe._mesh} | program "
          f"{[s.name for s in pipe.program.stages]} | K1/K3/K4 launches "
          f"{ {k: v for k, v in totals.items() if v} } | "
          f"max_memory_allocated {peak / 1e9:.2f} GB (two states) | {smi}")

    # (c) the disjoint layout: policy on the card, a toy WM stage on the CPU
    layout = pe.SubmeshLayout.split((dev, torch.device("cpu")))
    seen = []
    ex = pe.PipelineExecutor(pipe.program, layout)
    ex.set_wm_stage(lambda b: seen.append(
        (threading.current_thread().name, torch.ones(len(b)).device)),
        lambda: [0, 1, 2])
    try:
        for fn, _ in per_round.values():
            fn.launches = 0
        t0 = time.perf_counter()
        s_pipe, m_pipe, _ = ex.run_round(pipe.state, np_batch)
        t_round = time.perf_counter() - t0
        got = {k: fn.launches for k, (fn, _) in per_round.items()}
        bubble = dict(ex.last_bubble)
    finally:
        ex.close()
    totals = {k: totals[k] + got[k] for k in totals}
    s_fused, m_fused = fused._step_fn(fused.state, np_batch)
    on_card = all(x.device == dev for _, x in _flatten_with_path(s_pipe))
    print(f"[pipeline] (c) disjoint layout (policy {layout.policy.devices}, "
          f"wm {layout.wm.devices}): round wall {t_round * 1e3:.1f} ms, "
          f"bubble { {k: round(v, 4) for k, v in bubble.items()} } | WM "
          f"stage ran on {seen} | state on the card {on_card} | launches "
          f"{ {k: v for k, v in got.items() if want[k]} }")
    if (got != want or not layout.disjoint or not on_card
            or seen != [("pipeline-wm", torch.device("cpu"))]
            or not _bits_equal(s_pipe, s_fused)
            or {k: v.item() for k, v in m_pipe.items()}
            != {k: v.item() for k, v in m_fused.items()}):
        raise AssertionError("[pipeline] (c) the disjoint layout's round")
    out["openvla-7b pipelined training"] = totals
    for w in workers.values():
        w.stop()
    del workers, pipe, fused, s_pipe, s_fused, ex
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the world model as the second stage, in the system
    _, _, rt = _system_config()

    def check(system, m):
        wmt, ex = system.wm_trainer, system.trainer.pipeline
        keys = ("pipeline_rounds", "pipeline_bubble",
                "pipeline_peak_grad_bytes")
        interval = wmt.wm.obs_train_interval
        if (not all(k in m for k in keys) or not wmt.driven
                or set(threads) != {"pipeline-wm"}
                or not 1 <= wmt.cycles == len(threads) <= ex.rounds
                or m["wm_updates"]["obs"] != wmt.cycles // interval):
            raise AssertionError(
                f"[pipeline] run_wm: {[(k, m.get(k)) for k in keys]}, "
                f"driven {wmt.driven}, WM cycles {wmt.cycles} on "
                f"{sorted(set(threads))}, rounds {ex.rounds}, updates "
                f"{m['wm_updates']}")
        return (f"| pipeline_rounds {m['pipeline_rounds']}, "
                f"pipeline_bubble "
                f"{ {k: round(v, 4) for k, v in m['pipeline_bubble'].items()} }"
                f", pipeline_peak_grad_bytes "
                f"{m['pipeline_peak_grad_bytes'] / 1e9:.3f} GB | WM cycles "
                f"{wmt.cycles}, every one on the executor's WM stream ")
    with _wm_cycle_threads() as threads:
        out["openvla-7b world model, pipelined"] = _wm_run(
            dev, smi, counting(), pre, dataclasses.replace(rt, pipeline=True),
            "[pipeline] (b) run_wm", alone=False, check=check)

    # (d) the 16 x 16 plan's bytes per device, and the local mesh
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", _PLAN_SCRIPT, "openvla-7b",
                          "dbrx-132b"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise AssertionError(f"[pipeline] (d) {res.stdout}{res.stderr}")
    plan = json.loads(res.stdout.strip().splitlines()[-1])
    for arch, f in plan.items():
        total = f["params"] + f["moments"]
        print(f"[pipeline] (d) {arch} at full depth ({f['count'] / 1e9:.3f}"
              f" B parameters, params + f32 moments {f['state'] / 1e9:.1f} "
              f"GB) on "
              f"the 16 x 16 plan (fake group of 256, meta): per device params "
              f"{f['params'] / 1e9:.3f} GB, moments {f['moments'] / 1e9:.3f} "
              f"GB, total {total / 1e9:.3f} GB beside the H100's "
              f"{H100_BYTES / 1e9:.0f} GB (moments with pure ZeRO over data "
              f"alone: {f['analytic'] / 1e9:.3f} GB) | "
              f"{time.perf_counter() - t0:.1f} s")
    mesh = make_local_mesh()
    print(f"[pipeline] (d) make_local_mesh(): {mesh} over backend "
          f"{dist.get_backend()}, world {dist.get_world_size()}")
    dist.destroy_process_group()
    print(f"[pipeline] phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def _bits_equal(a, b) -> bool:
    """Two trees of tensors (nested dicts / NamedTuples) hold the same
    leaves bit for bit (bf16 compared as its int16 bits)."""
    import torch
    from repro_torch.data.checkpoint import _flatten_with_path
    fa, fb = list(_flatten_with_path(a)), list(_flatten_with_path(b))
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x.to(y.device), y):
            return False
    return True


def _state_bytes(state) -> int:
    from repro_torch.data.checkpoint import _flatten_with_path
    return sum(x.numel() * x.element_size()
               for _, x in _flatten_with_path(state))


def phase_checkpoint(dev, smi):
    """The trainer's checkpoints (``data/checkpoint.py``, the reference's
    format) on openvla-7b at full width and CKPT_LAYERS layers: a
    ``TrainerWorker`` with ``checkpoint_dir`` and ``checkpoint_interval``
    1 takes CKPT_STEPS steps on the dummy batch, saving each (the
    directory under the temp dir, whose free space must hold CKPT_STEPS
    checkpoints in CKPT_DISK_SHARE of it). ``restore`` onto a meta
    template gives every leaf of the live state bit for bit (bf16 from
    its bits), and one more step from the restored state equals one from
    the live state, bit for bit: state and metrics. Prints the save and
    restore seconds and GB/s (the read warm from the page cache)."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import RuntimeConfig
    from repro_torch.data import checkpoint
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.runtime import (FifoChannel, TrainerWorker,
                                     VersionedWeightStore)
    cfg, rl, _ = _system_config(n_layers=CKPT_LAYERS)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        trainer = TrainerWorker(cfg, rl, RuntimeConfig(), FifoChannel(1),
                                VersionedWeightStore(), batch_episodes=8,
                                checkpoint_dir=root, checkpoint_interval=1,
                                device=dev)
        nbytes = _state_bytes(trainer.state)
        free = shutil.disk_usage(root).free
        if CKPT_STEPS * nbytes > CKPT_DISK_SHARE * free:
            raise AssertionError(
                f"[checkpoint] {CKPT_STEPS} checkpoints of {nbytes / 1e9:.2f}"
                f" GB do not fit in {CKPT_DISK_SHARE} of {free / 1e9:.1f} GB")
        saves = []
        save = checkpoint.save

        def timed_save(*args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = save(*args, **kw)
            saves.append(time.perf_counter() - t0)
            return out
        batches = [dummy_batch(8, 8, 12, cfg.action_dim, cfg.vocab_size,
                               cfg.action_vocab_size,
                               num_prefix=cfg.num_prefix_tokens, seed=s)
                   for s in range(CKPT_STEPS + 1)]
        checkpoint.save = timed_save
        try:
            for b in batches[:CKPT_STEPS]:
                trainer.train_on_batch(b)
        finally:
            checkpoint.save = save
        files = sorted(p.name for p in pathlib.Path(root).iterdir())
        if checkpoint.latest_step(root) != CKPT_STEPS or len(files) != \
                2 * CKPT_STEPS:
            raise AssertionError(f"[checkpoint] files {files}")
        meta = _map_leaves(trainer.state, lambda x: torch.empty(
            x.shape, dtype=x.dtype, device="meta"))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        restored = checkpoint.restore(root, meta, device=dev)
        torch.cuda.synchronize(dev)
        t_restore = time.perf_counter() - t0
        if not _bits_equal(restored, trainer.state):
            raise AssertionError("[checkpoint] the restored state differs "
                                 "from the live one")
        live, m_live = trainer._step_fn(trainer.state, batches[-1])
        again, m_again = trainer._step_fn(restored, batches[-1])
        torch.cuda.synchronize(dev)
        same_state = _bits_equal(again, live)
        m_live = {k: v.item() for k, v in m_live.items()}
        m_again = {k: v.item() for k, v in m_again.items()}
        if not (same_state and m_live == m_again):
            raise AssertionError(
                f"[checkpoint] a step from the restored state differs from "
                f"one from the live state: state equal {same_state}, "
                f"metrics {m_live} vs {m_again}")
        print(f"[checkpoint] {cfg.name} x {CKPT_LAYERS} layers "
              f"({cfg.param_dtype} params, f32 moments): "
              f"{nbytes / 1e9:.3f} GB a checkpoint, {CKPT_STEPS} steps "
              f"saved ({files}) | save "
              + ", ".join(f"{t:.2f} s ({nbytes / t / 1e9:.2f} GB/s)"
                          for t in saves)
              + f" | restore onto a meta template {t_restore:.2f} s "
              f"({nbytes / t_restore / 1e9:.2f} GB/s, warm) | every leaf "
              f"bit for bit, bf16 included | step {CKPT_STEPS + 1} from "
              f"the restored state = from the live state, bit for bit "
              f"(loss {m_live['loss']:.6f}) | free disk {free / 1e9:.1f} "
              f"GB | phase wall {time.perf_counter() - t_phase:.1f} s | "
              f"{smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def _map_leaves(tree, fn):
    """``fn`` over the tensor leaves of nested dicts and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(v, fn) for v in tree))
    return fn(tree)


def _lane_bytes(blob_bytes: int):
    """The weight lane for blobs of ``blob_bytes`` (two blobs and room for
    their headers) and /dev/shm's free bytes, which must hold SHM_HEADROOM
    lanes."""
    import shutil
    lane = 2 * blob_bytes + (64 << 20)
    free = shutil.disk_usage("/dev/shm").free
    if free < SHM_HEADROOM * lane:
        raise AssertionError(
            f"/dev/shm has {free / 1e9:.1f} GB free, under {SHM_HEADROOM} "
            f"weight lanes of {lane / 1e9:.2f} GB")
    return lane, free


def sync_latency(transport, params, dev, iters=SYNC_ITERS):
    """Publish -> acquire through ``transport`` (the reference's
    ``benchmarks/sync_overhead.py::sync_latency``): ``iters`` times
    begin_publish, publish and acquire of a fresh version, timed until the
    acquired tree is usable on the card (``synchronize``, as the
    reference's ``block_until_ready``). ``transport`` may be a store
    itself (the wire: ``(store, acquirer)``). The first acquired tree is
    held bit for bit against ``params``. Returns the seconds."""
    import torch
    from repro_torch.runtime import VersionedWeightStore
    store, acquirer = (transport if isinstance(transport, tuple)
                       else (VersionedWeightStore(transport=transport),) * 2)
    lat = []
    for v in range(iters):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        store.begin_publish()
        store.publish(params, v)
        got = acquirer.acquire(newer_than=v - 1, timeout=60.0)
        if got is None or got[1] != v:
            raise AssertionError(f"[sync] acquire of v{v} gave "
                                 f"{None if got is None else got[1]}")
        torch.cuda.synchronize(dev)
        lat.append(time.perf_counter() - t0)
        if v == 0 and not _bits_equal(got[0], params):
            raise AssertionError("[sync] the acquired tree differs")
        del got
    return lat


def phase_sync(dev, smi):
    """The paper's Table 8 on the port: publish -> acquire of the system
    tree (openvla-7b at full width, TRAIN_LAYERS layers, bf16 on the card)
    through the direct, serialized and disk transports and over the wire
    (``WeightStoreTransport`` against a ``TransportServer`` in this
    process, through the weight lane), SYNC_ITERS times each, the lane's
    one-time warm-up at server start excluded and printed; the acquired
    tree on the card bit for bit, and every wire acquire served from the
    lane and read from it (none fell back to the socket body). Prints the
    median and p90 seconds and GB/s, and the server's encode and
    lane-write times."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.models.policy import init_policy_params
    from repro_torch.runtime import (DirectTransport, DiskTransport,
                                     SerializedTransport,
                                     VersionedWeightStore)
    from repro_torch.runtime.transport import (TransportServer,
                                               WeightStoreTransport)
    cfg, _, _ = _system_config()
    t_phase = time.perf_counter()
    params = init_policy_params(cfg, 0, device=dev)
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    lane, shm_free = _lane_bytes(nbytes)
    root = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    rows = []
    try:
        for name, t in (("direct", DirectTransport()),
                        ("serialized", SerializedTransport()),
                        ("disk", DiskTransport(root))):
            rows.append((name, sync_latency(t, params, dev), ""))
            gc.collect()
        store = VersionedWeightStore()
        server = TransportServer(weight_lane_bytes=lane).start()
        server.set_store(store)
        client = WeightStoreTransport(server.address, use_lane=True,
                                      device=dev)
        try:
            if not server.lane_ready.wait(timeout=300.0):
                raise AssertionError("[sync] the weight lane never warmed")
            lat = sync_latency((store, client), params, dev)
            c = server.metrics.snapshot()["counters"]
            n = max(c.get("weight_encodes", 0), 1)
            if not (client.lane_hits == SYNC_ITERS
                    and client.lane_fallbacks == 0
                    and c.get("weight_lane_serves") == SYNC_ITERS):
                raise AssertionError(
                    f"[sync] of {SYNC_ITERS} acquires the server served "
                    f"{c.get('weight_lane_serves', 0):.0f} from the lane, "
                    f"the reader read {client.lane_hits} from it and fell "
                    f"back to the socket {client.lane_fallbacks} times")
            rows.append(("wire (lane)", lat, (
                f" | the lane's pages touched at server start in "
                f"{c.get('weight_lane_warm_s', 0):.1f} s, before the first "
                f"publish | server: {c.get('weight_encodes', 0):.0f} "
                f"encodes of "
                f"{c.get('weight_encode_s', 0) / n * 1e3:.1f} ms on average "
                f"(one pinned D2H pass), {c.get('weight_lane_serves', 0):.0f}"
                f" lane serves, lane writes "
                f"{c.get('weight_lane_publish_s', 0) / n * 1e3:.1f} ms on "
                f"average; reader lane hits {client.lane_hits}, "
                f"fallbacks {client.lane_fallbacks}")))
        finally:
            client.close()
            server.stop()
            server.join()
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, lat, note in rows:
        med = statistics.median(lat)
        p90 = sorted(lat)[math.ceil(0.9 * len(lat)) - 1]
        print(f"[sync] {name}: publish -> acquire of {nbytes / 1e9:.3f} GB "
              f"({cfg.name} x {TRAIN_LAYERS} layers, bf16) median "
              f"{med * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms of {len(lat)} "
              f"({nbytes / med / 1e9:.2f} GB/s) | all "
              f"{[round(x * 1e3, 1) for x in lat]} ms{note} | {smi}")
    print(f"[sync] /dev/shm free {shm_free / 1e9:.1f} GB (lane "
          f"{lane / 1e9:.2f} GB) | phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _shm_names():
    return {p.name for p in pathlib.Path("/dev/shm").iterdir()}


def phase_remote(dev, smi, counters, inproc_keys):
    """Rollout workers in their own processes (the paper's physical
    isolation): ``AcceRLSystem`` on the system tree with
    ``num_rollout_workers`` 0 and REMOTE_WORKERS spawned children of
    REMOTE_ENVS envs each, each serving its own policy on the card (K1
    prefill, K2 decode), sending segments over the ring data plane and
    pulling every version over the weight lane; the parent trains
    (K1/K3/K4) for REMOTE_STEPS steps of ``run_async``. Held:
    ``_run_system``'s checks with each child's bridged swaps and version
    as the served ones; every child served batches, pulled every version
    published but the last (the trainer may publish it as the run stops)
    and swapped at least twice; every acquire was read from the lane,
    none fell back to the socket body, and the server served from the
    lane as many as the children read; every segment trained on came
    over the wire; the metric keys equal ``inproc_keys`` (the in-process
    run's); every service stopped healthy, every child exited 0;
    /dev/shm holds after the run what it held before; step 1 replayed on
    the plain route (``_replay_step1``). The children's K1/K2 launches,
    which the parent's counters cannot see, are counted in each child
    (zeroed at its start) and bridged through its reports as the
    counters ``launches.<wrapper>``; each child's are at least what its
    batches need (K1: layers a batch, K2: layers x action tokens).
    Returns the path's launches by name, the children's added, and the
    run's figures that the plane phase prints beside its own."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.base import TransportConfig
    from repro_torch.runtime import AcceRLSystem
    cfg, rl, rt = _system_config()
    n_l, ga, a = TRAIN_LAYERS, rl.grad_accum, cfg.action_dim
    from repro_torch.models.policy import init_policy_params
    params = init_policy_params(cfg, 0, device=dev)
    blob = sum(x.numel() * x.element_size() for x in _leaves(params))
    del params
    torch.cuda.empty_cache()
    lane, shm_free = _lane_bytes(blob)
    rt = dataclasses.replace(
        rt, num_rollout_workers=0, inference_batch=REMOTE_ENVS,
        transport=TransportConfig(
            kind="ring", remote_rollout_workers=REMOTE_WORKERS,
            envs_per_worker=REMOTE_ENVS, put_window=16,
            weight_lane_bytes=lane, connect_timeout_s=120.0))
    shm_before = _shm_names()
    t_phase = time.perf_counter()

    def served(system):
        return [(h.name, h.metrics.counter("weight_swaps"),
                 h.metrics.gauge("weight_version", -1.0))
                for h in system.remote_hosts]

    system, m, launches, peak, facts = _run_system(
        dev, counters, "[remote] run_async",
        lambda: AcceRLSystem(cfg, rl, rt, suite="spatial",
                             segment_horizon=8, max_episode_steps=16,
                             batch_episodes=8, seed=0, device=dev),
        lambda s: s.run_async(train_steps=REMOTE_STEPS,
                              wall_timeout_s=300.0),
        REMOTE_STEPS, lambda s, m: _step_floor(
            n_l, ga, a, 0, m["train_steps"]), served=served)
    trainer, server = system.trainer, system.transport_server
    done = m["train_steps"]
    hosts = system.remote_hosts
    if set(m) != set(inproc_keys):
        raise AssertionError(f"[remote] metric keys {sorted(set(m))} != "
                             f"the in-process run's {sorted(inproc_keys)}")
    codes = [h.process.exitcode for h in hosts]
    stopped = {k: h["state"] for k, h in system.health().items()
               if h["state"] != "stopped"}
    if codes != [0] * len(hosts) or stopped or system.workers:
        raise AssertionError(f"[remote] child exit codes {codes}, services "
                             f"not stopped {stopped}")
    pulled, batches, child_launches = {}, {}, {}
    for h in hosts:
        g = h.metrics.snapshot()["gauges"]
        pulled[h.name] = sorted(int(k.rsplit("_v", 1)[1]) for k in g
                                if k.startswith("weight_acquire_s_v"))
        batches[h.name] = nb = int(h.metrics.counter("batches"))
        child_launches[h.name] = got = {
            k: int(h.metrics.counter(f"launches.{k}", -1))
            for k in ("flash_attention", "decode_attention")}
        need = {"flash_attention": n_l * nb,
                "decode_attention": a * n_l * nb}
        if any(got[k] < n for k, n in need.items()):
            raise AssertionError(f"[remote] {h.name}: launches counted in "
                                 f"the child {got}, its {nb} batches need "
                                 f"{need}")
        acquires = h.metrics.hist("weight_acquire_s", {"count": 0})["count"]
        hits = h.metrics.counter("weight_lane_hits")
        if not (hits == acquires > 0
                and h.metrics.counter("weight_lane_fallbacks") == 0):
            raise AssertionError(
                f"[remote] {h.name}: {acquires} acquires, {hits:.0f} read "
                f"from the lane, "
                f"{h.metrics.counter('weight_lane_fallbacks'):.0f} fell "
                f"back to the socket")
        # every version but the last, which the trainer may publish as
        # the scheduler stops the run
        missed = set(facts["published"][:-1]) - set(pulled[h.name])
        if missed or not (batches[h.name] > 0
                          and h.metrics.counter("weight_swaps") >= 2
                          and h.metrics.counter("segments") > 0):
            raise AssertionError(f"[remote] {h.name}: batches "
                                 f"{batches[h.name]}, pulled "
                                 f"{pulled[h.name]} of "
                                 f"{facts['published']}, counters "
                                 f"{h.metrics.snapshot()['counters']}")
    pushed = system.experience.total_pushed
    if not pushed >= 8 * done or trainer.samples_seen <= 0:
        raise AssertionError(f"[remote] {pushed} segments over the wire "
                             f"for {done} steps of 8")
    left = _shm_names() - shm_before
    if left:
        raise AssertionError(f"[remote] SHM segments left behind: {left}")
    sc = server.metrics.snapshot()["counters"]
    hits = sum(h.metrics.counter("weight_lane_hits") for h in hosts)
    if sc.get("weight_lane_serves") != hits:
        raise AssertionError(f"[remote] the server served "
                             f"{sc.get('weight_lane_serves', 0):.0f} acquires"
                             f" from the lane, the children read {hits:.0f}")
    launches = dict(launches)
    for got in child_launches.values():
        for k, n in got.items():
            launches[k] += n
    lat = {h.name: h.metrics.gauge("batch_s_p50") for h in hosts}
    acq = {h.name: {int(k.rsplit("_v", 1)[1]): round(v, 3) for k, v in
                    h.metrics.snapshot()["gauges"].items()
                    if k.startswith("weight_acquire_s_v")} for h in hosts}
    log = trainer.metrics_log
    print(f"[remote] run_async: {cfg.name} x {n_l} layers, "
          f"{len(hosts)} spawned rollout children x {REMOTE_ENVS} envs "
          f"(inference batch {REMOTE_ENVS} each, on the card), data plane "
          f"ring, weight lane {lane / 1e9:.2f} GB (/dev/shm free "
          f"{shm_free / 1e9:.1f} GB) | system built in "
          f"{facts['t_init']:.1f} s | wall {m['wall_s']:.2f} s, {done} "
          f"train steps, {m['env_steps']} env steps, {m['episodes']} "
          f"episodes | sps_env {m['sps_env']:.2f}, sps_train "
          f"{m['sps_train']:.2f} | trainer_util {m['trainer_util']:.3f} | "
          f"mean_policy_lag {m['mean_policy_lag']:.3f} (per step "
          f"{[e['policy_lag'] for e in log]}) | children's batches "
          f"{batches}, batch_s p50 "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in lat.items())
          + f" | published {facts['published']}, pulled {pulled}, each "
          f"acquire's seconds {acq} | server: the lane's pages touched at "
          f"start in {sc.get('weight_lane_warm_s', 0):.1f} s, weight "
          f"encodes {sc.get('weight_encodes', 0):.0f} "
          f"({sc.get('weight_encode_s', 0):.2f} s), lane writes "
          f"{sc.get('weight_lane_publish_s', 0):.2f} s, lane serves "
          f"{sc.get('weight_lane_serves', 0):.0f} = the children's lane "
          f"reads, no fallback, stream items "
          f"{sc.get('stream_items', 0):.0f}, ring records in "
          f"{sc.get('ring_records_in', 0):.0f} | segments over the wire "
          f"{pushed} | children exit {codes}, /dev/shm as before | "
          f"launches counted in the children {child_launches} (their "
          f"batches {batches}), the path's {launches} | parent "
          f"max_memory_allocated {peak / 1e9:.2f} GB "
          f"| {smi}")
    first, log0 = trainer.first_batch, log[0]
    params0 = facts.pop("v0")
    del system, facts, trainer, server
    gc.collect()
    torch.cuda.empty_cache()
    _replay_step1(dev, cfg, rl, "[remote] run_async", params0, first, log0)
    del params0, first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[remote] phase wall {time.perf_counter() - t_phase:.1f} s")
    figures = {"wall_s": m["wall_s"], "sps_env": m["sps_env"],
               "sps_train": m["sps_train"],
               "mean_policy_lag": m["mean_policy_lag"],
               "batch_s_p50": lat,
               "acquire_s": {k: sorted(v.values()) for k, v in acq.items()}}
    return launches, figures


def _plane_config(plane, n_layers=TRAIN_LAYERS, **transport):
    """The plane phase's system: the system phase's model at ``n_layers``
    layers, no local rollout worker, REMOTE_WORKERS spawned rollout
    children of REMOTE_ENVS envs on the ring data plane, served by the
    shared inference tier ``plane`` ("host" or "spawn") with one window of
    every child's envs (inference batch REMOTE_WORKERS x REMOTE_ENVS)."""
    import dataclasses
    from repro_torch.configs.base import TransportConfig
    cfg, rl, rt = _system_config(n_layers=n_layers)
    rt = dataclasses.replace(
        rt, num_rollout_workers=0,
        inference_batch=REMOTE_WORKERS * REMOTE_ENVS,
        transport=TransportConfig(
            kind="ring", remote_rollout_workers=REMOTE_WORKERS,
            envs_per_worker=REMOTE_ENVS, put_window=16,
            connect_timeout_s=120.0, inference_plane=plane, **transport))
    return cfg, rl, rt


def _plane_system(dev, cfg, rl, rt):
    from repro_torch.runtime import AcceRLSystem
    return AcceRLSystem(cfg, rl, rt, suite="spatial", segment_horizon=8,
                        max_episode_steps=16, batch_episodes=8, seed=0,
                        device=dev)


def _cuda_holders(pids):
    """Of ``pids``: those ``nvidia-smi --query-compute-apps`` lists, and
    those holding an open ``/dev/nvidia*`` device (``/proc/<pid>/fd``),
    which CUDA opens when it initialises, before any context. Importing
    torch alone maps ``libcuda.so`` but opens no device."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout
    listed = {int(x) for x in out.split() if x.strip().isdigit()}
    opened = set()
    for pid in pids:
        try:
            fds = list(pathlib.Path(f"/proc/{pid}/fd").iterdir())
        except OSError:
            continue
        for fd in fds:
            try:
                if os.readlink(fd).startswith("/dev/nvidia"):
                    opened.add(pid)
                    break
            except OSError:
                pass
    return listed & set(pids), opened


def _client_counts(hosts):
    """Each rollout child's inference-client counters (bridged gauges
    ``infer_client_<key>``), held: every request it numbered was resolved
    or failed unanswered as the child closed (``failed``: at most one an
    env), none was resolved twice (a redelivered result finds no future:
    ``duplicates``), and the child launched no kernel."""
    counts = {}
    for h in hosts:
        g = h.metrics.snapshot()["gauges"]
        c = {k[len("infer_client_"):]: int(v) for k, v in g.items()
             if k.startswith("infer_client_")}
        if not (c and c["results"] + c["pending"] + c["failed"]
                == c["submitted"] > 0 and c["pending"] == 0
                and c["failed"] <= REMOTE_ENVS and c["duplicates"] == 0):
            raise AssertionError(f"[plane] {h.name}: client counters {c}")
        if h.metrics.counter("launches.flash_attention", -1) != -1:
            raise AssertionError(f"[plane] {h.name} launched a kernel")
        counts[h.name] = c
    return counts


def _plane_common(tag, system, m):
    """What every plane run must: the children exit 0, every service
    stopped healthy, every segment trained on came over the wire, the
    children's client counters whole (``_client_counts``)."""
    hosts = system.remote_hosts
    codes = [h.process.exitcode for h in hosts]
    stopped = {k: h["state"] for k, h in system.health().items()
               if h["state"] != "stopped"}
    if codes != [0] * len(hosts) or stopped:
        raise AssertionError(f"{tag}: child exit codes {codes}, services "
                             f"not stopped {stopped}")
    done = m["train_steps"]
    if not system.experience.total_pushed >= 8 * done:
        raise AssertionError(f"{tag}: {system.experience.total_pushed} "
                             f"segments over the wire for {done} steps")
    return _client_counts(hosts)


def _plane_host(dev, smi, counters, remote):
    """(a) Host mode: the parent's pool serves the children's requests
    through the server's ``infer.*`` endpoints. Held: ``_run_system``'s
    checks with the kernels' floors counted in the parent alone (K1/K2
    serve there, K1/K3/K4 train); what the children resolved <= the
    server's ``infer_results`` <= what the pool served <= the server's
    ``infer_submits`` <= what the children numbered (a request in flight
    as a child closes fails unanswered: ``_client_counts``); no child is
    a compute process in nvidia-smi or holds a ``/dev/nvidia*`` device
    (``_cuda_holders``), sampled every PLANE_SMI_PERIOD_S through the run
    (the parent holds one: the control); step 1 replayed on the plain
    route as phase 10's."""
    import gc
    import torch
    cfg, rl, rt = _plane_config("host")
    n_l, ga, a = TRAIN_LAYERS, rl.grad_accum, cfg.action_dim
    seen = {"children": set(), "listed": set(), "opened": set(),
            "samples": 0}

    def go(system):
        stop = threading.Event()

        def watch():
            while not stop.wait(PLANE_SMI_PERIOD_S):
                kids = [h.process.pid for h in system.remote_hosts
                        if h.process is not None]
                listed, opened = _cuda_holders(kids + [os.getpid()])
                seen["children"].update(kids)
                seen["listed"] |= listed
                seen["opened"] |= opened
                seen["samples"] += 1
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        try:
            return system.run_async(train_steps=REMOTE_STEPS,
                                    wall_timeout_s=300.0)
        finally:
            stop.set()
            t.join()

    system, m, launches, peak, facts = _run_system(
        dev, counters, "[plane] host mode",
        lambda: _plane_system(dev, cfg, rl, rt), go, REMOTE_STEPS,
        lambda s, m: _step_floor(n_l, ga, a, m["inference_batches"],
                                 m["train_steps"]))
    tag = "[plane] host mode"
    clients = _plane_common(tag, system, m)
    server, pool = system.transport_server.metrics, system.inference
    sent = sum(c["submitted"] for c in clients.values())
    got = sum(c["results"] for c in clients.values())
    if not (got <= server.counter("infer_results") <= pool.requests_served
            <= server.counter("infer_submits") <= sent):
        raise AssertionError(
            f"{tag}: server submits {server.counter('infer_submits')}, "
            f"results {server.counter('infer_results')}, the children's "
            f"{clients}, the pool served {pool.requests_served}")
    me = os.getpid()
    kids = seen["children"]
    if not (seen["samples"] and kids and not kids & seen["listed"]
            and not kids & seen["opened"] and me in seen["opened"]):
        raise AssertionError(f"{tag}: CUDA holders {seen} (parent {me})")
    lat = pool.metrics.series("batch_s")
    fill = pool.requests_served / max(
        pool.requests_served + pool.metrics.counter("padded_slots"), 1)
    log = system.trainer.metrics_log
    print(f"{tag}: {cfg.name} x {n_l} layers, {len(system.remote_hosts)} "
          f"spawned rollout children x {REMOTE_ENVS} envs with no policy "
          f"and no CUDA context (nvidia-smi compute pids {sorted(seen['listed'])} "
          f"over {seen['samples']} samples, children {sorted(kids)}, parent "
          f"{me}; /dev/nvidia* held by {sorted(seen['opened'])}), "
          f"served by the parent's pool (inference batch "
          f"{rt.inference_batch}) | system built in {facts['t_init']:.1f} s"
          f" | wall {m['wall_s']:.2f} s, {m['train_steps']} train steps, "
          f"{m['env_steps']} env steps | sps_env {m['sps_env']:.2f}, "
          f"sps_train {m['sps_train']:.2f} | mean_policy_lag "
          f"{m['mean_policy_lag']:.3f} (per step "
          f"{[e['policy_lag'] for e in log]}) | pool batches "
          f"{m['inference_batches']}, batch_s p50 "
          f"{statistics.median(lat) * 1e3:.1f} ms, window fill {fill:.3f}, "
          f"inference_util {m['inference_util']:.3f} | infer_submits "
          f"{server.counter('infer_submits'):.0f}, infer_results "
          f"{server.counter('infer_results'):.0f}, pool requests "
          f"{pool.requests_served}, the children's clients {clients} | "
          f"launches, all in the parent: {launches} | beside the remote "
          f"phase's children serving on the card in this run: wall "
          f"{remote['wall_s']:.2f} s, sps_env {remote['sps_env']:.2f}, "
          f"sps_train {remote['sps_train']:.2f}, mean_policy_lag "
          f"{remote['mean_policy_lag']:.3f}, batch_s p50 "
          + ", ".join(f"{k} {v * 1e3:.1f} ms"
                      for k, v in remote["batch_s_p50"].items())
          + f", each child's acquires {remote['acquire_s']} s | parent "
          f"max_memory_allocated {peak / 1e9:.2f} GB | {smi}")
    first, log0 = system.trainer.first_batch, log[0]
    params0 = facts.pop("v0")
    del system, facts
    gc.collect()
    torch.cuda.empty_cache()
    _replay_step1(dev, cfg, rl, tag, params0, first, log0)
    return launches


def _plane_spawn(dev, smi, counters):
    """(b) Spawn mode: the shared pool in a supervised child of its own
    (``restart="on_failure"``) on a fixed port, acquiring each version
    once through the weight lane; SIGKILLed once the children are stepping
    and it has served. Held: ``_run_system``'s checks (the tier's bridged
    swaps and version as the served ones; the parent's K1/K3/K4 floors);
    the tier restarted once, on the same address, every service healthy;
    just before the kill the tier holds a ``/dev/nvidia*`` device and no
    rollout child does (``_cuda_holders``); each child's client counters
    whole, at least one epoch change seen;
    the tier's K1/K2 launches, counted in the tier and bridged, at least
    what its batches need. Prints the tier's acquire seconds and the
    respawn's wall time (SIGKILL to the new tier's first batch)."""
    import gc
    import torch
    from repro_torch.configs.base import SupervisionConfig
    from repro_torch.models.policy import init_policy_params
    params = init_policy_params(_system_config()[0], 0, device=dev)
    lane, _ = _lane_bytes(sum(x.numel() * x.element_size()
                              for x in _leaves(params)))
    del params
    torch.cuda.empty_cache()
    cfg, rl, rt = _plane_config(
        "spawn", weight_lane_bytes=lane, reconnect_attempts=400,
        reconnect_backoff_s=0.05, supervision=SupervisionConfig(
            restart="on_failure", max_restarts=2, backoff_initial_s=0.1,
            backoff_max_s=1.0))
    n_l, ga, a = TRAIN_LAYERS, rl.grad_accum, cfg.action_dim
    kill = {}

    def go(system):
        tier = system.inference_plane_host
        kill["address"] = system.infer_address

        def kill_tier():
            deadline = time.monotonic() + 240.0
            while time.monotonic() < deadline:
                if (tier.process is not None
                        and tier.metrics.counter("batches") > 0
                        and all(h.env_steps > 0
                                for h in system.remote_hosts)):
                    incarnation = tier.incarnation
                    served = tier.metrics.counter("batches")
                    kill["pid"] = tier.process.pid
                    kill["kids"] = {h.process.pid
                                    for h in system.remote_hosts}
                    kill["opened"] = _cuda_holders(
                        sorted(kill["kids"]) + [kill["pid"]])[1]
                    t0 = time.perf_counter()
                    os.kill(kill["pid"], signal.SIGKILL)
                    while time.monotonic() < deadline:
                        if (tier.incarnation > incarnation
                                and tier.metrics.counter("batches")
                                > served):
                            kill["respawn_s"] = time.perf_counter() - t0
                            return
                        time.sleep(0.02)
                    return
                time.sleep(0.02)

        def killer():
            try:
                kill_tier()
            except Exception as e:       # noqa: BLE001 — shown by the check
                kill["error"] = repr(e)
        t = threading.Thread(target=killer, daemon=True)
        t.start()
        try:
            return system.run_async(train_steps=REMOTE_STEPS,
                                    wall_timeout_s=300.0)
        finally:
            t.join(timeout=5.0)

    def served(system):
        tier = system.inference_plane_host
        return [(tier.name, tier.metrics.counter("weight_swaps"),
                 tier.metrics.gauge("weight_version", -1.0))]

    tag = "[plane] spawn mode"
    system, m, launches, peak, facts = _run_system(
        dev, counters, tag, lambda: _plane_system(dev, cfg, rl, rt), go,
        REMOTE_STEPS, lambda s, m: _step_floor(n_l, ga, a, 0,
                                               m["train_steps"]),
        served=served)
    tier = system.inference_plane_host
    clients = _plane_common(tag, system, m)
    if not ("respawn_s" in kill and tier.restarts == 1
            and kill["opened"] == {kill["pid"]}
            and system.infer_address == kill["address"]
            and tier.process.exitcode == 0
            and all(c["epoch_changes"] >= 1 for c in clients.values())):
        raise AssertionError(f"{tag}: kill {kill}, tier restarts "
                             f"{tier.restarts}, address "
                             f"{system.infer_address}, exit "
                             f"{tier.process.exitcode}, clients {clients}")
    snap = tier.metrics.snapshot()
    nb = int(tier.metrics.counter("batches"))
    tier_launches = {k: int(tier.metrics.counter(f"launches.{k}", -1))
                     for k in ("flash_attention", "decode_attention")}
    need = {"flash_attention": n_l * nb, "decode_attention": a * n_l * nb}
    if any(tier_launches[k] < n for k, n in need.items()):
        raise AssertionError(f"{tag}: the tier's launches {tier_launches},"
                             f" its {nb} batches need {need}")
    launches = dict(launches)
    for k, n in tier_launches.items():
        launches[k] += n
    acq = {int(k.rsplit("_v", 1)[1]): round(v, 3)
           for k, v in snap["gauges"].items()
           if k.startswith("weight_acquire_s_v")}
    broker = {k[len("broker_"):]: int(v) for k, v in snap["gauges"].items()
              if k.startswith("broker_")}
    print(f"{tag}: the same children served by a spawned tier on "
          f"{kill['address'][0]}:{kill['address'][1]} (weights over the "
          f"lane, {lane / 1e9:.2f} GB), SIGKILLed (pid {kill['pid']}) "
          f"mid-episode and respawned on the same port by the supervisor"
          f" (restarts {tier.restarts}); before the kill /dev/nvidia* held "
          f"by {sorted(kill['opened'])}, not the children "
          f"{sorted(kill['kids'])} | respawn wall, SIGKILL to the new"
          f" tier's first batch: {kill['respawn_s']:.2f} s | the tier's "
          f"acquire seconds by version (the last incarnation's gauges "
          f"over the first's) {acq} | wall {m['wall_s']:.2f} s, "
          f"{m['train_steps']} train steps, {m['env_steps']} env steps | "
          f"sps_env {m['sps_env']:.2f}, sps_train {m['sps_train']:.2f} | "
          f"mean_policy_lag {m['mean_policy_lag']:.3f} | tier batches "
          f"{nb}, batch_s p50 "
          f"{tier.metrics.gauge('batch_s_p50') * 1e3:.1f} ms | the new "
          f"tier's broker {broker} | the children's clients {clients} "
          f"(resolved + failed at close = numbered, no duplicate) | "
          f"launches: "
          f"the tier's {tier_launches}, the path's {launches} | parent "
          f"max_memory_allocated {peak / 1e9:.2f} GB | {smi}")
    del system, facts
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def traced_host_plane(path) -> int:
    """The traced run of ``_plane_host``'s system (started by
    ``_plane_trace`` as ``chip_smoke.py --traced-host-plane PATH`` with
    ``REPRO_TRACE=1``, which its children inherit): ``run_async`` for
    REMOTE_STEPS steps, the trace dumped to ``path``, one JSON line of the
    run's pids and counts printed."""
    import torch
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.runtime import telemetry
    dev = torch.device("cuda", 0)
    system = _plane_system(dev, *_plane_config("host"))
    m = system.run_async(train_steps=REMOTE_STEPS, wall_timeout_s=300.0)
    bad = {k: h for k, h in system.health().items() if not h["healthy"]}
    if bad or m["train_steps"] < REMOTE_STEPS:
        raise AssertionError(f"traced run: {m['train_steps']} steps, "
                             f"services failed {bad}")
    sink = system.telemetry_sink.tail()
    n = telemetry.dump(path, process_name="chip_smoke traced host plane")
    print(json.dumps({
        "pid": os.getpid(), "events": n, "wall_s": m["wall_s"],
        "children": [h.process.pid for h in system.remote_hosts],
        "folded": system.transport_server.metrics.counter(
            "trace_events_folded"),
        "sink_samples": len(sink), "sink_keys": sorted(sink[-1])}))
    return 0


def _by_trace(events, name):
    """trace id -> the pids of ``name``'s events on it."""
    out = {}
    for e in events:
        if e.get("name") == name and e.get("ph") in ("X", "i"):
            t = e.get("args", {}).get("trace")
            if t is not None:
                out.setdefault(t, set()).add(e["pid"])
    return out


def _plane_trace(smi):
    """(c) ``traced_host_plane`` in a process of its own: the dump holds a
    child's ``rollout.put`` joined to the parent's ``server.apply`` on one
    trace id (and that trace reaching the trainer's pop or collate), and a
    version's ``weights.publish`` -> ``weights.acquire`` ->
    ``infer.first_action`` chain (the parent's pool serves, so all three
    are the parent's); the telemetry sink sampled with the reference's
    keys."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    path = os.path.join(root, "trace.json")
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--traced-host-plane", path],
            env=dict(os.environ, REPRO_TRACE="1"), capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode:
            raise AssertionError(f"[telemetry] traced run exit "
                                 f"{res.returncode}: {res.stdout[-2000:]}"
                                 f"{res.stderr[-4000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        nbytes = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parent, kids = run["pid"], set(run["children"])
    puts = _by_trace(events, "rollout.put")
    applies = _by_trace(events, "server.apply")
    joined = [t for t in puts if puts[t] <= kids and applies.get(t) == {
        parent}]
    trainer_side = set(_by_trace(events, "trainer.collate")) | set(
        _by_trace(events, "replay.pop"))
    reached = set(joined) & trainer_side
    chain = (set(_by_trace(events, "weights.publish"))
             & (set(_by_trace(events, "weights.acquire"))
                | set(_by_trace(events, "weights.wire_acquire")))
             & set(_by_trace(events, "infer.first_action")))
    pids = {e["pid"] for e in events if e.get("ph") != "M"}
    if not (joined and reached and chain and kids <= pids
            and run["folded"] > 0 and run["sink_samples"] > 0
            and run["sink_keys"] == ["health", "services", "t"]):
        raise AssertionError(f"[telemetry] joined {len(joined)}, reaching "
                             f"the trainer {len(reached)}, version chains "
                             f"{sorted(chain)}, pids {pids}, run {run}")
    print(f"[telemetry] REPRO_TRACE=1 run of the host-mode plane in its own "
          f"process: wall {wall:.1f} s (the run {run['wall_s']:.2f} s) | "
          f"{run['events']} events ({nbytes / 1e6:.2f} MB of Chrome trace) "
          f"from pids {sorted(pids)} (parent {parent}, children "
          f"{sorted(kids)}), {run['folded']:.0f} folded from the children's "
          f"reports | {len(puts)} episode flushes traced, {len(joined)} "
          f"with a child's rollout.put joined to the parent's server.apply"
          f", {len(reached)} of them on to the trainer's pop or collate | "
          f"publish -> acquire -> first action on versions {sorted(chain)}"
          f" | telemetry sink: {run['sink_samples']} samples, keys "
          f"{run['sink_keys']} | {smi}")


def _same_items(a, b) -> bool:
    """Two lists of experience items (dicts of arrays) equal, in order."""
    import numpy as np
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def _plane_journal(dev, smi):
    """(d) The journal on the checkpoint phase's model (CKPT_LAYERS
    layers): ``_plane_host``'s system with ``journal_dir`` under the temp
    dir (no compaction before the stop, so the log keeps every record; the
    temp dir's free space must hold it in CKPT_DISK_SHARE of it) runs
    ``run_async``. Once version 2 is published, a thread takes a
    crash-consistent copy of the journal (holding the experience channel's
    journal lock, so no put or pop lands between the group-commit flush,
    the copy and a look at the live channel): ``recover`` of the copy holds
    exactly the items the channel held then, every item it accepted and
    every pop it made up to then, and a version published by then, whose
    tree it decodes onto the card bit for bit. After the run
    stops, a new system with ``resume_journal`` holds, before it starts,
    the newest publish on the card bit for bit (the version and every
    leaf, bf16 by its bits) and the items the first left behind. Prints
    the journal's counters, the files, and a journaled publish's seconds
    (the store's hook on the trainer thread: one pinned D2H pass and the
    append)."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.runtime.transport import recover
    root = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    crash_dir = root + "_crash"
    tag = "[journal]"
    try:
        cfg, rl, rt = _plane_config("host", n_layers=CKPT_LAYERS,
                                    journal_dir=root,
                                    journal_compact_bytes=1 << 62)
        system = _plane_system(dev, cfg, rl, rt)
        blob = sum(x.numel() * x.element_size()
                   for x in _leaves(system.trainer.state.params))
        free = shutil.disk_usage(root).free
        # a record a publish (the trainer's REMOTE_STEPS and v0, one more
        # as it stops), the copy, the final snapshot
        if 2 * (REMOTE_STEPS + 3) * blob > CKPT_DISK_SHARE * free:
            raise AssertionError(f"{tag}: {free / 1e9:.1f} GB free for "
                                 f"publishes of {blob / 1e9:.2f} GB")
        note, published, pub_s = system.store.on_publish, {}, []

        def on_publish(params, version):
            t0 = time.perf_counter()
            note(params, version)
            pub_s.append(time.perf_counter() - t0)
            published[version] = params
        system.store.on_publish = on_publish
        crash = {}

        def copy_midrun():
            deadline = time.monotonic() + 240.0
            while time.monotonic() < deadline and max(published,
                                                      default=-1) < 2:
                time.sleep(0.01)
            chan = system.experience
            with chan.journal_lock:
                system.journal.flush()
                shutil.copytree(root, crash_dir)
                crash["items"] = chan.peek_all()
                crash["pushed"] = chan.total_pushed
        t = threading.Thread(target=copy_midrun, daemon=True)
        t.start()
        m = system.run_async(train_steps=REMOTE_STEPS, wall_timeout_s=300.0)
        t.join(timeout=60.0)
        bad = {k: h for k, h in system.health().items() if not h["healthy"]}
        if bad or m["train_steps"] < REMOTE_STEPS or "items" not in crash:
            raise AssertionError(f"{tag}: {m['train_steps']} steps, "
                                 f"services failed {bad}, mid-run copy "
                                 f"{sorted(crash)}")
        left = system.experience.peek_all()
        stats = system.journal.stats()
        files = {p: os.path.getsize(os.path.join(root, p))
                 for p in sorted(os.listdir(root))}
        del system
        gc.collect()
        torch.cuda.empty_cache()
        mid = recover(crash_dir)
        got = mid.store_params(device=dev)
        if not (got is not None and got[1] in published
                and _bits_equal(got[0], published[got[1]])
                and _same_items(mid.channel_items("experience"),
                                crash["items"])
                and mid.items_in == crash["pushed"] > 0
                and mid.items_out == crash["pushed"] - len(crash["items"])):
            raise AssertionError(
                f"{tag}: the mid-run copy recovers "
                f"{None if got is None else got[1]} of {sorted(published)}"
                f", {len(mid.channel_items('experience'))} items of "
                f"{mid.items_in} in and {mid.items_out} out; the channel "
                f"held {len(crash['items'])} of {crash['pushed']} pushed")
        del got
        t0 = time.perf_counter()
        state = recover(root)
        t_recover = time.perf_counter() - t0
        rt2 = dataclasses.replace(rt, transport=dataclasses.replace(
            rt.transport, resume_journal=True))
        t0 = time.perf_counter()
        system = _plane_system(dev, cfg, rl, rt2)
        t_resume = time.perf_counter() - t0
        got = system.store.acquire(timeout=5.0)
        items = system.experience.peek_all()
        system.registry.stop_all()
        system.journal.close()
        newest = max(published)
        if (got is None or got[1] != newest
                or not _bits_equal(got[0], published[newest])
                or any(x.device != dev for x in _leaves(got[0]))):
            raise AssertionError(f"{tag}: resumed store holds "
                                 f"{None if got is None else got[1]}, the "
                                 f"last publish was v{newest}, not bit for "
                                 f"bit on {dev}")
        if not (_same_items(items, left)
                and _same_items(state.channel_items("experience"), left)):
            raise AssertionError(f"{tag}: {len(items)} items resumed, "
                                 f"{len(state.channel_items('experience'))}"
                                 f" recovered, {len(left)} left behind")
        nbytes = sum(x.numel() * x.element_size() for x in _leaves(got[0]))
        del system, got, published
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(crash_dir, ignore_errors=True)
    print(f"{tag} {cfg.name} x {CKPT_LAYERS} layers, the host-mode plane "
          f"with journal_dir: run_async {m['train_steps']} train steps in "
          f"{m['wall_s']:.2f} s | journal {stats} | files at stop {files} "
          f"| {len(pub_s)} journaled publishes of {nbytes / 1e9:.2f} GB, "
          f"the store's hook {statistics.median(pub_s):.3f} s median (max "
          f"{max(pub_s):.3f}) | the mid-run copy: v{mid.store[0]} on the "
          f"card bit for bit, {mid.items_in} items put and {mid.items_out} "
          f"popped as the channel took them, {len(crash['items'])} held as "
          f"it held them, {mid.records} records, torn tail "
          f"{mid.torn_tail} | "
          f"recover at stop {t_recover:.2f} s: v{state.store[0]}, "
          f"{state.records} records | a new system with resume_journal "
          f"built in {t_resume:.1f} s: v{newest} on the card bit for bit, "
          f"{len(items)} experience items as left | {smi}")


def phase_plane(dev, smi, counters, remote):
    """The shared inference tier, the trace across processes and the
    journal (``_plane_host``, ``_plane_spawn``, ``_plane_trace``,
    ``_plane_journal``; ``remote``: the remote phase's figures, printed
    beside host mode's). Returns each run's launches by name."""
    t_phase = time.perf_counter()
    out = {"host mode, run_async": _plane_host(dev, smi, counters, remote)}
    out["spawned tier SIGKILLed, run_async"] = _plane_spawn(dev, smi,
                                                            counters)
    _plane_trace(smi)
    _plane_journal(dev, smi)
    print(f"[plane] phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def _init_two_versions(dev, cfg):
    import torch
    from repro_torch.models.policy import init_policy_params
    t0 = time.perf_counter()
    params0 = init_policy_params(cfg, 0, device=dev)
    params1 = init_policy_params(cfg, 1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params0))
    print(f"[model] {cfg.name}: {n_params / 1e9:.3f} B parameters x 2 "
          f"versions initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s | allocated "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB")
    return params0, params1


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import gipo_loss as gl
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from repro_torch.models.transformer import num_shared_applications
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

    def counting(**per):
        """Every wrapper, with the launches a path should make (0 for the
        kernels it does not run). Every K6 and K4 launch of a counted path
        is bf16 at a shape the kernel's tensor-core body takes, so it runs
        that body."""
        for k in ("ssd_scan", "fused_policy_loss_fwd",
                  "fused_policy_loss_bwd"):
            per.setdefault(f"{k} tensor-core body", per.get(k, 0))
        return {k: (fn, per.get(k, 0)) for k, fn in wrappers.items()}

    name, smi = phase_device()
    entries = phase_kernels(dev)
    by_path, failures = {}, []

    # openvla-7b: serving (full depth) and training (TRAIN_LAYERS layers)
    cfg = get_config("openvla-7b")
    nl, a = cfg.num_layers, cfg.action_dim
    params0, params1 = _init_two_versions(dev, cfg)
    phase_model(dev, cfg, params0, obs_len=12, bound=MODEL_LOGIT_BOUND,
                counters=counting(flash_attention=nl,
                                  decode_attention=nl * a))
    by_path["openvla-7b serving"] = phase_serving(
        dev, cfg, params0, params1, obs_len=12, frame=True,
        counters=counting(flash_attention=nl, decode_attention=nl * a))
    phase_trace(dev, cfg, params0, obs_len=12, frame=True)
    del params0, params1
    torch.cuda.empty_cache()
    ga = 2                                   # RLConfig().grad_accum
    by_path["openvla-7b training"] = phase_train(
        dev, "openvla-7b", TRAIN_LAYERS, 12,
        counting(flash_attention=TRAIN_LAYERS * ga,
                 flash_attention_bwd=TRAIN_LAYERS * ga,
                 fused_policy_loss_fwd=ga, fused_policy_loss_bwd=ga),
        (ROUTE_BOUND, LEAF_BOUND, STEPS_BOUND), failures,
        live_bounds=(LIVE_ROUTE_BOUND, LIVE_LEAF_BOUND),
        f32_witness=(None, OVLA_F32_BOUNDS))
    torch.cuda.empty_cache()

    # mamba2-2.7b: serving (full depth, T = 256) and training (16 layers)
    cfg = get_config("mamba2-2.7b")
    nl = cfg.num_layers
    params0, params1 = _init_two_versions(dev, cfg)
    phase_model(dev, cfg, params0, obs_len=SSM_OBS, bound=SSM_LOGIT_BOUND,
                f32_bound=SSM_F32_LOGIT_BOUND, counters=counting(ssd_scan=nl))
    phase_model(dev, cfg, params0, obs_len=SSM_ENV_OBS,
                bound=SSM_LOGIT_BOUND, counters=counting(ssd_scan=nl))
    by_path["mamba2-2.7b serving"] = phase_serving(
        dev, cfg, params0, params1, obs_len=SSM_OBS, frame=False,
        counters=counting(ssd_scan=nl))
    by_path["mamba2-2.7b serving, env prompts"] = phase_serving(
        dev, cfg, params0, params1, obs_len=SSM_ENV_OBS, frame=False,
        counters=counting(ssd_scan=nl))
    phase_trace(dev, cfg, params0, obs_len=SSM_OBS, frame=False)
    del params0, params1
    torch.cuda.empty_cache()
    per_step = counting(ssd_scan=SSM_TRAIN_LAYERS * ga,
                        ssd_scan_bwd=SSM_TRAIN_LAYERS * ga,
                        fused_policy_loss_fwd=ga, fused_policy_loss_bwd=ga)
    by_path["mamba2-2.7b training"] = phase_train(
        dev, "mamba2-2.7b", SSM_TRAIN_LAYERS, SSM_OBS - cfg.action_dim,
        per_step, (SSM_ROUTE_BOUND, SSM_LEAF_BOUND, SSM_STEPS_BOUND),
        failures, plain_remat=True,
        f32_witness=(SSM_F32_CHUNK, SSM_F32_BOUNDS))
    by_path["mamba2-2.7b training, env sequences"] = phase_train_env(
        dev, "mamba2-2.7b", SSM_TRAIN_LAYERS, SSM_ENV_OBS, per_step,
        SSM_ROUTE_BOUND)
    torch.cuda.empty_cache()

    # zamba2-1.2b: serving and training at full depth (38 layers, the
    # shared block 7 times)
    cfg = get_config("zamba2-1.2b")
    nl, a = cfg.num_layers, cfg.action_dim
    n_app = num_shared_applications(cfg)
    params0, params1 = _init_two_versions(dev, cfg)
    per_batch = counting(flash_attention=n_app, ssd_scan=nl,
                         decode_attention=n_app * a)
    phase_model(dev, cfg, params0, obs_len=SSM_OBS, bound=HYB_LOGIT_BOUND,
                f32_bound=HYB_F32_LOGIT_BOUND, counters=per_batch)
    phase_model(dev, cfg, params0, obs_len=SSM_ENV_OBS,
                bound=HYB_LOGIT_BOUND, counters=per_batch)
    by_path["zamba2-1.2b serving"] = phase_serving(
        dev, cfg, params0, params1, obs_len=SSM_OBS, frame=False,
        counters=per_batch)
    by_path["zamba2-1.2b serving, env prompts"] = phase_serving(
        dev, cfg, params0, params1, obs_len=SSM_ENV_OBS, frame=False,
        counters=per_batch)
    phase_trace(dev, cfg, params0, obs_len=SSM_OBS, frame=False)
    del params0, params1
    torch.cuda.empty_cache()
    # each block checkpointed: the backward runs K1 and K6 once more
    per_step = counting(flash_attention=2 * n_app * ga,
                        flash_attention_bwd=n_app * ga,
                        ssd_scan=2 * nl * ga, ssd_scan_bwd=nl * ga,
                        fused_policy_loss_fwd=ga, fused_policy_loss_bwd=ga)
    by_path["zamba2-1.2b training"] = phase_train(
        dev, "zamba2-1.2b", nl, SSM_OBS - a, per_step,
        (HYB_ROUTE_BOUND, HYB_LEAF_BOUND, HYB_STEPS_BOUND), failures,
        remat=True, f32_witness=(cfg.ssm.chunk, HYB_F32_BOUNDS))
    by_path["zamba2-1.2b training, env sequences"] = phase_train_env(
        dev, "zamba2-1.2b", nl, SSM_ENV_OBS, per_step, HYB_ROUTE_BOUND,
        remat=True)
    torch.cuda.empty_cache()

    # the kernel-ops entry point, the one path that runs K5
    by_path["kernel-ops entry point"] = phase_ops(dev, cfg, counting(
        flash_attention=2, gipo_head_loss_fwd=2, gipo_head_loss_bwd=1,
        fused_policy_loss_fwd=1, fused_policy_loss_bwd=1, ssd_scan=1))
    torch.cuda.empty_cache()

    # granite-moe-1b-a400m (moe): one MoE layer on the card against the
    # CPU, then serving and training at full width and full depth
    t_moe = time.perf_counter()
    phase_moe_layer(dev)
    cfg = get_config(MOE_ARCH)
    nl, a = cfg.num_layers, cfg.action_dim
    params0, params1 = _init_two_versions(dev, cfg)
    per_batch = counting(flash_attention=nl, decode_attention=nl * a)
    phase_model(dev, cfg, params0, obs_len=MOE_OBS, bound=None,
                f32_bound=MOE_F32_LOGIT_BOUND, counters=per_batch,
                agree=MOE.agree)
    phase_model(dev, cfg, params0, obs_len=SSM_ENV_OBS, bound=None,
                counters=per_batch, agree=MOE.agree)
    by_path[f"{MOE_ARCH} serving"] = phase_serving(
        dev, cfg, params0, params1, obs_len=MOE_OBS, frame=False,
        counters=per_batch)
    by_path[f"{MOE_ARCH} serving, env prompts"] = phase_serving(
        dev, cfg, params0, params1, obs_len=SSM_ENV_OBS, frame=False,
        counters=per_batch)
    phase_trace(dev, cfg, params0, obs_len=MOE_OBS, frame=False)
    del params0, params1
    torch.cuda.empty_cache()
    per_step = counting(flash_attention=nl * ga, flash_attention_bwd=nl * ga,
                        fused_policy_loss_fwd=ga, fused_policy_loss_bwd=ga)
    by_path[f"{MOE_ARCH} training"] = phase_train(
        dev, MOE_ARCH, nl, MOE_OBS - a, per_step,
        (MOE_ROUTE_BOUND, MOE_LEAF_BOUND, MOE_STEPS_BOUND), failures,
        plain_remat=True, live_steps_bound=MOE_LIVE_STEPS_BOUND,
        f32_witness=(None, MOE_F32_BOUNDS), checks=MOE)
    by_path[f"{MOE_ARCH} training, env sequences"] = phase_train_env(
        dev, MOE_ARCH, nl, SSM_ENV_OBS, per_step, MOE_ROUTE_BOUND)
    torch.cuda.empty_cache()
    print(f"[moe] {MOE_ARCH} layer, serving and training phases wall "
          f"{time.perf_counter() - t_moe:.1f} s")

    # the asynchronous system: rollouts, serving and training on one card
    inproc_keys = set()
    for run, launches in phase_system(dev, smi, counting(),
                                      async_keys=inproc_keys).items():
        by_path[f"openvla-7b system, {run}"] = launches
    # the world-model mode: imagination on the policy, the WM trainer
    by_path["openvla-7b world model, run_wm"], pre = phase_wm(dev, smi,
                                                              counting())
    # the pipelined executor: rounds against the fused step, the WM
    # trainer as its second stage, a disjoint layout, the 16 x 16 plan
    by_path.update(phase_pipeline(dev, smi, counting, pre))
    del pre
    # checkpoints, the weight transports, and rollout workers in their
    # own processes serving on the card
    phase_checkpoint(dev, smi)
    phase_sync(dev, smi)
    launches, remote = phase_remote(dev, smi, counting(), inproc_keys)
    by_path["openvla-7b remote rollout workers, run_async"] = launches
    # the shared inference tier: rollout children that never touch the
    # card, served from the parent's pool and from a spawned tier that
    # survives a SIGKILL; the trace across processes; the journal
    for run, launches in phase_plane(dev, smi, counting(), remote).items():
        by_path[f"openvla-7b inference plane, {run}"] = launches
    # the system on granite-moe-1b-a400m, then the witness of its
    # served-μ gap: an f32 copy, and one without drops (MOE above)
    nl = MOE_SYSTEM_LAYERS
    for run, launches in phase_system(dev, smi, counting(), arch=MOE_ARCH,
                                      n_layers=nl, sync=False,
                                      checks=MOE).items():
        by_path[f"{MOE_ARCH} system, {run}"] = launches
    phase_system(dev, smi, counting(), arch=MOE_ARCH, n_layers=nl,
                 sync=False, checks=MOE, edit=_f32_copy, note=", f32 copy")
    phase_system(dev, smi, counting(), arch=MOE_ARCH, n_layers=nl,
                 sync=False, checks=MOE_NO_DROPS,
                 edit=lambda c: _f32_copy(c, drops=False),
                 note=", f32 copy without drops")

    if failures:
        raise AssertionError("steps 1-3 comparisons failed: "
                             + " | ".join(failures))
    for e in entries:
        e["launches_by_path"] = {p: n[e["name"]] for p, n in by_path.items()
                                 if n[e["name"]]}
        e["launches"] = sum(e["launches_by_path"].values())
        if not e["launches"]:
            raise AssertionError(f"{e['name']}: no launch on any main path")
        if e["name"] in ("ssd_scan", "fused_policy_loss_fwd",
                         "fused_policy_loss_bwd"):
            e["tensor_core_launches"] = sum(
                n[f"{e['name']} tensor-core body"] for n in by_path.values())
    print(f"[smoke] wall {time.perf_counter() - t_main:.1f} s, the "
          f"kernels' build included | {smi}")
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
    if sys.argv[1:2] == ["--traced-host-plane"]:
        sys.exit(traced_host_plane(sys.argv[2]))
    sys.exit(main())
