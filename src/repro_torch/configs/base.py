"""Configuration dataclasses for the AcceRL reproduction.

Every selectable architecture (``--arch <id>``) is a :class:`ModelConfig`;
the RL pipeline, world model, and distribution settings have their own
dataclasses so the launcher can compose them freely.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard-style capacity dispatch)."""

    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden width
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    state_dim: int = 128            # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_dim: int = 4               # depthwise causal conv kernel
    chunk: int = 128                # SSD chunk length
    n_groups: int = 1               # B/C groups (shared across heads)
    # Hillclimb (§Perf, mamba2): split the fused in_proj into three
    # independently-sharded projections so the z/xBC/dt split never
    # crosses shard boundaries (kills a per-layer all-gather).
    fused_in_proj: bool = True

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 trunk + a single *shared* attention block
    applied every ``shared_every`` layers (weights tied across applications)."""

    shared_every: int = 6
    shared_d_ff: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A policy-backbone architecture.

    ``arch_type`` in {dense, moe, ssm, hybrid, audio, vlm}. ``audio`` and
    ``vlm`` use the same decoder stack as ``dense`` but accept precomputed
    modality embeddings from the (stubbed) frontend via ``prefix_embeds``.
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                # citation / model card

    # -- action head (paper App. D.1 vocabulary slimming) --------------------
    action_vocab_size: int = 256    # slimmed output head
    action_dim: int = 7             # action tokens emitted per env step
    max_episode_steps: int = 512    # for the value-head step embedding

    # -- attention ------------------------------------------------------------
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None      # normal operation
    long_context_window: int = 8192           # long_500k fallback for dense
    head_dim_override: Optional[int] = None

    # -- optional sub-configs ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # -- multimodal stub frontend ----------------------------------------------
    num_prefix_tokens: int = 0       # vision patches / audio frames per sample

    # -- numerics ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Natively sub-quadratic in context length (SSM state / window)."""
        return self.arch_type in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + action head)."""
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d                    # embedding
        total += self.action_vocab_size * d            # slimmed head
        if self.arch_type == "ssm":
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            g = self.ssm.n_groups
            per = (
                d * (2 * di + 2 * g * self.ssm.state_dim + nh)  # in_proj
                + self.ssm.conv_dim * (di + 2 * g * self.ssm.state_dim)
                + nh                                   # A_log
                + nh                                   # dt bias
                + di                                   # gated norm
                + di * d                               # out_proj
                + d                                    # pre-norm
            )
            return total + L * per
        kvh = self.num_kv_heads
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * kvh * hd + self.num_heads * hd * d
        if self.arch_type == "moe":
            assert self.moe is not None
            ff = 3 * d * self.moe.d_ff * self.moe.num_experts
            ff += d * self.moe.num_experts             # router
        else:
            ff = 3 * d * self.d_ff
        per = attn + ff + 2 * d                        # two norms
        total += L * per
        if self.arch_type == "hybrid":
            assert self.ssm is not None and self.hybrid is not None
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            g = self.ssm.n_groups
            per = (
                d * (2 * di + 2 * g * self.ssm.state_dim + nh)
                + self.ssm.conv_dim * (di + 2 * g * self.ssm.state_dim)
                + 2 * nh + di + di * d + d
            )
            shared = attn + 3 * d * self.hybrid.shared_d_ff + 2 * d
            total = self.vocab_size * d + self.action_vocab_size * d
            total += L * per + shared
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        assert self.moe is not None
        d, L = self.d_model, self.num_layers
        dense_share = self.param_count() - L * 3 * d * self.moe.d_ff * self.moe.num_experts
        return dense_share + L * 3 * d * self.moe.d_ff * self.moe.top_k


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """GIPO / PPO training settings (paper Table 3/5/6)."""

    algo: str = "gipo"               # {"gipo", "ppo"}
    gipo_sigma: float = 0.2
    ppo_clip: float = 0.2
    discount: float = 0.99
    gae_lambda: float = 0.95
    value_coef: float = 0.5
    kl_coef: float = 0.1
    entropy_coef: float = 0.0
    lr_policy: float = 3e-6
    lr_value: float = 3e-5
    warmup_steps: int = 500
    micro_batch: int = 16
    grad_accum: int = 2
    value_recompute: bool = True     # JIT-GAE fused into the train step
    adv_norm: str = "lagged_global"  # {"lagged_global", "batch", "none"}
    max_grad_norm: float = 1.0
    # -- hot-path fusion (kernels/dispatch.py) -------------------------------
    # fused_loss: run the action head + GIPO/entropy/KL loss block-fused on
    # hidden states (never materializing [B,T,A,Va] logits); exact parity
    # with the reference path. Only effective for algo == "gipo".
    # Default ON; fused_loss=False is the opt-out (--no-fused-loss).
    fused_loss: bool = True
    # kernel_dispatch: routing for the fused-loss op: "auto" = Pallas on
    # TPU, jnp twin elsewhere; "pallas"/"jnp" force one side (testing).
    # Attention routing has no per-config knob — use the process-wide
    # REPRO_KERNELS env var or dispatch.set_mode(), which also take
    # precedence over this field.
    kernel_dispatch: str = "auto"


@dataclasses.dataclass(frozen=True)
class WMConfig:
    """World model settings (paper §4, Table 4/5)."""

    imagine_horizon: int = 2
    frame_embed_dim: int = 256       # pixel-interface embedding width (stub codec)
    frame_tokens: int = 16           # patches per frame
    denoiser_layers: int = 4
    denoiser_d_model: int = 256
    denoiser_heads: int = 4
    history_frames: int = 4          # conditioning context ("step conditions")
    diffusion_steps: int = 8         # sampling steps at rollout time
    reward_train_interval: int = 15
    obs_train_interval: int = 3
    reward_scale: float = 5.0
    sigma_data: float = 0.5          # EDM preconditioning


@dataclasses.dataclass(frozen=True)
class SupervisionConfig:
    """Worker-lifecycle supervision (runtime/transport/supervision.py).

    ``restart="never"``: any worker failure marks
    its slot FAILED and schedulers fail fast. ``"on_failure"`` respawns
    (spawn mode) or re-accepts a redial (connect mode) with exponential
    backoff, up to ``max_restarts`` inside a sliding ``window_s``."""

    restart: str = "never"            # {"never", "on_failure"}
    max_restarts: int = 2             # budget inside the sliding window
    window_s: float = 60.0
    backoff_initial_s: float = 0.1
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    # connect-mode stall detector: a report gap beyond this is a failure
    # (0 = auto: liveness_heartbeats missed beats, floored at the floor)
    liveness_timeout_s: float = 0.0
    liveness_heartbeats: float = 10.0
    liveness_floor_s: float = 2.0
    # -- elastic autoscaling (runtime/transport/supervision.ElasticPolicy)
    # max_workers > 0 arms the autoscaler: the supervisor scales the
    # fleet between min/max from the experience-queue depth fraction and
    # the weight-staleness signal, draining (not killing) on scale-down
    min_workers: int = 0
    max_workers: int = 0
    elastic_interval_s: float = 2.0
    scale_up_depth: float = 0.25
    scale_down_depth: float = 0.9
    staleness_cap: float = 0.0        # published - oldest-acted version;
                                      # 0 disables the staleness signal
    drain_timeout_s: float = 10.0
    # inference-tier pressure (the queue_depth/window_fill gauges the
    # disaggregated plane bridges): a tier with queue depth >= tier_queue_hot
    # or window fill >= tier_fill_hot counts as saturated, which is an
    # additional scale-up trigger (and blocks scale-down) — 0 disables
    tier_queue_hot: float = 0.0
    tier_fill_hot: float = 0.0


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Cross-process transport (runtime/transport): socket/SHM experience
    channels + the weight-store wire for remote rollout workers (the
    paper's physical isolation of rollout from training)."""

    kind: str = "socket"              # {"socket", "shm", "ring"} — shm moves
                                      # large payloads out-of-band through
                                      # per-message shared memory; ring
                                      # through two persistent SHM rings per
                                      # channel (zero per-message churn)
    host: str = "127.0.0.1"
    port: int = 0                     # 0 = ephemeral
    listen_addr: str = ""             # "host:port" override of host/port —
                                      # bind 0.0.0.0 for multi-host workers
    token: str = ""                   # shared secret for the worker.hello
                                      # handshake (connect-mode workers)
    remote_rollout_workers: int = 0   # spawned rollout worker PROCESSES
    connect_rollout_workers: int = 0  # slots for workers that DIAL IN
                                      # (repro.launch.worker, other hosts)
    envs_per_worker: int = 1          # rollout envs inside each process
    heartbeat_s: float = 0.25         # child metrics/health report interval
    connect_timeout_s: float = 20.0
    shm_threshold_bytes: int = 1 << 16
    # wire-client resilience: transparent redial budget after a
    # server-side connection drop (0 = fail fast)
    reconnect_attempts: int = 0
    reconnect_backoff_s: float = 0.1
    # -- streaming data plane ------------------------------------------------
    # put_window > 0: rollout flushes go through a pipelined PutStream
    # (fire-and-forget frames, windowed async acks, exactly-once replay
    # after a reconnect) instead of one blocking RPC per flush. 0 keeps
    # one request/response per flush.
    put_window: int = 0
    # adaptive streaming: tune the effective put window / ack cadence
    # online from observed cumulative-ack RTT (multiplicative increase on
    # low occupancy, halving backoff on verdict pressure or RTT spikes).
    # put_window and ack cadence become BOUNDS — the effective window
    # starts at put_window, so steady RTT never drops below static.
    adaptive_put_window: bool = False
    # ring capacity per direction for kind="ring" (the persistent SHM
    # ring data plane; must hold several encoded flushes)
    ring_bytes: int = 8 << 20
    # zero-copy ring pops: the trainer-side channel decodes experience
    # straight out of the committed ring region under a lease instead of
    # copying each record out (the Prefetcher releases leases post-collate)
    zero_copy_pop: bool = False
    # weight broadcast lane: > 0 gives the server a persistent SHM ring
    # of this capacity holding one encoded weight blob per version;
    # same-host acquires read it positionally instead of receiving the
    # blob per-message (kills per-acquire SHM segment churn)
    weight_lane_bytes: int = 0
    # -- disaggregated inference plane ---------------------------------------
    # "": every rollout child runs its own colocated inference pool.
    # "host": the parent serves its OWN InferenceService behind the
    #   infer.* endpoints of the main TransportServer; remote rollout
    #   children submit action requests to it instead of building a pool.
    # "spawn": a supervised inference-tier child hosts the shared pool
    #   behind its own TransportServer on a fixed pre-allocated port;
    #   rollout children dial the tier (and redial across its restarts).
    inference_plane: str = ""
    infer_listen_addr: str = ""       # "host:port" bind override for the
                                      # spawned tier (default loopback +
                                      # a pre-allocated ephemeral port)
    # -- resilient control plane (runtime/transport/resilience) --------------
    # journal_dir non-empty: hosted channel contents, stream dedup
    # watermarks, and weight-store publishes are write-ahead journaled
    # there (compacted once the log passes journal_compact_bytes);
    # resume_journal: recover that directory's state at startup instead
    # of requiring it empty — the --resume-journal replacement-server path
    journal_dir: str = ""
    journal_compact_bytes: int = 64 << 20
    resume_journal: bool = False
    supervision: SupervisionConfig = dataclasses.field(
        default_factory=SupervisionConfig)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Observability plane (runtime/telemetry.py).

    ``sink=True`` registers a TelemetrySink service that samples every
    service's metrics/health into bounded history (and ``sink_path`` as
    JSONL), served remotely through the ``metrics.snapshot`` endpoint.
    Span/trace RECORDING is import-gated separately by the REPRO_TRACE
    env var (set automatically by ``launch/train.py --trace-out``) — it
    must be decided before the hot modules import, which a config field
    evaluated afterwards cannot do."""

    sink: bool = False
    sink_interval_s: float = 1.0
    sink_history: int = 256
    sink_path: str = ""               # JSONL history file ("" = memory only)
    trace_out: str = ""               # Chrome-trace JSON dump path written
                                      # by the launcher after the run


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Asynchronous runtime (paper §3, eq. 1)."""

    num_rollout_workers: int = 6
    num_inference_workers: int = 1
    num_trainer_workers: int = 1
    inference_batch: int = 8         # B in eq. 1
    inference_max_wait_s: float = 0.01   # T_max in eq. 1
    replay_capacity: int = 3000      # episodes
    wm_replay_capacity: int = 50_000
    img_replay_capacity: int = 10_000
    min_buffer_episodes: int = 4
    sync_mode: bool = False          # True reproduces the synchronous baseline
    weight_sync_interval: int = 1    # trainer steps between publishes
    drain: bool = True               # inference-drain protocol (App. D.6)
    prefetch_depth: int = 2
    # -- device ingest path (data/prefetch.py) -------------------------------
    prefetch_drain_timeout_s: float = 0.1   # partial-drain slice
    prefetch_idle_timeout_s: float = 0.5    # idle-backoff cap
    prefetch_staging: bool = True    # assemble batches into pooled
                                     # page-aligned host staging slabs
    prefetch_to_device: bool = False  # jax.device_put from the prefetch
                                      # thread (H2D overlaps next collate)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)  # TPU-friendly pads
    # -- pipelined training runtime (runtime/pipeline_exec.py) ---------------
    # pipeline=True routes TrainerWorker.train_on_batch through the static
    # per-submesh instruction schedule (RUN/SEND/RECV/FREE): the policy
    # trainer and the world-model trainer run as pipeline stages on
    # disjoint submeshes of the local device set, with microbatched
    # gradient accumulation and FREE instructions bounding live grads to
    # one micro-batch. On a 1-device host both submeshes share the device
    # (schedule semantics identical, overlap nil).
    pipeline: bool = False
    pipeline_microbatches: int = 0   # micro-batches per round (0 = grad_accum)
    pipeline_wm_devices: int = 0     # WM-submesh device count (0 = half the
                                     # local devices when >= 2, else shared)
    # -- experience channels (runtime/experience.py) -------------------------
    # Backpressure when the segment channel is full: "drop_oldest" is the
    # paper's fully-asynchronous mode (producers never block); "drop_newest"
    # keeps queued data; "block" clamps rollout to trainer throughput.
    replay_backpressure: str = "drop_oldest"
    # WM mode: target share of REAL segments in the policy trainer's batch
    # (MixedExperienceSource over B and B_img). 0.0 = paper §4 (pure B_img).
    mix_real_fraction: float = 0.0
    # -- cross-process transport (runtime/transport) -------------------------
    # remote_rollout_workers > 0 spawns that many rollout worker processes
    # whose channels/weight endpoints cross the boundary over this config.
    transport: TransportConfig = dataclasses.field(
        default_factory=TransportConfig)
    # -- observability plane (runtime/telemetry) -----------------------------
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # {"train", "prefill", "decode"}


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have "
                   f"{[s.name for s in INPUT_SHAPES]}")
