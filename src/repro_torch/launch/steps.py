"""The three step programs of the dry run and the production launchers, as
in the reference ``repro/launch/steps.py`` (DESIGN.md §5):

  * ``seq_train_step`` (train_4k)    — teacher-forced GIPO + JIT-GAE + lagged
    advantage normalization + AdamW(ZeRO-2) over a [B, S] token batch. The
    sequence IS the stream of action tokens (the paper's token-level
    optimization, App. D.3, with A folded into S).
  * ``prefill_step`` (prefill_32k) — prompt pass emitting the decode cache.
  * ``serve_step``  (decode_32k / long_500k) — ONE new token against a
    KV/state cache of ``seq_len``.

The spec builders return the trees (on ``meta``) and their
``sharding.rules.NamedSharding``s, so the dry run and the launchers share
one program. The reference jits each step with in/out shardings and GSPMD
splits it; the port runs it eagerly on the tensors it is given, and where
a mesh of more than one device placed the parameters (DTensors) each rank
runs its part of the split program (``sharding/spmd.py``):

  * the batch is the rank's rows (``spmd.rows``; ``data_split=False``
    where every rank is given the whole batch: long_500k's B = 1, or a MoE
    batch whose capacity groups straddle the ranks, ``spmd.splits``); each
    loss term is weighted by the rank's mask count over the global
    micro-batch's, and the grads, metrics and advantage stats are
    all-reduced over the data axes;
  * every block whose leaves the rules put on their split axes runs on
    the rank's part (Megatron's layout: an all-reduce after each
    row-parallel product and on each block input's gradient): attention
    on its query heads (``wk``/``wv`` on its KV heads, or used whole where
    the KV heads do not divide ``model``: granite-moe, dbrx, internlm2,
    llava, starcoder2, granite-20b on 16), the MLP on its ``d_ff``
    columns, a MoE block on its experts (the router, top-k and capacity
    whole on every rank), a Mamba2 block on its heads (``in_proj``, the
    conv, ``A_log``, ``D`` and ``dt_bias`` used whole on the rank's
    columns, K6/K7 on its heads), zamba2's shared block as the dense
    family's, the embedding on its vocabulary rows; prefill and decode
    take and emit the rank's region of the cache (``rules.cache_specs``:
    KV heads or their ``head_dim`` slices, the SSM state's heads, a chunk
    of the conv tail's channels), and decode against a cache on
    ``head_dim`` all-gathers its KV heads' slices (C10d queues the
    partial-score split);
  * the grads of the leaves used whole inside a split block are each
    rank's part and are summed over ``model`` once a step, beside the data
    all-reduce (``spmd.Layout.sum_parts``); every other leaf sharded over
    the mesh (a block off its split axes, the action and value heads,
    ``prefix_proj``) is gathered whole before use and its grad cut back to
    the rank's region; the grads then go to ZeRO-2 as DTensors placed as
    the parameters.

A one-device program (plain tensors) issues no collective. The reference's
``unroll`` and ``act_sharding`` (scan unrolling and a GSPMD layout pin)
have no counterpart in an eager loop and are not taken.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RLConfig, ShapeConfig
from repro_torch.core import advnorm, gae, gipo
from repro_torch.core.advnorm import AdvNormState
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import num_chips
from repro_torch.models import transformer
from repro_torch.models.layers import Params
from repro_torch.optim import adamw, zero
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import P, NamedSharding
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

ATTN_BLOCK = 1024      # online-softmax KV block (perf knob, §Perf)


class SeqTrainState(NamedTuple):
    """Trainer state for the sequence-granularity production train step."""

    params: Any
    opt: adamw.AdamWState
    adv_norm: AdvNormState


def _value_mlp(vh: Params, hidden: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Per-position value estimate reusing the action-aware value head's
    parameters (single-token pooling ⇒ attention weight ≡ 1; step
    embedding indexed by episode-step = position mod max_steps)."""
    h = hidden.detach().float()
    max_steps = vh["step_emb"].shape[0]
    e_step = vh["step_emb"][positions % max_steps]
    x = h + e_step[None]
    # jax.nn.gelu defaults to the tanh approximation
    x = F.gelu(x @ vh["mlp_w1"] + vh["mlp_b1"], approximate="tanh")
    return (x @ vh["mlp_w2"] + vh["mlp_b2"])[..., 0]          # [B, S]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy where it starts off a 16-byte boundary: K4 takes
    rows that start on one, and a view of a micro-batch's (or a rank's
    single) rows starts wherever the elements before it put it."""
    return x.clone() if x.data_ptr() % 16 else x


def seq_loss_fn(params, batch: Dict[str, torch.Tensor], adv_state,
                cfg: ModelConfig, rl: RLConfig, *, remat: bool = True,
                block: Optional[int] = ATTN_BLOCK, split=None, weight=None):
    """Token-level GIPO over a [B, S] sequence with JIT value recomputation.

    batch: tokens [B,S] i32, behavior_logp [B,S] f32, rewards [B,S-1] f32,
    dones [B,S-1] f32, mask [B,S-1] f32, prefix (optional [B,P,F]).
    Tokens are unified ids; a token's action-bin id is ``token mod Va``
    (the slimmed head scores only the action vocabulary, App. D.1).
    Returns (total, (metrics, packed adv stats)).

    In a placed program ``split`` is the forward's ``spmd.Split`` and
    ``weight`` this rank's share of the global micro-batch's masked means
    (``spmd.weights``): the masked means and their metrics are scaled by
    it, and a MoE backbone's aux terms (the global batch's on every data
    rank) by one over the data axes' size, so that the ranks' totals and
    metrics sum to the reference's."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    fused = rl.fused_loss and rl.algo == "gipo"
    out = transformer.forward(cfg, params, tokens, batch.get("prefix"),
                              window=cfg.sliding_window, remat=remat,
                              block=block, head=not fused, split=split)
    # next-token factorization: logits[:, t] scores tokens[:, t+1]
    p = out["hidden"].shape[1] - s          # prefix length
    hidden = out["hidden"][:, p:]
    targets = tokens[:, 1:] % cfg.action_vocab_size

    # --- JIT value recomputation (App. C.1): values from THIS forward ----
    positions = torch.arange(s, device=tokens.device)
    values = _value_mlp(params["value_head"], hidden, positions)   # [B,S]
    adv, returns = gae.jit_gae_from_forward(
        values, batch["rewards"], batch["dones"], rl.discount,
        rl.gae_lambda)
    stats = advnorm.local_stats(adv, batch["mask"])
    adv_n = advnorm.normalize_lagged(adv, adv_state).detach()

    mask = batch["mask"]
    logp_old = batch["behavior_logp"][:, 1:]
    if fused:
        # action head + GIPO/entropy/KL fused on hidden states (K4): no
        # [B,S,Va] logits or log-softmax in device memory
        rows = [_aligned(x.reshape(n)) for x, n in (
            (hidden[:, :-1], (b * (s - 1), -1)), (targets, -1),
            (logp_old, -1), (adv_n, -1), (mask, -1))]
        pg, _ent, kl, pg_m = dispatch.policy_head_loss(
            rows[0], params["action_head"]["w"], *rows[1:],
            sigma=rl.gipo_sigma)
        pg_m = {k: v.detach() for k, v in pg_m.items()}
    else:
        logits = out["logits"][:, p:][:, :-1]                    # [B,S-1,Va]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp_new = torch.gather(logp_all, -1,
                                targets[..., None].long())[..., 0]
        if rl.algo == "gipo":
            pg, pg_m = gipo.gipo_loss(logp_new[..., None],
                                      logp_old[..., None], adv_n, mask,
                                      rl.gipo_sigma)
        else:
            pg, pg_m = gipo.ppo_loss(logp_new[..., None],
                                     logp_old[..., None], adv_n, mask,
                                     rl.ppo_clip)
        kl = gipo.kl_penalty(logp_new[..., None], logp_old[..., None], mask)
    v_loss = gipo.value_loss(values[:, :-1], returns.detach(), mask)
    if weight is not None:
        pg, v_loss, kl = pg * weight, v_loss * weight, kl * weight
        pg_m = {k: v * weight for k, v in pg_m.items()}
    total = pg + rl.value_coef * v_loss + rl.kl_coef * kl
    if cfg.arch_type == "moe":
        aux = out["aux"]["load_balance"] + out["aux"]["router_z"]
        if split is not None and split.data is not None:
            aux = aux / split.data.size
        total = total + aux
    metrics = {"loss": total, "pg_loss": pg, "value_loss": v_loss,
               "kl": kl, **pg_m}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total, (metrics, stats.detach())


def _seq_grads(live, batch, adv_state, *, cfg: ModelConfig, rl: RLConfig,
               remat: bool, block: Optional[int], split=None, weight=None):
    """Grads of one micro-batch with respect to the ``live`` leaves
    (detached tensors that require grad; in each leaf's dtype, zeros where
    a leaf gets none, as ``jax.grad`` gives) against frozen params."""
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, aux = seq_loss_fn(live, batch, adv_state, cfg, rl,
                                 remat=remat, block=block, split=split,
                                 weight=weight)
        got = torch.autograd.grad(total, leaves, allow_unused=True)
    by_id = {id(x): g if g is not None else torch.zeros_like(x)
             for x, g in zip(leaves, got)}
    return tree_map(lambda x: by_id[id(x)], live), aux


def _constrain(grads, shardings):
    """The reference's ``with_sharding_constraint`` on the grads: each grad
    under its sharding, no collective. A placed program's grad (a DTensor
    placed as its parameter) is cut to the sharding's region
    (``spmd.recut``); a full grad is placed (``rules.place``). On a
    one-device mesh there is nothing to cut, as in ``init_train_state``."""
    def put(g, sh):
        if num_chips(sh.mesh) == 1:
            return g
        if rules.is_dtensor(g):
            return spmd.recut(g, sh)
        return rules.place(g, sh)
    return tree_map(put, grads, shardings)


def _micro_batches(batch, accum: int):
    return [batch] if accum == 1 else [
        {k: v[i] for k, v in batch.items()} for i in range(accum)]


def seq_grads(params, batch, adv_state, *, cfg: ModelConfig, rl: RLConfig,
              remat: bool = True, block: Optional[int] = ATTN_BLOCK,
              accum: int = 1, data_split: bool = True):
    """The grads ``seq_train_step`` updates with, its metrics and its
    summed advantage stats: ``accum`` sequential micro-batch passes (App.
    C.1: contiguous slicing, params frozen within the accumulation window).

    With ``accum > 1`` every batch leaf carries a leading [accum]
    micro-batch axis; grads are accumulated in f32 as ``a + g / accum``,
    the metrics are the last micro-batch's and the stats are summed.

    With params placed as DTensors this is the rank's part of the split
    program (the module's docstring): the grads come out as DTensors placed
    as the params (f32; the parts of the leaves used whole inside a split
    block summed over ``model``), the metrics and stats as the global
    batch's."""
    kw = dict(cfg=cfg, rl=rl, remat=remat, block=block)
    lay = spmd.layout(cfg, params)
    if lay is None:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if accum == 1:
            grads, (metrics, stats) = _seq_grads(live, batch, adv_state,
                                                 **kw)
            return grads, metrics, stats
        split = weights = None
    else:
        live = spmd.live_params(params, lay, requires_grad=True)
        split = lay.run(data_split)
        weights = spmd.weights(batch["mask"], accum, split.data)
    grads = None
    stats = torch.zeros((3,), dtype=torch.float32,
                        device=batch["tokens"].device)
    for i, mbatch in enumerate(_micro_batches(batch, accum)):
        g, (metrics, s) = _seq_grads(
            live, mbatch, adv_state, split=split,
            weight=None if weights is None else weights[i], **kw)
        if grads is None:
            grads = tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), g)
        with torch.no_grad():
            tree_map(lambda a, x: a.add_(x.float() / accum), grads, g)
        stats = stats + s
        del g
    if lay is None:
        return grads, metrics, stats
    with torch.no_grad():
        if split.data is not None:
            metrics, stats = spmd.sum_metrics(metrics, stats, split.data)
            tree_map(split.data.sum_, grads)
        lay.sum_parts(grads)
    return spmd.place_grads(grads, params, lay), metrics, stats


def seq_train_step(state: SeqTrainState, batch, *, cfg: ModelConfig,
                   rl: RLConfig, remat: bool = True,
                   block: Optional[int] = ATTN_BLOCK, accum: int = 1,
                   grad_shardings=None,
                   data_split: bool = True) -> Tuple[SeqTrainState, Dict]:
    """One optimizer step = ``accum`` sequential micro-batch passes
    (``seq_grads``), then the warmup lr, AdamW and the Welford update
    (single deferred stats aggregation). The params and AdamW moments are
    updated in place (``adamw.update``).

    With params placed as DTensors, ``batch`` is this rank's rows
    (``spmd.rows``) unless ``data_split`` is False (every rank given the
    whole batch); the module's docstring says what each rank runs."""
    grads, metrics, stats = seq_grads(state.params, batch, state.adv_norm,
                                      cfg=cfg, rl=rl, remat=remat,
                                      block=block, accum=accum,
                                      data_split=data_split)
    if grad_shardings is not None:
        grads = _constrain(grads, grad_shardings)
    lr = adamw.warmup_schedule(rl.lr_policy, rl.warmup_steps)(state.opt.step)
    new_params, new_opt, gnorm = adamw.update(
        grads, state.opt, state.params, lr, max_grad_norm=rl.max_grad_norm)
    new_adv = advnorm.welford_update(state.adv_norm, stats)
    metrics = dict(metrics, grad_norm=gnorm)
    return SeqTrainState(new_params, new_opt, new_adv), metrics


def _axes_size(mesh, axes) -> int:
    sizes = rules.mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def choose_accum(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 *, carry_budget_bytes: float = 3 * 2**30,
                 pure_dp: bool = False) -> int:
    """Pick gradient-accumulation steps so the remat-saved layer carries of
    one micro-batch stay under ``carry_budget_bytes`` per device
    (carries = L × mb_local × S × d_model × 2 bytes)."""
    dp = tuple(rules.batch_axes(mesh)) + (("model",) if pure_dp else ())
    local_b = max(shape.global_batch // _axes_size(mesh, dp), 1)
    per_seq = cfg.num_layers * shape.seq_len * cfg.d_model * 2
    mb = max(int(carry_budget_bytes // max(per_seq, 1)), 1)
    accum = 1
    while local_b // accum > mb and accum < local_b:
        accum *= 2
    return accum


def _serving(cfg: ModelConfig, params, data_split: bool):
    """(live params, split) of a serving program: placed params as the
    rank's live leaves and its ``spmd.Split``; plain ones as they are."""
    lay = spmd.layout(cfg, params)
    if lay is None:
        return params, None
    return spmd.live_params(params, lay), lay.run(data_split)


def prefill_step(params, tokens, prefix, *, cfg: ModelConfig,
                 window: Optional[int], cache_len: int,
                 block: Optional[int] = ATTN_BLOCK, data_split: bool = True):
    """The prompt pass: (last position's logits [B, Va], decode cache). With
    params placed as DTensors, ``tokens`` and ``prefix`` are the rank's rows
    (``data_split`` as in ``seq_train_step``), the logits come out whole
    over the action vocabulary on every model rank, and the cache holds
    the rank's rows and, where a block is split over ``model``, its region
    of that block's cache (``spmd.local_cache`` of the whole one)."""
    live, split = _serving(cfg, params, data_split)
    out, cache = transformer.prefill(cfg, live, tokens, prefix,
                                     cache_len=cache_len, window=window,
                                     block=block, split=split)
    return out["logits"][:, -1], cache


def serve_step(params, token, cache, *, cfg: ModelConfig,
               window: Optional[int], uniform: bool = False,
               data_split: bool = True):
    """One token against ``cache``, updated in place (``transformer.decode``;
    ``uniform`` as in ``attention.attention_decode``). Placed params take
    the rank's tokens and cache, as ``prefill_step`` emits them."""
    live, split = _serving(cfg, params, data_split)
    out, cache = transformer.decode(cfg, live, token, cache, window=window,
                                    uniform=uniform, split=split)
    return out["logits"][:, -1], cache


# ---------------------------------------------------------------------------
# Spec builders — trees on ``meta`` + NamedShardings per (arch × shape)
# ---------------------------------------------------------------------------

def long_context_window(cfg: ModelConfig,
                        shape: ShapeConfig) -> Optional[int]:
    """Sliding-window fallback for dense archs at 500k (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.subquadratic \
            and not cfg.is_attention_free:
        return cfg.long_context_window
    return cfg.sliding_window


def effective_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    window = long_context_window(cfg, shape)
    return min(shape.seq_len, window) if window else shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_structs(cfg: ModelConfig, *, with_value_head: bool = True):
    """The parameter tree on ``meta`` (shapes and dtypes, no memory)."""
    if with_value_head:
        from repro_torch.models.policy import init_policy_params
        return init_policy_params(cfg, 0, device="meta")
    return transformer.init_params(cfg, torch.Generator(), device="meta")


def state_structs(cfg: ModelConfig) -> SeqTrainState:
    p = param_structs(cfg)

    def f32(t):
        return tree_map(lambda x: _meta(x.shape, torch.float32), t)
    opt = adamw.AdamWState(step=_meta((), torch.int32), mu=f32(p),
                           nu=f32(p))
    advs = AdvNormState(*(_meta((), torch.float32) for _ in range(3)))
    return SeqTrainState(params=p, opt=opt, adv_norm=advs)


def train_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                accum: int = 1, fsdp=None, pure_dp: bool = False,
                fsdp_model: bool = False, zero3_axis=None):
    """(state_structs, batch_structs, state_shardings, batch_shardings).

    With ``accum > 1`` every batch leaf gains a LEADING unsharded
    [accum] micro-batch axis and the batch axis proper moves to axis 1
    (sequential micro-batch slicing, App. C.1)."""
    b, s = shape.global_batch, shape.seq_len
    sizes = rules.mesh_shape(mesh)
    state = state_structs(cfg)
    if fsdp_model or zero3_axis:
        # ZeRO-3 (§Perf): every tensor's largest divisible axis shards
        # over the chosen axis
        ax = zero3_axis or "model"
        repl = tree_map(lambda l: P(*([None] * l.ndim)), state.params)
        pspec = zero.shard_moments_spec(state.params, repl, data_axis=ax,
                                        data_size=sizes[ax])
    else:
        pspec = rules.param_specs(cfg, state.params, mesh, fsdp=fsdp,
                                  tp=not pure_dp)
    mspec = _moments_specs(state.params, pspec, mesh)
    scalar = P()
    state_spec = SeqTrainState(
        params=pspec,
        opt=adamw.AdamWState(step=scalar, mu=mspec,
                             nu=tree_map(lambda x: x, mspec)),
        adv_norm=AdvNormState(scalar, scalar, scalar))

    mb = b // accum
    lead = (accum, mb) if accum > 1 else (b,)
    batch = {
        "tokens": _meta(lead + (s,), torch.int32),
        "behavior_logp": _meta(lead + (s,), torch.float32),
        "rewards": _meta(lead + (s - 1,), torch.float32),
        "dones": _meta(lead + (s - 1,), torch.float32),
        "mask": _meta(lead + (s - 1,), torch.float32),
    }
    if cfg.num_prefix_tokens:
        batch["prefix"] = _meta(
            lead + (cfg.num_prefix_tokens, transformer.FRONTEND_DIM),
            torch.float32)

    def bspec_for(v):
        nd = v.ndim - (1 if accum > 1 else 0)
        if pure_dp:
            # batch over BOTH mesh axes — no tensor parallelism at all
            axes = tuple(rules.batch_axes(mesh)) + ("model",)
            spec = P(*((axes,) + (None,) * (nd - 1))) \
                if mb % _axes_size(mesh, axes) == 0 else P(*([None] * nd))
        else:
            spec = rules.data_spec(mesh, mb, nd)
        if accum > 1:
            spec = P(None, *spec)
        return spec
    bspec = {k: bspec_for(v) for k, v in batch.items()}
    return state, batch, _ns(mesh, state_spec), _ns(mesh, bspec)


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp=None):
    b, s = shape.global_batch, shape.seq_len
    window = long_context_window(cfg, shape)
    cache_len = effective_cache_len(cfg, shape)
    params = param_structs(cfg, with_value_head=False)
    pspec = rules.param_specs(cfg, params, mesh, fsdp=fsdp)
    tokens = _meta((b, s), torch.int32)
    tspec = rules.data_spec(mesh, b, 2, seq_axis=1, seq_len=s)
    prefix = prefix_spec = None
    if cfg.num_prefix_tokens:
        prefix = _meta((b, cfg.num_prefix_tokens, transformer.FRONTEND_DIM),
                       torch.float32)
        prefix_spec = rules.data_spec(mesh, b, 3)
    cache = transformer.init_decode_cache(cfg, b, cache_len, window=window,
                                          device="meta")
    cspec = rules.cache_specs(cfg, cache, mesh, b, cache_len)
    return dict(params=params, tokens=tokens, prefix=prefix, cache=cache,
                window=window, cache_len=cache_len,
                shardings=dict(params=_ns(mesh, pspec),
                               tokens=_ns(mesh, tspec),
                               prefix=_ns(mesh, prefix_spec)
                               if prefix is not None else None,
                               cache=_ns(mesh, cspec)))


def serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp=None,
                seq_shard: bool = False):
    b = shape.global_batch
    window = long_context_window(cfg, shape)
    cache_len = effective_cache_len(cfg, shape)
    params = param_structs(cfg, with_value_head=False)
    pspec = rules.param_specs(cfg, params, mesh, fsdp=fsdp)
    token = _meta((b,), torch.int32)
    tok_spec = rules.data_spec(mesh, b, 1)
    cache = transformer.init_decode_cache(cfg, b, cache_len, window=window,
                                          device="meta")
    cspec = rules.cache_specs(cfg, cache, mesh, b, cache_len,
                              seq_shard_model=seq_shard)
    return dict(params=params, token=token, cache=cache, window=window,
                cache_len=cache_len,
                shardings=dict(params=_ns(mesh, pspec),
                               token=_ns(mesh, tok_spec),
                               cache=_ns(mesh, cspec)))


def _moments_specs(param_structs_tree, pspec, mesh):
    """ZeRO-2: Adam moments additionally sharded over ``data``."""
    return zero.shard_moments_spec(
        param_structs_tree, pspec, data_axis="data",
        data_size=rules.mesh_shape(mesh)["data"])


def _ns(mesh, spec_tree):
    """A spec tree (dicts and NamedTuples of ``PartitionSpec``s) as
    ``NamedSharding``s on ``mesh``."""
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s),
                              spec_tree)
