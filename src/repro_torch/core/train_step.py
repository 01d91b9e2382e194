"""The AcceRL trainer step: GIPO + just-in-time GAE + lagged normalisation
with sequential micro-batch slicing and gradient accumulation (paper §5,
App. C), as in the reference ``repro/core/train_step.py``.

Per optimizer step (one gradient-accumulation window):
  1. slice the batch *sequentially* into micro-batches (contiguous views),
  2. per micro-batch: training forward → values → GAE on the spot →
     normalise with the PREVIOUS step's global stats (eq. 8) → GIPO loss
     → grads (``torch.autograd.grad`` against frozen params, eq. 7),
  3. accumulate grads in f32 and sum the packed advantage stats,
  4. one AdamW update; fold the stats into the Welford state.

With ``rl.fused_loss`` (the default) the action head and the GIPO /
entropy / KL loss run fused on hidden states (kernel K4 via
``dispatch.policy_head_loss``) and every attention call's backward is the
flash backward (kernel K3). ``loss_fn`` with ``fused_loss=False`` is the
reference path, which materialises the logits.

The port updates the state's params and AdamW moments in place (see
``optim/adamw.py``); ``train_step`` returns a new ``TrainState`` that
shares them. The reference's ``jit`` and buffer donation have no
counterpart: the step runs eagerly.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import batch_from_numpy
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core import advnorm, gae, gipo
from repro_torch.core.advnorm import AdvNormState
from repro_torch.data.trajectory import TrajectoryBatch
from repro_torch.kernels import dispatch
from repro_torch.models.policy import (
    action_log_prob,
    init_policy_params,
    policy_forward,
    policy_forward_hidden,
)
from repro_torch.launch.mesh import num_chips
from repro_torch.optim import adamw, zero
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves_with_path, tree_map


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    adv_norm: AdvNormState
    version: torch.Tensor           # i32 — published-policy version counter


def init_train_state(cfg: ModelConfig, seed: int = 0, *, mesh=None,
                     device="cuda") -> TrainState:
    """Random policy params from ``seed`` on ``device`` (``"meta"`` for a
    tree that costs no memory), zero AdamW moments and an empty Welford
    state.

    With ``mesh`` (a ``DeviceMesh`` carrying a ``data`` axis) of more than
    one device, the params are placed as DTensors under
    ``sharding.rules.param_specs`` and the f32 Adam moments under
    ``optim.zero.shard_opt_state`` — ZeRO-2: parameters stay replicated
    over ``data`` while each moment tensor's largest divisible axis is
    sharded over it (paper §3.1). On a one-device mesh this is a no-op, as
    in the reference."""
    dev = resolve_device(device)
    params = init_policy_params(cfg, seed, device=dev)
    opt = adamw.init(params)
    if mesh is not None and num_chips(mesh) > 1:
        pspec = rules.param_specs(cfg, params, mesh)
        params = rules.place_tree(params, mesh, pspec)
        opt = zero.shard_opt_state(opt, mesh, param_specs=pspec)
    return TrainState(params=params, opt=opt,
                      adv_norm=advnorm.init_adv_state(dev),
                      version=torch.zeros((), dtype=torch.int32, device=dev))


def _flat(x: torch.Tensor, b: int, tp1: int) -> torch.Tensor:
    return x.reshape((b * tp1,) + tuple(x.shape[2:]))


def _score_batch(cfg: ModelConfig, params, micro: TrajectoryBatch, *,
                 remat: bool):
    """Teacher-forced scoring of every (obs, action) step incl. bootstrap.
    Returns (logits [b,T+1,A,V], values [b,T+1], aux)."""
    b, tp1 = micro.obs_tokens.shape[:2]
    prefix = (None if micro.prefix_embeds is None
              else _flat(micro.prefix_embeds, b, tp1))
    out = policy_forward(cfg, params, _flat(micro.obs_tokens, b, tp1),
                         _flat(micro.actions, b, tp1),
                         _flat(micro.steps, b, tp1), prefix_embeds=prefix,
                         remat=remat)
    logits = out.logits.reshape((b, tp1) + tuple(out.logits.shape[1:]))
    return logits, out.value.reshape(b, tp1), out.aux


def _score_batch_hidden(cfg: ModelConfig, params, micro: TrajectoryBatch, *,
                        remat: bool):
    """Head-free twin of ``_score_batch`` for the fused-loss path.
    Returns (pred_hidden [b,T+1,A,d], values [b,T+1], aux)."""
    b, tp1 = micro.obs_tokens.shape[:2]
    prefix = (None if micro.prefix_embeds is None
              else _flat(micro.prefix_embeds, b, tp1))
    out = policy_forward_hidden(cfg, params, _flat(micro.obs_tokens, b, tp1),
                                _flat(micro.actions, b, tp1),
                                _flat(micro.steps, b, tp1),
                                prefix_embeds=prefix, remat=remat)
    hidden = out.pred_hidden.reshape(
        (b, tp1) + tuple(out.pred_hidden.shape[1:]))
    return hidden, out.value.reshape(b, tp1), out.aux


def _gae_and_norm(values, micro: TrajectoryBatch, adv_state: AdvNormState,
                  rl: RLConfig):
    """Just-in-time GAE (value recomputation, App. C.1) + lagged norm.
    ``value_recompute=False`` uses the STALE values recorded at collection
    (the Fig. 7 ablation)."""
    values_for_gae = values if rl.value_recompute else micro.behavior_value
    adv, returns = gae.jit_gae_from_forward(
        values_for_gae, micro.rewards, micro.dones, rl.discount,
        rl.gae_lambda)
    stats = advnorm.local_stats(adv, micro.mask)
    adv_n = advnorm.normalize_lagged(adv, adv_state)
    return adv_n.detach(), returns, stats


def _assemble_loss(cfg: ModelConfig, rl: RLConfig, pg, v_loss, kl, ent,
                   aux, stats, pg_metrics):
    """Combine the loss terms and build the (detached) metrics, shared by
    the reference and fused paths. A moe backbone's load-balance and
    router-z terms join the loss; its load balance and dropped share are
    reported."""
    total = pg + rl.value_coef * v_loss + rl.kl_coef * kl \
        - rl.entropy_coef * ent
    if cfg.arch_type == "moe":
        total = total + aux["load_balance"] + aux["router_z"]
    metrics = {
        "loss": total, "pg_loss": pg, "value_loss": v_loss, "kl": kl,
        "entropy": ent,
        "adv_mean_raw": stats[0] / torch.clamp_min(stats[2], 1.0),
        **pg_metrics,
    }
    if cfg.arch_type == "moe":
        metrics["moe_load_balance"] = aux["load_balance"]
        metrics["moe_dropped_frac"] = aux["dropped_frac"]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total, (metrics, stats.detach())


def _fused_loss_fn(params, micro: TrajectoryBatch, adv_state: AdvNormState,
                   cfg: ModelConfig, rl: RLConfig, *, remat: bool):
    """Fused-loss path: the action head + GIPO/entropy/KL run block-fused
    on hidden states; the [b,T,A,Va] logits are never materialised."""
    t = micro.horizon
    hidden, values, aux = _score_batch_hidden(cfg, params, micro,
                                              remat=remat)
    adv_n, returns, stats = _gae_and_norm(values, micro, adv_state, rl)
    b, a_dim = hidden.shape[0], micro.actions.shape[2]

    def per_token(x):                          # [b, t] -> [b * t * A]
        return x[..., None].expand(b, t, a_dim).reshape(-1)
    pg, ent, kl, pg_metrics = dispatch.policy_head_loss(
        hidden[:, :t].reshape(b * t * a_dim, -1),
        params["action_head"]["w"],
        micro.actions[:, :t].reshape(-1),
        micro.behavior_logp[:, :t].reshape(-1),
        per_token(adv_n), per_token(micro.mask), sigma=rl.gipo_sigma)
    v_loss = gipo.value_loss(values[:, :t], returns.detach(), micro.mask)
    return _assemble_loss(cfg, rl, pg, v_loss, kl, ent, aux, stats,
                          pg_metrics)


def loss_fn(params, micro: TrajectoryBatch, adv_state: AdvNormState,
            cfg: ModelConfig, rl: RLConfig, *, remat: bool = False):
    """(total loss, (metrics, packed adv stats)) of one micro-batch."""
    if rl.fused_loss and rl.algo == "gipo":
        return _fused_loss_fn(params, micro, adv_state, cfg, rl,
                              remat=remat)
    t = micro.horizon
    logits, values, aux = _score_batch(cfg, params, micro, remat=remat)
    adv_n, returns, stats = _gae_and_norm(values, micro, adv_state, rl)
    # token-level policy loss (App. D.3)
    logp_new = action_log_prob(logits[:, :t], micro.actions[:, :t])
    logp_old = micro.behavior_logp[:, :t]
    if rl.algo == "gipo":
        pg, pg_metrics = gipo.gipo_loss(logp_new, logp_old, adv_n,
                                        micro.mask, rl.gipo_sigma)
    else:
        pg, pg_metrics = gipo.ppo_loss(logp_new, logp_old, adv_n,
                                       micro.mask, rl.ppo_clip)
    # value loss: the bootstrap column is excluded
    v_loss = gipo.value_loss(values[:, :t], returns.detach(), micro.mask)
    kl = gipo.kl_penalty(logp_new, logp_old, micro.mask)
    ent = gipo.entropy_bonus(logits[:, :t], micro.mask)
    return _assemble_loss(cfg, rl, pg, v_loss, kl, ent, aux, stats,
                          pg_metrics)


def _microbatches(batch: TrajectoryBatch, n_micro: int):
    """Sequential contiguous slicing along the batch axis (App. C.1)."""
    b = batch.obs_tokens.shape[0]
    mb = b // n_micro

    def slice_i(i: int) -> TrajectoryBatch:
        return TrajectoryBatch(*(None if x is None else x[i * mb:(i + 1) * mb]
                                 for x in batch))
    return slice_i, mb


# --------------------------------------------------------------------------
# Stage functions: ``train_step`` composes them.
# --------------------------------------------------------------------------

def zero_grads_like(params):
    """Fresh f32 accumulator matching ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def microbatch_grads(params, micro: TrajectoryBatch,
                     adv_state: AdvNormState, *, cfg: ModelConfig,
                     rl: RLConfig, remat: bool = False):
    """Grads (in each param's dtype; zeros where a leaf gets none) and
    (metrics, packed adv stats) for one micro-batch against frozen
    params (eq. 7). Params placed as DTensors enter the forward as their
    full value (``rules.full_tensor``)."""
    live = tree_map(
        lambda p: rules.full_tensor(p).detach().requires_grad_(True), params)
    leaves = [x for _, x in tree_leaves_with_path(live)]
    with torch.enable_grad():
        total, aux = loss_fn(live, micro, adv_state, cfg, rl, remat=remat)
        got = torch.autograd.grad(total, leaves, allow_unused=True)
    by_id = {id(x): g if g is not None else torch.zeros_like(x)
             for x, g in zip(leaves, got)}
    return tree_map(lambda x: by_id[id(x)], live), aux


@torch.no_grad()
def accumulate_grads(acc, grads, stats_acc, stats, n_micro: int):
    """Fold one micro-batch's grads into the f32 accumulator (in place:
    ``acc + g.float() / n_micro``) and sum the packed stats."""
    tree_map(lambda a, g: a.add_(g.float() / n_micro), acc, grads)
    return acc, stats_acc + stats


def apply_update(state: TrainState, grads, stats, metrics, *,
                 rl: RLConfig) -> Tuple[TrainState, Dict]:
    """AdamW with the per-head lr tree, then fold the deferred advantage
    stats (end-of-backprop aggregation, App. C.1)."""
    lr_p = adamw.warmup_schedule(rl.lr_policy, rl.warmup_steps)(state.opt.step)
    lr_v = adamw.warmup_schedule(rl.lr_value, rl.warmup_steps)(state.opt.step)
    new_params, new_opt, gnorm = adamw.update(
        grads, state.opt, state.params, _lr_tree(state.params, lr_p, lr_v),
        max_grad_norm=rl.max_grad_norm)
    new_adv = advnorm.welford_update(state.adv_norm, stats)
    metrics = dict(metrics, grad_norm=gnorm, adv_count=new_adv.count)
    return TrainState(params=new_params, opt=new_opt, adv_norm=new_adv,
                      version=state.version + 1), metrics


def train_step(state: TrainState, batch: TrajectoryBatch, *,
               cfg: ModelConfig, rl: RLConfig,
               remat: bool = False) -> Tuple[TrainState, Dict]:
    """One optimizer step = ``rl.grad_accum`` micro-batch passes; the
    metrics are the last micro-batch's (the reference's ``m[-1]``)."""
    n_micro = rl.grad_accum
    slice_i, _ = _microbatches(batch, n_micro)
    grads = zero_grads_like(state.params)
    stats = torch.zeros((3,), dtype=torch.float32,
                        device=state.version.device)
    metrics = None
    for i in range(n_micro):
        g, (metrics, s) = microbatch_grads(state.params, slice_i(i),
                                           state.adv_norm, cfg=cfg, rl=rl,
                                           remat=remat)
        grads, stats = accumulate_grads(grads, g, stats, s, n_micro)
        del g
    return apply_update(state, grads, stats, metrics, rl=rl)


def _lr_tree(params, lr_policy, lr_value):
    """Per-leaf learning rates: any leaf under ``value_head`` trains at
    ``lr_value`` (10x the policy's, Table 3)."""
    return {k: (tree_map(lambda _: lr_value, v) if k == "value_head"
                else _lr_tree(v, lr_policy, lr_value)
                if isinstance(v, dict) else lr_policy)
            for k, v in params.items()}


def make_train_step(cfg: ModelConfig, rl: RLConfig, *, remat: bool = False,
                    device="cuda"):
    """Train step bound to a config and a device: a batch of numpy arrays
    is carried to the device first."""
    dev = resolve_device(device)
    step = functools.partial(train_step, cfg=cfg, rl=rl, remat=remat)

    def fn(state: TrainState, batch: TrajectoryBatch):
        if isinstance(batch.obs_tokens, np.ndarray):
            batch = batch_from_numpy(batch, device=dev)
        return step(state, batch)
    return fn
