"""The VLA policy: backbone + slimmed action head + value head, as in the
reference ``repro/models/policy.py``.

An env step consumes an observation embedding (stub frontend) plus the
instruction tokens and emits ``action_dim`` discrete action tokens, their
behaviour log-probs μ and the value V(o_t) (``sample_action_sequence``).
The trainer scores recorded steps teacher-forced (``policy_forward``, or
``policy_forward_hidden`` for the fused-loss path).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Params
from repro_torch.models.value_head import value_head, value_head_init


def init_policy_params(cfg: ModelConfig, seed: int = 0, *,
                       device="cuda") -> Params:
    """Random policy parameters drawn on ``device`` from a generator seeded
    with ``seed``. On ``"meta"`` the tree has shapes and dtypes only (no
    draw is made)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    params = transformer.init_params(cfg, gen, device=dev)
    params["value_head"] = value_head_init(
        gen, cfg.d_model, cfg.max_episode_steps, dev)
    return params


class PolicyOutput(NamedTuple):
    logits: torch.Tensor       # [B, A, Va] f32 — per action-token logits
    value: torch.Tensor        # [B]
    hidden: torch.Tensor       # [B, S, d]
    aux: Dict[str, Union[float, torch.Tensor]]  # MoE load-balance /
    #                            router-z / dropped share (f32 scalars;
    #                            floats 0 for the other arch types)


class PolicyHidden(NamedTuple):
    pred_hidden: torch.Tensor  # [B, A, d] — hidden at the position that
    #                            predicts each action token (pre head)
    value: torch.Tensor        # [B]
    aux: Dict[str, Union[float, torch.Tensor]]  # as PolicyOutput.aux


def _teacher_forced(cfg: ModelConfig, params: Params,
                    obs_tokens: torch.Tensor, action_tokens: torch.Tensor,
                    step_t: torch.Tensor,
                    prefix_embeds: Optional[torch.Tensor], *,
                    remat: bool, head: bool):
    """Shared teacher-forced pass. Returns (transformer out, pred slice,
    value); ``pred`` selects the positions prefix + T_obs + k − 1 that
    predict action token k, in one place for both paths."""
    a = action_tokens.shape[1]
    tokens = torch.cat([obs_tokens, action_tokens], dim=1)
    out = transformer.forward(cfg, params, tokens,
                              prefix_embeds=prefix_embeds, remat=remat,
                              head=head)
    t_total = out["hidden"].shape[1]
    pred = slice(t_total - a - 1, t_total - 1)
    act_hidden = out["hidden"][:, t_total - a:]                  # [B, A, d]
    value = value_head(params["value_head"], act_hidden, step_t)
    return out, pred, value


def policy_forward(cfg: ModelConfig, params: Params,
                   obs_tokens: torch.Tensor, action_tokens: torch.Tensor,
                   step_t: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None, *,
                   remat: bool = False) -> PolicyOutput:
    """Teacher-forced scoring of one env step. obs_tokens: [B, T_obs];
    action_tokens: [B, A]; step_t: [B]. Logits for action token k are read
    at the position preceding it."""
    out, pred, value = _teacher_forced(cfg, params, obs_tokens,
                                       action_tokens, step_t, prefix_embeds,
                                       remat=remat, head=True)
    return PolicyOutput(logits=out["logits"][:, pred], value=value,
                        hidden=out["hidden"], aux=out["aux"])


def policy_forward_hidden(cfg: ModelConfig, params: Params,
                          obs_tokens: torch.Tensor,
                          action_tokens: torch.Tensor, step_t: torch.Tensor,
                          prefix_embeds: Optional[torch.Tensor] = None, *,
                          remat: bool = False) -> PolicyHidden:
    """Teacher-forced scoring that stops before the action head; the fused
    loss (``dispatch.policy_head_loss``) applies the head blockwise."""
    out, pred, value = _teacher_forced(cfg, params, obs_tokens,
                                       action_tokens, step_t, prefix_embeds,
                                       remat=remat, head=False)
    return PolicyHidden(pred_hidden=out["hidden"][:, pred], value=value,
                        aux=out["aux"])


def action_log_prob(logits: torch.Tensor,
                    action_tokens: torch.Tensor) -> torch.Tensor:
    """Token-level log-probs. logits: [B, A, Va]; actions: [B, A]."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, action_tokens.long()[..., None])[..., 0]


def gumbel_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_action_sequence(cfg: ModelConfig, params: Params,
                           gen: Optional[torch.Generator],
                           obs_tokens: torch.Tensor, step_t: torch.Tensor,
                           prefix_embeds: Optional[torch.Tensor] = None,
                           temperature: float = 1.0,
                           gumbel: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Autoregressive action sampling for one env step.

    Prefills the observation context, then decodes ``cfg.action_dim``
    action tokens against the decode cache (a KV cache, or the SSM state;
    ``cache_len`` sizes only the former). Each token is drawn by Gumbel-max,
    ``argmax(logits + g)``, which is how ``jax.random.categorical`` samples;
    ``g`` comes from ``gen``, or from ``gumbel`` [A, B, Va] when given (the
    tests pass the reference's own noise). The sampled action token is fed
    back through the backbone's embedding table, as in the reference.
    Returns (action_tokens [B, A] int32, behaviour logp μ [B, A],
    value V(o_t) [B]).
    """
    a = cfg.action_dim
    prefix_len = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    cache_len = prefix_len + obs_tokens.shape[1] + a
    out, cache = transformer.prefill(cfg, params, obs_tokens, prefix_embeds,
                                     cache_len=cache_len)
    logits = out["logits"][:, -1]                        # [B, Va]
    tokens, logps, hiddens = [], [], []
    for i in range(a):
        if temperature != 1.0:
            logits = logits / temperature
        g = (gumbel[i] if gumbel is not None
             else gumbel_noise(gen, logits.shape, logits.device))
        tok = torch.argmax(logits + g, dim=-1)           # [B]
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, tok[:, None])[:, 0]
        dec, cache = transformer.decode(cfg, params, tok, cache)
        tokens.append(tok)
        logps.append(logp)
        hiddens.append(dec["hidden"][:, 0])              # [B, d]
        logits = dec["logits"][:, -1]
    act_hidden = torch.stack(hiddens, dim=1)             # [B, A, d]
    value = value_head(params["value_head"], act_hidden, step_t)
    return (torch.stack(tokens, dim=1).to(torch.int32),
            torch.stack(logps, dim=1), value)


def make_inference_fn(cfg: ModelConfig, temperature: float = 1.0, *,
                      device="cuda"):
    """Batched inference entry point for the service pool: numpy inputs in,
    tensors on ``device`` through ``sample_action_sequence`` under
    ``torch.inference_mode()``, numpy results out."""
    dev = resolve_device(device)

    def fn(params, gen, obs_tokens: np.ndarray, step_t: np.ndarray,
           prefix_embeds: Optional[np.ndarray] = None):
        with torch.inference_mode():
            obs = torch.as_tensor(obs_tokens, dtype=torch.long, device=dev)
            steps = torch.as_tensor(step_t, device=dev)
            prefix = (None if prefix_embeds is None else
                      torch.as_tensor(prefix_embeds, device=dev))
            toks, logps, values = sample_action_sequence(
                cfg, params, gen, obs, steps, prefix, temperature)
            return toks.cpu().numpy(), logps.cpu().numpy(), \
                values.cpu().numpy()
    return fn
