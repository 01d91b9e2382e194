"""The VLA policy's serving half: backbone + slimmed action head + value
head, as in the reference ``repro/models/policy.py``.

An env step consumes an observation embedding (stub frontend) plus the
instruction tokens and emits ``action_dim`` discrete action tokens, their
behaviour log-probs μ and the value V(o_t). Teacher-forced scoring (the
trainer's pass) belongs to the training slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = transformer.init_params(cfg, gen, device=dev)
    params["value_head"] = value_head_init(
        gen, cfg.d_model, cfg.max_episode_steps, dev)
    return params


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
    action tokens against the KV cache. Each token is drawn by Gumbel-max,
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
