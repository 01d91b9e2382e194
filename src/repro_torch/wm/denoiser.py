"""M_obs — the observation model: an EDM-preconditioned diffusion
next-frame predictor (DIAMOND-style, arXiv:2405.12399), as in the reference
``repro/wm/denoiser.py``.

The pixel interface is kept, but the denoiser consumes the frame vector
directly (the conv codec is the stubbed modality frontend). Conditioning =
the last ``history_frames`` frames + the current action-token chunk.

Parameters are a dict of f32 tensors; every function is plain PyTorch (the
products are small MLP products, not one of the repo's kernels). Noise comes
from a ``torch.Generator`` on the parameters' device, or from explicit
standard-normal draws (``z_sigma`` / ``z_noise`` / ``x0``), which the tests
use to pass the reference's own noise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import WMConfig
from repro_torch.models.layers import Params, dense_init
from repro_torch.optim import adamw

SIGMA_MIN = 2e-3
SIGMA_MAX = 80.0
RHO = 7.0
P_MEAN = -1.2
P_STD = 1.2


# ---------------------------------------------------------------------------
# Network: MLP denoiser F(c_in·x, cond, c_noise)
# ---------------------------------------------------------------------------

def denoiser_init(gen: torch.Generator, frame_dim: int, action_dim: int,
                  action_vocab: int, cfg: WMConfig) -> Params:
    """Random denoiser parameters, drawn from ``gen`` on its device."""
    dev, f32 = gen.device, torch.float32
    d = cfg.denoiser_d_model
    cond_dim = cfg.history_frames * frame_dim + action_dim * 8 + 1
    return {
        "act_emb": dense_init(gen, (action_vocab, 8), f32, dev, scale=1.0),
        "w_in": dense_init(gen, (frame_dim + cond_dim, d), f32, dev),
        "b_in": torch.zeros((d,), dtype=f32, device=dev),
        "w_h": dense_init(gen, (d, d), f32, dev),
        "b_h": torch.zeros((d,), dtype=f32, device=dev),
        "w_h2": dense_init(gen, (d, d), f32, dev),
        "b_h2": torch.zeros((d,), dtype=f32, device=dev),
        "w_out": dense_init(gen, (d, frame_dim), f32, dev),
        "b_out": torch.zeros((frame_dim,), dtype=f32, device=dev),
    }


def _network(params: Params, x_in: torch.Tensor, history: torch.Tensor,
             actions: torch.Tensor, c_noise: torch.Tensor) -> torch.Tensor:
    """x_in: [B, F] (pre-scaled); history: [B, H, F]; actions: [B, A] int;
    c_noise: [B]."""
    b = x_in.shape[0]
    a_emb = params["act_emb"][actions.long()].reshape(b, -1)
    h = torch.cat([x_in, history.reshape(b, -1), a_emb, c_noise[:, None]],
                  dim=-1)
    h = F.silu(h @ params["w_in"] + params["b_in"])
    h = h + F.silu(h @ params["w_h"] + params["b_h"])
    h = h + F.silu(h @ params["w_h2"] + params["b_h2"])
    return h @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# EDM preconditioning
# ---------------------------------------------------------------------------

def denoiser_apply(params: Params, x_noisy: torch.Tensor, sigma: torch.Tensor,
                   history: torch.Tensor, actions: torch.Tensor,
                   sigma_data: float) -> torch.Tensor:
    """D_θ(x; σ) = c_skip·x + c_out·F(c_in·x, cond, c_noise)."""
    sd2 = sigma_data ** 2
    s2 = sigma.square()
    c_skip = sd2 / (s2 + sd2)
    c_out = sigma * sigma_data / torch.sqrt(s2 + sd2)
    c_in = 1.0 / torch.sqrt(s2 + sd2)
    c_noise = torch.log(sigma) / 4.0
    f = _network(params, c_in[:, None] * x_noisy, history, actions, c_noise)
    return c_skip[:, None] * x_noisy + c_out[:, None] * f


def denoiser_loss(params: Params, gen: Optional[torch.Generator],
                  frames_next: torch.Tensor, history: torch.Tensor,
                  actions: torch.Tensor, cfg: WMConfig, *,
                  z_sigma: Optional[torch.Tensor] = None,
                  z_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EDM training objective with λ(σ) weighting. ``z_sigma`` [B] and
    ``z_noise`` [B, F] are standard normals (drawn from ``gen`` when not
    given): log σ = P_MEAN + P_STD·z_sigma, noise = z_noise·σ."""
    b = frames_next.shape[0]
    dev = frames_next.device
    if z_sigma is None:
        z_sigma = torch.randn((b,), generator=gen, device=dev)
    if z_noise is None:
        z_noise = torch.randn(frames_next.shape, generator=gen, device=dev)
    sigma = torch.exp(P_MEAN + P_STD * z_sigma)
    noise = z_noise * sigma[:, None]
    d = denoiser_apply(params, frames_next + noise, sigma, history, actions,
                       cfg.sigma_data)
    sd2 = cfg.sigma_data ** 2
    lam = (sigma.square() + sd2) / (sigma * cfg.sigma_data).square()
    return torch.mean(lam * torch.mean((d - frames_next).square(), dim=-1))


# ---------------------------------------------------------------------------
# Sampling (Euler over the Karras σ-schedule)
# ---------------------------------------------------------------------------

def karras_schedule(n: int, device=None) -> torch.Tensor:
    """``n`` Karras σ's from SIGMA_MAX down to SIGMA_MIN, then 0 (f32)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    s = (SIGMA_MAX ** (1 / RHO)
         + i / max(n - 1, 1) * (SIGMA_MIN ** (1 / RHO)
                                - SIGMA_MAX ** (1 / RHO))) ** RHO
    return torch.cat([s, torch.zeros((1,), device=device)])


def sample_next_frame(params: Params, gen: Optional[torch.Generator],
                      history: torch.Tensor, actions: torch.Tensor,
                      cfg: WMConfig, *,
                      x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generate ô_{t+1} given history and the action chunk. ``x0`` [B, F]
    is the standard-normal start (drawn from ``gen`` when not given),
    scaled by σ_0."""
    b, _, f = history.shape
    dev = history.device
    sigmas = karras_schedule(cfg.diffusion_steps, dev)
    if x0 is None:
        x0 = torch.randn((b, f), generator=gen, device=dev)
    x = x0 * sigmas[0]
    for i in range(cfg.diffusion_steps):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        denoised = denoiser_apply(params, x, s_cur.expand(b), history,
                                  actions, cfg.sigma_data)
        d = (x - denoised) / s_cur
        x = x + (s_next - s_cur) * d
    return x


def make_denoiser_train_step(cfg: WMConfig, lr: float = 1e-4):
    """One AdamW step (no weight decay) on the denoiser loss, by autograd
    over the plain function (``adamw.grad_step``). ``params`` and ``opt``
    are updated in place and returned with the loss."""
    def step(params, opt, gen, frames_next, history, actions, *,
             z_sigma=None, z_noise=None):
        return adamw.grad_step(
            lambda p: denoiser_loss(p, gen, frames_next, history, actions,
                                    cfg, z_sigma=z_sigma, z_noise=z_noise),
            params, opt, lr)
    return step


def make_sampler(cfg: WMConfig):
    return lambda params, gen, history, actions: sample_next_frame(
        params, gen, history, actions, cfg)
