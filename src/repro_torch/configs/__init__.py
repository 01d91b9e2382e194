"""Architecture registry: ``get_config("<arch-id>")`` and ``reduced()``.

The ten assigned architectures plus the paper's own backbone
(``openvla-7b``). ``reduced()`` produces the smoke-test variant of the same
family (≤2 layers, d_model ≤ 512, ≤4 experts) per the deliverable spec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    INPUT_SHAPES,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    RLConfig,
    RuntimeConfig,
    ShapeConfig,
    SSMConfig,
    WMConfig,
    get_shape,
)

from repro_torch.configs.granite_20b import CONFIG as _granite_20b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.openvla_7b import CONFIG as _openvla

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _granite_20b,
        _granite_moe,
        _starcoder2,
        _internlm2,
        _zamba2,
        _dbrx,
        _deepseek,
        _musicgen,
        _llava,
        _mamba2,
        _openvla,
    )
}

ASSIGNED_ARCHS: List[str] = [
    "granite-20b",
    "granite-moe-1b-a400m",
    "starcoder2-15b",
    "internlm2-1.8b",
    "zamba2-1.2b",
    "dbrx-132b",
    "deepseek-7b",
    "musicgen-medium",
    "llava-next-mistral-7b",
    "mamba2-2.7b",
]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {list_archs()}") from None


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    heads = 4 if cfg.num_heads else 0
    kv = 0
    if cfg.num_kv_heads:
        # preserve the GQA ratio shape: MQA stays MQA, MHA stays MHA.
        kv = 1 if cfg.num_kv_heads == 1 else (heads if cfg.num_kv_heads == cfg.num_heads else 2)
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=0 if cfg.arch_type == "ssm" else 4 * d_model,
        vocab_size=min(cfg.vocab_size, vocab),
        action_vocab_size=min(cfg.action_vocab_size, 64),
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        max_episode_steps=64,
        param_dtype="float32",
        compute_dtype="float32",
        head_dim_override=d_model // heads if heads else None,
    )
    if cfg.moe is not None:
        # capacity_factor = E/k guarantees zero token drops, making the
        # grouped dispatch exactly equal to per-token top-k routing — so the
        # smoke tests can assert prefill/decode vs forward consistency.
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff=d_model,
            capacity_factor=2.0)
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, chunk=32)
    if cfg.hybrid is not None:
        updates["hybrid"] = dataclasses.replace(
            cfg.hybrid, shared_every=1, shared_d_ff=2 * d_model)
    return dataclasses.replace(cfg, **updates)
