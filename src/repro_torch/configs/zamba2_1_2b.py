"""zamba2-1.2b — hybrid Mamba2 trunk + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=128),
    hybrid=HybridConfig(shared_every=6, shared_d_ff=8192),
    source="arXiv:2411.15242",
)
