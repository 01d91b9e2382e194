"""granite-moe-1b-a400m — MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
