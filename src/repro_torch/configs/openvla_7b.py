"""openvla-7b — the paper's own policy backbone: OpenVLA-OFT on Llama-2-7B
with the lm_head slimmed to 256 action bins (paper App. D.1, Table 3).
[arXiv:2502.19645]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="openvla-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    action_vocab_size=256,
    num_prefix_tokens=256,           # SigLIP/DINO patch embeds (stub frontend)
    source="arXiv:2502.19645 (OpenVLA-OFT on Llama-2-7B)",
)
