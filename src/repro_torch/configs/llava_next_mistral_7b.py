"""llava-next-mistral-7b — VLM backbone (anyres tiling vision frontend is the
stub; decoder consumes projected patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_prefix_tokens=576,           # one 24x24 anyres tile of patch embeds
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
