"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec conv codec is the stubbed modality frontend; the decoder consumes
precomputed frame embeddings (``num_prefix_tokens``) plus audio-token ids,
and its natural "action vocabulary" is the 2048-entry codec codebook.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    action_vocab_size=2048,          # codec codebook == output head
    num_prefix_tokens=64,            # conditioning frames from the stub codec
    source="arXiv:2306.05284",
)
