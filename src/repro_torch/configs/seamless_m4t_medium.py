"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

The mel-spectrogram + conv feature-extractor frontend is a STUB per the
assignment carve-out: ``input_specs()`` provides pre-computed frame
embeddings ``(B, T_frames, d_model)`` consumed by the text/unit
encoder-decoder backbone described here (12 layers per stack).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,                  # per stack (12 enc + 12 dec)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,                # GQA kv=16 (full MHA)
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    is_encoder_decoder=True,
    cross_attention=True,
    continuous_encoder_input=True,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=8, head_dim=16, d_ff=256, vocab_size=512)
