"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP
[hf:microsoft/Phi-3-vision-128k-instruct].

The CLIP vision tower is a STUB per the assignment carve-out:
``input_specs()`` provides pre-computed patch embeddings of shape
``(B, num_image_tokens, d_model)``; this config describes the language
backbone that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,                # GQA kv=32 (full MHA)
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    num_image_tokens=576,           # 24x24 CLIP patch grid
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3v-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=8, head_dim=16, d_ff=256, vocab_size=256,
        num_image_tokens=16)
