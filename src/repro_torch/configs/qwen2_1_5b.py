"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,                 # GQA kv=2
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-1.5b-smoke", num_layers=2, d_model=96, num_heads=6,
        num_kv_heads=2, head_dim=16, d_ff=280, vocab_size=256)
