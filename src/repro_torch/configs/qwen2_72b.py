"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,                 # GQA kv=8
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-72b-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=448, vocab_size=256)
