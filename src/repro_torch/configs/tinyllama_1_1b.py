"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,                 # GQA kv=4
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    source="arXiv:2401.02385",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="tinyllama-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=352, vocab_size=256)
