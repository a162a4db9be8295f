"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,                 # GQA kv=8
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,            # SWA native to the mixtral family
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=16384),
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256,
        sliding_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=256))
