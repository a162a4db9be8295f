"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,                 # GQA kv=8
    d_ff=512,                       # per-expert hidden
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-smoke", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=64))
