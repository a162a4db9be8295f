"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,                 # GQA kv=8 (attention layers only)
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_period=8,                  # 1 attention layer per 8 (1:7 interleave)
    moe_period=2,                   # MoE MLP every 2nd layer (jamba e/2)
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke", num_layers=8, d_model=128, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256,
        attn_period=4, moe_period=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=256),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk_size=32))
