"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,                    # attention-free
    num_kv_heads=0,
    d_ff=0,                         # mamba blocks have no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke", num_layers=2, d_model=128, vocab_size=256,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk_size=32))
