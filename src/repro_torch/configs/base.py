"""Run and model configs (copies of ``repro.configs.base``: ``FLConfig``,
``TrainConfig`` and the transformer's ``MoEConfig`` / ``SSMConfig`` /
``ModelConfig``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run parameters (paper §III, §VI)."""
    num_devices: int = 100          # N
    devices_per_round: int = 10     # S
    local_iters: int = 5            # L
    num_clusters: int = 10          # c
    selected_per_cluster: int = 1   # s
    learning_rate: float = 0.05     # paper §VI
    sigma: float = 0.8              # non-iid bias; "H" handled by partitioner
    target_accuracy: float = 0.0    # 0 = run max_rounds
    max_rounds: int = 100
    selection: str = "divergence"   # divergence | kmeans_random | random | icas
    feature_layer: str = "auto"     # K-means feature; "auto" = last FC (w_fc2)


@dataclass(frozen=True)
class TrainConfig:
    """LM training run parameters (``repro_torch.train``)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"        # adamw | sgd | momentum
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    moment_dtype: str = "float32"      # bf16 halves optimizer-state memory
    remat: bool = False
    label_smoothing: float = 0.0


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD hyper-parameters (arXiv:2405.21060)."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attn-free (ssm)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False          # qwen2-style
    sliding_window: Optional[int] = None   # SWA window; None = full attention
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0            # hybrid: one attention layer per period
    moe_period: int = 0             # MoE MLP every `moe_period` layers
    is_encoder_decoder: bool = False
    cross_attention: bool = False
    num_image_tokens: int = 0
    continuous_encoder_input: bool = False
    max_seq_len: int = 1 << 20
    source: str = ""                # citation for the published config

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts ----------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff          # SwiGLU: gate, up, down

    def _moe_mlp_params(self, active_only: bool) -> int:
        m = self.moe
        n_e = m.top_k if active_only else m.num_experts
        return n_e * 3 * self.d_model * m.d_ff + self.d_model * m.num_experts

    def _ssm_params(self) -> int:
        s = self.ssm
        d_inner = s.expand * self.d_model
        n_heads = d_inner // s.head_dim
        in_proj = self.d_model * (2 * d_inner + 2 * s.n_groups * s.d_state
                                  + n_heads)
        conv = s.conv_width * (d_inner + 2 * s.n_groups * s.d_state)
        out_proj = d_inner * self.d_model
        extra = 3 * n_heads + d_inner                # A_log, D, dt_bias, norm
        return in_proj + conv + out_proj + extra

    def num_params(self, active_only: bool = False) -> int:
        """Analytic parameter count. ``active_only`` counts top-k experts
        only."""
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        per_layer_norms = 2 * self.d_model

        def block_params(layer_idx: int, decoder: bool) -> int:
            p = per_layer_norms
            is_attn = True
            if self.attn_period:
                is_attn = (layer_idx % self.attn_period) == (self.attn_period - 1)
            if self.family == "ssm" or (self.attn_period and not is_attn):
                p += self._ssm_params()
            else:
                p += self._attn_params()
            if decoder and self.cross_attention:
                p += self._attn_params() + self.d_model
            use_moe = self.moe is not None and (
                self.moe_period == 0
                or (layer_idx % self.moe_period) == (self.moe_period - 1))
            if self.moe is not None and use_moe:
                p += self._moe_mlp_params(active_only)
            elif self.d_ff:
                p += self._dense_mlp_params()
            return p

        total = emb + head + self.d_model            # final norm
        if self.is_encoder_decoder:
            for i in range(self.num_layers):
                total += block_params(i, decoder=False)
                total += block_params(i, decoder=True)
            total += self.d_model                    # encoder final norm
        else:
            for i in range(self.num_layers):
                total += block_params(i, decoder=False)
        return total
