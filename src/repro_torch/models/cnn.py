"""The paper's local model (Fig. 3): conv5x5 -> pool -> conv5x5 -> pool ->
fc1 -> fc2, with per-layer named parameters ``w_c1 … b_fc2``.

Layouts follow the reference at every public function: HWIO conv weights,
NHWC images, ``[din, dout]`` linear weights. Every function takes a leading
client axis ``S`` on both the parameters (``[S, ...]``) and the images
(``[S, B, H, W, C]``), which is how the port trains all selected clients at
once where the reference ``vmap``s; :func:`cnn_forward` / :func:`cnn_loss`
are the single-model forms.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.paper_cnn import CNNConfig


def cnn_param_shapes(cfg: CNNConfig) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of one model: HWIO conv weights, ``[din, dout]``
    linear weights."""
    k5 = cfg.kernel
    cin, c1, c2 = cfg.input_channels, cfg.conv1_out, cfg.conv2_out
    return {
        "w_c1": (k5, k5, cin, c1), "b_c1": (c1,),
        "w_c2": (k5, k5, c1, c2), "b_c2": (c2,),
        "w_fc1": (cfg.flat_features, cfg.fc1_out), "b_fc1": (cfg.fc1_out,),
        "w_fc2": (cfg.fc1_out, cfg.num_classes), "b_fc2": (cfg.num_classes,),
    }


def init_cnn(cfg: CNNConfig, generator: torch.Generator,
             device="cpu") -> Dict[str, torch.Tensor]:
    """Same shapes and scales as the reference's ``init_cnn`` (normal
    weights scaled by 1/sqrt(fan_in), zero biases), drawn from
    ``generator`` in the reference's leaf order — the numbers differ from
    ``jax.random``'s."""
    out = {}
    for name, shape in cnn_param_shapes(cfg).items():
        if name.startswith("b_"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            scale = 1.0 / math.sqrt(math.prod(shape[:-1]))   # 1/sqrt(fan_in)
            out[name] = torch.randn(shape, generator=generator, device=device,
                                    dtype=torch.float32) * scale
    return out


def _conv(x, w, b):
    """VALID convolution as im2col + one (batched) GEMM, like the reference.

    x: [S, B, H, W, cin]; w: [S, kh, kw, cin, cout]; b: [S, cout].
    Patch columns go in (di, dj, cin) order, so ``w.reshape(kh*kw*cin,
    cout)`` lines up with them.
    """
    s, bsz = x.shape[:2]
    kh, kw, cin, cout = w.shape[1:]
    H = x.shape[2] - kh + 1
    W = x.shape[3] - kw + 1
    cols = torch.cat([x[:, :, di:di + H, dj:dj + W, :]
                      for di in range(kh) for dj in range(kw)], dim=-1)
    out = torch.bmm(cols.reshape(s, bsz * H * W, kh * kw * cin),
                    w.reshape(s, kh * kw * cin, cout))
    return (out + b[:, None, :]).reshape(s, bsz, H, W, cout)


def _maxpool(x, p: int):
    """VALID p×p max pool with stride p over NHWC (trailing rows/cols that
    do not fill a window are dropped)."""
    s, bsz, h, w, c = x.shape
    h2, w2 = h // p, w // p
    x = x[:, :, :h2 * p, :w2 * p, :].reshape(s, bsz, h2, p, w2, p, c)
    return x.amax(dim=(3, 5))


def cnn_forward_stacked(params, images, cfg: CNNConfig):
    """images: [S, B, H, W, C] -> logits [S, B, num_classes]."""
    s, bsz = images.shape[:2]
    x = torch.relu(_conv(images, params["w_c1"], params["b_c1"]))
    x = _maxpool(x, cfg.pool)
    x = torch.relu(_conv(x, params["w_c2"], params["b_c2"]))
    x = _maxpool(x, cfg.pool)
    x = x.reshape(s, bsz, -1)
    x = torch.relu(torch.bmm(x, params["w_fc1"]) + params["b_fc1"][:, None])
    return torch.bmm(x, params["w_fc2"]) + params["b_fc2"][:, None]


def cnn_loss_stacked(params, images, labels, cfg: CNNConfig):
    """Per-client mean cross-entropy [S] (the paper's loss, §III-C);
    ``log_softmax`` in fp32."""
    logits = cnn_forward_stacked(params, images, cfg)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.mean(dim=1)


def _one(params):
    return {k: v[None] for k, v in params.items()}


def cnn_forward(params, images, cfg: CNNConfig):
    """Single model. images: [B, H, W, C] -> logits [B, num_classes]."""
    return cnn_forward_stacked(_one(params), images[None], cfg)[0]


def cnn_loss(params, images, labels, cfg: CNNConfig):
    """Single-model mean cross-entropy (scalar)."""
    return cnn_loss_stacked(_one(params), images[None], labels[None], cfg)[0]


def cnn_accuracy(params, images, labels, cfg: CNNConfig):
    """Single-model accuracy (a 0-d tensor)."""
    pred = torch.argmax(cnn_forward(params, images, cfg), dim=-1)
    return (pred == labels).to(torch.float32).mean()
