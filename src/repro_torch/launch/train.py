"""Single-host LM training driver: train a --arch (its published config,
or with --smoke its reduced same-family variant) on the synthetic token
stream, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --smoke --steps 200 --batch 8 --seq 128

``--device`` (default ``cuda``) names the device; ``cuda`` with no card
raises, ``--device cpu`` runs the plain PyTorch paths.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.build import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models.transformer import init_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_step import make_train_step


def batches_from_stream(tokens: np.ndarray, batch: int, seq: int, seed: int,
                        device="cpu"):
    """Endless ``{"tokens": [batch, seq]}`` windows at uniform offsets of
    ``tokens`` (a numpy Generator seeded ``seed``, as the reference)."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        idx = rng.integers(0, n, batch)
        yield {"tokens": torch.as_tensor(
            np.stack([tokens[i:i + seq] for i in idx])).to(device)}


def make_vlm_audio_extras(cfg, batch: int, seq: int, device="cpu"):
    """The stubbed frontends' inputs, as the reference gives them: zero
    image-patch embeddings ``[batch, num_image_tokens, d]`` for a VLM,
    zero frame embeddings ``[batch, seq, d]`` for an encoder-decoder."""
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), device=device)
    if cfg.is_encoder_decoder:
        extras["src_embeds"] = torch.zeros((batch, seq, cfg.d_model),
                                           device=device)
    return extras


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moe-impl", default="dense",
                    help="the MoE layers' implementation (an MoE or hybrid "
                         "family): dense, dispatch or dense_fused")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-csv", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: 'cuda' (the card; raises when "
                         "there is none) or 'cpu' (the plain PyTorch paths)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_model(cfg, gen, device)
    opt_init, step_fn = make_train_step(cfg, tc, moe_impl=args.moe_impl,
                                        q_chunk=64, kv_chunk=64)
    opt_state = opt_init(params)

    stream = make_token_stream(cfg.vocab_size, 200_000, seed=args.seed)
    batches = batches_from_stream(stream, args.batch, args.seq, args.seed,
                                  device)
    extras = make_vlm_audio_extras(cfg, args.batch, args.seq, device)

    logger = MetricsLogger(args.log_csv)
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             {**next(batches), **extras})
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            logger.log(step, metrics)
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
    logger.flush()
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("checkpoint saved to", args.ckpt)
    return logger


if __name__ == "__main__":
    main()
