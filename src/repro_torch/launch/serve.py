"""Serving driver: batched generation from a --arch (its published config,
or with --smoke its reduced variant; random weights from --seed), on the
card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --smoke --batch 4 --gen 32

``--device`` (default ``cuda``) names the device; ``cuda`` with no card
raises, ``--device cpu`` runs the plain PyTorch paths.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.build import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serve import ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sampler", default="greedy",
                    choices=["greedy", "temperature"])
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: 'cuda' (the card; raises when "
                         "there is none) or 'cpu' (the plain PyTorch paths)")
    return ap


def _generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_model(cfg, _generator(device, args.seed), device)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=_generator(device, args.seed + 1),
                            device=device)
    t0 = time.time()
    out = eng.generate(prompts, num_tokens=args.gen, sampler=args.sampler,
                       generator=_generator(device, args.seed + 2),
                       temp=args.temp)
    dt = time.time() - t0
    print(f"{args.arch}: {args.batch}×{args.gen} tokens in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    for i, row in enumerate(out):
        print(f"  [{i}] {row.tolist()}")
    return out


if __name__ == "__main__":
    main()
