"""The dry run (the port of ``repro.launch.dryrun``): every (architecture ×
input shape) laid out on the production meshes with no allocation
(``meta`` structs), counted, and its roofline terms against the H100.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.jsonl

Each record has the reference's keys. FLOPs and bytes per device are the
whole step's counts over the chips, a perfect split. The collectives
(``collective_bytes_per_device``, ``collectives``, ``collective_s``) and
``peak_memory_per_device`` come from one more run of the step on the
record's mesh, partitioned by DTensor over a fake process group of 256 or
512 ranks in this process (``repro_torch.sharding.partition``): each
collective's result bytes on one device, the reference's convention, and
the high-water mark of live bytes a device holds, temporaries included,
with the kernels' own allocations where a kernel replaces its plain
version on the card (``roofline.analysis.PeakMemory``). Where DTensor
refused an op's layout and the op ran replicated, ``partition_refusals``
counts it; where the partitioned run failed, the collectives are ``null``
and ``collectives_reason`` says why. ``peak_memory_lower_bound`` is the
per-device bytes of the step's arguments and results under the partition
rules alone (``Lowered.memory_per_device``). The port has no compiled
program a mesh, so ``compile_s`` is ``null``; ``partition_s`` is the
partitioned run's seconds.

The reference counts its roofline on a twin of the step: every layer
unrolled (XLA counts a scan body once) and attention unblocked
(``q_chunk = kv_chunk`` = the sequence for train and prefill). The port
runs every layer eagerly, so it needs no unrolled twin and no
extrapolation (``twin_layers`` and ``twin_compile_s`` are ``null``); it
keeps the unblocked attention (only the encoder-decoder's cross-attention
is blocked), which counts the same FLOPs and runs one block where
seamless's 32k prefill runs 2048 a layer. ``--no-twin`` counts at the
flags' chunks instead, as the reference's production compile does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_input_shape
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import decode_step
from repro_torch.roofline.analysis import Lowered, analyze_compiled
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.train.train_step import make_loss_fn, make_train_step


def _pad_vocab(cfg, multiple: int):
    """Pad the PHYSICAL vocab so the embedding/logits dims divide the mesh
    model axis (the reference's lever against replicated [B,S,V] logits
    for non-divisible vocabs like seamless 256206 / granite 49155). The
    logical vocab (token-id range) is unchanged."""
    if multiple <= 0 or cfg.vocab_size % multiple == 0:
        return cfg
    padded = ((cfg.vocab_size + multiple - 1) // multiple) * multiple
    return cfg.replace(vocab_size=padded)


def _act_specs(mesh, cfg, batch):
    ba = sh.batch_axes(mesh, batch)
    specs = {"act": sh.P(ba if ba else None, None, None)}
    m = mesh.shape.get("model", 1)
    if cfg.vocab_size % m == 0:
        specs["logits"] = sh.P(ba if ba else None, None, "model")
    return specs


def _replicated(mesh):
    return sh.NamedSharding(mesh, sh.P())


def _named(mesh, specs):
    return {k: sh.NamedSharding(mesh, s) for k, s in specs.items()}


def lower_train(cfg, shape, mesh, *, moe_impl: str, q_chunk: int,
                kv_chunk: int, remat: bool, unroll: int = 1,
                donate: bool = True, moment_dtype: str = "float32"):
    """The train step (bf16 parameters, AdamW) on structs. ``unroll`` is
    the reference's scan unroll: the port runs its layers in a loop, so it
    changes nothing."""
    tc = TrainConfig(param_dtype="bfloat16", remat=remat,
                     moment_dtype=moment_dtype)
    opt_init, train_step = make_train_step(cfg, tc, moe_impl=moe_impl,
                                           q_chunk=q_chunk, kv_chunk=kv_chunk)
    p_struct = shp.param_structs(cfg, torch.bfloat16)
    p_shard = sh.params_shardings(p_struct, mesh)
    o_struct = opt_init(p_struct)
    o_shard = sh.opt_state_shardings(o_struct, p_shard, mesh)
    b_struct, b_spec = shp.batch_structs(cfg, shape, mesh)
    metrics_shard = {k: _replicated(mesh) for k in
                     ("loss", "ce", "aux", "lr", "gnorm")}
    return Lowered(train_step, (p_struct, o_struct, b_struct),
                   (p_shard, o_shard, _named(mesh, b_spec)),
                   (p_shard, o_shard, metrics_shard), mesh=mesh,
                   donate=(0, 1) if donate else ())


def lower_prefill(cfg, shape, mesh, *, moe_impl: str, q_chunk: int,
                  kv_chunk: int, unroll: int = 1):
    """Inference prefill: forward logits only (no cache materialization —
    the decode shapes exercise the cache path)."""
    tc = TrainConfig(param_dtype="bfloat16")
    loss_fn = make_loss_fn(cfg, tc, moe_impl=moe_impl, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)

    def prefill_step(params, batch):
        with torch.no_grad():
            loss, parts = loss_fn(params, batch)  # forward-only scoring pass
        return parts["ce"]

    p_struct = shp.param_structs(cfg, torch.bfloat16)
    p_shard = sh.params_shardings(p_struct, mesh)
    b_struct, b_spec = shp.batch_structs(cfg, shape, mesh)
    return Lowered(prefill_step, (p_struct, b_struct),
                   (p_shard, _named(mesh, b_spec)), _replicated(mesh),
                   mesh=mesh)


def lower_decode(cfg, shape, mesh, *, moe_impl: str, unroll: int = 1):
    """One decode step over the shape's cache (``long_500k``'s SWA window
    on the full-attention families); the cache is donated."""
    p_struct = shp.param_structs(cfg, torch.bfloat16)
    p_shard = sh.params_shardings(p_struct, mesh)
    c_struct, c_spec = shp.cache_structs(cfg, shape, mesh)
    b_struct, b_spec = shp.batch_structs(cfg, shape, mesh)
    c_shard = _named(mesh, c_spec)
    logits_shard = sh.NamedSharding(
        mesh, sh.token_spec(mesh, shape.global_batch, extra_dims=2))

    def step(p, b, c):
        with torch.no_grad():
            return decode_step(cfg, p, b, c, moe_impl=moe_impl)

    return Lowered(step, (p_struct, b_struct, c_struct),
                   (p_shard, _named(mesh, b_spec), c_shard),
                   (logits_shard, c_shard), mesh=mesh, donate=(2,))


def _lower(cfg, shape, mesh, *, moe_impl, q_chunk, kv_chunk, remat, unroll,
           act_constraints=False, moment_dtype="float32", count=None):
    """``(lowered, include_backward)``, the step counted (under the
    activation specs when ``act_constraints``) unless ``count`` is its
    count already."""
    ctx = (activation_sharding(_act_specs(mesh, cfg, shape.global_batch))
           if act_constraints else contextlib.nullcontext())
    with ctx:
        if shape.kind == "train":
            lowered = lower_train(cfg, shape, mesh, moe_impl=moe_impl,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  remat=remat, unroll=unroll,
                                  moment_dtype=moment_dtype)
        elif shape.kind == "prefill":
            lowered = lower_prefill(cfg, shape, mesh, moe_impl=moe_impl,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk,
                                    unroll=unroll)
        else:
            lowered = lower_decode(cfg, shape, mesh, moe_impl=moe_impl,
                                   unroll=unroll)
        lowered.step_count = count
        lowered.count()
    return lowered, shape.kind == "train"


@functools.lru_cache(maxsize=64)
def _count(cfg, shape, **opts):
    """A step's count, the same on every mesh: counted once a process for
    the meshes ``--mesh both`` runs it on."""
    return _lower(cfg, shape, make_production_mesh(), **opts)[0].count()


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            moe_impl: str = "dense", q_chunk: int = 512, kv_chunk: int = 1024,
            remat: bool = None, verbose: bool = True, twin: bool = True,
            pad_vocab: int = 0, act_constraints: bool = False,
            moment_dtype: str = "float32", ssd_chunk: int = 0,
            partition: bool = True):
    """One (arch × shape × mesh): the step on structs, counted (once a
    process for every mesh: the count is the whole step's), run
    partitioned on the mesh (unless ``partition`` is false: collectives
    and peak ``null``, with the reason), and its record. ``twin``: count
    and run at the reference's roofline-twin chunks (the module
    docstring)."""
    cfg = get_config(arch)
    if pad_vocab:
        cfg = _pad_vocab(cfg, pad_vocab)
    if ssd_chunk and cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                  chunk_size=ssd_chunk))
    shape = get_input_shape(shape_name)
    if remat is None:
        remat = shape.kind == "train"
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    chips = mesh.size
    if twin and shape.kind != "decode":
        q_chunk = kv_chunk = shape.seq_len

    t0 = time.time()
    opts = dict(moe_impl=moe_impl, q_chunk=q_chunk, kv_chunk=kv_chunk,
                remat=remat, unroll=1, act_constraints=act_constraints,
                moment_dtype=moment_dtype)
    lowered, include_backward = _lower(
        cfg, shape, mesh, count=_count(cfg, shape, **opts), **opts)
    t_lower = time.time() - t0
    report = analyze_compiled(lowered, arch=arch, shape=shape,
                              mesh_name=mesh_kind, chips=chips, cfg=cfg,
                              include_backward=include_backward,
                              partition=partition)
    run = lowered.partitioned(partition)
    d = report.to_dict()
    d["lower_s"] = round(t_lower, 1)
    d["compile_s"] = None
    d["moe_impl"] = moe_impl
    d["remat"] = remat
    d["pad_vocab"] = pad_vocab
    d["act_constraints"] = act_constraints
    d["moment_dtype"] = moment_dtype
    d["twin_compile_s"] = None
    d["twin_layers"] = None
    d["peak_memory_lower_bound"] = lowered.memory_per_device()
    d["collectives_reason"] = run.reason
    d["partition_refusals"] = run.refusals
    d["partition_s"] = round(run.seconds, 1)
    d["partition_mesh"] = run.mesh
    d["partition_torch"] = torch.__version__
    if verbose:
        print(json.dumps({k: v for k, v in d.items() if k != "collectives"},
                         indent=1, default=str))
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape)")
    ap.add_argument("--moe-impl", choices=["dense", "dispatch"],
                    default="dense")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--remat", action="store_true", default=None)
    ap.add_argument("--no-twin", action="store_true")
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="pad physical vocab to this multiple (e.g. 128)")
    ap.add_argument("--act-constraints", action="store_true")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} × {shape} × {mesh_kind}"
                print(f"=== dry-run {tag} ===", flush=True)
                try:
                    d = run_one(arch, shape, mesh_kind,
                                moe_impl=args.moe_impl, q_chunk=args.q_chunk,
                                kv_chunk=args.kv_chunk, remat=args.remat,
                                twin=not args.no_twin,
                                pad_vocab=args.pad_vocab,
                                act_constraints=args.act_constraints,
                                moment_dtype=args.moment_dtype,
                                ssd_chunk=args.ssd_chunk)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(d, default=str) + "\n")
                except Exception as e:
                    traceback.print_exc()
                    failures.append((tag, str(e)))
    if failures:
        print(f"FAILED {len(failures)}:")
        for tag, err in failures:
            print(" ", tag, "->", err[:200])
        sys.exit(1)
    print("all dry-runs OK")


if __name__ == "__main__":
    main()
