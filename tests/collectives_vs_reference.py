"""The dry run's collective bytes against the reference's, on small
combinations that compile on the CPU: an architecture's smoke config,
a train, prefill or decode step at batch 8 and 64 tokens, on a 2×4
``("data", "model")`` mesh.

The reference compiles each step's roofline twin (every layer unrolled,
attention unblocked) with XLA's SPMD partitioner over 8 host devices in a
subprocess, and parses the per-device HLO (``collective_bytes``); the port
runs the same step partitioned by DTensor over a fake process group of 8
ranks (``repro_torch.sharding.partition``). Both count a collective's
result bytes on one device.

    PYTHONPATH=src python tests/collectives_vs_reference.py        # all
    PYTHONPATH=src python tests/collectives_vs_reference.py \\
        --arch tinyllama-1.1b --kind train

prints one line a combination: both totals, the factor port ÷ reference,
and each side's counts by kind. ``tests/test_torch_dryrun_collectives.py``
holds two combinations to the factor ``PERF.md`` states.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESH = ((2, 4), ("data", "model"))
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 8, 64

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as rd
from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.roofline.analysis import collective_bytes

sizes, axes = {sizes!r}, {axes!r}
mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes),
            axes)
out = {{}}
for arch, kind in {cases!r}:
    shape = InputShape(f"{{kind}}_small", {seq}, {batch}, kind)
    lowered, _ = rd._lower(get_smoke_config(arch), shape, mesh,
                           moe_impl="dense", q_chunk={seq}, kv_chunk={seq},
                           remat=kind == "train", unroll=0)
    out[arch + " " + kind] = collective_bytes(lowered.compile().as_text())
print("JSON" + json.dumps(out))
"""


def reference_counts(cases):
    """``{"arch kind": the reference's collective_bytes}`` for ``cases``
    (pairs of arch and step kind), compiled in one subprocess."""
    code = _REFERENCE.format(sizes=MESH[0], axes=MESH[1], cases=list(cases),
                             seq=SEQ, batch=BATCH)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    line = [x for x in proc.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def port_run(arch, kind):
    """The port's ``PartitionedRun`` of the same step on the same mesh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_logical_mesh
    shape = InputShape(f"{kind}_small", SEQ, BATCH, kind)
    lowered, _ = dryrun._lower(get_smoke_config(arch), shape,
                               make_logical_mesh(*MESH), moe_impl="dense",
                               q_chunk=SEQ, kv_chunk=SEQ,
                               remat=kind == "train", unroll=1)
    return lowered.partitioned()


def main(argv=None):
    from repro_torch.configs import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--kind", choices=KINDS, default=None)
    args = ap.parse_args(argv)
    cases = [(a, k) for a in ([args.arch] if args.arch else ARCH_IDS)
             for k in ([args.kind] if args.kind else KINDS)]
    ref = reference_counts(cases)
    for arch, kind in cases:
        run = port_run(arch, kind)
        want = ref[f"{arch} {kind}"]
        got = run.collectives
        if got is None:
            print(f"{arch} {kind}: port null ({run.reason}); reference "
                  f"{want['total']} B")
            continue
        factor = got["total"] / want["total"] if want["total"] else None
        print(f"{arch} {kind}: port {got['total']} B, reference "
              f"{want['total']} B, factor "
              f"{'n/a' if factor is None else f'{factor:.3f}'}; port "
              f"{got['counts']}, reference {want['counts']}; refusals "
              f"{run.refusals}", flush=True)


if __name__ == "__main__":
    main()
