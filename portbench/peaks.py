"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its full 700 W limit): the benchmark's own copy
of ``repro_torch.launch.mesh.H100_SXM``."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,          # float32 outside the tensor cores
    "tf32_flops": 495e12,         # TF32 tensor cores
    "bf16_flops": 989e12,         # bf16 tensor cores
    "hbm_bytes": 80e9,
}

#: the FLOP rate of a configuration's stated precision
FLOP_RATE = {"float32": H100_SXM["fp32_flops"],
             "tf32": H100_SXM["tf32_flops"],
             "bfloat16": H100_SXM["bf16_flops"]}


def least_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time [s] the chip could take for ``flops`` operations in
    ``precision`` and ``nbytes`` bytes of HBM traffic: the larger of the
    two bounds."""
    return max(flops / FLOP_RATE[precision],
               nbytes / H100_SXM["hbm_bytes_per_s"])
