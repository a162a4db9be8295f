"""Hand-written CUDA kernels for the framework's compute hot spots, with
plain PyTorch oracles in ref.py and the dispatching wrappers in ops.py
(a CUDA tensor launches the kernel, a CPU tensor takes the plain path).

  pairwise_l2     — K-means assignment / weight-divergence distance matrix
  flat_aggregate  — eq.-(4) aggregation over the [N, P] client plane
  flash_attention — online-softmax attention (causal / SWA / GQA)
  ssd_scan        — Mamba2 SSD chunked scan
  stamp           — a device timestamp for the phase spans
                    (``repro_torch.utils.spans``)

The kernel functions shadow their modules' names as package attributes,
as in the reference; reach a module as ``from
repro_torch.kernels.<module> import ...``.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pairwise_l2 import pairwise_l2
from repro_torch.kernels.flat_aggregate import flat_aggregate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
