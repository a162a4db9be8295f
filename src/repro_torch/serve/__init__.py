"""Batched generation on the card: ``ServeEngine`` (prefill + decode over
the cache of ``repro_torch.models.transformer.init_cache``) and the token
samplers (``sampler``)."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve import sampler

__all__ = ["ServeEngine", "sampler"]
