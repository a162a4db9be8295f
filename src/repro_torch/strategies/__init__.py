"""Built-in strategy implementations. Importing this package registers
them in the ``repro_torch.api.registry`` registries."""
from repro_torch.strategies import aggregators as aggregators  # noqa: F401
from repro_torch.strategies import allocators as allocators    # noqa: F401
from repro_torch.strategies import compressors as compressors  # noqa: F401
from repro_torch.strategies import selectors as selectors      # noqa: F401
