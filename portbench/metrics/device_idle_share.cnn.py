"""device_idle_share.cnn: the device's idle share in the CNN seed sweep
(cnn-sweep8), moving seed_rounds_per_s; ``portbench/shares.py``."""
from portbench.shares import idle_share as read  # noqa: F401
