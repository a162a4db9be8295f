"""device_idle_share.lm: the device's idle share in the LM round
(qwen2-round16), moving round_ms_p95; ``portbench/shares.py``."""
from portbench.shares import idle_share as read  # noqa: F401
