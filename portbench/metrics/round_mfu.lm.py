"""round_mfu.lm: the whole round's share of the chip's peak in the LM
round (qwen2-round16), moving round_ms_p95; ``portbench/shares.py``."""
from portbench.shares import mfu as read  # noqa: F401
