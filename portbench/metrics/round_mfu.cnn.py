"""round_mfu.cnn: the whole round's share of the chip's peak in the CNN
seed sweep (cnn-sweep8), moving seed_rounds_per_s;
``portbench/shares.py``."""
from portbench.shares import mfu as read  # noqa: F401
