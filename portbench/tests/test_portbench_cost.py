"""The benchmark's operation and byte counts against hand counts."""
import math

import pytest

import smoke  # noqa: F401  (the repository's paths)
from portbench import harness, peaks
from portbench.cost import cnn, kernels, lm


def test_qwen2_tied_parameter_count():
    cfg = harness.load_json("configs", "qwen2-1.5b-clients")
    # embed 151936·1536, 28 layers of 46,797,824, the final norm 1536
    assert lm.param_count(cfg) == 1_543_714_304
    assert "lm_head" not in lm.leaves(cfg)


def test_qwen2_layer_by_hand():
    cfg = harness.load_json("configs", "qwen2-1.5b-clients")
    d, f, kv = 1536, 8960, 2 * 128
    per_layer = (d * d + d) + 2 * (d * kv + kv) + d * d + 3 * d * f + 2 * d
    assert per_layer == 46_797_824
    leaves = lm.leaves(cfg)
    layers = sum(math.prod(s) for k, s in leaves.items()
                 if k.startswith("blocks/"))
    assert layers == 28 * per_layer


def test_cnn_parameters_and_flops_by_hand():
    m = harness.load_json("configs", "paper-cnn-mnist")["model"]
    assert cnn.param_count(m) == 113_744
    conv1 = 24 * 24 * 15 * (2 * 25 + 1)
    conv2 = 8 * 8 * 28 * (2 * 25 * 15 + 1)
    fc = 224 * (2 * 448 + 1) + 10 * (2 * 224 + 1)
    assert cnn.forward_flops(m) == conv1 + conv2 + fc
    assert 5.5e6 < cnn.train_flops(m) < 6.5e6      # about 6 MFLOP an image


def test_cnn_seed_round_is_bound_by_operations():
    cfg = harness.load_json("configs", "paper-cnn-mnist")
    flops, nbytes = cnn.seed_round(cfg)
    # S·L·batch training images and the test set's forward
    assert flops == 10 * 20 * 32 * cnn.train_flops(cfg["model"]) \
        + 1000 * cnn.forward_flops(cfg["model"])
    assert flops / peaks.FLOP_RATE["float32"] > nbytes / 3.35e12


def test_kernel_costs_by_hand():
    assert kernels.pairwise_l2(16, 1, 1000, 2) == (3 * 16 * 1000,
                                                   16 * 1000 * 2 + 1000 * 4
                                                   + 16 * 4)
    assert kernels.flat_aggregate(16, 1000, 2) == (2 * 16 * 1000,
                                                   16 * 1000 * 2 + 16 * 4
                                                   + 1000 * 4)
    # rows of weight 0 never reach the fold: 4 winners of 16 clients
    assert kernels.flat_aggregate(16, 1000, 2, live=4) == (
        2 * 4 * 1000, 4 * 1000 * 2 + 16 * 4 + 1000 * 4)


def test_fl_round_is_bound_by_bytes():
    cfg = harness.load_json("configs", "qwen2-1.5b-clients")
    flops, nbytes = lm.fl_round(cfg, 16, 4)
    p = 1_543_714_304
    assert nbytes >= 16 * p * 2 + 2 * p * 2 + 4 * 151936 * 1536 * 4
    assert nbytes / 3.35e12 > flops / peaks.FLOP_RATE["bfloat16"]
    assert peaks.least_s(flops, nbytes, "bfloat16") == pytest.approx(
        nbytes / 3.35e12)
