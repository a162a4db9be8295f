"""The paper's own local models (Fig. 3 / Table II).

Two 5x5 conv layers (each followed by 2x2 max-pool), then two linear
layers. Channel counts per dataset reproduce Table II's exact
parameter counts:

  MNIST        : conv 15, 28 ; fc1 224 ; fc2 10  -> 113,744 params (448 KB)
  CIFAR-10     : conv 15, 28 ; fc1 300 ; fc2 10  -> 224,978 params (882 KB)
  FashionMNIST : conv 10, 12 ; fc1  80 ; fc2 10  ->  19,522 params ( 79 KB)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: Tuple[int, int]
    input_channels: int
    conv1_out: int
    conv2_out: int
    fc1_out: int
    num_classes: int
    kernel: int = 5
    pool: int = 2

    @property
    def flat_features(self) -> int:
        # 'valid' convs + 2x2 pools, as in the paper's Table II counts.
        h, w = self.input_hw
        h = (h - self.kernel + 1) // self.pool
        w = (w - self.kernel + 1) // self.pool
        h = (h - self.kernel + 1) // self.pool
        w = (w - self.kernel + 1) // self.pool
        return h * w * self.conv2_out


MNIST_CNN = CNNConfig("mnist_cnn", (28, 28), 1, 15, 28, 224, 10)
CIFAR10_CNN = CNNConfig("cifar10_cnn", (32, 32), 3, 15, 28, 300, 10)
FASHION_CNN = CNNConfig("fashion_cnn", (28, 28), 1, 10, 12, 80, 10)
# beyond-paper: a deliberately tiny model (P ≈ 6k) for population-scale
# runs and N-scaling benches, where the paper CNNs' P would make even the
# O(N) bookkeeping swamp the signal being measured
MICRO_CNN = CNNConfig("micro_cnn", (16, 16), 1, 8, 16, 64, 10,
                      kernel=3, pool=2)

CNN_CONFIGS = {
    "mnist": MNIST_CNN,
    "cifar10": CIFAR10_CNN,
    "fashion": FASHION_CNN,
    "micro": MICRO_CNN,
}
