"""LeNet-5 for 28×28 MNIST images (port of qtpu/models/lenet.py), BASELINE
config 1's model.

conv1 5×5 SAME (6) → relu → 2×2/2 max-pool → conv2 5×5 VALID (16) → relu →
2×2/2 max-pool → flatten → fc1 120 → relu → fc2 84 → relu → fc3.  The
convs are :class:`qtpu_torch.nn.layers.Conv` (bias, no BatchNorm), qtpu's
``QuantConv``.  Inputs are NHWC like qtpu's and the convs run NCHW inside,
so the flatten goes back to qtpu's (h, w, c) order first: fc1's weights
carried over from qtpu read their inputs in that order.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.nn.layers import Conv, QuantDense

FLAT = 5 * 5 * 16      # conv2's pooled output of a 28×28 image


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, 6, 5, padding="SAME")
        self.conv2 = Conv(6, 16, 5, padding="VALID")
        self.fc1 = QuantDense(FLAT, 120)
        self.fc2 = QuantDense(120, 84)
        self.fc3 = QuantDense(84, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(torch.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # qtpu's (h, w, c)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)
