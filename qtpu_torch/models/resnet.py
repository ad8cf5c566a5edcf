"""fp32 ResNets (CIFAR and ImageNet variants) as torch modules (port of
qtpu/models/resnet.py).

Layer names follow qtpu's ("stem", "layer{i}_{j}/conv{k}", "down", "fc",
with "/" for torch's "."), so QuantPolicy globs and frozen-tree paths match.
Inputs are NHWC like qtpu's; inside, the convs run NCHW (torch's layout).
Geometry is qtpu's: SAME pads asymmetrically (lo = total//2) as XLA does,
``torch_pad=True`` pads symmetrically (torchvision).

The layers are :class:`qtpu_torch.nn.layers.ConvBN` and the fc a
:class:`~qtpu_torch.nn.layers.QuantDense`: in eval BatchNorm runs on the
running statistics (the calibration forward), under ``model.train()`` on
the batch's, and a converted model (``transform.convert_model``) runs the
QAT forms of its layers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.nn.layers import ConvBN, QuantDense, pad3
from qtpu_torch.ops.qops import resolve_pads, spatial_mean


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_pad: bool = False):
        super().__init__()
        pad = pad3(torch_pad)
        self.conv1 = ConvBN(cin, features, 3, stride, pad, act="relu")
        self.conv2 = ConvBN(features, features, 3, 1, pad)
        self.down = (ConvBN(cin, features, 1, stride)
                     if stride != 1 or cin != features else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        r = self.down(x) if self.down is not None else x
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_pad: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = ConvBN(cin, features, 1, act="relu")
        self.conv2 = ConvBN(features, features, 3, stride, pad3(torch_pad),
                            act="relu")
        self.conv3 = ConvBN(features, out, 1)
        self.down = (ConvBN(cin, out, 1, stride)
                     if stride != 1 or cin != out else None)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        r = self.down(x) if self.down is not None else x
        return torch.relu(y + r)


class ResNet(nn.Module):
    """Generic ResNet over NHWC inputs.  ``cifar_stem=True``: 3×3/1 stem,
    no max-pool; otherwise the ImageNet 7×7/2 stem + 3×3/2 max-pool."""

    def __init__(self, block: type, stage_sizes: Sequence[int],
                 num_classes: int = 10, width: int = 64,
                 cifar_stem: bool = False, torch_pad: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.cifar_stem, self.torch_pad = cifar_stem, torch_pad
        if cifar_stem:
            self.stem = ConvBN(in_channels, width, 3, 1, pad3(torch_pad),
                               act="relu")
        else:
            self.stem = ConvBN(in_channels, width, 7, 2,
                               ((3, 3), (3, 3)) if torch_pad else "SAME",
                               act="relu")
        self.block_names = []
        cin = width
        for i, n in enumerate(stage_sizes):
            feat = width * 2 ** i
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                setattr(self, name, block(cin, feat, stride, torch_pad))
                self.block_names.append(name)
                cin = feat * block.expansion
        self.fc = QuantDense(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))
        if not self.cifar_stem:
            pads = (((1, 1), (1, 1)) if self.torch_pad else
                    resolve_pads(x.shape[2:], (3, 3), (2, 2), "SAME"))
            (hlo, hhi), (wlo, whi) = pads
            x = F.max_pool2d(F.pad(x, (wlo, whi, hlo, hhi),
                                   value=float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(spatial_mean(x, (2, 3)))


STAGES = {"resnet18": (2, 2, 2, 2), "resnet20": (3, 3, 3),
          "resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3),
          "resnet56": (9, 9, 9), "resnet101": (3, 4, 23, 3)}
_BOTTLENECK = frozenset({"resnet50", "resnet101"})
# factory defaults (qtpu.models): cifar variants at width 16 with a cifar stem
_CIFAR = frozenset({"resnet20", "resnet56"})


def get_model(name: str, *, num_classes: Optional[int] = None,
              width: Optional[int] = None, cifar_stem: Optional[bool] = None,
              torch_pad: bool = False, stage_sizes=None,
              in_channels: int = 3) -> ResNet:
    """qtpu.models.get_model for the ResNet family, with qtpu's factory
    defaults; ``stage_sizes`` overrides the depth (qtpu's ``clone``)."""
    name = name.lower()
    if name not in STAGES:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(STAGES)} (others: ROADMAP.md)")
    cifar = name in _CIFAR or name == "resnet18"
    return ResNet(Bottleneck if name in _BOTTLENECK else BasicBlock,
                  stage_sizes or STAGES[name],
                  num_classes=num_classes or (10 if cifar else 1000),
                  width=width or (16 if name in _CIFAR else 64),
                  cifar_stem=cifar if cifar_stem is None else cifar_stem,
                  torch_pad=torch_pad, in_channels=in_channels)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded fresh weights: He-normal kernels (fan in), zero biases, BN at
    γ=1, β=0, mean 0, var 1 — qtpu's initial state."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
