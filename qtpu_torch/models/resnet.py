"""fp32 ResNets (CIFAR and ImageNet variants) as torch modules (port of
qtpu/models/resnet.py).

Layer names follow qtpu's ("stem", "layer{i}_{j}/conv{k}", "down", "fc",
with "/" for torch's "."), so QuantPolicy globs and frozen-tree paths match.
Inputs are NHWC like qtpu's; inside, the convs run NCHW (torch's layout).
Geometry is qtpu's: SAME pads asymmetrically (lo = total//2) as XLA does,
``torch_pad=True`` pads symmetrically (torchvision).

BatchNorm runs on its running statistics with qtpu's formula
``(y − mean) / sqrt(var + eps) · γ + β`` — the eval / calibration forward.
Batch-statistics training comes with the training slice (ROADMAP.md).

``load_flax_variables`` copies qtpu's ``params``/``batch_stats`` in: conv
kernels HWIO → OIHW and dense kernels (in, out) → (out, in), the inverse of
qtpu/data/import_torch.py.  It is strict both ways.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.ops.qops import resolve_pads

BN_EPS = 1e-5
Padding = Union[str, Sequence[Tuple[int, int]]]


def _pad3(torch_pad: bool) -> Padding:
    return ((1, 1), (1, 1)) if torch_pad else "SAME"


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm on running stats (+ ReLU), NCHW inside."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", relu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding = padding
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hlo, hhi), (wlo, whi) = resolve_pads(x.shape[2:], self.kernel,
                                              self.stride, self.padding)
        x = F.pad(x, (wlo, whi, hlo, hhi))
        y = F.conv2d(x, self.conv.weight, stride=self.stride)
        bn = self.bn
        v = (-1, 1, 1)
        y = ((y - bn.running_mean.view(v)) / torch.sqrt(
            bn.running_var.view(v) + BN_EPS) * bn.weight.view(v)
             + bn.bias.view(v))
        return torch.relu(y) if self.relu else y


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_pad: bool = False):
        super().__init__()
        pad = _pad3(torch_pad)
        self.conv1 = ConvBN(cin, features, 3, stride, pad, relu=True)
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
        self.conv1 = ConvBN(cin, features, 1, relu=True)
        self.conv2 = ConvBN(features, features, 3, stride, _pad3(torch_pad),
                            relu=True)
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
            self.stem = ConvBN(in_channels, width, 3, 1, _pad3(torch_pad),
                               relu=True)
        else:
            self.stem = ConvBN(in_channels, width, 7, 2,
                               ((3, 3), (3, 3)) if torch_pad else "SAME",
                               relu=True)
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
        self.fc = nn.Linear(cin, num_classes)

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
        return self.fc(torch.mean(x, dim=(2, 3)))


_STAGES = {"resnet18": (2, 2, 2, 2), "resnet20": (3, 3, 3),
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
    if name not in _STAGES:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_STAGES)} (others: ROADMAP.md)")
    cifar = name in _CIFAR or name == "resnet18"
    return ResNet(Bottleneck if name in _BOTTLENECK else BasicBlock,
                  stage_sizes or _STAGES[name],
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


def layer_paths(model: nn.Module) -> Dict[str, nn.Module]:
    """qtpu-style path → quantizable layer (ConvBN or the fc)."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, (ConvBN, nn.Linear))}


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flat(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping) -> nn.Module:
    """Copy qtpu's fp32 ``params``/``batch_stats`` into ``model`` in place.

    Strict both ways: every model tensor must be filled with a
    shape-matching array and every array consumed (observer variables of
    ``in_q`` submodules excepted — they are not weights)."""
    src = {("params", k): v for k, v in _flat(params).items()}
    src.update({("batch_stats", k): v for k, v in _flat(batch_stats).items()})
    used = set()

    def take(col, path, shape, perm=None):
        key = (col, path)
        if key not in src:
            raise KeyError(f"qtpu variables lack {col}/{path}")
        a = src[key]
        if perm is not None:
            a = np.transpose(a, perm)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{col}/{path}: shape {a.shape} != {tuple(shape)}")
        used.add(key)
        return torch.tensor(a, dtype=torch.float32)

    with torch.no_grad():
        for path, m in layer_paths(model).items():
            if isinstance(m, ConvBN):
                w = m.conv.weight
                w.copy_(take("params", f"{path}/kernel", w.shape, (3, 2, 0, 1)))
                bn = m.bn
                bn.weight.copy_(take("params", f"{path}/scale", bn.weight.shape))
                bn.bias.copy_(take("params", f"{path}/bias", bn.bias.shape))
                bn.running_mean.copy_(take("batch_stats", f"{path}/mean",
                                           bn.running_mean.shape))
                bn.running_var.copy_(take("batch_stats", f"{path}/var",
                                          bn.running_var.shape))
            else:
                m.weight.copy_(take("params", f"{path}/kernel",
                                    m.weight.shape, (1, 0)))
                m.bias.copy_(take("params", f"{path}/bias", m.bias.shape))
    left = [f"{c}/{p}" for (c, p) in src if (c, p) not in used
            and "/in_q/" not in f"/{p}/"]
    if left:
        raise ValueError(f"qtpu variables not consumed: {sorted(left)}")
    return model
