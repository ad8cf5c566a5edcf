"""fp32 MobileNet-v1 / v2 as torch modules (port of qtpu/models/mobilenet.py).

Layer names follow qtpu's (``stem``, ``block{i}/dw|pw`` for v1,
``block{i}/expand|dw|project``, ``head`` for v2, ``fc``), so QuantPolicy
globs and frozen-tree paths match.  Inputs are NHWC like qtpu's; inside,
the convs run NCHW.  The depthwise convs are :class:`ConvBN` with
``groups`` equal to their channel count, the fc a ``QuantDense``; the
train, eval and QAT forms are the layers' own.  ``torch_pad=True`` pads
the 3×3 convs (1, 1) on both sides, torchvision's geometry, where SAME
pads (0, 1) at stride 2.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from qtpu_torch.nn.layers import ConvBN, QuantDense, pad3

# (expand, out_ch, repeats, stride) — the standard v2 schedule
V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
# (out_ch, stride) of the 13 depthwise-separable v1 blocks
V1_CFG = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
          (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
          (1024, 1))


def _round_ch(ch: float, divisor: int = 8) -> int:
    """Round channel counts like the original MobileNet width-multiplier rule."""
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return new


class DWSeparable(nn.Module):
    """Depthwise 3×3 + pointwise 1×1, both with relu (MobileNet-v1 block)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_pad: bool = False):
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride, pad3(torch_pad), act="relu",
                         groups=cin)
        self.pw = ConvBN(cin, features, 1, act="relu")

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 torch_pad: bool = False):
        super().__init__()
        w = lambda c: _round_ch(c * width_mult)   # noqa: E731
        self.stem = ConvBN(3, w(32), 3, 2, pad3(torch_pad), act="relu")
        cin = w(32)
        self.block_names = []
        for i, (c, s) in enumerate(V1_CFG):
            setattr(self, f"block{i}", DWSeparable(cin, w(c), s, torch_pad))
            self.block_names.append(f"block{i}")
            cin = w(c)
        self.fc = QuantDense(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(torch.mean(x, dim=(2, 3)))


class InvertedResidual(nn.Module):
    """MobileNet-v2 inverted residual: expand 1×1 → depthwise 3×3 → project
    1×1 (relu6 after expand and dw; the input added when shapes allow)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expand: int = 6, torch_pad: bool = False):
        super().__init__()
        hidden = cin * expand
        self.expand = (ConvBN(cin, hidden, 1, act="relu6")
                       if expand != 1 else None)
        self.dw = ConvBN(hidden, hidden, 3, stride, pad3(torch_pad),
                         act="relu6", groups=hidden)
        self.project = ConvBN(hidden, features, 1)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.dw(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 torch_pad: bool = False):
        super().__init__()
        w = lambda c: _round_ch(c * width_mult)   # noqa: E731
        self.stem = ConvBN(3, w(32), 3, 2, pad3(torch_pad), act="relu6")
        cin = w(32)
        self.block_names = []
        for t, c, n, s in V2_CFG:
            for j in range(n):
                name = f"block{len(self.block_names)}"
                setattr(self, name, InvertedResidual(
                    cin, w(c), s if j == 0 else 1, t, torch_pad))
                self.block_names.append(name)
                cin = w(c)
        head = w(1280) if width_mult > 1.0 else 1280
        self.head = ConvBN(cin, head, 1, act="relu6")
        self.fc = QuantDense(head, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.head(x)
        return self.fc(torch.mean(x, dim=(2, 3)))
