"""Conv + BatchNorm building block and the qtpu weight carrier (port of
``ConvBN`` of qtpu/nn/layers.py, fp32 eval form).

``ConvBN`` is a bias-free conv (``groups=C`` makes it depthwise), BatchNorm
on its running statistics with qtpu's formula ``(y − mean) / sqrt(var +
eps) · γ + β``, then an optional activation: ``None``, ``"relu"`` or
``"relu6"`` (``min(max(y, 0), 6)``).  Inputs are NCHW inside the models;
SAME pads asymmetrically (lo = total//2) as XLA does, explicit pads are
taken as given.

``layer_paths`` names every quantizable layer (ConvBN or Linear) by qtpu's
"/"-joined path.  ``load_flax_variables`` copies qtpu's ``params`` /
``batch_stats`` in: conv kernels HWIO → OIHW (a depthwise (3, 3, 1, C)
becomes (C, 1, 3, 3)) and dense kernels (in, out) → (out, in), the inverse
of qtpu/data/import_torch.py.  It is strict both ways.
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
ACTIVATIONS = (None, "relu", "relu6")


def pad3(torch_pad: bool) -> Padding:
    """3×3-conv padding: explicit (1, 1) under torch geometry, else SAME
    (the two differ at stride 2, where SAME pads (0, 1))."""
    return ((1, 1), (1, 1)) if torch_pad else "SAME"


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm on running stats (+ activation), NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", act: Optional[str] = None,
                 groups: int = 1):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"activation {act!r} not in {ACTIVATIONS}")
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=False,
                              groups=groups)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding = padding
        self.groups = groups
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hlo, hhi), (wlo, whi) = resolve_pads(x.shape[2:], self.kernel,
                                              self.stride, self.padding)
        x = F.pad(x, (wlo, whi, hlo, hhi))
        y = F.conv2d(x, self.conv.weight, stride=self.stride,
                     groups=self.groups)
        bn = self.bn
        v = (-1, 1, 1)
        y = ((y - bn.running_mean.view(v)) / torch.sqrt(
            bn.running_var.view(v) + BN_EPS) * bn.weight.view(v)
             + bn.bias.view(v))
        if self.act is None:
            return y
        y = torch.relu(y)
        return torch.clamp_max(y, 6.0) if self.act == "relu6" else y


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
