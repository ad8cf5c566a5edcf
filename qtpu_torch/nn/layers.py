"""Conv building blocks and the qtpu weight carrier (port of ``ConvBN`` and
``QuantConv`` of qtpu/nn/layers.py, fp32 eval forms).

``ConvBN`` is a bias-free conv (``groups=C`` makes it depthwise), BatchNorm
on its running statistics with qtpu's formula ``(y − mean) / sqrt(var +
eps) · γ + β``, then an optional activation: ``None``, ``"relu"`` or
``"relu6"`` (``min(max(y, 0), 6)``).  Inputs are NCHW inside the models;
SAME pads asymmetrically (lo = total//2) as XLA does, explicit pads are
taken as given.  ``Conv`` is the bias conv without BatchNorm (qtpu's
``QuantConv``, LeNet-5's layers): the conv, then ``+ bias`` as a separate
add, with the same pads.

``layer_paths`` names every quantizable layer (ConvBN, Conv or Linear) by
qtpu's "/"-joined path.  ``load_flax_variables`` copies qtpu's ``params`` /
``batch_stats`` in: conv kernels HWIO → OIHW (a depthwise (3, 3, 1, C)
becomes (C, 1, 3, 3)) and dense kernels (in, out) → (out, in), the inverse
of qtpu/data/import_torch.py.  It is strict both ways.  ``load_layer``
fills one layer the same way (the module SERVE path loads its excluded
layers with it).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

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


class Conv(nn.Module):
    """Conv + bias, no BatchNorm (qtpu's ``QuantConv`` in fp32), NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=True)
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding = padding
        self.groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hlo, hhi), (wlo, whi) = resolve_pads(x.shape[2:], self.kernel,
                                              self.stride, self.padding)
        y = F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), self.conv.weight,
                     stride=self.stride)
        return y + self.conv.bias.view(-1, 1, 1)


QUANTIZABLE = (ConvBN, Conv, nn.Linear)


def layer_paths(model: nn.Module) -> Dict[str, nn.Module]:
    """qtpu-style path → quantizable layer (ConvBN, Conv or a Linear)."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, QUANTIZABLE)}


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flat(v, p))
        elif isinstance(v, torch.Tensor):
            out[p] = v.detach().cpu().numpy()
        else:
            out[p] = np.asarray(v)
    return out


Take = Callable[[str, str, Tuple[int, ...], Optional[Tuple[int, ...]]],
                torch.Tensor]


def load_layer(m: nn.Module, path: str, take: Take) -> None:
    """Fill one quantizable layer from qtpu's variables: ``take(collection,
    leaf path, torch shape, permutation)`` returns each array as a float32
    tensor of that shape."""
    with torch.no_grad():
        if isinstance(m, (ConvBN, Conv)):
            w = m.conv.weight
            w.copy_(take("params", f"{path}/kernel", w.shape, (3, 2, 0, 1)))
        if isinstance(m, Conv):
            m.conv.bias.copy_(take("params", f"{path}/bias",
                                   m.conv.bias.shape, None))
        elif isinstance(m, ConvBN):
            bn = m.bn
            bn.weight.copy_(take("params", f"{path}/scale", bn.weight.shape,
                                 None))
            bn.bias.copy_(take("params", f"{path}/bias", bn.bias.shape, None))
            bn.running_mean.copy_(take("batch_stats", f"{path}/mean",
                                       bn.running_mean.shape, None))
            bn.running_var.copy_(take("batch_stats", f"{path}/var",
                                      bn.running_var.shape, None))
        else:
            m.weight.copy_(take("params", f"{path}/kernel", m.weight.shape,
                                (1, 0)))
            m.bias.copy_(take("params", f"{path}/bias", m.bias.shape, None))


def flax_taker(params: Mapping, batch_stats: Mapping) -> Tuple[Take, set,
                                                                 dict]:
    """A ``take`` over qtpu's nested ``params``/``batch_stats`` (numpy
    arrays or tensors), the set of keys it has consumed, and every key."""
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

    return take, used, src


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping) -> nn.Module:
    """Copy qtpu's fp32 ``params``/``batch_stats`` into ``model`` in place.

    Strict both ways: every model tensor must be filled with a
    shape-matching array and every array consumed (observer variables of
    ``in_q`` submodules excepted — they are not weights)."""
    take, used, src = flax_taker(params, batch_stats)
    for path, m in layer_paths(model).items():
        load_layer(m, path, take)
    left = [f"{c}/{p}" for (c, p) in src if (c, p) not in used
            and "/in_q/" not in f"/{p}/"]
    if left:
        raise ValueError(f"qtpu variables not consumed: {sorted(left)}")
    return model
