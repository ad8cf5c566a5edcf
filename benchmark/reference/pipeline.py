"""The plain reference's post-training quantization and inference, from the
weights, calibration batches and pixels the benchmark made:

* ``calibrate``: the float model over the calibration batches, each
  quantized layer's input range (running min and max);
* ``freeze``: BatchNorm folded into every conv, the weights' codes per
  output channel (``w_bits``: 8 as the configuration states; a lower
  width only for the control), each layer's input grid from its range;
  an excluded stem keeps its folded float32 weight;
* ``normalize``: 0-255 pixels to float32 with the per-channel mean and
  standard deviation, ``x·a + b``, ``a = 1 / (255·std)``, ``b = −mean /
  std``;
* ``logits``: integer inference of the frozen tree, in blocks of rows.

An architecture module (``reference.resnet``, ``reference.mobilenet_v2``)
gives ``layers``, ``fp32_forward`` and ``int8_forward``.  Imports nothing
of the system under test.
"""
from __future__ import annotations

import fnmatch
import importlib
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from benchmark.reference import quant as Q


def arch_module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def excluded(path: str, exclude: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in exclude)


@torch.no_grad()
def calibrate(arch, cfg: dict, params: Dict, batches: Iterable[torch.Tensor],
              exclude: Sequence[str]) -> Dict[str, tuple]:
    """path → (min, max) of each quantized layer's input over ``batches``
    (normalized float32 NHWC)."""
    ranges: Dict[str, tuple] = {}

    def observe(path, x):
        if excluded(path, exclude):
            return
        lo, hi = torch.amin(x), torch.amax(x)
        old = ranges.get(path)
        ranges[path] = ((lo, hi) if old is None else
                        (torch.minimum(old[0], lo), torch.maximum(old[1], hi)))

    with Q.fp32_exact():
        for b in batches:
            arch.fp32_forward(cfg, params, b.to(torch.float32), observe)
    return ranges


@torch.no_grad()
def freeze(arch, cfg: dict, params: Dict, ranges: Dict[str, tuple],
           exclude: Sequence[str], w_bits: int = 8) -> Dict[str, dict]:
    """The frozen tree (``reference.quant``'s node layout)."""
    eps = arch.BN_EPS
    tree = {}
    for path, shape, groups in arch.layers(cfg):
        p = path.replace("/", ".")
        w, b = Q.fold_bn(params[f"{p}.conv.weight"], params[f"{p}.bn"], eps)
        if excluded(path, exclude):
            tree[path] = {"w_oihw": w.permute(3, 2, 0, 1).contiguous(),
                          "b": b}
            continue
        tree[path] = _node(w, b, ranges[path], w_bits,
                           squeeze=shape[2:] == (1, 1) and groups == 1)
    tree["fc"] = _node(params["fc.weight"].to(torch.float32).t(),
                       params["fc.bias"].to(torch.float32), ranges["fc"],
                       w_bits, squeeze=False)
    return tree


def _node(w: torch.Tensor, b: torch.Tensor, rng: tuple, w_bits: int,
          squeeze: bool) -> dict:
    codes, scale = Q.weight_codes(w, w_bits, axis=-1)
    colsum = codes.to(torch.int32).sum(
        dim=tuple(range(codes.dim() - 1))).to(torch.int32)
    if squeeze:                       # a 1×1 conv as its (in, out) matrix
        codes = codes.reshape(codes.shape[-2], codes.shape[-1])
    return {"w": codes.contiguous(), "w_scale": scale, "colsum": colsum,
            "bias": b.to(torch.float32).contiguous(),
            "grid": Q.grid_from_range(*rng)}


def normalize_coeffs(mean: Sequence[float], std: Sequence[float],
                     device) -> tuple:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    a = (1.0 / (255.0 * std)).astype(np.float32)
    b = (-mean / std).astype(np.float32)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def normalize(x_u8: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    a, b = coeffs
    return x_u8.to(torch.float32) * a + b


@torch.no_grad()
def logits(arch, cfg: dict, tree: Dict, x_u8: torch.Tensor, coeffs: tuple,
           rows: int) -> torch.Tensor:
    """float32 logits of uint8 NHWC pixels, ``rows`` images at a time."""
    out = [arch.int8_forward(cfg, tree, normalize(x_u8[i:i + rows], coeffs))
           for i in range(0, x_u8.shape[0], rows)]
    return torch.cat(out)
