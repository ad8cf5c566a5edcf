"""Strided int8 convs (port of qtpu/ops/pallas/qconv_dispatch.py).

On the TPU a stride-2 conv ran as four stride-1 phase convs in ``raw_acc``
mode, summed before one epilogue — a workaround for Mosaic's missing strided
window slices.  Hopper has no such limit: K2 takes the stride and the pads
directly (the zero point at the pads, no padded copy) and produces the same
int32 accumulator in one launch, followed by the same folded epilogue
(full-kernel colsum).  The plain version is the direct float64 strided conv
of ``qops.qconv2d``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from qtpu_torch.ops import qops
from qtpu_torch.ops.qconv import qconv2d_folded, weight_ohwi
from qtpu_torch.ops.qmatmul import fold


def qconv2d_strided(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    strides: Tuple[int, int] = (2, 2), padding="SAME",
                    out_dtype: torch.dtype = torch.float32,
                    **kw) -> torch.Tensor:
    """Strided int8 conv (NHWC × HWIO) with zero-point pads per ``padding``
    ("SAME", "VALID" or explicit ((lo, hi), (lo, hi))): K2 at the stride,
    the pads read in the kernel.  Grid arguments as
    :func:`qtpu_torch.ops.qconv.qconv2d_fused`."""
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    kernel_hw = tuple(w_q.shape[:2])
    pads = qops.resolve_pads(x_q.shape[1:3], kernel_hw, strides, padding)
    co, mode = fold(**kw)
    return qconv2d_folded(x_q, weight_ohwi(w_q), co, mode, kw.get("residual"),
                          kernel_hw=kernel_hw, stride=strides[0], pads=pads,
                          zp=int(kw["act_zp"]), out_dtype=out_dtype)


def qconv2d_strided_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                          strides: Tuple[int, int] = (2, 2), padding="SAME",
                          out_dtype: torch.dtype = torch.float32,
                          **kw) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_strided`."""
    acc = qops.qconv2d(x_q, w_q, strides=strides, padding=padding,
                       zp=kw["act_zp"])
    co, mode = fold(**kw)
    return qops.apply_epilogue(acc, co, mode, residual=kw.get("residual"),
                               out_dtype=torch.int8 if mode.requant
                               else out_dtype)
