"""Strided K×K int8 conv as im2col + K1 (port of
qtpu/ops/pallas/qim2col.py:qconv2d_im2col).

The patch matrix is built with PyTorch tensor ops, as qtpu builds it with
XLA outside its Pallas kernel: zero-point pad per SAME, KH·KW strided tap
slices concatenated along the channels, (B·OH·OW, KH·KW·Ci).  The GEMM and
its folded epilogue are one K1 launch (``qmatmul_folded``), which
``qconv2d_im2col.launches`` also counts on a CUDA tensor.  K is padded
with zero patch columns and zero weight rows to a multiple of 16, which
puts the 7×7×3 stem (K = 147 → 160) on K1's 16-byte path; the accumulator,
the per-channel colsums and the zero-point correction are unchanged, so the
result is bit-identical to ``qops.qconv2d`` + the epilogue.

No engine calls it, as in qtpu; it stands beside K2's strided conv
(``qconv_dispatch.qconv2d_strided``), which computes the same function.
``qconv2d_im2col_plain`` is the direct float64 conv of ``qops.qconv2d`` and
the same epilogue.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from qtpu_torch.ops import qops
from qtpu_torch.ops.qmatmul import fold, qmatmul_folded

K_ALIGN = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def im2col_patches(x_q: torch.Tensor, kernel_hw: Tuple[int, int],
                   strides: Tuple[int, int], act_zp) -> torch.Tensor:
    """SAME zero-point-padded patches of int8 NHWC ``x_q``: (B·OH·OW,
    Kp) int8, the taps in (kh, kw, ci) order — the HWIO weight's row
    order — and zero columns up to Kp = K rounded up to 16."""
    B, H, W, Ci = x_q.shape
    KH, KW = kernel_hw
    sh, sw = strides
    OH, OW = -(-H // sh), -(-W // sw)
    xp = qops.pad_nhwc(x_q, qops.same_pads((H, W), (KH, KW), strides),
                       int(act_zp))
    taps = [xp[:, kh:kh + (OH - 1) * sh + 1:sh, kw:kw + (OW - 1) * sw + 1:sw]
            for kh in range(KH) for kw in range(KW)]
    K = KH * KW * Ci
    patches = torch.cat(taps, dim=-1).reshape(B * OH * OW, K)
    return F.pad(patches, (0, _round_up(K, K_ALIGN) - K)).contiguous()


def im2col_weight(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weight → K1's (Co, Kp) layout, zero rows up to Kp."""
    KH, KW, Ci, Co = w_q.shape
    K = KH * KW * Ci
    w_nk = w_q.reshape(K, Co).t()
    return F.pad(w_nk, (0, _round_up(K, K_ALIGN) - K)).contiguous()


def qconv2d_im2col(x_q: torch.Tensor, w_q: torch.Tensor, *,
                   strides: Tuple[int, int], act_scale, act_zp, w_scale,
                   colsum, bias=None, requant_scale=None, requant_zp=None,
                   relu: bool = False,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME-padded strided int8 conv as a patch GEMM on K1: (B, H, W, Ci) ×
    (KH, KW, Ci, Co) → (B, OH, OW, Co).  Grid arguments as qtpu's;
    ``colsum`` over the real taps only; int8 codes with ``requant_scale``."""
    B, H, W, _ = x_q.shape
    KH, KW, _, Co = w_q.shape
    OH, OW = -(-H // strides[0]), -(-W // strides[1])
    co, mode = fold(act_scale=act_scale, act_zp=act_zp, w_scale=w_scale,
                    colsum=colsum, bias=bias, requant_scale=requant_scale,
                    requant_zp=requant_zp, relu=relu)
    y = qmatmul_folded(im2col_patches(x_q, (KH, KW), strides, act_zp),
                       im2col_weight(w_q), co, mode, out_dtype=out_dtype)
    if x_q.is_cuda:            # the K1 launch noted its work for traces
        qconv2d_im2col.launches += 1
    return y.reshape(B, OH, OW, Co)


qconv2d_im2col.launches = 0


def qconv2d_im2col_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                         strides: Tuple[int, int], act_zp,
                         out_dtype: torch.dtype = torch.float32,
                         **kw) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_im2col`: the direct float64
    conv of ``qops.qconv2d``, then the same folded epilogue."""
    acc = qops.qconv2d(x_q, w_q, strides=strides, zp=act_zp)
    co, mode = fold(act_zp=act_zp, **kw)
    return qops.apply_epilogue(acc, co, mode,
                               out_dtype=torch.int8 if mode.requant
                               else out_dtype)
