"""K3: fused int8 depthwise convolution (port of
qtpu/ops/pallas/qdepthwise.py:qdepthwise_fused).

``qdepthwise_folded`` is the kernel wrapper: on a CUDA tensor it launches
the hand-written kernel of ``csrc/qdepthwise.cu`` (or raises), on a CPU
tensor it takes ``qdepthwise_folded_plain``.  Its ``launches`` attribute
counts kernel launches and nothing else.

The input is int8 NHWC, unpadded: the kernel reads the activation zero
point for every tap outside the image, with the pads of ``padding`` ("SAME",
"VALID" or explicit ((top, bottom), (left, right))).  The weight is stored
tap-major, (KH·KW, C) — the kernel's layout, prepared once at engine build.
The stride is 1 or 2; the TPU kernel took stride 1 only.  The epilogue
modes are K1's without the residual: int8 codes (relu6 folded into ``hi``),
f32 with relu / ``act_max``, or the raw int32 accumulator.

``qdepthwise_fused`` keeps qtpu's call form: stride 1, VALID, on an input
already padded with the zero point, a (KH, KW, 1, C) weight and the
unfolded grid arguments.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import (OUT_KIND, check_vectors, fold,
                                    launch_args, out_dtype_of)
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P) + (_I,) * 13 + (_F, _F, _F, _I, _I, _F, _P)


def weight_taps(w_q: torch.Tensor) -> torch.Tensor:
    """Depthwise HWIO (KH, KW, 1, C) → the kernel layout (KH·KW, C)."""
    if w_q.dim() != 4 or w_q.shape[2] != 1:
        raise ValueError(f"depthwise weight must be (KH, KW, 1, C), got "
                         f"{tuple(w_q.shape)}")
    return w_q.reshape(-1, w_q.shape[-1]).contiguous()


def _geometry(x_shape, kernel_hw, stride, padding):
    (pt, pb), (pl, pr) = qops.resolve_pads(x_shape[1:3], kernel_hw,
                                           (stride, stride), padding)
    H, W = x_shape[1:3]
    KH, KW = kernel_hw
    OH = (H + pt + pb - KH) // stride + 1
    OW = (W + pl + pr - KW) // stride + 1
    return pt, pl, OH, OW


def qdepthwise_folded(x_q: torch.Tensor, w_taps: torch.Tensor,
                      co: Optional[EpilogueCoeffs],
                      mode: Optional[EpilogueMode], *,
                      kernel_hw: Tuple[int, int], stride: int = 1,
                      padding: qops.Padding = "SAME", zp: int = 0,
                      out_dtype: torch.dtype = torch.float32,
                      raw_acc: bool = False) -> torch.Tensor:
    """Depthwise conv of the int8 (B, H, W, C) with the (KH·KW, C) weight,
    pads filled with ``zp`` → (B, OH, OW, C) after the epilogue."""
    if x_q.device.type == "cpu":
        return qdepthwise_folded_plain(
            x_q, w_taps, co, mode, kernel_hw=kernel_hw, stride=stride,
            padding=padding, zp=zp, out_dtype=out_dtype, raw_acc=raw_acc)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    if x_q.dim() != 4:
        raise ValueError(f"input must be NHWC, got {tuple(x_q.shape)}")
    B, H, W, C = x_q.shape
    KH, KW = kernel_hw
    dev = x_q.device
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} not in (1, 2)")
    if tuple(w_taps.shape) != (KH * KW, C):
        raise ValueError(f"weight {tuple(w_taps.shape)} does not match "
                         f"({KH}*{KW}, {C})")
    for name, t in (("x_q", x_q), ("w_taps", w_taps)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int8 tensor on {dev}")
    if not -128 <= int(zp) <= 127:
        raise ValueError(f"zero point {zp} off the int8 grid")
    if not raw_acc:
        check_vectors(co, C, dev)
    pt, pl, OH, OW = _geometry(x_q.shape, kernel_hw, stride, padding)
    if OH <= 0 or OW <= 0:
        raise ValueError(f"input {H}x{W} with its pads is smaller than the "
                         f"{KH}x{KW} kernel")
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    out = torch.empty((B, OH, OW, C), dtype=odt, device=dev)
    A, Bv, _, lo, hi, shift, relu, use_am, am = launch_args(
        None if raw_acc else co, mode)
    fn = _build.load("qdepthwise", "qtpu_qdepthwise_fused", _ARGTYPES)
    err = fn(x_q.data_ptr(), w_taps.data_ptr(), A, Bv, out.data_ptr(),
             OUT_KIND[odt], B, H, W, C, OH, OW, KH, KW, stride, pt, pl,
             int(zp), lo, hi, shift, relu, use_am, am,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qdepthwise_fused kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x_q.shape)}, "
                           f"{KH}x{KW}/{stride})")
    qdepthwise_folded.launches += 1
    return out


qdepthwise_folded.launches = 0


def qdepthwise_folded_plain(x_q: torch.Tensor, w_taps: torch.Tensor,
                            co: Optional[EpilogueCoeffs],
                            mode: Optional[EpilogueMode], *,
                            kernel_hw: Tuple[int, int], stride: int = 1,
                            padding: qops.Padding = "SAME", zp: int = 0,
                            out_dtype: torch.dtype = torch.float32,
                            raw_acc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qdepthwise_folded`: zero-point pad,
    the exact int32 tap sum, then the folded epilogue step by step."""
    qdepthwise_folded_plain.calls += 1
    KH, KW = kernel_hw
    xp = qops.resolve_and_pad(x_q, kernel_hw, (stride, stride), padding, zp)
    acc = qops.depthwise_acc(xp, w_taps.reshape(KH, KW, 1, -1), stride)
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    if raw_acc:
        return acc
    return qops.apply_epilogue(acc, co, mode, out_dtype=odt)


qdepthwise_folded_plain.calls = 0


def qdepthwise_fused(x_q: torch.Tensor, w_q: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.float32,
                     raw_acc: bool = False, **kw) -> torch.Tensor:
    """qtpu's call form: stride-1 VALID depthwise conv of the zp-prepadded
    (B, Hp, Wp, C) with the (KH, KW, 1, C) weight; grid arguments as
    :func:`qtpu_torch.ops.qmatmul.qmatmul_fused` without the residual
    (``act_scale``, ``act_zp``, ``w_scale``, ``colsum``, ``bias``,
    ``requant_scale``, ``requant_zp``, ``relu``, ``act_max``)."""
    co, mode = fold(**kw)
    return qdepthwise_folded(x_q, weight_taps(w_q), co, mode,
                             kernel_hw=tuple(w_q.shape[:2]), stride=1,
                             padding="VALID", out_dtype=out_dtype,
                             raw_acc=raw_acc)


def qdepthwise_fused_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                           out_dtype: torch.dtype = torch.float32,
                           raw_acc: bool = False, **kw) -> torch.Tensor:
    """Plain PyTorch version of :func:`qdepthwise_fused` (same arguments)."""
    co, mode = fold(**kw)
    return qdepthwise_folded_plain(x_q, weight_taps(w_q), co, mode,
                                   kernel_hw=tuple(w_q.shape[:2]), stride=1,
                                   padding="VALID", out_dtype=out_dtype,
                                   raw_acc=raw_acc)
