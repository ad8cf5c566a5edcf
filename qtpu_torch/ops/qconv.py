"""K2: fused int8 convolution as an implicit GEMM (port of
qtpu/ops/pallas/qconv.py:qconv2d_fused and pad_for_conv).

``qconv2d_folded`` is the kernel wrapper: on a CUDA tensor it launches the
hand-written kernel of ``csrc/qconv.cu`` (or raises), on a CPU tensor it
takes ``qconv2d_folded_plain``.  Its ``launches`` attribute counts kernel
launches and nothing else.

The input is int8 NHWC, already padded with the activation zero point; the
weight is stored (Co, KH·KW·Ci) — OHWI flattened, the kernel's layout,
prepared once at engine build.  Unlike the TPU kernel, the stride (1 or 2)
is a kernel parameter: the strided conv needs no phase split on Hopper
(qtpu_torch.ops.qconv_dispatch).  The epilogue modes are those of K1.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import (OUT_KIND, check_residual, check_vectors,
                                    fold, launch_args, out_dtype_of)
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _F, _F, _F, _F, _I, _I, _F, _P)


def weight_ohwi(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO (KH, KW, Ci, Co) → the kernel layout (Co, KH·KW·Ci)."""
    return w_q.reshape(-1, w_q.shape[-1]).t().contiguous()


def qconv2d_folded(x_pad: torch.Tensor, w_nk: torch.Tensor,
                   co: Optional[EpilogueCoeffs],
                   mode: Optional[EpilogueMode],
                   residual: Optional[torch.Tensor] = None, *,
                   kernel_hw: Tuple[int, int], stride: int = 1,
                   out_dtype: torch.dtype = torch.float32,
                   raw_acc: bool = False) -> torch.Tensor:
    """VALID conv of the zp-padded int8 (B, Hp, Wp, Ci) with the (Co,
    KH·KW·Ci) weight at ``stride`` → (B, OH, OW, Co) after the epilogue,
    with an optional int8 or f32 (B, OH, OW, Co) residual."""
    if x_pad.device.type == "cpu":
        return qconv2d_folded_plain(x_pad, w_nk, co, mode, residual,
                                    kernel_hw=kernel_hw, stride=stride,
                                    out_dtype=out_dtype, raw_acc=raw_acc)
    if not x_pad.is_cuda:
        raise ValueError(f"unsupported device {x_pad.device}")
    B, Hp, Wp, Ci = x_pad.shape
    KH, KW = kernel_hw
    Co = w_nk.shape[0]
    dev = x_pad.device
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} not in (1, 2)")
    if tuple(w_nk.shape) != (Co, KH * KW * Ci):
        raise ValueError(f"weight {tuple(w_nk.shape)} does not match "
                         f"({Co}, {KH}*{KW}*{Ci})")
    if Hp < KH or Wp < KW:
        raise ValueError(f"padded input {Hp}x{Wp} smaller than the kernel")
    for name, t in (("x_pad", x_pad), ("w_nk", w_nk)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int8 tensor on {dev}")
    if not raw_acc:
        check_vectors(co, Co, dev)
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    OH, OW = (Hp - KH) // stride + 1, (Wp - KW) // stride + 1
    res_kind = check_residual(residual, (B, OH, OW, Co), dev)
    out = torch.empty((B, OH, OW, Co), dtype=odt, device=dev)
    A, Bv, C, lo, hi, shift, relu, use_am, am = launch_args(
        None if raw_acc else co, mode)
    fn = _build.load("qconv", "qtpu_qconv2d_fused", _ARGTYPES)
    err = fn(x_pad.data_ptr(), w_nk.data_ptr(), A, Bv,
             None if residual is None else residual.data_ptr(), res_kind,
             out.data_ptr(), OUT_KIND[odt], B, Hp, Wp, Ci, Co, KH, KW, stride,
             C, lo, hi, shift, relu, use_am, am,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qconv2d_fused kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x_pad.shape)}, Co={Co}, "
                           f"{KH}x{KW}/{stride})")
    qconv2d_folded.launches += 1
    return out


qconv2d_folded.launches = 0


def qconv2d_folded_plain(x_pad: torch.Tensor, w_nk: torch.Tensor,
                         co: Optional[EpilogueCoeffs],
                         mode: Optional[EpilogueMode],
                         residual: Optional[torch.Tensor] = None, *,
                         kernel_hw: Tuple[int, int], stride: int = 1,
                         out_dtype: torch.dtype = torch.float32,
                         raw_acc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_folded` (exact float64
    accumulator, then the folded epilogue step by step)."""
    qconv2d_folded_plain.calls += 1
    KH, KW = kernel_hw
    Co = w_nk.shape[0]
    w_hwio = w_nk.reshape(Co, KH, KW, -1).permute(1, 2, 3, 0)
    acc = qops.conv_acc_f64(x_pad, w_hwio, stride)
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    if raw_acc:
        return acc
    return qops.apply_epilogue(acc, co, mode, residual=residual,
                               out_dtype=odt)


qconv2d_folded_plain.calls = 0


def qconv2d_fused(x_q: torch.Tensor, w_q: torch.Tensor, *, stride: int = 1,
                  out_dtype: torch.dtype = torch.float32,
                  raw_acc: bool = False, **kw) -> torch.Tensor:
    """qtpu's call form: VALID conv of the zp-prepadded (B, Hp, Wp, Ci) with
    the HWIO weight, grid arguments unfolded as for
    :func:`qtpu_torch.ops.qmatmul.qmatmul_fused` (``act_scale``, ``act_zp``,
    ``w_scale``, ``colsum``, ``bias``, ``requant_scale``, ``requant_zp``,
    ``relu``, ``act_max``, ``residual``, ``res_scale``, ``res_zp``).  For
    SAME semantics pad with :func:`pad_for_conv` first."""
    co, mode = fold(**kw)
    return qconv2d_folded(x_q, weight_ohwi(w_q), co, mode, kw.get("residual"),
                          kernel_hw=tuple(w_q.shape[:2]), stride=stride,
                          out_dtype=out_dtype, raw_acc=raw_acc)


def qconv2d_fused_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                        stride: int = 1,
                        out_dtype: torch.dtype = torch.float32,
                        raw_acc: bool = False, **kw) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_fused` (same arguments)."""
    co, mode = fold(**kw)
    return qconv2d_folded_plain(x_q, weight_ohwi(w_q), co, mode,
                                kw.get("residual"),
                                kernel_hw=tuple(w_q.shape[:2]),
                                stride=stride, out_dtype=out_dtype,
                                raw_acc=raw_acc)


def pad_for_conv(x_q: torch.Tensor, kernel_hw: Tuple[int, int],
                 act_zp) -> torch.Tensor:
    """Zero-point padding for a SAME stride-1 conv, with XLA's SAME split
    (lo = total//2), so even kernels pad like ``qops.qconv2d``."""
    return qops.resolve_and_pad(x_q, kernel_hw, (1, 1), "SAME", act_zp)
