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

Two kernels compute K3, chosen per call by :func:`k3_plan` from the shapes
(a deliberate dispatch, each counted: ``launches_halo``,
``launches_scalar``; ``launches`` stays their sum): ``"halo"`` stages a
band of input rows with its halo in shared memory and slides the 3×3
window down each column (3×3, C a multiple of 16, 16-byte aligned
operands), with the plan's rows and channels a block; ``"scalar"`` takes
one output element a thread, for the rest.

``qdepthwise_fused`` keeps qtpu's call form: stride 1, VALID, on an input
already padded with the zero point, a (KH, KW, 1, C) weight and the
unfolded grid arguments.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import (OUT_KIND, check_vectors, fold,
                                    launch_args, out_dtype_of)
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ((_P, _P, _P, _P, _P) + (_I,) * 13 + (_F, _F, _F, _I, _I, _F)
             + (_I, _I, _I, _P))
_SYMBOLS = {"halo": "qtpu_qdepthwise_fused",
            "scalar": "qtpu_qdepthwise_fused_scalar"}
HALO_SMEM = 48 * 1024     # the halo tile's bytes at most


class DwPlan(NamedTuple):
    """K3's kernel and, for the halo kernel, its output rows (``th``) and
    channels (``cc``) per block and its threads per block."""
    path: str
    th: int = 0
    cc: int = 0
    threads: int = 256


def k3_plan(B: int, H: int, W: int, C: int, OH: int, OW: int,
            kernel_hw: Tuple[int, int], stride: int, aligned: bool = True,
            *, sms: int) -> DwPlan:
    """The kernel and tiles K3 takes for these shapes.  ``"halo"`` for a
    3×3 at stride 1 or 2 with C a multiple of 16 and 16-byte aligned
    operands (``aligned``), else ``"scalar"``.  Halo tiles: 32 channels a
    block (16 when C is not a multiple of 32), 8 output rows at stride 1
    and 4 at stride 2 (fewer for smaller maps), halved while the grid has
    fewer than two blocks for each of the card's ``sms`` SMs (its
    ``multi_processor_count``, which the wrapper reads) or the staged tile
    ((rows-1)·s + 3) × ((OW-1)·s + 3) × channels bytes exceeds 48 KB; up
    to 128 threads (256 at stride 2), one output column and four channels
    each — so small maps (7×7) keep whole images and take few channels a
    block, large maps take bands (chosen from timings of the halo kernel
    over tile plans on an H100)."""
    if (tuple(kernel_hw) != (3, 3) or C % 16 or stride not in (1, 2)
            or not aligned):
        return DwPlan("scalar")
    cc = 32 if C % 32 == 0 else 16
    th = min(OH, 8 if stride == 1 else 4)
    Wt = (OW - 1) * stride + 3
    while th > 1 and (B * -(-OH // th) * (C // cc) < 2 * sms
                      or ((th - 1) * stride + 3) * Wt * cc > HALO_SMEM):
        th = -(-th // 2)
    if ((th - 1) * stride + 3) * Wt * cc > HALO_SMEM:
        return DwPlan("scalar")
    return DwPlan("halo", th, cc, min(128 * stride,
                                      -(-OW * cc // 4 // 32) * 32))


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
                      raw_acc: bool = False,
                      plan: Optional[DwPlan] = None) -> torch.Tensor:
    """Depthwise conv of the int8 (B, H, W, C) with the (KH·KW, C) weight,
    pads filled with ``zp`` → (B, OH, OW, C) after the epilogue.
    ``plan`` forces a :class:`DwPlan` (default: :func:`k3_plan`)."""
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
    vecs = () if raw_acc or co is None else (co.A, co.B)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x_q, w_taps, out, *vecs))
    auto = k3_plan(B, H, W, C, OH, OW, kernel_hw, stride, aligned,
                   sms=torch.cuda.get_device_properties(
                       dev).multi_processor_count)
    if plan is None:
        plan = auto
    elif plan.path not in _SYMBOLS or (plan.path == "halo"
                                       and auto.path != "halo"):
        raise ValueError(f"K3 plan {plan} cannot take these operands "
                         f"(they take {auto})")
    A, Bv, _, lo, hi, shift, relu, use_am, am = launch_args(
        None if raw_acc else co, mode)
    fn = _build.load("qdepthwise", _SYMBOLS[plan.path], _ARGTYPES)
    err = _build.launch(
        fn, dev, x_q.data_ptr(), w_taps.data_ptr(), A, Bv, out.data_ptr(),
        OUT_KIND[odt], B, H, W, C, OH, OW, KH, KW, stride, pt, pl, int(zp), lo,
        hi, shift, relu, use_am, am, plan.th, plan.cc, plan.threads)
    if err:
        raise RuntimeError(f"qdepthwise_fused kernel ({plan}) launch "
                           f"failed: CUDA error {err} (x "
                           f"{tuple(x_q.shape)}, {KH}x{KW}/{stride})")
    qdepthwise_folded.launches += 1
    name = f"launches_{plan.path}"
    setattr(qdepthwise_folded, name, getattr(qdepthwise_folded, name) + 1)
    return out


qdepthwise_folded.launches = 0
qdepthwise_folded.launches_halo = 0
qdepthwise_folded.launches_scalar = 0


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
