"""K2: fused int8 convolution as an implicit GEMM (port of
qtpu/ops/pallas/qconv.py:qconv2d_fused and pad_for_conv).

``qconv2d_folded`` is the kernel wrapper: on a CUDA tensor it launches a
hand-written kernel of ``csrc/qconv.cu`` (or raises), on a CPU tensor it
takes ``qconv2d_folded_plain``.  Its ``launches`` attribute counts kernel
launches and nothing else.

The input is int8 NHWC and unpadded: ``pads`` ((top, bottom), (left,
right)) and the activation zero point ``zp`` say how the reference pads it
(``pads`` 0: qtpu's call form, an input already padded with the zero
point).  The weight is stored (Co, KH·KW·Ci) — OHWI flattened, the
kernel's layout, prepared once at engine build — and ``tapsum`` (KH·KW,
Co), the int32 sum of each tap's weights over Ci (:func:`tapsum_of`),
beside it.  Unlike the TPU kernel, the stride (1 or 2) is a kernel
parameter: the strided conv needs no phase split on Hopper
(qtpu_torch.ops.qconv_dispatch).  The epilogue modes are those of K1.

Four kernels compute K2, chosen per call by :func:`k2_path` from what the
operands allow (a deliberate dispatch, never a fallback after a failure),
each counted (``launches_wgmma``, ``launches_stem``, ``launches_small``,
``launches_igemm``; ``launches`` stays their sum); ``path=`` forces one:
``"wgmma"``, K1's TMA + ``wgmma`` ring with TMA im2col loads, for Ci a
multiple of 64 (the zero fill at the pads corrected by ``zp · tapsum`` in
the epilogue); ``"stem"``, for Ci = 3 with int8 codes (the quantized
stems); ``"small"``, the stem kernel generalised, for the small-channel
convs (Ci·KH·KW ≤ 320: LeNet-5's, ResNet-20's 16- and 32-channel 3×3s,
the Ci = 3 stems with f32 or raw output), its input rows staged with the
zero-point pads written in the kernel, multiplied by ``wgmma`` or
``mma.sync`` (``small_mma=`` forces one, for a comparison); ``"igemm"``,
the old ``mma.sync`` loop, for the rest — on the zero-point-padded input,
which this wrapper then writes first through ``qops.resolve_and_pad`` (its
``calls`` count every pad copy).

The pad code ``zp`` is a host integer (the serving paths) or a 0-d int32
tensor on the card (the integer-forward QAT conv computes it there, as
qtpu traces it): every kernel then reads it from device memory, the
implicit GEMM's ``zp · tapsum`` repair runs wherever a window leaves the
image, and the old loop's pad copy is filled on the card — no host read,
so a CUDA graph of the training step holds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from qtpu_torch.bench.profile import note_work, recording
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import (OUT_KIND, check_residual, check_vectors,
                                    fold, int_grid, launch_args,
                                    out_dtype_of)
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ((_P,) * 6 + (_I, _P) + (_I,) * 14 + (_P,) + (_F,) * 4
             + (_I, _I, _F, _P))
PATHS = ("wgmma", "stem", "small", "igemm")
_SYMBOLS = {"wgmma": "qtpu_qconv2d_fused", "stem": "qtpu_qconv2d_fused_stem",
            "small": "qtpu_qconv2d_fused_small",
            "igemm": "qtpu_qconv2d_fused_igemm"}
# the small kernel's multiply forced: mma.sync, or wgmma (Co > 8)
_SMALL_MMA = {"sync": "qtpu_qconv2d_fused_small_sync",
              "wgmma": "qtpu_qconv2d_fused_small_wg"}
SMALL_K = 320     # the small kernel's Ci·KH·KW at most
NO_PADS = ((0, 0), (0, 0))
Pads = Sequence[Tuple[int, int]]
PadCode = Union[int, torch.Tensor]


def device_pad_code(zp: PadCode, dev: torch.device) -> Optional[torch.Tensor]:
    """``zp`` when it is a pad code on the device — a 0-d int32 tensor on
    ``dev``, which the kernels read from device memory — else None (a host
    integer).  Any other tensor raises."""
    if not isinstance(zp, torch.Tensor):
        return None
    if zp.dtype != torch.int32 or zp.dim() != 0 or zp.device != dev:
        raise ValueError(f"a pad code tensor must be a 0-d int32 tensor on "
                         f"{dev}, got {zp.dtype} {tuple(zp.shape)} on "
                         f"{zp.device}")
    return zp


def weight_ohwi(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO (KH, KW, Ci, Co) → the kernel layout (Co, KH·KW·Ci)."""
    return w_q.reshape(-1, w_q.shape[-1]).t().contiguous()


def tapsum_of(w_nk: torch.Tensor, kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """(KH·KW, Co) int32: each tap's weights summed over Ci — the zero-point
    term a pad tap contributes is ``zp · tapsum[tap]``."""
    KH, KW = kernel_hw
    Co = w_nk.shape[0]
    return (w_nk.reshape(Co, KH * KW, -1).sum(-1, dtype=torch.int32)
            .t().contiguous())


def out_hw(hw: Sequence[int], kernel_hw: Tuple[int, int], stride: int,
           pads: Pads) -> Tuple[int, int]:
    """(OH, OW) of the conv of an (H, W) input with these pads."""
    (pt, pb), (pl, pr) = pads
    return ((hw[0] + pt + pb - kernel_hw[0]) // stride + 1,
            (hw[1] + pl + pr - kernel_hw[1]) // stride + 1)


def k2_path(x: torch.Tensor, w: torch.Tensor, pads: Pads, stride: int,
            co: Optional[EpilogueCoeffs] = None,
            mode: Optional[EpilogueMode] = None, *,
            kernel_hw: Tuple[int, int],
            out_dtype: torch.dtype = torch.int8,
            residual: Optional[torch.Tensor] = None) -> str:
    """The kernel K2 takes for these operands (``x`` the unpadded (B, H, W,
    Ci) input, ``w`` the (Co, KH·KW·Ci) weight, ``out_dtype`` the
    output's, ``co``/``mode`` the folded epilogue): ``"igemm"`` for a
    requant grid the conversion-free requant cannot take (lo or hi not an
    integer, a shift other than 0 or 128); else ``"stem"`` for Ci = 3 with
    int8 codes, no residual, Co in {16, 32, 64, 128}, W·3 a multiple of 16,
    OW ≤ 256 and KH·KW·3 ≤ 256; ``"wgmma"`` for Ci a multiple of 64 where
    TMA can address every operand (16-byte aligned bases, output and
    residual rows of multiples of 16 bytes); ``"small"`` for Ci·KH·KW ≤
    320, an even Co ≤ 128 and the input and residual 4-byte aligned;
    ``"igemm"`` for the rest."""
    if (out_dtype == torch.int8 and co is not None and mode is not None
            and not int_grid(co.lo, co.hi, mode.shift)):
        return "igemm"
    B, H, W, Ci = x.shape
    Co = w.shape[0]
    OH, OW = out_hw((H, W), kernel_hw, stride, pads)
    if Ci == 3 and (out_dtype == torch.int8 and residual is None
                    and Co in (16, 32, 64, 128) and W * 3 % 16 == 0
                    and x.data_ptr() % 16 == 0 and OW <= 256
                    and kernel_hw[0] * kernel_hw[1] * 3 <= 256):
        return "stem"
    osize = torch.empty((), dtype=out_dtype).element_size()
    rows = [(x, Ci), (w, w.shape[1]), (None, Co * osize)]
    if residual is not None:
        rows.append((residual, Co * residual.element_size()))
    if Ci % 64 == 0 and all(
            nbytes % 16 == 0 and (t is None or t.data_ptr() % 16 == 0)
            for t, nbytes in rows):
        return "wgmma"
    return "small" if _small_fits(x, w, kernel_hw, residual) else "igemm"


def _small_fits(x: torch.Tensor, w: torch.Tensor, kernel_hw: Tuple[int, int],
                residual: Optional[torch.Tensor]) -> bool:
    """Whether the small kernel takes these operands (the requant grid
    aside): Ci·KH·KW ≤ 320, an even Co ≤ 128, the input and the residual
    4-byte aligned."""
    Co = w.shape[0]
    return (kernel_hw[0] * kernel_hw[1] * x.shape[-1] <= SMALL_K
            and Co % 2 == 0 and Co <= 128 and x.data_ptr() % 4 == 0
            and (residual is None or residual.data_ptr() % 4 == 0))


def qconv2d_folded(x_q: torch.Tensor, w_nk: torch.Tensor,
                   co: Optional[EpilogueCoeffs],
                   mode: Optional[EpilogueMode],
                   residual: Optional[torch.Tensor] = None, *,
                   kernel_hw: Tuple[int, int], stride: int = 1,
                   pads: Pads = NO_PADS, zp: PadCode = 0,
                   tapsum: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   raw_acc: bool = False,
                   path: Optional[str] = None,
                   small_mma: Optional[str] = None) -> torch.Tensor:
    """Conv of the int8 (B, H, W, Ci), padded by ``pads`` with ``zp``, with
    the (Co, KH·KW·Ci) weight at ``stride`` → (B, OH, OW, Co) after the
    epilogue, with an optional int8 or f32 (B, OH, OW, Co) residual.
    ``zp`` is a host integer or a 0-d int32 tensor on the card (the QAT
    step's), which every kernel reads from device memory and no host
    reads (its range is the caller's).  ``tapsum`` (:func:`tapsum_of`) is
    computed here when the implicit GEMM needs it and the caller did not
    prepare it.  ``small_mma`` ("sync" or "wgmma") forces the small
    kernel's multiply; it needs that path."""
    pads = tuple(tuple(int(v) for v in p) for p in pads)
    if x_q.device.type == "cpu":
        return qconv2d_folded_plain(x_q, w_nk, co, mode, residual,
                                    kernel_hw=kernel_hw, stride=stride,
                                    pads=pads, zp=zp, out_dtype=out_dtype,
                                    raw_acc=raw_acc)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    B, H, W, Ci = x_q.shape
    KH, KW = kernel_hw
    Co = w_nk.shape[0]
    dev = x_q.device
    x_bytes = x_q.numel()       # the input as given, before any pad copy
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} not in (1, 2)")
    if tuple(w_nk.shape) != (Co, KH * KW * Ci):
        raise ValueError(f"weight {tuple(w_nk.shape)} does not match "
                         f"({Co}, {KH}*{KW}*{Ci})")
    zp_dev = device_pad_code(zp, dev)
    zp = 0 if zp_dev is not None else int(zp)
    if min(v for p in pads for v in p) < 0 or not -128 <= zp <= 127:
        raise ValueError(f"pads {pads} or zero point {zp} out of range")
    OH, OW = out_hw((H, W), kernel_hw, stride, pads)
    if OH <= 0 or OW <= 0:
        raise ValueError(f"input {H}x{W} with pads {pads} smaller than the "
                         "kernel")
    for name, t in (("x_q", x_q), ("w_nk", w_nk)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int8 tensor on {dev}")
    if not raw_acc:
        check_vectors(co, Co, dev)
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    res_kind = check_residual(residual, (B, OH, OW, Co), dev)
    path = _path(path, x_q, w_nk, pads, stride, None if raw_acc else co,
                 mode, kernel_hw, odt, residual)
    if small_mma is not None and (path != "small"
                                  or small_mma not in _SMALL_MMA):
        raise ValueError(f"small_mma={small_mma!r} needs the small path "
                         f"and 'sync' or 'wgmma' (path {path!r})")
    (pt, _), (pl, _) = pads
    if path == "igemm" and pads != NO_PADS:
        x_q = qops.resolve_and_pad(
            x_q, kernel_hw, (stride, stride), pads,
            zp if zp_dev is None else zp_dev).contiguous()
        _, H, W, _ = x_q.shape
        pt = pl = 0
    # a pad code on the device is not known here: its repair always runs
    # where a window leaves the image (a code of 0 adds 0)
    if path == "wgmma" and (zp or zp_dev is not None) and pads != NO_PADS:
        if tapsum is None:
            tapsum = tapsum_of(w_nk, kernel_hw)
        if (tapsum.dtype != torch.int32 or tapsum.device != dev
                or not tapsum.is_contiguous()
                or tuple(tapsum.shape) != (KH * KW, Co)):
            raise ValueError(f"tapsum must be a contiguous int32 "
                             f"({KH * KW}, {Co}) tensor on {dev}")
    else:
        tapsum = None
    out = torch.empty((B, OH, OW, Co), dtype=odt, device=dev)
    A, Bv, C, lo, hi, shift, relu, use_am, am = launch_args(
        None if raw_acc else co, mode)
    fn = _build.load("qconv", _SMALL_MMA[small_mma] if small_mma
                     else _SYMBOLS[path], _ARGTYPES)
    err = _build.launch(
        fn, dev, x_q.data_ptr(), w_nk.data_ptr(),
        None if tapsum is None else tapsum.data_ptr(), A, Bv,
        None if residual is None else residual.data_ptr(), res_kind,
        out.data_ptr(), OUT_KIND[odt], B, H, W, Ci, Co, KH, KW, stride, pt,
        pl, OH, OW, zp, None if zp_dev is None else zp_dev.data_ptr(), C,
        lo, hi, shift, relu, use_am, am)
    if err:
        raise RuntimeError(f"qconv2d_fused kernel ({path}) launch failed: "
                           f"CUDA error {err} (x {tuple(x_q.shape)}, "
                           f"Co={Co}, {KH}x{KW}/{stride}, pads {pads})")
    qconv2d_folded.launches += 1
    name = f"launches_{path}"
    setattr(qconv2d_folded, name, getattr(qconv2d_folded, name) + 1)
    if recording():
        note_work(2 * B * OH * OW * Co * KH * KW * Ci,
                  x_bytes + w_nk.numel() + out.numel() * out.element_size()
                  + (0 if residual is None
                     else residual.numel() * residual.element_size())
                  + (0 if raw_acc else 8 * Co))
    return out


qconv2d_folded.launches = 0
qconv2d_folded.launches_wgmma = 0
qconv2d_folded.launches_stem = 0
qconv2d_folded.launches_small = 0
qconv2d_folded.launches_igemm = 0


def _path(path: Optional[str], x_q, w, pads, stride, co, mode, kernel_hw,
          out_dtype, residual) -> str:
    auto = k2_path(x_q, w, pads, stride, co, mode, kernel_hw=kernel_hw,
                   out_dtype=out_dtype, residual=residual)
    if path is None:
        return auto
    # the small kernel may also be forced where the stem kernel goes
    small = auto == "stem" and _small_fits(x_q, w, kernel_hw, residual)
    if path not in PATHS or not (path in ("igemm", auto)
                                 or (path == "small" and small)):
        raise ValueError(f"K2 path {path!r} cannot take these operands "
                         f"(they take {auto!r})")
    return path


def qconv2d_folded_plain(x_q: torch.Tensor, w_nk: torch.Tensor,
                         co: Optional[EpilogueCoeffs],
                         mode: Optional[EpilogueMode],
                         residual: Optional[torch.Tensor] = None, *,
                         kernel_hw: Tuple[int, int], stride: int = 1,
                         pads: Pads = NO_PADS, zp: PadCode = 0,
                         out_dtype: torch.dtype = torch.float32,
                         raw_acc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_folded`: zero-point pad,
    the exact float64 accumulator, then the folded epilogue step by
    step.  ``zp`` may be an integer or a 0-d tensor."""
    qconv2d_folded_plain.calls += 1
    KH, KW = kernel_hw
    Co = w_nk.shape[0]
    w_hwio = w_nk.reshape(Co, KH, KW, -1).permute(1, 2, 3, 0)
    acc = qops.conv_acc_f64(qops.pad_nhwc(x_q, pads, qops.pad_value(zp)),
                            w_hwio, stride)
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    if raw_acc:
        return acc
    return qops.apply_epilogue(acc, co, mode, residual=residual,
                               out_dtype=odt)


qconv2d_folded_plain.calls = 0


def border_correction(acc_zero_filled: torch.Tensor, tapsum: torch.Tensor,
                      hw: Sequence[int], kernel_hw: Tuple[int, int],
                      stride: int, pads: Pads, zp: int) -> torch.Tensor:
    """The implicit GEMM's pad repair as a plain function: the int32
    accumulator of the conv whose pads read 0 (TMA's fill), plus ``zp ·
    tapsum[tap]`` for every tap (kh, kw) of each output pixel's window that
    lies outside the (H, W) image — equal to the accumulator of the conv
    padded with ``zp``.  ``acc_zero_filled``: (B, OH, OW, Co);
    ``tapsum``: (KH·KW, Co) int32."""
    (pt, _), (pl, _) = pads
    KH, KW = kernel_hw
    OH, OW = acc_zero_filled.shape[1:3]
    dev = acc_zero_filled.device
    ih = torch.arange(OH, device=dev) * stride - pt
    iw = torch.arange(OW, device=dev) * stride - pl
    acc = acc_zero_filled.to(torch.int64)
    for kh in range(KH):
        out_h = (ih + kh < 0) | (ih + kh >= hw[0])
        for kw in range(KW):
            out_w = (iw + kw < 0) | (iw + kw >= hw[1])
            out = (out_h[:, None] | out_w[None, :]).to(torch.int64)
            acc = acc + (int(zp) * out[None, :, :, None]
                         * tapsum[kh * KW + kw].to(torch.int64))
    return acc.to(torch.int32)


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
