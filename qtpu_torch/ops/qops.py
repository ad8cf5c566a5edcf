"""Integer execution ops for the serving path (port of qtpu.ops.qops).

The numerical core every path shares: SAME/VALID/explicit padding with the
activation zero point as the pad value, activation quantization on the
unsigned grid, the folded epilogue ``clip(round(acc·A + B [+ r·C]), lo, hi)
− shift`` and the exact dequant epilogue of the fc.

``qconv2d`` and ``qmatmul`` are the exact plain references the hand-written
kernels are held against: the int8 products and their sums are computed in
float64, where every partial sum is an integer below 2^53 and so exact in any
order, then cast to int32; a depthwise ``qconv2d`` (``groups`` = channels)
sums its nine products per channel in int32 directly.  int8 ``F.conv2d`` is
never used: it returns int8 and wraps on overflow.

Scalar grid parameters (scales, zero points) may be Python numbers or 0-d
tensors.  Epilogue folding reads them on the host in numpy float32, in the
reference's operation order, so the folded coefficients equal qtpu's bit for
bit; the per-channel vectors stay tensors on their device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from qtpu_torch.utils import debug

Padding = Union[str, Sequence[Tuple[int, int]]]
Scalar = Union[float, int, np.number, torch.Tensor]


def same_pads(in_spatial: Sequence[int], window: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Explicit (lo, hi) pads reproducing XLA SAME padding (lo = total//2)."""
    pads = []
    for n, w, s in zip(in_spatial, window, strides):
        out = -(-n // s)
        total = max((out - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_pads(in_spatial: Sequence[int], window: Sequence[int],
                 strides: Sequence[int], padding: Padding
                 ) -> Tuple[Tuple[int, int], ...]:
    """SAME / VALID / explicit (lo, hi) pairs → explicit pairs; unknown
    strings raise."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "SAME":
            return same_pads(in_spatial, window, strides)
        if p == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(f"unknown padding {padding!r} "
                         "(use 'SAME', 'VALID', or explicit (lo,hi) pairs)")
    return tuple(tuple(int(v) for v in p) for p in padding)


def pad_value(zp: Optional[Scalar]):
    """A pad code as :func:`pad_nhwc` takes it: a Python int, or a 0-d
    tensor (the QAT step's), which no host reads."""
    if zp is None:
        return 0
    return zp if isinstance(zp, torch.Tensor) else int(zp)


def pad_nhwc(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
             value) -> torch.Tensor:
    """Constant-pad the H and W axes of an NHWC tensor.  A ``value`` that
    is a 0-d tensor fills the pads on its device — a fill, then the image
    copied in — and is never read on the host, so a CUDA graph can hold
    it."""
    (hlo, hhi), (wlo, whi) = pads
    if not (hlo or hhi or wlo or whi):
        return x
    if isinstance(value, torch.Tensor):
        B, H, W, C = x.shape
        out = torch.empty((B, H + hlo + hhi, W + wlo + whi, C),
                          dtype=x.dtype, device=x.device)
        out.copy_(value.to(x.dtype).expand(out.shape))
        out[:, hlo:hlo + H, wlo:wlo + W, :] = x
        return out
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=value)


def resolve_and_pad(x_q: torch.Tensor, window: Sequence[int],
                    strides: Sequence[int], padding: Padding,
                    zp: Optional[Scalar]) -> torch.Tensor:
    """Resolve the padding and zero-point-pad ``x_q`` (NHWC).  Its
    ``calls`` attribute counts the copies it makes, those K2's old loop
    needs included (K2's other kernels and K3's read the pads themselves:
    a serving forward of the ResNet-50 or MobileNet engines makes none)."""
    resolve_and_pad.calls += 1
    pads = resolve_pads(x_q.shape[1:3], window, strides, padding)
    return pad_nhwc(x_q, pads, pad_value(zp))


resolve_and_pad.calls = 0


def conv_acc_f64(xp: torch.Tensor, w: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """Exact int32 accumulator of a VALID conv of padded int8 NHWC ``xp``
    with HWIO ``w``: one float64 GEMM per tap, summed."""
    B, Hp, Wp, Ci = xp.shape
    KH, KW, _, Co = w.shape
    OH, OW = (Hp - KH) // stride + 1, (Wp - KW) // stride + 1
    acc = torch.zeros((B * OH * OW, Co), dtype=torch.float64,
                      device=xp.device)
    wd = w.to(torch.float64)
    for kh in range(KH):
        for kw in range(KW):
            tap = xp[:, kh:kh + (OH - 1) * stride + 1:stride,
                     kw:kw + (OW - 1) * stride + 1:stride, :]
            acc += tap.reshape(-1, Ci).to(torch.float64) @ wd[kh, kw]
    return acc.to(torch.int32).reshape(B, OH, OW, Co)


def depthwise_acc(xp: torch.Tensor, w: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """Exact int32 accumulator of a VALID depthwise conv of padded int8 NHWC
    ``xp`` with the (KH, KW, 1, C) weight: each strided tap slice times its
    per-channel weights, summed in int32 (nine int8 products never leave
    the int32 range)."""
    B, Hp, Wp, C = xp.shape
    KH, KW, one, C2 = w.shape
    if one != 1 or C2 != C:
        raise ValueError(f"depthwise weight {tuple(w.shape)} does not match "
                         f"{C} channels")
    OH, OW = (Hp - KH) // stride + 1, (Wp - KW) // stride + 1
    acc = torch.zeros((B, OH, OW, C), dtype=torch.int32, device=xp.device)
    wi = w.to(torch.int32)
    for kh in range(KH):
        for kw in range(KW):
            tap = xp[:, kh:kh + (OH - 1) * stride + 1:stride,
                     kw:kw + (OW - 1) * stride + 1:stride, :]
            acc += tap.to(torch.int32) * wi[kh, kw, 0]
    return acc


def qconv2d(x_q: torch.Tensor, w_q: torch.Tensor, *,
            strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
            groups: int = 1, zp: Optional[Scalar] = None) -> torch.Tensor:
    """int8 NHWC × int8 HWIO → int32 NHWC convolution (exact).  ``groups``
    is 1, or the channel count with a (KH, KW, 1, C) weight (depthwise)."""
    depthwise = groups != 1 and groups == x_q.shape[-1] == w_q.shape[-1] \
        and w_q.shape[2] == 1
    if groups != 1 and not depthwise:
        raise NotImplementedError(
            f"grouped int8 conv with groups={groups} (weight "
            f"{tuple(w_q.shape)}): only groups == channels (depthwise) is "
            "supported")
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    debug.check_int_inputs(x_q, w_q, what="qconv2d")
    xp = resolve_and_pad(x_q, w_q.shape[:2], strides, padding, zp)
    if depthwise:
        return depthwise_acc(xp, w_q, strides[0])
    return conv_acc_f64(xp, w_q, strides[0])


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (…, K) × int8 (K, N) → int32 (…, N) (exact)."""
    debug.check_int_inputs(x_q, w_q, what="qmatmul")
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    return acc.to(torch.int32)


def _divisor(scale: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A float32 divisor on ``like``'s device.  A device tensor (not a Python
    number) keeps CUDA's division a true IEEE division: with a host scalar
    PyTorch multiplies by the reciprocal, which moves codes at ties."""
    if isinstance(scale, torch.Tensor):
        return scale.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(scale), dtype=torch.float32,
                      device=like.device)


def quantize_act(x: torch.Tensor, scale: Scalar, zp: Scalar, bits: int = 8,
                 symmetric: bool = False) -> torch.Tensor:
    """fp32 → signed int8 codes on an affine grid with signed zero point
    ``zp``.  The affine path rounds on the unsigned grid, ``round(x/s +
    zp_u)``, then shifts — exactly as qtpu does."""
    debug.check_quant_grid(scale, zp, what="quantize_act")
    qmax = (1 << (bits - 1)) - 1
    s = _divisor(scale, x)
    if symmetric:
        q = torch.clamp(torch.round(x / s), -qmax, qmax)
    else:
        offset = 1 << (bits - 1)
        if isinstance(zp, torch.Tensor):
            zp_u = zp.to(device=x.device, dtype=torch.float32) + offset
        else:
            zp_u = float(np.float32(zp) + np.float32(offset))
        q = torch.clamp(torch.round(x / s + zp_u), 0, (1 << bits) - 1) - offset
    return q.to(torch.int8)


class EpilogueCoeffs(NamedTuple):
    """Folded epilogue coefficients: ``A``/``B`` are (N,) float32 tensors;
    ``C``/``lo``/``hi`` are Python floats holding float32 values."""
    A: torch.Tensor
    B: torch.Tensor
    C: float
    lo: float
    hi: float


class EpilogueMode(NamedTuple):
    requant: bool          # True → int8 codes out; False → f32 out
    shift: float           # 128.0 affine / 0.0 symmetric (requant only)
    relu: bool             # f32-mode only (folded into lo when requant)
    act_max: Optional[float]   # f32-mode only (folded into hi when requant)


def _h(v: Scalar) -> np.float32:
    """Host float32 value of a scalar (reads a tensor once)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).reshape(())
        return np.float32(v.item())
    return np.float32(v)


def epilogue_coeffs(*, act_scale: Scalar, act_zp: Scalar,
                    w_scale: torch.Tensor, colsum: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    requant_scale: Optional[Scalar] = None,
                    requant_zp: Optional[Scalar] = None,
                    requant_symmetric: bool = False,
                    relu: bool = False, act_max: Optional[float] = None,
                    res_scale: Optional[Scalar] = None,
                    res_zp: Optional[Scalar] = None,
                    res_f32: bool = False
                    ) -> Tuple[EpilogueCoeffs, EpilogueMode]:
    """Fold dequant → (residual) → relu → requant into
    ``clip(round(acc·A + B [+ r·C]), lo, hi) − shift`` (qtpu's single source
    of truth for the folding; see its docstring for the exactness notes).

    ``requant_zp`` is the signed-grid zero point; None with
    ``requant_scale`` set means a symmetric grid.  ``res_scale``/``res_zp``
    describe an int8 residual's grid; ``res_f32=True`` marks an f32
    residual instead.
    """
    n = colsum.shape[-1]
    dev = colsum.device
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    A0 = w_scale * float(_h(act_scale))
    zc = (colsum.to(torch.int32) * int(_h(act_zp))).to(torch.float32)
    B0 = -A0 * zc
    if bias is not None:
        B0 = B0 + torch.as_tensor(bias, dtype=torch.float32, device=dev)

    def vec(t: torch.Tensor) -> torch.Tensor:
        return t.expand(n).contiguous()

    if requant_scale is None:
        C = np.float32(1.0)
        if res_scale is not None:
            C = _h(res_scale)
            if res_zp is not None:
                B0 = B0 - float(_h(res_zp) * C)
        co = EpilogueCoeffs(A=vec(A0), B=vec(B0), C=float(C), lo=0.0, hi=0.0)
        return co, EpilogueMode(False, 0.0, relu, act_max)
    inv = np.float32(1.0) / np.maximum(_h(requant_scale), np.float32(1e-12))
    A = A0 * float(inv)
    B = B0 * float(inv)
    if res_f32:
        C = inv
    elif res_scale is not None:
        C = _h(res_scale) * inv
        if res_zp is not None:
            B = B - float(_h(res_zp) * C)
    else:
        C = np.float32(0.0)
    if requant_zp is not None and not requant_symmetric:
        zp_u = _h(requant_zp) + np.float32(128.0)
        B = B + float(zp_u)
        lo = zp_u if relu else np.float32(0.0)
        hi = np.float32(255.0)
        if act_max is not None:
            hi = np.minimum(hi, np.round(np.float32(act_max) * inv + zp_u))
        shift = 128.0
    else:
        lo = np.float32(0.0) if relu else np.float32(-127.0)
        hi = np.float32(127.0)
        if act_max is not None:
            hi = np.minimum(hi, np.round(np.float32(act_max) * inv))
        shift = 0.0
    co = EpilogueCoeffs(A=vec(A), B=vec(B), C=float(C), lo=float(lo),
                        hi=float(hi))
    return co, EpilogueMode(True, shift, relu, act_max)


def apply_epilogue(acc: torch.Tensor, co: EpilogueCoeffs, mode: EpilogueMode,
                   residual: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Folded epilogue on an int32 accumulator, each step rounded on its own
    (no fused multiply-add), as the reference computes it."""
    t = acc.to(torch.float32) * co.A + co.B
    if residual is not None:
        t = t + residual.to(torch.float32) * co.C
    if mode.requant:
        q = torch.clamp(torch.round(t), co.lo, co.hi) - mode.shift
        return q.to(out_dtype or torch.int8)
    if mode.relu:
        t = torch.clamp_min(t, 0.0)
    if mode.act_max is not None:
        t = torch.clamp_max(t, float(np.float32(mode.act_max)))
    return t if out_dtype is None else t.to(out_dtype)


def dequant_coeffs(*, act_scale: Scalar, act_zp: Scalar,
                   w_scale: torch.Tensor, colsum: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel constants of :func:`dequant_epilogue`:
    ``act_zp·colsum`` (exact integers) and ``act_scale·w_scale``, on
    ``colsum``'s device.  A layer whose grid is frozen computes them once."""
    dev = colsum.device
    zp = act_zp.to(dev) if isinstance(act_zp, torch.Tensor) \
        else int(act_zp)
    if isinstance(act_scale, torch.Tensor):
        sw = act_scale.to(dev) * w_scale
    else:
        sw = w_scale * float(np.float32(act_scale))
    return zp * colsum, sw


def dequant_apply(acc: torch.Tensor, zp_colsum: torch.Tensor,
                  sw: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`dequant_epilogue` on constants from :func:`dequant_coeffs`."""
    y = (acc - zp_colsum).to(torch.float32) * sw
    if bias is not None:
        y = y + bias
    return y


def dequant_epilogue(acc: torch.Tensor, *, act_scale: Scalar,
                     act_zp: Scalar, w_scale: torch.Tensor,
                     colsum: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act_scale·w_scale[o]·(acc[..., o] − act_zp·colsum[o]) + b[o]`` with
    the zero-point correction in exact integer arithmetic first."""
    zp_colsum, sw = dequant_coeffs(act_scale=act_scale, act_zp=act_zp,
                                   w_scale=w_scale, colsum=colsum)
    return dequant_apply(acc, zp_colsum, sw, bias)


def spatial_mean(x: torch.Tensor, dims: Tuple[int, int] = (1, 2)
                 ) -> torch.Tensor:
    """Mean over the two spatial ``dims`` (NHWC (1, 2), NCHW (2, 3)) — the
    global pool before a quantized fc.  Over an even count of values on one
    grid the mean can sit exactly on a half step of the fc's quantizer,
    where the float32 sum's order decides the rounding, and a parallel
    reduction on the card sums in another order than the CPU.  So an even
    count is summed in one fixed order on every device — row-major, the
    order of PyTorch's CPU sum up to 16 values and of XLA:CPU's at 4×4 and
    8×8 — and divided by the count as a device tensor (a true division on
    CUDA too).  An odd count cannot put the mean on a half step:
    ``torch.mean``."""
    h, w = x.shape[dims[0]], x.shape[dims[1]]
    if (h * w) % 2:
        return torch.mean(x, dim=dims)
    grid = x.movedim(dims, (0, 1))
    acc = grid[0, 0]
    for i in range(h):
        for j in range(w):
            if i or j:
                acc = acc + grid[i, j]
    return acc / torch.full((), float(h * w), dtype=acc.dtype,
                            device=acc.device)
