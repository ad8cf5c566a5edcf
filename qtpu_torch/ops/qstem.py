"""The excluded fp32 stem from the input pixels to int8 codes, and ResNet's
3×3/2 max-pool on int8 codes (``csrc/qstem.cu``).

Neither replaces a TPU kernel: qtpu left both to XLA (its flat engines'
fp32 stem conv, ReLU or ReLU6, ``quantize_act`` and the max-pool on codes).
On the card that was cuDNN's fp32 conv and some ten PyTorch elementwise
passes over a float32 map; here the map never reaches device memory.

``stem_fp32_codes`` is the stem's wrapper: on a CUDA tensor it launches the
hand-written kernel (or raises), on a CPU tensor it takes
``stem_fp32_codes_plain``, the sequence the engines ran before: uint8
pixels normalized (``x * a + b``), zero pads, ``F.conv2d`` in full fp32 (on
bf16-rounded operands for the bf16 stem), ``+ b``, ReLU or ReLU6 and
``qops.quantize_act`` onto the first block's grid.  The kernel sums each
output over the taps in the order of cuDNN's fp32 NHWC conv ((kh, kw, ci),
one FMA a tap from 0.0), and its epilogue divides by the scale and rounds
half to even as ``quantize_act`` does, so its codes are the plain path's
on the card, bit for bit.  It takes 7×7/2, 3×3/2 and 3×3/1 windows on up to
four input channels, any Co (zero-padded to a multiple of 8 in the
kernel's weight layout), SAME or explicit pads: every fp32 stem an engine
builds (ResNet ImageNet and CIFAR, MobileNet-v1 and v2).

``maxpool_codes`` is the 3×3/2 max-pool of int8 NHWC codes padded with
−128: on a CUDA tensor the kernel, on a CPU tensor ``maxpool_codes_plain``
(the max of the nine strided window slices).  Integer work: the two are
bit-equal.

Each wrapper counts its launches (``launches``), each plain version its
calls (``calls``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qtpu_torch.ops import _build, qops
from qtpu_torch.utils import debug
from qtpu_torch.utils.device import fp32_exact

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STEM_ARGTYPES = ((_P, _I, _P, _P, _P, _P, _P) + (_I,) * 14 + (_F, _F, _F)
                  + (_I, _I, _I, _P))
_POOL_ARGTYPES = (_P, _P) + (_I,) * 9 + (_P,)
# (KH, KW, stride) the kernel is instantiated for
STEM_WINDOWS = ((7, 7, 2), (3, 3, 2), (3, 3, 1))
MAX_CI = 4
MAX_THREADS = 256
PX = 8           # output columns a thread; the tile is 8·TWG columns wide
TWG = 2
TH_MAX = 16      # output rows a tile at most
SMEM_MAX = 232448  # shared memory a block may use on sm_90


class StemWeights(NamedTuple):
    """An excluded stem's folded conv as both paths take it: ``w_oihw``
    (Co, Ci, KH, KW) for ``F.conv2d`` (the plain path rounds it to bf16
    itself), ``w_taps`` (KH·KW·Ci, COP) tap-major with Co zero-padded to a
    multiple of 8 and, for the bf16 stem, rounded to bf16 and back (the
    kernel's), ``bias`` (Co,) and ``bias_pad`` (COP,)."""
    w_oihw: torch.Tensor
    w_taps: torch.Tensor
    bias: torch.Tensor
    bias_pad: torch.Tensor
    bf16: bool


def prepare_stem(w_hwio: torch.Tensor, bias: torch.Tensor,
                 bf16: bool = False) -> StemWeights:
    """The :class:`StemWeights` of a folded HWIO fp32 weight and its bias."""
    KH, KW, Ci, Co = w_hwio.shape
    cop = -(-Co // 8) * 8
    taps = w_hwio.reshape(KH * KW * Ci, Co).to(torch.float32)
    if bf16:
        taps = taps.to(torch.bfloat16).to(torch.float32)
    w_taps = torch.zeros((KH * KW * Ci, cop), dtype=torch.float32,
                         device=w_hwio.device)
    w_taps[:, :Co] = taps
    bias_pad = torch.zeros(cop, dtype=torch.float32, device=bias.device)
    bias_pad[:Co] = bias
    return StemWeights(w_hwio.permute(3, 2, 0, 1).contiguous(), w_taps,
                       bias, bias_pad, bool(bf16))


class StemPlan(NamedTuple):
    """The kernel's output tile: ``th`` rows × 8·``twg`` columns × every
    channel, and the block's threads, ``twg·th·COP/8``."""
    th: int
    twg: int
    threads: int


def stem_plan(OH: int, cop: int) -> StemPlan:
    """The tile for ``OH`` output rows and ``cop`` padded channels: a
    thread takes 8 columns × 8 channels; 16 columns and up to 16 rows a
    block (fewer where 256 threads cannot hold 16 rows of ``cop``
    channels), the rows spread evenly over the fewest row tiles.
    ResNet-50's and MobileNet's 112² maps take 16 × 16 tiles, on 256 and
    128 threads (the fastest of the 8·twg × th plans timed on an H100 at
    B = 128)."""
    groups = TWG * cop // 8
    if groups > MAX_THREADS:
        raise ValueError(f"stem of {cop} channels: more than "
                         f"{MAX_THREADS * 8 // TWG} the kernel takes")
    th_max = min(TH_MAX, MAX_THREADS // groups)
    th = -(-OH // -(-OH // th_max))
    return StemPlan(th, TWG, TWG * th * cop // 8)


class StemGeometry(NamedTuple):
    """One launch of the stem kernel: the (top, left) pads, the output size
    and the tile plan."""
    pad_t: int
    pad_l: int
    OH: int
    OW: int
    plan: StemPlan


def stem_geometry(x_shape, x_dtype: torch.dtype, sw: StemWeights,
                  strides: Tuple[int, int],
                  padding: qops.Padding) -> StemGeometry:
    """What the kernel runs for an NHWC input of ``x_shape`` and
    ``x_dtype`` with ``sw``, on the tile of :func:`stem_plan`; raises,
    naming the shape, for a geometry it does not take: a window other than
    :data:`STEM_WINDOWS`, unequal strides, more than four input channels,
    an input other than uint8 or float32, more channels than a block's
    threads hold, or a weight and patch beyond a block's shared memory."""
    if len(x_shape) != 4:
        raise ValueError(f"stem input must be NHWC, got {tuple(x_shape)}")
    B, H, W, Ci = x_shape
    Co, Ci_w, KH, KW = sw.w_oihw.shape
    cop = sw.w_taps.shape[1]
    sh, sv = strides
    what = (f"stem {KH}x{KW}/{tuple(strides)} Ci = {Ci_w} Co = {Co} on "
            f"input {tuple(x_shape)} {x_dtype}")
    if (KH, KW, sh) not in STEM_WINDOWS or sh != sv:
        raise ValueError(f"{what}: the stem kernel takes the windows "
                         f"(KH, KW, stride) {STEM_WINDOWS}")
    if Ci != Ci_w or not 1 <= Ci <= MAX_CI:
        raise ValueError(f"{what}: input channels must match the weight's "
                         f"{Ci_w}, at most {MAX_CI}")
    if x_dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{what}: uint8 or float32 input")
    (pt, pb), (pl, pr) = qops.resolve_pads((H, W), (KH, KW), strides,
                                           padding)
    OH = (H + pt + pb - KH) // sh + 1
    OW = (W + pl + pr - KW) // sh + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"{what}: smaller than the window with its pads")
    try:
        plan = stem_plan(OH, cop)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    # the weight, the patch (a float4 a column) and three tables of a row
    pw = (PX * plan.twg - 1) * sh + KW
    smem = 4 * (KH * KW * Ci * cop + ((plan.th - 1) * sh + KH) * pw * 4
                + 3 * pw * Ci)
    if smem > SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block, "
                         f"more than {SMEM_MAX}")
    return StemGeometry(pt, pl, OH, OW, plan)


def _quant_args(grid) -> Tuple[float, float, int]:
    """(scale, zp_u, symmetric) as ``quantize_act`` forms them: zp_u =
    float32(zp) + 128 on the host."""
    scale, zp, sym = grid
    for name, v in (("scale", scale), ("zero point", zp)):
        if isinstance(v, torch.Tensor):
            raise ValueError(f"the stem kernel takes the grid's {name} as a "
                             "host number, not a tensor")
    zp_u = float(np.float32(zp) + np.float32(128))
    return float(np.float32(scale)), zp_u, int(bool(sym))


def stem_fp32_codes(x: torch.Tensor, sw: StemWeights, *,
                    strides: Tuple[int, int], padding: qops.Padding,
                    act_max: Optional[float], grid,
                    norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """int8 codes (B, OH, OW, Co) on ``grid`` — (scale, zp, symmetric) —
    of the excluded stem on NHWC ``x``: uint8 pixels, normalized per
    channel by ``norm`` = (a, b) as ``x * a + b``, or float32 images;
    the conv with ``sw`` at ``strides`` and ``padding`` (pads read 0.0
    after the normalize), ``+ b``, ReLU clamped at ``act_max`` if given,
    then ``quantize_act``."""
    if x.device.type == "cpu":
        return stem_fp32_codes_plain(x, sw, strides=strides, padding=padding,
                                     act_max=act_max, grid=grid, norm=norm)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    debug.check_quant_grid(grid[0], grid[1], what="stem_fp32_codes")
    geo = stem_geometry(x.shape, x.dtype, sw, strides, padding)
    u8 = x.dtype == torch.uint8
    dev = x.device
    tensors = [("x", x), ("w_taps", sw.w_taps), ("bias", sw.bias_pad)]
    if u8:
        if norm is None:
            raise ValueError("uint8 pixels need the normalization")
        tensors += [("norm a", norm[0]), ("norm b", norm[1])]
    for name, t in tensors:
        if not t.is_contiguous() or t.device != dev or (
                t is not x and t.dtype != torch.float32):
            raise ValueError(f"stem_fp32_codes: {name} must be contiguous "
                             f"on {dev} (float32 but for x)")
    B, H, W, Ci = x.shape
    Co, _, KH, KW = sw.w_oihw.shape
    plan = geo.plan
    scale, zp_u, sym = _quant_args(grid)
    out = torch.empty((B, geo.OH, geo.OW, Co), dtype=torch.int8, device=dev)
    fn = _build.load("qstem", "qtpu_stem_fp32_codes", _STEM_ARGTYPES)
    err = _build.launch(
        fn, dev, x.data_ptr(), int(u8), sw.w_taps.data_ptr(),
        sw.bias_pad.data_ptr(), norm[0].data_ptr() if u8 else None,
        norm[1].data_ptr() if u8 else None, out.data_ptr(), B, H, W, Ci,
        geo.OH, geo.OW, Co, sw.w_taps.shape[1], KH, KW, strides[0],
        geo.pad_t, geo.pad_l, int(sw.bf16), scale, zp_u,
        0.0 if act_max is None else float(act_max), sym, plan.th, plan.twg)
    if err:
        raise RuntimeError(f"stem_fp32_codes kernel ({plan}) launch failed: "
                           f"CUDA error {err} (input {tuple(x.shape)} "
                           f"{x.dtype}, {KH}x{KW}/{strides[0]}, Co = {Co})")
    stem_fp32_codes.launches += 1
    return out


stem_fp32_codes.launches = 0


def stem_fp32_codes_plain(x: torch.Tensor, sw: StemWeights, *,
                          strides: Tuple[int, int], padding: qops.Padding,
                          act_max: Optional[float], grid,
                          norm: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`stem_fp32_codes` (same arguments):
    the engines' sequence, step by step."""
    stem_fp32_codes_plain.calls += 1
    if x.dtype == torch.uint8:
        a, b = norm
        x = x.to(torch.float32) * a + b
    w = sw.w_oihw
    pads = qops.resolve_pads(x.shape[1:3], w.shape[2:], strides, padding)
    xp = qops.pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2)
    if sw.bf16:
        xp = xp.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    with fp32_exact():
        y = F.conv2d(xp, w, stride=strides)
    y = y.permute(0, 2, 3, 1) + sw.bias
    y = (torch.clamp_min(y, 0.0) if act_max is None
         else torch.clamp(y, 0.0, act_max))
    scale, zp, sym = grid
    return qops.quantize_act(y, scale, zp, symmetric=sym)


stem_fp32_codes_plain.calls = 0


def _pool_geometry(shape, pads: Sequence[Tuple[int, int]]):
    (pt, pb), (pl, pr) = pads
    H, W = shape[1:3]
    return pt, pl, (H + pt + pb - 3) // 2 + 1, (W + pl + pr - 3) // 2 + 1


def maxpool_codes(y_q: torch.Tensor, pads) -> torch.Tensor:
    """3×3/2 max-pool of int8 NHWC codes with the explicit ``pads``
    ((top, bottom), (left, right)) filled with −128."""
    if y_q.device.type == "cpu":
        return maxpool_codes_plain(y_q, pads)
    if not y_q.is_cuda:
        raise ValueError(f"unsupported device {y_q.device}")
    if y_q.dim() != 4 or y_q.dtype != torch.int8 or not y_q.is_contiguous():
        raise ValueError(f"max-pool input must be contiguous int8 NHWC, got "
                         f"{tuple(y_q.shape)} {y_q.dtype}")
    B, H, W, C = y_q.shape
    pt, pl, OH, OW = _pool_geometry(y_q.shape, pads)
    if OH <= 0 or OW <= 0:
        raise ValueError(f"max-pool input {tuple(y_q.shape)} with pads "
                         f"{pads} is smaller than its 3x3 window")
    out = torch.empty((B, OH, OW, C), dtype=torch.int8, device=y_q.device)
    al = y_q.data_ptr() | out.data_ptr()
    vec = (16 if C % 16 == 0 and al % 16 == 0
           else 4 if C % 4 == 0 and al % 4 == 0 else 1)
    fn = _build.load("qstem", "qtpu_maxpool_codes", _POOL_ARGTYPES)
    err = _build.launch(fn, y_q.device, y_q.data_ptr(), out.data_ptr(), B, H,
                        W, C, OH, OW, pt, pl, vec)
    if err:
        raise RuntimeError(f"maxpool_codes kernel launch failed: CUDA error "
                           f"{err} (x {tuple(y_q.shape)}, pads {pads})")
    maxpool_codes.launches += 1
    return out


maxpool_codes.launches = 0


def maxpool_codes_plain(y_q: torch.Tensor, pads) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxpool_codes`: the max of the nine
    strided window slices of the −128-padded codes."""
    maxpool_codes_plain.calls += 1
    yp = qops.pad_nhwc(y_q, pads, -128)
    Hp, Wp = yp.shape[1:3]
    OH, OW = (Hp - 3) // 2 + 1, (Wp - 3) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            s = yp[:, dy:dy + 2 * (OH - 1) + 1:2, dx:dx + 2 * (OW - 1) + 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


maxpool_codes_plain.calls = 0
