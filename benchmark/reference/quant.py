"""The integer arithmetic of the plain reference: grids, weight codes, the
folded epilogue, exact accumulators, padding and pooling.

A frozen copy of plain code, written out again so that the reference
imports nothing of the system under test.  The rules it follows are the
published ones of affine int8 inference (Jacob et al., "Quantization and
Training of Neural Networks for Efficient Integer-Arithmetic-Only
Inference", 2018) in the operation order the configuration states:

* activations on an unsigned 8-bit affine grid, ``q = clip(round(x / s +
  zp_u), 0, 255) − 128`` (round half to even), scale and zero point from
  the observed range widened to hold 0;
* weights symmetric per output channel, ``round(w / (max|w| / 127))``;
* a layer's int32 accumulator is exact (int8 products summed in float64,
  where every partial sum is an integer below 2^53);
* dequant, bias, residual, ReLU and requant folded into ``clip(round(acc·A
  + B [+ r·C]), lo, hi) − shift``, each float32 step rounded on its own.

Every float32 division divides by a device tensor: a Python scalar would
turn it into a multiply by the reciprocal on the card.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def fdiv(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true float32 division on ``a``'s device."""
    return a / torch.full((), float(b), dtype=torch.float32, device=a.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


@contextlib.contextmanager
def fp32_exact():
    """float32 convolutions and matmuls in full float32: no TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- grids -------------------------------------------------------------------

def symmetric_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    return fdiv(torch.clamp_min(amax.to(torch.float32), 1e-12), qmax)


def affine_grid(xmin: torch.Tensor, xmax: torch.Tensor, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, unsigned zero point) of the grid over ``[xmin, xmax]``
    widened to hold 0."""
    qmax = (1 << bits) - 1
    lo = torch.clamp_max(xmin.to(torch.float32), 0.0)
    hi = torch.clamp_min(xmax.to(torch.float32), 0.0)
    scale = torch.clamp_min(fdiv(hi - lo, qmax), 1e-12)
    zp = torch.clamp(torch.round(0 - lo / scale), 0, qmax)
    return scale, zp


class Grid(NamedTuple):
    """An activation grid: float32 scale, signed zero point (Python)."""
    scale: float
    zp: int


def grid_from_range(xmin: torch.Tensor, xmax: torch.Tensor) -> Grid:
    scale, zp_u = affine_grid(xmin, xmax, 8)
    return Grid(float(np.float32(scale.item())), int(zp_u.item()) - 128)


def weight_codes(w: torch.Tensor, bits: int, axis: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes as int8, per-channel scale (C,)) of float32 ``w``, symmetric
    per channel along ``axis``."""
    axes = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    amax = torch.amax(torch.abs(w), dim=axes, keepdim=True)
    scale = symmetric_scale(amax, bits)
    qmax = (1 << (bits - 1)) - 1
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w / scale + zero), -qmax, qmax)
    return q.to(torch.int8), scale.reshape(-1)


def quantize_act(x: torch.Tensor, g: Grid) -> torch.Tensor:
    """float32 → int8 codes on ``g``."""
    s = torch.full((), g.scale, dtype=torch.float32, device=x.device)
    zp_u = float(np.float32(g.zp) + np.float32(128))
    q = torch.clamp(torch.round(x / s + zp_u), 0, 255) - 128
    return q.to(torch.int8)


def dequant(x_q: torch.Tensor, g: Grid) -> torch.Tensor:
    return (x_q.to(torch.float32) - float(g.zp)) * g.scale


# -- the folded epilogue -----------------------------------------------------

class Epilogue(NamedTuple):
    A: torch.Tensor
    B: torch.Tensor
    C: float
    lo: float
    hi: float
    requant: bool
    relu: bool
    act_max: Optional[float]


def epilogue(*, x_grid: Grid, w_scale: torch.Tensor, colsum: torch.Tensor,
             bias: torch.Tensor, out_grid: Optional[Grid] = None,
             relu: bool = False, act_max: Optional[float] = None,
             res_grid: Optional[Grid] = None, res_f32: bool = False
             ) -> Epilogue:
    """Coefficients of ``clip(round(acc·A + B + r·C), lo, hi) − 128`` onto
    ``out_grid``, or with ``out_grid`` None the float32 form ``acc·A + B +
    r·C`` (then ReLU, then ``min(·, act_max)``)."""
    A0 = w_scale.to(torch.float32) * float(np.float32(x_grid.scale))
    zc = (colsum.to(torch.int32) * int(x_grid.zp)).to(torch.float32)
    B0 = -A0 * zc + bias.to(torch.float32)
    if out_grid is None:
        C = np.float32(1.0)
        if res_grid is not None:
            C = np.float32(res_grid.scale)
            B0 = B0 - float(np.float32(res_grid.zp) * C)
        return Epilogue(A0, B0, float(C), 0.0, 0.0, False, relu, act_max)
    inv = np.float32(1.0) / np.maximum(np.float32(out_grid.scale),
                                       np.float32(1e-12))
    A = A0 * float(inv)
    B = B0 * float(inv)
    if res_f32:
        C = inv
    elif res_grid is not None:
        C = np.float32(res_grid.scale) * inv
        B = B - float(np.float32(res_grid.zp) * C)
    else:
        C = np.float32(0.0)
    zp_u = np.float32(out_grid.zp) + np.float32(128.0)
    B = B + float(zp_u)
    lo = zp_u if relu else np.float32(0.0)
    hi = np.float32(255.0)
    if act_max is not None:
        hi = np.minimum(hi, np.round(np.float32(act_max) * inv + zp_u))
    return Epilogue(A, B, float(C), float(lo), float(hi), True, relu,
                    act_max)


def apply(acc: torch.Tensor, e: Epilogue,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    t = acc.to(torch.float32) * e.A + e.B
    if residual is not None:
        t = t + residual.to(torch.float32) * e.C
    if e.requant:
        return (torch.clamp(torch.round(t), e.lo, e.hi) - 128.0).to(
            torch.int8)
    if e.relu:
        t = torch.clamp_min(t, 0.0)
    if e.act_max is not None:
        t = torch.clamp_max(t, float(np.float32(e.act_max)))
    return t


# -- geometry and exact accumulators ----------------------------------------

def same_pads(in_hw: Sequence[int], window: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """XLA's SAME padding: lo = total // 2."""
    pads = []
    for n, w, s in zip(in_hw, window, strides):
        out = -(-n // s)
        total = max((out - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def pad_nhwc(x: torch.Tensor, pads, value) -> torch.Tensor:
    (hlo, hhi), (wlo, whi) = pads
    if not (hlo or hhi or wlo or whi):
        return x
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=value)


def conv_acc(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
             zp: int) -> torch.Tensor:
    """Exact int32 accumulator of a SAME conv of int8 NHWC ``x_q`` (padded
    with the zero point ``zp``) with the HWIO int8 ``w_q``."""
    KH, KW, Ci, Co = w_q.shape
    xp = pad_nhwc(x_q, same_pads(x_q.shape[1:3], (KH, KW), (stride,) * 2),
                  int(zp))
    B, Hp, Wp, _ = xp.shape
    OH, OW = (Hp - KH) // stride + 1, (Wp - KW) // stride + 1
    acc = torch.zeros((B * OH * OW, Co), dtype=torch.float64,
                      device=x_q.device)
    wd = w_q.to(torch.float64)
    for kh in range(KH):
        for kw in range(KW):
            tap = xp[:, kh:kh + (OH - 1) * stride + 1:stride,
                     kw:kw + (OW - 1) * stride + 1:stride, :]
            acc += tap.reshape(-1, Ci).to(torch.float64) @ wd[kh, kw]
    return acc.to(torch.int32).reshape(B, OH, OW, Co)


def depthwise_acc(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                  zp: int) -> torch.Tensor:
    """Exact int32 accumulator of a SAME depthwise conv, (KH, KW, 1, C)
    weight, pads of ``zp``."""
    KH, KW, _, C = w_q.shape
    xp = pad_nhwc(x_q, same_pads(x_q.shape[1:3], (KH, KW), (stride,) * 2),
                  int(zp))
    B, Hp, Wp, _ = xp.shape
    OH, OW = (Hp - KH) // stride + 1, (Wp - KW) // stride + 1
    acc = torch.zeros((B, OH, OW, C), dtype=torch.int32, device=x_q.device)
    wi = w_q.to(torch.int32)
    for kh in range(KH):
        for kw in range(KW):
            tap = xp[:, kh:kh + (OH - 1) * stride + 1:stride,
                     kw:kw + (OW - 1) * stride + 1:stride, :]
            acc += tap.to(torch.int32) * wi[kh, kw, 0]
    return acc


def matmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 (…, K) × (K, N) accumulator."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def fp32_conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, stride: int,
                   groups: int = 1) -> torch.Tensor:
    """A float32 SAME conv of NCHW ``x`` (the fp32 model's layout), no
    TF32."""
    kh, kw = w_oihw.shape[2:]
    (hlo, hhi), (wlo, whi) = same_pads(x.shape[2:], (kh, kw), (stride,) * 2)
    xp = F.pad(x, (wlo, whi, hlo, hhi))
    with fp32_exact():
        return F.conv2d(xp, w_oihw, stride=stride, groups=groups)


def bn_eval(y: torch.Tensor, bn: dict, eps: float) -> torch.Tensor:
    """BatchNorm on its running statistics, NCHW."""
    v = (-1, 1, 1)
    return ((y - bn["mean"].view(v)) / sqrt_rn(bn["var"].view(v) + eps)
            * bn["gamma"].view(v) + bn["beta"].view(v))


def fold_bn(w_oihw: torch.Tensor, bn: dict, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(HWIO weight, bias) with the BatchNorm folded in."""
    sigma = sqrt_rn(bn["var"] + eps)
    w = w_oihw.to(torch.float32).permute(2, 3, 1, 0) * (bn["gamma"] / sigma)
    b = bn["beta"] - bn["gamma"] * bn["mean"] / sigma
    return w, b


# -- frozen nodes ------------------------------------------------------------
# A node: {"w": int8 codes (HWIO conv, (KH, KW, 1, C) depthwise, (in, out)
# fc), "w_scale": (C,), "colsum": int32 (C,), "bias": float32 (C,), "grid":
# the layer's input Grid}; an excluded float32 stem: {"w_oihw", "b"}.

def node_epilogue(node: dict, *, out_grid: Optional[Grid] = None,
                  relu: bool = False, act_max: Optional[float] = None,
                  res_grid: Optional[Grid] = None,
                  res_f32: bool = False) -> Epilogue:
    return epilogue(x_grid=node["grid"], w_scale=node["w_scale"],
                    colsum=node["colsum"], bias=node["bias"],
                    out_grid=out_grid, relu=relu, act_max=act_max,
                    res_grid=res_grid, res_f32=res_f32)


def stem_fp32(node: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The excluded stem: a float32 SAME conv of NHWC ``x`` with the folded
    weight, bias added; NHWC out, before the activation."""
    w = node["w_oihw"]
    pads = same_pads(x.shape[1:3], w.shape[2:], (stride, stride))
    xp = pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2)
    with fp32_exact():
        y = F.conv2d(xp, w, stride=(stride, stride))
    return y.permute(0, 2, 3, 1) + node["b"]


def fc_int8(node: dict, pooled: torch.Tensor) -> torch.Tensor:
    """The quantized fc: codes of ``pooled`` on its grid, the exact
    accumulator, ``(acc − zp·colsum)·(s_x·s_w) + b``."""
    g = node["grid"]
    acc = matmul_acc(quantize_act(pooled, g), node["w"])
    sw = node["w_scale"] * float(np.float32(g.scale))
    return (acc - int(g.zp) * node["colsum"]).to(torch.float32) * sw \
        + node["bias"]
