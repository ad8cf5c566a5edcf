"""Quantization grids, fake quantization with straight-through gradients,
and real quantization (port of qtpu.ops.fakequant).

Grid ranges, symmetric and affine scales, per-channel absolute max, the
export scale of the weight quantizer, quantize/dequantize and the int4
nibble packing of frozen weights; and the QAT quantizers
:func:`fake_quant` (pass-through or clip STE), :func:`fake_quant_pact`
(PACT's learnable clip α) and :func:`fake_quant_weight` (the scale
recomputed from the live weights).  No gradient flows into a scale or a
zero point.

All arithmetic is float32 in the reference's order, so codes match qtpu's
bit for bit on the same inputs; ``torch.round`` rounds half to even like
``jnp.round``.  Every division is by a tensor on the operand's device: on
CUDA, PyTorch turns a division by a host scalar into a multiplication by
its reciprocal, which is another float32 number.
"""
from __future__ import annotations

import numbers
from typing import Optional, Tuple, Union

import torch

Scalar = Union[float, int, torch.Tensor]


def qrange(bits: int, signed: bool = True, symmetric: bool = True
           ) -> Tuple[int, int]:
    """Integer range of a ``bits``-wide grid (symmetric signed grids use the
    restricted range ``[-(2^(b-1)-1), 2^(b-1)-1]``)."""
    if signed:
        qmax = (1 << (bits - 1)) - 1
        qmin = -qmax if symmetric else -(1 << (bits - 1))
    else:
        qmin, qmax = 0, (1 << bits) - 1
    return qmin, qmax


def _f32(v: Scalar) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true float32 division on ``a``'s device (by a filled
    device tensor: no host-to-device copy, which a CUDA graph refuses)."""
    return a / torch.full((), float(b), dtype=torch.float32, device=a.device)


def symmetric_scale(amax: Scalar, bits: int) -> torch.Tensor:
    """Scale for a symmetric grid from an absolute-max value."""
    _, qmax = qrange(bits, signed=True, symmetric=True)
    return _div(torch.clamp_min(_f32(amax), 1e-12), qmax)


def affine_qparams(xmin: Scalar, xmax: Scalar, bits: int,
                   signed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine (scale, zero_point) covering ``[xmin, xmax]`` widened to hold 0;
    the zero point is a float already rounded to an integer value."""
    qmin, qmax = qrange(bits, signed=signed, symmetric=False)
    xmin = torch.clamp_max(_f32(xmin), 0.0)
    xmax = torch.clamp_min(_f32(xmax), 0.0)
    scale = torch.clamp_min(_div(xmax - xmin, qmax - qmin), 1e-12)
    zp = torch.clamp(torch.round(qmin - xmin / scale), qmin, qmax)
    return scale, zp


def channel_amax(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Per-channel absolute max, keepdims so the result broadcasts against x."""
    axes = tuple(i for i in range(x.dim()) if i != channel_axis % x.dim())
    return torch.amax(torch.abs(x), dim=axes, keepdim=True)


def weight_qparams(w: torch.Tensor, *, bits: int = 8,
                   channel_axis: Optional[int] = None) -> torch.Tensor:
    """The symmetric weight scale ``max|W| / (2^(b-1)-1)`` (per tensor or per
    channel, keepdims)."""
    amax = (torch.amax(torch.abs(w)) if channel_axis is None
            else channel_amax(w, channel_axis))
    return symmetric_scale(amax, bits)


def _quantize_to_grid(x, scale, zero_point, qmin: int, qmax: int):
    return torch.clamp(torch.round(x / scale + zero_point), qmin, qmax)


def _on(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device (a tensor keeps its
    autograd); a number is filled there (no host-to-device copy, which a
    CUDA graph refuses)."""
    if isinstance(v, numbers.Number):
        return torch.full((), float(v), dtype=torch.float32,
                          device=like.device)
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def fake_quant(x: torch.Tensor, scale: Scalar, zero_point: Scalar = 0.0, *,
               bits: int = 8, signed: bool = True, symmetric: bool = True,
               ste: str = "passthrough") -> torch.Tensor:
    """``dequantize(quantize(x))`` with a straight-through gradient:
    ``"passthrough"`` d/dx = 1 everywhere, ``"clip"`` 1 where ``x / scale
    + zero_point`` lies in the grid's range and 0 outside.  ``scale`` and
    ``zero_point`` broadcast against ``x`` and get no gradient."""
    if ste not in ("passthrough", "clip"):
        raise ValueError(f"unknown ste {ste!r}")
    qmin, qmax = qrange(bits, signed=signed, symmetric=symmetric)
    scale, zero_point = _on(scale, x).detach(), _on(zero_point, x).detach()
    q = _quantize_to_grid(x, scale, zero_point, qmin, qmax)
    xq = (q - zero_point) * scale
    if ste == "passthrough":
        return x + (xq - x).detach()
    t = x / scale + zero_point
    inside = (t >= qmin) & (t <= qmax)
    return torch.where(inside, x + (xq - x).detach(), xq.detach())


class _Balanced(torch.autograd.Function):
    """``max(a, b)`` (or ``min``) with JAX's gradient: the larger (smaller)
    operand takes it all, and at a tie each takes half."""

    @staticmethod
    def forward(ctx, a, b, is_max: bool):
        ctx.save_for_backward(a, b)
        ctx.is_max = is_max
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        wins = a > b if ctx.is_max else a < b
        loses = a < b if ctx.is_max else a > b
        wa = torch.where(wins, 1.0, torch.where(loses, 0.0, 0.5))
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g * wa).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = (g * (1.0 - wa)).sum_to_size(b.shape)
        return ga, gb, None


def fake_quant_pact(x: torch.Tensor, alpha: torch.Tensor, *, bits: int = 8,
                    ste: str = "passthrough") -> torch.Tensor:
    """PACT: ``clip(x, 0, α)`` with a learnable α, fake-quantized on the
    unsigned grid over ``[0, α]`` (zero point 0).  α's gradient is the
    paper's ``1{x ≥ α}`` from the clip, with qtpu's gradients at ties
    (``jnp.clip`` and ``jnp.maximum``): x = 0 and x = α pass half to x,
    and x = α half to α; the grid's scale takes none."""
    _, qmax = qrange(bits, signed=False, symmetric=False)
    alpha = _on(alpha, x)
    alpha = _Balanced.apply(alpha, torch.full_like(alpha, 1e-6), True)
    yc = _Balanced.apply(_Balanced.apply(x, torch.zeros_like(alpha), True),
                         alpha, False)
    return fake_quant(yc, _div(alpha.detach(), qmax), 0.0, bits=bits,
                      signed=False, symmetric=False, ste=ste)


def fake_quant_weight(w: torch.Tensor, *, bits: int = 8,
                      channel_axis: Optional[int] = None,
                      ste: str = "passthrough") -> torch.Tensor:
    """Symmetric weight fake-quant with the scale ``max|W| / (2^(b-1)-1)``
    recomputed from the live weights (per tensor, or per channel along
    ``channel_axis``), as the reference's weight pre-hook."""
    scale = weight_qparams(w.detach(), bits=bits, channel_axis=channel_axis)
    return fake_quant(w, scale, 0.0, bits=bits, signed=True, symmetric=True,
                      ste=ste)


def quantize(x: torch.Tensor, scale: Scalar, zero_point: Scalar = 0.0, *,
             bits: int = 8, signed: bool = True, symmetric: bool = True
             ) -> torch.Tensor:
    """Quantize to an integer tensor (int8 storage for int8 and int4)."""
    qmin, qmax = qrange(bits, signed=signed, symmetric=symmetric)
    dev = x.device
    q = _quantize_to_grid(x.to(torch.float32), _f32(scale).to(dev),
                          _f32(zero_point).to(dev), qmin, qmax)
    return q.to(torch.int8 if signed else torch.uint8)


def dequantize(q: torch.Tensor, scale: Scalar, zero_point: Scalar = 0.0
               ) -> torch.Tensor:
    return (q.to(torch.float32) - zero_point) * scale


def pack_int4(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int8-held int4 values ([-7, 7]) into nibbles along ``axis``:
    low nibble = even index, high nibble = odd index."""
    axis = axis % q.dim()
    n = q.shape[axis]
    if n % 2:
        raise ValueError(f"pack axis length must be even, got {n}")
    qt = q.movedim(axis, -1)
    lo, hi = qt[..., 0::2], qt[..., 1::2]
    packed = ((lo & 0x0F) | (hi << 4)).to(torch.int8)
    return packed.movedim(-1, axis).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 nibbles → int8 tensor of int4 values."""
    axis = axis % packed.dim()
    lo = (packed << 4) >> 4                   # sign-extend the low nibble
    hi = packed >> 4                          # arithmetic shift: high nibble
    stacked = torch.stack([lo, hi], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)
