"""Quantization grids and real quantization (port of qtpu.ops.fakequant).

The serving subset: grid ranges, symmetric and affine scales, per-channel
absolute max, the export scale of the weight quantizer, quantize/dequantize
and the int4 nibble packing of frozen weights.  ``fake_quant`` and PACT with
straight-through gradients come with the training slice (ROADMAP.md).

All arithmetic is float32 in the reference's order, so codes match qtpu's
bit for bit on the same inputs; ``torch.round`` rounds half to even like
``jnp.round``.
"""
from __future__ import annotations

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


def symmetric_scale(amax: Scalar, bits: int) -> torch.Tensor:
    """Scale for a symmetric grid from an absolute-max value."""
    _, qmax = qrange(bits, signed=True, symmetric=True)
    return torch.clamp_min(_f32(amax), 1e-12) / qmax


def affine_qparams(xmin: Scalar, xmax: Scalar, bits: int,
                   signed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine (scale, zero_point) covering ``[xmin, xmax]`` widened to hold 0;
    the zero point is a float already rounded to an integer value."""
    qmin, qmax = qrange(bits, signed=signed, symmetric=False)
    xmin = torch.clamp_max(_f32(xmin), 0.0)
    xmax = torch.clamp_min(_f32(xmax), 0.0)
    scale = torch.clamp_min((xmax - xmin) / (qmax - qmin), 1e-12)
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
