"""Integer-forward QAT conv (port of qtpu/ops/qat_int.py).

The fake-quant simulation computes ``conv(fake_quant(x),
fake_quant_weight(w))`` in fp32; every operand is a grid point, so the
conv is an integer convolution scaled by ``act_scale · w_scale``.
:func:`qat_int_conv` runs it as one: a ``torch.autograd.Function`` whose

* forward quantizes x and w to int8 codes on the fake-quant grids
  (affine codes stored shifted by −128; int4 weights are int8 codes in
  ±7), computes the exact int32 accumulator, and dequantizes with the
  zero-point column-sum term: ``(acc + (128 − zp_u)·colsum) ·
  act_scale·w_scale``;
* backward is qtpu's pass-through STE from the saved codes: dx =
  convᵀ(g, dequant(w_codes)) and dw = wgrad(dequant(x_codes), g), both in
  float32 (``aten.convolution_backward`` on the zero-padded input, no
  primal re-evaluated); the scale and the zero point get zero gradients.

On a CUDA tensor the accumulator runs on the kernels the module SERVE path
routes each conv to (:func:`conv_kind`): a 1×1 stride-1 conv without pads
on K1 (``qmatmul_folded``), any other one-group conv — K×K at stride 1 or
2, the 1×1/2 downsample as a 1×1 window — on K2 (``qconv2d_folded``, the
zero-point pads read in the kernel where its path allows), a depthwise
conv on K3 (``qdepthwise_folded``), each with ``raw_acc=True``; it
launches them or raises.  Every operand is derived from the live weights
at each call (codes, their layouts; K2 computes its ``tapsum``), so an
optimizer step is never trained against stale weights.  On a CPU tensor
the accumulator is the plain version, ``qops.qconv2d``'s exact float64
(depthwise: int32) conv; :func:`qat_int_conv_plain` takes it on any
device, to hold the kernels against it.

The pad value is ``round(zp_u) − 128``, so a padded tap is a real zero on
the grid.  It stays a 0-d int32 on the conv's device, as qtpu traces it:
K2 and K3 read it from device memory, so no step reads the host.  :func:`int_forward_ok` sends clip-STE and PACT specs (their
gradient masks and α need the fake-quant path) to the simulation.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops import qops
from qtpu_torch.ops.qconv import PadCode, qconv2d_folded
from qtpu_torch.ops.qdepthwise import qdepthwise_folded
from qtpu_torch.ops.qmatmul import qmatmul_folded
from qtpu_torch.utils.device import cpu_conv_layout

Padding = Union[str, Sequence[Tuple[int, int]]]
SIGNED_OFFSET = 128   # int8 storage shift of unsigned affine codes


def conv_kind(kernel_hw: Tuple[int, int], stride: Tuple[int, int],
              padding: Padding, groups: int, cin: int, cout: int) -> str:
    """The kernel family of a quantized conv: ``"gemm"`` (K1) for a 1×1
    stride-1 conv without pads, ``"depthwise"`` (K3) for groups = channels,
    ``"conv"`` (K2) for any other one-group conv."""
    if groups != 1:
        if groups == cin == cout:
            return "depthwise"
        raise ValueError(f"grouped conv ({groups} groups of {cin}) has no "
                         "integer kernel")
    no_pads = (isinstance(padding, str) and padding.upper() in
               ("SAME", "VALID")) or all(v == 0 for p in padding for v in p)
    if tuple(kernel_hw) == (1, 1) and tuple(stride) == (1, 1) and no_pads:
        return "gemm"
    return "conv"


def weight_codes(w: torch.Tensor, bits: int, per_channel: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of ``fake_quant_weight`` on an OIHW
    weight: the scale keepdims (O, 1, 1, 1) per channel, 0-d per tensor."""
    scale = fq.weight_qparams(w.detach(), bits=bits,
                              channel_axis=0 if per_channel else None)
    _, qmax = fq.qrange(bits, signed=True, symmetric=True)
    codes = torch.clamp(torch.round(w.detach() / scale), -qmax, qmax)
    return codes.to(torch.int8), scale


def act_codes(x: torch.Tensor, scale: torch.Tensor, zp_u: torch.Tensor,
              bits: int, symmetric: bool) -> torch.Tensor:
    """int8 codes on the fake-quant grid; affine codes shifted by −128."""
    if symmetric:
        _, qmax = fq.qrange(bits, signed=True, symmetric=True)
        return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    q = torch.clamp(torch.round(x / scale + zp_u), 0, (1 << bits) - 1)
    return (q - SIGNED_OFFSET).to(torch.int8)


def _dequant_act(x_s: torch.Tensor, scale: torch.Tensor, zp_u: torch.Tensor,
                 symmetric: bool) -> torch.Tensor:
    if symmetric:
        return x_s.to(torch.float32) * scale
    return (x_s.to(torch.float32) + (SIGNED_OFFSET - zp_u)) * scale


def int_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, *, stride: int,
                  padding: Padding, groups: int,
                  zp: PadCode) -> torch.Tensor:
    """Exact int32 accumulator of int8 NHWC codes with OIHW int8 weights
    (qtpu's ``qops.qconv2d``), on any device; ``zp`` the pad code, an int
    or a 0-d int32 tensor."""
    return qops.qconv2d(x_q, w_q.permute(2, 3, 1, 0), strides=(stride, stride),
                        padding=padding, groups=groups, zp=zp)


def int_acc(x_q: torch.Tensor, w_q: torch.Tensor, *, stride: int,
            padding: Padding, groups: int, zp: PadCode) -> torch.Tensor:
    """The same accumulator: the plain version for a CPU tensor, else K1,
    K2 or K3 by :func:`conv_kind` (K2 and K3 read a tensor ``zp`` from
    device memory; K1's 1×1/1 convs have no pads)."""
    if x_q.device.type == "cpu":
        return int_acc_plain(x_q, w_q, stride=stride, padding=padding,
                             groups=groups, zp=zp)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    B, H, W, Ci = x_q.shape
    Co, _, KH, KW = w_q.shape
    kind = conv_kind((KH, KW), (stride, stride), padding, groups, Ci, Co)
    if kind == "gemm":
        acc = qmatmul_folded(x_q.reshape(-1, Ci), w_q.reshape(Co, Ci), None,
                             None, raw_acc=True)
        return acc.reshape(B, H, W, Co)
    if kind == "depthwise":
        return qdepthwise_folded(
            x_q, w_q.reshape(Co, KH * KW).t().contiguous(), None, None,
            kernel_hw=(KH, KW), stride=stride, padding=padding, zp=zp,
            raw_acc=True)
    pads = qops.resolve_pads((H, W), (KH, KW), (stride, stride), padding)
    return qconv2d_folded(
        x_q, w_q.permute(0, 2, 3, 1).reshape(Co, -1).contiguous(), None,
        None, kernel_hw=(KH, KW), stride=stride, pads=pads, zp=zp,
        raw_acc=True)


AccFn = Callable[..., torch.Tensor]


class _QatIntConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, act_scale, act_zp_u, a_bits: int, w_bits: int,
                per_channel: bool, act_symmetric: bool, stride: int,
                padding: Padding, groups: int, acc_fn: AccFn):
        scale = act_scale.detach().to(torch.float32)
        zp_u = act_zp_u.detach().to(torch.float32)
        w_codes, w_scale = weight_codes(w, w_bits, per_channel)
        x_codes = act_codes(x.detach().permute(0, 2, 3, 1), scale, zp_u,
                            a_bits, act_symmetric).contiguous()
        # the pad code stays a 0-d int32 on the device (qtpu traces it):
        # no host read, so the step can be one CUDA graph
        pad_zp = (0 if act_symmetric else
                  (torch.round(zp_u) - SIGNED_OFFSET).to(torch.int32))
        acc = acc_fn(x_codes, w_codes, stride=stride, padding=padding,
                     groups=groups, zp=pad_zp)
        w_scale_o = w_scale.reshape(-1) if per_channel else w_scale
        if act_symmetric:
            y = acc.to(torch.float32) * (scale * w_scale_o)
        else:
            colsum = w_codes.sum(dim=(1, 2, 3), dtype=torch.int32)
            y = ((acc.to(torch.float32) + (SIGNED_OFFSET - zp_u) * colsum)
                 * (scale * w_scale_o))
        ctx.save_for_backward(x_codes, w_codes, scale, zp_u, w_scale)
        ctx.geometry = (act_symmetric, stride, padding, groups)
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        x_codes, w_codes, scale, zp_u, w_scale = ctx.saved_tensors
        act_symmetric, stride, padding, groups = ctx.geometry
        x_deq = _dequant_act(x_codes, scale, zp_u,
                             act_symmetric).permute(0, 3, 1, 2)
        w_deq = w_codes.to(torch.float32) * w_scale
        H, W = x_deq.shape[2:]
        (pt, pb), (pl, pr) = qops.resolve_pads((H, W), w_deq.shape[2:],
                                               (stride, stride), padding)
        xp = cpu_conv_layout(torch.nn.functional.pad(x_deq,
                                                     (pl, pr, pt, pb)))
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            g.contiguous(), xp, w_deq, None, [stride, stride], [0, 0],
            [1, 1], False, [0, 0], groups,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        dx = None if dxp is None else dxp[:, :, pt:pt + H, pl:pl + W]
        zero = (lambda i, t: torch.zeros_like(t)
                if ctx.needs_input_grad[i] else None)
        return (dx, dw, zero(2, scale), zero(3, zp_u)) + (None,) * 8


def _apply(x, w, act_scale, act_zp_u, acc_fn, *, a_bits, w_bits,
           per_channel, act_symmetric, strides, padding, groups):
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    act_scale, act_zp_u = fq._on(act_scale, x), fq._on(act_zp_u, x)
    return _QatIntConv.apply(x, w, act_scale, act_zp_u, a_bits, w_bits,
                             per_channel, act_symmetric, int(strides[0]),
                             padding, groups, acc_fn)


def qat_int_conv(x: torch.Tensor, w: torch.Tensor, act_scale, act_zp_u, *,
                 a_bits: int = 8, w_bits: int = 8, per_channel: bool = True,
                 act_symmetric: bool = False,
                 strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
                 groups: int = 1) -> torch.Tensor:
    """``conv(fake_quant(x), fake_quant_weight(w))`` of an NCHW ``x`` and an
    OIHW ``w`` on the integer kernels (NCHW out).  ``act_zp_u`` is the
    zero point on the unsigned grid (``fakequant.affine_qparams``'s);
    ignored for symmetric activations."""
    return _apply(x, w, act_scale, act_zp_u, int_acc, a_bits=a_bits,
                  w_bits=w_bits, per_channel=per_channel,
                  act_symmetric=act_symmetric, strides=strides,
                  padding=padding, groups=groups)


def qat_int_conv_plain(x: torch.Tensor, w: torch.Tensor, act_scale,
                       act_zp_u, **kw) -> torch.Tensor:
    """:func:`qat_int_conv` with the plain accumulator on any device (the
    same arguments)."""
    return _apply(x, w, act_scale, act_zp_u, int_acc_plain,
                  **{**dict(a_bits=8, w_bits=8, per_channel=True,
                            act_symmetric=False, strides=(1, 1),
                            padding="SAME", groups=1), **kw})


def int_forward_ok(spec, mode) -> bool:
    """Whether a layer's spec and mode can take the integer forward."""
    return (spec is not None and mode is not None and mode.quantizes
            and spec.ste == "passthrough" and spec.act_observer != "pact"
            and spec.quantize_weights and spec.quantize_acts)
