"""The module SERVE path (port of the SERVE branches of qtpu/nn/layers.py —
``_serve_vars``/``_serve_weight``/``_serve_epilogue``, ``QuantDense``,
``QuantConv`` and ``ConvBN`` in ``QuantMode.SERVE`` — and of the
``serve_model`` that qtpu's ``freeze`` returns).

qtpu serves a config the flat engines cannot take (LeNet-5, or excludes
beyond stem/fc) with its own model in SERVE mode: every quantized layer
quantizes its f32 input onto its frozen grid, runs the integer conv or
matmul to the int32 accumulator and closes with ``dequant_epilogue``, then
its activation; everything else — excluded layers, pools, residual adds,
flatten — is the fp32 model.  :func:`serve_model` builds that model here:
the fp32 module with each quantized layer replaced by a
:class:`ServeLayer` over its frozen node, prepared once by
``fused_ops.prepare_node``, and the excluded layers' fp32 weights loaded
from the tree's ``params``/``batch_stats`` (strict both ways).

A :class:`ServeLayer` picks its kernel by shape, each launched with
``raw_acc=True`` (the int32 accumulator of qtpu's ``qops.qmatmul`` /
``qops.qconv2d``):

* a dense layer, or a 1×1 stride-1 conv without pads → K1
  (``qmatmul_folded``);
* any other conv with one group — K×K at stride 1 or 2, and the 1×1
  stride-2 downsample as a 1×1 window (read at its stride by the kernel,
  no strided copy) → K2 (``qconv2d_folded``, the zero-point pads and
  ``tapsum`` read in the kernel where its path allows);
* a depthwise conv → K3 (``qdepthwise_folded``).

A node sliced by ``parallel.mesh.shard_variables`` runs this rank's output
channels and gathers them over the ``model`` group after its activation
(a depthwise one reads only its own input channels).

The convs keep the model's NCHW interface: a layer takes and returns NCHW
tensors whose memory is channels-last (the NHWC input permuted), so its
own permutes are views and the int8 codes it quantizes are already the
kernels' NHWC layout.  The excluded fp32 layers run with TF32 off
(:class:`ServeModel` wraps the forward in ``fp32_exact``).  On the CPU the
kernels take their plain versions; on the card each launches or raises.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Union

import torch
import torch.nn as nn

from qtpu_torch.models import get_model
from qtpu_torch.nn.config import LayerQuantSpec, QuantPolicy
from qtpu_torch.nn.layers import flax_taker, layer_paths, load_layer
from qtpu_torch.ops import qops
from qtpu_torch.ops.qat_int import conv_kind
from qtpu_torch.ops.qmatmul import qmatmul_folded
from qtpu_torch.serve import fused_ops
from qtpu_torch.utils.device import fp32_exact, resolve_device

KINDS = ("dense", "gemm", "conv", "depthwise")


def kind_of(m: nn.Module) -> str:
    """The kernel family a quantized layer's SERVE forward runs: ``dense``
    and ``gemm`` (K1), ``conv`` (K2), ``depthwise`` (K3) — the routing of
    the integer-forward QAT conv too (``ops.qat_int.conv_kind``)."""
    if isinstance(m, nn.Linear):
        return "dense"
    conv = m.conv
    return conv_kind(m.kernel, m.stride, m.padding, m.groups,
                     conv.in_channels, conv.out_channels)


class ServeLayer(nn.Module):
    """One quantized layer in SERVE mode over its frozen node: quantize the
    input onto the node's grid (affine or symmetric, from ``act_sym``), the
    kernel's int32 accumulator, ``dequant_epilogue`` (its per-channel
    ``act_zp·colsum`` and ``act_scale·w_scale`` computed once, in
    :meth:`of`), the activation."""

    def __init__(self, node: Dict[str, Any], kind: str, *, bits: int = 8,
                 stride=(1, 1), padding="SAME", act: Optional[str] = None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"kind {kind!r} not in {KINDS}")
        self.node, self.kind, self.bits = node, kind, bits
        self.stride, self.padding, self.act = stride, padding, act

    @classmethod
    def of(cls, m: nn.Module, node: Mapping[str, Any], spec: LayerQuantSpec,
           device: torch.device) -> "ServeLayer":
        """The serve layer replacing the fp32 layer ``m``."""
        kind = kind_of(m)
        prepared = fused_ops.prepare_node(dict(node), device,
                                          depthwise=kind == "depthwise")
        g = prepared["grid"]
        prepared["zp_colsum"], prepared["sw"] = qops.dequant_coeffs(
            act_scale=g.scale, act_zp=g.zp, w_scale=prepared["w_scale"],
            colsum=prepared["colsum"])
        if kind == "dense":
            return cls(prepared, kind, bits=spec.a_bits)
        return cls(prepared, kind, bits=spec.a_bits, stride=m.stride,
                   padding=m.padding, act=getattr(m, "act", None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        node, g = self.node, self.node["grid"]
        dense = self.kind == "dense"
        xh = x if dense else x.permute(0, 2, 3, 1)
        x_q = qops.quantize_act(xh, g.scale, g.zp, bits=self.bits,
                                symmetric=g.sym).contiguous()
        if dense:
            acc = qmatmul_folded(x_q, node["w_nk"], None, None,
                                 raw_acc=True)
        elif self.kind == "gemm":
            acc = fused_ops.gemm_1x1(x_q, node, raw_acc=True)
        elif self.kind == "conv":
            acc = fused_ops.conv(x_q, node, strides=self.stride,
                                 padding=self.padding, raw_acc=True)
        else:
            acc = fused_ops.depthwise(x_q, node, strides=self.stride,
                                      padding=self.padding, raw_acc=True)
        y = qops.dequant_apply(acc, node["zp_colsum"], node["sw"],
                               node["bias"])
        if self.act is not None:
            y = torch.relu(y)
            if self.act == "relu6":
                y = torch.clamp_max(y, 6.0)
        y = fused_ops.tp_gather(y, node)
        return y if dense else y.permute(0, 3, 1, 2)


class ServeModel(nn.Module):
    """The model in SERVE mode: ``model(x)`` maps f32 NHWC images to logits
    on its device.  ``kinds``: each quantized layer's path → kernel
    family."""

    def __init__(self, net: nn.Module, kinds: Dict[str, str],
                 device: torch.device):
        super().__init__()
        self.net, self.kinds, self.device = net, kinds, device

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_exact():
            return self.net(torch.as_tensor(x).to(self.device))


def _node_at(tree: Mapping, path: str) -> Optional[Mapping]:
    node = tree
    for k in path.split("/"):
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


def serve_model(model: Union[str, nn.Module], policy: QuantPolicy,
                tree: Mapping[str, Any], device=None,
                **model_kwargs) -> ServeModel:
    """The SERVE-mode model of a frozen ``tree``: ``model`` is a model name
    (built by ``get_model(model, **model_kwargs)``) or an fp32 module (a
    copy is taken); every quantized layer (``layer_paths`` ∩
    ``policy.spec_for``) becomes a :class:`ServeLayer` over its
    ``qweights`` node, every excluded one is filled from ``params`` /
    ``batch_stats``.  ``device``: ``None`` means the card."""
    dev = resolve_device(device)
    net = (get_model(model, **model_kwargs) if isinstance(model, str)
           else copy.deepcopy(model))
    take, used, src = flax_taker(tree.get("params", {}),
                                 tree.get("batch_stats", {}))
    kinds = {}
    for path, m in layer_paths(net).items():
        spec = policy.spec_for(path)
        if spec is None:
            load_layer(m, path, take)
            continue
        node = _node_at(tree["qweights"], path)
        if node is None or "kernel_q" not in node:
            raise KeyError(f"the frozen tree has no qweights node for the "
                           f"quantized layer {path}")
        layer = ServeLayer.of(m, node, spec, dev)
        parent, _, name = path.replace("/", ".").rpartition(".")
        setattr(net.get_submodule(parent) if parent else net, name, layer)
        kinds[path] = layer.kind
    left = sorted(f"{c}/{p}" for (c, p) in src if (c, p) not in used)
    if left:
        raise ValueError(f"fp32 variables of no excluded layer: {left}")
    return ServeModel(net.to(dev).eval(), kinds, dev)
