"""Conv building blocks, their quantization-aware forms, and the qtpu
weight carrier (port of ``QuantDense``, ``QuantConv`` and ``ConvBN`` of
qtpu/nn/layers.py).

``ConvBN`` is a bias-free conv (``groups=C`` makes it depthwise), BatchNorm
with qtpu's formula ``(y − mean) / sqrt(var + eps) · γ + β``, then an
optional activation: ``None``, ``"relu"`` or ``"relu6"`` (``min(max(y,
0), 6)``).  Inputs are NCHW inside the models; SAME pads asymmetrically
(lo = total//2) as XLA does, explicit pads are taken as given.  ``Conv`` is
the bias conv without BatchNorm (qtpu's ``QuantConv``, LeNet-5's layers):
the conv, then ``+ bias`` as a separate add, with the same pads.
``QuantDense`` is the fully-connected layer, an ``nn.Linear``.

A layer without a policy runs fp32: BatchNorm on its running statistics in
eval (the forward calibration and freeze use), and in training on the
batch's mean and *biased* variance (``jnp.var``'s), updating the running
statistics as ``0.9·running + 0.1·batch``; inside
``parallel.collectives.synced_batch`` (the data-parallel trainer) the
batch statistics are those of the global batch.  ``transform.convert_model``
attaches a :class:`~qtpu_torch.nn.config.QuantPolicy` (``quant``), each
layer's spec and an :class:`~qtpu_torch.nn.act_quant.ActQuant` ``in_q``.
In a quantizing mode the input is fake-quantized by ``in_q`` and the
weights by ``fake_quant_weight`` (per output channel: OIHW axis 0, (out,
in) axis 0); a conv with ``qat_forward="int"`` takes
``ops.qat_int.qat_int_conv`` instead where ``int_forward_ok`` allows (the
dense layer always takes the simulation, as qtpu's).  ``ConvBN`` with
``fold_bn`` folds BatchNorm into the quantized conv: in training with
``fake_bn="exact"`` an fp32 statistics conv on the unquantized input
gives the batch statistics and the weights are folded by the batch σ;
with ``"approx"`` the weights are folded by the running σ, the output
un-scaled by the fold factor, then batch-statistics BatchNorm; in eval
the fold uses the running statistics.  Without ``fold_bn`` the quantized
conv is followed by BatchNorm unfolded.  Gradients flow through the batch
mean and variance, as in qtpu.

``layer_paths`` names every quantizable layer (ConvBN, Conv or Linear) by
qtpu's "/"-joined path.  ``load_flax_variables`` copies qtpu's ``params``
/ ``batch_stats`` in — conv kernels HWIO → OIHW (a depthwise (3, 3, 1, C)
becomes (C, 1, 3, 3)) and dense kernels (in, out) → (out, in), the
inverse of qtpu/data/import_torch.py — and, into a converted model, its
``quant_stats``, ``quant_params`` and ``params/…/in_q/pact_alpha``.  It is
strict both ways.  ``load_layer`` fills one layer the same way (the module
SERVE path loads its excluded layers with it).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.nn.act_quant import ActQuant
from qtpu_torch.nn.config import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops.qat_int import int_forward_ok, qat_int_conv
from qtpu_torch.ops.qops import resolve_pads
from qtpu_torch.parallel import collectives
from qtpu_torch.utils.device import cpu_conv_layout

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
Padding = Union[str, Sequence[Tuple[int, int]]]
ACTIVATIONS = (None, "relu", "relu6")


def pad3(torch_pad: bool) -> Padding:
    """3×3-conv padding: explicit (1, 1) under torch geometry, else SAME
    (the two differ at stride 2, where SAME pads (0, 1))."""
    return ((1, 1), (1, 1)) if torch_pad else "SAME"


class Quantizable:
    """What every quantizable layer shares: the policy and spec that
    ``convert_model`` attaches (none by default: fp32), and the ``in_q``
    activation quantizer."""

    quant: Optional[QuantPolicy] = None
    spec: Optional[LayerQuantSpec] = None

    def _no_quant(self) -> None:
        self.in_q: Optional[ActQuant] = None

    def set_quant(self, policy: Optional[QuantPolicy], path: str) -> None:
        """Attach ``policy`` (None detaches it); a fresh ``in_q`` is made
        when the layer's spec quantizes activations and has none yet."""
        self.quant = policy
        self.spec = None if policy is None else policy.spec_for(path)
        if self.spec is None or not self.spec.quantize_acts:
            self.in_q = None
        elif self.in_q is None or self.in_q.spec != self.spec:
            dev = next(self.parameters()).device
            self.in_q = ActQuant(self.spec).to(dev)

    def resolve(self) -> Tuple[Optional[LayerQuantSpec], QuantMode]:
        """This layer's spec and mode (None and OFF: fp32)."""
        q = self.quant
        if q is None or q.mode == QuantMode.OFF or self.spec is None:
            return None, QuantMode.OFF
        if q.mode == QuantMode.SERVE:
            raise ValueError("SERVE mode runs on qtpu_torch.nn.serve_layers")
        return self.spec, q.mode

    def quant_input(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        return x if self.in_q is None else self.in_q(x, mode)


def quant_weight(w: torch.Tensor, spec: Optional[LayerQuantSpec],
                 mode: QuantMode) -> torch.Tensor:
    """Weights fake-quantized per output channel (axis 0) or per tensor in
    a quantizing mode; as they are otherwise."""
    if spec is None or not spec.quantize_weights or not mode.quantizes:
        return w
    return fq.fake_quant_weight(w, bits=spec.w_bits,
                                channel_axis=0 if spec.per_channel else None,
                                ste=spec.ste)


class _ConvBase(Quantizable, nn.Module):
    """The conv both ``ConvBN`` and ``Conv`` run, fp32 or quantized."""

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        (hlo, hhi), (wlo, whi) = resolve_pads(x.shape[2:], self.kernel,
                                              self.stride, self.padding)
        xp = F.pad(x, (wlo, whi, hlo, hhi))
        if torch.is_grad_enabled():
            xp = cpu_conv_layout(xp)
        return F.conv2d(xp, w, stride=self.stride, groups=self.groups)

    def _quant_conv_fn(self, x: torch.Tensor, spec, mode
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
        """``w ↦`` the layer's conv of ``x``: the fp32 conv of the
        fake-quantized operands, or the integer-forward QAT conv.  ``in_q``
        runs (and its observer updates) here, once."""
        if (self.quant is not None and self.quant.qat_forward == "int"
                and int_forward_ok(spec, mode)):
            scale, zp = self.in_q(x, mode, emit_qparams=True)

            def int_conv(w):
                return qat_int_conv(
                    x, w, scale, zp, a_bits=spec.a_bits, w_bits=spec.w_bits,
                    per_channel=spec.per_channel,
                    act_symmetric=spec.act_symmetric, strides=self.stride,
                    padding=self.padding, groups=self.groups)
            return int_conv
        xq = x if spec is None else self.quant_input(x, mode)
        return lambda w: self._conv(xq, quant_weight(w, spec, mode))


def _batch_stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of an NCHW tensor — over the
    global batch inside ``collectives.synced_batch`` (data-parallel
    training: the sums are reduced over the data group, with autograd)."""
    group = collectives.batch_group()
    if group is None:
        mean = y.mean(dim=(0, 2, 3))
        c = y - mean.view(-1, 1, 1)
        return mean, (c * c).mean(dim=(0, 2, 3))
    n = y.numel() // y.shape[1] * dist.get_world_size(group)
    mean = collectives.all_reduce_sum_grad(y.sum(dim=(0, 2, 3)), group) / n
    c = y - mean.view(-1, 1, 1)
    return mean, collectives.all_reduce_sum_grad(
        (c * c).sum(dim=(0, 2, 3)), group) / n


class ConvBN(_ConvBase):
    """Conv (no bias) + BatchNorm (+ activation), NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", act: Optional[str] = None,
                 groups: int = 1):
        super().__init__()
        self._no_quant()
        if act not in ACTIVATIONS:
            raise ValueError(f"activation {act!r} not in {ACTIVATIONS}")
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=False,
                              groups=groups)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding = padding
        self.groups = groups
        self.act = act

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        bn = self.bn
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                  + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                 + (1 - BN_MOMENTUM) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec, mode = self.resolve()
        bn = self.bn
        kernel, gamma, beta = self.conv.weight, bn.weight, bn.bias
        v = (-1, 1, 1)
        o = (-1, 1, 1, 1)
        quant_conv = self._quant_conv_fn(x, spec, mode)
        fold = spec is not None and mode.quantizes and self.quant.fold_bn
        if fold and self.training and self.quant.fake_bn == "approx":
            sigma_r = torch.sqrt(bn.running_var + BN_EPS)
            factor = gamma / sigma_r
            safe = torch.where(factor == 0.0, torch.ones_like(factor),
                               factor)
            y = quant_conv(kernel * factor.view(o)) / safe.view(v)
            bmean, bvar = _batch_stats(y)
            self._update_running(bmean.detach(), bvar.detach())
            y = ((y - bmean.view(v)) / torch.sqrt(bvar.view(v) + BN_EPS)
                 * gamma.view(v) + beta.view(v))
        elif fold:
            if self.training:
                mean, var = _batch_stats(self._conv(x, kernel))
                self._update_running(mean.detach(), var.detach())
            else:
                mean, var = bn.running_mean, bn.running_var
            sigma = torch.sqrt(var + BN_EPS)
            w_fold = kernel * (gamma / sigma).view(o)
            b_fold = beta - gamma * mean / sigma
            y = quant_conv(w_fold) + b_fold.view(v)
        else:
            y = quant_conv(kernel)
            if self.training:
                mean, var = _batch_stats(y)
                self._update_running(mean.detach(), var.detach())
            else:
                mean, var = bn.running_mean, bn.running_var
            y = ((y - mean.view(v)) / torch.sqrt(var.view(v) + BN_EPS)
                 * gamma.view(v) + beta.view(v))
        if self.act is None:
            return y
        y = torch.relu(y)
        return torch.clamp_max(y, 6.0) if self.act == "relu6" else y


class Conv(_ConvBase):
    """Conv + bias, no BatchNorm (qtpu's ``QuantConv``), NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME"):
        super().__init__()
        self._no_quant()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=True)
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding = padding
        self.groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec, mode = self.resolve()
        y = self._quant_conv_fn(x, spec, mode)(self.conv.weight)
        return y + self.conv.bias.view(-1, 1, 1)


class QuantDense(Quantizable, nn.Linear):
    """The fully-connected layer: ``nn.Linear`` in fp32, and with a policy
    ``fake_quant(x) @ fake_quant_weight(W)ᵀ + b`` in qtpu's order (the
    simulation always: qtpu's integer forward covers convs only)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout)
        self._no_quant()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec, mode = self.resolve()
        if spec is None:
            return F.linear(x, self.weight, self.bias)
        x = self.quant_input(x, mode)
        return x @ quant_weight(self.weight, spec, mode).t() + self.bias


QUANTIZABLE = (ConvBN, Conv, nn.Linear)


def layer_paths(model: nn.Module) -> Dict[str, nn.Module]:
    """qtpu-style path → quantizable layer (ConvBN, Conv or a Linear)."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, QUANTIZABLE)}


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flat(v, p))
        elif isinstance(v, torch.Tensor):
            out[p] = v.detach().cpu().numpy()
        else:
            out[p] = np.asarray(v)
    return out


Take = Callable[[str, str, Tuple[int, ...], Optional[Tuple[int, ...]]],
                torch.Tensor]


def load_layer(m: nn.Module, path: str, take: Take) -> None:
    """Fill one quantizable layer from qtpu's variables: ``take(collection,
    leaf path, torch shape, permutation)`` returns each array as a float32
    tensor of that shape."""
    with torch.no_grad():
        if isinstance(m, (ConvBN, Conv)):
            w = m.conv.weight
            w.copy_(take("params", f"{path}/kernel", w.shape, (3, 2, 0, 1)))
        if isinstance(m, Conv):
            m.conv.bias.copy_(take("params", f"{path}/bias",
                                   m.conv.bias.shape, None))
        elif isinstance(m, ConvBN):
            bn = m.bn
            bn.weight.copy_(take("params", f"{path}/scale", bn.weight.shape,
                                 None))
            bn.bias.copy_(take("params", f"{path}/bias", bn.bias.shape, None))
            bn.running_mean.copy_(take("batch_stats", f"{path}/mean",
                                       bn.running_mean.shape, None))
            bn.running_var.copy_(take("batch_stats", f"{path}/var",
                                      bn.running_var.shape, None))
        else:
            m.weight.copy_(take("params", f"{path}/kernel", m.weight.shape,
                                (1, 0)))
            m.bias.copy_(take("params", f"{path}/bias", m.bias.shape, None))


def load_act_quant(aq: ActQuant, path: str, take: Take,
                   collections: Sequence[str]) -> None:
    """Fill a converted layer's ``in_q`` from qtpu's ``quant_stats`` /
    ``quant_params`` (each when in ``collections``) and its
    ``params/<path>/in_q/pact_alpha``."""
    leaves = {"quant_stats": ("min", "max", "count", "hist", "hist_amax"),
              "quant_params": ("act_scale", "act_zp", "calibrated")}
    with torch.no_grad():
        for col in collections:
            for leaf in leaves[col]:
                buf = getattr(aq, leaf, None)
                if buf is not None:
                    buf.copy_(take(col, f"{path}/in_q/{leaf}",
                                   buf.shape, None))
        if aq.pact_alpha is not None:
            aq.pact_alpha.copy_(take("params", f"{path}/in_q/pact_alpha",
                                     (), None))


def flax_taker(params: Mapping, batch_stats: Mapping,
               **more: Mapping) -> Tuple[Take, set, dict]:
    """A ``take`` over qtpu's nested ``params``/``batch_stats`` (and any
    further collections by name; numpy arrays or tensors), the set of keys
    it has consumed, and every key."""
    src = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats),
                      *more.items()):
        src.update({(col, k): v for k, v in _flat(tree).items()})
    used = set()

    def take(col, path, shape, perm=None):
        key = (col, path)
        if key not in src:
            raise KeyError(f"qtpu variables lack {col}/{path}")
        a = src[key]
        if perm is not None:
            a = np.transpose(a, perm)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{col}/{path}: shape {a.shape} != {tuple(shape)}")
        used.add(key)
        return torch.tensor(np.asarray(a, np.float32))

    return take, used, src


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping,
                        quant_stats: Optional[Mapping] = None,
                        quant_params: Optional[Mapping] = None
                        ) -> nn.Module:
    """Copy qtpu's fp32 ``params``/``batch_stats`` into ``model`` in place
    and, into a converted model, the ``quant_stats`` / ``quant_params``
    given and each ``in_q``'s ``pact_alpha``.

    Strict both ways: every model tensor filled must find a shape-matching
    array and every array must be consumed, except the ``in_q`` variables
    of layers without an ``in_q`` (an fp32 model's: they are not
    weights)."""
    more = {k: v for k, v in (("quant_stats", quant_stats),
                              ("quant_params", quant_params))
            if v is not None}
    take, used, src = flax_taker(params, batch_stats, **more)
    observed = set()
    for path, m in layer_paths(model).items():
        load_layer(m, path, take)
        aq = getattr(m, "in_q", None)
        if aq is not None:
            load_act_quant(aq, path, take, tuple(more))
            observed.add(path)
    left = [f"{c}/{p}" for (c, p) in src if (c, p) not in used
            and ("/in_q/" not in f"/{p}/"
                 or p.split("/in_q/")[0] in observed)]
    if left:
        raise ValueError(f"qtpu variables not consumed: {sorted(left)}")
    return model
