"""Freeze: calibrated fp32 model → integer serving tree (port of
qtpu/transform/freeze.py).

Produces qtpu's frozen layout with torch tensors: ``qweights`` nodes with
``kernel_q`` (HWIO int8, or (in, out) for the fc; int4 nibble-packed along
the output axis when even), ``w_scale`` (per channel (N,) or per tensor ()),
``colsum`` (int32), ``bias`` (BN folded, f32), ``act_scale``, ``act_zp``
(signed-grid int32) and ``act_sym``; plus ``params``/``batch_stats`` of the
excluded layers in qtpu's names and layouts, so the engines fold their BN
from the trained running statistics.  A bias conv without BatchNorm
(:class:`qtpu_torch.nn.layers.Conv`, qtpu's ``QuantConv``) freezes its
kernel and bias as they are, qtpu's no-BN branch; excluded, it keeps
``params/<path>/{kernel, bias}``.

Each quantized layer's activation grid comes, as qtpu's, from the
calibrated ``quant_params`` first; else from a PACT layer's α, an affine
grid over ``[0, α]``; else from the observer's min/max (the EMA state of a
QAT run).  ``calib`` is :func:`qtpu_torch.transform.calibrate.calibrate`'s
output, or for a converted model left out: the model's own ``in_q`` state
(``transform.convert.quant_state``), so a QAT-trained model freezes from
what training left — its EMA observers and the running statistics its
fake-BN steps updated.

Like qtpu, it refuses ``quantize_weights=False`` (the integer path has no
fp32-weight form) and raises on a quantized layer whose observer saw no
batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from qtpu_torch.nn.layers import BN_EPS, Conv, ConvBN, layer_paths
from qtpu_torch.nn.config import QuantPolicy
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.transform.convert import quant_state
from qtpu_torch.utils import debug
from qtpu_torch.utils.numerics import sqrt_rn


def _set(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _hwio(m) -> torch.Tensor:
    return m.conv.weight.detach().to(torch.float32).permute(2, 3, 1, 0)


def _act_grid(path: str, spec, calib: dict):
    """(act_scale, unsigned-grid zero point) of a quantized layer."""
    aq = calib.get("quant_params", {}).get(path)
    alpha = calib.get("pact_alpha", {}).get(path)
    if aq is not None and aq.get("calibrated", False):
        return (torch.as_tensor(aq["act_scale"], dtype=torch.float32),
                torch.as_tensor(aq["act_zp"], dtype=torch.float32))
    if alpha is not None:
        return fq.affine_qparams(torch.zeros_like(alpha),
                                 torch.clamp_min(alpha, 1e-6), spec.a_bits)
    st = calib.get("quant_stats", {}).get(path)
    if st is None:
        raise ValueError(f"no activation stats for layer {path}")
    if int(st.get("count", 0)) == 0:
        raise ValueError(
            f"layer {path} was never calibrated and its observer saw no "
            "batches — run transform.calibrate (or a QAT epoch with an EMA "
            "observer) before freeze")
    if spec.act_symmetric:
        amax = torch.maximum(torch.abs(st["min"]), torch.abs(st["max"]))
        return (fq.symmetric_scale(amax, spec.a_bits),
                torch.zeros((), dtype=torch.float32))
    return fq.affine_qparams(st["min"], st["max"], spec.a_bits)


def freeze(model: nn.Module, policy: QuantPolicy,
           calib: Optional[dict] = None) -> dict:
    """``calib``: :func:`qtpu_torch.transform.calibrate.calibrate` output;
    ``None`` reads a converted model's own observer state."""
    qweights: Dict = {}
    params: Dict = {}
    batch_stats: Dict = {}
    if calib is None:
        calib = quant_state(model)
    with torch.no_grad():
        for path, m in layer_paths(model).items():
            spec = policy.spec_for(path)
            if spec is None:
                # excluded layer: fp32 params in qtpu's names and layouts
                if isinstance(m, ConvBN):
                    _set(params, path, {"kernel": _hwio(m).contiguous(),
                                        "scale": m.bn.weight.detach().clone(),
                                        "bias": m.bn.bias.detach().clone()})
                    _set(batch_stats, path,
                         {"mean": m.bn.running_mean.detach().clone(),
                          "var": m.bn.running_var.detach().clone()})
                elif isinstance(m, Conv):
                    _set(params, path, {"kernel": _hwio(m).contiguous(),
                                        "bias": m.conv.bias.detach().clone()})
                else:
                    _set(params, path,
                         {"kernel": m.weight.detach().t().contiguous(),
                          "bias": m.bias.detach().clone()})
                continue
            if not spec.quantize_weights:
                raise ValueError(
                    f"layer {path} has quantize_weights=False; the integer "
                    "serving path cannot represent fp32 weights — exclude "
                    "the layer instead")
            if isinstance(m, ConvBN):
                kernel = _hwio(m)
                bn = m.bn
                sigma = sqrt_rn(bn.running_var + BN_EPS)
                w_f = kernel * (bn.weight / sigma)
                b_f = bn.bias - bn.weight * bn.running_mean / sigma
            elif isinstance(m, Conv):
                w_f = _hwio(m)
                b_f = m.conv.bias.detach().to(torch.float32)
            else:
                w_f = m.weight.detach().to(torch.float32).t()
                b_f = m.bias.detach().to(torch.float32)
            ch_axis = w_f.dim() - 1
            scale_kd = fq.weight_qparams(
                w_f, bits=spec.w_bits,
                channel_axis=ch_axis if spec.per_channel else None)
            w_q = fq.quantize(w_f, scale_kd, bits=spec.w_bits)
            colsum = w_q.to(torch.int32).sum(
                dim=tuple(range(w_f.dim() - 1))).to(torch.int32)
            packed = spec.w_bits == 4 and w_q.shape[-1] % 2 == 0
            w_store = fq.pack_int4(w_q, axis=-1) if packed else w_q

            a_scale, zp_u = _act_grid(path, spec, calib)
            if spec.act_symmetric:
                zp = torch.zeros((), dtype=torch.int32)
            else:
                zp = (zp_u - (1 << (spec.a_bits - 1))).to(torch.int32)
            dev = w_q.device
            node = {
                "kernel_q": w_store.contiguous(),
                "w_scale": (scale_kd.reshape(-1) if spec.per_channel
                            else scale_kd.reshape(())),
                "colsum": colsum,
                "bias": b_f.to(torch.float32).contiguous(),
                "act_scale": a_scale.reshape(()).to(dev),
                "act_zp": zp.reshape(()).to(dev),
                "act_sym": bool(spec.act_symmetric),
            }
            debug.check_frozen_node(node, bits=spec.w_bits, packed=packed,
                                    path=path)
            _set(qweights, path, node)
    return {"qweights": qweights, "params": params,
            "batch_stats": batch_stats}
