"""Post-training calibration (port of the range pass of
qtpu/transform/calibrate.py): min-max and EMA observers.

qtpu records each quantized layer's *input* range during the fp32 forward
that ``QuantMode.CALIB_RANGE`` runs: BatchNorm on running statistics, no
weight fake-quant.  Here the fp32 model's eval forward is that forward, and
forward pre-hooks — the reference's own idiom — observe each quantized
layer's input, with the layer's observer: ``"minmax"`` the running
min/max, ``"ema"`` qtpu's ``ema_update`` at the spec's ``ema_momentum``
over the batches in order.  The observer state is fresh on every call, so
calibration is idempotent.  The histogram / KL pass and PACT are still to
port (ROADMAP.md) and raise.

Returns ``{"quant_stats": {path: state}, "quant_params": {path: {"act_scale",
"act_zp", "calibrated"}}}`` keyed by qtpu's "/"-joined layer paths.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn as nn

from qtpu_torch.calib import observers as obs
from qtpu_torch.nn.layers import layer_paths
from qtpu_torch.nn.config import QuantPolicy
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.utils.device import fp32_exact


def calibrate(model: nn.Module, policy: QuantPolicy,
              batches: Iterable) -> dict:
    """Run ``batches`` (NHWC arrays or tensors) through ``model`` and freeze
    affine/symmetric activation grids for every quantized layer."""
    device = next(model.parameters()).device
    layers = {p: m for p, m in layer_paths(model).items()
              if policy.spec_for(p) is not None
              and policy.spec_for(p).quantize_acts}
    for p in layers:
        if policy.spec_for(p).act_observer not in ("minmax", "ema"):
            raise NotImplementedError(
                f"{p}: only the min-max and EMA observers are ported "
                "(KL / PACT: ROADMAP.md)")
    stats = {p: obs.minmax_init(device) for p in layers}

    def observer(path):
        spec = policy.spec_for(path)

        def hook(_module, args):
            if spec.act_observer == "ema":
                stats[path] = obs.ema_update(stats[path], args[0],
                                             spec.ema_momentum)
            else:
                stats[path] = obs.minmax_update(stats[path], args[0])
        return hook

    hooks = [m.register_forward_pre_hook(observer(p))
             for p, m in layers.items()]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), fp32_exact():
            for b in batches:
                if not isinstance(b, torch.Tensor):
                    b = torch.tensor(np.asarray(b, np.float32))
                model(b.to(device, torch.float32))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)

    qparams = {}
    for p, st in stats.items():
        spec = policy.spec_for(p)
        if st["count"] == 0:
            continue
        if spec.act_symmetric:
            amax = torch.maximum(torch.abs(st["min"]), torch.abs(st["max"]))
            scale = fq.symmetric_scale(amax, spec.a_bits)
            zp = torch.zeros((), dtype=torch.float32, device=device)
        else:
            scale, zp = fq.affine_qparams(st["min"], st["max"], spec.a_bits)
        qparams[p] = {"act_scale": scale, "act_zp": zp, "calibrated": True}
    return {"quant_stats": stats, "quant_params": qparams}
