"""Post-training calibration (port of qtpu/transform/calibrate.py): min-max,
EMA, KL and PACT observers.

qtpu records each quantized layer's *input* range during the fp32 forward
that ``QuantMode.CALIB_RANGE`` runs: BatchNorm on running statistics, no
weight fake-quant.  Here the fp32 model's eval forward is that forward (a
converted model's fp32 copy, ``strip_quant``), and forward pre-hooks — the
reference's own idiom — observe each quantized layer's input, with the
layer's observer: ``"minmax"`` the running min/max, ``"ema"`` qtpu's
``ema_update`` at the spec's ``ema_momentum`` over the batches in order,
``"kl"`` the running min/max too, ``"pact"`` the range ``(0, α)`` every
batch (α the layer's ``in_q.pact_alpha`` in a converted model, else the
spec's ``pact_init``).  Layers on the KL observer then take qtpu's second
pass: each histogram's range is seeded with ``max(|min|, |max|, 1e-12)``,
the same batches run again with pre-hooks that bin |x| (``hist_update``,
on the device), and the host threshold search (``kl_threshold``) freezes
a symmetric grid, ``act_scale = symmetric_scale(T)`` and ``act_zp = 0``.
The observer state is fresh on every call, so calibration is idempotent.

Returns ``{"quant_stats": {path: state}, "quant_params": {path:
{"act_scale", "act_zp", "calibrated"}}, "seconds": {"range", "hist",
"search"}}`` keyed by qtpu's "/"-joined layer paths; a KL layer's state
also holds ``hist`` (the counts) and ``hist_amax``.  In a converted model
the same state is written into each layer's ``in_q`` buffers, as qtpu's
calibrate returns its variables with ``quant_params`` filled.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch
import torch.nn as nn

from qtpu_torch.calib import observers as obs
from qtpu_torch.calib.kl import kl_threshold
from qtpu_torch.nn.layers import layer_paths
from qtpu_torch.nn.config import QuantPolicy
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.transform.convert import strip_quant
from qtpu_torch.utils.device import fp32_exact


def _run(model: nn.Module, batches, hooks: Dict[str, Callable],
         layers: Dict[str, nn.Module], device: torch.device) -> float:
    """One eval forward of every batch with ``hooks[path]`` as the forward
    pre-hook of ``layers[path]``; returns the pass's seconds."""
    t0 = time.perf_counter()
    handles = [layers[p].register_forward_pre_hook(h)
               for p, h in hooks.items()]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), fp32_exact():
            for b in batches:
                if not isinstance(b, torch.Tensor):
                    b = torch.tensor(np.asarray(b, np.float32))
                model(b.to(device, torch.float32))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return time.perf_counter() - t0


def calibrate(model: nn.Module, policy: QuantPolicy,
              batches: Iterable) -> dict:
    """Run ``batches`` (NHWC arrays or tensors) through ``model`` and freeze
    affine/symmetric activation grids for every quantized layer.  The
    batches are iterated twice when a layer uses the KL observer."""
    device = next(model.parameters()).device
    batches = list(batches)
    converted = getattr(model, "quant", None) is not None
    fp32 = strip_quant(model) if converted else model
    own = layer_paths(model)
    layers = {p: m for p, m in layer_paths(fp32).items()
              if policy.spec_for(p) is not None
              and policy.spec_for(p).quantize_acts}
    stats = {p: obs.minmax_init(device) for p in layers}

    def pact_alpha(path):
        aq = getattr(own[path], "in_q", None)
        if aq is not None and aq.pact_alpha is not None:
            return aq.pact_alpha.detach().to(torch.float32).clone()
        return torch.tensor(policy.spec_for(path).pact_init,
                            dtype=torch.float32, device=device)

    def ranger(path):
        spec = policy.spec_for(path)
        alpha = pact_alpha(path) if spec.act_observer == "pact" else None

        def hook(_module, args):
            if alpha is not None:
                stats[path] = {"min": torch.zeros_like(alpha), "max": alpha,
                               "count": stats[path]["count"] + 1}
            elif spec.act_observer == "ema":
                stats[path] = obs.ema_update(stats[path], args[0],
                                             spec.ema_momentum)
            else:
                stats[path] = obs.minmax_update(stats[path], args[0])
        return hook

    seconds = {"range": _run(fp32, batches,
                             {p: ranger(p) for p in layers}, layers, device),
               "hist": 0.0, "search": 0.0}

    kl = [p for p in layers if policy.spec_for(p).act_observer == "kl"
          and stats[p]["count"] > 0]
    hists = {}
    for p in kl:
        st = stats[p]
        amax = torch.maximum(torch.abs(st["min"]), torch.abs(st["max"]))
        hists[p] = obs.hist_set_range(obs.hist_init(device=device),
                                      torch.clamp_min(amax, 1e-12))

    def binner(path):
        def hook(_module, args):
            hists[path] = obs.hist_update(hists[path], args[0])
        return hook

    if kl:
        seconds["hist"] = _run(fp32, batches, {p: binner(p) for p in kl},
                               layers, device)

    t0 = time.perf_counter()
    qparams = {}
    for p, st in stats.items():
        spec = policy.spec_for(p)
        if st["count"] == 0:
            continue
        if p in hists:
            h = hists[p]
            stats[p] = {**st, "hist": h["counts"], "hist_amax": h["amax"]}
            t = kl_threshold(h["counts"].cpu().numpy(),
                             float(h["amax"].cpu()), bits=spec.a_bits)
            scale = fq.symmetric_scale(np.float32(t), spec.a_bits).to(device)
            zp = torch.zeros((), dtype=torch.float32, device=device)
        elif spec.act_symmetric:
            scale = obs.minmax_to_symmetric(st, spec.a_bits)
            zp = torch.zeros((), dtype=torch.float32, device=device)
        else:
            scale, zp = obs.minmax_to_affine(st, spec.a_bits)
        qparams[p] = {"act_scale": scale, "act_zp": zp, "calibrated": True}
    seconds["search"] = time.perf_counter() - t0
    if converted:
        _write(own, stats, qparams)
    return {"quant_stats": stats, "quant_params": qparams,
            "seconds": seconds}


def _write(layers: Dict[str, nn.Module], stats: dict, qparams: dict) -> None:
    """Calibration state into the converted layers' ``in_q`` buffers."""
    with torch.no_grad():
        for path, st in stats.items():
            aq = layers[path].in_q
            aq.min.copy_(st["min"])
            aq.max.copy_(st["max"])
            aq.count.fill_(st["count"])
            if "hist" in st and hasattr(aq, "hist"):
                aq.hist.copy_(st["hist"])
                aq.hist_amax.copy_(st["hist_amax"])
            q = qparams.get(path)
            if q is not None:
                aq.act_scale.copy_(q["act_scale"])
                aq.act_zp.copy_(q["act_zp"])
                aq.calibrated.fill_(True)
