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

qtpu jits each pass's step (``range_step``, ``hist_step``), one compiled
program per batch shape.  Here, on a card, each pass keeps one CUDA graph
per batch shape, by the training step's rule (``train.graphs.step_plan``):
the first two batches of a shape run eagerly on a side stream, the third
is captured and replayed, every later one replayed; a shape with two
batches or fewer stays eager.  The hooks update the observers in place
(``calib.observers``' ``*_update_``), in tensors made before any capture,
so a replay updates the state the next batch reads.  The counts are host
integers, which a replay does not move: the capture records how far it
moved each and puts them back, and every replay adds that.  A pass that
cannot be captured raises ``GraphCaptureError``; ``graphed=False`` runs
every batch eagerly, for measuring the passes against their graphs only.

Returns ``{"quant_stats": {path: state}, "quant_params": {path:
{"act_scale", "act_zp", "calibrated"}}, "seconds": {"range", "hist",
"search"}}`` (each pass's wall seconds, its captures included) keyed by
qtpu's "/"-joined layer paths; a KL layer's state also holds ``hist``
(the counts) and ``hist_amax``.  In a converted model
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
from qtpu_torch.train.graphs import step_plan
from qtpu_torch.transform.convert import strip_quant
from qtpu_torch.utils.device import fp32_exact
from qtpu_torch.utils.graphs import add_counts, capture_call, launch_counters


def _run(model: nn.Module, batches, hooks: Dict[str, Callable],
         layers: Dict[str, nn.Module], device: torch.device,
         counted: Dict[str, dict], graphed: bool) -> float:
    """One eval forward of every batch with ``hooks[path]`` as the forward
    pre-hook of ``layers[path]`` — on a card with ``graphed``, per batch
    shape two eager batches, then a captured graph replayed (module
    docstring); ``counted``: the states whose host ``count`` the hooks
    advance.  Returns the pass's seconds."""
    t0 = time.perf_counter()
    handles = [layers[p].register_forward_pre_hook(h)
               for p, h in hooks.items()]
    was_training = model.training
    model.eval()
    graphs: Dict[tuple, _PassGraph] = {}
    seen: Dict[tuple, int] = {}
    graphed = _graphs_on(device, graphed)
    try:
        with torch.no_grad(), fp32_exact():
            for b in batches:
                if not isinstance(b, torch.Tensor):
                    b = torch.tensor(np.asarray(b, np.float32))
                b = b.to(torch.float32)
                if not graphed:
                    model(b.to(device))
                    continue
                key = tuple(b.shape)
                n = seen[key] = seen.get(key, 0) + 1
                plan = step_plan(n - 1)
                if plan == "eager":
                    _eager_on_side_stream(model, b.to(device), device)
                    continue
                if plan == "capture":
                    graphs[key] = _PassGraph(model, b, device, counted)
                graphs[key].replay(b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return time.perf_counter() - t0


def _graphs_on(device: torch.device, graphed: bool) -> bool:
    """Whether a pass on ``device`` replays graphs: on a card, not turned
    off."""
    return graphed and device.type == "cuda"


def _eager_on_side_stream(model: nn.Module, x: torch.Tensor,
                          device: torch.device) -> None:
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        model(x)
    cur.wait_stream(side)


class _PassGraph:
    """One batch shape's captured forward of a calibration pass, its hooks'
    in-place updates with it: the batch is copied into ``static``, the
    graph replayed, and each state's count advanced as the capture's call
    advanced it (and put back)."""

    def __init__(self, model: nn.Module, b: torch.Tensor,
                 device: torch.device, counted: Dict[str, dict]):
        self.static = torch.empty(b.shape, dtype=b.dtype, device=device)
        self.static.copy_(b)
        before = {p: st["count"] for p, st in counted.items()}
        self.graph, _, self.launches, _ = capture_call(
            lambda: model(self.static), device,
            f"the calibration pass at batch {tuple(b.shape)}")
        self.counts = {p: st["count"] - before[p]
                       for p, st in counted.items()
                       if st["count"] != before[p]}
        for p, n in self.counts.items():
            counted[p]["count"] -= n
        self.states = counted
        self._counters = launch_counters()

    def replay(self, b: torch.Tensor) -> None:
        self.static.copy_(b, non_blocking=True)
        self.graph.replay()
        add_counts(self._counters, self.launches)
        for p, n in self.counts.items():
            self.states[p]["count"] += n


def calibrate(model: nn.Module, policy: QuantPolicy,
              batches: Iterable, graphed: bool = True) -> dict:
    """Run ``batches`` (NHWC arrays or tensors) through ``model`` and freeze
    affine/symmetric activation grids for every quantized layer.  The
    batches are iterated twice when a layer uses the KL observer.  On a
    card each pass replays a CUDA graph per batch shape from its third
    batch of that shape on (``graphed=False``: eager, for measurement
    only)."""
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
            st = stats[path]
            if alpha is not None:
                st["min"].zero_()
                st["max"].copy_(alpha)
                st["count"] += 1
            elif spec.act_observer == "ema":
                obs.ema_update_(st, args[0], spec.ema_momentum)
            else:
                obs.minmax_update_(st, args[0])
        return hook

    seconds = {"range": _run(fp32, batches,
                             {p: ranger(p) for p in layers}, layers, device,
                             stats, graphed),
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
            obs.hist_update_(hists[path], args[0])
        return hook

    if kl:
        seconds["hist"] = _run(fp32, batches, {p: binner(p) for p in kl},
                               layers, device, {}, graphed)

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
