"""Model conversion (port of qtpu/transform/convert.py): the functional
equivalent of the reference's ``convert_model(net, exclude=...,
convert_fn=...)``.

qtpu converts by cloning a model definition with a policy attached; its
variables live apart.  A torch module holds its state, so here every
conversion returns a converted *copy*: ``convert_model`` deep-copies the
model and attaches the policy to every quantizable layer
(``Quantizable.set_quant``: the layer's spec by its path, and a fresh
``in_q`` activation quantizer where the spec quantizes activations), so
the fp32 model stays as it was — as qtpu's ``clone`` leaves it.
``set_mode`` and ``strip_quant`` return copies too.
``quantize_variables`` gives a converted model a trained fp32 state,
keeping its fresh observers and its initial PACT ``pact_alpha``;
``deep_merge`` is qtpu's nested overlay.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from qtpu_torch.nn.config import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.nn.layers import layer_paths


def _attach(model: nn.Module, policy: Optional[QuantPolicy]) -> nn.Module:
    model.quant = policy
    for path, m in layer_paths(model).items():
        m.set_quant(policy, path)
    return model


def convert_model(model: nn.Module, policy: Optional[QuantPolicy] = None,
                  *, exclude: Sequence[str] = (),
                  overrides: Sequence[Tuple[str, LayerQuantSpec]] = (),
                  mode: Optional[QuantMode] = None) -> nn.Module:
    """A quantized copy of ``model``.  If it already carries a policy,
    ``exclude``/``overrides``/``mode`` refine it."""
    if not layer_paths(model):
        raise TypeError(f"{type(model).__name__} has no quantizable layer")
    base = policy if policy is not None else (
        getattr(model, "quant", None) or QuantPolicy())
    new_policy = dataclasses.replace(
        base, exclude=tuple(base.exclude) + tuple(exclude),
        overrides=tuple(base.overrides) + tuple(overrides),
        mode=mode if mode is not None else base.mode)
    return _attach(copy.deepcopy(model), new_policy)


def deep_merge(fresh, trained):
    """Overlay trained leaves onto the fresh tree, keeping fresh-only
    paths (a quantizer's own parameters the fp32 model never had)."""
    if isinstance(fresh, Mapping) and isinstance(trained, Mapping):
        out = dict(fresh)
        for k, v in trained.items():
            out[k] = deep_merge(fresh[k], v) if k in fresh else v
        return out
    return trained


def quantize_variables(qmodel: nn.Module,
                       trained: Union[nn.Module, Mapping[str, Any]]
                       ) -> nn.Module:
    """Load a trained fp32 state (a module or its ``state_dict``) into the
    converted ``qmodel`` in place: every trained tensor overlays its
    counterpart, the ``in_q`` state keeps its fresh values.  Raises on a
    trained tensor the converted model does not have."""
    if isinstance(trained, nn.Module):
        trained = trained.state_dict()
    fresh = qmodel.state_dict()
    unknown = sorted(set(trained) - set(fresh))
    if unknown:
        raise ValueError(f"trained tensors the converted model lacks: "
                         f"{unknown}")
    qmodel.load_state_dict(deep_merge(fresh, dict(trained)))
    return qmodel


def set_mode(model: nn.Module, mode: QuantMode) -> nn.Module:
    """A copy of ``model`` with its quantization mode switched."""
    policy = getattr(model, "quant", None)
    if policy is None:
        raise ValueError("model has no quantization policy; convert it first")
    return _attach(copy.deepcopy(model), policy.with_mode(mode))


def strip_quant(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with quantization removed (the fp32 baseline)."""
    return _attach(copy.deepcopy(model), None)


def quant_state(model: nn.Module) -> dict:
    """The observer state of a converted model's layers, by qtpu's layer
    path: ``{"quant_stats": {path: {"min", "max", "count"}},
    "quant_params": {path: {"act_scale", "act_zp", "calibrated"}},
    "pact_alpha": {path: α}}`` (what ``freeze`` reads)."""
    out = {"quant_stats": {}, "quant_params": {}, "pact_alpha": {}}
    with torch.no_grad():
        for path, m in layer_paths(model).items():
            aq = getattr(m, "in_q", None)
            if aq is None:
                continue
            out["quant_stats"][path] = {"min": aq.min.clone(),
                                        "max": aq.max.clone(),
                                        "count": int(aq.count)}
            out["quant_params"][path] = {
                "act_scale": aq.act_scale.clone(),
                "act_zp": aq.act_zp.clone(),
                "calibrated": bool(aq.calibrated)}
            if aq.pact_alpha is not None:
                out["pact_alpha"][path] = aq.pact_alpha.detach().clone()
    return out
