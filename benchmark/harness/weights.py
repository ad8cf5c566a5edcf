"""Seeded weights, calibration images and input pixels, made on the device
from ``--seed`` in a few large draws of one generator.

Weights follow He et al.'s initialisation (normal, std √(2 / fan-in)); the
BatchNorm of every conv gets random statistics and affine terms (γ in
[0.5, 1.5), β in [−0.1, 0.1), mean in [−0.1, 0.1), var in [0.5, 1.5)) so
that folding it changes every weight; biases are N(0, 0.01²).  Pixels are
uniform over 0-255.  The same seed gives the same tensors."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_params(specs: List[Tuple[str, Tuple[int, ...], str]],
                g: torch.Generator, device) -> Dict:
    """The reference's parameter dict: a tensor per weight and bias, a
    dict (gamma, beta, mean, var) per BatchNorm."""
    dense = [(n, s, k) for n, s, k in specs if k in ("conv", "fc", "bias")]
    norms = [(n, s) for n, s, k in specs if k == "bn"]
    total = sum(math.prod(s) for _, s, _ in dense)
    flat = torch.randn(total, generator=g, device=device)
    nbn = sum(s[0] for _, s in norms)
    u = torch.rand((4, nbn), generator=g, device=device)
    params, o = {}, 0
    for name, shape, kind in dense:
        n = math.prod(shape)
        std = 0.01 if kind == "bias" else math.sqrt(2.0 / math.prod(shape[1:]))
        params[name] = flat[o:o + n].view(shape) * std
        o += n
    o = 0
    for name, (c,) in norms:
        v = u[:, o:o + c]
        params[name] = {"gamma": v[0] + 0.5, "beta": (v[1] - 0.5) * 0.2,
                        "mean": (v[2] - 0.5) * 0.2, "var": v[3] + 0.5}
        o += c
    return params


def state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The parameters under ``torch.nn`` names (a BatchNorm's ``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``),
    for ``load_state_dict`` into the system's model."""
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            out[f"{name}.weight"] = v["gamma"]
            out[f"{name}.bias"] = v["beta"]
            out[f"{name}.running_mean"] = v["mean"]
            out[f"{name}.running_var"] = v["var"]
            out[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=v["gamma"].device)
        else:
            out[name] = v
    return out


def pixels(n: int, shape: Tuple[int, ...], g: torch.Generator,
           device) -> torch.Tensor:
    """``n`` uint8 NHWC images, uniform over 0-255, on ``device``."""
    return torch.randint(0, 256, (n, *shape), generator=g, device=device,
                         dtype=torch.uint8)
