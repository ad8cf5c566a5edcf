"""Calibration observers (port of the min-max and EMA observers of
qtpu/calib/observers.py).  The histogram observer and the KL threshold
search are still to port (ROADMAP.md).

State: ``{"min": 0-d float32 tensor, "max": 0-d float32 tensor, "count":
int}``.  Min and max stay on the activations' device; the count is a host
integer, so an update never waits on the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

State = Dict[str, object]


def minmax_init(device: Optional[torch.device] = None) -> State:
    return {"min": torch.zeros((), dtype=torch.float32, device=device),
            "max": torch.zeros((), dtype=torch.float32, device=device),
            "count": 0}


def minmax_update(state: State, x: torch.Tensor) -> State:
    """Global (all-batches) running min/max."""
    bmin = torch.amin(x).to(torch.float32)
    bmax = torch.amax(x).to(torch.float32)
    if state["count"] == 0:
        return {"min": bmin, "max": bmax, "count": 1}
    return {"min": torch.minimum(state["min"], bmin),
            "max": torch.maximum(state["max"], bmax),
            "count": state["count"] + 1}


def ema_update(state: State, x: torch.Tensor, momentum: float = 0.99
               ) -> State:
    """Exponential-moving-average min/max from a :func:`minmax_init` state
    (qtpu's ``ema_init`` is the same): the first batch's range, then
    ``m * old + (1 - m) * batch``.  ``m`` and ``1 - m`` are float32 as in
    qtpu (``jnp.float32(momentum)``, then ``1 - m`` in float32): 1 - 0.99
    in double, cast to float32, is another number."""
    bmin = torch.amin(x).to(torch.float32)
    bmax = torch.amax(x).to(torch.float32)
    if state["count"] == 0:
        return {"min": bmin, "max": bmax, "count": 1}
    m = torch.tensor(momentum, dtype=torch.float32, device=bmin.device)
    one_m = 1 - m
    return {"min": m * state["min"] + one_m * bmin,
            "max": m * state["max"] + one_m * bmax,
            "count": state["count"] + 1}
