"""Calibration observers (port of qtpu/calib/observers.py): min-max, EMA
and the |x| histogram of KL calibration.

State of the range observers: ``{"min": 0-d float32 tensor, "max": 0-d
float32 tensor, "count": int}``.  Min and max stay on the activations'
device; the count is a host integer, so an update never waits on the
device.  Histogram state: ``{"counts": (nbins,) float32, "amax": 0-d
float32}``, both on the device — |x| binned over the range ``[0, amax]``
a preceding min-max pass froze (qtpu's two-pass scheme); only the
threshold search (:mod:`qtpu_torch.calib.kl`) runs on the host.

Each update has two forms: the functional one returns a new state, as
qtpu's observers do; the one whose name ends in ``_`` runs it and copies
the new values into the state's own tensors (``_assign``: one expression
an observer, so the same arithmetic, kernels and bits) and returns the
state.  A calibration pass replayed as a CUDA graph
(``transform/calibrate.py``) needs the second: a graph reads and writes
the tensors it was captured with.  The count stays a host integer either
way, and its first-batch branch runs only where the count is 0, so a
captured update is always a later batch's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from qtpu_torch.ops import fakequant as fq

State = Dict[str, object]

HIST_NBINS = 2048   # the histogram's bin count, as qtpu's
HIST_ROWS = 256     # partial histograms a batch is counted into


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


def _assign(state: State, new: State) -> State:
    """``new`` written into ``state``: its new tensors copied into
    ``state``'s (their storage kept), anything else rebound."""
    for k, v in new.items():
        if not isinstance(v, torch.Tensor):
            state[k] = v
        elif v is not state[k]:
            state[k].copy_(v)
    return state


def minmax_update_(state: State, x: torch.Tensor) -> State:
    """:func:`minmax_update` written into ``state``'s tensors."""
    return _assign(state, minmax_update(state, x))


def ema_update(state: State, x: torch.Tensor, momentum: float = 0.99
               ) -> State:
    """Exponential-moving-average min/max from a :func:`minmax_init` state
    (qtpu's ``ema_init`` is the same): the first batch's range, then
    ``m * old + (1 - m) * batch``.  ``m`` and ``1 - m`` are float32 as in
    qtpu (``jnp.float32(momentum)``, then ``1 - m`` in float32): 1 - 0.99
    in double, cast to float32, is another number; ``m`` is filled on the
    device (a fill kernel, which a graph holds, not an upload)."""
    bmin = torch.amin(x).to(torch.float32)
    bmax = torch.amax(x).to(torch.float32)
    if state["count"] == 0:
        return {"min": bmin, "max": bmax, "count": 1}
    m = torch.full((), momentum, dtype=torch.float32, device=bmin.device)
    one_m = 1 - m
    return {"min": m * state["min"] + one_m * bmin,
            "max": m * state["max"] + one_m * bmax,
            "count": state["count"] + 1}


def ema_update_(state: State, x: torch.Tensor, momentum: float = 0.99
                ) -> State:
    """:func:`ema_update` written into ``state``'s tensors."""
    return _assign(state, ema_update(state, x, momentum))


def hist_init(nbins: int = HIST_NBINS,
              device: Optional[torch.device] = None) -> State:
    return {"counts": torch.zeros((nbins,), dtype=torch.float32,
                                  device=device),
            "amax": torch.zeros((), dtype=torch.float32, device=device)}


def hist_set_range(state: State, amax) -> State:
    """Freeze the histogram range (once, after the min-max pass)."""
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=state["counts"].device)
    return {**state, "amax": amax}


def hist_update(state: State, x: torch.Tensor) -> State:
    """Accumulate the |x| histogram over [0, amax] on the device: bin
    ``clip(int32(|x| / amax * nbins), 0, nbins - 1)`` in float32, in that
    order, with ``amax`` a device tensor (a host-scalar divide becomes a
    reciprocal multiply on CUDA and moves values across bin edges).  Values
    above amax land in the last bin.  The batch is counted exactly in
    integers — a scatter of integer ones, which needs no read of the data
    on the host, where ``torch.bincount`` on CUDA reads the largest index
    back to size its output — and only then added to the float32 running
    counts: scattering +1.0 into a float32 total would stop a bin at 2^24.
    Element i counts in partial histogram ``i % HIST_ROWS``, summed after:
    one histogram would take a run of equal codes (ReLU's zeros, half of an
    activation) as atomic adds on one address."""
    counts = state["counts"]
    nbins = counts.shape[0]
    amax = torch.clamp_min(state["amax"], 1e-12)
    ax = torch.abs(x).to(torch.float32).reshape(-1)
    idx = torch.clamp((ax / amax * nbins).to(torch.int32), 0, nbins - 1)
    n, dev = idx.shape[0], idx.device
    rows = torch.arange(n, dtype=torch.int32, device=dev) % HIST_ROWS
    part = torch.zeros((HIST_ROWS * nbins,), dtype=torch.int32, device=dev)
    part.index_add_(0, idx + rows * nbins,
                    torch.ones((), dtype=torch.int32, device=dev).expand(n))
    batch = part.view(HIST_ROWS, nbins).sum(0)
    return {**state, "counts": counts + batch.to(torch.float32)}


def hist_update_(state: State, x: torch.Tensor) -> State:
    """:func:`hist_update` written into ``state["counts"]``."""
    return _assign(state, hist_update(state, x))


def minmax_to_affine(state: State, bits: int = 8):
    """(scale, zero point) of the affine grid over a range state."""
    return fq.affine_qparams(state["min"], state["max"], bits)


def minmax_to_symmetric(state: State, bits: int = 8) -> torch.Tensor:
    """Scale of the symmetric grid over a range state."""
    amax = torch.maximum(torch.abs(state["min"]), torch.abs(state["max"]))
    return fq.symmetric_scale(amax, bits)
