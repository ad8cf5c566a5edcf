"""Activation quantizer: observer state + fake-quant, mode-switched (port of
qtpu/nn/act_quant.py).

A converted layer quantizes (or observes) its input through an
:class:`ActQuant` submodule named ``in_q``, whose state has qtpu's names:
the buffers ``min``, ``max``, ``count`` (qtpu's ``quant_stats``; a KL spec
also ``hist`` and ``hist_amax``), ``act_scale``, ``act_zp`` and
``calibrated`` (its ``quant_params``), and for a PACT spec the parameter
``pact_alpha``.  The state depends on the spec only, never on the mode.

Modes (the layer passes its policy's): ``OFF`` returns ``x``;
``CALIB_RANGE`` records the range (min-max, EMA, or ``(0, α)`` for PACT);
``CALIB_HIST`` bins |x| for a KL spec; ``QUANT_ONLINE`` fake-quantizes on
the batch's own range; ``QUANT_EMA`` updates the EMA observer first, then
fake-quantizes on its range; ``QUANT`` on the frozen ``act_scale`` /
``act_zp``.  PACT in the two training modes clips to the live α.  The
observers update only in training (``module.train()``): that is where
qtpu's ``quant_stats`` collection is mutable.

Inside ``parallel.collectives.synced_batch`` (data-parallel training) a
batch's range is that of the global batch.

``emit_qparams=True`` (the integer-forward QAT conv,
:mod:`qtpu_torch.ops.qat_int`) runs the same updates but returns the live
``(scale, zero point)`` grid for the caller to quantize with; PACT, whose α
needs the fake-quant gradient, refuses it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from qtpu_torch.calib import observers as obs
from qtpu_torch.nn.config import LayerQuantSpec, QuantMode
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.parallel import collectives


def _scalar(value, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def _batch_range(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of the batch as float32 — of the global batch inside
    ``collectives.synced_batch`` (data-parallel training)."""
    xd = x.detach()
    bmin, bmax = torch.amin(xd).float(), torch.amax(xd).float()
    group = collectives.batch_group()
    if group is not None:
        bmin = collectives.all_reduce(bmin, group, "min")
        bmax = collectives.all_reduce(bmax, group, "max")
    return bmin, bmax


class ActQuant(nn.Module):
    """Quantizes (or observes) the input activation of one layer."""

    def __init__(self, spec: LayerQuantSpec):
        super().__init__()
        self.spec = spec
        self.register_buffer("min", _scalar(0.0))
        self.register_buffer("max", _scalar(0.0))
        self.register_buffer("count", _scalar(0, torch.int32))
        if spec.act_observer == "kl":
            self.register_buffer("hist", torch.zeros(obs.HIST_NBINS))
            self.register_buffer("hist_amax", _scalar(0.0))
        self.register_buffer("act_scale", _scalar(1.0))
        self.register_buffer("act_zp", _scalar(0.0))
        self.register_buffer("calibrated", _scalar(False, torch.bool))
        self.pact_alpha = (nn.Parameter(_scalar(spec.pact_init))
                           if spec.act_observer == "pact" else None)

    def forward(self, x: torch.Tensor, mode: QuantMode,
                emit_qparams: bool = False):
        spec = self.spec
        if not spec.quantize_acts or mode == QuantMode.OFF:
            return x
        alpha = self.pact_alpha
        if mode == QuantMode.CALIB_RANGE:
            if self.training:
                with torch.no_grad():
                    if alpha is not None:
                        self.min.zero_()
                        self.max.copy_(alpha)
                        self.count.add_(1)
                    else:
                        self._observe(x, ema=spec.act_observer == "ema")
            return x
        if mode == QuantMode.CALIB_HIST:
            if spec.act_observer == "kl" and self.training:
                h = obs.hist_update({"counts": self.hist,
                                     "amax": self.hist_amax}, x.detach())
                self.hist.copy_(h["counts"])
            return x
        if mode == QuantMode.SERVE:
            raise ValueError("SERVE mode runs on qtpu_torch.nn.serve_layers")
        if emit_qparams:
            if alpha is not None:
                raise ValueError("emit_qparams is unavailable for PACT specs")
            return self.qparams(x, mode)
        if alpha is not None and mode in (QuantMode.QUANT_ONLINE,
                                          QuantMode.QUANT_EMA):
            return fq.fake_quant_pact(x, alpha, bits=spec.a_bits,
                                      ste=spec.ste)
        scale, zp = self.qparams(x, mode)
        return fq.fake_quant(x, scale, zp, bits=spec.a_bits,
                             signed=spec.act_symmetric,
                             symmetric=spec.act_symmetric, ste=spec.ste)

    def qparams(self, x: torch.Tensor, mode: QuantMode
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The grid a quantizing mode uses for ``x``; ``QUANT_EMA`` in
        training updates the observer first."""
        if mode == QuantMode.QUANT_ONLINE:
            return self._grid(*_batch_range(x))
        if mode == QuantMode.QUANT_EMA:
            if self.training:
                with torch.no_grad():
                    self._observe(x, ema=True)
            return self._grid(self.min, self.max)
        if mode == QuantMode.QUANT:
            return self.act_scale, self.act_zp
        raise ValueError(f"mode {mode} has no quantization grid")

    def _observe(self, x: torch.Tensor, ema: bool) -> None:
        """One min-max or EMA update of the range buffers, on the device:
        the first batch's range, then the running min/max or ``m·old +
        (1 − m)·batch`` (qtpu's observers, count 0 selected by ``where``)."""
        bmin, bmax = _batch_range(x)
        first = self.count == 0
        if ema:
            m = torch.tensor(self.spec.ema_momentum, dtype=torch.float32,
                             device=bmin.device)
            new_min = m * self.min + (1 - m) * bmin
            new_max = m * self.max + (1 - m) * bmax
        else:
            new_min = torch.minimum(self.min, bmin)
            new_max = torch.maximum(self.max, bmax)
        self.min.copy_(torch.where(first, bmin, new_min))
        self.max.copy_(torch.where(first, bmax, new_max))
        self.count.add_(1)

    def _grid(self, xmin: torch.Tensor, xmax: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = self.spec
        if spec.act_symmetric:
            amax = torch.maximum(torch.abs(xmin), torch.abs(xmax))
            return (fq.symmetric_scale(amax, spec.a_bits),
                    torch.zeros((), dtype=torch.float32, device=xmin.device))
        return fq.affine_qparams(xmin, xmax, spec.a_bits)
