"""Quantization configuration: per-layer specs, the model-wide policy and
the quantization modes (port of qtpu/nn/config.py).

* :class:`QuantMode` — what a converted model's forward does: fp32
  (``OFF``), observe activation ranges (``CALIB_RANGE``) or histograms
  (``CALIB_HIST``), fake-quantize with per-batch ranges
  (``QUANT_ONLINE``), with the EMA observer (``QUANT_EMA``, QAT) or with
  frozen calibrated grids (``QUANT``); ``SERVE`` is the integer execution
  of :mod:`qtpu_torch.nn.serve_layers`;
* :class:`LayerQuantSpec` — how one layer quantizes (bits, granularity,
  observer, straight-through estimator, PACT's initial clip);
* :class:`QuantPolicy` — default spec, ``fnmatch`` exclude globs and
  per-layer overrides over the "/"-joined layer path (the reference's
  ``exclude=[first, last]`` idiom), the mode, and the QAT settings
  ``fold_bn``, ``fake_bn`` (``"exact"``: a statistics conv on the fp32
  input and weights folded by the batch σ; ``"approx"``: weights folded
  by the running σ, the output un-scaled, then batch-statistics BN) and
  ``qat_forward`` (``"sim"``: the fp32 conv of fake-quantized operands;
  ``"int"``: the same function on the integer kernels,
  :mod:`qtpu_torch.ops.qat_int`).
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
from typing import Optional, Tuple


class QuantMode(enum.Enum):
    """Execution mode of a converted model."""

    OFF = "off"
    CALIB_RANGE = "calib_range"
    CALIB_HIST = "calib_hist"
    QUANT_ONLINE = "quant_online"
    QUANT_EMA = "quant_ema"
    QUANT = "quant"
    SERVE = "serve"

    @property
    def is_calib(self) -> bool:
        return self in (QuantMode.CALIB_RANGE, QuantMode.CALIB_HIST)

    @property
    def quantizes(self) -> bool:
        return self in (QuantMode.QUANT_ONLINE, QuantMode.QUANT_EMA,
                        QuantMode.QUANT)


@dataclasses.dataclass(frozen=True)
class LayerQuantSpec:
    """Symmetric per-channel int8 weights, affine int8 activations and the
    pass-through STE by default, as the reference."""

    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    act_observer: str = "minmax"      # 'minmax' | 'ema' | 'kl' | 'pact'
    act_symmetric: bool = False
    ema_momentum: float = 0.99        # the 'ema' observer's momentum
    ste: str = "passthrough"          # 'passthrough' | 'clip'
    quantize_weights: bool = True
    quantize_acts: bool = True
    pact_init: float = 6.0            # PACT's initial clip α

    def __post_init__(self):
        if self.act_observer not in ("minmax", "ema", "kl", "pact"):
            raise ValueError(f"unknown act_observer {self.act_observer!r}")
        if self.act_observer == "kl" and not self.act_symmetric:
            object.__setattr__(self, "act_symmetric", True)
        if self.act_observer == "pact" and self.act_symmetric:
            raise ValueError("PACT activations are affine (act_symmetric "
                             "must be False)")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Model-wide policy resolved per layer path with ``fnmatch`` globs."""

    default: LayerQuantSpec = LayerQuantSpec()
    exclude: Tuple[str, ...] = ()
    overrides: Tuple[Tuple[str, LayerQuantSpec], ...] = ()
    mode: QuantMode = QuantMode.QUANT_ONLINE
    fold_bn: bool = True
    fake_bn: str = "exact"            # 'exact' | 'approx'
    qat_forward: str = "sim"          # 'sim' | 'int'

    def __post_init__(self):
        if self.fake_bn not in ("exact", "approx"):
            raise ValueError(f"unknown fake_bn scheme {self.fake_bn!r}")
        if self.qat_forward not in ("sim", "int"):
            raise ValueError(f"unknown qat_forward {self.qat_forward!r}")

    def spec_for(self, path: str) -> Optional[LayerQuantSpec]:
        """Spec for the layer at ``path``, or None if excluded."""
        if any(fnmatch.fnmatch(path, pat) for pat in self.exclude):
            return None
        for pat, spec in self.overrides:
            if fnmatch.fnmatch(path, pat):
                return spec
        return self.default

    def with_mode(self, mode: QuantMode) -> "QuantPolicy":
        return dataclasses.replace(self, mode=mode)

    @staticmethod
    def int8_ptq(**kw) -> "QuantPolicy":
        """Per-channel INT8 weights + affine INT8 acts, offline calibration."""
        return QuantPolicy(default=LayerQuantSpec(), mode=QuantMode.QUANT,
                           **kw)

    @staticmethod
    def int8_qat(**kw) -> "QuantPolicy":
        """INT8 QAT: EMA-tracked activation ranges, STE gradients."""
        return QuantPolicy(default=LayerQuantSpec(act_observer="ema"),
                           mode=QuantMode.QUANT_EMA, **kw)

    @staticmethod
    def int4_weight_only(a_bits: int = 8, **kw) -> "QuantPolicy":
        """INT4 weights + INT8 acts (BASELINE config 5)."""
        return QuantPolicy(
            default=LayerQuantSpec(w_bits=4, a_bits=a_bits,
                                   act_observer="ema"),
            mode=QuantMode.QUANT_EMA, **kw)

    @staticmethod
    def int8_qat_pact(w_bits: int = 8, **kw) -> "QuantPolicy":
        """QAT with PACT's learnable activation clip."""
        return QuantPolicy(
            default=LayerQuantSpec(w_bits=w_bits, act_observer="pact"),
            mode=QuantMode.QUANT_EMA, **kw)
