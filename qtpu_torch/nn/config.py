"""Quantization configuration: per-layer specs and the model-wide policy
(port of qtpu/nn/config.py, PTQ subset).

* :class:`LayerQuantSpec` — how one layer quantizes (bits, granularity,
  observer);
* :class:`QuantPolicy` — default spec, ``fnmatch`` exclude globs and
  per-layer overrides over the "/"-joined layer path (the reference's
  ``exclude=[first, last]`` idiom).

The quantization modes, STE choice, PACT and fake-BN settings arrive with
the QAT slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerQuantSpec:
    """Symmetric per-channel int8 weights and affine int8 activations by
    default, as the reference."""

    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    act_observer: str = "minmax"      # 'minmax' | 'ema' | 'kl' | 'pact'
    act_symmetric: bool = False
    ema_momentum: float = 0.99        # the 'ema' observer's momentum
    quantize_weights: bool = True
    quantize_acts: bool = True

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

    def spec_for(self, path: str) -> Optional[LayerQuantSpec]:
        """Spec for the layer at ``path``, or None if excluded."""
        if any(fnmatch.fnmatch(path, pat) for pat in self.exclude):
            return None
        for pat, spec in self.overrides:
            if fnmatch.fnmatch(path, pat):
                return spec
        return self.default

    @staticmethod
    def int8_ptq(**kw) -> "QuantPolicy":
        """Per-channel INT8 weights + affine INT8 acts, offline calibration."""
        return QuantPolicy(default=LayerQuantSpec(), **kw)
