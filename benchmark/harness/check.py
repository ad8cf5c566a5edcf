"""The comparison that decides ``correct``.

The timed path's logits — a sample drawn from the seed of what the window
returned — against the plain reference's (``benchmark/reference``), which
calibrates, freezes and runs again from the weights, calibration batches
and pixels the benchmark made, after the window has closed and the
system's state is freed.  The numbers compared, each with its limit from
the configuration file (``correctness.limits``):

* ``logits_rel_l2_max``: over the sampled images, the largest ‖program −
  reference‖₂ / ‖reference‖₂ of an image's logits;
* ``missing``: sampled outputs that never came back (limit 0);
* ``failed``: requests of the window that failed or never came back
  (limit 0).

The control is the reference itself computed one precision lower (int4
weights, ``w_bits=4``) in the program's place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import pipeline as ref


def rel_l2_max(prog: np.ndarray, want: np.ndarray) -> float:
    p = np.asarray(prog, np.float64)
    w = np.asarray(want, np.float64)
    num = np.linalg.norm(p - w, axis=1)
    den = np.maximum(np.linalg.norm(w, axis=1), 1e-30)
    return float(np.max(num / den)) if len(p) else 0.0


class Reference:
    """The plain reference of one configuration on the run's inputs."""

    def __init__(self, cfg: dict, params: Dict, calib: List[torch.Tensor],
                 device):
        self.cfg = cfg
        self.arch = ref.arch_module(cfg["architecture"])
        self.exclude = cfg["quantization"]["exclude"]
        self.params = params
        self.calib = calib
        ing = cfg["ingest"]
        self.coeffs = ref.normalize_coeffs(ing["mean"], ing["std"], device)
        self.device = device
        self._ranges = None

    def logits(self, x_u8: torch.Tensor, w_bits: int = 8,
               rows: int = 128) -> np.ndarray:
        if self._ranges is None:
            self._ranges = ref.calibrate(self.arch, self.cfg, self.params,
                                         self.calib, self.exclude)
        tree = ref.freeze(self.arch, self.cfg, self.params, self._ranges,
                          self.exclude, w_bits)
        out = ref.logits(self.arch, self.cfg, tree, x_u8.to(self.device),
                         self.coeffs, rows)
        return out.cpu().numpy()


def checks(prog: np.ndarray, want: np.ndarray, missing: int, failed: int,
           limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}})."""
    out = {"logits_rel_l2_max": {"value": rel_l2_max(prog, want),
                                 "limit": float(limits["logits_rel_l2_max"])},
           "missing": {"value": int(missing), "limit": 0},
           "failed": {"value": int(failed), "limit": 0}}
    ok = all(c["value"] <= c["limit"] for c in out.values())
    return ok, out
