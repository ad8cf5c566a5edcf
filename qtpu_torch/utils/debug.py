"""Debug-mode numeric assertions for the integer core (port of qtpu.utils.debug).

Same toggle as the reference: ``QTPU_DEBUG=1`` in the environment, or
``debug.enable()`` in code.  Disabled, every check is a single ``if``.

* ``check_int_inputs`` — integer-kernel inputs must be int8 tensors (int4
  is nibble-packed inside int8 storage), weights of rank 2 or 4;
* ``check_quant_grid`` — grid scale/zero-point of rank 0 or 1, numeric;
* ``check_frozen_node`` — eager value checks on one frozen layer: finite
  positive scales, int8 storage, codes inside the grid, colsum consistency,
  an int32 zero-point on the signed int8 grid.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_enabled = os.environ.get("QTPU_DEBUG", "").lower() in ("1", "true", "on")


def enable(on: bool = True) -> None:
    """Turn debug checks on/off process-wide (tests; overrides QTPU_DEBUG)."""
    global _enabled
    _enabled = bool(on)


def check_int_inputs(x_q: torch.Tensor, w_q: Optional[torch.Tensor] = None,
                     *, what: str = "qop") -> None:
    if not _enabled:
        return
    if x_q.dtype != torch.int8:
        raise AssertionError(f"{what}: activation dtype {x_q.dtype} != int8")
    if w_q is not None:
        if w_q.dtype != torch.int8:
            raise AssertionError(f"{what}: weight dtype {w_q.dtype} != int8")
        if w_q.dim() not in (2, 4):
            raise AssertionError(f"{what}: weight rank {w_q.dim()} not in "
                                 "{2, 4}")


def check_quant_grid(scale, zp=None, *, what: str = "grid") -> None:
    if not _enabled:
        return
    for name, v in (("scale", scale), ("zp", zp)):
        if v is None:
            continue
        t = torch.as_tensor(v)
        if t.dim() not in (0, 1):
            raise AssertionError(f"{what}: {name} rank {t.dim()} not in {{0, 1}}")
        if t.dtype == torch.bool or t.is_complex():
            raise AssertionError(f"{what}: {name} dtype {t.dtype} is not numeric")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def check_frozen_node(node: Dict[str, torch.Tensor], *, bits: int,
                      packed: bool, path: str = "") -> None:
    if not _enabled:
        return
    where = f"frozen[{path}]"
    w_q = _np(node["kernel_q"])
    if w_q.dtype != np.int8:
        raise AssertionError(f"{where}: kernel_q dtype {w_q.dtype} != int8")
    for name in ("w_scale", "act_scale"):
        s = _np(node[name]).astype(np.float64)
        if not np.all(np.isfinite(s)):
            raise AssertionError(f"{where}: {name} has non-finite entries")
        if not np.all(s > 0):
            raise AssertionError(f"{where}: {name} has non-positive entries")
    if not np.all(np.isfinite(_np(node["bias"]).astype(np.float64))):
        raise AssertionError(f"{where}: bias has non-finite entries")
    zp = _np(node["act_zp"])
    if zp.dtype != np.int32:
        raise AssertionError(f"{where}: act_zp dtype {zp.dtype} != int32")
    if not -128 <= int(zp) <= 127:
        raise AssertionError(f"{where}: act_zp {int(zp)} off the signed grid")
    if packed:
        from qtpu_torch.ops import fakequant as fq
        w_codes = _np(fq.unpack_int4(torch.from_numpy(w_q), axis=-1))
    else:
        w_codes = w_q
    qmax = (1 << (bits - 1)) - 1
    if w_codes.min() < -qmax or w_codes.max() > qmax:
        raise AssertionError(
            f"{where}: weight codes [{w_codes.min()}, {w_codes.max()}] "
            f"outside the symmetric int{bits} grid ±{qmax}")
    colsum = _np(node["colsum"]).astype(np.int64)
    ref = w_codes.astype(np.int64).reshape(-1, w_codes.shape[-1]).sum(0)
    if not np.array_equal(colsum, ref):
        raise AssertionError(f"{where}: colsum disagrees with kernel codes")
