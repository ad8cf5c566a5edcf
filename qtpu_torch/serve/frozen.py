"""Frozen serving weights carried across from qtpu.

``from_numpy_tree`` turns qtpu's ``freeze()`` output, given as nested numpy
(``jax.tree_util.tree_map(np.asarray, serve_vars)``), into the port's tree:
the same nesting and leaf names, torch tensors of the same dtypes and
shapes on ``device``.  The static ``act_sym`` leaf is read once into a
Python bool.  ``to_numpy_tree`` is the inverse (``act_sym`` back to a numpy
bool), so a round trip reproduces every leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from qtpu_torch.utils.device import resolve_device


def from_numpy_tree(tree: Mapping[str, Any], device=None) -> dict:
    """Nested mapping of numpy arrays → nested dict of tensors on ``device``
    (``None`` means the card)."""
    dev = resolve_device(device)

    def conv(key, v):
        if isinstance(v, Mapping):
            return {k: conv(k, x) for k, x in v.items()}
        a = np.asarray(v)
        if key == "act_sym":
            return bool(a)
        return torch.tensor(a, device=dev)

    return {k: conv(k, v) for k, v in tree.items()}


def to_numpy_tree(tree: Mapping[str, Any]) -> dict:
    """Inverse of :func:`from_numpy_tree`."""
    def conv(key, v):
        if isinstance(v, Mapping):
            return {k: conv(k, x) for k, x in v.items()
                    if not k.startswith("_")}
        if key == "act_sym":
            return np.asarray(bool(v))
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    return {k: conv(k, v) for k, v in tree.items()}
