"""Checkpoints on ``torch.save`` (port of qtpu/utils/checkpoint.py).

A checkpoint is a directory holding one file, ``tree.pt``: a nested dict
of tensors written by ``torch.save`` and read back with
``torch.load(..., weights_only=True)``.  Two trees go through it: the
frozen serving tree (``--save-frozen``/``--load-frozen``) and an fp32
model's ``state_dict`` (``examples.run --save-state``/``--load-state``).

``save`` walks a tree as ``serve/frozen.to_numpy_tree`` does: keys that
start with ``_`` (the engines' caches) are dropped, numpy arrays and
Python scalars become tensors, and ``act_sym`` is stored as a bool tensor
that ``load`` turns back into a Python bool.  With ``target`` every leaf's
place in the tree, dtype and shape is checked, and a mismatch raises.  The
format is the port's own: it does not read qtpu's orbax trees.
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

FILE = "tree.pt"


def _to_saved(key, v):
    if isinstance(v, Mapping):
        return {k: _to_saved(k, x) for k, x in v.items()
                if not str(k).startswith("_")}
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    a = np.asarray(v)
    if key == "act_sym":
        a = a.astype(bool)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _from_saved(key, v, device):
    if isinstance(v, Mapping):
        return {k: _from_saved(k, x, device) for k, x in v.items()}
    if key == "act_sym":
        return bool(v)
    return v.to(device)


def save(path: str, tree: Mapping[str, Any]) -> None:
    """Write ``tree`` to the directory ``path`` (created; an earlier
    checkpoint there is replaced whole)."""
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, FILE)
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(_to_saved(None, tree), tmp)
    os.replace(tmp, dst)


def _check(got, want, where: str) -> None:
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != {
                k for k in want if not str(k).startswith("_")}:
            raise ValueError(
                f"checkpoint structure at {where or '/'}: keys "
                f"{sorted(got) if isinstance(got, Mapping) else type(got)}"
                f" != target's {sorted(want)}")
        for k in got:
            _check(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, bool) or isinstance(got, bool):
        if not (isinstance(want, bool) and isinstance(got, bool)):
            raise ValueError(f"checkpoint leaf {where}: {type(got).__name__}"
                             f" where the target has {type(want).__name__}")
        return
    w = torch.as_tensor(want) if not isinstance(want, torch.Tensor) else want
    if got.dtype != w.dtype or tuple(got.shape) != tuple(w.shape):
        raise ValueError(
            f"checkpoint leaf {where}: {got.dtype} {tuple(got.shape)} != "
            f"target's {w.dtype} {tuple(w.shape)}")


def load(path: str, target: Optional[Mapping[str, Any]] = None,
         device=None) -> dict:
    """The tree saved at ``path``, its tensors on ``device`` (``None``: the
    CPU, as stored).  ``target``: a tree whose structure, dtypes and shapes
    the checkpoint must match leaf for leaf."""
    raw = torch.load(os.path.join(path, FILE), map_location="cpu",
                     weights_only=True)
    tree = _from_saved(None, raw, torch.device(device or "cpu"))
    if target is not None:
        _check(tree, target, "")
    return tree
