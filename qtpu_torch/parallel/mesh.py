"""Meshes of ranks and the sharding rules of the serving runtime (port of
qtpu/parallel/mesh.py).

A :class:`Mesh` names the axes of the world's ranks — ``("data",
"model")`` for serving, ``("data", "spatial")`` and ``("pipe",)`` for the
spatial and pipeline modules — over a ``torch.distributed.device_mesh``
(``init_device_mesh``), one rank per device (``parallel.distributed``).
A one-rank mesh needs no process group.  ``mesh.shape`` maps each axis to
its size, as qtpu's does; ``mesh.group(axis)`` is this rank's process
group along it and ``mesh.coord(axis)`` its index there.

qtpu's rules, with its names:

* ``kernel_q`` is sliced on its output-channel (last) axis; ``w_scale``,
  ``colsum`` and ``bias`` follow when they are 1-D; everything else —
  grids, per-tensor scales, the fp32 ``params`` / ``batch_stats`` of
  excluded layers — is replicated (:func:`serve_variable_specs`);
* a node whose channel count does not divide by ``tp`` is replicated
  instead (:func:`serve_shardings`; the port decides per node, so a node's
  leaves never disagree).  A nibble-packed int4 ``kernel_q`` pairs
  channels (2i, 2i + 1) along that axis, so it is sliced as it lies when
  the slice holds whole pairs; its kernel layout, ``pack_int4_nk``, is
  made from the slice at engine build, pairing along K.

:func:`shard_variables` keeps this rank's slice of each sharded node and
tags the node ``_tp`` (:class:`TPShard`: the ``model`` group, this rank's
index in it, the group's size and the slice's channel range); the flat
engines' fused ops and the module SERVE path run the slice, then gather the
channels over the group where a consumer needs them all
(``serve/fused_ops.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from qtpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec, qtpu's ``PartitionSpec``: one mesh axis name (or
    None) per tensor dimension; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """Named axes over the world's ranks (row-major: the last axis is the
    fastest-varying rank index)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def group(self, axis: str):
        """This rank's process group along ``axis``; None on a one-rank
        mesh or an axis of size 1."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_coordinate()[
            self.axis_names.index(axis)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def mesh_over_ranks(shape: Dict[str, int]) -> Mesh:
    """A mesh of ``shape`` over every rank of the world (sizes multiply to
    the world size)."""
    n = distributed.world_size()
    m = Mesh(shape)
    if m.size != n:
        dims = " * ".join(f"{k}={v}" for k, v in shape.items())
        raise ValueError(f"{dims} = {m.size} != {n} ranks")
    if n == 1:
        return m
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if distributed.backend() == "nccl" else "cpu"
    m.device_mesh = init_device_mesh(kind, tuple(shape.values()),
                                     mesh_dim_names=tuple(shape))
    return m


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ``('data', 'model')`` mesh over the world's ranks."""
    n = distributed.world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return mesh_over_ranks({DATA_AXIS: dp, MODEL_AXIS: tp})


def _qweight_leaf_spec(name: str, leaf) -> P:
    """Sharding rule for one leaf of the ``qweights`` collection."""
    if name == "kernel_q":
        return P(*([None] * (leaf.dim() - 1) + [MODEL_AXIS]))
    if name in ("w_scale", "colsum", "bias") and leaf.dim() == 1:
        return P(MODEL_AXIS)
    return P()


def _is_node(v) -> bool:
    return isinstance(v, dict) and "kernel_q" in v


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return P()


def serve_variable_specs(serve_vars: Dict[str, Any]) -> Dict[str, Any]:
    """The spec of every leaf of a frozen tree (TP over ``model``)."""

    def spec_qweights(tree):
        return {k: (spec_qweights(v) if isinstance(v, dict)
                    else _qweight_leaf_spec(k, v)
                    if isinstance(v, torch.Tensor) else P())
                for k, v in tree.items() if not k.startswith("_")}

    return {col: (spec_qweights(tree) if col == "qweights"
                  else _replicated(tree))
            for col, tree in serve_vars.items()}


def _node_divides(node: Dict[str, Any], tp: int) -> bool:
    """Whether every sharded leaf of ``node`` divides by ``tp``."""
    for k, v in node.items():
        if not isinstance(v, torch.Tensor) or k.startswith("_"):
            continue
        spec = _qweight_leaf_spec(k, v)
        if MODEL_AXIS in spec and v.shape[spec.index(MODEL_AXIS)] % tp:
            return False
    return True


def serve_shardings(serve_vars: Dict[str, Any], mesh: Mesh
                    ) -> Dict[str, Any]:
    """The specs resolved on ``mesh``: a node whose channels do not divide
    by the ``model`` axis is replicated."""
    specs = serve_variable_specs(serve_vars)
    tp = mesh.shape[MODEL_AXIS]

    def resolve(tree, spec):
        if _is_node(tree) and not _node_divides(tree, tp):
            return _replicated(spec)
        return {k: (resolve(tree[k], s) if isinstance(s, dict) else s)
                for k, s in spec.items()}

    return {col: resolve(serve_vars[col], s) for col, s in specs.items()}


class TPShard(NamedTuple):
    """A node's slice on this rank: the ``model`` group, this rank's index
    in it, the group's size and the output channels ``[lo, hi)`` of the
    full node."""
    group: Any
    index: int
    size: int
    lo: int
    hi: int


def shard_variables(serve_vars: Dict[str, Any], mesh: Mesh
                    ) -> Dict[str, Any]:
    """This rank's slice of the serving variables: each sharded node keeps
    its channels ``[i·N/tp, (i+1)·N/tp)`` and is tagged ``_tp``; the rest
    is shared with ``serve_vars``.  A tree already sharded is returned as
    it is."""
    tp = mesh.shape[MODEL_AXIS]
    if tp == 1:
        return serve_vars
    group, idx = mesh.group(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    shardings = serve_shardings(serve_vars, mesh)

    def slice_leaf(v, spec):
        if not isinstance(v, torch.Tensor) or MODEL_AXIS not in spec:
            return v
        d = spec.index(MODEL_AXIS)
        n = v.shape[d] // tp
        return v.narrow(d, idx * n, n).contiguous()

    def walk(tree, spec):
        if _is_node(tree):
            if "_tp" in tree or not any(MODEL_AXIS in s
                                        for s in spec.values()):
                return tree
            n = tree["colsum"].shape[0] // tp
            out = {k: slice_leaf(v, spec.get(k, P()))
                   for k, v in tree.items()}
            out["_tp"] = TPShard(group, idx, tp, idx * n, (idx + 1) * n)
            return out
        if isinstance(tree, dict):
            return {k: walk(v, spec.get(k, {})) for k, v in tree.items()}
        return tree

    return {col: (walk(tree, shardings[col]) if col == "qweights" else tree)
            for col, tree in serve_vars.items()}


def batch_sharding(mesh: Mesh) -> P:
    """Input batches: sharded over ``data``, replicated over ``model``."""
    return P(DATA_AXIS)


def sharded_nodes(tree: Dict[str, Any]) -> int:
    """The number of nodes of a tree that :func:`shard_variables` sliced."""
    if _is_node(tree):
        return int("_tp" in tree)
    if isinstance(tree, dict):
        return sum(sharded_nodes(v) for v in tree.values())
    return 0
