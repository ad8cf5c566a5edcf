"""Pipeline parallelism — stage-partitioned inference over a ``'pipe'``
mesh axis (port of qtpu/parallel/pipeline.py).

The GPipe schedule of qtpu's single SPMD program, one stage per rank: each
of ``n_micro + n − 1`` ticks every rank runs its stage on the activation it
received and sends its output one hop on (``collectives.ppermute`` over
the ``pipe`` group — a neighbour transfer, never a broadcast); rank 0 feeds
microbatch ``t`` at tick ``t``, and the last rank's outputs from tick
``n − 1`` on are the results, broadcast to every rank.  The bubble is
``(n − 1) / (n_micro + n − 1)``.  Stages must keep the activation's shape
and dtype.

In the rank model a rank holds exactly its own stage's parameters:
:func:`stage_local` takes them from a tree stacked on a leading stage axis
(qtpu's ``stage_sharding`` placement).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from qtpu_torch.parallel import collectives, distributed
from qtpu_torch.parallel.mesh import Mesh, P, mesh_over_ranks

PIPE_AXIS = "pipe"


def make_pipeline_mesh(stages: int) -> Mesh:
    """One-axis ``('pipe',)`` mesh, one rank per stage."""
    n = distributed.world_size()
    if stages != n:
        raise ValueError(f"{stages} stages != {n} ranks")
    return mesh_over_ranks({PIPE_AXIS: stages})


def stage_sharding(mesh: Mesh) -> P:
    """Stacked stage parameters: the leading (stage) axis over ``pipe``."""
    return P(PIPE_AXIS)


def stage_local(stacked: Any, mesh: Mesh) -> Any:
    """This rank's stage of a pytree (dict, list, tuple or tensor) whose
    leaves are stacked on a leading stage axis."""
    i = mesh.coord(PIPE_AXIS)
    if isinstance(stacked, dict):
        return {k: stage_local(v, mesh) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(stage_local(v, mesh) for v in stacked)
    return stacked[i]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """Run ``n_micro`` microbatches through the ranks' stages.

    ``stage_fn(params, x) -> y`` applies one stage (same shape and dtype);
    ``stage_params``: this rank's stage (:func:`stage_local`);
    ``x_micro``: ``(n_micro, mb, ...)``, the same on every rank.  Returns
    ``(n_micro, mb, ...)``, the same on every rank."""
    n = mesh.shape[PIPE_AXIS]
    idx = mesh.coord(PIPE_AXIS)
    group = mesh.group(PIPE_AXIS)
    n_micro = x_micro.shape[0]
    act = torch.zeros_like(x_micro[0])
    ys = []
    for t in range(n_micro + n - 1):
        recv = (collectives.ppermute(act, group,
                                     [(j, j + 1) for j in range(n - 1)])
                if n > 1 else act)
        x_in = (x_micro[t] if t < n_micro else torch.zeros_like(act)) \
            if idx == 0 else recv
        act = stage_fn(stage_params, x_in)
        if act.shape != x_in.shape or act.dtype != x_in.dtype:
            raise ValueError(
                f"stage {idx} maps {tuple(x_in.shape)} {x_in.dtype} to "
                f"{tuple(act.shape)} {act.dtype}: stages must keep the "
                "activation's shape and dtype")
        ys.append(act)
    out = torch.stack(ys[n - 1:]).contiguous()      # the last stage's exits
    if n > 1:
        out = collectives.broadcast(out, group, src=n - 1)
    return out
