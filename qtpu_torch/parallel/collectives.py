"""The collectives of the parallel runtime, over ``torch.distributed``
process groups.

Every collective the runtime issues goes through here, so each is counted
(``counts``: calls per name, the TP forward's all-gathers among them) and
each sees the same rule for tensors the backend cannot take: gloo runs its
collectives on host memory, so a CUDA tensor under gloo is copied to the
host here, explicitly, and back after (``counts["<name>.host_staged"]``);
the compute around it never leaves the card.  Under NCCL nothing is
staged.

* :func:`all_gather` — equal tensors of a group's ranks concatenated along
  ``dim``, in group rank order (the TP channel gather, the model group's
  batch);
* :func:`all_reduce` — the sum (or min / max) over a group, no autograd;
* :func:`all_reduce_sum_grad` — the sum with autograd, its backward the
  same sum of the gradients (the DP trainer's synchronized batch
  statistics);
* :func:`ppermute` — point-to-point sends along ``(src, dst)`` pairs of
  group ranks, qtpu's ``lax.ppermute``: a rank that receives nothing gets
  zeros (the spatial halos, the pipeline's hop);
* :func:`synced_batch` — the data group whose global batch a training
  forward's statistics cover: inside it BatchNorm's batch mean and
  variance (``nn.layers``) and the activation observers' min / max
  (``nn.act_quant``) are reduced over the group (:func:`batch_group`),
  as GSPMD reduces them over qtpu's sharded batch.

Inside :func:`recording` each collective is also recorded — its kind, the
group's size and the bytes of the tensor this rank hands in, taken before
any host staging — for the projection of ``bench.scaling_projection``.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

counts: "collections.Counter[str]" = collections.Counter()


def reset_counts() -> None:
    counts.clear()


_records = None


@contextlib.contextmanager
def recording() -> Iterator[List[dict]]:
    """Within: every collective appends ``{"kind", "group", "bytes"}`` to
    the list this yields (``bytes``: the tensor this rank passes in)."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def _record(kind: str, x: torch.Tensor, group) -> None:
    if _records is not None:
        _records.append(dict(kind=kind, group=dist.get_world_size(group),
                             bytes=x.numel() * x.element_size()))


def _staged(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """``x`` as the group's backend takes it: on the host for a CUDA
    tensor under gloo."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        counts[f"{name}.host_staged"] += 1
        return x.cpu()
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` (equal shapes) concatenated along ``dim`` in group
    rank order, on ``x``'s device."""
    counts["all_gather"] += 1
    _record("all_gather", x, group)
    xs = _staged(x.contiguous(), group, "all_gather")
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, xs, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum", "min" or "max") of the group's ``x``; a new
    tensor on ``x``'s device."""
    counts["all_reduce"] += 1
    _record("all_reduce", x, group)
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    y = _staged(x.detach(), group, "all_reduce").clone()
    dist.all_reduce(y, op=ops[op], group=group)
    return y.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_reduce_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` with autograd: the gradient of every rank's
    input is the group's sum of the output gradients, so the ranks' losses
    differentiate as one loss over the global batch."""
    return _AllReduceSum.apply(x, group)


def ppermute(x: torch.Tensor, group, pairs: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """qtpu's ``lax.ppermute``: this rank sends ``x`` to ``dst`` for its
    ``(me, dst)`` pair and returns what its ``(src, me)`` pair sent, or
    zeros; group ranks in ``pairs``."""
    counts["ppermute"] += 1
    _record("ppermute", x, group)
    me = dist.get_rank(group)
    xs = _staged(x.contiguous(), group, "ppermute")
    out = torch.zeros_like(xs)
    reqs = []
    for src, dst in pairs:
        if src == me:
            reqs.append(dist.isend(xs, dist.get_global_rank(group, dst),
                                   group=group))
        if dst == me:
            reqs.append(dist.irecv(out, dist.get_global_rank(group, src),
                                   group=group))
    for r in reqs:
        r.wait()
    return out.to(x.device)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (equal
    shapes), on ``x``'s device."""
    counts["broadcast"] += 1
    _record("broadcast", x, group)
    y = _staged(x.contiguous(), group, "broadcast").clone()
    dist.broadcast(y, dist.get_global_rank(group, src), group=group)
    return y.to(x.device)


_batch_group = None


@contextlib.contextmanager
def synced_batch(group) -> Iterator[None]:
    """Within: batch statistics reduce over ``group`` (None: local)."""
    global _batch_group
    prev, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = prev


def batch_group():
    """The group batch statistics reduce over, or None."""
    return _batch_group
