"""Training and evaluation loops: fp32 training and STE-based QAT through
one loop (port of qtpu/train/loop.py).

A step is the forward with fake-quant applied to the live fp32 master
weights, the mean cross-entropy, backprop through the dequantized values
into the masters (STE), and an AdamW update — qtpu's ``optax.adamw(lr)``:
``torch.optim.AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)``, one group over every parameter (torch's default
decay is 1e-2).  A parameter the step gave no gradient gets a zero one, so
its decay still applies, as optax's does.  BatchNorm's running statistics
and the activation observers update in the same forward: the model is in
``train()`` mode, where qtpu's ``batch_stats`` / ``quant_stats`` are
mutable.  The forward and backward run with TF32 off
(``utils.device.fp32_exact``): cuDNN would otherwise run the fp32 convs —
the statistics conv, the simulation's conv, the conv transposes — in TF32
and move the codes.

``evaluate`` keeps the remainder batch (dropping it reported accuracy over
a truncated set).  ``fit`` shuffles each epoch with ``batches(seed=seed +
epoch)``.

Data-parallel training (``mesh=``, a ``parallel.mesh`` with a ``data``
axis; qtpu's ``make_train_step(mesh=)`` / ``fit(mesh=)``): every rank is
given the same global batch and runs its own rows of it; BatchNorm's batch
statistics and the observers' min / max are those of the global batch
(``parallel.collectives.synced_batch``, SyncBN-like), the gradients are
averaged over ``data``, and the state stays replicated — the step is the
single-process step on the global batch, up to f32 summation order.  A
batch that does not divide by the axis raises ``ValueError``.  A data axis
of one rank reduces over nothing: its step is the single-process step.

Compiled steps (qtpu jits both, qtpu/train/loop.py:70, :100): on a card,
with no mesh or a one-rank data axis, ``train_step`` keeps one CUDA graph
per batch shape in its :class:`TrainState` — two eager steps, then the
third captured and replayed, every later one replayed
(``train/graphs.py``) — and ``eval_step`` / ``evaluate`` keep one per batch
shape for the model (the remainder batch is a second).  A data axis of
several ranks stays eager: gloo's collectives go through the host, which a
graph cannot hold (ROADMAP C21).  A step that cannot be captured raises
(``GraphCaptureError``): nothing falls back to eager.  On the card AdamW is
``capturable`` (its step count stays on the device), in eager and graphed
steps alike; the CPU keeps torch's default.  ``TrainState.run_eagerly()``
and ``graphed=False`` turn the graphs off, for measuring a step against
its graph only; the trainer never does.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.data import Dataset, batches
from qtpu_torch.parallel import collectives
from qtpu_torch.parallel.mesh import DATA_AXIS
from qtpu_torch.train.graphs import (StepGraph, capture_eval_step,
                                     capture_train_step, eager_on_side_stream,
                                     step_key, step_plan)
from qtpu_torch.utils.device import fp32_exact


def adamw(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """qtpu's ``optax.adamw(lr)`` over every parameter of ``model``;
    ``capturable`` on the card (its step count on the device, which a CUDA
    graph needs)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4,
                             capturable=_device(model).type == "cuda")


@dataclasses.dataclass
class TrainState:
    """The model (parameters, BatchNorm and observer state), its optimizer
    and the count of steps taken; on the card also the steps' CUDA graphs
    (``graphs``: key → ``train.graphs.StepGraph``, freed with the state)
    and the steps seen at each key."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    graphed: bool = True
    graphs: Dict[tuple, StepGraph] = dataclasses.field(
        default_factory=dict)
    seen: Dict[tuple, int] = dataclasses.field(default_factory=dict)

    def run_eagerly(self) -> None:
        """Run this state's steps eagerly on the card too, with no graph —
        for measuring a step against its graph only; the trainer never
        calls it."""
        self.graphed = False
        self.graphs.clear()
        self.seen.clear()

    def graph_bytes(self) -> int:
        """The device memory this state's graphs hold."""
        return sum(g.nbytes for g in self.graphs.values())


def create_train_state(model: nn.Module, lr: float = 1e-3) -> TrainState:
    return TrainState(model, adamw(model, lr))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels.long())


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _host(x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(np.asarray(x, np.float32)),
            torch.as_tensor(np.asarray(y)).long())


def _tensors(model, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = _device(model)
    xh, yh = _host(x, y)
    return xh.to(dev), yh.to(dev)


def graphs_on(dev: torch.device, dp: int, graphed: bool = True) -> bool:
    """Whether a step on ``dev`` over a data axis of ``dp`` ranks replays a
    CUDA graph: on a card, one rank, graphs not turned off."""
    return dev.type == "cuda" and dp == 1 and graphed


def _data_group(mesh):
    """(the ``data`` group or None, its size, this rank's index)."""
    if mesh is None:
        return None, 1, 0
    return (mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS],
            mesh.coord(DATA_AXIS))


def _check_divides(batch_size: int, dp: int) -> None:
    if batch_size % dp:
        raise ValueError(f"global batch_size={batch_size} must divide by "
                         f"the data axis ({dp})")


def train_step(state: TrainState, x, y, mesh=None) -> dict:
    """One step on a batch (NHWC images, integer labels): ``{"loss",
    "acc"}`` as 0-d tensors on the model's device.  With ``mesh`` the batch
    is the global one, every rank runs its rows and the metrics are the
    global batch's.  On a card with one rank the step replays its batch
    shape's CUDA graph from the third step at that shape on."""
    model = state.model
    group, dp, i = _data_group(mesh)
    if dp > 1:
        _check_divides(len(x), dp)
        b = len(x) // dp
        x, y = x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]
    else:
        group = None        # one rank: a reduction over it is the identity
    model.train()
    dev = _device(model)
    if graphs_on(dev, dp, state.graphed):
        loss, acc = _graphed_step(state, *_host(x, y), dev)
    else:
        loss, acc = _step(state, *_tensors(model, x, y), group, dp)
    state.step += 1
    return {"loss": loss, "acc": acc}


def _graphed_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                  dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step as its key's graph plans it (``step_plan``); the metrics
    are copies."""
    key = step_key(state.model, x, y)
    seen = state.seen.get(key, 0)
    state.seen[key] = seen + 1

    def step(xd, yd):
        return _step(state, xd, yd, None, 1)
    plan = step_plan(seen)
    if plan == "eager":
        return eager_on_side_stream(step, x, y, dev)
    if plan == "capture":
        state.graphs[key] = capture_train_step(step, x, y, dev, state.model)
    loss, acc = state.graphs[key].replay(x, y)
    return loss.clone(), acc.clone()


def _step(state: TrainState, x: torch.Tensor, y: torch.Tensor, group,
          dp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward, loss, backward, AdamW: (loss, acc) of the step, reduced
    over ``group`` when there is one."""
    model = state.model
    with fp32_exact(), collectives.synced_batch(group):
        logits = model(x)
        loss = cross_entropy(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    for pg in state.optimizer.param_groups:
        for p in pg["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif group is not None:
                # the ranks' losses differentiate as one (the synced
                # statistics' backward sums across ranks): their mean is
                # the global batch's gradient
                p.grad = collectives.all_reduce(p.grad, group) / dp
    state.optimizer.step()
    acc = (logits.detach().argmax(-1) == y).float().mean()
    loss = loss.detach()
    if group is not None:
        loss = collectives.all_reduce(loss, group) / dp
        acc = collectives.all_reduce(acc, group) / dp
    return loss, acc


# each model's evaluation graphs (key → StepGraph), freed with it
_EVAL_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, dict]" = (
    weakref.WeakKeyDictionary())


def _hits(model: nn.Module, x: torch.Tensor, y: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    with fp32_exact():
        logits = model(x)
    top1 = logits.argmax(-1) == y
    top5 = (torch.argsort(logits, dim=-1, stable=True)[:, -5:]
            == y[:, None]).any(-1)
    return top1.sum(), top5.sum()


@torch.no_grad()
def eval_step(model: nn.Module, x, y, graphed: bool = True
              ) -> Tuple[int, int]:
    """(top-1 hits, top-5 hits) of one batch, in eval mode; on a card the
    model's graph for this batch shape, captured at its first batch
    (``graphed=False``: eager, for measurement only)."""
    model.eval()
    dev = _device(model)
    if not graphs_on(dev, 1, graphed):
        t1, t5 = _hits(model, *_tensors(model, x, y))
        return int(t1), int(t5)
    x, y = _host(x, y)
    held = _EVAL_GRAPHS.setdefault(model, {})
    key = step_key(model, x, y)
    if key not in held:
        held[key] = capture_eval_step(
            lambda xd, yd: _hits(model, xd, yd), x, y, dev, model)
    t1, t5 = held[key].replay(x, y)
    return int(t1), int(t5)


def eval_graphs(model: nn.Module) -> Dict[tuple, StepGraph]:
    """The evaluation graphs kept for ``model`` (key → StepGraph)."""
    return dict(_EVAL_GRAPHS.get(model, {}))


def evaluate(model: nn.Module, ds: Dataset, batch_size: int = 256,
             graphed: bool = True) -> Tuple[float, float]:
    """(top-1, top-5) accuracy over a dataset, the remainder batch kept
    (on a card one graph per batch shape; ``graphed=False``: eager, for
    measurement only)."""
    n = c1 = c5 = 0
    for x, y in batches(ds, batch_size, shuffle=False, drop_remainder=False):
        t1, t5 = eval_step(model, x, y, graphed)
        c1 += t1
        c5 += t5
        n += len(y)
    if n == 0:
        return 0.0, 0.0
    return c1 / n, c5 / n


def fit(model: nn.Module, train_ds: Dataset, *, epochs: int = 1,
        batch_size: int = 128, lr: float = 1e-3,
        eval_ds: Optional[Dataset] = None, log_every: int = 0,
        json_logs: bool = False, seed: int = 0, mesh=None) -> TrainState:
    """Train ``model`` (fp32 or converted: QAT runs through the same loop)
    with a fresh AdamW for ``epochs`` epochs of shuffled, full batches.
    ``json_logs`` prints one JSON line per log event instead of text.
    ``mesh``: data-parallel over its ``data`` axis; ``batch_size`` is the
    global batch and must divide by it, and rank 0's model state is
    broadcast first, so every rank starts from the same one."""
    group, dp, _ = _data_group(mesh)
    _check_divides(batch_size, dp)
    if group is not None:
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                t.copy_(collectives.broadcast(t, group, src=0))
    state = create_train_state(model, lr)

    def log(payload: dict, text: str) -> None:
        print(json.dumps(payload) if json_logs else text, flush=True)

    for epoch in range(epochs):
        for i, (x, y) in enumerate(batches(train_ds, batch_size,
                                           seed=seed + epoch)):
            metrics = train_step(state, x, y, mesh=mesh)
            if log_every and i % log_every == 0:
                loss, acc = float(metrics["loss"]), float(metrics["acc"])
                log({"event": "train", "epoch": epoch, "step": i,
                     "loss": round(loss, 4), "acc": round(acc, 4)},
                    f"epoch {epoch} step {i}: loss={loss:.4f} acc={acc:.3f}")
        if eval_ds is not None:
            t1, t5 = evaluate(state.model, eval_ds, batch_size)
            log({"event": "eval", "epoch": epoch, "top1": round(t1, 4),
                 "top5": round(t5, 4)},
                f"epoch {epoch}: eval top1={t1:.4f} top5={t5:.4f}")
    return state
