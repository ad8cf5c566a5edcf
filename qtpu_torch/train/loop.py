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
batch that does not divide by the axis raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from qtpu_torch.data import Dataset, batches
from qtpu_torch.parallel import collectives
from qtpu_torch.parallel.mesh import DATA_AXIS
from qtpu_torch.utils.device import fp32_exact


def adamw(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """qtpu's ``optax.adamw(lr)`` over every parameter of ``model``."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


@dataclasses.dataclass
class TrainState:
    """The model (parameters, BatchNorm and observer state), its optimizer
    and the count of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, lr: float = 1e-3) -> TrainState:
    return TrainState(model, adamw(model, lr))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels.long())


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensors(model, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = _device(model)
    return (torch.as_tensor(np.asarray(x, np.float32)).to(dev),
            torch.as_tensor(np.asarray(y)).to(dev).long())


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
    global batch's."""
    model = state.model
    group, dp, i = _data_group(mesh)
    if dp > 1:
        _check_divides(len(x), dp)
        b = len(x) // dp
        x, y = x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]
    x, y = _tensors(model, x, y)
    model.train()
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
    state.step += 1
    acc = (logits.detach().argmax(-1) == y).float().mean()
    loss = loss.detach()
    if group is not None:
        loss = collectives.all_reduce(loss, group) / dp
        acc = collectives.all_reduce(acc, group) / dp
    return {"loss": loss, "acc": acc}


@torch.no_grad()
def eval_step(model: nn.Module, x, y) -> Tuple[int, int]:
    """(top-1 hits, top-5 hits) of one batch, in eval mode."""
    x, y = _tensors(model, x, y)
    model.eval()
    with fp32_exact():
        logits = model(x)
    top1 = logits.argmax(-1) == y
    top5 = (torch.argsort(logits, dim=-1, stable=True)[:, -5:]
            == y[:, None]).any(-1)
    return int(top1.sum()), int(top5.sum())


def evaluate(model: nn.Module, ds: Dataset, batch_size: int = 256
             ) -> Tuple[float, float]:
    """(top-1, top-5) accuracy over a dataset, the remainder batch kept."""
    n = c1 = c5 = 0
    for x, y in batches(ds, batch_size, shuffle=False, drop_remainder=False):
        t1, t5 = eval_step(model, x, y)
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
