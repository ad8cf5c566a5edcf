"""The training and evaluation steps compiled per step shape: one CUDA
graph a shape.

qtpu wraps its training step and its evaluation step in ``jax.jit``
(qtpu/train/loop.py ``make_train_step``, ``make_eval_step``), so a step is
one compiled program per input shape.  The port's counterpart is a CUDA
graph of the whole step — for training the forward, the loss, the
backward, the zero gradients of parameters that got none, AdamW's update
and the metrics; for evaluation the forward and the top-1 / top-5 counts —
captured once a shape and replayed, with no Python between the kernels.

A graph is kept per :func:`step_key`: the batch's shapes and dtypes, the
model's policy, and the storage of every parameter and buffer (a graph
holds their addresses, so a model whose tensors were replaced gets a new
one).  Training (``train.loop.train_step``): the first two steps at a key
run eagerly on a side stream — real steps; they allocate AdamW's state and
initialise cuBLAS and cuDNN, as PyTorch's capture recipe needs — the third
is captured and then replayed once for its own batch, and every later step
copies its batch into the static inputs and replays (:func:`step_plan`).
Evaluation (``eval_step`` / ``evaluate``): two forwards without gradients
on a side stream, checked to change no buffer (eval mode mutates nothing:
BatchNorm's running statistics and the observers stay), then the capture.
The capture is ``utils.graphs.capture_call``'s: a call that breaks it
raises :class:`~qtpu_torch.utils.graphs.GraphCaptureError`, and nothing
falls back to eager.  Launch counters move on every replay by the counts
the capture recorded.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from qtpu_torch.utils.graphs import (GraphCaptureError, add_counts,
                                     capture_call, launch_counters)

WARMUP_STEPS = 2     # eager training steps at a key before its capture

Step = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]


def step_key(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """What a step is compiled for: x's and y's shapes and dtypes, the
    model's policy (``model.quant``) and mode, and the storage of its
    parameters and buffers."""
    return (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
            getattr(model, "quant", None), model.training,
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                        model.buffers())))


def step_plan(seen: int) -> str:
    """What a training step does when ``seen`` steps of its key came
    before it: ``"eager"`` (the first two), ``"capture"`` (the third: it
    is then replayed), ``"replay"``."""
    if seen < WARMUP_STEPS:
        return "eager"
    return "capture" if seen == WARMUP_STEPS else "replay"


class StepGraph:
    """One key's captured step: ``static_x``, ``static_y`` → ``graph`` →
    ``outputs`` (static tensors every replay overwrites); ``launches``:
    the counts one replay adds; ``nbytes``: the device memory it holds (its
    pool and the static inputs); ``grads``: (parameter, its gradient in the
    pool), put back on the parameters after every replay."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", static_x: torch.Tensor,
                 static_y: torch.Tensor, outputs: Tuple[torch.Tensor, ...],
                 launches: Dict[str, int], nbytes: int,
                 grads: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()):
        self.graph = graph
        self.static_x, self.static_y = static_x, static_y
        self.outputs = outputs
        self.launches = launches
        self.nbytes = nbytes
        self.grads = tuple(grads)
        self._counters = launch_counters()

    def replay(self, x: torch.Tensor, y: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
        """Copy the batch in, replay, and return the static outputs (copy
        them before the next replay)."""
        self.static_x.copy_(x, non_blocking=True)
        self.static_y.copy_(y, non_blocking=True)
        self.graph.replay()
        add_counts(self._counters, self.launches)
        for p, g in self.grads:
            p.grad = g
        return self.outputs


def _statics(x: torch.Tensor, y: torch.Tensor, device: torch.device):
    sx = torch.empty(x.shape, dtype=x.dtype, device=device)
    sy = torch.empty(y.shape, dtype=y.dtype, device=device)
    sx.copy_(x)
    sy.copy_(y)
    return sx, sy


def eager_on_side_stream(step: Step, x: torch.Tensor, y: torch.Tensor,
                         device: torch.device) -> Tuple[torch.Tensor, ...]:
    """One eager step on a side stream (the batch moved to ``device``
    first), its outputs copied on the current stream."""
    x, y = x.to(device), y.to(device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = step(x, y)
    cur.wait_stream(side)
    return tuple(t.clone() for t in out)


def capture_train_step(step: Step, x: torch.Tensor, y: torch.Tensor,
                       device: torch.device, model: nn.Module) -> StepGraph:
    """Capture one training step of ``model`` at this batch's key (the
    batch is copied into the static inputs; the step is not run: replay
    it)."""
    sx, sy = _statics(x, y, device)
    graph, out, launches, pool = capture_call(
        lambda: step(sx, sy), device,
        f"the training step at batch {tuple(x.shape)}")
    grads = [(p, p.grad) for p in model.parameters() if p.grad is not None]
    return StepGraph(graph, sx, sy, tuple(out), launches,
                     pool + sx.nbytes + sy.nbytes, grads)


def capture_eval_step(step: Step, x: torch.Tensor, y: torch.Tensor,
                      device: torch.device, model: nn.Module) -> StepGraph:
    """Capture ``step`` (an evaluation step of ``model``, in eval mode)
    at this batch's key after two warm-up calls without gradients on a
    side stream, which must change none of the model's buffers."""
    what = f"the evaluation step at batch {tuple(x.shape)}"
    sx, sy = _statics(x, y, device)
    before = {n: b.clone() for n, b in model.named_buffers()}
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.no_grad():
        with torch.cuda.stream(side):
            for _ in range(2):
                step(sx, sy)
        cur.wait_stream(side)
        changed = [n for n, b in model.named_buffers()
                   if not torch.equal(b, before[n])]
        if changed:
            raise GraphCaptureError(
                f"{what}: its warm-up changed {len(changed)} buffers "
                f"({', '.join(changed[:4])}): eval mode must mutate nothing")
        graph, out, launches, pool = capture_call(lambda: step(sx, sy),
                                                  device, what)
    return StepGraph(graph, sx, sy, tuple(out), launches,
                     pool + sx.nbytes + sy.nbytes)
