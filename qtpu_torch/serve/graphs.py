"""The served forward compiled per batch bucket: one CUDA graph a bucket.

qtpu's ``ServingEngine`` wraps its forward in ``jax.jit`` and compiles it
once for each batch bucket (qtpu/serve/engine.py), so a served round is one
compiled program.  The port's counterpart is a CUDA graph: the forward's
launches at one bucket's shape, captured once and replayed each round, with
no Python between the kernels.

A :class:`BucketGraph` holds a static input of the bucket's shape and of the
dtype the engine's ``preprocess_fn`` emits, the captured graph, and its
static output.  :func:`capture_bucket` warms the forward up twice on a side
stream and captures a third call with ``torch.cuda.graph`` (as
``bench.timing.capture`` does), in ``capture_error_mode="thread_local"``:
the engine's scheduler and HTTP threads stay alive meanwhile.  The graph's
memory pool is its own (one a bucket).  A forward that syncs with the host
cannot be captured: :class:`GraphCaptureError` names the bucket and the
cause, and nothing falls back to eager.

The ops' launch counters move on every replay by the counts the capture
recorded (``utils/graphs.py``, shared with the trainer's step graphs).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from qtpu_torch.utils.graphs import (GraphCaptureError, add_counts,
                                     capture_call, launch_counters)


class BucketGraph:
    """One bucket's captured forward: ``static_in`` → ``graph`` →
    ``static_out``; ``launches``: the counts one replay adds (counter name →
    n, nonzero only); ``nbytes``: the device memory the graph holds (its
    pool and the static input)."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", static_in: torch.Tensor,
                 static_out: torch.Tensor, launches: Dict[str, int],
                 nbytes: int, counters):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.nbytes = nbytes
        self._counters = counters

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        """Copy ``x`` (on the host or the card) into the static input, replay,
        and return ``static_out`` — which the next replay overwrites: the
        caller copies it out (``ServingEngine._dispatch_round`` does, on
        the card in stream order)."""
        if x.shape != self.static_in.shape or x.dtype != self.static_in.dtype:
            raise ValueError(
                f"batch {tuple(x.shape)} {x.dtype} does not match the "
                f"graph's input {tuple(self.static_in.shape)} "
                f"{self.static_in.dtype}")
        self.static_in.copy_(x, non_blocking=True)
        self.graph.replay()
        add_counts(self._counters, self.launches)
        return self.static_out


def capture_bucket(forward: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, device: torch.device,
                   bucket: int) -> BucketGraph:
    """Capture ``forward`` at ``x``'s shape and dtype on ``device`` (``x``:
    a batch of the bucket, on the host or the card; it is copied into the
    static input), after two warm-up calls on a side stream.  Raises
    :class:`GraphCaptureError` naming ``bucket``."""
    static_in = torch.empty(x.shape, dtype=x.dtype, device=device)
    static_in.copy_(x)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.no_grad():
        with torch.cuda.stream(side):
            for _ in range(2):
                forward(static_in)
        cur.wait_stream(side)
        graph, out, launches, pool = capture_call(
            lambda: forward(static_in), device,
            f"bucket {bucket}: the forward")
    if not isinstance(out, torch.Tensor):
        raise GraphCaptureError(
            f"bucket {bucket}: the forward returned {type(out).__name__}, "
            "not a tensor")
    return BucketGraph(graph, static_in, out, launches,
                       pool + static_in.nbytes, launch_counters())
