"""A forward compiled per input shape: one CUDA graph a shape.

qtpu wraps its forwards in ``jax.jit``: ``ServingEngine`` compiles its
forward once for each batch bucket (qtpu/serve/engine.py), and the flat
engines jit their own entries, ``forward``, ``forward_codes`` and
``forward_u8`` (qtpu/serve/resnet_engine.py and the MobileNet engines), so a
call is one compiled program per input shape.  The port's counterpart is a
CUDA graph: the forward's launches at one shape, captured once and replayed
each call, with no Python between the kernels.  ``ServingEngine`` keeps one
a bucket, a flat engine one a (entry, input shape).

A :class:`ForwardGraph` holds a static input of the shape and dtype, the
captured graph, and its static output.  :func:`capture_forward` warms the
forward up twice on a side stream and captures a third call with
``torch.cuda.graph`` (as ``bench.timing.capture`` does), in
``capture_error_mode="thread_local"``: the engine's scheduler and HTTP
threads stay alive meanwhile.  The graph's memory pool is its own, or a
:class:`GraphPool` that several graphs share (a flat engine's graphs: one
pool an engine, so a new input shape adds its static tensors, not a pool
of its own).  A forward that syncs with the host cannot be captured:
:class:`GraphCaptureError` names what was captured and the cause, and
nothing falls back to eager.

The ops' launch counters move on every replay by the counts the capture
recorded (``utils/graphs.py``, shared with the trainer's step graphs).

A graph's ``key`` is a short stable name, ``<name>/<shape>/<dtype>``
(``forward_u8/128x224x224x3/uint8``; a flat engine's ``name`` is the entry,
``ServingEngine``'s ``bucket``).  While a profiler records, a call carries
the spans ``bench.profile`` names: the wait, the upload, the replay under
``qtpu.graph.replay:<key>``, the copy out.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from qtpu_torch.bench.profile import (GRAPH_COPY_OUT, GRAPH_REPLAY,
                                      GRAPH_UPLOAD, GRAPH_WAIT, annotate)
from qtpu_torch.utils.graphs import (GraphCaptureError, add_counts,
                                     capture_call, launch_counters)


class GraphPool:
    """A memory pool that several graphs capture into, and the event that
    orders their calls.  A capture reuses the intermediates the pool's
    earlier captures freed, so the graphs may not run at once: each
    :meth:`ForwardGraph.call` waits for the last call's copy out, on
    whatever stream it came."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.done = torch.cuda.Event()


class ForwardGraph:
    """One shape's captured forward: ``static_in`` → ``graph`` →
    ``static_out``; ``launches``: the counts one replay adds (counter name →
    n, nonzero only); ``nbytes``: the device memory the graph took (what
    its capture added to the pool, and the static input); ``done``: the
    event recorded after a call's copy out (its :class:`GraphPool`'s);
    ``key``: the graph's name in traces (module docstring)."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", static_in: torch.Tensor,
                 static_out: torch.Tensor, launches: Dict[str, int],
                 nbytes: int, counters, done: "torch.cuda.Event", key: str):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.nbytes = nbytes
        self._counters = counters
        self._done = done
        self.key = key
        self._replay_span = GRAPH_REPLAY + key

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
        with annotate(GRAPH_UPLOAD):
            self.static_in.copy_(x, non_blocking=True)
        with annotate(self._replay_span):
            self.graph.replay()
        add_counts(self._counters, self.launches)
        return self.static_out

    def call(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`replay`, then a new tensor: the static output copied on
        the card in stream order, as ``jax.jit`` returns a fresh array."""
        with annotate(GRAPH_WAIT):
            torch.cuda.current_stream(self.static_in.device).wait_event(
                self._done)
        out = self.replay(x)
        with annotate(GRAPH_COPY_OUT):
            out = out.clone()
            self._done.record()
        return out


def graph_key(name: str, x: torch.Tensor) -> str:
    """``name/<d0>x<d1>x.../<dtype>``: a graph's key (module docstring)."""
    dims = "x".join(str(d) for d in x.shape)
    return f"{name}/{dims}/{str(x.dtype).replace('torch.', '')}"


def capture_forward(forward: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, device: torch.device, what: str,
                    pool: Optional[GraphPool] = None,
                    name: str = "forward") -> ForwardGraph:
    """Capture ``forward`` at ``x``'s shape and dtype on ``device`` (``x``:
    on the host or the card; it is copied into the static input), after
    two warm-up calls on a side stream, into ``pool`` or a pool of its own, keyed ``graph_key(name, x)``.  Raises
    :class:`GraphCaptureError` naming ``what``."""
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
        graph, out, launches, grew = capture_call(
            lambda: forward(static_in), device, what,
            pool.handle if pool else None)
    if not isinstance(out, torch.Tensor):
        raise GraphCaptureError(
            f"{what} returned {type(out).__name__}, not a tensor")
    return ForwardGraph(graph, static_in, out, launches,
                        grew + static_in.nbytes, launch_counters(),
                        pool.done if pool else torch.cuda.Event(),
                        graph_key(name, x))
