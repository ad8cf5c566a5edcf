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

The launch counters.  Every kernel wrapper in ``qtpu_torch.ops`` counts its
launches on itself (``launches``, ``launches_<kernel>``), every plain
version its calls (``calls``), ``qops.resolve_and_pad`` its pad copies.
A replay runs none of that Python.  So the capture records how far its one
call moved each counter, puts the counters back (a captured launch has not
run), and :meth:`BucketGraph.replay` adds the recorded counts on every
replay: the counters keep counting the launches the card ran.
"""
from __future__ import annotations

import importlib
import types
from typing import Callable, Dict, Tuple

import torch

# the ops modules whose wrappers carry launch or call counters
COUNTER_MODULES = ("qmatmul", "qconv", "qdepthwise", "qproj", "qtail",
                   "qblock", "qstage", "qivr", "qim2col", "qops")


class GraphCaptureError(RuntimeError):
    """A bucket's forward could not be captured as a CUDA graph."""


def _is_counter(attr: str, value) -> bool:
    return (isinstance(value, int) and not isinstance(value, bool)
            and (attr in ("launches", "calls")
                 or attr.startswith("launches_")))


def launch_counters() -> Dict[str, Tuple[types.FunctionType, str]]:
    """Every counter of the ops wrappers: ``"<function>.<attribute>"`` →
    (function, attribute)."""
    out = {}
    for name in COUNTER_MODULES:
        mod = importlib.import_module(f"qtpu_torch.ops.{name}")
        for fn in vars(mod).values():
            if (not isinstance(fn, types.FunctionType)
                    or fn.__module__ != mod.__name__):
                continue
            for attr, value in vars(fn).items():
                if _is_counter(attr, value):
                    out[f"{fn.__name__}.{attr}"] = (fn, attr)
    return out


def read_counters(counters) -> Dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def add_counts(counters, counts: Dict[str, int]) -> None:
    for k, n in counts.items():
        fn, attr = counters[k]
        setattr(fn, attr, getattr(fn, attr) + n)


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
    static input).  Raises :class:`GraphCaptureError` naming ``bucket``."""
    counters = launch_counters()
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
        torch.cuda.synchronize(device)
        before = read_counters(counters)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                pool0 = torch.cuda.memory_reserved(device)
                out = forward(static_in)
                pool = torch.cuda.memory_reserved(device) - pool0
        except RuntimeError as e:
            # a failed capture ends in capture_end's error; the call that
            # broke it (a host sync, say) is its context
            add_counts(counters, {k: before[k] - n for k, n in
                                  read_counters(counters).items()})
            cause = "; ".join(f"{type(c).__name__}: {c}"
                              for c in (e.__context__, e) if c is not None)
            raise GraphCaptureError(
                f"bucket {bucket}: the forward cannot be captured as a "
                f"CUDA graph ({cause})") from e
    after = read_counters(counters)
    # the captured call launched nothing: put the counters back
    add_counts(counters, {k: before[k] - after[k] for k in counters})
    if not isinstance(out, torch.Tensor):
        raise GraphCaptureError(
            f"bucket {bucket}: the forward returned {type(out).__name__}, "
            "not a tensor")
    launches = {k: after[k] - before[k] for k in counters
                if after[k] != before[k]}
    return BucketGraph(graph, static_in, out, launches,
                       pool + static_in.nbytes, counters)
