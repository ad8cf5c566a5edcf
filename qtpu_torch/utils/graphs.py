"""CUDA-graph capture and the ops' launch counters, shared by the served
buckets (``serve/graphs.py``) and the training and evaluation steps
(``train/graphs.py``).

The launch counters.  Every kernel wrapper in ``qtpu_torch.ops`` counts its
launches on itself (``launches``, ``launches_<kernel>``), every plain
version its calls (``calls``), ``qops.resolve_and_pad`` its pad copies.
A replay runs none of that Python.  So :func:`capture_call` records how far
its one call moved each counter and puts the counters back (a captured
launch has not run), and the holder of the graph adds the recorded counts
(:func:`add_counts`) on every replay: the counters keep counting the
launches the card ran.
"""
from __future__ import annotations

import importlib
import types
from typing import Callable, Dict, Tuple, TypeVar

import torch

# the ops modules whose wrappers carry launch or call counters
COUNTER_MODULES = ("qmatmul", "qconv", "qdepthwise", "qproj", "qtail",
                   "qblock", "qstage", "qivr", "qim2col", "qops")


T = TypeVar("T")


class GraphCaptureError(RuntimeError):
    """A call (a bucket's forward, a training or evaluation step) could not
    be captured as a CUDA graph."""


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


def capture_call(fn: Callable[[], T], device: torch.device, what: str,
                 pool=None) -> Tuple["torch.cuda.CUDAGraph", T,
                                     Dict[str, int], int]:
    """Capture one call of ``fn`` as a CUDA graph on ``device``
    (``torch.cuda.graph`` in ``thread_local`` mode, into the memory pool
    ``pool`` — a ``torch.cuda.graph_pool_handle()`` — or one of its own):
    (the graph, ``fn``'s result — static tensors that every replay
    overwrites —, the counts one replay adds (counter name → n, nonzero
    only), the bytes the pool grew by).  The counters are put back: a
    captured launch has not run.  A call that breaks the capture (a host
    sync, say) raises :class:`GraphCaptureError`, ``what`` and the cause in
    its message; nothing falls back to eager."""
    counters = launch_counters()
    torch.cuda.synchronize(device)
    before = read_counters(counters)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            pool0 = torch.cuda.memory_reserved(device)
            out = fn()
            pool = torch.cuda.memory_reserved(device) - pool0
    except Exception as e:
        # a failed capture ends in capture_end's error; the call that
        # broke it (a host sync, say) is its context
        add_counts(counters, {k: before[k] - n for k, n in
                              read_counters(counters).items()})
        cause = "; ".join(f"{type(c).__name__}: {c}"
                          for c in (e.__context__, e) if c is not None)
        raise GraphCaptureError(
            f"{what} cannot be captured as a CUDA graph ({cause})") from e
    after = read_counters(counters)
    # the captured call launched nothing: put the counters back
    add_counts(counters, {k: before[k] - after[k] for k in counters})
    launches = {k: after[k] - before[k] for k in counters
                if after[k] != before[k]}
    return graph, out, launches, pool
