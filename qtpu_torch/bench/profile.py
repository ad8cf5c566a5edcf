"""Profiler traces and named scopes on ``torch.profiler`` (port of
qtpu/bench/profile.py).

``trace(logdir, device)`` records the block with CPU activity, and CUDA
activity on a card, and writes the Chrome trace JSON into ``logdir``
(view with Perfetto).  A profiler that fails to start, stop or export
raises: unlike qtpu's, nothing degrades to a warning, since a table built
from a missing trace would be silently empty.

``annotate(name)`` is the engines' scope: ``record_function(name)`` while
a profiler records, a null context otherwise.  qtpu's ``jax.named_scope``
costs nothing at run time; a ``record_function`` around each of the ~20
steps of a forward would cost host time on every served request, so
outside a trace the scope is one flag test.

A CUDA graph's replay runs no Python, so no scope records inside it.  What
a trace of a replay carries is the graphed call's four spans, recorded
while a profiler records (``ForwardGraph.call`` and ``replay``):
``GRAPH_WAIT`` (the stream waits for the pool's last copy out),
``GRAPH_UPLOAD`` (the input into the static input), ``GRAPH_REPLAY + key``
(``graph.replay()``) and ``GRAPH_COPY_OUT`` (the static output cloned, the
pool's event recorded); outside a trace each is the same one flag test.
A replay runs the device ops of the eager body it captured, in the same
order and under the same names, so the scopes of a traced eager call
(``bench.tracing.device_op_scopes``) label a replay's ops by position.

``note_work(ops, nbytes, cuda_core_ops)`` is the kernel wrappers'
annotation: the work of one launch, as a zero-length span named
``qtpu.work ops=.. bytes=.. cc=..`` inside the innermost open scope, which
``bench.tracing`` reads back beside the kernels.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
from torch.profiler import (ProfilerAction, ProfilerActivity, profile,
                            record_function)

_NULL = contextlib.nullcontext()
WORK = "qtpu.work"          # the name prefix of a work note's span
# the graphed call's spans; a replay's is GRAPH_REPLAY + the graph's key
GRAPH_WAIT = "qtpu.graph.wait"
GRAPH_UPLOAD = "qtpu.graph.upload"
GRAPH_REPLAY = "qtpu.graph.replay:"
GRAPH_COPY_OUT = "qtpu.graph.copy_out"


def recording() -> bool:
    """Whether a profiler records now (not while it only warms up)."""
    return torch.autograd.profiler._is_profiler_enabled


def annotate(name: str):
    """Named scope for per-layer attribution in traces."""
    return record_function(name) if recording() else _NULL


def note_work(ops: float, nbytes: float, cuda_core_ops: float = 0) -> None:
    """Add one kernel launch's work to the innermost open scope of the
    trace being recorded.  Call it only while ``recording()``: a wrapper
    tests the flag first, so outside a trace a launch pays that one test
    and none of the work's arithmetic."""
    with record_function(f"{WORK} ops={ops:.0f} bytes={nbytes:.0f} "
                         f"cc={cuda_core_ops:.0f}"):
        pass


@dataclass
class Trace:
    """The running trace: ``step()`` ends a warm-up step; once the block
    has ended, ``path`` is the Chrome trace file and ``profiler`` the
    stopped ``torch.profiler.profile`` (``key_averages()``, ``events()``)."""
    profiler: profile
    path: Optional[str] = None

    def step(self) -> None:
        self.profiler.step()


@contextlib.contextmanager
def trace(logdir: str, device, *, warmup: int = 0,
          record_shapes: bool = False) -> Iterator[Trace]:
    """Record the block with torch.profiler on ``device`` (CPU activity,
    plus CUDA activity on a card) into ``logdir/<pid>_<ns>.pt.trace.json``.

    With ``warmup`` the first ``warmup`` steps (each ended by
    ``Trace.step()``) run under the profiler's schedule without being
    recorded: a forward traced alone lost its first kernels on the card.
    The caller synchronizes the device before the block ends."""
    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{os.getpid()}_{time.time_ns()}"
                                ".pt.trace.json")
    held = Trace(profiler=None)

    def ready(p):
        p.export_chrome_trace(path)
        held.path = path

    schedule = None
    if warmup:
        def schedule(step):
            return (ProfilerAction.WARMUP if step < warmup
                    else ProfilerAction.RECORD)
    with profile(activities=activities, schedule=schedule,
                 on_trace_ready=ready, record_shapes=record_shapes) as p:
        held.profiler = p
        yield held
    if held.path is None:
        raise RuntimeError(f"the profiler wrote no trace into {logdir}")
