"""Timing on the card (port of qtpu/bench/timing.py), and the card's peak
rates.

``time_scan_fit`` is qtpu's slope fit: the per-iteration time of a chain
of ``body(carry) -> carry`` calls, taken as the slope between two chain
lengths so that what a chain pays once cancels.  On the card each chain is
captured as one CUDA graph and its replay timed with CUDA events — the
counterpart of qtpu's compiled ``lax.scan``: device time, no host code
between the iterations.  On the CPU the chain is an eager loop timed with
``time.perf_counter`` (the host's time: no device metric).

``timed`` (``iters`` calls as one CUDA graph), ``timed_eager`` (calls
issued from Python) and ``events_ms`` are the graph timers ``chip_smoke.py``
and the bench modules share.  A flat engine's entry point called inside
one of these captures runs its eager body (``serve.flat_engine.
entry_plan``: the stream is capturing), but the warm-ups outside it would
capture the entry's own graph: time the eager body (``eager_forward``)
where the capture is the timer's, and ``timed_eager`` of the entry point
times its replays.  ``bound`` is the least time the card could
take for a piece of work at the H100 SXM's published peak rates (NVIDIA's
data sheet, dense, at its 700 W limit; a card set lower is slower, so every
number is kept beside ``device_label``'s name and power limit).
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Tuple

import torch

PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8 tensor-core rate
PEAK_CUDA_CORE_OPS = 67e12  # H100 SXM rate outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bandwidth


def bound(nbytes, ops, peak_ops=PEAK_INT8_OPS, cuda_core_ops=0
          ) -> Tuple[float, str]:
    """The least time (ms) for the work, and what bounds it: bytes at the
    memory rate, operations at their unit's peak — the int8 tensor cores,
    or outside them for ``cuda_core_ops`` (the depthwise taps)."""
    tb = nbytes / PEAK_BYTES
    to = max(ops / peak_ops, cuda_core_ops / PEAK_CUDA_CORE_OPS)
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def device_label(device) -> str:
    """What a measurement on ``device`` is kept beside: for a card its name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives
    them (raises if nvidia-smi fails), for the CPU ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={idx}",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def events_ms(run: Callable[[], object], iters: int) -> float:
    """ms per iteration of ``run`` (which issues ``iters`` of them) between
    two CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def capture(fn: Callable[[], object], warmup: Callable[[], object]
            ) -> "torch.cuda.CUDAGraph":
    """``fn``'s launches captured as one CUDA graph, after two calls of
    ``warmup`` on a side stream (as capture requires), replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            warmup()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def timed(fn: Callable[[], object], iters: int) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph, the
    replay timed with CUDA events.  Launched one by one from Python, a call
    of a few tens of microseconds is bound by the host's launch rate, which
    would be timed instead of the kernel."""
    def calls():
        for _ in range(iters):
            fn()
    return events_ms(capture(calls, fn).replay, iters)


def timed_eager(fn: Callable[[], object], iters: int) -> float:
    """ms per call issued from Python (host overhead included)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return events_ms(run, iters)


def _first_tensor(init) -> torch.Tensor:
    leaves = init if isinstance(init, (tuple, list)) else (init,)
    for t in leaves:
        if isinstance(t, torch.Tensor):
            return t
    raise ValueError("time_scan_fit: init holds no tensor")


def time_scan_fit(body: Callable, init, *args, n_short: int = 50,
                  n_long: int = 200, reps: int = 3) -> float:
    """Per-iteration seconds of ``body(carry, *args) -> carry``.

    ``body`` returns a carry of ``init``'s structure, and each iteration's
    carry feeds the next.  A chain of ``n`` iterations is timed ``reps``
    times at ``n_short`` and ``n_long``, the best of each kept; the result
    is the slope between them.  On a card (``init``'s first tensor there)
    each chain is one CUDA graph, its replay timed with CUDA events; on the
    CPU an eager loop under ``time.perf_counter``.

    qtpu's ``compiler_options`` (XLA backend options of the scan) has no
    counterpart: PyTorch runs the body's launches as they are issued, and
    the graph replays them; no compiler sits in between to take options.
    """
    if n_long <= n_short:
        raise ValueError(f"n_long {n_long} must exceed n_short {n_short}")
    on_card = _first_tensor(init).is_cuda

    def chain(n):
        c = init
        for _ in range(n):
            c = body(c, *args)
        return c

    def total(n: int) -> float:
        if on_card:
            graph = capture(lambda: chain(n), lambda: body(init, *args))
            return min(events_ms(graph.replay, 1)
                       for _ in range(reps)) / 1e3
        chain(n)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(n)
            best = min(best, time.perf_counter() - t0)
        return best

    t_short = total(n_short)
    t_long = total(n_long)
    return max((t_long - t_short) / (n_long - n_short), 1e-9)
