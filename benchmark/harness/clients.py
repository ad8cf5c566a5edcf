"""The clients that drive the system through the window.

``offline`` — a bulk job: batches of pixels from a pool in pinned host
memory, each through the engine's ``forward_u8`` (one CUDA graph a shape),
``ahead`` batches issued before the oldest one's logits are copied back
and waited for.  An image counts when its logits are on the host inside
the window.

``open_loop`` — independent users: the main thread submits every request
whose time has come (``engine.submit``, one image each) and sleeps until
the next is due; each request is timed from when it was due to when its
logits were set on its future.  After the window the client waits up to
``drain_s`` for what is still out; a request that failed or never came
back is infinitely late.

Both can run a profiled slice in the window (``slice_at``: the share of
the window after which it starts; ``slice_len``: batches or seconds), its
measured part inside a ``bench.slice`` span, and keep the outputs the
comparison samples.
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import trace as tr


@dataclass
class Window:
    seconds: float
    attempted: int = 0
    failed: int = 0
    completed: int = 0                  # images back inside the window
    latencies_s: List[float] = field(default_factory=list)
    late_s: List[float] = field(default_factory=list)   # generator lateness
    slice_events: Optional[List[dict]] = None
    slice_images: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    outputs: Dict[int, np.ndarray] = field(default_factory=dict)


def offline(engine, pool: List[torch.Tensor], classes: int, seconds: float,
            ahead: int, keep: List[int], slice_len: int = 0,
            slice_at: float = 0.4) -> Window:
    """Batches ``pool[k % len(pool)]`` through ``engine.forward_u8``; the
    last logits of each pool batch in ``keep`` are kept."""
    on_card = engine.device.type == "cuda"
    B, P, n_out = pool[0].shape[0], len(pool), ahead + 1
    outs = [torch.empty((B, classes), dtype=torch.float32,
                        pin_memory=on_card) for _ in range(n_out)]
    win = Window(seconds=seconds)
    inflight = []                       # (k, out buffer, event)
    issued = 0

    def issue():
        nonlocal issued
        k = issued
        y = engine.forward_u8(pool[k % P])
        buf = outs[k % n_out]
        buf.copy_(y, non_blocking=True)
        ev = torch.cuda.Event() if on_card else None
        if ev is not None:
            ev.record()
        inflight.append((k, buf, ev))
        issued += 1
        if time.perf_counter() < t_end:
            win.attempted += B

    def retire() -> float:
        k, buf, ev = inflight.pop(0)
        if ev is not None:
            ev.synchronize()
        now = time.perf_counter()
        if k % P in keep:
            win.outputs[k % P] = buf.numpy().copy()
        if now <= t_end:
            win.completed += B
        return now

    def run_slice():
        with tr.mark(tr.SLICE):
            for _ in range(slice_len):
                issue()
                retire()

    t0 = time.perf_counter()
    t_end = t0 + seconds
    for _ in range(ahead):
        issue()
    sliced = not slice_len
    while True:
        if not sliced and time.perf_counter() >= t0 + slice_at * seconds:
            win.slice_events = tr.record(run_slice, engine.device.type)
            win.slice_images = slice_len * B
            sliced = True
        issue()
        if retire() > t_end:
            break
    while inflight:
        retire()
    return win


def open_loop(engine, images: np.ndarray, due: np.ndarray,
              which: np.ndarray, keep: List[int], drain_s: float,
              slice_s: float = 0.0, slice_at: float = 0.4,
              device_type: str = "cuda") -> Window:
    """Request i sends ``images[which[i]]`` at ``due[i]`` seconds after the
    window opens; the logits of the requests in ``keep`` are kept."""
    n = len(due)
    seconds = float(due[-1])
    win = Window(seconds=seconds, attempted=n)
    done = np.full(n, math.inf)
    failed = np.zeros(n, dtype=bool)
    futs: Dict[int, object] = {}
    keep = set(int(i) for i in keep)

    def on_done(i, fut):
        if fut.exception() is not None:
            failed[i] = True
        else:
            done[i] = time.perf_counter()

    before = engine.stats()
    t0 = time.perf_counter()
    late = np.zeros(n)
    i = 0
    sliced = slice_s <= 0

    def submit_due(until: float):
        nonlocal i
        while i < n:
            now = time.perf_counter() - t0
            if now >= until:
                return
            while i < n and due[i] <= now:
                try:
                    f = engine.submit(images[which[i]])
                except RuntimeError:
                    failed[i] = True
                else:
                    f.add_done_callback(functools.partial(on_done, i))
                    if i in keep:
                        futs[i] = f
                late[i] = now - due[i]
                i += 1
            if i < n:
                wait = due[i] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, 5e-4))

    while i < n:
        if not sliced and time.perf_counter() - t0 >= slice_at * seconds:
            def run_slice():
                with tr.mark(tr.SLICE):
                    submit_due(time.perf_counter() - t0 + slice_s)
            win.slice_events = tr.record(run_slice, device_type)
            sliced = True
            continue
        submit_due(slice_at * seconds if not sliced else math.inf)
    t_close = time.perf_counter()
    while time.perf_counter() < t_close + drain_s:
        if np.all(np.isfinite(done) | failed):
            break
        time.sleep(1e-3)
    after = engine.stats()
    lat = done - (t0 + due)
    lat[failed] = math.inf
    win.latencies_s = lat.tolist()
    win.late_s = late.tolist()
    win.failed = int(np.sum(~np.isfinite(lat)))
    win.completed = int(np.sum(np.isfinite(lat) & (done <= t0 + seconds)))
    for j, f in futs.items():
        if f.done() and f.exception() is None:
            win.outputs[j] = np.asarray(f.result())
    rounds = {b: after["rounds_per_bucket"].get(b, 0)
              - before["rounds_per_bucket"].get(b, 0)
              for b in after["rounds_per_bucket"]}
    win.counters = {"images": after["images"] - before["images"],
                    "rows": sum(int(b) * r for b, r in rounds.items())}
    return win
