"""Reading the device from ``torch.profiler`` traces.

``record(fn)`` runs ``fn`` under the profiler (host and CUDA activity) and
returns the trace's complete events, read from its exported Chrome JSON
(written under ``$TMPDIR`` and deleted).  The benchmark marks what it
measures with its own host spans: ``bench.slice`` around a slice of the
timed path, ``bench.forward`` around each eager forward whose scopes are
read.  Then:

* ``slice_reading`` — the slice's wall time (its span), the time in which
  some kernel, copy or fill ran on the card (the union of their
  intervals), the device operations that took most time, and the idle
  gaps summed by what the host was doing in their middle (its innermost
  host event then);
* ``scope_times`` — the device time of each kernel launched inside a
  ``bench.forward`` span, summed by the innermost host span around its
  launch (the engines' ``stem``, block and ``head`` scopes; ``(forward)``
  for kernels under no scope of the engine), the launch found through the
  kernel's correlation id.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE, FORWARD = "bench.slice", "bench.forward"
WORK_NOTE = "qtpu.work"      # the system's zero-length notes: no scope
OUTSIDE = "(forward)"
NAME_CHARS = 160


def record(fn: Callable[[], object], device_type: str = "cuda") -> List[dict]:
    """``fn()`` under ``torch.profiler``; its complete ("X") events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if device_type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def mark(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _span(events: List[dict], name: str) -> Tuple[float, float]:
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] == name]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} '{name}' spans in the trace, not 1")
    return spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class SliceReading:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def slice_reading(events: List[dict], top: int = 10) -> SliceReading:
    """The ``bench.slice`` span's device activity (module docstring)."""
    s0, s1 = _span(events, SLICE)
    dev = []
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], s0), min(e["ts"] + e["dur"], s1)
        if b > a:
            dev.append((a, b))
            by_name[e["name"][:NAME_CHARS]] += (b - a) * 1e-6
    busy = union(dev)
    gaps, prev = [], s0
    for a, b in busy + [(s1, s1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["name"] not in (SLICE,)
            and not e["name"].startswith("ProfilerStep")]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        m = 0.5 * (a + b)
        inner = [e for e in host if e["ts"] <= m <= e["ts"] + e["dur"]]
        what = (min(inner, key=lambda e: e["dur"])["name"][:NAME_CHARS]
                if inner else "(host idle)")
        by_host[what] += (b - a) * 1e-6
    return SliceReading(
        window_s=(s1 - s0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(by_host.items(), key=lambda kv: -kv[1])[:top])


def scope_times(events: List[dict]) -> Tuple[Dict[str, float], int]:
    """(device seconds by scope over every ``bench.forward`` span, the
    number of such spans)."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    notes = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            notes[e.get("tid")].append(e)
    forwards = sum(len([e for e in v if e["name"] == FORWARD])
                   for v in notes.values())
    out: Dict[str, float] = defaultdict(float)
    for k in events:
        if k.get("cat") != "kernel":
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t = launch["ts"]
        around = [e for e in notes[launch.get("tid")]
                  if e["ts"] <= t <= e["ts"] + e["dur"]]
        if not any(e["name"] == FORWARD for e in around):
            continue
        inner = [e for e in around if e["name"] != FORWARD
                 and not e["name"].startswith(WORK_NOTE)]
        scope = (min(inner, key=lambda e: e["dur"])["name"] if inner
                 else OUTSIDE)
        out[scope] += k["dur"] * 1e-6
    return dict(out), forwards
