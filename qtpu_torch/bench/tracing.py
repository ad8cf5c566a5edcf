"""Per-layer roofline table from a profiler trace (port of
qtpu/bench/tracing.py).

``capture_trace`` records a function under ``torch.profiler``
(``bench.profile.trace``) and returns the Chrome trace JSON it wrote;
``parse_trace`` reads it back as one :class:`OpRecord` per piece of work,
each attributed to the engine's ``annotate()`` scopes; ``layer_table``
sums them per scope — µs a step, achieved TOP/s and GB/s, and the share of
the scope's own roofline — and ``format_table`` prints that table.

Attribution.  On a card the records are the device kernels (``cat:
"kernel"``).  Each is attributed to the innermost ``user_annotation`` span
that encloses its launch on the host thread: the CUDA API event (``cat``
``cuda_runtime`` and its kin) with the kernel's ``correlation``.  That
holds for the port's kernels, launched from their shared libraries
through ``ctypes`` and so under no aten op, as for PyTorch's own.  The
``gpu_user_annotation`` spans are not used: the profiler derives them
from the same host spans and the same correlation, and a span on the
device timeline cannot say which of two adjacent scopes issued a kernel.
On the CPU the records are the ``cpu_op`` events' self time (their time
less that of the ops nested in them), each attributed to the innermost
scope at its start.  Nested scopes keep their path (``layer1_1/sub``).
The same attribution, over every device op (kernels, copies, fills)
launched inside one span, in launch order and with the innermost scope,
is ``device_op_scopes``: of a traced eager call, it labels by position
the device ops of a replay of the graph that call's body was captured
into (``bench.profile``).

Work.  XLA gave qtpu each op's ``model_flops`` and ``bytes_accessed``; a
CUDA trace carries nothing like it.  So each kernel wrapper of the port
calls ``bench.profile.note_work`` where it counts its launch, with the
work of the launch by PERF.md's bound rule — 2·M·N·K int8 operations
(depthwise taps as operations outside the tensor cores), each input read
and each output written once.  While a profiler records, the note is a
zero-length span in the trace, which ``parse_trace`` reads back and
attributes to its scope like a kernel; otherwise the wrapper pays one
flag test.

CLI: ``python -m qtpu_torch.bench.tracing [batch] [json_out] --model
{resnet50,mobilenet_v2,mobilenet_v1} [--device cpu]`` builds the model's
product engine as ``serve.cli.build_engine`` builds its config (seed-0
weights, the config's calibration on its training set — synthetic unless
``$QTPU_DATA_DIR`` holds it), traces 10 forwards of its eager body
(``build_forward``'s: a replayed CUDA graph would run none of the scopes)
on the card and prints the table; with ``--device cpu`` it measures the
host's plain path, whose times are the CPU's and whose work columns are
empty (the plain versions note nothing).
"""
from __future__ import annotations

import glob
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from qtpu_torch.bench.profile import WORK, trace
from qtpu_torch.bench.timing import (PEAK_BYTES, PEAK_CUDA_CORE_OPS,
                                     PEAK_INT8_OPS)

UNATTRIBUTED = "(unattributed)"


@dataclass
class OpRecord:
    name: str            # kernel or aten op name; WORK for a work note
    scope: str           # annotate() scope path ("layer1_1"), "" if none
    dur_us: float        # device (card) or self (CPU) time, microseconds
    ops: float           # int8 tensor-core operations (work notes only)
    bytes: float         # bytes read and written once (work notes only)
    category: str        # "kernel", "cpu_op" or "work"
    cuda_core_ops: float = 0.0   # operations outside the tensor cores


def _work_of(name: str):
    """(ops, bytes, cuda_core_ops) of a work note's span name."""
    kv = dict(f.split("=") for f in name[len(WORK):].split())
    return float(kv["ops"]), float(kv["bytes"]), float(kv["cc"])


def _scope_of(names: List[str]) -> str:
    """The scope path of the enclosing spans, outermost first:
    ["layer1_1", "sub"] -> "layer1_1/sub"; [] -> ""."""
    return "/".join(names)


def _scopes_at(spans, queries) -> Dict[object, List[str]]:
    """The scopes open at each query time on one host thread.
    ``spans``: (start, end, name) of the thread's scopes, which nest;
    ``queries``: (time, key).  Returns key -> their names, outermost
    first."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [s[2] for s in stack]
    return out


def _self_times(ops) -> List[float]:
    """Each ``(start, end)`` op's time less that of the ops directly nested
    in it (one host thread)."""
    order = sorted(range(len(ops)), key=lambda k: (ops[k][0], -ops[k][1]))
    self_t = [e - s for s, e in ops]
    stack = []
    for k in order:
        s, e = ops[k]
        while stack and not (ops[stack[-1]][0] <= s
                             and e <= ops[stack[-1]][1]):
            stack.pop()
        if stack:
            self_t[stack[-1]] -= e - s
        stack.append(k)
    return self_t


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _DeviceOp(NamedTuple):
    name: str
    dur: float
    corr: Optional[int]      # the correlation of its launch
    cat: str                 # one of DEVICE_CATS
    ts: float


@dataclass
class _Events:
    """A trace's events sorted for attribution: by host thread the scope
    spans and the CPU ops; the work notes; the CUDA API calls by
    correlation (thread, time); the device ops."""
    spans: Dict[tuple, list]
    cpu_ops: Dict[tuple, list]
    notes: list
    launches: Dict[int, tuple]
    device: List[_DeviceOp]


def _split(events: List[dict]) -> _Events:
    out = _Events(defaultdict(list), defaultdict(list), [], {}, [])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        thread, ts = (e.get("pid"), e.get("tid")), float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if name.startswith(WORK):
                out.notes.append((thread, ts, name))
            elif not name.startswith("ProfilerStep#"):
                out.spans[thread].append((ts, ts + dur, name))
        elif cat and cat.startswith("cuda_"):      # a CUDA API call
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                out.launches[corr] = (thread, ts)
        elif cat in DEVICE_CATS:
            out.device.append(_DeviceOp(name, dur, e.get("args", {}).get(
                "correlation"), cat, ts))
        elif cat == "cpu_op":
            out.cpu_ops[thread].append((ts, ts + dur, name))
    return out


def _load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def parse_trace(path: str) -> List[OpRecord]:
    """The records of a Chrome trace ``torch.profiler`` exported: the
    device kernels when the trace has any, else the CPU ops' self times;
    plus the work notes.  Each carries its scope path (module docstring)."""
    ev = _split(_load(path))
    kernels = [d for d in ev.device if d.cat == "kernel"]
    queries = defaultdict(list)
    for k, (thread, ts, _) in enumerate(ev.notes):
        queries[thread].append((ts, ("note", k)))
    if kernels:
        for k, d in enumerate(kernels):
            if d.corr in ev.launches:
                thread, ts = ev.launches[d.corr]
                queries[thread].append((ts, ("kernel", k)))
    else:
        for thread, ops in ev.cpu_ops.items():
            for k, (s, _, _) in enumerate(ops):
                queries[thread].append((s, ("cpu", thread, k)))
    scope = {}
    for thread, qs in queries.items():
        scope.update((k, _scope_of(names)) for k, names in
                     _scopes_at(ev.spans.get(thread, []), qs).items())
    out = []
    if kernels:
        for k, d in enumerate(kernels):
            out.append(OpRecord(d.name, scope.get(("kernel", k), ""), d.dur,
                                0.0, 0.0, "kernel"))
    else:
        for thread, ops in ev.cpu_ops.items():
            self_t = _self_times([(s, e) for s, e, _ in ops])
            for k, (_, _, name) in enumerate(ops):
                out.append(OpRecord(name, scope[("cpu", thread, k)],
                                    self_t[k], 0.0, 0.0, "cpu_op"))
    for k, (_, _, name) in enumerate(ev.notes):
        ops, nbytes, cc = _work_of(name)
        out.append(OpRecord(WORK, scope[("note", k)], 0.0, ops, nbytes,
                            "work", cc))
    return out


def device_op_scopes(events: List[dict], within: str
                     ) -> List[Tuple[str, str]]:
    """(name, innermost scope, ``""`` for none) of each device op — kernel,
    copy or fill — launched inside a ``within`` span, in launch order: the
    same attribution as :func:`parse_trace`'s, through the op's
    correlation, with ``within`` and the spans around it left out."""
    ev = _split(events)
    queries = defaultdict(list)
    for k, d in enumerate(ev.device):
        if d.corr in ev.launches:
            thread, ts = ev.launches[d.corr]
            queries[thread].append((ts, k))
    order = []
    for thread, qs in queries.items():
        open_at = _scopes_at(ev.spans.get(thread, []), qs)
        for ts, k in qs:
            names = open_at[k]
            if within not in names:
                continue
            inner = names[names.index(within) + 1:]
            order.append((ts, ev.device[k].ts, ev.device[k].name,
                          inner[-1] if inner else ""))
    order.sort(key=lambda o: o[:2])
    return [(name, scope) for _, _, name, scope in order]


def latest_trace_file(logdir: str) -> Optional[str]:
    files = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capture_trace(fn: Callable, *args, steps: int = 10,
                  logdir: Optional[str] = None) -> str:
    """Run ``fn(*args)`` ``steps`` times under the profiler on the device
    of the first tensor in ``args``; return the trace file's path.

    A call before the trace warms up (builds, allocator); one more runs
    under the profiler's schedule unrecorded (a forward traced alone lost
    its first kernels on the card); the device is synchronized before the
    trace stops.  Raises if a card's trace holds no device kernel."""
    devs = [a.device for a in args if isinstance(a, torch.Tensor)]
    if not devs:
        raise ValueError("capture_trace: no tensor argument names a device")
    dev = devs[0]
    logdir = logdir or os.path.join(tempfile.gettempdir(), "qtpu_torch_trace")
    fn(*args)
    _sync(dev)
    with trace(logdir, dev, warmup=1) as t:
        fn(*args)
        _sync(dev)
        t.step()
        for _ in range(steps):
            fn(*args)
        _sync(dev)
    if dev.type == "cuda" and not any(
            r.category == "kernel" for r in parse_trace(t.path)):
        raise RuntimeError(f"the trace {t.path} holds no device kernel: "
                           "CUDA activity was not recorded")
    return t.path


def layer_table(records: List[OpRecord], steps: int,
                peak_ops: float = PEAK_INT8_OPS,
                peak_bw: float = PEAK_BYTES,
                peak_cuda_core: float = PEAK_CUDA_CORE_OPS) -> List[Dict]:
    """Aggregate records into a per-scope roofline table.

    ``roofline_pct`` is ideal-time / actual-time, ideal = max(ops /
    peak_ops, cuda_core_ops / peak_cuda_core, bytes / peak_bw) summed over
    the scope's work notes, actual = the scope's summed kernel (or CPU op)
    time — how close the scope runs to its own speed of light on the H100
    SXM's published rates.  PyTorch's elementwise kernels carry no work
    notes: their time counts against their scope's roofline.  ``tops`` and
    ``gbps`` are the notes' operations (both kinds) and bytes over that
    time; ``n_ops`` counts kernels (or CPU ops) a step, not notes."""
    agg: Dict[str, Dict] = {}
    for r in records:
        key = r.scope or UNATTRIBUTED
        row = agg.setdefault(key, dict(scope=key, us=0.0, ops=0.0,
                                       bytes=0.0, ideal_us=0.0, n_ops=0))
        row["us"] += r.dur_us
        row["ops"] += r.ops + r.cuda_core_ops
        row["bytes"] += r.bytes
        row["ideal_us"] += max(r.ops / peak_ops,
                               r.cuda_core_ops / peak_cuda_core,
                               r.bytes / peak_bw) * 1e6
        row["n_ops"] += r.category != "work"
    rows = []
    for row in agg.values():
        us = row["us"] / steps
        rows.append(dict(
            scope=row["scope"],
            us=us,
            n_ops=row["n_ops"] // steps or row["n_ops"],
            tops=row["ops"] / row["us"] / 1e6 if row["us"] else 0.0,
            gbps=row["bytes"] / row["us"] / 1e3 if row["us"] else 0.0,
            roofline_pct=(100.0 * row["ideal_us"] / row["us"]
                          if row["us"] else 0.0),
        ))
    rows.sort(key=lambda r: -r["us"])
    return rows


def format_table(rows: List[Dict], title: str = "") -> str:
    lines = []
    if title:
        lines.append(title)
    lines.append(f"{'scope':<16}{'us/step':>9}{'ops':>5}{'TOPS':>8}"
                 f"{'GB/s':>8}{'%roof':>7}")
    total_us = sum(r["us"] for r in rows)
    total_ideal = sum(r["us"] * r["roofline_pct"] / 100.0 for r in rows)
    for r in rows:
        lines.append(f"{r['scope']:<16}{r['us']:>9.1f}{r['n_ops']:>5d}"
                     f"{r['tops']:>8.1f}{r['gbps']:>8.0f}"
                     f"{r['roofline_pct']:>6.1f}%")
    pct = 100.0 * total_ideal / total_us if total_us else 0.0
    lines.append(f"{'TOTAL':<16}{total_us:>9.1f}{'':>5}{'':>8}{'':>8}"
                 f"{pct:>6.1f}%")
    return "\n".join(lines)


# the config each --model's product engine serves
MODELS = {"resnet50": "resnet50_imagenet_int8_ptq_fp32stem",
          "mobilenet_v2": "mobilenetv2_imagenet_int8_ptq_fp32stem",
          "mobilenet_v1": "mobilenetv1_imagenet_int8_ptq_fp32stem"}
STEPS = 10


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    from qtpu_torch.bench.timing import device_label
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_forward
    from qtpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(
        description="per-layer roofline table from a profiler trace")
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("json_out", nargs="?", default=None,
                    help="optional JSON artifact path")
    ap.add_argument("--model", default="resnet50", choices=tuple(MODELS))
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIGS[MODELS[args.model]]
    fwd = build_forward(cfg, device=dev)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((args.batch, cfg.image_size, cfg.image_size, 3),
                    generator=g).to(dev)
    path = capture_trace(fwd, x, steps=STEPS)
    rows = layer_table(parse_trace(path), STEPS)
    label = device_label(dev)
    print(format_table(rows, title=f"{args.model} int8 engine ({cfg.name}), "
                       f"B={args.batch}, {label} ({path})"))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(model=args.model, config=cfg.name,
                           batch=args.batch, device=label, trace=path,
                           steps=STEPS, rows=rows), f, indent=1)
        print(f"saved {args.json_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
