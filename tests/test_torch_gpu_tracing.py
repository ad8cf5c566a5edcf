"""The tracing tooling on the card (no JAX: ``python -m pytest --noconftest
-m gpu tests/test_torch_gpu_tracing.py``).

Every test here is ``gpu``-marked and skips without a card:

* the per-layer table of a full-depth ResNet-50
  (``resnet50_imagenet_int8_ptq_fp32stem``, seeded weights, its
  calibration) at B = 8: the scopes are qtpu's, every K1 and K2 kernel
  lies in one — 3 K1 and 1 K2 in each projection block, 2 and 1 in the
  others, the fc's K1 in ``head`` — and each launch's work note sits in
  the scope of its kernel;
* ``time_scan_fit`` on the card (each chain one CUDA graph) against the
  graph timer on the same forward;
* the same engine's ``forward_u8`` graph at B = 8 and 128: every replay
  of three traced calls runs the device ops of a traced eager call of its
  body, by name and in order, so the eager call's scopes
  (``bench.tracing.device_op_scopes``: qtpu's, and no op under none, the
  uint8 normalize running in ``stem``) label each of them; each call has
  its four spans, the replay's named by the graph's key, one
  host-to-device copy launched inside the upload's; the calls' logits
  equal the graph's first call.
"""
import collections
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RN50 = "resnet50_imagenet_int8_ptq_fp32stem"
STEPS = 3


@pytest.fixture(scope="module")
def rn50_forward():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_forward

    return build_forward(CONFIGS[RN50], device="cuda")


def _x(batch):
    g = torch.Generator().manual_seed(batch)
    return torch.randn((batch, 224, 224, 3), generator=g).cuda()


@pytest.mark.gpu
def test_resnet50_table_attributes_every_kernel(rn50_forward, tmp_path):
    from chip_smoke import kernel_family
    from qtpu_torch.bench.tracing import (UNATTRIBUTED, capture_trace,
                                          layer_table, parse_trace)

    path = capture_trace(rn50_forward, _x(8), steps=STEPS,
                         logdir=str(tmp_path))
    records = parse_trace(path)
    kernels = [r for r in records if r.category == "kernel"]
    assert kernels and all(r.scope for r in kernels), [
        r.name[:60] for r in kernels if not r.scope]
    blocks = [f"layer{i + 1}_{j}" for i, n in enumerate((3, 4, 6, 3))
              for j in range(n)]
    rows = layer_table(records, STEPS)
    assert {r["scope"] for r in rows} == {"stem", *blocks, "head"}
    assert UNATTRIBUTED not in {r["scope"] for r in rows}
    got = collections.defaultdict(collections.Counter)
    for r in kernels:
        fam = kernel_family(r.name)
        if fam and fam.split()[0] in ("K1", "K2"):
            got[r.scope][fam.split()[0]] += 1
    want = {b: {"K1": 3 * STEPS if b.endswith("_0") else 2 * STEPS,
                "K2": STEPS} for b in blocks}
    want["head"] = {"K1": STEPS}
    assert {s: dict(c) for s, c in got.items()} == want
    notes = collections.Counter(r.scope for r in records
                                if r.category == "work")
    assert notes == {s: sum(c.values()) for s, c in want.items()}
    assert all(r["roofline_pct"] > 0 for r in rows if r["scope"] != "stem")


@pytest.mark.gpu
def test_time_scan_fit_matches_graph_timer(rn50_forward):
    from qtpu_torch.bench.timing import time_scan_fit, timed

    x = _x(32)
    with torch.inference_mode():
        ref = timed(lambda: rn50_forward(x), 5)
        fit = 1e3 * time_scan_fit(
            lambda c: c + 0.0 * rn50_forward(c).sum(), x, n_short=3,
            n_long=13)
    assert abs(fit - ref) <= 0.05 * ref, (fit, ref)


def _traced(fn, logdir):
    """``fn()`` once unrecorded (a call traced alone lost its first kernels
    on the card), then inside a ``WITHIN`` span: the trace's events and
    what the recorded call returned."""
    from torch.profiler import record_function

    from qtpu_torch.bench.profile import trace

    with trace(logdir, "cuda", warmup=1) as t:
        fn()
        torch.cuda.synchronize()
        t.step()
        with record_function(WITHIN):
            out = fn()
        torch.cuda.synchronize()
    with open(t.path) as f:
        return json.load(f)["traceEvents"], out


WITHIN = "test.within"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 128])
def test_forward_u8_replay_runs_the_eager_ops_in_order(rn50_forward, batch,
                                                       tmp_path):
    from qtpu_torch.bench.profile import (GRAPH_COPY_OUT, GRAPH_REPLAY,
                                          GRAPH_UPLOAD, GRAPH_WAIT)
    from qtpu_torch.bench.tracing import device_op_scopes

    eng = rn50_forward.__self__
    g = torch.Generator().manual_seed(batch)
    x = torch.randint(0, 256, (batch, 224, 224, 3), dtype=torch.uint8,
                      generator=g).pin_memory()
    eng.free_graphs()
    want = eng.forward_u8(x)                # captures the graph
    (graph,) = eng.graphs.values()
    assert graph.key == f"forward_u8/{batch}x224x224x3/uint8"

    x_dev = x.cuda()
    events, _ = _traced(lambda: eng.eager_forward_u8(x_dev), str(tmp_path))
    nodes = device_op_scopes(events, WITHIN)
    blocks = {f"layer{i + 1}_{j}" for i, n in enumerate((3, 4, 6, 3))
              for j in range(n)}
    assert {s for _, s in nodes} == {"stem", *blocks, "head"}

    events, got = _traced(
        lambda: [eng.forward_u8(x) for _ in range(3)], str(tmp_path))
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    assert {n: len(spans[n]) for n in (GRAPH_WAIT, GRAPH_UPLOAD,
                                       GRAPH_REPLAY + graph.key,
                                       GRAPH_COPY_OUT)} == {
        GRAPH_WAIT: 3, GRAPH_UPLOAD: 3, GRAPH_REPLAY + graph.key: 3,
        GRAPH_COPY_OUT: 3}
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE and "correlation" in e.get("args", {}):
            ops[e["args"]["correlation"]].append(e)

    def launched_in(name):
        return [e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans[name])]
    replays = [c for c in launched_in(GRAPH_REPLAY + graph.key) if ops[c]]
    assert len(replays) == 3
    for c in replays:
        run = sorted(ops[c], key=lambda d: d["ts"])
        assert [d["name"] for d in run] == [n for n, _ in nodes]
    uploads = [d for c in launched_in(GRAPH_UPLOAD) for d in ops[c]]
    assert len(uploads) == 3 and all(
        d["cat"] == "gpu_memcpy" and "HtoD" in d["name"] for d in uploads)
    assert all(torch.equal(y, want) for y in got)
    eng.free_graphs()
