"""qtpu_torch.bench.tracing against qtpu.bench.tracing, on the CPU.

* A hand-built Chrome trace in torch.profiler's shape — a host thread with
  nested ``user_annotation`` scopes, ``cuda_runtime`` launches and device
  ``kernel`` events linked by ``correlation``, work notes, and events that must be ignored (the ``ProfilerStep`` span, the
  device's ``gpu_user_annotation`` spans and copies, flow events, host
  ops, another thread's scope) — parses into kernels attributed to the
  launching thread's innermost scope, work notes in theirs, an
  ``(unattributed)`` row, qtpu's sorting and a TOTAL row.  A CPU trace's
  records are its ops' self times.
* The same scopes, durations, operations and bytes through qtpu's
  ``layer_table`` (as its ``OpRecord``s) and the port's (kernels plus work
  notes), under the same peak rates: the rows equal to rtol 1e-12 and
  ``format_table`` prints the same text.
* The port's flat engines — ResNet product, ``tail`` and ``stage``,
  MobileNet-v2 product and ``ivr``, MobileNet-v1 — emit qtpu's scope
  names: the set from a CPU trace of one forward equals the set read from
  ``jax.jit(engine._forward).lower(x).as_text(debug_info=True)`` on the
  same frozen tree (frozen by the port at narrow widths).
* ``python -m qtpu_torch.bench.tracing --device cpu`` (``main``) on a
  narrowed ResNet-50 config: qtpu's 18 scopes, and every CPU op of the
  forward in one of them but the input handling outside ``_forward``.
"""
import dataclasses
import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.bench.tracing import OpRecord as JOpRecord
from qtpu.bench.tracing import format_table as j_format_table
from qtpu.bench.tracing import layer_table as j_layer_table
from qtpu.serve.experimental import \
    ExperimentalMobileNetV2Int8Engine as JExpMNv2
from qtpu.serve.experimental import ExperimentalResNetInt8Engine as JExpRN
from qtpu.serve.mobilenet_engine import MobileNetV2Int8Engine as JMNv2
from qtpu.serve.mobilenet_v1_engine import MobileNetV1Int8Engine as JMNv1
from qtpu.serve.resnet_engine import ResNetInt8Engine as JRN
from qtpu_torch.bench import tracing
from qtpu_torch.bench.profile import WORK, trace
from qtpu_torch.bench.timing import PEAK_BYTES, PEAK_INT8_OPS
from qtpu_torch.bench.tracing import (UNATTRIBUTED, OpRecord, format_table,
                                      latest_trace_file, layer_table,
                                      parse_trace)
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn import QuantPolicy
from qtpu_torch.serve.experimental import (ExperimentalMobileNetV2Int8Engine,
                                           ExperimentalResNetInt8Engine)
from qtpu_torch.serve.flat_engine import FlatInt8Engine
from qtpu_torch.serve.frozen import to_numpy_tree
from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
from qtpu_torch.serve.mobilenet_v1_engine import MobileNetV1Int8Engine
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
from qtpu_torch.transform import calibrate, freeze

HOST, DEV = 4242, 0


def _x(ts, dur, name, cat, tid=HOST, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _note(ts, ops, nbytes, cc=0):
    return _x(ts, 1.0, f"{WORK} ops={ops} bytes={nbytes} cc={cc}",
              "user_annotation")


def _kernel(ts, dur, name, corr):
    return _x(ts, dur, name, "kernel", tid=7, pid=DEV, correlation=corr,
              device=0, stream=7)


def _write(tmp_path, events, name="t.pt.trace.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))
    return str(p)


def _card_trace(tmp_path):
    ev = [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": HOST, "tid": HOST,
         "args": {"name": "python3"}},
        _x(0.0, 1000.0, "ProfilerStep#1", "user_annotation"),
        # stem: one launch; its aten op is ignored on a card's trace
        _x(10.0, 90.0, "stem", "user_annotation"),
        _x(15.0, 45.0, "aten::conv2d", "cpu_op"),
        _x(20.0, 5.0, "cudaLaunchKernel", "cuda_runtime", correlation=1),
        # layer1_0 with a nested scope: a launch and a note in each
        _x(110.0, 290.0, "layer1_0", "user_annotation"),
        _x(150.0, 100.0, "sub", "user_annotation"),
        _x(160.0, 5.0, "cudaLaunchKernel", "cuda_runtime", correlation=2),
        _note(170.0, 4000000000, 1000000),
        _x(300.0, 5.0, "cudaLaunchKernelExC", "cuda_runtime", correlation=3),
        _note(306.0, 0, 2000000),
        # a launch outside every scope
        _x(500.0, 5.0, "cudaLaunchKernel", "cuda_runtime", correlation=4),
        _x(600.0, 100.0, "head", "user_annotation"),
        _x(650.0, 5.0, "cudaLaunchKernel", "cuda_runtime", correlation=5),
        _note(656.0, 0, 500000, 67000000),
        # another host thread's scope covers the launches' times
        _x(0.0, 1000.0, "other", "user_annotation", tid=HOST + 1),
        # the device: kernels, and what is not a kernel
        _kernel(30.0, 100.0, "fp32 conv", 1),
        _kernel(170.0, 50.0, "wgmma_gemm_kernel<64>", 2),
        _kernel(310.0, 20.0, "ConvX", 3),
        _kernel(510.0, 10.0, "elementwise_kernel", 4),
        _kernel(660.0, 5.0, "dw_halo_kernel", 5),
        _x(160.0, 300.0, "layer1_0", "gpu_user_annotation", tid=7, pid=DEV),
        _x(700.0, 40.0, "Memcpy DtoH", "gpu_memcpy", tid=7, pid=DEV),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 2, "pid": HOST,
         "tid": HOST, "ts": 160.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 2, "pid": DEV,
         "tid": 7, "ts": 170.0, "bp": "e"},
    ]
    return _write(tmp_path, ev)


def test_synthetic_card_trace(tmp_path):
    path = _card_trace(tmp_path)
    assert latest_trace_file(str(tmp_path)) == path
    recs = parse_trace(path)
    kernels = {(r.name, r.scope, r.dur_us) for r in recs
               if r.category == "kernel"}
    assert kernels == {("fp32 conv", "stem", 100.0),
                       ("wgmma_gemm_kernel<64>", "layer1_0/sub", 50.0),
                       ("ConvX", "layer1_0", 20.0),
                       ("elementwise_kernel", "", 10.0),
                       ("dw_halo_kernel", "head", 5.0)}
    notes = sorted((r.scope, r.ops, r.bytes, r.cuda_core_ops) for r in recs
                   if r.category == "work")
    assert notes == [("head", 0.0, 500000.0, 67000000.0),
                     ("layer1_0", 0.0, 2000000.0, 0.0),
                     ("layer1_0/sub", 4e9, 1e6, 0.0)]
    assert len(recs) == 8
    rows = layer_table(recs, steps=1)
    assert [r["scope"] for r in rows] == ["stem", "layer1_0/sub", "layer1_0",
                                          UNATTRIBUTED, "head"]
    by = {r["scope"]: r for r in rows}
    assert by["stem"]["n_ops"] == 1 and by["stem"]["roofline_pct"] == 0.0
    sub = by["layer1_0/sub"]
    assert sub["tops"] == pytest.approx(4e9 / 50.0 / 1e6)
    assert sub["gbps"] == pytest.approx(1e6 / 50.0 / 1e3)
    assert sub["roofline_pct"] == pytest.approx(
        100 * 4e9 / PEAK_INT8_OPS * 1e6 / 50.0)
    assert by["layer1_0"]["roofline_pct"] == pytest.approx(
        100 * 2e6 / PEAK_BYTES * 1e6 / 20.0)
    # the depthwise note: its CUDA-core operations bound it at 67 TOP/s
    assert by["head"]["roofline_pct"] == pytest.approx(
        100 * 67e6 / 67e12 * 1e6 / 5.0)
    assert by["head"]["tops"] == pytest.approx(67e6 / 5.0 / 1e6)
    text = format_table(rows, title="demo")
    lines = text.splitlines()
    assert lines[0] == "demo" and lines[1].startswith("scope")
    total = lines[-1].split()
    assert total[0] == "TOTAL" and float(total[1]) == pytest.approx(185.0)
    ideal = sum(r["us"] * r["roofline_pct"] / 100 for r in rows)
    assert total[2] == f"{100 * ideal / 185.0:.1f}%"


def test_synthetic_cpu_trace_self_times(tmp_path):
    ev = [_x(0.0, 100.0, "stem", "user_annotation"),
          _x(10.0, 50.0, "aten::conv2d", "cpu_op"),
          _x(12.0, 46.0, "aten::convolution", "cpu_op"),
          _x(15.0, 40.0, "aten::_convolution", "cpu_op"),
          _x(70.0, 10.0, "aten::relu", "cpu_op"),
          _x(200.0, 10.0, "aten::to", "cpu_op")]
    recs = parse_trace(_write(tmp_path, ev))
    got = {(r.name, r.scope, round(r.dur_us, 6)) for r in recs}
    assert got == {("aten::conv2d", "stem", 4.0),
                   ("aten::convolution", "stem", 6.0),
                   ("aten::_convolution", "stem", 40.0),
                   ("aten::relu", "stem", 10.0), ("aten::to", "", 10.0)}
    assert all(r.category == "cpu_op" for r in recs)


def test_layer_table_matches_qtpu():
    rng = np.random.default_rng(15)
    scopes = ["stem", "layer1_0", "layer1_1", "layer2_0/sub", "head", ""]
    j_recs, t_recs = [], []
    for k in range(60):
        scope = scopes[rng.integers(len(scopes))]
        dur = float(rng.uniform(1.0, 300.0))
        ops = float(rng.integers(0, 5) * rng.integers(1, 10**10))
        nbytes = float(rng.integers(0, 10**8))
        j_recs.append(JOpRecord(name=f"op{k}", scope=scope, dur_us=dur,
                                flops=ops, bytes=nbytes, category="",
                                source=""))
        t_recs.append(OpRecord(f"k{k}", scope, dur, 0.0, 0.0, "kernel"))
        t_recs.append(OpRecord(WORK, scope, 0.0, ops, nbytes, "work"))
    for steps in (1, 3):
        want = j_layer_table(j_recs, steps, peak_ops=PEAK_INT8_OPS,
                             peak_bw=PEAK_BYTES)
        got = layer_table(t_recs, steps)
        assert [r["scope"] for r in got] == [r["scope"] for r in want]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                if key == "scope":
                    continue
                assert g[key] == pytest.approx(w[key], rel=1e-12, abs=0), key
        assert format_table(got, "t") == j_format_table(want, "t")


# -- scope parity with qtpu's lowered forwards ---------------------------

RN_ARCH = dict(stage_sizes=(3, 2, 1, 1), width=16, bottleneck=True,
               cifar_stem=True, num_classes=10)
# qtail needs Cmid a multiple of 64: the tail engine at full width
TAIL_ARCH = dict(RN_ARCH, stage_sizes=(1, 2, 1, 1), width=64)


def _freeze(name, size, **kw):
    model = get_model(name, num_classes=10, **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32))
    policy = QuantPolicy.int8_ptq()
    tree = freeze(model, policy, calibrate(model, policy, [x]))
    return tree, to_numpy_tree(tree), x


@pytest.fixture(scope="module")
def trees():
    rn = dict(cifar_stem=True)
    return {"resnet": _freeze("resnet50", 16, width=16,
                              stage_sizes=RN_ARCH["stage_sizes"], **rn),
            "resnet_tail": _freeze("resnet50", 16, width=64,
                                   stage_sizes=TAIL_ARCH["stage_sizes"],
                                   **rn),
            "mobilenet_v2": _freeze("mobilenet_v2", 32, width_mult=0.25),
            "mobilenet_v1": _freeze("mobilenet_v1", 32, width_mult=0.25)}


STAGE = dict(use_qstage=True, qstage_proj=True, use_qproj=True)
TAIL = dict(use_qtail=True, use_qproj=True)
ENGINES = {
    "resnet_product": ("resnet", lambda t: ResNetInt8Engine(
        t, RN_ARCH, device="cpu"), lambda s: JRN(s, RN_ARCH)),
    "resnet_stage": ("resnet", lambda t: ExperimentalResNetInt8Engine(
        t, RN_ARCH, device="cpu", **STAGE), lambda s: JExpRN(
            s, RN_ARCH, qstage_interpret=True, qtail_interpret=True,
            **STAGE)),
    "resnet_tail": ("resnet_tail", lambda t: ExperimentalResNetInt8Engine(
        t, TAIL_ARCH, device="cpu", **TAIL), lambda s: JExpRN(
            s, TAIL_ARCH, qtail_interpret=True, **TAIL)),
    "mobilenet_v2_product": ("mobilenet_v2", lambda t: MobileNetV2Int8Engine(
        t, num_classes=10, device="cpu"), lambda s: JMNv2(s, 10)),
    "mobilenet_v2_ivr": ("mobilenet_v2",
                         lambda t: ExperimentalMobileNetV2Int8Engine(
                             t, num_classes=10, device="cpu", use_qivr=True),
                         lambda s: JExpMNv2(s, 10, use_qivr=True,
                                            qivr_interpret=True)),
    "mobilenet_v1": ("mobilenet_v1", lambda t: MobileNetV1Int8Engine(
        t, num_classes=10, device="cpu"), lambda s: JMNv1(s, 10)),
}
# a scope each engine must emit beyond its blocks' names
FUSED = {"resnet_stage": {"layer1_stage", "layer2_idrun"},
         "mobilenet_v2_ivr": {"block2_ivrun"}}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_scope_names_match_qtpu(trees, engine, tmp_path):
    which, make_port, make_qtpu = ENGINES[engine]
    tree, sv, x = trees[which]
    port = make_port(tree)
    path = tracing.capture_trace(port.forward, x, steps=1,
                                 logdir=str(tmp_path))
    got = {r.scope.split("/")[0] for r in parse_trace(path) if r.scope}
    text = jax.jit(make_qtpu(sv)._forward).lower(
        jnp.asarray(x.numpy())).as_text(debug_info=True)
    want = set(re.findall(r"jit\(_forward\)/([A-Za-z0-9_]+)/", text))
    assert {"stem", "head"} <= want
    assert got == want
    assert FUSED.get(engine, set()) <= got
    if engine == "resnet_tail":
        assert port._qtail_prep, "the tail engine routed no block"


def test_cli_cpu_capture(monkeypatch, tmp_path):
    # ResNet-50's depth at width 8, calibrated on two images, traced at 64²
    name = tracing.MODELS["resnet50"]
    monkeypatch.setitem(CONFIGS, name, dataclasses.replace(
        CONFIGS[name], width=8, calib_batches=1, batch_size=2, n_train=2,
        image_size=64))
    out = tmp_path / "table.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tracing.main(["1", str(out), "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["batch"] == 1
    blocks = {f"layer{i + 1}_{j}" for i, n in enumerate((3, 4, 6, 3))
              for j in range(n)}
    assert {r["scope"] for r in res["rows"]} - {UNATTRIBUTED} == {
        "stem", "head", *blocks}
    # outside every scope: only what the entry point (``forward``, in
    # inference mode) does to its input before _forward
    x = torch.zeros((1, 64, 64, 3))
    host = types.SimpleNamespace(device=torch.device("cpu"))
    with trace(str(tmp_path / "input"), "cpu") as t, torch.inference_mode():
        FlatInt8Engine._input(host, x, torch.float32)
    input_ops = [r.name for r in parse_trace(t.path)]
    recs = parse_trace(res["trace"])
    outside = [r.name for r in recs if not r.scope]
    assert sorted(outside) == sorted(input_ops * res["steps"])
    assert len(recs) > 50 * len(outside)
