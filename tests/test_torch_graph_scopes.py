"""Engine scopes in the graphed forward, on the CPU (no JAX).

* Labelling a trace's device ops by scope (``bench.tracing.device_op_scopes``)
  on a hand-built Kineto trace: every device op (kernels, copies, fills)
  launched inside the given span, in launch order, with the innermost
  scope at its launch (``""`` under none); nested scopes, launches outside
  the span and another thread's scopes.
* ``ForwardGraph.call``'s four spans: nothing records and no
  ``record_function`` is made while no profiler records; under one, the
  wait, the upload, ``qtpu.graph.replay:<key>`` and the copy out, in turn.
* Graph keys.
"""
import json

import torch

from qtpu_torch.bench import profile, tracing
from qtpu_torch.bench.profile import (GRAPH_COPY_OUT, GRAPH_REPLAY,
                                      GRAPH_UPLOAD, GRAPH_WAIT, trace)
from qtpu_torch.serve import graphs
from qtpu_torch.serve.graphs import ForwardGraph, graph_key

HOST, DEV = 4242, 0
WITHIN = "eager.forward"        # the span around the labelled call


def _x(ts, dur, name, cat, tid=HOST, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _span(ts, dur, name, tid=HOST):
    return _x(ts, dur, name, "user_annotation", tid=tid)


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _x(ts, 2.0, name, "cuda_runtime", correlation=corr)


def _dev(ts, dur, name, corr, cat="kernel"):
    return _x(ts, dur, name, cat, tid=7, pid=DEV, correlation=corr)


# -- device ops by scope ---------------------------------------------------------

def test_device_op_scopes_in_launch_order():
    within = WITHIN
    ev = [
        _x(0.0, 2000.0, "ProfilerStep#1", "user_annotation"),
        # a launch before the mapped span: not the forward's
        _launch(5.0, 1),
        _span(10.0, 1000.0, within),
        # an op under no scope of the engine
        _launch(20.0, 2, "cudaMemcpyAsync"),
        _span(30.0, 200.0, "stem"),
        _x(35.0, 50.0, "aten::conv2d", "cpu_op"),
        _launch(40.0, 3),
        _span(100.0, 100.0, "sub"),              # nested in stem
        _launch(110.0, 4),
        _x(120.0, 1.0, "qtpu.work ops=1 bytes=2 cc=0", "user_annotation"),
        _launch(210.0, 5),                       # back in stem
        _span(300.0, 200.0, "layer1_0"),
        _launch(310.0, 6, "cudaMemsetAsync"),
        _launch(320.0, 7),
        _launch(600.0, 8),                       # after layer1_0
        # another thread's scope over the same times
        _span(0.0, 2000.0, "other", tid=HOST + 1),
        # the device, listed out of order
        _dev(900.0, 9.0, "k8", 8),
        _dev(50.0, 5.0, "k3", 3),
        _dev(25.0, 4.0, "Memcpy HtoD (Pinned -> Device)", 2, "gpu_memcpy"),
        _dev(6.0, 1.0, "k1", 1),
        _dev(130.0, 6.0, "k4", 4),
        _dev(330.0, 3.0, "Memset (Device)", 6, "gpu_memset"),
        _dev(220.0, 7.0, "k5", 5),
        _dev(340.0, 8.0, "k7", 7),
        _x(40.0, 300.0, "stem", "gpu_user_annotation", tid=7, pid=DEV),
    ]
    assert tracing.device_op_scopes(ev, within) == [
        ("Memcpy HtoD (Pinned -> Device)", ""),
        ("k3", "stem"), ("k4", "sub"), ("k5", "stem"),
        ("Memset (Device)", "layer1_0"), ("k7", "layer1_0"), ("k8", "")]


def test_device_op_scopes_over_several_calls():
    # three traced calls of one body, each inside its own span: their ops
    # one call after another, so each call's run is the body's order
    ev = []
    for c in range(3):
        t0 = 1000.0 * c
        corr = 10 * c
        ev += [_span(t0, 500.0, WITHIN), _span(t0 + 10.0, 100.0, "stem"),
               _launch(t0 + 20.0, corr + 1), _launch(t0 + 200.0, corr + 2),
               _dev(t0 + 600.0, 5.0, "conv", corr + 1),
               _dev(t0 + 610.0, 5.0, "K1", corr + 2)]
    assert tracing.device_op_scopes(ev[::-1], WITHIN) == [
        ("conv", "stem"), ("K1", "")] * 3


def test_device_op_scopes_without_the_span_is_empty():
    ev = [_span(0.0, 100.0, "stem"), _launch(10.0, 1), _dev(20.0, 5.0, "k", 1)]
    assert tracing.device_op_scopes(ev, WITHIN) == []


# -- the graphed call's spans ---------------------------------------------------

class _Graph:
    def __init__(self, static_in, static_out):
        self.static_in, self.static_out = static_in, static_out

    def replay(self):
        self.static_out.copy_(self.static_in * 2)


class _Stream:
    def wait_event(self, event):
        event.waited = True


class _Event:
    def record(self):
        self.recorded = True


def _graph(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    x = torch.zeros(2, 3)
    out = torch.zeros(2, 3)
    key = graph_key("forward_u8", x)
    return ForwardGraph(_Graph(x, out), x, out, {}, 0, {}, _Event(), key)


def test_call_spans_cost_nothing_while_nothing_records(monkeypatch):
    g = _graph(monkeypatch)

    def refuse(name):
        raise AssertionError(f"a span {name} was made")
    monkeypatch.setattr(profile, "record_function", refuse)
    y = g.call(torch.ones(2, 3))
    assert torch.equal(y, torch.full((2, 3), 2.0)) and y is not g.static_out
    assert g._done.recorded
    assert g.key == "forward_u8/2x3/float32"


def test_call_spans_under_the_profiler(monkeypatch, tmp_path):
    g = _graph(monkeypatch)
    with trace(str(tmp_path), "cpu") as t:
        g.call(torch.ones(2, 3))
    with open(t.path) as f:
        spans = sorted((e["ts"], e["name"])
                       for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "user_annotation")
    assert [n for _, n in spans] == [
        GRAPH_WAIT, GRAPH_UPLOAD, GRAPH_REPLAY + "forward_u8/2x3/float32",
        GRAPH_COPY_OUT]


def test_graph_keys():
    x = torch.zeros((128, 224, 224, 3), dtype=torch.uint8)
    assert graph_key("forward_u8", x) == "forward_u8/128x224x224x3/uint8"
    assert graphs.graph_key("bucket", torch.zeros(8, 4, dtype=torch.int8)) \
        == "bucket/8x4/int8"
