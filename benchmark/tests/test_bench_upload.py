"""``upload_ms.offline`` from small synthetic slices: the copies launched
inside the system's upload spans, and a system without the spans read
by its host-to-device copies."""
from types import SimpleNamespace

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.runner import reader

UPLOAD = "qtpu.graph.upload"
HTOD, DTOH = "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pinned)"


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _call(t0, corr, upload_us, spans=True):
    """One graphed call at ``t0``: the upload's copy (inside an upload span
    when ``spans``), the graph launch and a kernel, the client's copy
    back."""
    ev = [_x("cudaMemcpyAsync", "cuda_runtime", t0 + 2, 1, correlation=corr),
          _x("cudaGraphLaunch", "cuda_runtime", t0 + 10, 1,
             correlation=corr + 1),
          _x("cudaMemcpyAsync", "cuda_runtime", t0 + 20, 1,
             correlation=corr + 2),
          _x(HTOD, "gpu_memcpy", t0 + 30, upload_us, tid=7,
             correlation=corr),
          _x("K1", "kernel", t0 + 500, 300, tid=7, correlation=corr + 1),
          _x(DTOH, "gpu_memcpy", t0 + 900, 5, tid=7, correlation=corr + 2)]
    if spans:
        ev.append(_x(UPLOAD, "user_annotation", t0, 5))
    return ev


def _read(events, client="offline"):
    run = SimpleNamespace(client=client,
                          window=SimpleNamespace(slice_events=events))
    return reader("upload_ms.offline")(run)


@pytest.mark.parametrize("spans", [True, False])
def test_upload_ms_a_batch(spans):
    ev = [_x(tr.SLICE, "user_annotation", 0, 10000)]
    ev += _call(1000, 10, 400, spans) + _call(3000, 20, 420, spans)
    # a call before the slice: neither its span nor its copy is read
    ev += _call(-2000, 30, 9000, spans)
    assert _read(ev) == pytest.approx(0.41)


def test_only_copies_launched_inside_the_span_count():
    ev = [_x(tr.SLICE, "user_annotation", 0, 10000)] + _call(1000, 10, 400)
    # another thread's launch while the span is open
    ev += [_x("cudaMemsetAsync", "cuda_runtime", 1003, 1, tid=2,
              correlation=50),
           _x("Memset (Device)", "gpu_memset", 1100, 70, tid=7,
              correlation=50)]
    assert _read(ev) == pytest.approx(0.4)


def test_nothing_to_read():
    ev = [_x(tr.SLICE, "user_annotation", 0, 10000)] + _call(1000, 10, 400)
    assert _read(ev, client="open_loop") is None
    assert _read(None) is None
    # no upload span and no host-to-device copy
    no_upload = [e for e in ev if e["name"] not in (UPLOAD, HTOD)]
    assert _read(no_upload) is None
