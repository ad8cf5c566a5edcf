"""Idle share, breakdown and scope attribution from small synthetic
traces."""
import pytest

from benchmark.harness import trace as tr


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_idle_share_of_a_slice():
    ev = [_x(tr.SLICE, "user_annotation", 0, 100),
          _x("k1", "kernel", 10, 20), _x("k2", "kernel", 25, 15),
          _x("copy", "gpu_memcpy", 60, 10),
          _x("cudaEventSynchronize", "cuda_runtime", 40, 20),
          _x("k3", "kernel", 95, 20)]          # runs past the slice
    r = tr.slice_reading(ev)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert r.idle_share == pytest.approx(0.55)
    assert dict(r.device_ops)["k1"] == pytest.approx(20e-6)
    gaps = dict(r.idle_gaps)
    assert gaps["cudaEventSynchronize"] == pytest.approx(20e-6)
    assert gaps["(host idle)"] == pytest.approx((10 + 25) * 1e-6)


def test_a_trace_without_one_slice_is_refused():
    with pytest.raises(ValueError):
        tr.slice_reading([_x("k", "kernel", 0, 1)])


def test_kernels_are_attributed_to_the_scope_of_their_launch():
    ev = [_x(tr.FORWARD, "user_annotation", 0, 100),
          _x("stem", "user_annotation", 10, 30),
          _x("layer1_0", "user_annotation", 50, 30),
          _x("qtpu.work ops=1 bytes=1 cc=0", "user_annotation", 55, 0),
          _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=2),
          _x("cudaLaunchKernel", "cuda_runtime", 55, 1, correlation=3),
          _x("cudaLaunchKernel", "cuda_runtime", 150, 1, correlation=4),
          _x("norm", "kernel", 200, 7, tid=9, correlation=1),
          _x("conv", "kernel", 210, 11, tid=9, correlation=2),
          _x("gemm", "kernel", 230, 13, tid=9, correlation=3),
          _x("other", "kernel", 250, 17, tid=9, correlation=4)]
    times, n = tr.scope_times(ev)
    assert n == 1
    assert times == pytest.approx({tr.OUTSIDE: 7e-6, "stem": 11e-6,
                                   "layer1_0": 13e-6})
