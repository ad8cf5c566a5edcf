"""qtpu_torch ServingEngine on the CPU (mirrors tests/test_serving_pipeline.py).

A tiny torch forward stands in for the network: results in order under
saturation with the pipeline on and off, submit-time dtype/shape refusal, a
failing forward fails its futures and the engine, ``stop`` mid-stream never
hangs a caller, and ``build_engine`` for the fp32-stem config at a tiny size
answers ``predict`` like its flat engine, with f32 or raw-uint8 ingest.  The
dispatch policy's ResNet branches equal qtpu's (the MobileNet branches:
tests/test_torch_mobilenet.py).

The CUDA graphs' CPU side (the graphs themselves: tests/test_torch_gpu_serve.py):
a forward that returns one reused output buffer, as a graph's replay does,
served over many rounds of one bucket with the pipeline on and off — every
request gets its own rows, since a round's output is copied out before the
next round runs; a CPU engine reports no graphs in ``stats()``; the ops'
counters a replay adds (``utils.graphs``); ``bench.serve_rounds.round_ms`` times a
round of a burst.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.serve.cli import build_engine
from qtpu_torch.serve.dispatch import resnet_arch
from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

W = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (8 * 8 * 1, 5)).astype(np.float32))


def tiny_forward(_v, x):
    return torch.tanh(x.reshape(x.shape[0], -1) @ W)


def _engine(**kw):
    kw.setdefault("forward_fn", tiny_forward)
    return ServingEngine(None, {}, device="cpu", **kw)


@pytest.mark.parametrize("pipeline", [False, True])
def test_results_correct_under_saturation(pipeline):
    eng = _engine(batch_buckets=(4, 8), max_wait_ms=2.0, pipeline=pipeline)
    try:
        n = 64
        xs = np.random.default_rng(1).standard_normal(
            (n, 8, 8, 1)).astype(np.float32)
        ref = tiny_forward(None, torch.from_numpy(xs)).numpy()
        futs = [eng.submit(xs[i]) for i in range(n)]
        out = np.stack([f.result(timeout=60) for f in futs])
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        st = eng.stats()
        assert st["images"] == n and st["batches"] >= n // 8
        assert sum(st["rounds_per_bucket"].values()) == st["batches"]
    finally:
        eng.stop()


def test_submit_validates_dtype_and_shape():
    eng = _engine(batch_buckets=(4,), max_wait_ms=1.0)
    try:
        x = np.zeros((8, 8, 1), np.float32)
        eng.submit(x).result(timeout=60)
        eng.submit(x.astype(np.float64)).result(timeout=60)   # same_kind
        with pytest.raises(ValueError):
            eng.submit(np.zeros((8, 7, 1), np.float32))
        with pytest.raises(ValueError):
            eng.submit(np.zeros((8, 8, 3), np.float32))
        assert eng.healthy
        eng.submit(x).result(timeout=60)
    finally:
        eng.stop()
    u8 = _engine(batch_buckets=(4,), max_wait_ms=1.0, raw_dtype=np.uint8,
                 forward_fn=lambda _v, x: torch.zeros(x.shape[0], 3))
    try:
        u8.submit(np.zeros((8, 8, 1), np.uint8)).result(timeout=60)
        with pytest.raises(ValueError):
            u8.submit(np.zeros((8, 8, 1), np.float32))
        assert u8.healthy
    finally:
        u8.stop()


def test_forward_error_fails_futures_and_engine():
    def flaky(_v, x):
        if x.shape[0] == 8:
            raise RuntimeError("boom")
        return tiny_forward(_v, x)

    eng = _engine(batch_buckets=(4, 8), max_wait_ms=5.0, forward_fn=flaky)
    try:
        xs = np.zeros((8, 8, 8, 1), np.float32)
        for f in [eng.submit(xs[i]) for i in range(4)]:
            f.result(timeout=60)
        futs = [eng.submit(xs[i]) for i in range(8)]
        errs = sum(1 for f in futs if f.exception(timeout=60) is not None)
        assert errs >= 1
        deadline = time.monotonic() + 10
        while eng.healthy and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not eng.healthy
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError):
            eng.submit(xs[0])
    finally:
        eng.stop()


def test_stop_mid_stream_never_hangs_callers():
    eng = _engine(batch_buckets=(4,), max_wait_ms=1.0, pipeline=True)
    xs = np.zeros((4, 8, 8, 1), np.float32)
    futs = [eng.submit(xs[i % 4]) for i in range(16)]
    stopper = threading.Thread(target=eng.stop)
    stopper.start()
    for f in futs:
        try:
            f.result(timeout=60)
        except Exception:
            pass
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    assert all(f.done() for f in futs)


def test_module_path_is_not_ported():
    """With no forward, ServingEngine serves ``model(batch)`` — the module
    SERVE path (the name is kept from when that path raised); passing
    both forwards still raises, and so does passing neither with a model
    that cannot be called."""
    calls = []

    def model(x):
        calls.append(x.shape[0])
        return tiny_forward(None, x)

    eng = ServingEngine(model, {}, batch_buckets=(4,), max_wait_ms=1.0,
                        device="cpu")
    try:
        xs = np.random.default_rng(2).standard_normal(
            (3, 8, 8, 1)).astype(np.float32)
        np.testing.assert_allclose(
            eng.predict(xs), tiny_forward(None, torch.from_numpy(xs)),
            rtol=1e-6, atol=1e-6)
        assert calls and set(calls) == {4}
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="OR"):
        ServingEngine(model, {}, forward_fn=tiny_forward,
                      forward_factory=lambda sv: model, device="cpu")
    with pytest.raises(ValueError, match="callable model"):
        ServingEngine(None, {}, device="cpu")


def test_build_engine_fp32_stem_config_answers_predict():
    cfg = dataclasses.replace(
        CONFIGS["resnet50_imagenet_int8_ptq_fp32stem"], image_size=32,
        num_classes=10, width=16, calib_batches=1, batch_size=4,
        n_train=8)
    eng, info = build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                             device="cpu")
    try:
        assert info["serve_path"] == "flat-engine"
        x = np.random.default_rng(0).standard_normal(
            (5, 32, 32, 3)).astype(np.float32)
        y = eng.predict(x)
        assert y.shape == (5, 10) and np.isfinite(y).all()
        flat = ResNetInt8Engine(
            eng.vars, resnet_arch("resnet50", num_classes=10, image_size=32,
                                  width=16, cifar_stem=False), device="cpu")
        np.testing.assert_array_equal(y, flat.forward(torch.tensor(x)).numpy())
        assert len(eng.stats()["rounds_per_bucket"]) >= 1
    finally:
        eng.stop()


@pytest.mark.parametrize("model", ["resnet18", "resnet20", "resnet34",
                                   "resnet50", "resnet56", "resnet101"])
def test_dispatch_matches_qtpu(model):
    from qtpu.serve import dispatch as jd
    from qtpu_torch.serve import dispatch as td

    assert td.quantized_layer_paths(model) == jd.quantized_layer_paths(model)
    for exclude in ((), ("stem*",), ("stem*", "fc"), ("layer1_0/*",)):
        assert (td.flat_engine_eligible(model, exclude)
                == jd.flat_engine_eligible(model, exclude))
    for size in (32, 224):
        assert (td.resnet_arch(model, num_classes=10, image_size=size)
                == jd.resnet_arch(model, num_classes=10, image_size=size))


def test_dispatch_refusals():
    from qtpu_torch.serve import dispatch as td

    # MobileNet-v2 now serves on the flat engine: no refusal
    assert td.flat_engine_eligible("mobilenet_v2", ()) == (True, frozenset())
    # an exclude beyond stem/fc goes to the module SERVE path
    assert td.make_flat_forward("resnet50", exclude=("layer1_0/*",),
                                device="cpu")[3] == "module"
    # uint8 ingest onto a quantized stem: host-quantized int8 codes
    _, pre, raw_dtype, path = td.make_flat_forward(
        "resnet50", uint8_ingest=True, device="cpu")
    assert (path, raw_dtype) == ("flat-engine+int8-ingest", np.uint8)
    assert pre is not None
    with pytest.raises(SystemExit, match="flat-engine"):
        td.make_flat_forward("resnet50", exclude=("layer1_0/*",),
                             uint8_ingest=True, device="cpu")


def test_uint8_ingest_composes_with_excluded_stem():
    """Raw 0-255 pixels on the wire, normalized on the device before the
    fp32 stem, give the f32-image path's predictions (mirrors
    tests/test_serve_cli.py)."""
    cfg = dataclasses.replace(
        CONFIGS["resnet50_imagenet_int8_ptq_fp32stem"], image_size=32,
        num_classes=10, width=16, calib_batches=1, batch_size=4,
        n_train=8)
    x8 = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3),
                                           dtype=np.uint8)
    eng_u8, info = build_engine(cfg, buckets=(4,), uint8_ingest=True,
                                max_wait_ms=50.0, device="cpu")
    try:
        assert info["serve_path"] == "flat-engine+u8-ingest"
        assert info["raw_dtype"] == "uint8"
        y_u8 = eng_u8.predict(x8)
    finally:
        eng_u8.stop()
    eng_f32, _ = build_engine(cfg, buckets=(4,), max_wait_ms=50.0,
                              device="cpu")
    try:
        y_f32 = eng_f32.predict(x8.astype(np.float32) / 255.0)
    finally:
        eng_f32.stop()
    assert (y_u8.argmax(-1) == y_f32.argmax(-1)).all()
    assert np.linalg.norm(y_u8 - y_f32) / np.linalg.norm(y_f32) < 0.05


@pytest.mark.parametrize("pipeline", [True, False])
def test_rounds_copy_out_a_reused_output_buffer(pipeline):
    """The forward returns the same buffer every round, rewritten in place
    (what a CUDA graph's static output is): with the pipeline, round k is
    read back only after round k+1 has run, so without the copy-out round
    k's requests would get round k+1's logits."""
    buf = torch.empty(8, 5)

    def reused(_v, x):
        buf.copy_(tiny_forward(None, x))
        return buf

    eng = _engine(batch_buckets=(8,), max_wait_ms=2.0, pipeline=pipeline,
                  forward_fn=reused)
    try:
        n = 96
        xs = np.random.default_rng(3).standard_normal(
            (n, 8, 8, 1)).astype(np.float32)
        ref = tiny_forward(None, torch.from_numpy(xs)).numpy()
        futs = [eng.submit(xs[i]) for i in range(n)]
        out = np.stack([f.result(timeout=60) for f in futs])
        buf.fill_(float("nan"))        # results must not alias the buffer
        assert eng.stats()["rounds_per_bucket"][8] >= n // 8
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.stack([f.result() for f in futs]), ref,
                                   rtol=1e-6, atol=1e-6)
    finally:
        eng.stop()


def test_cpu_engine_reports_no_graphs():
    eng = _engine(batch_buckets=(2, 4), max_wait_ms=1.0)
    try:
        eng.warmup((8, 8, 1))
        eng.predict(np.zeros((3, 8, 8, 1), np.float32))
        st = eng.stats()
        assert st["graphed"] == {2: 0, 4: 0}
        assert st["graph_bytes"] == {} and st["graph_launches"] == {}
        assert eng.graphed_buckets == []
    finally:
        eng.stop()


def test_launch_counters_found_and_added():
    """``utils.graphs.launch_counters`` finds every kernel wrapper's launch
    counters, the plain versions' call counters and the pad copies, and
    ``add_counts`` advances them as a replay does."""
    from qtpu_torch.ops import qconv, qmatmul, qops
    from qtpu_torch.utils import graphs

    c = graphs.launch_counters()
    for name in ("qmatmul_folded.launches", "qmatmul_folded.launches_wgmma",
                 "qmatmul_folded.launches_wgmma_cp",
                 "qmatmul_folded_w4.launches_igemm",
                 "qconv2d_folded.launches_small",
                 "qdepthwise_folded.launches_halo",
                 "qproj_folded.launches", "qtail_folded.launches_wgmma",
                 "qblock_folded.launches", "qstage_folded.launches",
                 "qstage_proj_folded.launches_wgmma",
                 "qivr_folded.launches", "qconv2d_im2col.launches",
                 "qmatmul_folded_plain.calls", "resolve_and_pad.calls"):
        assert name in c, name
    assert all(attr == "calls" or attr.startswith("launches")
               for _, attr in c.values())
    before = graphs.read_counters(c)
    try:
        graphs.add_counts(c, {"qmatmul_folded.launches": 3,
                              "qconv2d_folded.launches_small": 2,
                              "resolve_and_pad.calls": 1})
        after = graphs.read_counters(c)
        assert after["qmatmul_folded.launches"] == \
            before["qmatmul_folded.launches"] + 3
        assert qconv.qconv2d_folded.launches_small == \
            before["qconv2d_folded.launches_small"] + 2
        assert qops.resolve_and_pad.calls == \
            before["resolve_and_pad.calls"] + 1
        assert {k for k in c if after[k] != before[k]} == {
            "qmatmul_folded.launches", "qconv2d_folded.launches_small",
            "resolve_and_pad.calls"}
    finally:
        for k, (fn, attr) in c.items():
            setattr(fn, attr, before[k])
    assert qmatmul.qmatmul_folded.launches == before["qmatmul_folded.launches"]


def test_submit_burst_reaches_the_scheduler_at_once():
    from qtpu_torch.bench.serve_rounds import submit_burst

    eng = _engine(batch_buckets=(4, 8), max_wait_ms=5.0)
    submit = eng.submit

    def slow_submit(image):     # a loaded host: 8 submits outlast 5 ms
        time.sleep(0.004)
        return submit(image)

    eng.submit = slow_submit
    try:
        xs = np.random.default_rng(3).standard_normal(
            (8, 8, 8, 1)).astype(np.float32)
        futs = submit_burst(eng, list(xs))
        out = np.stack([f.result(timeout=60) for f in futs])
        ref = tiny_forward(None, torch.from_numpy(xs)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        assert eng.stats()["rounds_per_bucket"] == {8: 1}
        assert "put" not in vars(eng._queue)     # the queue's own put again
    finally:
        eng.stop()


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_round_ms_times_one_round_a_burst(batch):
    from qtpu_torch.bench.serve_rounds import round_ms, summary

    eng = _engine(batch_buckets=(4, 8), max_wait_ms=50.0)
    try:
        xs = np.zeros((8, 8, 8, 1), np.float32)
        ms = round_ms(eng, xs, batch, 3)
        assert len(ms) == 3 and all(m > 0 for m in ms)
        assert summary(ms)["rounds"] == 3
        assert eng.stats()["batches"] == 3
        assert "_dispatch_round" not in vars(eng)   # the wrappers are gone
    finally:
        eng.stop()
