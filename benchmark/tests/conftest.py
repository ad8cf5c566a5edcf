"""Tests of the benchmark: its yardstick (work counter, statistics, trace
reading, traffic, import check) and, on the CPU at a narrow size, the
whole run with the system's plain path, the reference and the faults
the comparison must catch.  Tests marked ``gpu`` run the cells on a card
and skip without one: ``python -m pytest benchmark/tests -q``."""
import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("gpu") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")


def serve_cell():
    """The open-loop cell PERF.md keeps for later (its latency spread did
    not fit a bound): ResNet-50 through ``ServingEngine`` under
    ``traffic/poisson_rn50.json``, as a later entry of BENCHMARK.json
    would name it."""
    from benchmark.harness.spec import BENCH, Cell, Metric, load_json

    return Cell(
        name="rn50.serve", chips=1,
        config=load_json(BENCH / "configs" /
                         "resnet50_imagenet_int8_ptq_fp32stem.json"),
        traffic=load_json(BENCH / "traffic" / "poisson_rn50.json"),
        end_to_end=[Metric(n, "ms", "lower", "host_clock")
                    for n in ("latency_p50_ms", "latency_p95_ms")]
        + [Metric("setup_s", "s", "lower", "host_clock")],
        per_layer=[Metric("idle_pct.serve", "%", "lower", "device_trace"),
                   Metric("fill_pct.serve", "%", "higher",
                          "program_counter")])


@pytest.fixture
def small_cell(monkeypatch):
    """``small_cell(name)``: the cell ``name`` at a size a CPU test holds —
    64×64 images, ResNet-50 at base width 16 (MobileNet-v2 at its own
    widths), batches of 4, 2 calibration batches — with the system's
    experiment config narrowed alike for the test's duration."""
    from benchmark.harness.spec import load_cell
    from qtpu_torch.examples import configs as C

    def make(name, size=64, batch=4, rate=40.0):
        cell = (load_cell(name) if name != "rn50.serve" else serve_cell())
        cfg = dict(cell.config, image_size=size)
        repl = {"image_size": size}
        if cfg["architecture"] == "resnet":
            cfg["width"] = repl["width"] = 16
        ec = C.CONFIGS[cfg["experiment"]]
        monkeypatch.setitem(C.CONFIGS, cfg["experiment"],
                            dataclasses.replace(ec, **repl))
        cfg["calibration"] = {"batches": 2, "batch_size": 4}
        cfg["correctness"] = dict(cfg["correctness"], sample_rows=batch,
                                  reference_rows=batch)
        tf = dict(cell.traffic)
        if tf["client"] == "offline":
            tf.update(batch=batch, pool_batches=2, trace_slice_batches=2)
        else:
            tf.update(rate_per_s=rate, image_pool=8, drain_s=30,
                      trace_slice_s=0.3)
        cell.config, cell.traffic = cfg, tf
        return cell
    return make
