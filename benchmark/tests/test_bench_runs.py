"""Whole runs on the CPU at a narrow size: the system's plain path against
the reference, the control, and the faults the comparison must catch.

A fault breaks the timed path underneath the harness — the engine's
forward body — and the run must come out not correct: half of the batch
left out (its rows' logits never computed: zeros), or an answer altered
where it is produced (one image's logits moved)."""
import time

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.harness.runner import run_cell
from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

CPU = torch.device("cpu")
SEED = 2**31 + 11


def _run(cell, seed=SEED, seconds=0.6, **kw):
    return run_cell(cell, seed, seconds, False, CPU, time.monotonic(), **kw)


@pytest.mark.parametrize("name", ["rn50.offline", "mnv2.offline",
                                  "rn50.serve"])
def test_sound_runs_are_correct_and_the_control_is_not(small_cell, name):
    done = _run(small_cell(name), control=True)
    res = done["result"]
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logits_rel_l2_max"]["value"] == 0.0
    assert res["checks"]["missing"]["value"] == 0
    limit = res["checks"]["logits_rel_l2_max"]["limit"]
    assert done["extra"]["control"] > 3 * limit
    assert set(res["metrics"]) >= {"setup_s"}


def _half_batch(forward):
    def broken(self, x, **kw):
        y = forward(self, x, **kw)
        y[:(y.shape[0] + 1) // 2] = 0.0      # a served round's real rows
        return y                               # come first
    return broken


def _altered(forward):
    def broken(self, x, **kw):
        y = forward(self, x, **kw).clone()
        y[0, 0] += 10.0 * y[0].abs().max()
        return y
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered])
@pytest.mark.parametrize("name,engine", [
    ("rn50.offline", ResNetInt8Engine), ("mnv2.offline", MobileNetV2Int8Engine),
    ("rn50.serve", ResNetInt8Engine)])
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, name,
                                            engine, fault):
    monkeypatch.setattr(engine, "_forward", fault(engine._forward))
    cell = small_cell(name, rate=8.0)
    res = _run(cell, seconds=1.0)["result"]
    assert not res["correct"]
    c = res["checks"]["logits_rel_l2_max"]
    assert c["value"] > c["limit"]


def test_a_request_that_never_comes_back_is_not_correct(small_cell,
                                                        monkeypatch):
    from qtpu_torch.serve.engine import ServingEngine

    def drop(self, batch, b, out_dev, t_run, event):
        batch[-1][1].set_exception(RuntimeError("dropped"))
        return original(self, batch[:-1], b, out_dev, t_run, event)
    original = ServingEngine._resolve_round
    monkeypatch.setattr(ServingEngine, "_resolve_round", drop)
    res = _run(small_cell("rn50.serve", rate=8.0), seconds=1.0)["result"]
    assert not res["correct"] and res["failed"] > 0


def test_the_reference_follows_the_ports_cpu_path_on_other_seeds(small_cell):
    for seed in (1, 2**33 + 5):
        res = _run(small_cell("rn50.offline"), seed=seed)["result"]
        assert res["checks"]["logits_rel_l2_max"]["value"] == 0.0


def test_rel_l2_max_reads_the_worst_row():
    want = np.ones((3, 4), np.float32)
    got = want.copy()
    got[1] *= 1.5
    assert check.rel_l2_max(got, want) == pytest.approx(0.5)
    ok, c = check.checks(got, want, 0, 0, {"logits_rel_l2_max": 0.6})
    assert ok and c["logits_rel_l2_max"]["limit"] == 0.6
    ok, _ = check.checks(want, want, 1, 0, {"logits_rel_l2_max": 0.6})
    assert not ok


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rn50.offline", "mnv2.offline"])
def test_each_cell_runs_correct_on_the_card(name):
    import json
    import subprocess
    import sys

    root = __file__.rsplit("/benchmark/", 1)[0]
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=1300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
