"""The work counter against published totals and by hand."""
import pytest

from benchmark.harness.spec import load_cell
from benchmark.harness.workcount import (ScopeWork, macs,
                                         model_ops_per_image)
from benchmark.work import mobilenet_v2, resnet


def _cfg(cell):
    return load_cell(cell).config


def test_resnet50_multiply_adds_match_the_published_4_1_g():
    # He et al. 2016, Table 1: 3.8e9 FLOPs (multiply-adds) for the convs;
    # the usual count with the fc and the projections is 4.1 G
    total = sum(macs(x) for x in resnet.layers(_cfg("rn50.offline")))
    assert 4.0e9 < total < 4.2e9


def test_mobilenet_v2_multiply_adds_match_the_published_300_m():
    # Sandler et al. 2018, Table 4: 300 M multiply-adds at 224², 1.0
    total = sum(macs(x) for x in mobilenet_v2.layers(_cfg("mnv2.offline")))
    assert 290e6 < total < 315e6


def test_model_ops_are_twice_the_multiply_adds():
    cfg = _cfg("rn50.offline")
    assert model_ops_per_image(cfg) == 2.0 * sum(
        macs(x) for x in resnet.layers(cfg))


def test_layer1_0_scope_counted_by_hand():
    cfg = _cfg("rn50.offline")
    w = ScopeWork(cfg, batch=2).work["layer1_0"]
    n = 56 * 56
    m = n * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    assert w[0] == 2.0 * 2 * m and w[1] == 0.0
    weights = 64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256
    assert w[2] == weights + 2 * (n * 64 + n * 256)


def test_depthwise_work_is_counted_apart_and_the_output_side_is_strided():
    cfg = _cfg("mnv2.offline")
    w = ScopeWork(cfg, batch=1).work["block1"]   # 16 → 96 → /2 → 24
    assert w[1] == 2.0 * 56 * 56 * 96 * 9
    assert w[2] == (16 * 96 + 9 * 96 + 96 * 24) + 112 * 112 * 16 \
        + 56 * 56 * 24


def test_chained_runs_cover_their_blocks():
    cfg = _cfg("rn50.offline")
    sw = ScopeWork(cfg, batch=1)
    seen = ["stem", "layer1_0", "layer1_idrun", "layer2_stage", "head"]
    assert sw.covered("layer1_idrun", seen) == ["layer1_1", "layer1_2"]
    assert sw.covered("layer2_stage", seen) == [f"layer2_{j}"
                                                for j in range(4)]
    mw = ScopeWork(_cfg("mnv2.offline"), batch=1)
    seen = ["stem", "block0", "block1", "block2_ivrun", "block3",
            "block4_ivrun", "block7", "head"]
    assert mw.covered("block2_ivrun", seen) == ["block2"]
    assert mw.covered("block4_ivrun", seen) == ["block4", "block5",
                                                "block6"]
    with pytest.raises(KeyError):
        mw.covered("nothing", seen)
