"""qtpu_torch MobileNet-v1 vs qtpu, on the CPU.

The recipe and tolerances of tests/test_torch_mobilenet.py (whose helpers
this file uses), for MobileNet-v1 at width 0.25 and 32×32 inputs: the fp32
forward, freeze parity, and the engine on qtpu's frozen tree against qtpu's
engine run op by op, block by block under the tie rule and logits to rel-L2
≤ 1e-4.  Cases: the quantized stem (K2 3×3/2, Ci = 3) with SAME geometry,
and the fp32 stem with torch_pad geometry.  The last pointwise emits f32
(the mean-pool's input): the port's equals qtpu's to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qtpu.serve.mobilenet_v1_engine as jmod1
from qtpu.serve.mobilenet_v1_engine import MobileNetV1Int8Engine as JEngine
from qtpu_torch.serve.frozen import from_numpy_tree
from qtpu_torch.serve.fused_ops import grid_of as t_grid_of
from qtpu_torch.serve.mobilenet_v1_engine import (V1_STRIDES,
                                                  MobileNetV1Int8Engine as
                                                  TEngine)
from test_torch_mobilenet import (assert_codes, check_fp32_forward,
                                  check_freeze, count_plain, qtpu_frozen,
                                  record_qtpu, recorded, rel_l2, stem_to_fp32)


@pytest.fixture(scope="module")
def qtpu_v1():
    return qtpu_frozen("mobilenet_v1")


def test_fp32_forward_matches_qtpu(qtpu_v1):
    x, fp32, _ = qtpu_v1
    check_fp32_forward("mobilenet_v1", x, fp32)


def test_freeze_matches_qtpu(qtpu_v1):
    x, fp32, sv = qtpu_v1
    check_freeze("mobilenet_v1", x, fp32, sv)


@pytest.mark.parametrize("case", ["int8_stem_same", "fp32_stem_torch_pad"])
def test_engine_blocks_and_logits_match_qtpu(qtpu_v1, monkeypatch, case):
    x, fp32, sv = qtpu_v1
    int8_stem = case == "int8_stem_same"
    torch_pad = not int8_stem
    tree = sv if int8_stem else stem_to_fp32(sv, fp32)
    jeng = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), num_classes=10,
                   torch_pad=torch_pad)
    teng = TEngine(from_numpy_tree(tree, device="cpu"), num_classes=10,
                   torch_pad=torch_pad, device="cpu")
    calls = record_qtpu(monkeypatch, jmod1)
    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    n0 = count_plain()
    got = teng.forward(torch.tensor(x)).numpy()
    n1 = count_plain()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    # 13 pointwise + fc on K1, 13 depthwise on K3, the quantized stem on K2
    assert tuple(b - a for a, b in zip(n0, n1)) == (14, 13, int(int8_stem))

    first = t_grid_of(teng._node("block0", "dw"))
    stem_codes, _ = recorded(calls, jeng._node("block0", "dw"))
    assert_codes(teng._stem(torch.tensor(x), first).numpy(), stem_codes)
    n = len(V1_STRIDES)
    for i in range(n):
        j_in, _ = recorded(calls, jeng._node(f"block{i}", "dw"))
        _, j_out = recorded(calls, jeng._node(f"block{i}", "pw"))
        nxt = t_grid_of(teng._node(f"block{i + 1}", "dw")) if i + 1 < n \
            else None
        t_out = teng._block(torch.tensor(j_in), i, nxt).numpy()
        if nxt is None:
            np.testing.assert_allclose(t_out, j_out, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(j_out).max()))
        else:
            assert_codes(t_out, j_out)
    if int8_stem:
        from qtpu_torch.ops.qops import quantize_act
        g = teng.stem_grid()
        codes = quantize_act(torch.tensor(x), g.scale, g.zp, symmetric=g.sym)
        np.testing.assert_array_equal(teng.forward_codes(codes).numpy(), got)
