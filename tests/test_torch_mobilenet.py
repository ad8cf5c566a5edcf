"""qtpu_torch MobileNet-v2 vs qtpu, on the CPU (v1: test_torch_mobilenet_v1.py).

qtpu's MobileNet-v2 at width 0.25 and 32×32 inputs is initialized, its
BatchNorm statistics and affine parameters moved off their init values
(seeded), then calibrated and frozen full-int8.  The same fp32 variables go
into the port's model with ``load_flax_variables``:

* the fp32 forwards agree to rel-L2 ≤ 1e-5 (two fp32 conv implementations
  summing in different orders);
* the port's calibrate + freeze reproduces qtpu's frozen tree as
  tests/test_torch_freeze.py requires (weights exact, ``act_scale`` to
  rtol 1e-5), with the debug checks of every frozen node on — the
  depthwise (3, 3, 1, C) nodes' per-channel scales and nine-tap colsums
  included;
* qtpu's frozen tree, through ``from_numpy_tree``, runs in the port's
  engine on the CPU (the kernels' plain versions) against qtpu's engine run
  op by op (``_forward``, unjitted — ROADMAP C10).  qtpu's per-block codes
  are recorded from that run; each port block is fed qtpu's codes from the
  block before, and its output follows the tie rule (equal, except one
  step on at most 0.1% of elements).  Logits agree to rel-L2 ≤ 1e-4 (the
  mean-pool sums in another order, and a code moved at a tie moves the
  logits a little).  Cases: the quantized stem with torch_pad geometry,
  and the fp32 stem (the frozen tree with its stem moved to fp32) with
  SAME geometry, through ``forward`` and ``forward_u8``.

The chained engine (``ExperimentalMobileNetV2Int8Engine`` with ``use_qivr``)
on the same frozen tree has qtpu's runs — 10 blocks in 5 runs — and, walked
run by run, follows qtpu's codes (its chained kernel in interpret mode) by
the tie rule; its logits equal the port's product engine's.

The dispatch paths equal qtpu's, and ``build_engine`` serves narrowed
``mobilenetv2_imagenet_int8_ptq_fp32stem`` and ``mobilenetv1_imagenet_int8_ptq``
through ``ServingEngine``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qtpu.serve.mobilenet_engine as jmod2
from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.serve.mobilenet_engine import MobileNetV2Int8Engine as JEngine
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import QuantPolicy
from qtpu_torch.ops import qconv, qdepthwise, qivr, qmatmul
from qtpu_torch.serve import cli
from qtpu_torch.serve.experimental import ExperimentalMobileNetV2Int8Engine
from qtpu_torch.serve.frozen import from_numpy_tree, to_numpy_tree
from qtpu_torch.serve.fused_ops import grid_of as t_grid_of
from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine as TEngine
from qtpu_torch.serve.mobilenet_v1_engine import \
    MobileNetV1Int8Engine as TEngineV1
from qtpu_torch.transform import calibrate, freeze
from qtpu_torch.utils import debug

KEY = jax.random.PRNGKey(0)
WIDTH, SIZE = 0.25, 32


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def assert_codes(a, b, frac=1e-3):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _perturb_bn(v, seed=1):
    """BatchNorm running statistics and affine parameters off their init
    values, so the BN fold is exercised (seeded)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key = path[-1].key
        a = np.asarray(a)
        if key == "mean":
            return a + rng.normal(0, 0.2, a.shape).astype(a.dtype)
        if key == "var":
            return a * rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
        if key == "scale":
            return a * rng.uniform(0.7, 1.3, a.shape).astype(a.dtype)
        if key == "bias":
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a

    out = dict(v)
    for col in ("params", "batch_stats"):
        out[col] = jax.tree_util.tree_map_with_path(bump, v[col])
    return out


def qtpu_frozen(model, size=SIZE, width_mult=WIDTH):
    """(x, fp32 variables, full-int8 frozen tree) from qtpu, all numpy."""
    m = j_get_model(model, num_classes=10, width_mult=width_mult)
    x = jax.random.normal(KEY, (2, size, size, 3))
    qm = convert_model(m, JPolicy.int8_ptq())
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    v = _perturb_bn(v)
    fp32 = {"params": _np_tree(v["params"]),
            "batch_stats": _np_tree(v["batch_stats"])}
    v = j_calibrate(qm, v, [x])
    _, sv = j_freeze(qm, v, x)
    return np.asarray(x), fp32, _np_tree(sv)


def stem_to_fp32(sv, fp32):
    """The frozen tree of the same model with its stem excluded: the stem's
    node out of ``qweights``, its fp32 params and statistics in."""
    qw = {k: v for k, v in sv["qweights"].items() if k != "stem"}
    return {"qweights": qw,
            "params": {"stem": fp32["params"]["stem"]},
            "batch_stats": {"stem": fp32["batch_stats"]["stem"]}}


def port_model(model, fp32, width_mult=WIDTH):
    m = get_model(model, num_classes=10, width_mult=width_mult)
    return load_flax_variables(m, fp32["params"], fp32["batch_stats"])


def _nodes(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            yield p, v
        elif hasattr(v, "items"):
            yield from _nodes(v, p)


def check_fp32_forward(model, x, fp32, width_mult=WIDTH):
    ref = j_get_model(model, num_classes=10, width_mult=width_mult).apply(
        fp32, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(model, fp32, width_mult)(torch.tensor(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-5, rel_l2(got, ref)


def check_freeze(model, x, fp32, sv, width_mult=WIDTH):
    m = port_model(model, fp32, width_mult)
    policy = QuantPolicy.int8_ptq()
    prev = debug._enabled
    debug.enable(True)       # check_frozen_node on every node, dw included
    try:
        got = dict(_nodes(to_numpy_tree(freeze(m, policy, calibrate(
            m, policy, [x])))["qweights"]))
    finally:
        debug.enable(prev)
    ref = dict(_nodes(sv["qweights"]))
    assert sorted(got) == sorted(ref)
    for path, r in ref.items():
        g = got[path]
        for leaf in ("kernel_q", "colsum", "act_zp"):
            assert g[leaf].dtype == r[leaf].dtype, (path, leaf)
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        for leaf in ("w_scale", "bias"):
            assert g[leaf].shape == r[leaf].shape
            np.testing.assert_allclose(g[leaf], r[leaf], rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        np.testing.assert_allclose(g["act_scale"], r["act_scale"], rtol=1e-5,
                                   err_msg=path)
    # an excluded stem keeps qtpu's fp32 names and layouts
    excl = QuantPolicy.int8_ptq(exclude=("stem*",))
    tree = to_numpy_tree(freeze(m, excl, calibrate(m, excl, [x])))
    assert "stem" not in tree["qweights"]
    for col in ("params", "batch_stats"):
        for leaf, val in fp32[col]["stem"].items():
            np.testing.assert_allclose(tree[col]["stem"][leaf], val,
                                       rtol=1e-7, err_msg=leaf)


def record_qtpu(monkeypatch, module):
    """Wrap qtpu's fused ops in the engine ``module`` so a ``_forward``
    records (node, input codes, output) of every layer call."""
    calls = []
    for name in ("gemm_1x1", "conv_xla"):
        fn = getattr(module, name)

        def wrapped(x, node, *a, _fn=fn, **kw):
            y = _fn(x, node, *a, **kw)
            calls.append((id(node), np.asarray(x), np.asarray(y)))
            return y
        monkeypatch.setattr(module, name, wrapped)
    return calls


def recorded(calls, node):
    """(input, output) of the one recorded call on ``node``."""
    hits = [(x, y) for nid, x, y in calls if nid == id(node)]
    assert len(hits) == 1
    return hits[0]


def count_plain():
    return (qmatmul.qmatmul_folded_plain.calls,
            qdepthwise.qdepthwise_folded_plain.calls,
            qconv.qconv2d_folded_plain.calls)


@pytest.fixture(scope="module")
def qtpu_v2():
    return qtpu_frozen("mobilenet_v2")


def test_fp32_forward_matches_qtpu(qtpu_v2):
    x, fp32, _ = qtpu_v2
    check_fp32_forward("mobilenet_v2", x, fp32)


def test_freeze_matches_qtpu(qtpu_v2):
    x, fp32, sv = qtpu_v2
    check_freeze("mobilenet_v2", x, fp32, sv)


@pytest.mark.parametrize("case", ["int8_stem_torch_pad", "fp32_stem_same"])
def test_engine_blocks_and_logits_match_qtpu(qtpu_v2, monkeypatch, case):
    x, fp32, sv = qtpu_v2
    torch_pad = case == "int8_stem_torch_pad"
    tree = sv if torch_pad else stem_to_fp32(sv, fp32)
    jeng = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), num_classes=10,
                   torch_pad=torch_pad)
    teng = TEngine(from_numpy_tree(tree, device="cpu"), num_classes=10,
                   torch_pad=torch_pad, device="cpu")
    calls = record_qtpu(monkeypatch, jmod2)
    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    n0 = count_plain()
    got = teng.forward(torch.tensor(x)).numpy()
    n1 = count_plain()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    # every int8 layer ran a kernel's plain version: 16 expand + 17 project
    # + head + fc on K1, 17 depthwise on K3, the quantized stem on K2
    assert (n1[0] - n0[0], n1[1] - n0[1], n1[2] - n0[2]) == \
        (35, 17, int(torch_pad))

    blocks = teng._blocks()
    grid = teng._block_in_grid(blocks[0][0])
    stem_codes, _ = recorded(calls, jeng._node("block0", "dw"))
    assert_codes(teng._stem(torch.tensor(x), grid).numpy(), stem_codes)
    for i, (name, _, stride) in enumerate(blocks):
        first = jeng._node(name, "expand") or jeng._node(name, "dw")
        j_in, _ = recorded(calls, first)
        _, j_out = recorded(calls, jeng._node(name, "project"))
        nxt = (teng._block_in_grid(blocks[i + 1][0]) if i + 1 < len(blocks)
               else t_grid_of(teng._node("head")))
        t_out = teng._block(torch.tensor(j_in), grid, name, stride, nxt)
        assert t_out.dtype == torch.int8
        assert_codes(t_out.numpy(), j_out)
        grid = nxt
    if torch_pad:
        # host int8 ingest: codes on the stem's grid give the same logits
        from qtpu_torch.ops.qops import quantize_act
        g = teng.stem_grid()
        codes = quantize_act(torch.tensor(x), g.scale, g.zp, symmetric=g.sym)
        np.testing.assert_array_equal(teng.forward_codes(codes).numpy(), got)
    else:
        with pytest.raises(ValueError):
            teng.stem_grid()        # an excluded stem has no ingest grid


def test_ivr_engine_runs_and_logits_match_qtpu(qtpu_v2, monkeypatch):
    from qtpu.serve.experimental import ExperimentalMobileNetV2Int8Engine \
        as JExpV2
    x, _, sv = qtpu_v2
    jtree = jax.tree_util.tree_map(jnp.asarray, sv)
    jeng = JExpV2(jtree, num_classes=10, use_qivr=True, qivr_interpret=True)
    teng = ExperimentalMobileNetV2Int8Engine(
        from_numpy_tree(sv, device="cpu"), num_classes=10, device="cpu",
        use_qivr=True)
    runs = {i: p["nrun"] for i, p in teng._qivr_prep.items()}
    assert runs == {i: p["nrun"] for i, p in jeng._qivr_prep.items()}
    assert runs == {2: 1, 4: 2, 7: 3, 11: 2, 14: 2}
    # each step's input and the single blocks' outputs from qtpu's product
    # engine run op by op; the runs' from qtpu's chained kernel
    calls = record_qtpu(monkeypatch, jmod2)
    JEngine(jtree, num_classes=10)._forward(jnp.asarray(x))
    monkeypatch.undo()
    grid = teng._block_in_grid("block0")
    for step in teng._plan():
        i, n, run = step
        name = teng._blocks()[i][0]
        j_in, _ = recorded(calls, jeng._node(name, "expand")
                           or jeng._node(name, "dw"))
        t_out, grid = teng._step(torch.tensor(j_in), grid, step)
        j_out = (jeng._qivr(jnp.asarray(j_in), i) if run else
                 recorded(calls, jeng._node(name, "project"))[1])
        assert_codes(t_out.numpy(), j_out)
    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    n0, r0 = count_plain(), qivr.qivr_folded_plain.calls
    got = teng.forward(torch.tensor(x)).numpy()
    n1, r1 = count_plain(), qivr.qivr_folded_plain.calls
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    # 5 runs on K9; K1/K3 for the 7 blocks outside them, the head, the fc
    # and the quantized stem on K2
    assert r1 - r0 == 5 and qivr.qivr_folded.launches == 0
    assert tuple(b - a for a, b in zip(n0, n1)) == (15, 7, 1)
    prod = TEngine(from_numpy_tree(sv, device="cpu"), num_classes=10,
                   device="cpu")
    np.testing.assert_array_equal(prod.forward(torch.tensor(x)).numpy(), got)


def test_forward_u8_matches_qtpu(qtpu_v2):
    x, fp32, sv = qtpu_v2
    tree = stem_to_fp32(sv, fp32)
    mean, std = (0.5, 0.4, 0.45), (0.25, 0.3, 0.2)
    x8 = np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    teng = TEngine(from_numpy_tree(tree, device="cpu"), num_classes=10,
                   device="cpu", normalize=(mean, std))
    jeng = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), num_classes=10,
                   normalize=(mean, std))
    got = teng.forward_u8(torch.from_numpy(x8)).numpy()
    ref = np.asarray(jeng._forward(jnp.asarray(x8), raw_u8=True))
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)


@pytest.mark.parametrize("model", ["mobilenet_v1", "mobilenet_v2"])
def test_dispatch_matches_qtpu(model):
    from qtpu.serve import dispatch as jd
    from qtpu_torch.serve import dispatch as td

    assert td.quantized_layer_paths(model) == jd.quantized_layer_paths(model)
    for exclude in ((), ("stem*",), ("stem*", "fc"), ("head",),
                    ("block3/*",)):
        assert (td.flat_engine_eligible(model, exclude)
                == jd.flat_engine_eligible(model, exclude))


@pytest.mark.parametrize("bad", [dict(width=32), dict(cifar_stem=True),
                                 dict(in_channels=1)])
def test_get_model_refuses_resnet_fields_on_mobilenet(bad):
    """A config's ResNet fields reach every family; a MobileNet takes them
    only at their neutral values."""
    neutral = dict(width=None, cifar_stem=False, in_channels=3)
    m = get_model("mobilenet_v2", num_classes=10, width_mult=WIDTH, **neutral)
    assert m.fc.out_features == 10
    with pytest.raises(ValueError):
        get_model("mobilenet_v2", num_classes=10, **bad)


@pytest.mark.parametrize("name,engine,per_forward", [
    ("mobilenetv2_imagenet_int8_ptq_fp32stem", TEngine, (35, 17, 0)),
    ("mobilenetv1_imagenet_int8_ptq", TEngineV1, (14, 13, 1)),
])
def test_build_engine_serves_narrow_config(monkeypatch, name, engine,
                                           per_forward):
    """``build_engine`` for a MobileNet config, narrowed (the model built at
    width ``WIDTH``), on the CPU: ``ServingEngine`` answers like the flat
    engine's forward, which ran the plain versions of K1/K3/K2
    ``per_forward`` times."""
    monkeypatch.setattr(cli, "get_model",
                        functools.partial(get_model, width_mult=WIDTH))
    cfg = dataclasses.replace(CONFIGS[name], image_size=SIZE, num_classes=10,
                              calib_batches=1, batch_size=4, n_train=8)
    eng, info = cli.build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                                 device="cpu")
    try:
        assert info["serve_path"] == "flat-engine"
        x = np.random.default_rng(2).standard_normal(
            (5, SIZE, SIZE, 3)).astype(np.float32)
        y = eng.predict(x)
        assert y.shape == (5, 10) and np.isfinite(y).all()
        assert ("stem" in eng.vars["qweights"]) == bool(per_forward[2])
        flat = engine(eng.vars, num_classes=10, device="cpu")
        n0 = count_plain()
        np.testing.assert_array_equal(y, flat.forward(torch.tensor(x)).numpy())
        n1 = count_plain()
        assert tuple(b - a for a, b in zip(n0, n1)) == per_forward
    finally:
        eng.stop()
