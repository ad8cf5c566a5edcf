"""qtpu_torch's module SERVE path and LeNet-5 against qtpu's, on the CPU
(mirrors tests/test_freeze_serve.py and tests/test_e2e_lenet.py).

* LeNet-5's fp32 forward with qtpu's seeded weights carried across by
  ``load_flax_variables`` equals qtpu's to rel-L2 ≤ 1e-5 (two fp32 conv
  implementations) — the flatten goes back to qtpu's (h, w, c) order, and
  the flatten in the port's NCHW order does not agree.
* The port's freeze of LeNet-5 (per-tensor weights, min-max) reproduces
  qtpu's tree: ``kernel_q``, ``colsum`` and ``act_zp`` exact, ``w_scale``
  per tensor (shape ()) and ``bias`` to rtol 1e-6, ``act_scale`` to rtol
  1e-5 (the ranges come from two fp32 conv implementations).
* ``serve_model`` over qtpu's frozen tree (through ``from_numpy_tree``)
  against qtpu's ``serve_model.apply`` run op by op (unjitted — ROADMAP
  C10), for LeNet-5 (affine, and symmetric grids as
  tests/test_freeze_serve.py:238), a narrowed ResNet-18 (CIFAR stem, stage
  sizes (1, 1, 1, 1), width 8) full int8 — its 1×1/2 downsamples as 1×1
  windows on K2 — and with ``exclude=("*/down",)``, and MobileNet-v2 at
  width 0.25 with ``block1`` excluded.  Each quantized layer's input is
  recorded in both (qtpu's through ``flax.linen.intercept_methods``) and
  quantized onto the layer's grid: the codes follow the tie rule (equal,
  except one step on at most 0.1% of elements).  Logits agree to rel-L2 ≤
  1e-4.  The plain versions of K1/K2/K3 run once per quantized layer, by
  the layer's kind.
* Dispatch sends the same configs to the module path as qtpu's, and
  refuses ``uint8_ingest`` there with qtpu's message; ``build_engine``
  serves ``lenet_mnist_int8`` (module path) and a narrowed
  ``resnet18_cifar10_int8_kl`` (flat engine, symmetric grids) on the CPU.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import LayerQuantSpec as JSpec
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.nn.layers import ConvBN as JConvBN
from qtpu.nn.layers import QuantConv as JQuantConv
from qtpu.nn.layers import QuantDense as JQuantDense
from qtpu.ops import qops as jqops
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import LayerQuantSpec, QuantPolicy
from qtpu_torch.nn.serve_layers import ServeLayer, serve_model
from qtpu_torch.ops import qconv, qdepthwise, qmatmul, qops
from qtpu_torch.serve import dispatch as td
from qtpu_torch.serve.cli import build_engine, serve_module
from qtpu_torch.serve.dispatch import resnet_arch
from qtpu_torch.serve.frozen import from_numpy_tree, to_numpy_tree
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
from qtpu_torch.transform import calibrate, freeze

KEY = jax.random.PRNGKey(0)


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
    """BatchNorm statistics and affine parameters off their init values,
    so the excluded layers' BN and the fold are exercised (seeded)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key, a = path[-1].key, np.asarray(a)
        if key == "mean":
            return a + rng.normal(0, 0.2, a.shape).astype(a.dtype)
        if key == "var":
            return a * rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
        if key == "scale":
            return a * rng.uniform(0.7, 1.3, a.shape).astype(a.dtype)
        return a

    out = dict(v)
    if "batch_stats" in v:
        for col in ("params", "batch_stats"):
            out[col] = jax.tree_util.tree_map_with_path(bump, v[col])
    return out


# name → (qtpu/port model kwargs, stage sizes, input shape, port policy,
# qtpu policy, expected plain calls (K1, K2, K3) a forward or None)
CASES = {
    "lenet5": (dict(num_classes=10), None, (4, 28, 28, 1),
               QuantPolicy(default=LayerQuantSpec(per_channel=False)),
               JPolicy(default=JSpec(per_channel=False)), (3, 2, 0)),
    "lenet5_symmetric": (
        dict(num_classes=10), None, (4, 28, 28, 1),
        QuantPolicy(default=LayerQuantSpec(act_symmetric=True)),
        JPolicy(default=JSpec(act_symmetric=True)), (3, 2, 0)),
    "resnet18_down_fp32": (
        dict(num_classes=10, cifar_stem=True, width=8), (1, 1, 1, 1),
        (4, 16, 16, 3), QuantPolicy.int8_ptq(exclude=("*/down",)),
        JPolicy.int8_ptq(exclude=("*/down",)), (1, 9, 0)),
    "resnet18_int8": (
        dict(num_classes=10, cifar_stem=True, width=8), (1, 1, 1, 1),
        (4, 16, 16, 3), QuantPolicy.int8_ptq(), JPolicy.int8_ptq(),
        (1, 12, 0)),
    "mobilenet_v2_block1_fp32": (
        dict(num_classes=10, width_mult=0.25), None, (2, 32, 32, 3),
        QuantPolicy.int8_ptq(exclude=("block1/*",)),
        JPolicy.int8_ptq(exclude=("block1/*",)), None),
}


def _model_name(case):
    return case.split("_")[0] if case.startswith("lenet") else (
        "resnet18" if case.startswith("resnet18") else "mobilenet_v2")


def qtpu_frozen(case):
    """(x, fp32 variables, qtpu's SERVE model, frozen tree) of a case, the
    model seeded and calibrated on two seeded batches."""
    kw, stages, shape, _, jpol, _ = CASES[case]
    m = j_get_model(_model_name(case), **kw)
    if stages:
        m = m.clone(stage_sizes=stages)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    qm = convert_model(m, jpol)
    v = dict(jax.jit(qm.init, static_argnames="train")(
        KEY, jnp.asarray(x), train=False))
    v = _perturb_bn(v)
    fp32 = {"params": _np_tree(v["params"]),
            "batch_stats": _np_tree(v.get("batch_stats", {}))}
    v = j_calibrate(qm, v, [jnp.asarray(x),
                            jnp.asarray(rng.standard_normal(shape)
                                        .astype(np.float32))])
    sm, sv = j_freeze(qm, v, jnp.asarray(x))
    return x, fp32, sm, _np_tree(sv)


def port_kwargs(case):
    kw, stages, *_ = CASES[case]
    return dict(kw, **({"stage_sizes": stages} if stages else {}))


# -- LeNet-5: fp32 forward (flatten order) and freeze ---------------------------

@pytest.fixture(scope="module")
def lenet():
    return qtpu_frozen("lenet5")


def test_lenet_fp32_forward_matches_qtpu(lenet):
    x, fp32, _, _ = lenet
    ref = np.asarray(j_get_model("lenet5", num_classes=10).apply(
        {"params": fp32["params"]}, jnp.asarray(x)))
    m = load_flax_variables(get_model("lenet5", num_classes=10),
                            fp32["params"], {})
    with torch.no_grad():
        got = m(torch.tensor(x)).numpy()
        assert rel_l2(got, ref) <= 1e-5, rel_l2(got, ref)
        # fc1 reads (h, w, c): the NCHW flatten computes something else
        h = torch.relu(m.conv1(torch.tensor(x).permute(0, 3, 1, 2)))
        h = torch.nn.functional.max_pool2d(h, 2, 2)
        h = torch.nn.functional.max_pool2d(torch.relu(m.conv2(h)), 2, 2)
        h = torch.relu(m.fc2(torch.relu(m.fc1(h.reshape(h.shape[0], -1)))))
        assert rel_l2(m.fc3(h).numpy(), ref) > 1e-2


def _nodes(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            yield p, v
        elif hasattr(v, "items"):
            yield from _nodes(v, p)


def test_lenet_freeze_matches_qtpu(lenet):
    """The port's calibrate + freeze of the same LeNet-5 on the same two
    batches (per-tensor weights, min-max) against qtpu's tree."""
    x, fp32, _, sv = lenet
    m = load_flax_variables(get_model("lenet5", num_classes=10),
                            fp32["params"], {})
    policy = CASES["lenet5"][3]
    rng = np.random.default_rng(3)
    rng.standard_normal(x.shape)          # the first batch is ``x``
    x2 = rng.standard_normal(x.shape).astype(np.float32)
    tree = freeze(m, policy, calibrate(m, policy, [x, x2]))
    got = dict(_nodes(to_numpy_tree(tree)["qweights"]))
    ref = dict(_nodes(sv["qweights"]))
    assert sorted(got) == sorted(ref) == ["conv1", "conv2", "fc1", "fc2",
                                          "fc3"]
    for path, r in ref.items():
        g = got[path]
        for leaf in ("kernel_q", "colsum", "act_zp"):
            assert g[leaf].dtype == r[leaf].dtype, (path, leaf)
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        assert g["w_scale"].shape == r["w_scale"].shape == ()
        for leaf in ("w_scale", "bias"):
            np.testing.assert_allclose(g[leaf], r[leaf], rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        np.testing.assert_allclose(g["act_scale"], r["act_scale"],
                                   rtol=1e-5, err_msg=path)
    # excluded: the fp32 params in qtpu's names and layouts
    pol = QuantPolicy(default=LayerQuantSpec(per_channel=False),
                      exclude=("conv1", "fc3"))
    tree = to_numpy_tree(freeze(m, pol, calibrate(m, pol, [x])))
    assert sorted(tree["params"]) == ["conv1", "fc3"]
    np.testing.assert_array_equal(tree["params"]["conv1"]["kernel"],
                                  fp32["params"]["conv1"]["kernel"])
    np.testing.assert_array_equal(tree["params"]["fc3"]["bias"],
                                  fp32["params"]["fc3"]["bias"])


# -- the module SERVE path against qtpu's serve_model.apply ---------------------

def _qtpu_inputs(sm, sv, x):
    """qtpu's logits and each quantized layer's input, run op by op."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if (context.method_name == "__call__"
                and isinstance(mod, (JQuantConv, JQuantDense, JConvBN))):
            seen["/".join(mod.path)] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        y = sm.apply(sv, jnp.asarray(x))
    return np.asarray(y), seen


def _port_inputs(model, x):
    seen, hooks = {}, []
    for path in model.kinds:
        layer = model.net.get_submodule(path.replace("/", "."))

        def hook(_m, args, path=path):
            a = args[0]
            seen[path] = (a if a.dim() == 2 else a.permute(0, 2, 3, 1)
                          ).numpy().copy()
        hooks.append(layer.register_forward_pre_hook(hook))
    try:
        y = model(torch.tensor(x)).numpy()
    finally:
        for h in hooks:
            h.remove()
    return y, seen


def _plain_calls():
    return (qmatmul.qmatmul_folded_plain.calls,
            qconv.qconv2d_folded_plain.calls,
            qdepthwise.qdepthwise_folded_plain.calls)


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_serve_matches_qtpu(case):
    x, _, sm, sv = qtpu_frozen(case)
    policy, expect = CASES[case][3], CASES[case][5]
    tree = from_numpy_tree(sv, device="cpu")
    model = serve_model(_model_name(case), policy, tree, device="cpu",
                        **port_kwargs(case))
    assert all(isinstance(model.net.get_submodule(p.replace("/", ".")),
                          ServeLayer) for p in model.kinds)
    assert sorted(model.kinds) == sorted(p for p, _ in _nodes(sv["qweights"]))
    y_ref, j_in = _qtpu_inputs(sm, sv, x)
    n0 = _plain_calls()
    y, t_in = _port_inputs(model, x)
    calls = tuple(b - a for a, b in zip(n0, _plain_calls()))
    kinds = list(model.kinds.values())
    assert calls == (kinds.count("dense") + kinds.count("gemm"),
                     kinds.count("conv"), kinds.count("depthwise"))
    if expect is not None:
        assert calls == expect
    for path in model.kinds:
        node = tree["qweights"]
        for k in path.split("/"):
            node = node[k]
        sym = bool(node["act_sym"])
        t_codes = qops.quantize_act(torch.tensor(t_in[path]),
                                    node["act_scale"], node["act_zp"],
                                    symmetric=sym)
        j_codes = jqops.quantize_act(jnp.asarray(j_in[path]),
                                     jnp.asarray(node["act_scale"].numpy()),
                                     jnp.asarray(node["act_zp"].numpy()),
                                     symmetric=sym)
        assert_codes(t_codes.numpy(), j_codes)
    assert y.shape == y_ref.shape and np.isfinite(y).all()
    assert rel_l2(y, y_ref) <= 1e-4, rel_l2(y, y_ref)
    if case == "lenet5_symmetric":
        assert all(int(n["act_zp"]) == 0 for _, n in _nodes(sv["qweights"]))


def test_serve_model_is_strict():
    """A quantized layer without its node, or fp32 variables no excluded
    layer takes, raise."""
    _, _, _, sv = qtpu_frozen("lenet5")
    tree = from_numpy_tree(sv, device="cpu")
    policy = CASES["lenet5"][3]
    missing = {**tree, "qweights": {k: v for k, v in tree["qweights"].items()
                                    if k != "fc2"}}
    with pytest.raises(KeyError, match="fc2"):
        serve_model("lenet5", policy, missing, device="cpu", num_classes=10)
    extra = {**tree, "params": {"fc9": {"bias": torch.zeros(3)}}}
    with pytest.raises(ValueError, match="fc9"):
        serve_model("lenet5", policy, extra, device="cpu", num_classes=10)


# -- dispatch and build_engine -----------------------------------------------------

@pytest.mark.parametrize("model,exclude", [
    ("lenet5", ()), ("resnet18", ("*/down",)), ("resnet50", ("layer1_0/*",)),
    ("mobilenet_v2", ("block1/*",)), ("resnet50", ("stem*", "*/down")),
    ("resnet18", ("stem*",))])
def test_dispatch_routes_like_qtpu(model, exclude):
    from qtpu.serve import dispatch as jd

    j = jd.make_flat_forward(model, exclude=exclude)
    t = td.make_flat_forward(model, exclude=exclude, device="cpu")
    assert t[3] == j[3]
    if j[3] == "module":
        assert t == j
        with pytest.raises(SystemExit) as je:
            jd.make_flat_forward(model, exclude=exclude, uint8_ingest=True)
        with pytest.raises(SystemExit) as te:
            td.make_flat_forward(model, exclude=exclude, uint8_ingest=True,
                                 device="cpu")
        assert str(te.value) == str(je.value)
    assert td.quantized_layer_paths("lenet5") == \
        jd.quantized_layer_paths("lenet5") == ()


def test_build_engine_serves_lenet_on_the_module_path():
    cfg = dataclasses.replace(CONFIGS["lenet_mnist_int8"], calib_batches=2,
                              batch_size=4, n_train=16)
    eng, info = build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                             device="cpu")
    try:
        assert info["serve_path"] == "module"
        assert info["image_shape"] == (28, 28, 1)
        assert isinstance(eng.model.net.conv1, ServeLayer)
        x = np.random.default_rng(4).standard_normal(
            (5, 28, 28, 1)).astype(np.float32)
        y = eng.predict(x)
        assert y.shape == (5, 10) and np.isfinite(y).all()
        direct = serve_module(cfg, eng.vars, device="cpu")(torch.tensor(x))
        np.testing.assert_array_equal(y, direct.numpy())
    finally:
        eng.stop()


def test_build_engine_serves_narrow_resnet18_kl():
    """Config 2 at width 8, stage sizes (1, 1, 1, 1) (patched through the
    config's width and a narrowed model), on the flat engine: KL
    thresholds, symmetric grids (act_zp 0), ``predict`` equal to the flat
    engine's forward."""
    cfg = dataclasses.replace(CONFIGS["resnet18_cifar10_int8_kl"], width=8,
                              calib_batches=1, batch_size=4, n_train=8)
    eng, info = build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                             device="cpu")
    try:
        assert info["serve_path"] == "flat-engine"
        assert info["calib_seconds"]["hist"] > 0
        nodes = dict(_nodes(to_numpy_tree(eng.vars)["qweights"]))
        assert len(nodes) == 21
        assert all(int(n["act_zp"]) == 0 and bool(n["act_sym"])
                   for n in nodes.values())
        x = np.random.default_rng(5).standard_normal(
            (3, 32, 32, 3)).astype(np.float32)
        y = eng.predict(x)
        flat = ResNetInt8Engine(eng.vars, resnet_arch(
            "resnet18", num_classes=10, image_size=32, width=8,
            cifar_stem=True), device="cpu")
        np.testing.assert_array_equal(y, flat.forward(torch.tensor(x))
                                      .numpy())
    finally:
        eng.stop()


@pytest.mark.parametrize("h", [1, 2, 3, 4, 7, 8])
def test_spatial_mean_order(h):
    """The pool before a quantized fc: an even count summed in row-major
    order and divided (PyTorch's CPU mean up to 16 values; XLA:CPU's mean
    at 4×4 and 8×8, where the half steps of a mean of 16 or 64 codes fall),
    an odd count by ``torch.mean``; NHWC and NCHW views agree."""
    x = torch.from_numpy((np.random.default_rng(h).integers(
        -127, 128, (8, h, h, 64)) * np.float32(0.0173)).astype(np.float32))
    got = qops.spatial_mean(x)
    assert torch.equal(got, qops.spatial_mean(x.permute(0, 3, 1, 2), (2, 3)))
    if h * h <= 16 or h % 2:
        assert torch.equal(got, torch.mean(x, dim=(1, 2)))
    if h in (4, 8):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.mean(jnp.asarray(x.numpy()),
                                             axis=(1, 2))))
