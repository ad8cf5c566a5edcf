"""qtpu_torch models + calibrate + freeze vs qtpu, on the CPU.

qtpu's fp32 params and batch statistics (after two training steps, so the
running statistics are not the init values) are carried into the port's
torch ResNet; both packages then calibrate and freeze on the same numpy
batch.  Weight-derived leaves come from identical float32 operations:
``kernel_q``, ``colsum`` and ``act_zp`` must be exact, ``w_scale`` and
``bias`` agree to rtol 1e-6.  ``act_scale`` agrees to rtol 1e-5: the
activation ranges come from two fp32 conv implementations (XLA's and
PyTorch's), which sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import LayerQuantSpec, QuantPolicy
from qtpu_torch.serve.frozen import from_numpy_tree, to_numpy_tree
from qtpu_torch.transform import calibrate, freeze

KEY = jax.random.PRNGKey(0)

CASES = {
    # tests/test_engine.py recipe: resnet50 at stage_sizes (1,1,1,1), cifar stem
    "cifar_full_int8": dict(cifar=True, size=32, width=64, exclude=()),
    # ImageNet 7x7/2 stem + max-pool, fp32 stem excluded
    "imagenet_fp32stem": dict(cifar=False, size=64, width=16,
                              exclude=("stem*",)),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _qtpu_run(cifar, size, width, exclude):
    m = j_get_model("resnet50", num_classes=10, cifar_stem=cifar,
                    width=width).clone(stage_sizes=(1, 1, 1, 1))
    x = np.asarray(jax.random.normal(KEY, (4, size, size, 3)))
    qm = convert_model(m, JPolicy.int8_ptq(exclude=exclude))
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    tr = jax.jit(lambda v, xx: qm.apply(
        v, xx, train=True, mutable=["batch_stats", "quant_stats"]))
    for i in range(2):
        _, mut = tr(v, jax.random.normal(jax.random.fold_in(KEY, i),
                                         (4, size, size, 3)))
        v.update(mut)
    fp32 = {"params": _np_tree(v["params"]),
            "batch_stats": _np_tree(v["batch_stats"])}
    v = j_calibrate(qm, v, [jnp.asarray(x)])
    _, sv = j_freeze(qm, v, jnp.asarray(x))
    return x, fp32, _np_tree(sv)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = CASES[request.param]
    x, fp32, sv = _qtpu_run(**c)
    model = get_model("resnet50", num_classes=10, cifar_stem=c["cifar"],
                      width=c["width"], stage_sizes=(1, 1, 1, 1))
    load_flax_variables(model, fp32["params"], fp32["batch_stats"])
    policy = QuantPolicy.int8_ptq(exclude=c["exclude"])
    tree = freeze(model, policy, calibrate(model, policy, [x]))
    return c, sv, tree, model, x


def _nodes(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            yield p, v
        elif hasattr(v, "items"):
            yield from _nodes(v, p)


def test_freeze_matches_qtpu(case):
    c, sv, tree, _, _ = case
    got = dict(_nodes(to_numpy_tree(tree)["qweights"]))
    ref = dict(_nodes(sv["qweights"]))
    assert sorted(got) == sorted(ref)
    assert ("stem" in got) == (c["exclude"] == ())
    for path, r in ref.items():
        g = got[path]
        for leaf in ("kernel_q", "colsum", "act_zp"):
            assert g[leaf].dtype == r[leaf].dtype, (path, leaf)
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        for leaf in ("w_scale", "bias"):
            assert g[leaf].shape == r[leaf].shape
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        np.testing.assert_allclose(g["act_scale"], r["act_scale"], rtol=1e-5,
                                   err_msg=path)
        assert bool(g["act_sym"]) == bool(r["act_sym"])


def test_excluded_layers_keep_fp32_params(case):
    c, sv, tree, _, _ = case
    got = to_numpy_tree(tree)
    if not c["exclude"]:
        assert not got["params"] and not got["batch_stats"]
        return
    for col in ("params", "batch_stats"):
        r = sv[col]["stem"]
        for leaf, val in r.items():
            np.testing.assert_array_equal(got[col]["stem"][leaf], val)


def test_from_numpy_tree_round_trip(case):
    _, sv, _, _, _ = case
    tree = from_numpy_tree(sv, device="cpu")
    assert isinstance(tree["qweights"]["layer1_0"]["conv1"]["act_sym"], bool)
    back = to_numpy_tree(tree)
    flat_ref = jax.tree_util.tree_leaves_with_path(sv)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_got)
    for path, leaf in flat_ref:
        g = flat_got[path]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        np.testing.assert_array_equal(g, leaf)


def test_calibrate_is_idempotent(case):
    c, _, tree, model, x = case
    policy = QuantPolicy.int8_ptq(exclude=c["exclude"])
    again = freeze(model, policy, calibrate(model, policy, [x]))
    for (p, a), (_, b) in zip(_nodes(tree["qweights"]),
                              _nodes(again["qweights"])):
        assert torch.equal(a["act_scale"], b["act_scale"]), p
        assert torch.equal(a["act_zp"], b["act_zp"]), p


def test_freeze_refusals():
    model = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=(1, 1, 1, 1))
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    policy = QuantPolicy.int8_ptq()
    with pytest.raises(ValueError, match="never calibrated"):
        freeze(model, policy, calibrate(model, policy, []))
    no_w = QuantPolicy(default=LayerQuantSpec(quantize_weights=False))
    with pytest.raises(ValueError, match="quantize_weights=False"):
        freeze(model, no_w, calibrate(model, no_w, [x]))


def test_load_flax_variables_is_strict():
    _, fp32, _ = _qtpu_run(cifar=True, size=32, width=16, exclude=())
    model = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=(1, 1, 1, 1))
    params = jax.tree_util.tree_map(lambda a: a, fp32["params"])
    params = {k: v for k, v in params.items() if k != "fc"}
    with pytest.raises(KeyError):
        load_flax_variables(model, params, fp32["batch_stats"])
    extra = dict(fp32["params"])
    extra["bogus"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        load_flax_variables(model, extra, fp32["batch_stats"])


def test_debug_checks_catch_corrupt_nodes(case):
    """qtpu_torch.utils.debug, on: a frozen node passes, a node whose colsum
    disagrees with its codes fails, a float tensor fed to an int8 op fails."""
    from qtpu_torch.utils import debug

    _, _, tree, _, _ = case
    node = dict(tree["qweights"]["layer1_0"]["conv1"])
    prev = debug._enabled
    debug.enable(True)
    try:
        debug.check_frozen_node(node, bits=8, packed=False, path="conv1")
        with pytest.raises(AssertionError, match="colsum"):
            debug.check_frozen_node(dict(node, colsum=node["colsum"] + 1),
                                    bits=8, packed=False)
        with pytest.raises(AssertionError, match="int8"):
            debug.check_int_inputs(torch.zeros(2, 2), what="qmatmul")
        with pytest.raises(AssertionError, match="rank"):
            debug.check_quant_grid(torch.ones(2, 2), what="grid")
    finally:
        debug.enable(prev)
