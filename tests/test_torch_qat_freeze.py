"""QAT-trained models against qtpu's, on the CPU: freeze after QAT — from
the EMA observers (config 5's recipe on a narrowed ResNet-50) and from
PACT's α (LeNet-5) — against qtpu's freeze of the same state, PACT
calibration, and the converted models' eval forward on frozen grids.

Both packages hold one state (qtpu's variables after its QAT steps,
carried by ``load_flax_variables``).  Tolerances: frozen codes, column
sums and zero points equal; weight scales, biases and activation scales
rtol 1e-6 (one float32 fold on each side).  The eval forward on frozen
grids with the integer forward: every quantized conv's accumulator is
exact on both sides, so the logits agree to the fc's fp32 matmul, rtol
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantMode as JMode
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.train.loop import create_train_state, make_train_step
from qtpu.transform import convert_model as j_convert
from qtpu.transform import freeze as j_freeze
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import QuantMode, QuantPolicy
from qtpu_torch.nn.layers import layer_paths
from qtpu_torch.transform import calibrate, convert_model, freeze

KEY = jax.random.PRNGKey(0)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _kw(name):
    return (dict(num_classes=10) if name == "lenet5" else
            dict(num_classes=10, width_mult=0.25) if name == "mobilenet_v2"
            else dict(num_classes=10, width=8))


def _batches(name, n=3, b=8):
    rng = np.random.default_rng(0)
    shape = (b, 28, 28, 1) if name == "lenet5" else (b, 32, 32, 3)
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def _frozen_grids(v):
    """Every in_q calibrated onto one affine grid (a fixed grid per layer
    takes the data-dependent ranges out of the comparison)."""
    def fill(t):
        for n in t.values():
            if "act_scale" in n:
                n.update(act_scale=np.float32(0.03125),
                         act_zp=np.float32(128.0),
                         calibrated=np.bool_(True))
            else:
                fill(n)
    fill(v["quant_params"])


@pytest.mark.parametrize("name", ["resnet20", "mobilenet_v2"])
def test_qat_eval_forward_bit_equal(name):
    """Frozen grids, running-statistics fold, integer forward: every
    quantized conv's accumulator is exact on both sides, so the logits
    agree to the fc's fp32 matmul (rtol 1e-6)."""
    jm = j_convert(j_get_model(name, **_kw(name)),
                   JPolicy(mode=JMode.QUANT, qat_forward="int"))
    tm = convert_model(get_model(name, **_kw(name)),
                       QuantPolicy(mode=QuantMode.QUANT, qat_forward="int"))
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    v = _np(dict(jax.jit(jm.init, static_argnames="train")(KEY, x,
                                                          train=True)))
    _frozen_grids(v)
    load_flax_variables(tm, v["params"], v["batch_stats"], v["quant_stats"],
                        v["quant_params"])
    yj = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        yt = tm.eval()(torch.tensor(x)).numpy()
    _close(yt, yj, 1e-6, "logits")


def _nodes(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            yield p, v
        elif hasattr(v, "items"):
            yield from _nodes(v, p)


def _compare_frozen(jtree, tree):
    jn, tn = dict(_nodes(jtree["qweights"])), dict(_nodes(tree["qweights"]))
    assert sorted(jn) == sorted(tn)
    for p in jn:
        a, b = jn[p], tn[p]
        for leaf in ("kernel_q", "colsum", "act_zp"):
            np.testing.assert_array_equal(b[leaf].numpy(), np.asarray(
                a[leaf]), err_msg=f"{p} {leaf}")
        for leaf in ("w_scale", "bias", "act_scale"):
            _close(b[leaf].numpy(), a[leaf], 1e-6, f"{p} {leaf}")


def _qtpu_qat(name, jpol, steps=2):
    jm = j_convert(j_get_model(name, **_kw(name)), jpol) if name != \
        "resnet50" else j_convert(j_get_model(
            "resnet50", num_classes=10, cifar_stem=True, width=16).clone(
                stage_sizes=(1, 1, 1, 1)), jpol)
    tx = optax.adamw(1e-3)
    batches = _batches("lenet5" if name == "lenet5" else "resnet", steps, 4)
    st = create_train_state(jm, KEY, jnp.asarray(batches[0][0][:2]), tx)
    step = make_train_step(jm, tx)
    for x, y in batches:
        st, _ = step(st, jnp.asarray(x), jnp.asarray(y))
    return jm, _np(st.variables()), batches[0][0]


def test_freeze_after_qat_from_ema():
    """Config 5's recipe (int4 weights, EMA activations, stem and fc fp32)
    on a narrowed ResNet-50: qtpu trains two QAT steps, the port freezes
    the same state from its own layers (no calibration)."""
    jpol = JPolicy.int4_weight_only(exclude=("stem*", "fc"))
    jm, v, x = _qtpu_qat("resnet50", jpol)
    _, jtree = j_freeze(jm, v, jnp.asarray(x))
    tm = convert_model(get_model("resnet50", num_classes=10, cifar_stem=True,
                                 width=16, stage_sizes=(1, 1, 1, 1)),
                       QuantPolicy.int4_weight_only(exclude=("stem*", "fc")))
    load_flax_variables(tm, v["params"], v["batch_stats"], v["quant_stats"],
                        v["quant_params"])
    tree = freeze(tm, tm.quant)
    _compare_frozen(_np(jtree), tree)
    np.testing.assert_array_equal(tree["params"]["stem"]["kernel"].numpy(),
                                  v["params"]["stem"]["kernel"])


def test_freeze_after_qat_from_pact():
    jm, v, x = _qtpu_qat("lenet5", JPolicy.int8_qat_pact())
    _, jtree = j_freeze(jm, v, jnp.asarray(x))
    tm = convert_model(get_model("lenet5"), QuantPolicy.int8_qat_pact())
    load_flax_variables(tm, v["params"], {}, v["quant_stats"],
                        v["quant_params"])
    assert float(layer_paths(tm)["conv2"].in_q.pact_alpha.detach()) != 6.0
    _compare_frozen(_np(jtree), freeze(tm, tm.quant))


def test_calibrate_pact_records_alpha_and_freeze_refuses_unobserved():
    tm = convert_model(get_model("lenet5"), QuantPolicy.int8_qat_pact(),
                       mode=QuantMode.QUANT)
    with torch.no_grad():
        layer_paths(tm)["fc1"].in_q.pact_alpha.fill_(0.5)
    x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(
        np.float32)
    cal = calibrate(tm, tm.quant, [x, x])
    st = cal["quant_stats"]["fc1"]
    assert float(st["min"]) == 0.0 and float(st["max"]) == 0.5 and \
        st["count"] == 2
    aq = layer_paths(tm)["fc1"].in_q
    assert bool(aq.calibrated) and float(aq.act_scale) == np.float32(
        0.5) / np.float32(255)
    fresh = convert_model(get_model("lenet5"), QuantPolicy.int8_qat())
    with pytest.raises(ValueError, match="never calibrated"):
        freeze(fresh, fresh.quant)


