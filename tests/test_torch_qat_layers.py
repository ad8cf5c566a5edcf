"""QAT forms of qtpu_torch's layers against qtpu's, on the CPU.

``ActQuant`` in every mode (fp32 pass-through, range and histogram
calibration, per-batch, EMA and frozen quantization, PACT, and the
``emit_qparams`` grid of the integer forward), then the dense layer, the
bias conv (qtpu's ``QuantConv``) and ``ConvBN`` — fp32 training with batch
statistics, the quantized conv followed by batch-statistics BN (unfolded),
exact fake-BN, approximate fake-BN, and the folded eval form — each on the
simulation and on the integer forward.  Both packages start from the same
variables (qtpu's ``init``, carried by ``load_flax_variables``) and take
the same seeded input and upstream gradient.

Tolerances: observer state (min, max, count, EMA) is computed by the same
float32 operations on the same input — equal.  Outputs, every parameter's
gradient, the input's gradient and the updated BatchNorm statistics:
rtol 1e-5 with an absolute floor of 1e-5 of the tensor's largest value
(XLA's and PyTorch's fp32 convolutions and reductions sum in different
orders; a gradient element near zero is a cancellation of such sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.nn import LayerQuantSpec as JSpec
from qtpu.nn import QuantMode as JMode
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.nn.act_quant import ActQuant as JActQuant
from qtpu.nn.layers import ConvBN as JConvBN
from qtpu.nn.layers import QuantConv as JQuantConv
from qtpu.nn.layers import QuantDense as JQuantDense
from qtpu_torch.nn import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.nn.act_quant import ActQuant
from qtpu_torch.nn.layers import (Conv, ConvBN, QuantDense,
                                  load_flax_variables)

RTOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


# --- ActQuant ---------------------------------------------------------------

def _aq_pair(observer, mode, x, steps=2, emit=False, frozen=None, **spec_kw):
    """qtpu's and the port's ActQuant over ``steps`` batches (x, then
    x·1.5 + 0.25 ...) in training; returns both outputs of the last step
    and both states."""
    jspec, tspec = (JSpec(act_observer=observer, **spec_kw),
                    LayerQuantSpec(act_observer=observer, **spec_kw))
    jm = JActQuant(jspec, JMode[mode], emit_qparams=emit)
    v = _np(dict(jm.init(jax.random.PRNGKey(0), x)))
    tm = ActQuant(tspec).train()
    if frozen is not None:
        v["quant_params"]["act_scale"] = np.float32(frozen[0])
        v["quant_params"]["act_zp"] = np.float32(frozen[1])
        tm.act_scale.fill_(frozen[0])
        tm.act_zp.fill_(frozen[1])
    if observer == "kl":
        v["quant_stats"]["hist_amax"] = np.float32(4.0)
        tm.hist_amax.fill_(4.0)
    for i in range(steps):
        xi = x * (1.0 + 0.5 * i) + 0.25 * i
        yj, mut = jm.apply(v, xi, mutable=["quant_stats"])
        v = {**v, **_np(dict(mut))}
        yt = tm(torch.tensor(xi), QuantMode[mode], emit_qparams=emit)
    return yj, yt, v, tm


AQ_CASES = [("minmax", "OFF"), ("minmax", "CALIB_RANGE"),
            ("ema", "CALIB_RANGE"), ("pact", "CALIB_RANGE"),
            ("kl", "CALIB_HIST"), ("minmax", "QUANT_ONLINE"),
            ("ema", "QUANT_EMA"), ("minmax", "QUANT"), ("pact", "QUANT_EMA"),
            ("pact", "QUANT_ONLINE")]


AQ_PARAMS = [(o, m, sym) for o, m in AQ_CASES for sym in (False, True)
             if not (o == "pact" and sym)]    # PACT is affine only


@pytest.mark.parametrize("observer,mode,symmetric", AQ_PARAMS,
                         ids=[f"{o}-{m}-{'sym' if s else 'affine'}"
                              for o, m, s in AQ_PARAMS])
def test_act_quant_modes(observer, mode, symmetric):
    x = np.random.default_rng(1).standard_normal((4, 6, 6, 3)).astype(
        np.float32) * 2
    frozen = (0.02, 0.0 if symmetric else 131.0) if mode == "QUANT" else None
    yj, yt, v, tm = _aq_pair(observer, mode, x, frozen=frozen,
                             act_symmetric=symmetric or observer == "kl")
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    st = v.get("quant_stats", {})
    for leaf in ("min", "max", "count", "hist"):
        if leaf in st:
            np.testing.assert_array_equal(getattr(tm, leaf).numpy(),
                                          st[leaf], err_msg=leaf)


@pytest.mark.parametrize("mode", ["QUANT_ONLINE", "QUANT_EMA", "QUANT"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_act_quant_emit_qparams(mode, symmetric):
    x = np.random.default_rng(2).standard_normal((2, 5, 5, 4)).astype(
        np.float32)
    frozen = (0.03, 0.0 if symmetric else 120.0) if mode == "QUANT" else None
    (sj, zj), (st, zt), v, tm = _aq_pair(
        "ema", mode, x, emit=True, frozen=frozen, act_symmetric=symmetric)
    assert float(st) == float(sj) and float(zt) == float(zj)
    if mode == "QUANT_EMA":
        assert float(tm.max) == float(v["quant_stats"]["max"])


def test_act_quant_observers_update_only_in_training():
    x = np.ones((2, 3, 3, 2), np.float32)
    tm = ActQuant(LayerQuantSpec(act_observer="ema")).eval()
    tm(torch.tensor(x), QuantMode.QUANT_EMA)
    tm(torch.tensor(x), QuantMode.CALIB_RANGE)
    assert int(tm.count) == 0
    tm.train()(torch.tensor(x), QuantMode.QUANT_EMA)
    assert int(tm.count) == 1 and float(tm.max) == 1.0


def test_pact_alpha_gradient_through_act_quant():
    x = np.clip(np.random.default_rng(3).standard_normal((4, 8)) * 3, 0,
                None).astype(np.float32)
    spec = dict(act_observer="pact", pact_init=1.5)
    jm = JActQuant(JSpec(**spec), JMode.QUANT_EMA)
    v = _np(dict(jm.init(jax.random.PRNGKey(0), x)))

    def f(params):
        y, _ = jm.apply({**v, "params": params}, x, mutable=["quant_stats"])
        return jnp.sum(y * jnp.arange(8.0))
    gj = jax.grad(f)(v["params"])["pact_alpha"]
    tm = ActQuant(LayerQuantSpec(**spec)).train()
    (tm(torch.tensor(x), QuantMode.QUANT_EMA) * torch.arange(8.0)).sum(
    ).backward()
    _close(tm.pact_alpha.grad.numpy(), gj, "dα")
    assert int(tm.count) == 0      # PACT leaves the observer alone


def test_emit_qparams_refused_for_pact():
    tm = ActQuant(LayerQuantSpec(act_observer="pact"))
    with pytest.raises(ValueError, match="PACT"):
        tm(torch.zeros(2, 2), QuantMode.QUANT_EMA, emit_qparams=True)


# --- layers ------------------------------------------------------------------

class _Wrap(torch.nn.Module):
    """One layer named ``c`` over NHWC input (qtpu's layout), so the port's
    ``load_flax_variables`` and policy paths see qtpu's ``c``."""

    def __init__(self, layer, nhwc=True):
        super().__init__()
        self.c, self.nhwc = layer, nhwc

    def forward(self, x):
        if not self.nhwc:
            return self.c(x)
        return self.c(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# (name, kind, policy kwargs or None for fp32, train, stride, groups)
LAYER_CASES = [
    ("convbn_fp32_train", "convbn", None, True, 1, 1),
    ("convbn_fp32_eval", "convbn", None, False, 1, 1),
    ("convbn_unfolded", "convbn", dict(fold_bn=False), True, 1, 1),
    ("convbn_exact", "convbn", dict(fake_bn="exact"), True, 1, 1),
    ("convbn_exact_stride2", "convbn", dict(fake_bn="exact"), True, 2, 1),
    ("convbn_exact_depthwise", "convbn", dict(fake_bn="exact"), True, 1, 8),
    ("convbn_approx", "convbn", dict(fake_bn="approx"), True, 1, 1),
    ("convbn_approx_depthwise", "convbn", dict(fake_bn="approx"), True, 2,
     8),
    ("convbn_folded_eval", "convbn", dict(fake_bn="exact"), False, 1, 1),
    ("conv_bias", "conv", dict(), True, 1, 1),
    ("conv_bias_stride2", "conv", dict(), True, 2, 1),
    ("dense", "dense", dict(), True, 1, 1),
    ("dense_fp32", "dense", None, True, 1, 1),
]


def _layer_pair(kind, pol, stride, groups, w_bits=8, per_channel=True,
                symmetric=False):
    cin, cout = 8, (8 if groups > 1 else 16)
    spec = dict(w_bits=w_bits, per_channel=per_channel,
                act_symmetric=symmetric, act_observer="ema")
    jpol = tpol = None
    if pol is not None:
        jpol = JPolicy(default=JSpec(**spec), mode=JMode.QUANT_EMA, **pol)
        tpol = QuantPolicy(default=LayerQuantSpec(**spec),
                           mode=QuantMode.QUANT_EMA, **pol)
    if kind == "convbn":
        jm = JConvBN(cout, (3, 3), (stride, stride), groups=groups,
                     act=jax.nn.relu, quant=jpol)
        tl = ConvBN(cin, cout, 3, stride, act="relu", groups=groups)
    elif kind == "conv":
        jm = JQuantConv(cout, (3, 3), (stride, stride), quant=jpol)
        tl = Conv(cin, cout, 3, stride)
    else:
        jm = JQuantDense(cout, quant=jpol)
        tl = QuantDense(cin, cout)
    tm = _Wrap(tl, nhwc=kind != "dense")
    if tpol is not None:
        tl.set_quant(tpol, "c")
    return jm, tm, tpol


def _run_pair(jm, tm, x, g, train, kind, v):
    """Forward + backward of both; returns (yj, grads_j, mut_j, yt) with the
    port's gradients left on its parameters."""
    kw = {"train": train} if kind == "convbn" else {}
    mutable = ["batch_stats", "quant_stats"] if train else False

    def f(params, xx):
        out = jm.apply({**v, "params": params}, xx, mutable=mutable, **kw)
        y, mut = out if train else (out, {})
        return jnp.sum(y * g), (y, mut)
    (_, (yj, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tm.train(train)
    yt = tm(xt)
    (yt * torch.tensor(g)).sum().backward()
    return yj, _np(gp), _np(gx), _np(dict(mut)), yt, xt


def _check_layer(jm, tm, kind, x, train, pre=None):
    g = np.random.default_rng(5).standard_normal(
        np.asarray(jax.eval_shape(
            lambda: jm.init_with_output(jax.random.PRNGKey(0), x)[0]).shape)
    ).astype(np.float32)
    v = _np(dict(jm.init(jax.random.PRNGKey(0), x,
                         **({"train": True} if kind == "convbn" else {}))))
    if pre is not None:
        pre(v)
    wrap = lambda t: {"c": t}  # noqa: E731
    load_flax_variables(tm, wrap(v["params"]), wrap(v.get("batch_stats", {})),
                        *((wrap(v["quant_stats"]), wrap(v["quant_params"]))
                          if "quant_stats" in v else ()))
    yj, gp, gx, mut, yt, xt = _run_pair(jm, tm, x, g, train, kind, v)
    _close(yt.detach().numpy(), yj, "output")
    _close(xt.grad.numpy(), gx, "dx")
    layer = tm.c
    names = {"kernel": (layer.conv.weight if kind != "dense"
                        else layer.weight),
             "bias": (layer.bn.bias if kind == "convbn" else
                      layer.conv.bias if kind == "conv" else layer.bias)}
    if kind == "convbn":
        names["scale"] = layer.bn.weight
    for name, p in names.items():
        gt = p.grad.numpy()
        if name == "kernel":
            gt = (gt.transpose(2, 3, 1, 0) if gt.ndim == 4 else gt.T)
        _close(gt, gp[name], f"d{name}")
    if "batch_stats" in mut:
        _close(layer.bn.running_mean.numpy(), mut["batch_stats"]["mean"],
               "running mean")
        _close(layer.bn.running_var.numpy(), mut["batch_stats"]["var"],
               "running var")
    if "quant_stats" in mut:
        st = mut["quant_stats"]["in_q"]
        for leaf in ("min", "max", "count"):
            np.testing.assert_array_equal(getattr(layer.in_q, leaf).numpy(),
                                          st[leaf], err_msg=leaf)


def _calibrated(v):
    """A frozen grid for a folded-eval case (QUANT_EMA's eval reads the
    EMA state: give it a range)."""
    v["quant_stats"]["in_q"]["min"] = np.float32(-2.5)
    v["quant_stats"]["in_q"]["max"] = np.float32(3.0)
    v["quant_stats"]["in_q"]["count"] = np.int32(4)
    v["batch_stats"]["mean"] = np.linspace(-0.2, 0.3, 16).astype(np.float32)
    v["batch_stats"]["var"] = np.linspace(0.5, 2.0, 16).astype(np.float32)


LAYER_PARAMS = [(*c, fwd) for c in LAYER_CASES
                for fwd in (("sim",) if c[2] is None else ("sim", "int"))]


@pytest.mark.parametrize("name,kind,pol,train,stride,groups,forward",
                         LAYER_PARAMS,
                         ids=[f"{c[0]}-{c[-1]}" for c in LAYER_PARAMS])
def test_layer_qat_forms(name, kind, pol, train, stride, groups, forward):
    pol = None if pol is None else {**pol, "qat_forward": forward}
    jm, tm, _ = _layer_pair(kind, pol, stride, groups)
    shape = (4, 8) if kind == "dense" else (4, 8, 8, 8)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    _check_layer(jm, tm, kind, x, train,
                 pre=_calibrated if name == "convbn_folded_eval" else None)


@pytest.mark.parametrize("w_bits,per_channel,symmetric",
                         [(4, True, False), (8, False, False),
                          (8, True, True)])
@pytest.mark.parametrize("forward", ["sim", "int"])
def test_convbn_exact_grids(w_bits, per_channel, symmetric, forward):
    """Exact fake-BN on int4 weights, per-tensor weights and symmetric
    activations."""
    jm, tm, _ = _layer_pair("convbn", dict(fake_bn="exact",
                                           qat_forward=forward), 1, 1,
                            w_bits=w_bits, per_channel=per_channel,
                            symmetric=symmetric)
    x = np.random.default_rng(6).standard_normal((4, 8, 8, 8)).astype(
        np.float32)
    _check_layer(jm, tm, "convbn", x, True)


def test_excluded_layer_stays_fp32():
    """A layer the policy excludes has no ``in_q`` and runs the fp32 form."""
    tl = ConvBN(4, 8, 3)
    ref = ConvBN(4, 8, 3)
    ref.load_state_dict(tl.state_dict())
    tl.set_quant(QuantPolicy.int8_qat(exclude=("c",)), "c")
    assert tl.in_q is None
    x = torch.randn(2, 4, 6, 6)
    assert torch.equal(tl.eval()(x), ref.eval()(x))
