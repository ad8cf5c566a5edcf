"""qtpu_torch's trainer against qtpu's, on the CPU: training steps from
carried qtpu weights, AdamW against ``optax.adamw``, ``evaluate`` with its
remainder batch, conversion, and ``run_experiment``.

Both packages start from one state — qtpu's ``create_train_state`` output
as numpy, carried by ``load_flax_variables`` — and take the same seeded
batches.  Tolerances, each with its reason:

* fp32 steps (ResNet-20 at width 8) and integer-forward / PACT QAT steps
  (LeNet-5): losses rtol 1e-5; the weights rel-L2 ≤ 1e-4 over all of them
  together and elementwise rtol 1e-4 but for at most 0.1% of the elements
  or two (an element whose gradient is near zero moves by Adam's normalised step,
  ±lr, whichever sign its gradient takes); EMA observer ranges rtol 1e-5;
  BatchNorm running statistics per tensor rel-L2 ≤ 1e-4 (the third batch's
  statistics follow weights such an element moved).
* QAT steps of a network with BatchNorm between quantizers (ResNet-20 with
  exact fake-BN): the two packages' fp32 statistics convs and reductions
  sum in different orders, so a few activation codes sit on the other side
  of a rounding tie; each such code moves its channel's batch statistics
  and the next layer's EMA range, which moves more codes — the difference
  grows with depth (qtpu against itself, compiled at two XLA optimisation
  levels, differs by 1.9e-3 in the first step's loss).  The per-layer
  forms are held to rtol 1e-5 in tests/test_torch_qat_layers.py, and the
  same network's eval forward on frozen grids is bit-equal
  (tests/test_torch_qat_freeze.py); the
  training steps are held to losses rtol 1e-2 and the weights' rel-L2 ≤
  5e-2 (measured: ≤ 1.1e-3 and 1.1e-2 for the worst tensor).

Freeze after QAT and the QAT models' eval forward: test_torch_qat_freeze.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qtpu.data.datasets import Dataset as JDataset
from qtpu.examples.configs import CONFIGS as J_CONFIGS
from qtpu.examples.run import run_experiment as j_run_experiment
from qtpu.models import get_model as j_get_model
from qtpu.nn import LayerQuantSpec as JSpec
from qtpu.nn import QuantMode as JMode
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.train import evaluate as j_evaluate
from qtpu.train.loop import create_train_state, make_train_step
from qtpu.transform import convert_model as j_convert
from qtpu_torch.data import Dataset
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.examples.run import main, run_experiment
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.nn.layers import layer_paths
from qtpu_torch.train import adamw, create_train_state as t_state
from qtpu_torch.train import evaluate, train_step
from qtpu_torch.transform import (convert_model, deep_merge,
                                  quantize_variables, set_mode, strip_quant)

KEY = jax.random.PRNGKey(0)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _kw(name):
    return (dict(num_classes=10) if name == "lenet5" else
            dict(num_classes=10, width_mult=0.25) if name == "mobilenet_v2"
            else dict(num_classes=10, width=8))


def _pair(name, jpol=None, tpol=None):
    """qtpu's model and train state, and the port's model carrying it."""
    jm = j_get_model(name, **_kw(name))
    tm = get_model(name, **_kw(name))
    if jpol is not None:
        jm, tm = j_convert(jm, jpol), convert_model(tm, tpol)
    shape = (2, 28, 28, 1) if name == "lenet5" else (2, 32, 32, 3)
    tx = optax.adamw(1e-3)
    st = create_train_state(jm, KEY, jnp.zeros(shape), tx)
    v = _np(st.variables())
    load_flax_variables(tm, v["params"], v.get("batch_stats", {}),
                        v.get("quant_stats"), v.get("quant_params"))
    return jm, tm, st, tx


def _batches(name, n=3, b=8):
    rng = np.random.default_rng(0)
    shape = (b, 28, 28, 1) if name == "lenet5" else (b, 32, 32, 3)
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def _leaf(tree, path, leaf):
    for k in path.split("/"):
        tree = tree[k]
    return tree[leaf]


def _steps(name, jpol=None, tpol=None):
    """Three steps in both packages; returns the per-step losses and both
    final states."""
    jm, tm, st, tx = _pair(name, jpol, tpol)
    step = make_train_step(jm, tx)
    ts = t_state(tm, 1e-3)
    losses = []
    for x, y in _batches(name):
        st, mj = step(st, jnp.asarray(x), jnp.asarray(y))
        mt = train_step(ts, x, y)
        losses.append((float(mj["loss"]), float(mt["loss"])))
    return losses, _np(st.params), _np(st.extra), tm


def _check_params(jp, tm, limit, lr=1e-3, steps=3, elementwise=True):
    """Every weight against qtpu's: rel-L2 over all of them together ≤
    ``limit``; elementwise within rtol ``limit`` (floor ``limit`` of the
    tensor's largest value) but for at most 0.1% of the elements (or two),
    each
    within Adam's largest move, 2·lr a step (an element whose gradient is
    near zero steps ±lr whichever sign its gradient takes); without
    ``elementwise`` only the first and the last."""
    got, want = [], []
    for path, m in layer_paths(tm).items():
        w = (m.conv.weight if hasattr(m, "conv") else m.weight).detach()
        w = w.numpy()
        w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        ref = _leaf(jp, path, "kernel")
        off = np.abs(w - ref) > limit * (np.abs(ref) + np.abs(ref).max())
        assert not elementwise or off.sum() <= max(2, 1e-3 * off.size), (
            path, int(off.sum()))
        assert np.abs(w - ref).max() <= 2 * lr * steps * 1.01, path
        got.append(w.ravel())
        want.append(ref.ravel())
        aq = getattr(m, "in_q", None)
        if aq is not None and aq.pact_alpha is not None:
            _close(aq.pact_alpha.detach().numpy(),
                   _leaf(jp, path + "/in_q", "pact_alpha"), 1e-5, "α")
    worst = _rel_l2(np.concatenate(got), np.concatenate(want))
    assert worst <= limit, worst
    return worst


def _check_state(extra, tm, tol):
    """BatchNorm running statistics per tensor to rel-L2 ≤ ``tol``, EMA
    observer ranges to rtol ``tol``, counts equal."""
    for path, m in layer_paths(tm).items():
        if hasattr(m, "bn"):
            for leaf, buf in (("mean", m.bn.running_mean),
                              ("var", m.bn.running_var)):
                ref = _leaf(extra["batch_stats"], path, leaf)
                assert _rel_l2(buf.numpy(), ref) <= tol, (path, leaf)
        aq = getattr(m, "in_q", None)
        if aq is not None:
            qs = extra["quant_stats"]
            for leaf in ("min", "max"):
                _close(getattr(aq, leaf).numpy(),
                       _leaf(qs, path + "/in_q", leaf), tol,
                       f"{path} {leaf}")
            assert int(aq.count) == int(_leaf(qs, path + "/in_q", "count"))


def test_fp32_steps_match_qtpu():
    losses, jp, extra, tm = _steps("resnet20")
    for lj, lt in losses:
        assert abs(lt - lj) <= 1e-5 * abs(lj), losses
    _check_params(jp, tm, 1e-4)
    _check_state(extra, tm, 1e-4)


@pytest.mark.parametrize("observer,forward,tol", [("ema", "int", 1e-5),
                                                  ("pact", "sim", 1e-4)])
def test_qat_steps_match_qtpu_lenet(observer, forward, tol):
    """LeNet-5 (no BatchNorm): the integer forward with EMA ranges, and PACT
    (whose grid is α's) on the simulation, whose fp32 convs sum in another
    order and can put a code across a tie: losses rtol 1e-4 there (measured
    2.5e-5 at the third step) and the weights rel-L2 ≤ 1e-3 (measured
    2.8e-4 for the worst tensor)."""
    jpol = JPolicy(default=JSpec(act_observer=observer), mode=JMode.QUANT_EMA,
                   qat_forward=forward)
    tpol = QuantPolicy(default=LayerQuantSpec(act_observer=observer),
                       mode=QuantMode.QUANT_EMA, qat_forward=forward)
    losses, jp, extra, tm = _steps("lenet5", jpol, tpol)
    for lj, lt in losses:
        assert abs(lt - lj) <= tol * abs(lj), losses
    _check_params(jp, tm, 10 * tol, elementwise=forward == "int")
    _check_state(extra, tm, 1e-5)


def test_qat_steps_resnet_exact_fake_bn():
    """Config 3's recipe (EMA, exact fake-BN) on ResNet-20 at width 8, on
    the simulation (qtpu's own jitted integer-forward step turns its
    parameters to NaN under this suite's XLA flags — optimisation level 0 —
    and stays finite under the default ones; ROADMAP.md C17)."""
    jpol = JPolicy.int8_qat()
    tpol = QuantPolicy.int8_qat()
    losses, jp, extra, tm = _steps("resnet20", jpol, tpol)
    for lj, lt in losses:
        assert np.isfinite(lt) and abs(lt - lj) <= 1e-2 * abs(lj), losses
    _check_params(jp, tm, 5e-2, elementwise=False)


def test_adamw_matches_optax():
    """qtpu's optax.adamw(lr) (weight decay 1e-4) against the port's
    AdamW over five steps of the same gradients: rtol 1e-6 (the bias
    corrections are folded in another order)."""
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = optax.adamw(3e-2)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(pj)
    mod = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                  for k, v in p0.items()})
    opt_t = adamw(mod, 3e-2)
    assert opt_t.defaults["weight_decay"] == 1e-4
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in g.items():
            mod[k].grad = torch.tensor(v)
        opt_t.step()
    for k in p0:
        _close(mod[k].detach().numpy(), pj[k], 1e-6, k)


class _ConstModel(torch.nn.Module):
    """Always predicts class 0 (top-1) and classes {0..4} (top-5)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        base = torch.arange(10, 0, -1, dtype=torch.float32)
        return base.expand(x.shape[0], 10) + self.w


def test_evaluate_counts_remainder_batch():
    """qtpu's test_eval_loop: 6 samples at batch 4, the remainder kept."""
    images = np.zeros((6, 8, 8, 1), np.float32)
    labels = np.array([0, 0, 0, 0, 0, 9], np.int64)
    top1, top5 = evaluate(_ConstModel(), Dataset(images, labels, 10),
                          batch_size=4)
    assert top1 == 5 / 6 and top5 == 5 / 6
    import flax.linen as fnn

    class JConst(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            base = jnp.arange(10, 0, -1, dtype=jnp.float32)
            return jnp.broadcast_to(base, (x.shape[0], 10))
    jv = JConst().init(KEY, jnp.asarray(images[:2]))
    assert (top1, top5) == j_evaluate(JConst(), jv, JDataset(
        images, labels, 10), batch_size=4)


def test_convert_set_mode_strip_quant():
    m = get_model("lenet5")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    q = convert_model(m, QuantPolicy.int8_qat(), exclude=("fc3",))
    assert all(getattr(x, "in_q", None) is None
               for x in layer_paths(m).values())
    assert q.quant.exclude == ("fc3",) and q.quant.mode == QuantMode.QUANT_EMA
    paths = layer_paths(q)
    assert paths["fc3"].in_q is None and paths["conv1"].in_q is not None
    assert paths["conv1"].spec == LayerQuantSpec(act_observer="ema")
    q.train()(torch.zeros(2, 28, 28, 1))
    assert int(paths["conv1"].in_q.count) == 1
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k          # the fp32 model as it was
    q2 = set_mode(q, QuantMode.QUANT)
    assert q2.quant.mode == QuantMode.QUANT and q.quant.mode == \
        QuantMode.QUANT_EMA
    assert int(layer_paths(q2)["conv1"].in_q.count) == 1   # state carried
    s = strip_quant(q)
    assert s.quant is None and all(
        getattr(x, "in_q", None) is None for x in layer_paths(s).values())
    x = torch.randn(2, 28, 28, 1)
    assert torch.equal(s.eval()(x), m.eval()(x))
    refined = convert_model(q, exclude=("fc2",), mode=QuantMode.QUANT)
    assert refined.quant.exclude == ("fc3", "fc2")
    with pytest.raises(ValueError, match="convert it first"):
        set_mode(m, QuantMode.QUANT)


def test_deep_merge_and_quantize_variables():
    assert deep_merge({"a": {"x": 1, "alpha": 6}, "b": 2},
                      {"a": {"x": 3}, "c": 4}) == \
        {"a": {"x": 3, "alpha": 6}, "b": 2, "c": 4}
    trained = get_model("lenet5")
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(1.0)
    q = convert_model(get_model("lenet5"),
                      QuantPolicy.int8_qat_pact())
    quantize_variables(q, trained)
    for path, m in layer_paths(q).items():
        ref = layer_paths(trained)[path]
        assert torch.equal(m.weight if hasattr(m, "weight") and not hasattr(
            m, "conv") else m.conv.weight,
            ref.weight if not hasattr(ref, "conv") else ref.conv.weight)
        assert float(m.in_q.pact_alpha.detach()) == 6.0
        assert int(m.in_q.count) == 0
    with pytest.raises(ValueError, match="lacks"):
        quantize_variables(get_model("lenet5"), q.state_dict())


def _tiny(cfg):
    return dataclasses.replace(cfg, n_train=64, n_eval=40, fp32_epochs=1,
                               qat_epochs=1, batch_size=32, calib_batches=2)


@pytest.mark.parametrize("method", ["ptq", "qat", "online"])
def test_run_experiment_lenet_keys(method, capsys):
    """``run_experiment`` for each method: qtpu's JSON keys, as its own
    run of the same config prints them."""
    cfg = _tiny(dataclasses.replace(CONFIGS["lenet_mnist_int8"],
                                    method=method, serve=method == "ptq"))
    got = run_experiment(cfg, verbose=False, device="cpu")
    want = j_run_experiment(_tiny(dataclasses.replace(
        J_CONFIGS["lenet_mnist_int8"], method=method,
        serve=method == "ptq")), verbose=False)
    assert sorted(got) == sorted(want)
    assert sorted(got.get("serving", {})) == sorted(want.get("serving", {}))
    for k in ("config", "dataset", "synthetic_data", "w_bits", "a_bits",
              "method", "act_observer"):
        assert got[k] == want[k], k
    for k in ("fp32_top1", "quant_top1"):
        assert 0.0 <= got[k] <= 1.0
    printed = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith('{"config": "lenet_mnist_int8"')
               for line in printed)


def test_run_cli_device_and_refusals(capsys):
    assert main(["--config", "lenet_mnist_int8", "--device", "cpu",
                 "--quiet", "--set", "n_train=32", "--set", "n_eval=8",
                 "--set", "fp32_epochs=1", "--set", "batch_size=16",
                 "--set", "calib_batches=1"]) == 0
    assert '"method": "ptq"' in capsys.readouterr().out
    for flag, value in (("--dp", "2"), ("--save-state", "s"),
                        ("--load-state", "s"), ("--torch-ckpt", "c.pth")):
        with pytest.raises(SystemExit, match="ROADMAP"):
            main(["--config", "lenet_mnist_int8", "--device", "cpu", flag,
                  value])
