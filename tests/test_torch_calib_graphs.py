"""Calibration's passes compiled per batch shape: the observers' in-place
updates and the passes' graph logic, on the CPU (the graphs themselves run
on the card: tests/test_torch_gpu_serve.py).

* ``minmax_update_``, ``ema_update_`` and ``hist_update_`` write into the
  state's own tensors (their storage unchanged, as a replayed graph needs)
  values equal bit for bit to the functional updates' and to qtpu's jitted
  observers', over batches of several shapes, the 2^24 case of the
  histogram included; the histogram's integer scatter equals
  ``torch.bincount``.
* The flow of a graphed calibration driven on the CPU with the capture
  replaced by a recorder: per batch shape two eager batches, the third
  captured, then replays, for the range pass and the histogram pass; a
  shape seen twice or less stays eager; ``quant_stats`` and
  ``quant_params`` equal to the eager calibration's bit for bit on LeNet-5
  (min-max, EMA, KL) and a narrowed ResNet-20 (KL).
* A pass graph's count bookkeeping: the capture moves no host count, every
  replay advances each observed layer's by one.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.calib import observers as jobs
from qtpu_torch.calib import observers as tobs
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn import LayerQuantSpec, QuantPolicy
from qtpu_torch.transform.calibrate import calibrate

# the module (``qtpu_torch.transform.calibrate`` the package re-exports is
# the function)
tcal_mod = importlib.import_module("qtpu_torch.transform.calibrate")
RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(shapes, seed=5):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal(s) * (1 + 0.5 * i)).astype(np.float32)
            for i, s in enumerate(shapes)]


SHAPES = [(4, 8, 8, 3), (4, 8, 8, 3), (2, 5, 7, 3), (4, 8, 8, 3), (1000,)]


# ---- the observers in place -----------------------------------------------------

@pytest.mark.parametrize("kind", ["minmax", "ema"])
def test_inplace_range_observers_equal_functional_and_qtpu(kind):
    batches = _batches(SHAPES)
    if kind == "ema":
        upd, upd_, jupd = (tobs.ema_update, tobs.ema_update_,
                           jax.jit(jobs.ema_update))
    else:
        upd, upd_, jupd = (tobs.minmax_update, tobs.minmax_update_,
                           jax.jit(jobs.minmax_update))
    fn, st, js = tobs.minmax_init(), tobs.minmax_init(), jobs.minmax_init()
    ptrs = (st["min"].data_ptr(), st["max"].data_ptr())
    for b in batches:
        x = torch.from_numpy(b)
        fn = upd(fn, x)
        assert upd_(st, x) is st
        js = jupd(js, jnp.asarray(b))
        assert (st["min"].data_ptr(), st["max"].data_ptr()) == ptrs
        for k in ("min", "max"):
            assert st[k].dtype == torch.float32
            assert torch.equal(st[k], fn[k]), k
            assert st[k].item() == np.float32(js[k]), k
    assert st["count"] == fn["count"] == int(js["count"]) == len(batches)
    assert isinstance(st["count"], int)


@pytest.mark.parametrize("nbins,outliers", [(2048, False), (2048, True),
                                            (64, False)])
def test_inplace_hist_equals_functional_and_qtpu(nbins, outliers):
    batches = _batches(SHAPES, seed=9)
    if outliers:
        for b in batches:
            b.reshape(-1)[:5] *= 60.0
    amax = float(np.float32(max(np.abs(b).max() for b in batches) * 0.9))
    fn = tobs.hist_set_range(tobs.hist_init(nbins), np.float32(amax))
    st = tobs.hist_set_range(tobs.hist_init(nbins), np.float32(amax))
    js = jobs.hist_set_range(jobs.hist_init(nbins), jnp.float32(amax))
    ptr = st["counts"].data_ptr()
    step = jax.jit(jobs.hist_update)
    for b in batches:
        fn = tobs.hist_update(fn, torch.from_numpy(b))
        assert tobs.hist_update_(st, torch.from_numpy(b)) is st
        js = step(js, jnp.asarray(b))
    assert st["counts"].data_ptr() == ptr
    assert torch.equal(st["counts"], fn["counts"])
    np.testing.assert_array_equal(st["counts"].numpy(),
                                  np.asarray(js["counts"]))
    assert float(st["counts"].sum()) == sum(b.size for b in batches)


def test_inplace_hist_past_2_24():
    """A bin already at 2^24 still gains a batch's 1000 in place, as the
    functional update and qtpu's."""
    st = tobs.hist_set_range(tobs.hist_init(8), 1.0)
    st["counts"][0] = 2.0 ** 24
    fn = tobs.hist_update(dict(st, counts=st["counts"].clone()),
                          torch.zeros(1000))
    tobs.hist_update_(st, torch.zeros(1000))
    assert float(st["counts"][0]) == 2.0 ** 24 + 1000.0
    assert torch.equal(st["counts"], fn["counts"])
    js = jobs.hist_set_range(jobs.hist_init(nbins=8), jnp.float32(1.0))
    js = {**js, "counts": js["counts"].at[0].set(2.0 ** 24)}
    js = jobs.hist_update(js, jnp.zeros((1000,), jnp.float32))
    np.testing.assert_array_equal(st["counts"].numpy(),
                                  np.asarray(js["counts"]))


@pytest.mark.parametrize("n", [1, 1000, 300_000])
def test_scatter_counts_equal_bincount(n):
    x = torch.from_numpy(RNG.standard_normal(n).astype(np.float32))
    st = tobs.hist_set_range(tobs.hist_init(), 2.5)
    idx = torch.clamp((x.abs() / st["amax"] * 2048).to(torch.int32), 0,
                      2047)
    want = torch.bincount(idx.to(torch.int64), minlength=2048)
    assert torch.equal(tobs.hist_update(st, x)["counts"],
                       want.to(torch.float32))


# ---- the passes' graph logic ------------------------------------------------------

class _Recorder:
    """Stands in for the card's side stream and capture on the CPU: an
    eager batch runs the forward; a captured pass graph runs nothing at
    capture (a captured call has not run) and the forward at every replay,
    its hooks advancing the counts as a replay's recorded counts do."""

    def __init__(self):
        self.log = []
        rec = self

        class Graph:
            def __init__(self, model, b, device, counted):
                rec.log.append(("capture", tuple(b.shape)))
                self.model = model

            def replay(self, b):
                rec.log.append(("replay", tuple(b.shape)))
                self.model(b)
        self.graph = Graph

    def eager(self, model, x, device):
        self.log.append(("eager", tuple(x.shape)))
        model(x)


def _graphed_on_cpu(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tcal_mod, "_graphs_on", lambda dev, graphed: graphed)
    monkeypatch.setattr(tcal_mod, "_eager_on_side_stream", rec.eager)
    monkeypatch.setattr(tcal_mod, "_PassGraph", rec.graph)
    return rec


def _model(name):
    if name == "lenet5":
        m = get_model("lenet5", num_classes=10)
    else:
        m = get_model("resnet20", num_classes=10, width=8,
                      stage_sizes=(1, 1, 1))
    init_weights(m, torch.Generator().manual_seed(3))
    return m


def _assert_equal(got, ref):
    assert got["quant_stats"].keys() == ref["quant_stats"].keys()
    for p, st in got["quant_stats"].items():
        want = ref["quant_stats"][p]
        assert st.keys() == want.keys(), p
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, want[k]), (p, k)
            else:
                assert v == want[k], (p, k)
    for p, q in got["quant_params"].items():
        for k in ("act_scale", "act_zp"):
            assert torch.equal(q[k], ref["quant_params"][p][k]), (p, k)


@pytest.mark.parametrize("name,observer", [
    ("lenet5", "minmax"), ("lenet5", "ema"), ("lenet5", "kl"),
    ("resnet20", "kl")])
def test_graphed_calibration_flow_equals_eager(name, observer, monkeypatch):
    hw, c = (28, 1) if name == "lenet5" else (16, 3)
    shapes = [(3, hw, hw, c)] * 3 + [(2, hw, hw, c)] * 2 + [(3, hw, hw, c)]
    batches = _batches(shapes, seed=11)
    policy = QuantPolicy(default=LayerQuantSpec(act_observer=observer))
    model = _model(name)
    rec = _graphed_on_cpu(monkeypatch)
    # graphs turned off: no graph, no side stream
    ref = calibrate(model, policy, batches, graphed=False)
    assert rec.log == []
    got = calibrate(model, policy, batches)
    big, small = shapes[0], shapes[3]
    one_pass = ([("eager", big)] * 2 + [("capture", big), ("replay", big)]
                + [("eager", small)] * 2 + [("replay", big)])
    assert rec.log == one_pass * (2 if observer == "kl" else 1)
    _assert_equal(got, ref)
    assert all(st["count"] == len(batches)
               for st in got["quant_stats"].values())
    assert set(got["seconds"]) == {"range", "hist", "search"}


def test_pass_graph_counts_move_on_replay_only(monkeypatch):
    """``_PassGraph``'s bookkeeping with the capture replaced by a call:
    the capture leaves every host count as it was, each replay adds one to
    each layer the forward observed."""
    model = _model("lenet5")
    policy = QuantPolicy.int8_ptq()
    layers = {p: m for p, m in tcal_mod.layer_paths(model).items()
              if policy.spec_for(p) is not None}
    stats = {p: tobs.minmax_init() for p in layers}
    stats["conv1"]["count"] = 2
    def observe(path):
        def hook(_module, args):
            tobs.minmax_update_(stats[path], args[0])
        return hook
    for p in layers:
        layers[p].register_forward_pre_hook(observe(p))

    class Graph:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            pass                   # a replay runs no Python: no hook

    def capture_call(fn, device, what):
        fn()
        return Graph(fn), None, {}, 0
    monkeypatch.setattr(tcal_mod, "capture_call", capture_call)
    x = torch.from_numpy(_batches([(2, 28, 28, 1)])[0])
    model.eval()
    with torch.no_grad():
        g = tcal_mod._PassGraph(model, x, torch.device("cpu"), stats)
        assert [st["count"] for st in stats.values()] == [2] + [0] * (
            len(stats) - 1)
        assert g.counts == {p: 1 for p in stats}
        g.replay(x)
        g.replay(x)
    assert [st["count"] for st in stats.values()] == [4] + [2] * (
        len(stats) - 1)
