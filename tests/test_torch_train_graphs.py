"""The QAT step's pad code on the device and the logic of the compiled
steps, on the CPU (the graphs themselves run on the card:
tests/test_torch_gpu_train.py).

* The integer-forward QAT conv with its pad code as a 0-d int32 tensor:
  the accumulator equals the one of the int pad code (K2's and K3's plain
  versions and wrappers, negative, zero and positive codes, SAME, VALID,
  explicit pads, stride 2, depthwise), and the conv — forward and both
  gradients — equals qtpu's ``qat_int_conv`` (held as
  tests/test_torch_qat_int.py holds it), with every host read patched to
  raise.
* One forward and backward of narrowed configs 3 and 5 (MobileNet-v2 at
  width 0.25, ResNet-50 at width 16, stages 1-1-1-1), on the integer
  forward and on the simulation, training mode, with ``Tensor.item``,
  ``__int__``, ``__float__``, ``__bool__``, ``__index__``, ``tolist`` and
  ``torch.tensor`` of a Python number patched to raise: the step's model
  part reads nothing back from the device, so a CUDA graph can hold it.
  The patches are on during the forward and the backward only: AdamW's
  step on the CPU (not ``capturable``) reads its step count on the host.
* The graph logic that needs no card: the plan by step count (two eager,
  the third captured, then replays), where graphs apply (a card, one
  rank, not turned off), the dispatch under a mesh of two ranks (eager,
  with its group) and of one (graphed), the off switch, the evaluation
  graphs' keys (the remainder batch a second), AdamW's ``capturable``;
  the flow of a graphed training run driven on the CPU with the capture
  replaced by a recorder, equal bit for bit to the eager run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops.qat_int import qat_int_conv as j_qat_int_conv
from qtpu_torch.data import Dataset
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.ops import qat_int
from qtpu_torch.ops import qconv as k2
from qtpu_torch.ops import qdepthwise as k3
from qtpu_torch.train import loop
from qtpu_torch.train import graphs as tgraphs
from qtpu_torch.train import create_train_state, train_step
from qtpu_torch.transform import convert_model


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the steps here are small, and beside the
    suite's other workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_host_reads(monkeypatch):
    """Patch every way a tensor's value reaches the host to raise."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return f
    for name in ("item", "__int__", "__float__", "__bool__", "__index__",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    tensor = torch.tensor

    def no_number_upload(data, *a, **k):
        if k.get("device") is not None and isinstance(data, (int, float)):
            raise AssertionError(f"host upload: torch.tensor({data!r}, "
                                 f"device={k['device']})")
        return tensor(data, *a, **k)
    monkeypatch.setattr(torch, "tensor", no_number_upload)


# ---- the pad code as a 0-d int32 tensor ---------------------------------------

# (Ci, Co, kernel, stride, padding, groups)
ACC_CASES = [(8, 16, 3, 1, "SAME", 1), (8, 16, 3, 2, "SAME", 1),
             (8, 16, 3, 1, "VALID", 1), (8, 16, 3, 2, ((1, 1), (1, 1)), 1),
             (8, 16, 1, 2, "SAME", 1), (3, 8, 3, 2, "SAME", 1),
             (16, 16, 3, 1, "SAME", 16), (16, 16, 3, 2, "SAME", 16),
             (16, 16, 3, 1, "VALID", 16)]


@pytest.mark.parametrize("zp", [-37, 0, 45])
@pytest.mark.parametrize("ci,co,k,s,padding,groups", ACC_CASES)
def test_int_acc_tensor_pad_code_equals_int(ci, co, k, s, padding, groups,
                                            zp):
    g = torch.Generator().manual_seed(ci * co + k + s)
    x = torch.randint(-128, 128, (2, 9, 9, ci), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (co, ci // groups, k, k), generator=g,
                      dtype=torch.int8)
    args = dict(stride=s, padding=padding, groups=groups)
    ref = qat_int.int_acc(x, w, zp=zp, **args)
    got = qat_int.int_acc(x, w, zp=torch.tensor(zp, dtype=torch.int32),
                          **args)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    # the wrappers' CPU route (their plain versions) likewise
    if groups == 1:
        pads = k2.qops.resolve_pads((9, 9), (k, k), (s, s), padding)
        w_nk = w.permute(0, 2, 3, 1).reshape(co, -1).contiguous()
        kw = dict(kernel_hw=(k, k), stride=s, pads=pads, raw_acc=True)
        a = k2.qconv2d_folded(x, w_nk, None, None, zp=zp, **kw)
        b = k2.qconv2d_folded(x, w_nk, None, None,
                              zp=torch.tensor(zp, dtype=torch.int32), **kw)
    else:
        taps = w.reshape(co, k * k).t().contiguous()
        kw = dict(kernel_hw=(k, k), stride=s, padding=padding, raw_acc=True)
        a = k3.qdepthwise_folded(x, taps, None, None, zp=zp, **kw)
        b = k3.qdepthwise_folded(x, taps, None, None,
                                 zp=torch.tensor(zp, dtype=torch.int32), **kw)
    assert torch.equal(a, b) and torch.equal(a, ref)


def test_pad_code_tensor_of_another_kind_refused():
    with pytest.raises(ValueError, match="0-d int32"):
        k2.device_pad_code(torch.tensor([3], dtype=torch.int32),
                           torch.device("cpu"))
    with pytest.raises(ValueError, match="0-d int32"):
        k2.device_pad_code(torch.tensor(3.0), torch.device("cpu"))
    assert k2.device_pad_code(5, torch.device("cpu")) is None


def _grid(seed, shape, kshape, zp_u):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, kshape)
    codes[0, 0, 0, :] = 127
    w = (codes * 2.0 ** -7).astype(np.float32)
    q = rng.integers(0, 256, shape)
    return ((q - zp_u) * 2.0 ** -6).astype(np.float32), w


# zp_u 30 pads with -98, 128 with 0, 201 with +73
@pytest.mark.parametrize("zp_u", [30.0, 128.0, 201.0])
@pytest.mark.parametrize("strides,padding,groups", [
    ((1, 1), "SAME", 1), ((1, 1), "VALID", 1), ((2, 2), "SAME", 1),
    ((2, 2), "VALID", 1), ((1, 1), "SAME", 16), ((2, 2), "SAME", 16)])
def test_qat_int_conv_device_pad_code_matches_qtpu(zp_u, strides, padding,
                                                   groups, monkeypatch):
    x, w = _grid(11, (2, 9, 9, 16), (3, 3, 16 // groups, 16), zp_u)
    kw = dict(a_bits=8, w_bits=8, per_channel=True, act_symmetric=False,
              strides=strides, padding=padding, groups=groups)

    def j(xx, ww):
        return j_qat_int_conv(xx, ww, jnp.float32(2.0 ** -6),
                              jnp.float32(zp_u), **kw)
    y_j, vjp = jax.vjp(j, jnp.asarray(x), jnp.asarray(w))
    g = (np.random.default_rng(3).integers(-4, 5, y_j.shape) * 2.0 ** -4
         ).astype(np.float32)
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                      ).requires_grad_()
    wt = torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                      ).requires_grad_()
    scale, zp = torch.tensor(np.float32(2.0 ** -6)), torch.tensor(
        np.float32(zp_u))
    gt = torch.tensor(np.ascontiguousarray(g.transpose(0, 3, 1, 2)))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        y = qat_int.qat_int_conv(xt, wt, scale, zp, **kw)
        (y * gt).sum().backward()
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y_j))
    for got, want in ((xt.grad.permute(0, 2, 3, 1), dx_j),
                      (wt.grad.permute(2, 3, 1, 0), dw_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


# ---- the step's model part makes no host read -----------------------------------

def _narrow(name, form, seed=0):
    cfg = CONFIGS[name]
    kw = (dict(width=16, stage_sizes=(1, 1, 1, 1)) if cfg.model == "resnet50"
          else dict(width_mult=0.25))
    model = init_weights(get_model(cfg.model, num_classes=10, **kw),
                         torch.Generator().manual_seed(seed))
    return convert_model(model, dataclasses.replace(cfg.policy(),
                                                    qat_forward=form))


@pytest.mark.parametrize("form", ["int", "sim"])
@pytest.mark.parametrize("name", ["resnet50_int4w_int8a_qat",
                                  "mobilenetv2_imagenet_int8_qat"])
def test_qat_forward_backward_reads_no_host(name, form, monkeypatch):
    model = _narrow(name, form).train()
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, 2))
    for _ in range(2):      # the observers' first batch, then the EMA
        with monkeypatch.context() as m:
            _no_host_reads(m)
            loss = loop.cross_entropy(model(x), y)
            loss.backward()
    assert torch.isfinite(loss)


# ---- the graph logic ----------------------------------------------------------

def test_step_plan_two_eager_then_capture_then_replays():
    assert [tgraphs.step_plan(i) for i in range(6)] == [
        "eager", "eager", "capture", "replay", "replay", "replay"]
    assert tgraphs.WARMUP_STEPS == 2


def test_graphs_apply_on_a_card_with_one_rank():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert loop.graphs_on(cuda, 1)
    assert not loop.graphs_on(cuda, 2)
    assert not loop.graphs_on(cpu, 1)
    assert not loop.graphs_on(cuda, 1, graphed=False)


def _batches(n, b, hw=16, seed=2):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal((b, hw, hw, 3)).astype(np.float32),
             rs.integers(0, 10, b)) for _ in range(n)]


class _Recorder:
    """Stands in for the card's capture and side stream on the CPU: the
    eager steps and the captured step run the real step; a replay runs it
    again (a graph replays the same kernels)."""

    def __init__(self):
        self.log = []

    def eager(self, step, x, y, dev):
        self.log.append(("eager", tuple(x.shape)))
        return tuple(t.clone() for t in step(x.to(dev), y.to(dev)))

    def capture(self, step, x, y, dev, model):
        self.log.append(("capture", tuple(x.shape)))
        rec = self

        class Graph:
            nbytes = 123

            def replay(self, xx, yy):
                rec.log.append(("replay", tuple(xx.shape)))
                return step(xx, yy)
        return Graph()


def _graphed_on_cpu(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(loop, "graphs_on", lambda dev, dp, graphed=True:
                        dp == 1 and graphed)
    monkeypatch.setattr(loop, "eager_on_side_stream", rec.eager)
    monkeypatch.setattr(loop, "capture_train_step", rec.capture)
    return rec


def test_graphed_run_flow_equals_eager_run(monkeypatch):
    data = _batches(5, 4) + _batches(3, 2, seed=3)
    eager = create_train_state(_narrow("resnet50_int4w_int8a_qat", "int"),
                               1e-3)
    eager.run_eagerly()
    ref = [train_step(eager, x, y) for x, y in data]
    rec = _graphed_on_cpu(monkeypatch)
    state = create_train_state(_narrow("resnet50_int4w_int8a_qat", "int"),
                               1e-3)
    got = [train_step(state, x, y) for x, y in data]
    assert rec.log == [("eager", (4, 16, 16, 3))] * 2 + [
        ("capture", (4, 16, 16, 3))] + [("replay", (4, 16, 16, 3))] * 3 + [
        ("eager", (2, 16, 16, 3))] * 2 + [("capture", (2, 16, 16, 3)),
                                          ("replay", (2, 16, 16, 3))]
    assert state.step == eager.step == 8
    assert len(state.graphs) == 2 and state.graph_bytes() == 246
    assert not eager.graphs and not eager.seen
    for a, b in zip(got, ref):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["acc"], b["acc"])
    for (n, p), q in zip(state.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(p, q), n


def test_run_eagerly_drops_the_graphs(monkeypatch):
    rec = _graphed_on_cpu(monkeypatch)
    state = create_train_state(_narrow("mobilenetv2_imagenet_int8_qat",
                                       "sim"), 1e-3)
    for x, y in _batches(3, 2):
        train_step(state, x, y)
    assert len(state.graphs) == 1 and sum(state.seen.values()) == 3
    state.run_eagerly()
    assert not state.graphed and not state.graphs and not state.seen
    n = len(rec.log)
    for x, y in _batches(3, 2):
        train_step(state, x, y)
    assert len(rec.log) == n and not state.graphs and state.step == 6


class _Mesh:
    def __init__(self, dp):
        self.shape = {"data": dp}

    def group(self, axis):
        return f"group:{axis}"

    def coord(self, axis):
        return 0


@pytest.mark.parametrize("dp", [1, 2])
def test_a_mesh_of_several_ranks_stays_eager(dp, monkeypatch):
    calls = []
    monkeypatch.setattr(loop, "_device", lambda model: torch.device("cuda"))
    monkeypatch.setattr(loop, "_tensors", lambda model, x, y: (
        torch.as_tensor(x), torch.as_tensor(y)))
    monkeypatch.setattr(loop, "_step", lambda state, x, y, group, n: (
        calls.append(("eager", group, n, len(x))) or (torch.zeros(()),) * 2))
    monkeypatch.setattr(loop, "_graphed_step", lambda state, x, y, dev: (
        calls.append(("graphed", len(x))) or (torch.zeros(()),) * 2))
    model = torch.nn.Linear(2, 2)
    state = loop.TrainState(model, torch.optim.SGD(model.parameters(), 0.1))
    x, y = np.zeros((4, 2), np.float32), np.zeros(4, np.int64)
    train_step(state, x, y, mesh=_Mesh(dp))
    assert calls == ([("eager", "group:data", 2, 2)] if dp == 2
                     else [("graphed", 4)])


def test_evaluation_graphs_one_a_batch_shape(monkeypatch):
    captured = []

    def capture(step, x, y, dev, model):
        captured.append(tuple(x.shape))

        class Graph:
            def replay(self, xx, yy):
                return step(xx, yy)
        return Graph()
    model = _narrow("resnet50_int4w_int8a_qat", "int")
    n = 10
    rs = np.random.default_rng(4)
    ds = Dataset(rs.standard_normal((n, 16, 16, 3)).astype(np.float32),
                 rs.integers(0, 10, n), 10)
    train_step(create_train_state(model, 1e-3), ds.images[:4],
               ds.labels[:4])                  # the observers' first batch
    eager = loop.evaluate(model, ds, 4)
    assert not loop.eval_graphs(model)           # the CPU: no graph
    monkeypatch.setattr(loop, "graphs_on", lambda dev, dp, graphed=True:
                        graphed)
    monkeypatch.setattr(loop, "capture_eval_step", capture)
    assert loop.evaluate(model, ds, 4) == eager
    assert loop.evaluate(model, ds, 4) == eager
    assert captured == [(4, 16, 16, 3), (2, 16, 16, 3)]
    assert len(loop.eval_graphs(model)) == 2
    assert loop.evaluate(model, ds, 4, graphed=False) == eager
    assert len(captured) == 2


def test_adamw_capturable_only_on_the_card():
    model = torch.nn.Linear(2, 2)
    assert loop.adamw(model, 1e-3).defaults["capturable"] is False
