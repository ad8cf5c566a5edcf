"""The QAT trainer's integer forward on the card (no JAX: ``python -m
pytest --noconftest -m gpu tests/test_torch_gpu_train.py``).

Every test here is ``gpu``-marked and skips without a CUDA device:

* ``qat_int_conv`` — the integer-forward QAT conv — on K1 (1×1/1), K2
  (3×3 at stride 1 and 2, the 1×1/2 downsample, a Ci = 3 stem) and K3
  (depthwise) against ``qat_int_conv_plain`` (the float64 accumulator) on
  the card: the int32 accumulators, the output and both gradients equal
  (the conv transposes on cuDNN's deterministic algorithms: its default
  wgrad at some shapes sums with atomics, in another order each run);
  the launches counted by kernel, none on the plain path; and the fp32
  simulation on the card (TF32 off) against the integer forward, rel-L2 ≤
  1e-5;
* one QAT step of a narrowed ResNet-50 (config 5's policy, the integer
  forward) and of MobileNet-v2 at width 0.25 (config 3's) on the card
  against the same step on the CPU, layer by layer with each layer's
  input, output gradient and batch statistics from the card
  (teacher-forced; the statistics' values only, so the weights fold to the
  card's bits): outputs rel-L2 ≤ 1e-5, parameter gradients rel-L2 ≤ 1e-3
  (the fp32 weight gradients sum over B·H·W positions in other orders:
  up to 1.2e-4 at full width), running statistics rtol 1e-6, EMA observers
  equal;
* K2 (implicit GEMM, small kernel, the old loop with its pad copy) and K3
  (halo, scalar) with the pad code as a 0-d int32 on the card, read from
  device memory: the raw accumulators equal the host-scalar entry's and
  the plain version's;
* the compiled steps: five training steps with graphs (two eager, a
  capture, replays) against five with graphs off, from the same weights
  and batches, for the narrowed configs 5 and 3 on the integer forward
  and config 5 on the simulation and in fp32 — loss, acc, every parameter,
  AdamW's state, BatchNorm's statistics and the observers bit-equal after
  every step, one graph kept, the launch counters moved alike; evaluation
  graphed against eager (a remainder batch included); a step that syncs
  with the host refused at its capture.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn import layers as qlayers
from qtpu_torch.nn.layers import layer_paths
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops import qat_int, qops
from qtpu_torch.ops import qconv as tconv
from qtpu_torch.ops import qdepthwise as tdw
from qtpu_torch.ops import qmatmul as tmm
from qtpu_torch.data import Dataset
from qtpu_torch.train import create_train_state, evaluate, train_step
from qtpu_torch.train.loop import eval_graphs
from qtpu_torch.transform import convert_model
from qtpu_torch.utils.device import fp32_exact
from qtpu_torch.utils.graphs import (GraphCaptureError, launch_counters,
                                     read_counters)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return (tmm.qmatmul_folded.launches, tconv.qconv2d_folded.launches,
            tdw.qdepthwise_folded.launches,
            tmm.qmatmul_folded_plain.calls + tconv.qconv2d_folded_plain.calls
            + tdw.qdepthwise_folded_plain.calls)


# (Ci, Co, kernel, stride, groups, H, weight bits, the kernel it runs)
CASES = [(64, 64, 1, 1, 1, 14, 4, 0), (64, 64, 3, 1, 1, 14, 4, 1),
         (64, 128, 3, 2, 1, 14, 8, 1), (64, 128, 1, 2, 1, 14, 4, 1),
         (3, 32, 3, 2, 1, 32, 8, 1), (96, 96, 3, 1, 96, 14, 8, 2),
         (96, 96, 3, 2, 96, 14, 8, 2), (24, 144, 1, 1, 1, 14, 8, 0),
         (144, 24, 1, 1, 1, 56, 8, 0), (24, 144, 1, 1, 1, 56, 8, 0),
         (3, 32, 3, 2, 1, 224, 8, 1), (16, 16, 3, 1, 1, 32, 8, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,k,s,groups,h,w_bits,kernel", CASES)
def test_qat_int_conv_kernels_equal_plain(cuda, ci, co, k, s, groups, h,
                                          w_bits, kernel):
    g = torch.Generator().manual_seed(ci * co + k)
    x = (torch.randn((4, ci, h, h), generator=g) * 2).to(cuda)
    w = (torch.randn((co, ci // groups, k, k), generator=g) * 0.1).to(cuda)
    scale, zp = fq.affine_qparams(x.min(), x.max(), 8)
    kw = dict(w_bits=w_bits, strides=(s, s), groups=groups)
    outs = {}
    for name, fn in (("kernel", qat_int.qat_int_conv),
                     ("plain", qat_int.qat_int_conv_plain)):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = _launches()
        y = fn(xr, wr, scale, zp, **kw)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            y.backward(torch.full_like(y, 0.01))
        torch.cuda.synchronize()
        after = _launches()
        outs[name] = (y.detach(), xr.grad, wr.grad,
                      tuple(a - b for a, b in zip(after, before)))
    want = [0, 0, 0, 0]
    want[kernel] = 1
    assert outs["kernel"][3] == tuple(want)
    for a, b in zip(outs["kernel"][:3], outs["plain"][:3]):
        assert torch.equal(a, b)
    with fp32_exact():
        xq = fq.fake_quant(x, scale, zp, signed=False, symmetric=False)
        wq = fq.fake_quant_weight(w, bits=w_bits, channel_axis=0)
        (hlo, hhi), (wlo, whi) = qops.resolve_pads((h, h), (k, k), (s, s),
                                                   "SAME")
        y_sim = F.conv2d(F.pad(xq, (wlo, whi, hlo, hhi)), wq, stride=s,
                         groups=groups)
    y = outs["kernel"][0]
    assert ((y_sim - y).norm() / y.norm()).item() <= 1e-5


# config 3's QAT convs at the trainer's B = 16 (24-byte rows and N = 24 on
# K1's narrow-row kernel, the Ci = 3 stem on K2's small kernel), under
# autograd: the raw accumulators take the new paths and no old loop
QAT_NEW_PATHS = [(24, 144, 1, 1, 56, "wgmma_cp"), (144, 24, 1, 1, 56,
                                                   "wgmma_cp"),
                 (3, 32, 3, 2, 224, "small")]


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,k,s,h,path", QAT_NEW_PATHS)
def test_qat_int_conv_takes_the_new_paths(cuda, ci, co, k, s, h, path):
    g = torch.Generator().manual_seed(ci + co)
    x = (torch.randn((16, ci, h, h), generator=g) * 2).to(cuda)
    w = (torch.randn((co, ci, k, k), generator=g) * 0.1).to(cuda)
    scale, zp = fq.affine_qparams(x.min(), x.max(), 8)
    f1, f2 = tmm.qmatmul_folded, tconv.qconv2d_folded

    def counts():
        return (f1.launches_wgmma_cp, f1.launches_igemm, f2.launches_small,
                f2.launches_igemm, qops.resolve_and_pad.calls)

    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    c0 = counts()
    y = qat_int.qat_int_conv(xr, wr, scale, zp, w_bits=8, strides=(s, s))
    torch.cuda.synchronize()
    d = tuple(b - a for a, b in zip(c0, counts()))
    assert d == ((1, 0, 0, 0, 0) if path == "wgmma_cp" else (0, 0, 1, 0, 0))
    y_ref = qat_int.qat_int_conv_plain(x, w, scale, zp, w_bits=8,
                                       strides=(s, s))
    assert torch.equal(y.detach(), y_ref)


def _teacher_forced(model, policy, cuda, hw, monkeypatch):
    """Each layer's CPU copy on the input, output gradient and batch
    statistics (their values) the card's layer saw."""
    gpu = convert_model(model.to(cuda), policy)
    pre = copy.deepcopy(gpu).to("cpu")
    seen, current, card_stats = {}, [None], {}
    batch_stats = qlayers._batch_stats

    def record(y):
        m, v = batch_stats(y)
        card_stats[current[0]] = (m.detach().cpu(), v.detach().cpu())
        return m, v

    def replay(y):
        m, v = batch_stats(y)
        cm, cv = card_stats[current[0]]
        return m + (cm - m).detach(), v + (cv - v).detach()

    def hook(path):
        def fwd(_mod, args, out):
            rec = seen[path] = {"x": args[0].detach().clone(),
                                "y": out.detach().clone()}
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return fwd

    def enter(path):
        def pre_hook(_mod, _args):
            current[0] = path
        return pre_hook
    layers = layer_paths(gpu)
    for p, m in layers.items():
        m.register_forward_hook(hook(p))
        m.register_forward_pre_hook(enter(p))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    monkeypatch.setattr(qlayers, "_batch_stats", record)
    m = train_step(create_train_state(gpu, 1e-4), x, rng.integers(0, 10, 2))
    assert torch.isfinite(m["loss"])
    monkeypatch.setattr(qlayers, "_batch_stats", replay)
    for path, m_pre in layer_paths(pre).items():
        rec = seen[path]
        layer = copy.deepcopy(m_pre).train()
        current[0] = path
        with fp32_exact():
            out = layer(rec["x"].cpu())
            out.backward(rec["g"].cpu())
        ref = rec["y"].cpu()
        assert ((out.detach() - ref).norm() / ref.norm()).item() <= 1e-5
        gp = dict(layers[path].named_parameters())
        for name, p in layer.named_parameters():
            g_ref = gp[name].grad.cpu()
            assert ((p.grad - g_ref).norm() / g_ref.norm().clamp_min(1e-30)
                    ).item() <= 1e-3, (path, name)
        gb = dict(layers[path].named_buffers())
        for name, b in layer.named_buffers():
            b_ref = gb[name].cpu()
            if name.startswith("in_q."):
                assert torch.equal(b, b_ref), (path, name)
            elif b.is_floating_point():
                torch.testing.assert_close(b, b_ref, rtol=1e-6, atol=1e-6 *
                                           float(b_ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet50_int4w_int8a_qat",
                                  "mobilenetv2_imagenet_int8_qat"])
def test_qat_step_card_vs_cpu_teacher_forced(cuda, name, monkeypatch):
    cfg = CONFIGS[name]
    kw = (dict(width=16, stage_sizes=(1, 1, 1, 1)) if cfg.model == "resnet50"
          else dict(width_mult=0.25))
    model = init_weights(get_model(cfg.model, num_classes=10, **kw),
                         torch.Generator().manual_seed(0))
    policy = dataclasses.replace(cfg.policy(), qat_forward="int")
    _teacher_forced(model, policy, cuda, 64, monkeypatch)


# K2 and K3 with the pad code on the device: (kernel, Ci, Co, k, stride, H,
# K2 path forced or None)
DEVICE_PAD_CASES = [("K2", 64, 64, 3, 1, 14, None), ("K2", 128, 128, 3, 2,
                                                      14, None),
                    ("K2", 256, 128, 1, 2, 14, None),
                    ("K2", 3, 32, 3, 2, 32, None),
                    ("K2", 16, 16, 3, 1, 16, None),
                    ("K2", 64, 64, 3, 1, 14, "igemm"),
                    ("K2", 24, 40, 3, 2, 15, "igemm"),
                    ("K3", 144, 144, 3, 1, 14, None),
                    ("K3", 96, 96, 3, 2, 15, None), ("K3", 24, 24, 5, 1, 9,
                                                     None)]


@pytest.mark.gpu
@pytest.mark.parametrize("zp", [-41, 0, 23])
@pytest.mark.parametrize("kern,ci,co,k,s,h,path", DEVICE_PAD_CASES)
def test_device_pad_code_equals_the_scalar_entry(cuda, kern, ci, co, k, s,
                                                 h, path, zp):
    g = torch.Generator().manual_seed(ci + co + k + s)
    x = torch.randint(-128, 128, (4, h, h, ci), generator=g,
                      dtype=torch.int8).to(cuda)
    zd = torch.tensor(zp, dtype=torch.int32, device=cuda)
    if kern == "K2":
        w = torch.randint(-127, 128, (co, k * k * ci), generator=g,
                          dtype=torch.int8).to(cuda)
        pads = qops.resolve_pads((h, h), (k, k), (s, s), "SAME")
        kw = dict(kernel_hw=(k, k), stride=s, pads=pads, raw_acc=True)
        host = tconv.qconv2d_folded(x, w, None, None, zp=zp, path=path, **kw)
        dev = tconv.qconv2d_folded(x, w, None, None, zp=zd, path=path, **kw)
        plain = tconv.qconv2d_folded_plain(x, w, None, None, zp=zp, **kw)
    else:
        w = torch.randint(-127, 128, (k * k, co), generator=g,
                          dtype=torch.int8).to(cuda)
        kw = dict(kernel_hw=(k, k), stride=s, padding="SAME", raw_acc=True)
        host = tdw.qdepthwise_folded(x, w, None, None, zp=zp, **kw)
        dev = tdw.qdepthwise_folded(x, w, None, None, zp=zd, **kw)
        plain = tdw.qdepthwise_folded_plain(x, w, None, None, zp=zp, **kw)
    assert torch.equal(dev, host) and torch.equal(dev, plain)


def _narrow(name, form, cuda, seed=0):
    cfg = CONFIGS[name]
    kw = (dict(width=16, stage_sizes=(1, 1, 1, 1)) if cfg.model == "resnet50"
          else dict(width_mult=0.25))
    model = init_weights(get_model(cfg.model, num_classes=10, **kw),
                         torch.Generator().manual_seed(seed)).to(cuda)
    if form == "fp32":
        return model
    return convert_model(model, dataclasses.replace(cfg.policy(),
                                                    qat_forward=form))


def _state_equal(a, b):
    """Parameters, buffers and AdamW's state of two train states."""
    for (n, t), u in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(t, u), n
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name,form", [
    ("resnet50_int4w_int8a_qat", "int"),
    ("mobilenetv2_imagenet_int8_qat", "int"),
    ("resnet50_int4w_int8a_qat", "sim"), ("resnet50_int4w_int8a_qat",
                                          "fp32")])
def test_graphed_steps_equal_eager_steps(cuda, name, form):
    rs = np.random.default_rng(5)
    data = [(rs.standard_normal((4, 32, 32, 3)).astype(np.float32),
             rs.integers(0, 10, 4)) for _ in range(5)]
    graphed = create_train_state(_narrow(name, form, cuda), 1e-3)
    eager = create_train_state(_narrow(name, form, cuda), 1e-3)
    eager.run_eagerly()
    assert graphed.optimizer.defaults["capturable"]
    counters = launch_counters()
    moved = {}
    # cuDNN's deterministic algorithms: its default weight gradients sum
    # with atomics at some shapes, in another order each run
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        _five_steps(data, graphed, eager, counters, moved)
    assert not eager.graphs and graphed.graph_bytes() > 0


def _five_steps(data, graphed, eager, counters, moved):
    for i, (x, y) in enumerate(data):
        out = {}
        for key, st in (("graphed", graphed), ("eager", eager)):
            c0 = read_counters(counters)
            out[key] = train_step(st, x, y)
            torch.cuda.synchronize()
            moved[key] = {k: v - c0[k] for k, v in
                          read_counters(counters).items() if v != c0[k]}
        for k in ("loss", "acc"):
            assert torch.equal(out["graphed"][k], out["eager"][k]), (i, k)
        _state_equal(graphed, eager)
        assert moved["graphed"] == moved["eager"], i
        assert len(graphed.graphs) == (1 if i >= 2 else 0), i


@pytest.mark.gpu
def test_evaluate_graphed_equals_eager(cuda):
    model = _narrow("mobilenetv2_imagenet_int8_qat", "int", cuda)
    rs = np.random.default_rng(6)
    ds = Dataset(rs.standard_normal((10, 32, 32, 3)).astype(np.float32),
                 rs.integers(0, 10, 10), 10)
    train_step(create_train_state(model, 1e-3), ds.images[:4],
               ds.labels[:4])                   # the observers' first batch
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        eager = evaluate(model, ds, 4, graphed=False)
        assert evaluate(model, ds, 4) == eager == evaluate(model, ds, 4)
    assert len(eval_graphs(model)) == 2         # B = 4 and the remainder 2
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


class _Syncs(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 10)

    def forward(self, x):
        y = self.fc(x.mean((1, 2)))
        return y * float(y.abs().max())         # a host read


@pytest.mark.gpu
def test_a_step_that_syncs_is_refused_at_its_capture(cuda):
    state = create_train_state(_Syncs().to(cuda), 1e-3)
    x = np.zeros((2, 4, 4, 3), np.float32)
    y = np.zeros(2, np.int64)
    train_step(state, x, y)
    train_step(state, x, y)                      # two eager steps run
    with pytest.raises(GraphCaptureError, match="training step"):
        train_step(state, x, y)
