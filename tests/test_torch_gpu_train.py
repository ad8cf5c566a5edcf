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
  equal.
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
from qtpu_torch.train import create_train_state, train_step
from qtpu_torch.transform import convert_model
from qtpu_torch.utils.device import fp32_exact


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
