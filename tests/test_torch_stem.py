"""The fp32 stem from the input pixels to int8 codes and ResNet's max-pool
on codes (``qtpu_torch/ops/qstem.py``) on the CPU, no JAX.

* ``stem_fp32_codes`` on a CPU tensor takes its plain version, which is
  bit-equal to the sequence the flat engines ran before the stem kernel
  (normalize, zero pads, ``F.conv2d`` in full fp32 on bf16-rounded operands
  for the bf16 stem, ``+ b``, ReLU or ReLU6, ``quantize_act``), at every
  fp32-stem geometry an engine builds: ResNet's ImageNet 7×7/2 (SAME and
  torchvision's pads), its CIFAR 3×3/1 (Co = 16, an odd Co = 9 and a
  symmetric grid), MobileNet's 3×3/2 with ReLU and ReLU6 (SAME and torch
  pads), on uint8 pixels and f32 images;
* ``maxpool_codes`` on the CPU is the −128-padded max of the nine strided
  window slices, bit for bit;
* the ResNet (ImageNet and CIFAR stems), MobileNet-v2 and MobileNet-v1
  engines run their fp32 stems through the wrapper: the codes of ``_stem``
  equal that sequence on the engine's folded weights, one plain call a
  forward (and one plain max-pool for the ImageNet ResNet);
* ``stem_geometry`` — what the kernel runs on a card — takes every
  geometry above with its tile plan, and raises, naming the input's shape,
  for one no engine builds;
* ``prepare_stem``'s layouts and the two kernels' launch counters in
  ``utils.graphs.launch_counters``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qtpu_torch.ops import qops, qstem
from qtpu_torch.utils.device import fp32_exact

RNG = np.random.default_rng(24)
NORM = (torch.tensor([0.0171, 0.0175, 0.0174]),
        torch.tensor([-2.118, -2.036, -1.804]))
TV7 = ((3, 3), (3, 3))
TV3 = ((1, 1), (1, 1))
# (name, window, stride, Co, padding, act_max, grid, max-pool pads or
#  None); "same" pools with SAME pads
GEOMETRIES = {
    "resnet_7x7_same": (7, 2, 64, "SAME", None, (0.021, -128, False),
                        "same"),
    "resnet_7x7_torch": (7, 2, 64, TV7, None, (0.021, -128, False), TV3),
    "cifar_3x3_co16": (3, 1, 16, "SAME", None, (0.017, -120, False), None),
    "cifar_3x3_co9_sym": (3, 1, 9, "SAME", None, (0.013, 0, True), None),
    "mobilenet_relu_same": (3, 2, 32, "SAME", None, (0.019, -128, False),
                            None),
    "mobilenet_relu6_same": (3, 2, 32, "SAME", 6.0, (6.0 / 255, -128, False),
                             None),
    "mobilenet_relu6_torch": (3, 2, 32, TV3, 6.0, (6.0 / 255, -128, False),
                              None),
    "mobilenet_relu_torch": (3, 2, 8, TV3, None, (0.019, -128, False), None),
}


def engines_sequence(x, w_oihw, b, strides, padding, act_max, grid, norm,
                     bf16):
    """The excluded stem as the flat engines ran it before the kernel
    (``_normalize_u8``, ``_stem_conv_fp32``, the activation and
    ``quantize_act``)."""
    if norm is not None:
        x = x.to(torch.float32) * norm[0] + norm[1]
    pads = qops.resolve_pads(x.shape[1:3], w_oihw.shape[2:], strides,
                             padding)
    xp = qops.pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2)
    w = w_oihw
    if bf16:
        xp = xp.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    with fp32_exact():
        y = F.conv2d(xp, w, stride=strides)
    y = y.permute(0, 2, 3, 1) + b
    y = torch.clamp_min(y, 0.0) if act_max is None else torch.clamp(
        y, 0.0, act_max)
    scale, zp, sym = grid
    return qops.quantize_act(y, scale, zp, symmetric=sym)


def nine_slices(y_q, pads):
    """ResNet's max-pool on codes as the engine ran it: −128 pads, the max
    of the nine strided window slices."""
    yp = qops.pad_nhwc(y_q, pads, -128)
    Hp, Wp = yp.shape[1:3]
    OH, OW = (Hp - 3) // 2 + 1, (Wp - 3) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            s = yp[:, dy:dy + 2 * (OH - 1) + 1:2, dx:dx + 2 * (OW - 1) + 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


def _weights(K, Co, ci=3):
    w = torch.from_numpy((RNG.standard_normal((K, K, ci, Co))
                          * (2.0 / (K * K * ci)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((RNG.standard_normal(Co) * 0.1).astype(np.float32))
    return w, b


def _input(u8, shape=(2, 19, 21, 3)):
    if u8:
        return torch.from_numpy(RNG.integers(0, 256, shape, dtype=np.uint8))
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_path_is_the_engines_sequence(name, u8, bf16):
    K, s, Co, padding, act_max, grid, pool = GEOMETRIES[name]
    w, b = _weights(K, Co)
    sw = qstem.prepare_stem(w, b, bf16=bf16)
    x = _input(u8)
    norm = NORM if u8 else None
    calls = qstem.stem_fp32_codes_plain.calls
    got = qstem.stem_fp32_codes(x, sw, strides=(s, s), padding=padding,
                                act_max=act_max, grid=grid, norm=norm)
    want = engines_sequence(x, w.permute(3, 2, 0, 1).contiguous(), b,
                            (s, s), padding, act_max, grid, norm, bf16)
    assert qstem.stem_fp32_codes_plain.calls == calls + 1
    assert got.dtype == torch.int8 and torch.equal(got, want)
    # the codes use the grid: not all clamped to one end
    assert int(got.min()) < int(got.max())
    if pool is not None:
        pads = (qops.same_pads(got.shape[1:3], (3, 3), (2, 2))
                if pool == "same" else pool)
        assert torch.equal(qstem.maxpool_codes(got, pads),
                           nine_slices(got, pads))


@pytest.mark.parametrize("C", [64, 16, 12, 9])
@pytest.mark.parametrize("pads", [((0, 1), (0, 1)), ((1, 1), (1, 1)),
                                  ((1, 0), (0, 1))])
def test_maxpool_plain_is_the_nine_slices(C, pads):
    y = torch.from_numpy(RNG.integers(-128, 128, (3, 13, 12, C),
                                      dtype=np.int8))
    calls = qstem.maxpool_codes_plain.calls
    got = qstem.maxpool_codes(y, pads)
    assert qstem.maxpool_codes_plain.calls == calls + 1
    assert torch.equal(got, nine_slices(y, pads))


def _frozen(name, exclude=("stem*",), **kw):
    from qtpu_torch.models import get_model
    from qtpu_torch.models.resnet import init_weights
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.transform import calibrate, freeze

    m = get_model(name, num_classes=10, **kw)
    init_weights(m, torch.Generator().manual_seed(3))
    x = RNG.standard_normal((4, 32, 32, 3)).astype(np.float32)
    policy = QuantPolicy.int8_ptq(exclude=exclude)
    return freeze(m, policy, calibrate(m, policy, [x]))


def _engine(kind, torch_pad=False, stem_dtype=None):
    from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
    from qtpu_torch.serve.mobilenet_v1_engine import MobileNetV1Int8Engine
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    if kind in ("resnet_imagenet", "resnet_cifar"):
        cifar = kind == "resnet_cifar"
        tree = _frozen("resnet50", width=16, stage_sizes=(1, 1, 1, 1),
                       cifar_stem=cifar, torch_pad=torch_pad)
        arch = dict(stage_sizes=(1, 1, 1, 1), width=16, bottleneck=True,
                    cifar_stem=cifar, num_classes=10, torch_pad=torch_pad)
        return ResNetInt8Engine(tree, arch, device="cpu",
                                stem_dtype=stem_dtype)
    tree = _frozen(kind, width_mult=0.25, torch_pad=torch_pad)
    cls = (MobileNetV2Int8Engine if kind == "mobilenet_v2"
           else MobileNetV1Int8Engine)
    return cls(tree, num_classes=10, torch_pad=torch_pad, device="cpu",
               stem_dtype=stem_dtype)


def _first_grid(eng, kind):
    from qtpu_torch.serve.fused_ops import grid_of

    if kind == "mobilenet_v2":
        return eng._block_in_grid(eng._blocks()[0][0])
    if kind == "mobilenet_v1":
        return grid_of(eng._node("block0", "dw"))
    return grid_of(eng._node(eng._names[0][0], "conv1"))


# (engine kind, torch_pad, stem_dtype)
ENGINE_CASES = [("resnet_imagenet", False, None),
                ("resnet_imagenet", True, torch.bfloat16),
                ("resnet_cifar", False, None),
                ("mobilenet_v2", False, None),
                ("mobilenet_v2", True, None),
                ("mobilenet_v1", True, torch.bfloat16)]


@pytest.mark.parametrize("kind,torch_pad,stem_dtype", ENGINE_CASES)
def test_engine_stems_run_the_wrapper(kind, torch_pad, stem_dtype):
    eng = _engine(kind, torch_pad, stem_dtype)
    sw = eng._stem_fp32
    assert sw.bf16 == (stem_dtype == torch.bfloat16)
    grid = _first_grid(eng, kind)
    imagenet = kind != "resnet_cifar"
    s = 2 if imagenet else 1
    K = 7 if kind == "resnet_imagenet" else 3
    padding = ("SAME" if not torch_pad or not imagenet
               else (TV7 if K == 7 else TV3))
    act_max = 6.0 if kind == "mobilenet_v2" else None
    for u8 in (True, False):
        x = _input(u8, (2, 32, 32, 3))
        calls = (qstem.stem_fp32_codes_plain.calls,
                 qstem.maxpool_codes_plain.calls)
        got = eng._stem(x, grid, raw_u8=u8)
        want = engines_sequence(x, sw.w_oihw, sw.bias, (s, s), padding,
                                act_max, tuple(grid),
                                eng._u8_norm if u8 else None, sw.bf16)
        pooled = kind == "resnet_imagenet"
        if pooled:
            pads = (TV3 if torch_pad
                    else qops.same_pads(want.shape[1:3], (3, 3), (2, 2)))
            want = nine_slices(want, pads)
        assert torch.equal(got, want)
        assert (qstem.stem_fp32_codes_plain.calls - calls[0],
                qstem.maxpool_codes_plain.calls - calls[1]) == (1,
                                                                int(pooled))
    logits = eng.forward_u8(_input(True, (2, 32, 32, 3)))
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())


def _sw(K, Co, ci=3):
    return qstem.prepare_stem(*_weights(K, Co, ci))


# (input shape, window, Co, stride, padding, (OH, OW, the plan), the
#  (top, left) pads)
PRODUCTION = [
    ((128, 224, 224, 3), 7, 64, 2, "SAME", (112, 112, (16, 2, 256)), (2, 2)),
    ((8, 224, 224, 3), 7, 64, 2, TV7, (112, 112, (16, 2, 256)), (3, 3)),
    ((128, 224, 224, 3), 3, 32, 2, "SAME", (112, 112, (16, 2, 128)), (0, 0)),
    ((1, 224, 224, 3), 3, 32, 2, TV3, (112, 112, (16, 2, 128)), (1, 1)),
    ((8, 32, 32, 3), 3, 16, 1, "SAME", (32, 32, (16, 2, 64)), (1, 1)),
    ((3, 32, 32, 3), 3, 9, 1, "SAME", (32, 32, (16, 2, 64)), (1, 1)),
    ((8, 32, 32, 3), 3, 64, 1, "SAME", (32, 32, (16, 2, 256)), (1, 1)),
    ((2, 64, 64, 3), 7, 64, 2, "SAME", (32, 32, (16, 2, 256)), (2, 2)),
]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,K,Co,s,padding,out,pads", PRODUCTION)
def test_stem_geometry_takes_every_engine_stem(shape, K, Co, s, padding, out,
                                               pads, dtype):
    geo = qstem.stem_geometry(shape, dtype, _sw(K, Co), (s, s), padding)
    assert (geo.OH, geo.OW, tuple(geo.plan)) == out
    assert (geo.pad_t, geo.pad_l) == pads
    assert geo.plan.threads <= qstem.MAX_THREADS


@pytest.mark.parametrize("OH,cop,plan", [
    (112, 64, (16, 2, 256)),   # ResNet-50's stem: 16 x 16 tiles
    (112, 32, (16, 2, 128)),   # MobileNet's
    (56, 64, (14, 2, 224)),    # rows spread over the fewest row tiles
    (32, 128, (8, 2, 256)),    # 256 threads hold 8 rows of 128 channels
    (7, 16, (7, 2, 28)),
])
def test_stem_plan_fills_the_block_up_to_sixteen_rows(OH, cop, plan):
    assert tuple(qstem.stem_plan(OH, cop)) == plan


BAD = {
    "5x5 window": ((2, 32, 32, 3), 5, 16, (1, 1), "SAME", torch.float32),
    "7x7 at stride 1": ((2, 32, 32, 3), 7, 16, (1, 1), "SAME",
                        torch.float32),
    "unequal strides": ((2, 32, 32, 3), 3, 16, (2, 1), "SAME", torch.uint8),
    "five input channels": ((2, 32, 32, 5), 3, 16, (2, 2), "SAME",
                            torch.uint8),
    "int8 input": ((2, 32, 32, 3), 3, 16, (2, 2), "SAME", torch.int8),
    "not NHWC": ((32, 32, 3), 3, 16, (2, 2), "SAME", torch.uint8),
    "more channels than a block's threads": ((2, 32, 32, 3), 3, 1032, (2, 2),
                                             "SAME", torch.uint8),
    "weights past shared memory": ((2, 32, 32, 3), 7, 512, (2, 2), "SAME",
                                   torch.uint8),
    "smaller than the window": ((2, 5, 5, 3), 7, 16, (2, 2),
                                ((0, 0), (0, 0)), torch.uint8),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_stem_geometry_raises_naming_the_shape(case):
    shape, K, Co, strides, padding, dtype = BAD[case]
    sw = _sw(K, Co, ci=3 if case != "five input channels" else 5)
    with pytest.raises(ValueError, match=str(tuple(shape)).replace(
            "(", r"\(").replace(")", r"\)")):
        qstem.stem_geometry(shape, dtype, sw, strides, padding)


def test_prepare_stem_layouts():
    w, b = _weights(3, 9)
    sw = qstem.prepare_stem(w, b)
    assert sw.w_taps.shape == (27, 16) and sw.bias_pad.shape == (16,)
    assert torch.equal(sw.w_taps[:, :9], w.reshape(27, 9))
    assert not sw.w_taps[:, 9:].any() and not sw.bias_pad[9:].any()
    assert torch.equal(sw.bias_pad[:9], b) and torch.equal(sw.bias, b)
    assert torch.equal(sw.w_oihw, w.permute(3, 2, 0, 1))
    sb = qstem.prepare_stem(w, b, bf16=True)
    assert torch.equal(sb.w_taps[:, :9], w.reshape(27, 9).to(
        torch.bfloat16).to(torch.float32))
    # the plain path rounds its own weight: it keeps the fp32 one
    assert torch.equal(sb.w_oihw, sw.w_oihw) and sb.bf16


def test_launch_counters_hold_the_stem_kernels():
    from qtpu_torch.utils.graphs import launch_counters

    c = launch_counters()
    for key in ("stem_fp32_codes.launches", "maxpool_codes.launches",
                "stem_fp32_codes_plain.calls", "maxpool_codes_plain.calls"):
        assert key in c, key
    fn, attr = c["stem_fp32_codes.launches"]
    assert fn is qstem.stem_fp32_codes and attr == "launches"
