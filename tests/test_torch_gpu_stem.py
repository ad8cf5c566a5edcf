"""The fp32 stem kernel and the max-pool on codes (``ops/qstem.py``,
``csrc/qstem.cu``) on the card (no JAX: ``python -m pytest --noconftest -m
gpu tests/test_torch_gpu_stem.py``).

Every test here is ``gpu``-marked and skips without a CUDA device:

* the stem kernel bit-equal to its plain version on the card — cuDNN's
  fp32 conv and PyTorch's normalize, bias, activation and quantize: the
  kernel sums the taps in the order of cuDNN's fp32 NHWC conv, and a code
  one step off would move the logits of a deep int8 network by percents —
  at ResNet's 7×7/2 (SAME and torchvision's
  pads), the CIFAR 3×3/1 (Co = 16, and an odd Co = 9 on a symmetric
  grid), MobileNet's 3×3/2 with ReLU and ReLU6 (SAME and torch pads), on
  uint8 pixels and f32 images, fp32 and bf16 ``stem_dtype``, at B = 1, 3
  and 8, and the two production stems at B = 128;
* the max-pool kernel bit-equal to its plain version, on its 16-, 4- and
  1-byte paths, SAME and torch pads, B = 1, 3, 8 and 128;
* the flat engines' graphed entries (``forward_u8``, ``forward``) bit-equal
  to their eager bodies on narrow ResNets (ImageNet and CIFAR stems) and
  MobileNets, and one eager forward launching one stem kernel and, for the
  ImageNet ResNet, one max-pool kernel, nothing on a plain path;
* a traced eager ``forward_u8`` of the two production engines
  (``resnet50_imagenet_int8_ptq_fp32stem``,
  ``mobilenetv2_imagenet_int8_ptq_fp32stem``): under the ``stem`` scope
  only the stem kernel (and ResNet's max-pool kernel), no cuDNN
  ``convolve`` and no PyTorch elementwise kernel, and the launch counters
  at 1 + 1 (ResNet) and 1 (MobileNet) a forward.

The equality rests on cuDNN: the plain path's fp32 NHWC conv runs
``convolve_common_engine_float_NHWC``, which sums each output over the taps
in (kh, kw, ci) order, one FMA a tap from 0.0, on an H100 with cuDNN
9.22.0 (``torch.backends.cudnn.version()`` 92200; PyTorch 2.11.0+cu128,
CUDA 12.8); the stem kernel keeps that order.  Another cuDNN build, a
changed heuristic or ``cudnn.benchmark=True`` may pick another algorithm or
order, and then the stem tests here fail at ties: look at the library first.
"""
import numpy as np
import pytest
import torch

from qtpu_torch.ops import qops, qstem

RNG = np.random.default_rng(124)
NORM_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
TV7 = ((3, 3), (3, 3))
TV3 = ((1, 1), (1, 1))
# name: (H, window, stride, Co, padding, act_max, grid)
GEOMETRIES = {
    "resnet_7x7_same": (224, 7, 2, 64, "SAME", None, (0.04, -128, False)),
    "resnet_7x7_torch": (224, 7, 2, 64, TV7, None, (0.04, -128, False)),
    "cifar_3x3_co16": (32, 3, 1, 16, "SAME", None, (0.03, -120, False)),
    "cifar_3x3_co9_sym": (32, 3, 1, 9, "SAME", None, (0.03, 0, True)),
    "mobilenet_relu_same": (224, 3, 2, 32, "SAME", None,
                            (0.03, -128, False)),
    "mobilenet_relu6_same": (224, 3, 2, 32, "SAME", 6.0,
                             (6.0 / 255, -128, False)),
    "mobilenet_relu6_torch": (224, 3, 2, 32, TV3, 6.0,
                              (6.0 / 255, -128, False)),
    "mobilenet_relu_torch": (224, 3, 2, 32, TV3, None, (0.03, -128, False)),
}
PRODUCTION = ("resnet_7x7_same", "mobilenet_relu6_same")
RN50 = "resnet50_imagenet_int8_ptq_fp32stem"
MNV2 = "mobilenetv2_imagenet_int8_ptq_fp32stem"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _norm(dev):
    from qtpu_torch.serve.fused_ops import u8_normalize_coeffs
    return u8_normalize_coeffs(*NORM_STATS, 3, device=dev)


def assert_codes_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.int8
    d = (a.int() - b.int()).abs()
    assert torch.equal(a, b), (d.max().item(), (d > 0).float().mean().item())


def _stem_case(name, batch, u8, bf16, dev):
    H, K, s, Co, padding, act_max, grid = GEOMETRIES[name]
    w = torch.from_numpy((RNG.standard_normal((K, K, 3, Co))
                          * (2.0 / (K * K * 3)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((RNG.standard_normal(Co) * 0.1).astype(np.float32))
    sw = qstem.prepare_stem(w.to(dev), b.to(dev), bf16=bf16)
    x8 = torch.from_numpy(RNG.integers(0, 256, (batch, H, H, 3),
                                       dtype=np.uint8)).to(dev)
    norm = _norm(dev)
    x = x8 if u8 else (x8.float() * norm[0] + norm[1]).contiguous()
    kw = dict(strides=(s, s), padding=padding, act_max=act_max, grid=grid,
              norm=norm if u8 else None)
    return x, sw, kw


CASES = [(n, b) for n in sorted(GEOMETRIES) for b in (1, 3, 8)] + [
    (n, 128) for n in PRODUCTION]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("name,batch", CASES)
def test_stem_kernel_equals_cudnn_and_its_glue(cuda, name, batch, u8, bf16):
    x, sw, kw = _stem_case(name, batch, u8, bf16, cuda)
    n = (qstem.stem_fp32_codes.launches, qstem.stem_fp32_codes_plain.calls)
    got = qstem.stem_fp32_codes(x, sw, **kw)
    assert (qstem.stem_fp32_codes.launches - n[0],
            qstem.stem_fp32_codes_plain.calls - n[1]) == (1, 0)
    want = qstem.stem_fp32_codes_plain(x, sw, **kw)
    torch.cuda.synchronize()
    assert_codes_equal(got, want)
    assert int(got.min()) < int(got.max())   # the grid is used


# (C, batch): the 16-, 4- and 1-byte paths at B = 1, 3 and 8, and B = 128
# at ResNet-50's 64 channels
POOL_CASES = [(C, b) for C in (64, 16, 12, 9) for b in (1, 3, 8)] + [
    (64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("pads", [((2, 3), (2, 3)), TV3],
                         ids=["same", "torch"])
@pytest.mark.parametrize("C,batch", POOL_CASES)
def test_maxpool_kernel_bit_equal(cuda, C, pads, batch):
    H = 112 if C == 64 else 17
    y = torch.from_numpy(RNG.integers(-128, 128, (batch, H, H, C),
                                      dtype=np.int8)).to(cuda)
    if pads[0] == (2, 3):
        pads = qops.same_pads((H, H), (3, 3), (2, 2))
    n = qstem.maxpool_codes.launches
    got = qstem.maxpool_codes(y, pads)
    assert qstem.maxpool_codes.launches == n + 1
    assert torch.equal(got, qstem.maxpool_codes_plain(y, pads))


def _narrow(kind, dev):
    """A narrow fp32-stem engine of ``kind`` on the card, its inputs 64²
    (ImageNet stems) or 32² (CIFAR)."""
    from qtpu_torch.models import get_model
    from qtpu_torch.models.resnet import init_weights
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
    from qtpu_torch.serve.mobilenet_v1_engine import MobileNetV1Int8Engine
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.transform import calibrate, freeze

    H = 32 if kind == "resnet_cifar" else 64
    if kind.startswith("resnet"):
        kw = dict(width=16, stage_sizes=(1, 1, 1, 1),
                  cifar_stem=kind == "resnet_cifar")
        name = "resnet50"
    else:
        kw, name = dict(width_mult=0.25), kind
    m = get_model(name, num_classes=10, **kw)
    init_weights(m, torch.Generator().manual_seed(3))
    m = m.to(dev).eval()
    x = RNG.standard_normal((8, H, H, 3)).astype(np.float32)
    policy = QuantPolicy.int8_ptq(exclude=("stem*",))
    tree = freeze(m, policy, calibrate(m, policy, [x]))
    if kind.startswith("resnet"):
        arch = dict(stage_sizes=(1, 1, 1, 1), width=16, bottleneck=True,
                    cifar_stem=kind == "resnet_cifar", num_classes=10)
        return ResNetInt8Engine(tree, arch, device=dev), H
    cls = (MobileNetV2Int8Engine if kind == "mobilenet_v2"
           else MobileNetV1Int8Engine)
    return cls(tree, num_classes=10, device=dev), H


def _zero_counters():
    from qtpu_torch.utils.graphs import launch_counters
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["resnet_imagenet", "resnet_cifar",
                                  "mobilenet_v2", "mobilenet_v1"])
def test_graphed_entries_equal_eager(cuda, kind):
    eng, H = _narrow(kind, cuda)
    pooled = int(kind == "resnet_imagenet")
    for batch in (3, 8):
        x8 = torch.from_numpy(RNG.integers(0, 256, (batch, H, H, 3),
                                           dtype=np.uint8))
        xf = torch.from_numpy(RNG.standard_normal((batch, H, H, 3)).astype(
            np.float32))
        for entry, x in (("forward_u8", x8), ("forward", xf)):
            _zero_counters()
            eager = getattr(eng, f"eager_{entry}")(x.to(cuda))
            torch.cuda.synchronize()
            assert (qstem.stem_fp32_codes.launches,
                    qstem.maxpool_codes.launches,
                    qstem.stem_fp32_codes_plain.calls,
                    qstem.maxpool_codes_plain.calls) == (1, pooled, 0, 0)
            first = getattr(eng, entry)(x)      # captures the graph
            again = getattr(eng, entry)(x)      # replays it
            assert torch.equal(first, eager) and torch.equal(again, eager)
    assert len(eng.graphs) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,want", [(RN50, ("stem_codes_kernel",
                                              "maxpool_codes_kernel")),
                                      (MNV2, ("stem_codes_kernel",))])
def test_traced_stem_runs_only_the_stem_kernels(cuda, cfg, want, tmp_path):
    from qtpu_torch.bench.tracing import capture_trace, parse_trace
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_forward

    eng = build_forward(CONFIGS[cfg], device=cuda).__self__
    x8 = torch.from_numpy(RNG.integers(0, 256, (8, 224, 224, 3),
                                       dtype=np.uint8)).to(cuda)
    steps = 2
    path = capture_trace(eng.eager_forward_u8, x8, steps=steps,
                         logdir=str(tmp_path))
    stem = [r.name for r in parse_trace(path)
            if r.category == "kernel" and r.scope == "stem"]
    assert not [k for k in stem if "convolve" in k.lower()
                or "at::native" in k or "elementwise" in k], stem
    assert len(stem) == steps * len(want), stem
    for k in want:
        assert sum(k in name for name in stem) == steps, stem
    _zero_counters()
    eng.eager_forward_u8(x8)
    torch.cuda.synchronize()
    assert (qstem.stem_fp32_codes.launches,
            qstem.maxpool_codes.launches) == (1, len(want) - 1)
