"""K2's pads in the kernel and K3's tile plan, on the CPU, against qtpu.

K2's implicit GEMM reads the unpadded input through TMA, which fills every
tap outside the image with 0, and repairs the accumulator in its epilogue
with ``zp · tapsum`` over those taps; K2's plain version and its wrappers
(``qconv2d_folded``, ``fused_ops.conv``, ``qconv2d_strided``) now take the
pads and the zero point instead of a padded copy.  Here, on the same
seeded numpy inputs:
  * the correction as a plain function (``qconv.border_correction``) on the
    zero-filled accumulator equals ``qtpu.ops.qops.qconv2d(..., zp=zp)`` in
    int32, at zp -128, 0 and 37, 3×3 and 7×7, stride 1 and 2, odd and even
    sizes, SAME (XLA's asymmetric split) and explicit ((3, 3), (3, 3));
  * ``tapsum`` as ``fused_ops.prepare_node`` makes it equals numpy's;
  * ``fused_ops.conv`` and ``qconv2d_strided`` with the pads passed in equal
    qtpu's conv and epilogue, and no zero-point pad copy is made;
  * ``k2_path`` and ``k3_plan``, pure functions of shapes, pointers and the
    folded grid.
Tolerances: int32 accumulators bit-exact; int8 codes equal except one step
at fp32 ties (≤ 0.1%, as tests/test_torch_kernels.py); f32 to rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops import qops as jq
from qtpu.serve import fused_ops as jfo
from qtpu_torch.ops import fakequant as tfq
from qtpu_torch.ops import qconv as tconv
from qtpu_torch.ops import qdepthwise as tdw
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops.qconv_dispatch import qconv2d_strided
from qtpu_torch.ops.qmatmul import fold
from qtpu_torch.serve import fused_ops as fo

RNG = np.random.default_rng(23)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_codes(a, b, frac=1e-3):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def assert_f32(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-6,
                               atol=1e-6 * float(np.abs(b).max()))


# (B, H, W, Ci, Co, kernel, stride, padding): odd and even sizes, SAME's
# asymmetric split ((0, 1) at 8/2, (2, 3) at 12 7x7/2), explicit pads
BORDER_CASES = [
    (2, 7, 7, 8, 5, 3, 1, "SAME"),
    (1, 8, 8, 4, 6, 3, 2, "SAME"),
    (2, 9, 9, 4, 3, 3, 2, "SAME"),
    (2, 6, 5, 5, 3, 3, 1, ((1, 1), (1, 1))),
    (1, 12, 12, 3, 4, 7, 2, "SAME"),
    (1, 11, 13, 3, 4, 7, 2, ((3, 3), (3, 3))),
    (1, 10, 10, 6, 4, 7, 1, "SAME"),
]


@pytest.mark.parametrize("B,H,W,Ci,Co,k,stride,padding", BORDER_CASES)
@pytest.mark.parametrize("zp", [-128, 0, 37])
def test_border_correction_matches_qtpu_qconv2d(B, H, W, Ci, Co, k, stride,
                                                padding, zp):
    """Zero-filled conv + zp · tapsum over the taps outside the image ==
    qtpu's conv on the zero-point-padded input, in int32; and K2's plain
    version with the pads passed in gives the same accumulator."""
    x = RNG.integers(-128, 128, (B, H, W, Ci)).astype(np.int8)
    w = RNG.integers(-127, 128, (k, k, Ci, Co)).astype(np.int8)
    ref = np.asarray(jq.qconv2d(jnp.asarray(x), jnp.asarray(w),
                                strides=(stride, stride), padding=padding,
                                zp=jnp.int32(zp)))
    pads = tq.resolve_pads((H, W), (k, k), (stride, stride), padding)
    acc0 = tq.conv_acc_f64(tq.pad_nhwc(_t(x), pads, 0), _t(w), stride)
    w_nk = tconv.weight_ohwi(_t(w))
    ts = tconv.tapsum_of(w_nk, (k, k))
    got = tconv.border_correction(acc0, ts, (H, W), (k, k), stride, pads, zp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    raw = tconv.qconv2d_folded(_t(x), w_nk, None, None, raw_acc=True,
                               kernel_hw=(k, k), stride=stride, pads=pads,
                               zp=zp)
    np.testing.assert_array_equal(raw.numpy(), ref)


def _np_node(kh, ci, co, zp, scale, depthwise=False):
    w = RNG.integers(-127, 128, (kh, kh, 1 if depthwise else ci,
                                 co)).astype(np.int8)
    return dict(kernel_q=w,
                w_scale=RNG.uniform(0.002, 0.02, co).astype(np.float32),
                colsum=w.astype(np.int32).sum((0, 1, 2)),
                bias=(RNG.standard_normal(co) * 0.1).astype(np.float32),
                act_scale=np.float32(scale), act_zp=np.int32(zp))


@pytest.mark.parametrize("kh,ci,co,int4", [(3, 16, 24, False),
                                           (7, 3, 64, False),
                                           (3, 8, 16, True)])
def test_prepare_node_tapsum(kh, ci, co, int4):
    """prepare_node keeps, beside w_nk, each tap's weights summed over Ci
    ((KH·KW, Co) int32) — for an int4 node, of the unpacked codes."""
    node = _np_node(kh, ci, co, 3, 0.02)
    w = node["kernel_q"]
    if int4:
        w = (w // 19).astype(np.int8)            # int4 codes in [-7, 7]
        node["kernel_q"] = tfq.pack_int4(_t(w), axis=-1).numpy()
        node["colsum"] = w.astype(np.int32).sum((0, 1, 2))
    prep = fo.prepare_node({k: _t(v) for k, v in node.items()},
                           torch.device("cpu"))
    want = w.astype(np.int32).sum(2).reshape(kh * kh, co)
    assert prep["tapsum"].dtype == torch.int32
    np.testing.assert_array_equal(prep["tapsum"].numpy(), want)


def test_prepare_node_tapsum_only_for_kxk_convs():
    one = fo.prepare_node({k: _t(v) for k, v in
                           _np_node(1, 8, 8, 0, 0.02).items()},
                          torch.device("cpu"))
    dw = fo.prepare_node({k: _t(v) for k, v in
                          _np_node(3, 8, 8, 0, 0.02, True).items()},
                         torch.device("cpu"), depthwise=True)
    assert "tapsum" not in one and "tapsum" not in dw


# (H, W, Ci, Co, kernel, stride, padding) of fused_ops.conv's callers: the
# ResNet 3x3s, the stems, torch-geometry explicit pads
CONV_CASES = [
    (9, 9, 16, 16, 3, 1, "SAME"),
    (10, 10, 16, 32, 3, 2, "SAME"),
    (9, 9, 8, 16, 3, 2, ((1, 1), (1, 1))),
    (16, 16, 3, 16, 7, 2, "SAME"),
    (15, 15, 3, 8, 7, 2, ((3, 3), (3, 3))),
    (16, 16, 3, 8, 3, 2, "SAME"),
]


@pytest.mark.parametrize("H,W,Ci,Co,k,stride,padding", CONV_CASES)
@pytest.mark.parametrize("requant", [True, False])
def test_fused_conv_pads_in_kernel_match_qtpu(H, W, Ci, Co, k, stride,
                                              padding, requant):
    """fused_ops.conv (the pads and the zero point passed to K2, no padded
    copy) against qtpu's conv_xla on the same frozen node."""
    node = _np_node(k, Ci, Co, -37, 0.013)
    x = RNG.integers(-128, 128, (2, H, W, Ci)).astype(np.int8)
    nxt = (0.021, 5) if requant else None
    ref = jfo.conv_xla(jnp.asarray(x), {k_: jnp.asarray(v)
                                        for k_, v in node.items()},
                       strides=(stride, stride), relu=True,
                       requant=None if nxt is None else (
                           jnp.float32(nxt[0]), jnp.int32(nxt[1]), False),
                       padding=padding)
    pads0 = tq.resolve_and_pad.calls
    got = fo.conv(_t(x), {k_: _t(v) for k_, v in node.items()},
                  strides=(stride, stride), relu=True,
                  requant=None if nxt is None else fo.Grid(*nxt),
                  padding=padding)
    assert tq.resolve_and_pad.calls == pads0
    assert tconv.qconv2d_folded.launches == 0
    if requant:
        assert got.dtype == torch.int8
        assert_codes(got.numpy(), ref)
    else:
        assert_f32(got.numpy(), ref)


@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1)), "VALID"])
@pytest.mark.parametrize("zp", [-128, 37])
def test_strided_pads_in_kernel_match_qtpu(padding, zp):
    """qconv2d_strided (the pads passed to K2) against qtpu's conv and
    epilogue at the int8 grid's extreme and an odd zero point."""
    x = RNG.integers(-128, 128, (2, 11, 10, 8)).astype(np.int8)
    w = RNG.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    kw = dict(act_scale=0.02, act_zp=zp,
              w_scale=RNG.uniform(0.001, 0.01, 16).astype(np.float32),
              colsum=w.astype(np.int32).sum((0, 1, 2)),
              bias=RNG.standard_normal(16).astype(np.float32),
              requant_scale=0.05, requant_zp=-3, relu=True)
    acc = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), strides=(2, 2),
                     padding=padding, zp=jnp.int32(zp))
    jco, jmode = jq.epilogue_coeffs(**{k: jnp.asarray(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    ref = jq.apply_epilogue(acc, jco, jmode)
    pads0 = tq.resolve_and_pad.calls
    got = qconv2d_strided(_t(x), _t(w), strides=(2, 2), padding=padding,
                          **{k: _t(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    assert tq.resolve_and_pad.calls == pads0
    assert_codes(got.numpy(), np.asarray(ref))


def _co(n, zp=-20):
    return tq.epilogue_coeffs(act_scale=0.02, act_zp=3,
                              w_scale=torch.full((n,), 0.01),
                              colsum=torch.zeros(n, dtype=torch.int32),
                              requant_scale=0.05, requant_zp=zp, relu=True)


def _unaligned(shape):
    """An int8 tensor of ``shape`` whose data starts one byte off a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=torch.int8)[1:n + 1].view(shape)


# (label, x shape, Co, kernel, stride, padding, out dtype, residual dtype,
# requant zp, want)
K2_PATH_CASES = [
    ("RN50 3x3/1 Ci 64", (2, 9, 9, 64), 64, 3, 1, "SAME", torch.int8, None,
     -20, "wgmma"),
    ("RN50 3x3/2 Ci 512", (1, 14, 14, 512), 512, 3, 2, "SAME", torch.int8,
     None, -20, "wgmma"),
    ("f32 out, f32 residual", (1, 7, 7, 128), 128, 3, 1, "SAME",
     torch.float32, torch.float32, None, "wgmma"),
    ("raw int32", (1, 7, 7, 64), 64, 3, 1, "SAME", torch.int32, None, None,
     "wgmma"),
    ("Co 136: 136-byte int8 rows", (1, 9, 9, 128), 136, 3, 1, "SAME",
     torch.int8, None, -20, "igemm"),
    ("Co 136, f32 out (544-byte rows)", (1, 9, 9, 128), 136, 3, 1, "SAME",
     torch.float32, None, None, "wgmma"),
    ("CIFAR Ci 16", (2, 8, 8, 16), 16, 3, 1, "SAME", torch.int8, None, -20,
     "small"),
    ("MNv1 stem Ci 3 Co 32", (1, 32, 32, 3), 32, 3, 2, "SAME", torch.int8,
     None, -20, "stem"),
    ("RN50 stem 7x7/2 Co 64 torch pads", (1, 32, 32, 3), 64, 7, 2,
     ((3, 3), (3, 3)), torch.int8, None, -20, "stem"),
    ("stem W * 3 not a multiple of 16", (1, 17, 17, 3), 32, 3, 2, "SAME",
     torch.int8, None, -20, "small"),
    ("stem Co 24", (1, 16, 16, 3), 24, 7, 2, "SAME", torch.int8, None, -20,
     "small"),
    ("stem f32 out", (1, 16, 16, 3), 32, 3, 2, "SAME", torch.float32, None,
     None, "small"),
    ("stem with a residual", (1, 16, 16, 3), 32, 3, 2, "SAME", torch.int8,
     torch.int8, -20, "small"),
    ("stem OW 264 > 256", (1, 8, 528, 3), 16, 3, 2, "SAME", torch.int8, None,
     -20, "small"),
    ("requant grid off the integers", (1, 7, 7, 64), 64, 3, 1, "SAME",
     torch.int8, None, -20.5, "igemm"),
    ("stem raw int32 (config 3's QAT stem)", (1, 16, 16, 3), 32, 3, 2,
     "SAME", torch.int32, None, None, "small"),
    ("LeNet conv1 Ci 1 Co 6 5x5 SAME raw", (2, 28, 28, 1), 6, 5, 1, "SAME",
     torch.int32, None, None, "small"),
    ("LeNet conv2 Ci 6 Co 16 5x5 VALID raw", (2, 14, 14, 6), 16, 5, 1,
     "VALID", torch.int32, None, None, "small"),
    ("RN20 Ci 32 3x3 int8 residual", (2, 16, 16, 32), 32, 3, 1, "SAME",
     torch.int8, torch.int8, -20, "small"),
    ("RN20 Ci 32 3x3/2 Co 64", (2, 16, 16, 32), 64, 3, 2, "SAME",
     torch.int8, None, -20, "small"),
    ("Ci 40 3x3: K = 360 > 320", (1, 8, 8, 40), 40, 3, 1, "SAME",
     torch.int8, None, -20, "igemm"),
    ("Co 5 odd", (1, 8, 8, 16), 5, 3, 1, "SAME", torch.float32, None, None,
     "igemm"),
    ("Co 136 > 128, Ci 16", (1, 8, 8, 16), 136, 3, 1, "SAME", torch.int8,
     None, -20, "igemm"),
    ("small off-integer grid", (1, 8, 8, 16), 16, 3, 1, "SAME", torch.int8,
     None, -20.5, "igemm"),
]


@pytest.mark.parametrize("case", K2_PATH_CASES, ids=lambda c: c[0])
def test_k2_path_dispatch(case):
    """K2's per-call choice among its kernels: the implicit GEMM where TMA
    can address every operand and Ci % 64 == 0, the stem kernel for Ci = 3
    int8 codes at the widths it tiles, the small-channel kernel for
    Ci·KH·KW <= 320 and an even Co <= 128, the old loop otherwise (and for
    any requant grid off the integers).  Decided from shapes, pointers and
    the folded grid."""
    _, shape, Co, k, stride, padding, odt, rdt, zp, want = case
    x = torch.zeros(shape, dtype=torch.int8)
    w = torch.zeros((Co, k * k * shape[-1]), dtype=torch.int8)
    pads = tq.resolve_pads(shape[1:3], (k, k), (stride, stride), padding)
    OH, OW = tconv.out_hw(shape[1:3], (k, k), stride, pads)
    res = (None if rdt is None
           else torch.zeros((shape[0], OH, OW, Co), dtype=rdt))
    co = mode = None
    if odt == torch.int8:
        co, mode = _co(Co, zp)
    assert tconv.k2_path(x, w, pads, stride, co, mode, kernel_hw=(k, k),
                         out_dtype=odt, residual=res) == want


def test_k2_path_unaligned_input():
    w = torch.zeros((64, 576), dtype=torch.int8)
    x = _unaligned((1, 9, 9, 64))
    assert tconv.k2_path(x, w, ((1, 1), (1, 1)), 1,
                         kernel_hw=(3, 3)) == "igemm"
    assert tconv.k2_path(_unaligned((1, 16, 16, 3)),
                         torch.zeros((32, 27), dtype=torch.int8),
                         ((0, 1), (0, 1)), 2, kernel_hw=(3, 3)) == "igemm"
    # the small kernel takes a 4-byte aligned input, not a 1-byte-off one
    x16 = torch.zeros((1 * 8 * 8 * 16 + 16,), dtype=torch.int8)
    w16 = torch.zeros((16, 144), dtype=torch.int8)
    for off, want in ((4, "small"), (1, "igemm")):
        xo = x16[off:off + 1024].view(1, 8, 8, 16)
        assert tconv.k2_path(xo, w16, ((1, 1), (1, 1)), 1,
                             kernel_hw=(3, 3)) == want


def test_k2_forced_path_refused_where_it_cannot_go():
    """path= forces a kernel the operands allow; a CPU tensor takes the
    plain version whatever the path."""
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    w = torch.zeros((16, 144), dtype=torch.int8)
    co, mode = _co(16)
    with pytest.raises(ValueError):
        tconv._path("wgmma", x, w, ((1, 1), (1, 1)), 1, co, mode, (3, 3),
                    torch.int8, None)
    assert tconv._path("igemm", x, w, ((1, 1), (1, 1)), 1, co, mode, (3, 3),
                       torch.int8, None) == "igemm"
    assert tconv._path("small", x, w, ((1, 1), (1, 1)), 1, co, mode, (3, 3),
                       torch.int8, None) == "small"
    # the small kernel may be forced where the stem kernel goes, not where
    # the implicit GEMM does or past its depth
    xs, ws = torch.zeros((1, 32, 32, 3), dtype=torch.int8), torch.zeros(
        (32, 27), dtype=torch.int8)
    co32, mode32 = _co(32)
    assert tconv._path("small", xs, ws, ((0, 1), (0, 1)), 2, co32, mode32,
                       (3, 3), torch.int8, None) == "small"
    x64 = torch.zeros((1, 8, 8, 64), dtype=torch.int8)
    w64 = torch.zeros((64, 576), dtype=torch.int8)
    co64, mode64 = _co(64)
    for xx, ww, c, m in ((x64, w64, co64, mode64),
                         (torch.zeros((1, 8, 8, 40), dtype=torch.int8),
                          torch.zeros((40, 360), dtype=torch.int8),
                          *_co(40))):
        with pytest.raises(ValueError):
            tconv._path("small", xx, ww, ((1, 1), (1, 1)), 1, c, m, (3, 3),
                        torch.int8, None)


# (B, H, W, C, OH, OW, kernel, stride, aligned, the plan) on an H100 SXM's
# 132 SMs: MobileNet's depthwise rows at B = 8 and 128, and the shapes the
# halo kernel does not take
H100_SMS = 132
K3_PLAN_CASES = [
    ((8, 112, 112, 96, 56, 56, (3, 3), 2, True), ("halo", 4, 32, 256)),
    ((8, 56, 56, 144, 56, 56, (3, 3), 1, True), ("halo", 8, 16, 128)),
    ((8, 7, 7, 960, 7, 7, (3, 3), 1, True), ("halo", 4, 32, 64)),
    ((128, 56, 56, 144, 56, 56, (3, 3), 1, True), ("halo", 8, 16, 128)),
    ((128, 7, 7, 960, 7, 7, (3, 3), 1, True), ("halo", 7, 32, 64)),
    ((8, 28, 28, 192, 14, 14, (3, 3), 2, True), ("halo", 2, 32, 128)),
    ((1, 5, 5, 16, 5, 5, (3, 3), 1, True), ("halo", 1, 16, 32)),
    ((1, 9, 10, 24, 9, 10, (3, 3), 1, True), ("scalar", 0, 0, 256)),
    ((2, 9, 9, 32, 9, 9, (5, 5), 1, True), ("scalar", 0, 0, 256)),
    ((2, 9, 9, 32, 9, 9, (3, 3), 1, False), ("scalar", 0, 0, 256)),
    ((1, 4, 2000, 32, 4, 2000, (3, 3), 1, True), ("scalar", 0, 0, 256)),
]


@pytest.mark.parametrize("args,want", K3_PLAN_CASES,
                         ids=lambda v: "x".join(map(str, v[:4]))
                         if isinstance(v[0], int) else None)
def test_k3_plan(args, want):
    """K3's kernel and tiles as a pure function of the shapes: whole small
    maps with few channels a block, bands of large ones, the scalar kernel
    where the halo kernel cannot go (C % 16, other kernel sizes, unaligned
    operands, a row too wide for 48 KB)."""
    assert tuple(tdw.k3_plan(*args, sms=H100_SMS)) == want


def test_k3_plans_fit_the_kernel():
    """Every halo plan over a grid of shapes is one the C entry takes:
    channels a multiple of 16 dividing C, a staged tile within 48 KB, 32 to
    256 threads in whole warps, and a grid of at least one block."""
    for B in (1, 8, 128):
        for H in (4, 7, 14, 28, 56, 112):
            for C in (16, 32, 48, 144, 960):
                for s in (1, 2):
                    OH = -(-H // s)
                    p = tdw.k3_plan(B, H, H, C, OH, OH, (3, 3), s,
                                    sms=H100_SMS)
                    assert p.path == "halo"
                    assert p.cc % 16 == 0 and C % p.cc == 0
                    assert 1 <= p.th <= OH
                    assert ((p.th - 1) * s + 3) * ((OH - 1) * s + 3) * p.cc \
                        <= tdw.HALO_SMEM
                    assert 32 <= p.threads <= 256 and p.threads % 32 == 0


def test_depthwise_plain_unchanged_by_plan():
    """The plain version ignores the plan; a forced halo plan on a CPU
    tensor still takes it."""
    x = _t(RNG.integers(-128, 128, (1, 6, 7, 16)).astype(np.int8))
    w = _t(RNG.integers(-127, 128, (9, 16)).astype(np.int8))
    co, mode = fold(act_scale=0.02, act_zp=4, w_scale=torch.full((16,), 0.01),
                    colsum=w.int().sum(0), requant_scale=0.05, requant_zp=-3,
                    relu=True, act_max=6.0)
    a = tdw.qdepthwise_folded(x, w, co, mode, kernel_hw=(3, 3), zp=4,
                              plan=tdw.DwPlan("halo", 1, 16, 32))
    b = tdw.qdepthwise_folded_plain(x, w, co, mode, kernel_hw=(3, 3), zp=4)
    assert tdw.qdepthwise_folded.launches == 0
    np.testing.assert_array_equal(a.numpy(), b.numpy())
