"""qtpu_torch CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here is ``gpu``-marked and
skips without a CUDA device.  Shapes include ragged M, N and K (masked
edges), K not a multiple of 16 (the byte-gather path), Ci = 3 and both
strides; for the depthwise kernel C not a multiple of 16 (the scalar path),
odd H, B = 1..3, both strides and both paddings; for the fused bottleneck kernels (K4-K6) odd H,
W = H + 1, Cmid 16-512, B = 1..3, both strides of K4's downsample, K5 with
the pad in the kernel (1) and on a zero-point-prepadded input (0), and
ResNet-50's widths; for the chained kernels (K7-K9) runs of 1-5 blocks,
H = W in {4, 5, 7} (and 5 x 6), B in {1, 3}, channel counts that are not
multiples of 16 (the byte-gather loads: Cmid 24, MobileNet-v2's C = 24), C
= 160 / E = 960, a projection with Cp != Co, and a CUDA-graph capture of
each cooperative launch; for K1 both kernels (the TMA + wgmma path and
the old mma.sync loop, forced) at M, N and K off every tile, M < 64, K = 24,
persistent grids of many tiles, every output and residual kind, a CUDA-graph
capture, and the per-path launch counters; for K1's int4 entry M in {1, 37, 392, 2000}, K with
K/2 on (64, 96, 1024) and off (48, 200) the 16-byte path, N in {64, 72,
256, 2048}, every epilogue mode, also against the int8 entry on the
unpacked weight and qtpu's ``w_packed`` call form, a CUDA-graph capture and
the refusal of odd K; the im2col conv at the 7×7×3 stem shape and two 3×3
shapes, also against K2.  The kernel and its plain version apply the same
epilogue formula in the same order, so every output must be bit-exact.

This file imports no JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py``.
"""
import numpy as np
import pytest
import torch

from qtpu_torch.ops import qblock as tblock
from qtpu_torch.ops import qconv as tconv
from qtpu_torch.ops import qdepthwise as tdw
from qtpu_torch.ops import qivr as tivr
from qtpu_torch.ops import qmatmul as tmm
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops import qproj as tproj
from qtpu_torch.ops import qstage as tstage
from qtpu_torch.ops import qtail as ttail
from qtpu_torch.ops.qconv_dispatch import (qconv2d_strided,
                                           qconv2d_strided_plain)

RNG = np.random.default_rng(11)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _dev(a, dev):
    return torch.tensor(np.asarray(a), device=dev)


K1_MODES = ["requant_res_i8", "f32_res_f32", "raw", "requant_sym",
            "requant_res_f32", "f32_res_i8"]


def _k1_epilogue(mode, M, N, w, dev):
    """qmatmul_fused keywords for one K1 epilogue mode: every output kind
    (int8 codes, f32, raw int32) and residual kind (none, int8, f32)."""
    kw = dict(act_scale=0.02, act_zp=3,
              w_scale=_dev(RNG.uniform(0.001, 0.01, (N,)).astype(np.float32),
                           dev),
              colsum=_dev(w.astype(np.int32).sum(0), dev),
              bias=_dev(RNG.standard_normal(N).astype(np.float32), dev))
    res_i8 = dict(residual=_dev(RNG.integers(-128, 128, (M, N)).astype(
        np.int8), dev), res_scale=0.03, res_zp=-6.0)
    res_f32 = dict(residual=_dev(RNG.standard_normal((M, N)).astype(
        np.float32), dev))
    requant = dict(requant_scale=0.05, requant_zp=-3, relu=True)
    kw.update({"requant_res_i8": {**requant, **res_i8},
               "f32_res_f32": dict(relu=True, act_max=6.0, **res_f32),
               "raw": {}, "requant_sym": dict(requant_scale=0.5),
               "requant_res_f32": {**requant, **res_f32},
               "f32_res_i8": dict(relu=True, **res_i8)}[mode])
    return kw


def _rows_ok(N, out_dtype, kw):
    """The output's and the residual's rows are multiples of 16 bytes."""
    res = kw.get("residual")
    return (N * out_dtype.itemsize % 16 == 0
            and (res is None or N * res.element_size() % 16 == 0))


def _k1_counts(fn):
    return (fn.launches, fn.launches_wgmma, fn.launches_wgmma_cp,
            fn.launches_igemm)


def _w4_counts(fn):
    """The int4 entry's counters: it has no narrow-row kernel."""
    return fn.launches, fn.launches_wgmma, fn.launches_igemm


def _k1_want(M, K, N, out_dtype, kw):
    """The kernel k1_path gives int8 operands from aligned tensors."""
    res = kw.get("residual")
    rows = [K, N * out_dtype.itemsize] + (
        [] if res is None else [N * res.element_size()])
    small_m = M < tmm.NARROW_MIN_M
    if all(r % 16 == 0 for r in rows) and (N >= 64 or small_m):
        return "wgmma"
    return ("wgmma_cp" if all(r % 4 == 0 for r in rows) and not small_m
            else "igemm")


# M, N and K off every tile (M < 64, N = 208, K = 80), K = 24 and rows that
# are no multiple of 16 bytes (the narrow-row kernel, or the igemm path
# where they are no multiple of 4), persistent grids of many tiles per
# block (M = 40000, 3000; M = 17000, K = 512: two warpgroups a block,
# 128-row tiles with a ragged last one), the fc (M = 8, N = 1000); the
# narrow-row kernel's tiles: N = 24, 10 (one 16-wide tile), 12 (MobileNet-v2's
# TP = 2 halves), 84 (one 96-wide), 32 and 144, K = 12, 84, 120, 144
@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(37, 200, 13), (130, 64, 72),
                                   (8, 2048, 1000), (300, 48, 256),
                                   (2000, 256, 384), (37, 80, 208),
                                   (200, 24, 144), (40000, 64, 256),
                                   (3000, 1024, 64), (1, 16, 16),
                                   (17000, 512, 256), (25088, 24, 144),
                                   (5000, 144, 24), (999, 84, 10),
                                   (8, 120, 84), (63, 12, 12),
                                   (4000, 144, 32), (700, 96, 24)])
@pytest.mark.parametrize("mode", K1_MODES)
def test_qmatmul_kernel_matches_plain(cuda, M, K, N, mode):
    x = RNG.integers(-128, 128, (M, K)).astype(np.int8)
    w = RNG.integers(-127, 128, (K, N)).astype(np.int8)
    kw = _k1_epilogue(mode, M, N, w, cuda)
    raw = mode == "raw"
    xt, wt = _dev(x, cuda), _dev(w, cuda)
    co, emode = tmm.fold(**kw)
    odt = tmm.out_dtype_of(emode, torch.float32, raw)
    w_nk = wt.t().contiguous()
    path = tmm.k1_path(xt, w_nk, odt, kw.get("residual"))
    assert path == _k1_want(M, K, N, odt, kw)
    c0 = _k1_counts(tmm.qmatmul_folded)
    got = tmm.qmatmul_fused(xt, wt, raw_acc=raw, **kw)
    torch.cuda.synchronize()
    assert _k1_counts(tmm.qmatmul_folded) == tuple(
        c + d for c, d in zip(c0, (1, path == "wgmma", path == "wgmma_cp",
                                   path == "igemm")))
    ref = tmm.qmatmul_fused_plain(xt, wt, raw_acc=raw, **kw)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    # the old loop, forced, gives the same values; so does the TMA ring
    # forced where it can go (N < 64 takes the narrow-row kernel)
    forced = ["igemm"] + (["wgmma"] if path == "wgmma_cp" and K % 16 == 0
                          and _rows_ok(N, odt, kw) else [])
    for force in forced:
        old = tmm.qmatmul_folded(xt, w_nk, co, emode, kw.get("residual"),
                                 raw_acc=raw, path=force)
        np.testing.assert_array_equal(old.cpu().numpy(), ref.cpu().numpy())
    f = tmm.qmatmul_folded
    assert f.launches == (f.launches_wgmma + f.launches_wgmma_cp
                          + f.launches_igemm)
    if path != "wgmma" and not (K % 16 == 0 and _rows_ok(N, odt, kw)):
        with pytest.raises(ValueError, match="cannot take"):
            tmm.qmatmul_folded(xt, w_nk, co, emode, kw.get("residual"),
                               raw_acc=raw, path="wgmma")
    if K % 4 == 0 and _k1_want(tmm.NARROW_MIN_M, K, N, odt, kw) != "igemm":
        # the narrow-row kernel forced below 512 rows, where it can go
        old = tmm.qmatmul_folded(xt, w_nk, co, emode, kw.get("residual"),
                                 raw_acc=raw, path="wgmma_cp")
        np.testing.assert_array_equal(old.cpu().numpy(), ref.cpu().numpy())
    elif path == "igemm":
        with pytest.raises(ValueError, match="cannot take"):
            tmm.qmatmul_folded(xt, w_nk, co, emode, kw.get("residual"),
                               raw_acc=raw, path="wgmma_cp")


@pytest.mark.gpu
@pytest.mark.parametrize("res", [None, "i8"])
@pytest.mark.parametrize("lo,hi,shift", [(0.0, 255.0, 128.0),
                                         (-127.0, 127.0, 0.0),
                                         (-3.0, 6.0, 0.0)])
def test_qmatmul_requant_rounds_ties_to_even(cuda, res, lo, hi, shift):
    """Requant codes at exact ties (A = 0.5: t = acc / 2 + B, B a multiple
    of 0.5), affine, symmetric and narrow grids: the wgmma path rounds the
    clipped value by adding 1.5 * 2^23, the old loop by rintf before the
    clip; both must give the plain version's codes."""
    M, K, N = 300, 64, 128
    x = _dev(RNG.integers(-128, 128, (M, K)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-3, 4, (N, K)).astype(np.int8), cuda)
    co = tq.EpilogueCoeffs(
        A=torch.full((N,), 0.5, device=cuda),
        B=_dev(RNG.integers(-4, 5, N).astype(np.float32) * 0.5, cuda),
        C=0.5, lo=lo, hi=hi)
    mode = tq.EpilogueMode(True, shift, False, None)
    r = (_dev(RNG.integers(-128, 128, (M, N)).astype(np.int8), cuda)
         if res else None)
    got = tmm.qmatmul_folded(x, w, co, mode, r)
    old = tmm.qmatmul_folded(x, w, co, mode, r, path="igemm")
    ref = tmm.qmatmul_folded_plain(x, w, co, mode, r)
    torch.cuda.synchronize()
    acc = tq.qmatmul(x, w.t())
    assert (acc % 2 != 0).float().mean().item() > 0.3     # ties abound
    assert torch.equal(got, ref) and torch.equal(old, ref)


@pytest.mark.gpu
def test_qmatmul_wgmma_captures_in_a_cuda_graph(cuda):
    """The new K1 path (TMA descriptors passed by value) replays from a CUDA
    graph, at a multi-tile persistent grid with an int8 residual."""
    M, K, N = 5000, 256, 512
    w = RNG.integers(-127, 128, (K, N)).astype(np.int8)
    kw = _k1_epilogue("requant_res_i8", M, N, w, cuda)
    co, emode = tmm.fold(**kw)
    x = _dev(RNG.integers(-128, 128, (M, K)).astype(np.int8), cuda)
    w_nk = _dev(w, cuda).t().contiguous()
    ref = tmm.qmatmul_folded(x, w_nk, co, emode, kw["residual"])
    n0, nw, nc, ni = _k1_counts(tmm.qmatmul_folded)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmm.qmatmul_folded(x, w_nk, co, emode, kw["residual"])
    assert _k1_counts(tmm.qmatmul_folded) == (n0 + 1, nw + 1, nc, ni)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    np.testing.assert_array_equal(
        ref.cpu().numpy(), tmm.qmatmul_folded_plain(
            x, w_nk, co, emode, kw["residual"]).cpu().numpy())


# The rows the narrow-row kernel took over, at B = 8 and B = 128 (M = B·56²
# for MobileNet-v2's 56² blocks): MobileNet-v2's block1 project, block2
# expand / project (+int8 residual) and block3 expand; and the fcs that stay
# on the old loop below 512 rows (LeNet-5's fc2 and fc3, the CIFAR fcs, raw),
# where the narrow-row kernel, forced, must agree
NARROW_ROWS = [
    ("MNv2 block1 project", 56 * 56, 96, 24, "requant", None),
    ("MNv2 block2 expand relu6", 56 * 56, 24, 144, "relu6", None),
    ("MNv2 block2 project +int8 res", 56 * 56, 144, 24, "requant", "i8"),
    ("MNv2 block3 expand relu6", 56 * 56, 24, 144, "relu6", None),
    ("LeNet fc2 raw", 1, 120, 84, "raw", None),
    ("LeNet fc3 raw", 1, 84, 10, "raw", None),
    ("RN20 fc raw", 1, 64, 10, "raw", None),
    ("RN18 fc raw", 1, 512, 10, "raw", None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 128])
@pytest.mark.parametrize("row", NARROW_ROWS, ids=lambda r: r[0])
def test_narrow_rows_at_model_shapes(cuda, B, row):
    """K1's narrow-row kernel at the model rows it took from the old loop:
    bit-exact against the plain version and against the old loop forced."""
    _, per_image, K, N, ep, res = row
    M = B * per_image
    x = _dev(RNG.integers(-128, 128, (M, K)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (N, K)).astype(np.int8), cuda)
    raw = ep == "raw"
    co = mode = None
    if not raw:
        co, mode = tq.epilogue_coeffs(
            act_scale=0.02, act_zp=-9,
            w_scale=_dev(RNG.uniform(0.001, 0.01, (N,)).astype(np.float32),
                         cuda),
            colsum=_dev(RNG.integers(-900, 900, N).astype(np.int32), cuda),
            requant_scale=0.05, requant_zp=-20, relu=True,
            act_max=6.0 if ep == "relu6" else None,
            res_scale=0.04 if res else None, res_zp=-7 if res else None)
    r = (_dev(RNG.integers(-128, 128, (M, N)).astype(np.int8), cuda)
         if res else None)
    odt = torch.int32 if raw else torch.int8
    path = "wgmma_cp" if M >= tmm.NARROW_MIN_M else "igemm"
    assert tmm.k1_path(x, w, odt, r, co, mode) == path
    c0 = _k1_counts(tmm.qmatmul_folded)
    got = tmm.qmatmul_folded(x, w, co, mode, r, raw_acc=raw)
    torch.cuda.synchronize()
    assert _k1_counts(tmm.qmatmul_folded) == (
        c0[0] + 1, c0[1], c0[2] + (path == "wgmma_cp"),
        c0[3] + (path == "igemm"))
    assert torch.equal(got, tmm.qmatmul_folded_plain(x, w, co, mode, r,
                                                     raw_acc=raw))
    for force in ("igemm", "wgmma_cp"):
        assert torch.equal(got, tmm.qmatmul_folded(
            x, w, co, mode, r, raw_acc=raw, path=force))


# K2's rows the small kernel took from the old loop: LeNet-5's convs (raw,
# at zero-point pads), config 3's raw Ci = 3 stem at the trainer's B = 16,
# ResNet-20's 16- and 32-channel 3×3s (int8 codes, an int8 residual, the
# stride-2 convs into 32 and 64 channels) at B = 8 and 128
SMALL_ROWS = [
    ("LeNet conv1 5x5 SAME raw", None, 28, 1, 6, 5, 1, "SAME", -17, "raw"),
    ("LeNet conv2 5x5 VALID raw", None, 14, 6, 16, 5, 1, "VALID", 5, "raw"),
    ("cfg3 QAT stem 3x3/2 raw", 16, 224, 3, 32, 3, 2, "SAME", -5, "raw"),
    ("RN20 layer1 3x3 +int8 res", None, 32, 16, 16, 3, 1, "SAME", -9,
     "res"),
    ("RN20 layer2_0 3x3/2", None, 32, 16, 32, 3, 2, "SAME", -9, "requant"),
    ("RN20 layer2 3x3 +int8 res", None, 16, 32, 32, 3, 1, "SAME", -9,
     "res"),
    ("RN20 layer3_0 3x3/2", None, 16, 32, 64, 3, 2, "SAME", -9, "requant"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 128])
@pytest.mark.parametrize("row", SMALL_ROWS, ids=lambda r: r[0])
def test_small_conv_at_model_shapes(cuda, B, row):
    """K2's small kernel at the model rows it took from the old loop, with
    either multiply: bit-exact against the plain version and against the
    old loop forced (on its zero-point-padded copy)."""
    _, fixed_b, H, Ci, Co, k, s, padding, zp, ep = row
    B = fixed_b or B
    x = _dev(RNG.integers(-128, 128, (B, H, H, Ci)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (Co, k * k * Ci)).astype(np.int8), cuda)
    pads = tq.resolve_pads((H, H), (k, k), (s, s), padding)
    OH, OW = tconv.out_hw((H, H), (k, k), s, pads)
    raw = ep == "raw"
    co = mode = r = None
    if not raw:
        co, mode = tq.epilogue_coeffs(
            act_scale=0.02, act_zp=zp,
            w_scale=_dev(RNG.uniform(0.001, 0.01, (Co,)).astype(np.float32),
                         cuda),
            colsum=_dev(RNG.integers(-900, 900, Co).astype(np.int32), cuda),
            requant_scale=0.05, requant_zp=-20, relu=True,
            res_scale=0.04 if ep == "res" else None,
            res_zp=-7 if ep == "res" else None)
    if ep == "res":
        r = _dev(RNG.integers(-128, 128, (B, OH, OW, Co)).astype(np.int8),
                 cuda)
    args = dict(kernel_hw=(k, k), stride=s, pads=pads, zp=zp, raw_acc=raw)
    assert tconv.k2_path(x, w, pads, s, co, mode, kernel_hw=(k, k),
                         out_dtype=torch.int32 if raw else torch.int8,
                         residual=r) == "small"
    ref = tconv.qconv2d_folded_plain(x, w, co, mode, r, **args)
    for mma in (None, "sync") + (("wgmma",) if Co > 8 else ()):
        c0 = _k2_counts()
        got = tconv.qconv2d_folded(x, w, co, mode, r, small_mma=mma, **args)
        torch.cuda.synchronize()
        assert _k2_counts() == (c0[0] + 1, c0[1], c0[2], c0[3] + 1, c0[4],
                                c0[5])                  # no pad copy
        assert torch.equal(got, ref)
    assert torch.equal(ref, tconv.qconv2d_folded(x, w, co, mode, r,
                                                 path="igemm", **args))


@pytest.mark.gpu
def test_new_paths_capture_in_a_cuda_graph(cuda):
    """K1's narrow-row kernel (an int8 residual on 24-byte rows, cp.async
    loads and thread stores) and K2's small kernel (pads written in the
    kernel, both multiplies) replay from one CUDA graph."""
    M = 3000
    x = _dev(RNG.integers(-128, 128, (M, 144)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (24, 144)).astype(np.int8), cuda)
    r = _dev(RNG.integers(-128, 128, (M, 24)).astype(np.int8), cuda)
    xe = _dev(RNG.integers(-128, 128, (M, 24)).astype(np.int8), cuda)
    we = _dev(RNG.integers(-127, 128, (144, 24)).astype(np.int8), cuda)
    xc = _dev(RNG.integers(-128, 128, (4, 16, 16, 16)).astype(np.int8), cuda)
    wc = _dev(RNG.integers(-127, 128, (32, 144)).astype(np.int8), cuda)

    def fold(n, **kw):
        return tq.epilogue_coeffs(
            act_scale=0.02, act_zp=-9,
            w_scale=_dev(RNG.uniform(0.001, 0.01, (n,)).astype(np.float32),
                         cuda),
            colsum=_dev(RNG.integers(-500, 500, n).astype(np.int32), cuda),
            requant_scale=0.05, requant_zp=-20, relu=True, **kw)

    (c24, m24), (c144, m144), (c32, m32) = (
        fold(24, res_scale=0.04, res_zp=-7), fold(144, act_max=6.0),
        fold(32))
    cargs = dict(kernel_hw=(3, 3), stride=1, pads=((1, 1), (1, 1)), zp=-9)

    def run():
        return (tmm.qmatmul_folded(x, w, c24, m24, r),
                tmm.qmatmul_folded(xe, we, c144, m144),
                tconv.qconv2d_folded(xc, wc, c32, m32, small_mma="sync",
                                     **cargs),
                tconv.qconv2d_folded(xc, wc, c32, m32, small_mma="wgmma",
                                     **cargs))

    refs = run()
    c0 = (tmm.qmatmul_folded.launches_wgmma_cp,
          tconv.qconv2d_folded.launches_small)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    assert (tmm.qmatmul_folded.launches_wgmma_cp,
            tconv.qconv2d_folded.launches_small) == (c0[0] + 2, c0[1] + 2)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, ref in zip(outs, refs):
            assert torch.equal(o, ref)
    assert torch.equal(refs[0], tmm.qmatmul_folded_plain(x, w, c24, m24, r))
    assert torch.equal(refs[2], refs[3])
    assert torch.equal(refs[2], tconv.qconv2d_folded_plain(xc, wc, c32, m32,
                                                           **cargs))


@pytest.mark.gpu
def test_new_paths_refuse_bad_inputs(cuda):
    """The narrow-row and small kernels raise, and count nothing, on
    operands they do not take: rows or bases off 4 bytes, int4 weights, a
    requant grid off the integers, Ci·KH·KW > 320, an odd Co, the small
    multiply named without the small path."""
    x6 = torch.zeros((64, 6), dtype=torch.int8, device=cuda)
    w6 = torch.zeros((64, 6), dtype=torch.int8, device=cuda)
    buf = torch.zeros(64 * 24 + 16, dtype=torch.int8, device=cuda)
    x_off = buf[2:2 + 64 * 24].view(64, 24)
    w24 = torch.zeros((144, 24), dtype=torch.int8, device=cuda)
    c0 = _k1_counts(tmm.qmatmul_folded)
    for x, w in ((x6, w6), (x_off, w24)):
        with pytest.raises(ValueError, match="cannot take"):
            tmm.qmatmul_folded(x, w, None, None, raw_acc=True,
                               path="wgmma_cp")
    w4 = torch.zeros((24, 72), dtype=torch.int8, device=cuda)
    xk = torch.zeros((64, 144), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="cannot take"):
        tmm.qmatmul_folded_w4(xk, w4, None, None, raw_acc=True,
                              path="wgmma_cp")
    co, mode = tq.epilogue_coeffs(
        act_scale=0.02, act_zp=3, w_scale=torch.full((144,), 0.01,
                                                     device=cuda),
        colsum=torch.zeros(144, dtype=torch.int32, device=cuda),
        requant_scale=0.05, requant_zp=-20.5, relu=True)  # lo 107.5
    xe = torch.zeros((64, 24), dtype=torch.int8, device=cuda)
    assert tmm.k1_path(xe, w24, torch.int8, None, co, mode) == "igemm"
    with pytest.raises(ValueError, match="cannot take"):
        tmm.qmatmul_folded(xe, w24, co, mode, path="wgmma_cp")
    assert _k1_counts(tmm.qmatmul_folded) == c0
    k0 = _k2_counts()
    xc = torch.zeros((1, 8, 8, 40), dtype=torch.int8, device=cuda)
    wc = torch.zeros((40, 360), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="cannot take"):
        tconv.qconv2d_folded(xc, wc, None, None, kernel_hw=(3, 3),
                             pads=((1, 1), (1, 1)), raw_acc=True,
                             path="small")
    xo = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda)
    wo = torch.zeros((5, 144), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="cannot take"):
        tconv.qconv2d_folded(xo, wo, None, None, kernel_hw=(3, 3),
                             pads=((1, 1), (1, 1)), raw_acc=True,
                             path="small")
    x64 = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=cuda)
    w64 = torch.zeros((64, 576), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="small path"):
        tconv.qconv2d_folded(x64, w64, None, None, kernel_hw=(3, 3),
                             pads=((1, 1), (1, 1)), raw_acc=True,
                             small_mma="sync")
    assert _k2_counts() == k0


def _k2_counts():
    f = tconv.qconv2d_folded
    return (f.launches, f.launches_wgmma, f.launches_stem, f.launches_small,
            f.launches_igemm, tq.resolve_and_pad.calls)


# (B, H, W, Ci, Co, k, stride, padding, the path k2_path gives a requant
# call): the stems (Ci = 3: MobileNet's 3x3/2 at Co = 32, ResNet-50's 7x7/2
# at Co = 64, SAME and the explicit ((3, 3), (3, 3))), the implicit GEMM at
# Ci 64-512 with M off every tile, odd and even sizes at both strides, and
# the small-channel kernel's (Ci 1, 3, 6, 16, 32: LeNet-5's, the stems'
# other widths, ResNet-20's; Co 6, 16, 24, 32, 64), and the old loop's
# (Ci·KH·KW > 320 with Ci 40; Co = 136: rows of 136 bytes)
K2_CASES = [
    (3, 16, 16, 3, 32, 3, 2, "SAME", "stem"),
    (2, 23, 32, 3, 64, 7, 2, "SAME", "stem"),
    (1, 17, 16, 3, 16, 7, 2, ((3, 3), (3, 3)), "stem"),
    (3, 17, 17, 3, 24, 7, 2, "SAME", "small"),
    (2, 28, 28, 1, 6, 5, 1, "SAME", "small"),
    (3, 14, 14, 6, 16, 5, 1, "VALID", "small"),
    (2, 32, 32, 16, 16, 3, 1, "SAME", "small"),
    (2, 32, 31, 16, 32, 3, 2, "SAME", "small"),
    (3, 16, 16, 32, 32, 3, 1, "SAME", "small"),
    (2, 15, 16, 32, 64, 3, 2, "SAME", "small"),
    (1, 33, 30, 3, 32, 3, 2, ((0, 1), (0, 1)), "small"),
    (2, 9, 9, 64, 64, 3, 1, "SAME", "wgmma"),
    (3, 14, 14, 64, 64, 3, 2, "SAME", "wgmma"),
    (1, 15, 15, 128, 64, 3, 2, "SAME", "wgmma"),
    (2, 7, 7, 512, 512, 3, 1, "SAME", "wgmma"),
    (1, 9, 11, 128, 128, 3, 1, ((1, 1), (1, 1)), "wgmma"),
    (3, 12, 12, 16, 16, 3, 1, "SAME", "small"),
    (3, 9, 9, 40, 8, 3, 1, "SAME", "igemm"),
    (3, 9, 9, 128, 136, 3, 1, "SAME", "igemm"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co,k,stride,padding,want", K2_CASES)
@pytest.mark.parametrize("zp", [-128, 0, 37])
@pytest.mark.parametrize("mode", ["requant", "f32", "requant_res_i8",
                                  "f32_res_f32"])
def test_qconv_kernel_matches_plain(cuda, B, H, W, Ci, Co, k, stride,
                                    padding, want, zp, mode):
    """Every K2 kernel, as k2_path chooses it and with the old loop forced
    (the small kernel also with either multiply forced), pads read in the
    kernel (the old loop: on the copy the wrapper pads and counts), exact
    against the plain version; qconv2d_strided (qtpu's call form) too, and
    the raw int32 accumulator."""
    x = RNG.integers(-128, 128, (B, H, W, Ci)).astype(np.int8)
    w = RNG.integers(-127, 128, (k, k, Ci, Co)).astype(np.int8)
    kw = dict(act_scale=0.02, act_zp=zp,
              w_scale=_dev(RNG.uniform(0.001, 0.01, (Co,)).astype(
                  np.float32), cuda),
              colsum=_dev(w.astype(np.int32).sum((0, 1, 2)), cuda),
              bias=_dev(RNG.standard_normal(Co).astype(np.float32), cuda),
              relu=True)
    pads = tq.resolve_pads((H, W), (k, k), (stride, stride), padding)
    OH, OW = tconv.out_hw((H, W), (k, k), stride, pads)
    if mode.startswith("requant"):
        kw.update(requant_scale=0.05, requant_zp=2)
    if mode.endswith("res_i8"):
        kw.update(residual=_dev(RNG.integers(-128, 128, (B, OH, OW, Co))
                                .astype(np.int8), cuda),
                  res_scale=0.03, res_zp=-6.0)
    elif mode.endswith("res_f32"):
        kw.update(residual=_dev(RNG.standard_normal((B, OH, OW, Co)).astype(
            np.float32), cuda))
    xt, wt = _dev(x, cuda), _dev(w, cuda)
    w_nk = tconv.weight_ohwi(wt)
    co, emode = tmm.fold(**kw)
    res = kw.get("residual")
    args = dict(kernel_hw=(k, k), stride=stride, pads=pads, zp=zp)
    odt = tmm.out_dtype_of(emode, torch.float32, False)
    path = tconv.k2_path(xt, w_nk, pads, stride, co, emode, kernel_hw=(k, k),
                         out_dtype=odt, residual=res)
    if mode == "requant":
        assert path == want
    ref = tconv.qconv2d_folded_plain(xt, w_nk, co, emode, res, **args)
    runs = [(None, None), ("igemm", None)]
    if path == "small":
        runs += [("small", "sync")] + ([("small", "wgmma")] if Co > 8
                                        else [])
    for force, mma in runs:
        c0 = _k2_counts()
        got = tconv.qconv2d_folded(xt, w_nk, co, emode, res, path=force,
                                   small_mma=mma, **args)
        torch.cuda.synchronize()
        used = force or path
        pad = int(used == "igemm" and pads != ((0, 0), (0, 0)))
        assert _k2_counts() == tuple(
            c + d for c, d in zip(c0, (1, used == "wgmma", used == "stem",
                                       used == "small", used == "igemm",
                                       pad)))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    if path == "small" and Co <= 8:
        with pytest.raises(RuntimeError):    # no wgmma below 16 columns
            tconv.qconv2d_folded(xt, w_nk, co, emode, res, small_mma="wgmma",
                                 **args)
    np.testing.assert_array_equal(
        qconv2d_strided(xt, wt, strides=(stride, stride), padding=padding,
                        **kw).cpu().numpy(),
        qconv2d_strided_plain(xt, wt, strides=(stride, stride),
                              padding=padding, **kw).cpu().numpy())
    raw = tconv.qconv2d_folded(xt, w_nk, None, None, raw_acc=True, **args)
    raw_ref = tconv.qconv2d_folded_plain(xt, w_nk, None, None, raw_acc=True,
                                         **args)
    np.testing.assert_array_equal(raw.cpu().numpy(), raw_ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("Ci,Co,k", [(64, 64, 3), (3, 32, 3), (3, 64, 7),
                                     (16, 32, 3), (6, 16, 5)])
@pytest.mark.parametrize("lo,hi,shift", [(0.0, 255.0, 128.0),
                                         (-127.0, 127.0, 0.0),
                                         (-3.0, 6.0, 0.0)])
def test_qconv_requant_rounds_ties_to_even(cuda, Ci, Co, k, lo, hi, shift):
    """K2's codes at exact ties (A = 0.5, B a multiple of 0.5) through the
    implicit GEMM (Ci = 64), the stem kernel (Ci = 3) and the small kernel
    (Ci = 16, 6), which round the clipped value by adding 1.5 * 2^23, and
    the old loop (rintf before the clip): all give the plain version's
    codes."""
    B, H, zp = 2, 16, 5
    x = _dev(RNG.integers(-128, 128, (B, H, H, Ci)).astype(np.int8), cuda)
    w_nk = _dev(RNG.integers(-3, 4, (Co, k * k * Ci)).astype(np.int8), cuda)
    co = tq.EpilogueCoeffs(
        A=torch.full((Co,), 0.5, device=cuda),
        B=_dev(RNG.integers(-4, 5, Co).astype(np.float32) * 0.5, cuda),
        C=0.0, lo=lo, hi=hi)
    mode = tq.EpilogueMode(True, shift, False, None)
    pads = tq.same_pads((H, H), (k, k), (2, 2))
    args = dict(kernel_hw=(k, k), stride=2, pads=pads, zp=zp)
    assert tconv.k2_path(x, w_nk, pads, 2, co, mode, kernel_hw=(k, k)) == (
        "stem" if Ci == 3 else "wgmma" if Ci == 64 else "small")
    got = tconv.qconv2d_folded(x, w_nk, co, mode, **args)
    old = tconv.qconv2d_folded(x, w_nk, co, mode, path="igemm", **args)
    ref = tconv.qconv2d_folded_plain(x, w_nk, co, mode, **args)
    torch.cuda.synchronize()
    acc = tconv.qconv2d_folded_plain(x, w_nk, None, None, raw_acc=True,
                                     **args)
    assert (acc % 2 != 0).float().mean().item() > 0.3     # ties abound
    assert torch.equal(got, ref) and torch.equal(old, ref)


@pytest.mark.gpu
def test_k2_k3_capture_in_a_cuda_graph(cuda):
    """K2's implicit GEMM (pads and the tapsum correction in the kernel),
    its stem kernel and K3's halo kernel replay from one CUDA graph."""
    x64 = _dev(RNG.integers(-128, 128, (4, 14, 14, 64)).astype(np.int8), cuda)
    w64 = _dev(RNG.integers(-127, 128, (128, 576)).astype(np.int8), cuda)
    x3 = _dev(RNG.integers(-128, 128, (2, 32, 32, 3)).astype(np.int8), cuda)
    w3 = _dev(RNG.integers(-127, 128, (32, 27)).astype(np.int8), cuda)
    xd = _dev(RNG.integers(-128, 128, (2, 7, 7, 960)).astype(np.int8), cuda)
    wd = _dev(RNG.integers(-127, 128, (9, 960)).astype(np.int8), cuda)

    def fold(n):
        return tq.epilogue_coeffs(
            act_scale=0.02, act_zp=-9,
            w_scale=_dev(RNG.uniform(0.001, 0.01, (n,)).astype(np.float32),
                         cuda),
            colsum=_dev(RNG.integers(-500, 500, n).astype(np.int32), cuda),
            requant_scale=0.05, requant_zp=-20, relu=True)

    (c64, m64), (c3, m3), (cd, md) = fold(128), fold(32), fold(960)
    ts = tconv.tapsum_of(w64, (3, 3))

    def run():
        return (tconv.qconv2d_folded(x64, w64, c64, m64, kernel_hw=(3, 3),
                                     pads=((1, 1), (1, 1)), zp=-9, tapsum=ts),
                tconv.qconv2d_folded(x3, w3, c3, m3, kernel_hw=(3, 3),
                                     stride=2, pads=((0, 1), (0, 1)), zp=-9),
                tdw.qdepthwise_folded(xd, wd, cd, md, kernel_hw=(3, 3),
                                      zp=-9))

    refs = run()
    c0 = (tconv.qconv2d_folded.launches_wgmma,
          tconv.qconv2d_folded.launches_stem,
          tdw.qdepthwise_folded.launches_halo)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    assert (tconv.qconv2d_folded.launches_wgmma,
            tconv.qconv2d_folded.launches_stem,
            tdw.qdepthwise_folded.launches_halo) == tuple(c + 1 for c in c0)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, refs):
            assert torch.equal(o, r)
    np.testing.assert_array_equal(
        refs[0].cpu().numpy(),
        tconv.qconv2d_folded_plain(x64, w64, c64, m64, kernel_hw=(3, 3),
                                   pads=((1, 1), (1, 1)),
                                   zp=-9).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,C,stride", [(1, 9, 24, 1), (2, 17, 40, 2),
                                         (3, 7, 8, 2), (2, 12, 96, 1),
                                         (1, 15, 32, 2), (2, 6, 144, 2),
                                         (2, 7, 960, 1), (1, 19, 48, 1),
                                         (2, 13, 64, 2), (1, 28, 16, 1)])
@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
@pytest.mark.parametrize("mode", ["requant_relu6", "f32_relu6", "raw"])
def test_qdepthwise_kernel_matches_plain(cuda, B, H, C, stride, padding,
                                         mode):
    x = RNG.integers(-128, 128, (B, H, H + 1, C)).astype(np.int8)
    w = RNG.integers(-127, 128, (3, 3, 1, C)).astype(np.int8)
    zp = int(RNG.integers(-20, 20))
    kw = dict(act_scale=0.02, act_zp=zp,
              w_scale=_dev(RNG.uniform(0.001, 0.01, (C,)).astype(np.float32),
                           cuda),
              colsum=_dev(w.astype(np.int32).sum((0, 1, 2)), cuda),
              bias=_dev(RNG.standard_normal(C).astype(np.float32), cuda),
              relu=True, act_max=6.0)
    if mode == "requant_relu6":
        kw.update(requant_scale=0.05, requant_zp=-3)
    co, emode = tmm.fold(**kw)
    xt = _dev(x, cuda)
    wt = tdw.weight_taps(_dev(w, cuda))
    args = dict(kernel_hw=(3, 3), stride=stride, padding=padding, zp=zp,
                raw_acc=mode == "raw")
    f = tdw.qdepthwise_folded
    n0, h0, s0 = f.launches, f.launches_halo, f.launches_scalar
    got = tdw.qdepthwise_folded(xt, wt, co, emode, **args)
    torch.cuda.synchronize()
    halo = C % 16 == 0
    assert (f.launches, f.launches_halo, f.launches_scalar) == (
        n0 + 1, h0 + halo, s0 + (not halo))
    ref = tdw.qdepthwise_folded_plain(xt, wt, co, emode, **args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    # the scalar kernel forced, and a halo plan of one row and 16 channels
    # (every band edge a halo edge)
    np.testing.assert_array_equal(
        tdw.qdepthwise_folded(xt, wt, co, emode, plan=tdw.DwPlan("scalar"),
                              **args).cpu().numpy(), ref.cpu().numpy())
    if halo:
        np.testing.assert_array_equal(
            tdw.qdepthwise_folded(xt, wt, co, emode,
                                  plan=tdw.DwPlan("halo", 1, 16, 64),
                                  **args).cpu().numpy(), ref.cpu().numpy())
    if stride == 1 and padding == "SAME" and mode != "raw":
        # qtpu's call form on the zero-point-prepadded input
        xp = tq.resolve_and_pad(xt, (3, 3), (1, 1), "SAME", zp)
        wq = _dev(w, cuda)
        np.testing.assert_array_equal(
            tdw.qdepthwise_fused(xp, wq, **kw).cpu().numpy(),
            tdw.qdepthwise_fused_plain(xp, wq, **kw).cpu().numpy())


# -- K1's int4 entry and the im2col conv ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1, 64, 64), (37, 96, 72), (392, 1024, 2048),
                                   (37, 48, 64), (392, 200, 72), (1, 1024, 72),
                                   (2000, 64, 256), (37, 1024, 2048),
                                   (37, 160, 208), (40000, 64, 256),
                                   (3000, 512, 64), (17000, 512, 256)])
@pytest.mark.parametrize("mode", K1_MODES)
def test_qmatmul_int4_kernel_matches_plain(cuda, M, K, N, mode):
    """The int4 entry (the wgmma path when K % 32 == 0 and the rows allow
    TMA, else the old loop, its K/2 on the 16-byte path when K % 32 == 0 and
    the byte path otherwise; ragged M and N, persistent grids) against its
    plain version, against the int8 entry on the unpacked weight, and qtpu's
    ``w_packed`` call form."""
    x = RNG.integers(-128, 128, (M, K)).astype(np.int8)
    w = RNG.integers(-7, 8, (K, N)).astype(np.int8)
    w[0, : min(N, 2)] = (-7, 7)[: min(N, 2)]
    kw = _k1_epilogue(mode, M, N, w, cuda)
    raw = mode == "raw"
    xt, wt = _dev(x, cuda), _dev(w, cuda)
    co, emode = tmm.fold(**kw)
    w4 = tmm.pack_int4_nk(wt.t().contiguous())
    path = tmm.k1_path(xt, w4, tmm.out_dtype_of(emode, torch.float32, raw),
                       kw.get("residual"))
    n0, nw, ni = _w4_counts(tmm.qmatmul_folded_w4)
    n8 = tmm.qmatmul_folded.launches
    got = tmm.qmatmul_folded_w4(xt, w4, co, emode, kw.get("residual"),
                                raw_acc=raw)
    torch.cuda.synchronize()
    assert _w4_counts(tmm.qmatmul_folded_w4) == (
        n0 + 1, nw + (path == "wgmma"), ni + (path == "igemm"))
    assert tmm.qmatmul_folded.launches == n8
    assert (path == "wgmma") == (K % 32 == 0 and _rows_ok(N, got.dtype, kw))
    old = tmm.qmatmul_folded_w4(xt, w4, co, emode, kw.get("residual"),
                                raw_acc=raw, path="igemm")
    np.testing.assert_array_equal(old.cpu().numpy(), got.cpu().numpy())
    ref = tmm.qmatmul_folded_w4_plain(xt, w4, co, emode, kw.get("residual"),
                                      raw_acc=raw)
    i8 = tmm.qmatmul_folded(xt, wt.t().contiguous(), co, emode,
                            kw.get("residual"), raw_acc=raw)
    assert got.dtype == ref.dtype and got.shape == (M, N)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), i8.cpu().numpy())
    if N % 64 == 0:
        bn = 64 if N == 64 else 128
        packed = tmm.pack_int4_halves(wt, bn)
        np.testing.assert_array_equal(
            tmm.qmatmul_fused(xt, packed, w_packed=True, bn=bn, raw_acc=raw,
                              **kw).cpu().numpy(), got.cpu().numpy())


@pytest.mark.gpu
def test_qmatmul_int4_captures_in_a_cuda_graph(cuda):
    x = _dev(RNG.integers(-128, 128, (64, 256)).astype(np.int8), cuda)
    w4 = tmm.pack_int4_nk(_dev(RNG.integers(-7, 8, (128, 256)).astype(
        np.int8), cuda))
    ref = tmm.qmatmul_folded_w4(x, w4, None, None, raw_acc=True)
    n0, nw, ni = _w4_counts(tmm.qmatmul_folded_w4)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmm.qmatmul_folded_w4(x, w4, None, None, raw_acc=True)
    assert _w4_counts(tmm.qmatmul_folded_w4) == (n0 + 1, nw + 1, ni)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(ref, tmm.qmatmul_folded_w4_plain(x, w4, None, None,
                                                        raw_acc=True))
    with pytest.raises(ValueError):                      # odd K
        tmm.qmatmul_folded_w4(x[:, :255].contiguous(), w4, None, None,
                              raw_acc=True)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Ci,Co,k,stride", [(2, 17, 3, 64, 7, 2),
                                                (1, 12, 16, 24, 3, 1),
                                                (3, 9, 32, 32, 3, 2)])
def test_im2col_conv_matches_plain_and_k2(cuda, B, H, Ci, Co, k, stride):
    from qtpu_torch.ops import qim2col
    from qtpu_torch.ops.qconv_dispatch import qconv2d_strided

    x = RNG.integers(-128, 128, (B, H, H, Ci)).astype(np.int8)
    w = RNG.integers(-127, 128, (k, k, Ci, Co)).astype(np.int8)
    kw = dict(act_scale=0.02, act_zp=6,
              w_scale=_dev(RNG.uniform(0.001, 0.01, (Co,)).astype(
                  np.float32), cuda),
              colsum=_dev(w.astype(np.int32).sum((0, 1, 2)), cuda),
              bias=_dev(RNG.standard_normal(Co).astype(np.float32), cuda),
              requant_scale=0.05, requant_zp=-3, relu=True)
    xt, wt = _dev(x, cuda), _dev(w, cuda)
    n0, i0 = tmm.qmatmul_folded.launches, qim2col.qconv2d_im2col.launches
    got = qim2col.qconv2d_im2col(xt, wt, strides=(stride, stride), **kw)
    torch.cuda.synchronize()
    assert tmm.qmatmul_folded.launches == n0 + 1
    assert qim2col.qconv2d_im2col.launches == i0 + 1
    ref = qim2col.qconv2d_im2col_plain(xt, wt, strides=(stride, stride),
                                       **kw)
    k2 = qconv2d_strided(xt, wt, strides=(stride, stride), **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), k2.cpu().numpy())


@pytest.mark.gpu
def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((4, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 8), dtype=torch.int8, device=cuda)
    kw = dict(act_scale=0.1, act_zp=0,
              w_scale=torch.ones(8, device=cuda),
              colsum=torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tmm.qmatmul_fused(x.float(), w, **kw)            # not int8
    with pytest.raises(ValueError):
        tmm.qmatmul_fused(x[:, ::2], w[::2], **kw)       # not contiguous
    xd = torch.zeros((1, 5, 5, 8), dtype=torch.int8, device=cuda)
    wd = torch.zeros((9, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                      # stride 3
        tdw.qdepthwise_folded(xd, wd, None, None, kernel_hw=(3, 3),
                              stride=3, raw_acc=True)
    with pytest.raises(ValueError):                      # weight not (9, C)
        tdw.qdepthwise_folded(xd, wd[:, :4].contiguous(), None, None,
                              kernel_hw=(3, 3), raw_acc=True)


# -- K4 qproj, K5 qtail, K6 qblock -------------------------------------------

def _requant(n, k, dev, zp_out, **kw):
    """Folded coefficients of an affine requant with relu, on ``dev``."""
    return tq.epilogue_coeffs(
        act_scale=0.02, act_zp=int(RNG.integers(-20, 20)),
        w_scale=_dev(RNG.uniform(0.001, 0.01, n).astype(np.float32), dev),
        colsum=_dev(RNG.integers(-127 * k // 8, 127 * k // 8, n).astype(
            np.int32), dev),
        bias=_dev(RNG.standard_normal(n).astype(np.float32), dev),
        requant_scale=0.05, requant_zp=zp_out, relu=True, **kw)


def _i8(dev, *shape):
    return _dev(RNG.integers(-128, 128, shape).astype(np.int8), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hx,Wx,cmid,cin,cout,stride", [
    (1, 7, 8, 16, 32, 64, 1), (2, 9, 10, 64, 64, 256, 2),
    (3, 5, 6, 128, 256, 72, 2), (8, 56, 56, 64, 64, 256, 1),
    (1, 14, 14, 512, 1024, 2048, 2), (2, 28, 28, 128, 256, 512, 2)])
def test_qproj_kernel_matches_plain(cuda, B, Hx, Wx, cmid, cin, cout,
                                    stride):
    H, W = -(-Hx // stride), -(-Wx // stride)
    b, x = _i8(cuda, B, H, W, cmid), _i8(cuda, B, Hx, Wx, cin)
    w3, wd = _i8(cuda, cout, cmid), _i8(cuda, cout, cin)
    co3, mode3 = _requant(cout, cmid, cuda, -3, res_f32=True)
    cod, _ = tq.epilogue_coeffs(
        act_scale=0.03, act_zp=-4,
        w_scale=_dev(RNG.uniform(0.001, 0.01, cout).astype(np.float32),
                     cuda),
        colsum=_dev(RNG.integers(-2000, 2000, cout).astype(np.int32), cuda))
    n0 = tproj.qproj_folded.launches
    got = tproj.qproj_folded(b, x, w3, wd, co3, mode3, cod, stride=stride)
    torch.cuda.synchronize()
    assert tproj.qproj_folded.launches == n0 + 1
    ref = tproj.qproj_folded_plain(b, x, w3, wd, co3, mode3, cod,
                                   stride=stride)
    assert got.dtype == ref.dtype == torch.int8
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hin,Win,cmid,cout,pad", [
    (1, 7, 8, 16, 64, 1), (2, 9, 10, 64, 256, 1), (3, 5, 6, 32, 40, 1),
    (2, 14, 14, 256, 1024, 1), (1, 7, 7, 512, 2048, 1),
    (2, 8, 9, 48, 192, 0), (1, 3, 3, 16, 64, 0)])
def test_qtail_kernel_matches_plain(cuda, B, Hin, Win, cmid, cout, pad):
    H, W = Hin + 2 * pad - 2, Win + 2 * pad - 2
    a, r = _i8(cuda, B, Hin, Win, cmid), _i8(cuda, B, H, W, cout)
    w2, w3 = _i8(cuda, cmid, 9 * cmid), _i8(cuda, cout, cmid)
    co2, mode2 = _requant(cmid, 9 * cmid, cuda, 7)
    co3, mode3 = _requant(cout, cmid, cuda, -3, res_scale=0.03, res_zp=6)
    zp = int(RNG.integers(-20, 20))
    n0 = ttail.qtail_folded.launches
    got = ttail.qtail_folded(a, r, w2, w3, co2, mode2, co3, mode3, pad=pad,
                             zp=zp)
    torch.cuda.synchronize()
    assert ttail.qtail_folded.launches == n0 + 1
    ref = ttail.qtail_folded_plain(a, r, w2, w3, co2, mode2, co3, mode3,
                                   pad=pad, zp=zp)
    assert got.shape == ref.shape == (B, H, W, cout)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cin,cmid", [
    (1, 7, 8, 64, 16), (2, 9, 10, 256, 64), (3, 5, 6, 48, 32),
    (2, 14, 14, 1024, 256), (1, 7, 7, 2048, 512), (2, 1, 2, 64, 16)])
def test_qblock_kernel_matches_plain(cuda, B, H, W, cin, cmid):
    x = _i8(cuda, B, H, W, cin)
    w1, w2, w3 = (_i8(cuda, cmid, cin), _i8(cuda, cmid, 9 * cmid),
                  _i8(cuda, cin, cmid))
    co1, mode1 = _requant(cmid, cin, cuda, 11)
    co2, mode2 = _requant(cmid, 9 * cmid, cuda, 7)
    co3, mode3 = _requant(cin, cmid, cuda, -3, res_scale=0.03, res_zp=6)
    zp2 = int(RNG.integers(-20, 20))
    n0 = tblock.qblock_folded.launches
    got = tblock.qblock_folded(x, w1, w2, w3, co1, mode1, co2, mode2, co3,
                               mode3, zp2=zp2)
    torch.cuda.synchronize()
    assert tblock.qblock_folded.launches == n0 + 1
    ref = tblock.qblock_folded_plain(x, w1, w2, w3, co1, mode1, co2, mode2,
                                     co3, mode3, zp2=zp2)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
def test_fused_wrappers_refuse_bad_inputs(cuda):
    co, mode = _requant(64, 16, cuda, 0)
    co16, mode16 = _requant(16, 16, cuda, 0)
    a = _i8(cuda, 1, 4, 4, 16)
    with pytest.raises(ValueError):                      # residual shape
        ttail.qtail_folded(a, _i8(cuda, 1, 3, 4, 64), _i8(cuda, 16, 144),
                           _i8(cuda, 64, 16), co16, mode16, co, mode)
    with pytest.raises(ValueError):                      # Cmid % 16
        ttail.qtail_folded(_i8(cuda, 1, 4, 4, 8), _i8(cuda, 1, 4, 4, 64),
                           _i8(cuda, 8, 72), _i8(cuda, 64, 8), co16, mode16,
                           co, mode)
    with pytest.raises(ValueError):                      # not int8
        tproj.qproj_folded(a.float(), a, _i8(cuda, 64, 16), _i8(cuda, 64, 16),
                           co, mode, co)
    with pytest.raises(ValueError):                      # stride 3
        tproj.qproj_folded(a[:, :2, :2].contiguous(), a, _i8(cuda, 64, 16),
                           _i8(cuda, 64, 16), co, mode, co, stride=3)
    with pytest.raises(ValueError):                      # conv1 shape
        tblock.qblock_folded(_i8(cuda, 1, 4, 4, 64), _i8(cuda, 16, 32),
                             _i8(cuda, 16, 144), _i8(cuda, 64, 16), co16,
                             mode16, co16, mode16, co, mode, zp2=0)


# -- K7 qstage, K8 qstage_proj, K9 qivr ---------------------------------------

def _fold(n, k, dev, **kw):
    """Folded coefficients onto an affine grid with a random zero point."""
    return tq.epilogue_coeffs(
        act_scale=0.02, act_zp=int(RNG.integers(-20, 20)),
        w_scale=_dev(RNG.uniform(0.001, 0.01, n).astype(np.float32), dev),
        colsum=_dev(RNG.integers(-127 * k // 8, 127 * k // 8, n).astype(
            np.int32), dev),
        bias=_dev(RNG.standard_normal(n).astype(np.float32), dev),
        requant_scale=0.05, requant_zp=int(RNG.integers(-30, 30)), **kw)


def _zp():
    return int(RNG.integers(-128, 40))


def _stage_chain(dev, n, cin, cmid):
    """Weights and coefficients of ``n`` identity bottlenecks."""
    w = (_i8(dev, n, cmid, cin), _i8(dev, n, cmid, 9 * cmid),
         _i8(dev, n, cin, cmid))
    co = tstage.stack_chain([
        (_fold(cmid, cin, dev, relu=True),
         _fold(cmid, 9 * cmid, dev, relu=True),
         _fold(cin, cmid, dev, relu=True, res_scale=0.03, res_zp=6), _zp())
        for _ in range(n)])
    return w, co


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cin,cmid,n", [
    (1, 4, 4, 64, 16, 1), (3, 5, 5, 128, 32, 2), (1, 7, 7, 256, 64, 3),
    (3, 7, 7, 64, 16, 4), (1, 5, 5, 32, 16, 5), (3, 5, 6, 48, 24, 2),
    (2, 14, 14, 1024, 256, 2), (1, 7, 7, 2048, 512, 1)])
def test_qstage_kernel_matches_plain(cuda, B, H, W, cin, cmid, n):
    (w1, w2, w3), co = _stage_chain(cuda, n, cin, cmid)
    x = _i8(cuda, B, H, W, cin)
    n0 = tstage.qstage_folded.launches
    got = tstage.qstage_folded(x, w1, w2, w3, co)
    torch.cuda.synchronize()
    assert tstage.qstage_folded.launches == n0 + 1
    ref = tstage.qstage_folded_plain(x, w1, w2, w3, co)
    assert got.shape == ref.shape == x.shape
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,cp,cm,co,cmid,n", [
    (1, 7, 7, 64, 64, 256, 64, 2), (3, 5, 5, 32, 16, 64, 16, 1),
    (1, 4, 4, 48, 24, 40, 24, 1), (3, 4, 5, 128, 32, 96, 32, 3)])
def test_qstage_proj_kernel_matches_plain(cuda, B, H, W, cp, cm, co, cmid,
                                          n):
    wp = (_i8(cuda, cm, cp), _i8(cuda, cm, 9 * cm), _i8(cuda, co, cm),
          _i8(cuda, co, cp))
    pco = tstage.stack_chain([(
        _fold(cm, cp, cuda, relu=True), _fold(cm, 9 * cm, cuda, relu=True),
        _fold(co, cm, cuda, relu=True, res_f32=True), _zp())])
    cod, _ = tq.epilogue_coeffs(
        act_scale=0.03, act_zp=-4,
        w_scale=_dev(RNG.uniform(0.001, 0.01, co).astype(np.float32), cuda),
        colsum=_dev(RNG.integers(-2000, 2000, co).astype(np.int32), cuda))
    (w1, w2, w3), cco = _stage_chain(cuda, n, co, cmid)
    x = _i8(cuda, B, H, W, cp)
    args = (x, *wp, pco, cod, w1, w2, w3, cco)
    n0 = tstage.qstage_proj_folded.launches
    got = tstage.qstage_proj_folded(*args)
    torch.cuda.synchronize()
    assert tstage.qstage_proj_folded.launches == n0 + 1
    ref = tstage.qstage_proj_folded_plain(*args)
    assert got.shape == ref.shape == (B, H, W, co)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


def _ivr_run(dev, n, c, e):
    """Weights and coefficients of ``n`` inverted residuals."""
    w = (_i8(dev, n, e, c), _i8(dev, n, 9, e), _i8(dev, n, c, e))
    return w, tstage.stack_chain([
        (_fold(e, c, dev, relu=True, act_max=6.0),
         _fold(e, 9, dev, relu=True, act_max=6.0),
         _fold(c, e, dev, res_scale=0.03, res_zp=6), _zp())
        for _ in range(n)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,c,e,n", [
    (1, 4, 4, 24, 144, 1), (3, 5, 5, 24, 144, 2), (1, 7, 7, 160, 960, 2),
    (3, 7, 7, 32, 192, 3), (1, 5, 5, 64, 384, 5), (3, 4, 4, 96, 576, 4),
    (1, 5, 6, 40, 240, 2)])
def test_qivr_kernel_matches_plain(cuda, B, H, W, c, e, n):
    (w1, wd, w3), co = _ivr_run(cuda, n, c, e)
    x = _i8(cuda, B, H, W, c)
    n0 = tivr.qivr_folded.launches
    got = tivr.qivr_folded(x, w1, wd, w3, co)
    torch.cuda.synchronize()
    assert tivr.qivr_folded.launches == n0 + 1
    ref = tivr.qivr_folded_plain(x, w1, wd, w3, co)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
def test_chained_kernels_in_a_cuda_graph(cuda):
    """The cooperative launches are captured and replayed by a CUDA graph,
    several in a row, with the results of eager launches."""
    (w1, w2, w3), co = _stage_chain(cuda, 3, 64, 16)
    x = _i8(cuda, 3, 7, 7, 64)
    (v1, vd, v3), vco = _ivr_run(cuda, 2, 24, 144)
    y = _i8(cuda, 3, 5, 5, 24)

    def run():
        return (tstage.qstage_folded(x, w1, w2, w3, co),
                tivr.qivr_folded(y, v1, vd, v3, vco))
    eager = [t.cpu() for t in run()]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [run() for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for pair in outs:
            for got, ref in zip(pair, eager):
                np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.gpu
def test_chained_wrappers_refuse_bad_inputs(cuda):
    (w1, w2, w3), co = _stage_chain(cuda, 2, 64, 16)
    with pytest.raises(ValueError):                      # channels
        tstage.qstage_folded(_i8(cuda, 1, 4, 4, 32), w1, w2, w3, co)
    with pytest.raises(ValueError):                      # coefficient rows
        tstage.qstage_folded(_i8(cuda, 1, 4, 4, 64), w1[:1].contiguous(),
                             w2[:1].contiguous(), w3[:1].contiguous(), co)
    (v1, vd, v3), vco = _ivr_run(cuda, 1, 16, 72)
    with pytest.raises(ValueError):                      # E % 16
        tivr.qivr_folded(_i8(cuda, 1, 4, 4, 16), v1, vd, v3, vco)
