"""K4 (qproj) on K1's TMA + wgmma ring and K8 (qstage_proj) on the wgmma
runner: their routing, K8's plan and the kernels.

On the CPU (Tier-1): ``k4_path`` and ``stage_proj_path`` at every ResNet-50
and ResNet-101 projection shape (all ``"wgmma"``) and at each shape their
rules refuse (``"igemm"``); ``chain_plan``'s K8 kind (``"stage_proj"``) at
ResNet-50's layer1 on a 132-SM card — the plan, its shared memory worked
by hand, its phases (the projection's P0-P2, then the chain's); the
wrappers' checks of shapes, strides and plans; and the plain versions
against the unfused K1/K2 sequence they stand for.

On the card (``gpu``-marked, skipped without one): K4 at ResNet-50's four
projection blocks (strides 1 and 2), B = 1, 2, 8 and 128, and at odd
inputs (Hx = 7 → 4), and K8 at layer1 with 1, 2 and 3 chained blocks,
both chain modes and both tiles-a-unit, B = 1, 2, 8 and 128, each on the
new kernel (``launches_wgmma``) equal to the plain version, to the older
kernel forced with ``path="igemm"`` and to the unfused K1/K2 sequence;
both replayed from a CUDA graph.  Every epilogue is the unfused
sequence's, in its order, so every output must be bit-exact.

This file imports no JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_k4k8.py``.
"""
import numpy as np
import pytest
import torch

from qtpu_torch.ops import chain_plan as cp
from qtpu_torch.ops import qmatmul as k1
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops import qproj as k4
from qtpu_torch.ops import qstage as k8
from qtpu_torch.ops.qtail import _sm_count
from qtpu_torch.ops.time_chain import unfused_stage

RNG = np.random.default_rng(10)
SMS = 132
# ResNet-50's and ResNet-101's projection blocks: (block, Hx, Cmid, Cout,
# Cin, stride); the two networks share them
PROJ = (("layer1_0", 56, 64, 256, 64, 1), ("layer2_0", 56, 128, 512, 256, 2),
        ("layer3_0", 28, 256, 1024, 512, 2),
        ("layer4_0", 14, 512, 2048, 1024, 2))
# their whole layer1: (H, Cp, Cm, Co), chained blocks (2 in ResNet-50, 2
# in ResNet-101)
LAYER1 = (56, 64, 64, 256)
BATCHES = (1, 2, 8, 32, 128)


def _coeffs(n, k, dev="cpu", **kw):
    return tq.epilogue_coeffs(
        act_scale=0.02, act_zp=int(RNG.integers(-20, 20)),
        w_scale=torch.tensor(RNG.uniform(0.001, 0.01, n).astype(np.float32),
                             device=dev),
        colsum=torch.tensor(RNG.integers(-127 * k // 8, 127 * k // 8, n)
                            .astype(np.int32), device=dev),
        bias=torch.tensor(RNG.standard_normal(n).astype(np.float32),
                          device=dev), **kw)


def _i8(*shape, dev="cpu", lo=-128):
    return torch.tensor(RNG.integers(lo, 128, shape).astype(np.int8),
                        device=dev)


REQ = dict(requant_scale=0.05, requant_zp=-20, relu=True)


def _proj(B, Hx, cmid, cout, cin, stride, dev="cpu", lo_shift=0.0):
    """K4's operands on random codes: (b, x, w3, wd, co3, mode3, cod)."""
    H = -(-Hx // stride)
    co3, mode3 = _coeffs(cout, cmid, dev, res_f32=True, **REQ)
    if lo_shift:
        co3 = tq.EpilogueCoeffs(A=co3.A, B=co3.B, C=co3.C,
                                lo=co3.lo + lo_shift, hi=co3.hi)
    cod, _ = _coeffs(cout, cin, dev)
    return (_i8(B, H, H, cmid, dev=dev), _i8(B, Hx, Hx, cin, dev=dev),
            _i8(cout, cmid, dev=dev, lo=-127), _i8(cout, cin, dev=dev,
                                                   lo=-127),
            co3, mode3, cod)


def _stage(cp_, cm, co, cmid, n, dev="cpu", zp=-9, lo_shift=0.0):
    """K8's operands but x: (wp1, wp2, wp3, wd, pco, cod, w1, w2, w3, co)."""
    def block(c_in, c_mid, c_out, res):
        return (_coeffs(c_mid, c_in, dev, **REQ),
                _coeffs(c_mid, 9 * c_mid, dev, **REQ),
                _coeffs(c_out, c_mid, dev, **res, **REQ), zp)
    pb = block(cp_, cm, co, dict(res_f32=True))
    if lo_shift:
        (c1, m1), rest = pb[0], pb[1:]
        pb = ((tq.EpilogueCoeffs(A=c1.A, B=c1.B, C=c1.C, lo=c1.lo + lo_shift,
                                 hi=c1.hi), m1), *rest)
    pco = k8.stack_chain([pb])
    cod, _ = _coeffs(co, cp_, dev)
    co_chain = k8.stack_chain([block(co, cmid, co, dict(res_scale=0.04,
                                                        res_zp=-7))
                               for _ in range(n)])
    return (_i8(cm, cp_, dev=dev, lo=-127), _i8(cm, 9 * cm, dev=dev, lo=-127),
            _i8(co, cm, dev=dev, lo=-127), _i8(co, cp_, dev=dev, lo=-127),
            pco, cod, _i8(n, cmid, co, dev=dev, lo=-127),
            _i8(n, cmid, 9 * cmid, dev=dev, lo=-127),
            _i8(n, co, cmid, dev=dev, lo=-127), co_chain)


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("block,Hx,cmid,cout,cin,stride", PROJ)
def test_k4_path_resnet(B, block, Hx, cmid, cout, cin, stride):
    # the shapes alone: k4_path reads shapes, grids and base addresses
    ops = _proj(1, 1, cmid, cout, cin, 1)
    b = torch.empty((B, -(-Hx // stride), -(-Hx // stride), cmid),
                    dtype=torch.int8)
    x = torch.empty((B, Hx, Hx, cin), dtype=torch.int8)
    assert k4.k4_path(b, x, *ops[2:6], stride) == "wgmma"


@pytest.mark.parametrize("cmid,cout,cin,stride,why", [
    (48, 256, 64, 1, "Cmid off 64"), (64, 256, 32, 2, "Cin off 64"),
    (64, 192, 64, 1, "Cout off 128"), (64, 256, 64, 3, "stride 3")])
def test_k4_path_refuses(cmid, cout, cin, stride, why):
    ops = _proj(1, 7, cmid, cout, cin, 1)
    assert k4.k4_path(*ops[:6], stride) == "igemm", why


def test_k4_path_refuses_grid_and_alignment():
    ops = _proj(2, 7, 64, 256, 64, 1)
    assert k4.k4_path(*ops[:6], 1) == "wgmma"
    odd = _proj(2, 7, 64, 256, 64, 1, lo_shift=0.5)
    assert not k1.int_grid(odd[4].lo, odd[4].hi, odd[5].shift)
    assert k4.k4_path(*odd[:6], 1) == "igemm"
    b = torch.zeros(2 * 7 * 7 * 64 + 1, dtype=torch.int8)[1:].reshape(
        2, 7, 7, 64)                  # not 16-byte aligned
    assert k4.k4_path(b, *ops[1:6], 1) == "igemm"


@pytest.mark.parametrize("B", BATCHES)
def test_stage_proj_path_layer1(B):
    H, cp_, cm, co = LAYER1
    ops = _stage(cp_, cm, co, cm, 2)
    x = torch.empty((B, H, H, cp_), dtype=torch.int8)
    assert k8.stage_proj_path(B, H, H, cp_, cm, co, cm, ops[4], ops[-1], 2,
                              x, *ops[:4], sms=SMS) == "wgmma"


@pytest.mark.parametrize("cp_,cm,co,cmid,n,why", [
    (48, 64, 256, 64, 2, "Cp off 64"), (64, 64, 256, 128, 2, "Cm != Cmid"),
    (64, 48, 256, 48, 2, "Cm off 64"), (64, 64, 192, 64, 2, "Co off 128"),
    (64, 64, 256, 64, 0, "no chained block")])
def test_stage_proj_path_refuses(cp_, cm, co, cmid, n, why):
    ops = _stage(cp_, cm, co, cmid, max(n, 1))
    assert k8.stage_proj_path(8, 14, 14, cp_, cm, co, cmid, ops[4], ops[-1],
                              n, *ops[:4], sms=SMS) == "igemm", why


def test_stage_proj_path_refuses_grid_and_alignment():
    ops = _stage(64, 64, 256, 64, 2)
    assert k8.stage_proj_path(8, 14, 14, 64, 64, 256, 64, ops[4], ops[-1], 2,
                              *ops[:4], sms=SMS) == "wgmma"
    odd = _stage(64, 64, 256, 64, 2, lo_shift=0.5)
    assert not k8.int_grids(odd[4])
    assert k8.stage_proj_path(8, 14, 14, 64, 64, 256, 64, odd[4], odd[-1],
                              2, *odd[:4], sms=SMS) == "igemm"
    chain_odd = _stage(64, 64, 256, 64, 2)
    chain_odd = (*chain_odd[:-1], odd[4])      # a chain grid off integers
    assert k8.stage_proj_path(8, 14, 14, 64, 64, 256, 64, ops[4],
                              chain_odd[-1], 2, sms=SMS) == "igemm"
    unaligned = torch.zeros(65, dtype=torch.int8)[1:]
    assert k8.stage_proj_path(8, 14, 14, 64, 64, 256, 64, ops[4], ops[-1],
                              2, unaligned, sms=SMS) == "igemm"


# (B) -> the chain's (mode, tm) behind K8 at layer1 on 132 SMs: K7's rule
K8_PLAN = {1: ("split", 1), 2: ("fused", 1), 8: ("fused", 1),
           32: ("fused", 2), 128: ("fused", 2)}


def _smem_by_hand(stages, nres, tm, split):
    """K8 at layer1 (Co 256, Cm 64): slack, the ring, four output slabs,
    then the residual slabs, the halo (4 chunks a tile) and mid (64 x 64 a
    tile, fused only) — a region at least the td tile's 128 x 128 f32 —
    K1's rows, conv2's and conv3's rows, the barriers."""
    shared = nres * tm * 8192 + tm * 4 * 1664 + (0 if split else
                                                 tm * 64 * 64)
    return (1024 + stages * 8192 + 4 * 8192 + max(shared, 65536) + 2048
            + 8 * (64 + 256) + 512)


@pytest.mark.parametrize("B", BATCHES)
def test_chain_plan_stage_proj_layer1(B):
    H, cp_, cm, co = LAYER1
    plan = cp.chain_plan("stage_proj", B, H, H, co, cm, sms=SMS)
    assert plan is not None
    assert (plan.mode, plan.w, plan.tm) == (*K8_PLAN[B][:1], 64,
                                            K8_PLAN[B][1])
    split = plan.mode == "split"
    assert plan.smem == _smem_by_hand(plan.stages, plan.nres, plan.tm, split)
    assert plan.smem == cp.phase_smem_bytes("stage_proj", co, cm,
                                            tm=plan.tm, stages=plan.stages,
                                            nres=plan.nres, split=split)
    assert plan.smem <= cp.SMEM_LIMIT < plan.smem + cp.STAGE
    # the projection's phases, then the chain's (as K7's plan gives them)
    M, t8 = B * H * H, B * 7 * 7
    proj = (-(-M // 128), -(-t8 // plan.tm), -(-M // 128) * 2)
    k7 = cp.chain_plan("stage", B, H, H, co, cm, sms=SMS)
    assert (k7.mode, k7.tm) == (plan.mode, plan.tm)
    assert plan.tiles == proj + k7.tiles
    assert plan.grid == min(max(plan.tiles), SMS)


def test_phase_smem_bytes_stage_proj():
    # the td tile widens the region where the residual slabs, halo and mid
    # are smaller, and lies over them where they are larger
    small = cp.phase_smem_bytes("stage_proj", 256, 64, tm=1, stages=10,
                                nres=1)
    assert small == cp.phase_smem_bytes("stage", 256, 64, tm=1, stages=10,
                                        nres=1) - (8192 + 4 * 1664 +
                                                   64 * 64) + 65536
    big = dict(tm=2, stages=4, nres=2)
    assert cp.phase_smem_bytes("stage_proj", 2048, 512, **big) == \
        cp.phase_smem_bytes("stage", 2048, 512, **big)


def test_resolve_plan_stage_proj():
    H, cp_, cm, co = LAYER1
    auto = cp.chain_plan("stage_proj", 8, H, H, co, cm, sms=SMS)
    assert k8.resolve_plan(None, "wgmma", "stage_proj", 8, H, H, co, cm,
                           SMS) == auto
    split = cp.chain_plan("stage_proj", 8, H, H, co, cm, sms=SMS,
                          mode="split")
    assert split.mode != auto.mode
    assert k8.resolve_plan(split, "wgmma", "stage_proj", 8, H, H, co, cm,
                           SMS) == split
    with pytest.raises(ValueError):       # K7's plan is not K8's
        k8.resolve_plan(cp.chain_plan("stage", 8, H, H, co, cm, sms=SMS),
                        "wgmma", "stage_proj", 8, H, H, co, cm, SMS)
    with pytest.raises(ValueError):       # another image size
        k8.resolve_plan(split, "wgmma", "stage_proj", 8, 28, 28, co, cm,
                        SMS)
    with pytest.raises(ValueError):       # the older kernel takes none
        k8.resolve_plan(split, "igemm", "stage_proj", 8, H, H, co, cm, SMS)


@pytest.mark.parametrize("stride", [1, 2])
def test_qproj_folded_checks(stride):
    b, x, w3, wd, co3, mode3, cod = _proj(2, 7, 16, 64, 16, stride)
    k4.qproj_folded(b, x, w3, wd, co3, mode3, cod, stride=stride)
    with pytest.raises(ValueError):       # a stride the kernels lack
        k4.qproj_folded(b, x, w3, wd, co3, mode3, cod, stride=3)
    with pytest.raises(ValueError):       # x at this stride is not b's
        k4.qproj_folded(b, x[:, :5], w3, wd, co3, mode3, cod, stride=stride)
    with pytest.raises(ValueError):       # w3 (Cout, Cmid) transposed
        k4.qproj_folded(b, x, w3.t().contiguous(), wd, co3, mode3, cod,
                        stride=stride)
    with pytest.raises(ValueError):       # not NHWC
        k4.qproj_folded(b.reshape(-1, 16), x, w3, wd, co3, mode3, cod,
                        stride=stride)
    with pytest.raises(ValueError):
        k4.qproj_folded(b, x, w3, wd, co3, mode3, cod, stride=stride,
                        path="both")


def test_qstage_proj_folded_checks():
    x = _i8(2, 6, 6, 64)
    ops = _stage(64, 32, 128, 32, 2)
    k8.qstage_proj_folded(x, *ops)
    bad = list(ops)
    bad[1] = ops[1][:, :-32]          # wp2 (Cm, 8 Cm)
    with pytest.raises(ValueError):
        k8.qstage_proj_folded(x, *bad)
    bad = list(ops)
    bad[3] = ops[3].t().contiguous()  # wd (Cp, Co)
    with pytest.raises(ValueError):
        k8.qstage_proj_folded(x, *bad)
    with pytest.raises(ValueError):   # not NHWC
        k8.qstage_proj_folded(x.reshape(-1, 64), *ops)
    with pytest.raises(ValueError):
        k8.qstage_proj_folded(x, *ops, path="both")


@pytest.mark.parametrize("B,Hx,cmid,cout,cin,stride", [
    (2, 7, 64, 256, 64, 2), (3, 9, 32, 128, 64, 1), (1, 5, 16, 64, 32, 2)])
def test_k4_plain_is_the_unfused_pair(B, Hx, cmid, cout, cin, stride):
    """K4's plain version: the downsample's K1 f32 dequant of x at the
    stride, then conv3's K1 with that f32 residual (M = 147, 243, 9 rows:
    none a multiple of 128; Hx = 7 and 5 odd at stride 2)."""
    b, x, w3, wd, co3, mode3, cod = _proj(B, Hx, cmid, cout, cin, stride)
    n0 = k4.qproj_folded_plain.calls
    got = k4.qproj_folded(b, x, w3, wd, co3, mode3, cod, stride=stride)
    assert k4.qproj_folded_plain.calls == n0 + 1
    assert k4.qproj_folded.launches == 0
    xd = x[:, ::stride, ::stride, :].reshape(-1, cin)
    td = k1.qmatmul_folded(xd, wd, cod, k4.DOWN_MODE)
    ref = k1.qmatmul_folded(b.reshape(-1, cmid), w3, co3, mode3, td)
    assert torch.equal(got.reshape(-1, cout), ref)


@pytest.mark.parametrize("B,H,n", [(2, 7, 1), (1, 9, 3), (3, 5, 2)])
def test_k8_plain_is_the_unfused_sequence(B, H, n):
    """K8's plain version against K1 → K2 → K1 f32 downsample → K1 + f32
    residual, then the chain's K1 → K2 → K1 + residual per block (the
    sequence ``time_chain.unfused_stage`` runs on the card)."""
    x = _i8(B, H, H, 64)
    ops = _stage(64, 32, 128, 32, n)
    n0 = k8.qstage_proj_folded_plain.calls
    got = k8.qstage_proj_folded(x, *ops)
    assert k8.qstage_proj_folded_plain.calls == n0 + 1
    assert k8.qstage_proj_folded.launches == 0
    assert torch.equal(got, unfused_stage(x, *ops))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _k4_all_equal(ops, stride):
    """The two-GEMM tile (counted on its kernel) = plain = the older kernel
    forced = the unfused K1 pair."""
    fn = k4.qproj_folded
    before = (fn.launches, fn.launches_wgmma)
    got = fn(*ops, stride=stride)
    assert (fn.launches, fn.launches_wgmma) == (before[0] + 1,
                                                before[1] + 1)
    torch.cuda.synchronize()
    ref = k4.qproj_folded_plain(*ops, stride=stride)
    assert torch.equal(got, ref)
    assert torch.equal(fn(*ops, stride=stride, path="igemm"), ref)
    b, x, w3, wd, co3, mode3, cod = ops
    xd = x[:, ::stride, ::stride, :].contiguous().reshape(-1, x.shape[-1])
    td = k1.qmatmul_folded(xd, wd, cod, k4.DOWN_MODE)
    unf = k1.qmatmul_folded(b.reshape(-1, b.shape[-1]), w3, co3, mode3, td)
    assert torch.equal(unf.reshape(got.shape), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 8, 128])
@pytest.mark.parametrize("block,Hx,cmid,cout,cin,stride", PROJ)
def test_k4_resnet50_blocks(cuda, B, block, Hx, cmid, cout, cin, stride):
    _k4_all_equal(_proj(B, Hx, cmid, cout, cin, stride, dev=cuda), stride)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hx,stride", [(1, 7, 2), (3, 7, 2), (2, 9, 1),
                                         (5, 13, 2), (1, 3, 1)])
@pytest.mark.parametrize("cmid,cout,cin", [(64, 256, 64), (128, 512, 256),
                                           (256, 1024, 512)])
def test_k4_odd_inputs(cuda, B, Hx, stride, cmid, cout, cin):
    """Odd inputs at stride 2 (7 → 4, 13 → 7), M not a multiple of 64 or
    128."""
    _k4_all_equal(_proj(B, Hx, cmid, cout, cin, stride, dev=cuda), stride)


def _k8_all_equal(x, ops, plan=None):
    """K8 on the runner (with ``plan``, forced) = plain = the older kernel
    forced = the unfused sequence; counted on the runner."""
    fn = k8.qstage_proj_folded
    before = (fn.launches, fn.launches_wgmma)
    got = fn(x, *ops, plan=plan)
    assert (fn.launches, fn.launches_wgmma) == (before[0] + 1,
                                                before[1] + 1)
    torch.cuda.synchronize()
    ref = k8.qstage_proj_folded_plain(x, *ops)
    assert torch.equal(got, ref)
    assert torch.equal(fn(x, *ops, path="igemm"), ref)
    assert torch.equal(unfused_stage(x, *ops), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 8, 128])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_k8_layer1(cuda, B, n):
    H, cp_, cm, co = LAYER1
    _k8_all_equal(_i8(B, H, H, cp_, dev=cuda), _stage(cp_, cm, co, cm, n,
                                                      dev=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,tm", [("fused", 1), ("fused", 2),
                                     ("split", 1)])
@pytest.mark.parametrize("B", [1, 2, 8, 128])
def test_k8_every_plan(cuda, mode, tm, B):
    H, cp_, cm, co = LAYER1
    plan = cp.chain_plan("stage_proj", B, H, H, co, cm,
                         sms=_sm_count(cuda.index), mode=mode, tm=tm)
    if plan is None:
        pytest.skip("no layout of this plan fits a block")
    _k8_all_equal(_i8(B, H, H, cp_, dev=cuda),
                  _stage(cp_, cm, co, cm, 2, dev=cuda), plan)


@pytest.mark.gpu
@pytest.mark.parametrize("zp", [-128, 0, 37])
@pytest.mark.parametrize("B,H,W", [(1, 1, 2), (3, 3, 3), (2, 5, 7),
                                   (1, 9, 9), (2, 12, 10)])
def test_k8_ragged_images_and_zero_points(cuda, zp, B, H, W):
    for cp_, cm, co in ((64, 64, 256), (128, 128, 512)):
        ops = _stage(cp_, cm, co, cm, 2, dev=cuda, zp=zp)
        x = _i8(B, H, W, cp_, dev=cuda)
        for mode, tm in (("fused", 1), ("fused", 2), ("split", 1)):
            plan = cp.chain_plan("stage_proj", B, H, W, co, cm,
                                 sms=_sm_count(cuda.index), mode=mode, tm=tm)
            if plan is not None:
                _k8_all_equal(x, ops, plan)


@pytest.mark.gpu
def test_graph_capture(cuda):
    """K4's persistent launch and K8's cooperative one replay from a CUDA
    graph."""
    H, cp_, cm, co = LAYER1
    x8 = _i8(8, H, H, cp_, dev=cuda)
    ops8 = _stage(cp_, cm, co, cm, 2, dev=cuda)
    ops4 = _proj(8, 28, 256, 1024, 512, 2, dev=cuda)
    runs = [lambda: k8.qstage_proj_folded(x8, *ops8),
            lambda: k4.qproj_folded(*ops4, stride=2)]
    for run in runs:
        ref = run()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
