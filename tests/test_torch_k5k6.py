"""K5 (qtail) and K6 (qblock): the wgmma kernel, its plan and its routing.

On the CPU (Tier-1): ``tail_plan``'s choices for ResNet-50's identity
blocks on a 132-SM card, the shared-memory formula of every plan within a
block's 227 KB, ``tail_path``'s routing, and ``ExperimentalResNetInt8Engine``
on a frozen full-depth ResNet-50 tree selecting all 12 identity blocks for
K5 (``use_qtail``) and K6 (``use_qblock``).

On the card (``gpu``-marked, skipped without one): K5 and K6 at each
ResNet-50 stage shape at B = 1, 8 and 32, on the wgmma kernel (``tail_path``'s
choice, counted by ``launches_wgmma``), bit-exact against the plain version
and against the older ``mma.sync`` kernel forced with ``path="igemm"``;
ragged images (1×2, 3×3, H and W off the 8×8 tile) at zero points −128, 0
and 37, K5 with its pads in the kernel (pad 1) and on a prepadded input
(pad 0), every cluster size the channels allow, one and two tiles a
block (an odd tile count leaves a block's second tile outside the
images); the routing counters (Cmid
16, 32, 48 on the older kernel); a CUDA-graph capture of the cluster
launches.  The kernels and the plain versions apply the same epilogue in
the same order, so every output must be bit-exact.

This file imports no JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_k5k6.py``.
"""
import numpy as np
import pytest
import torch

from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn.config import QuantPolicy
from qtpu_torch.ops import qblock as k6
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops import qtail as k5
from qtpu_torch.serve.dispatch import resnet_arch
from qtpu_torch.serve.experimental import ExperimentalResNetInt8Engine
from qtpu_torch.transform import calibrate, freeze

RNG = np.random.default_rng(8)
# ResNet-50's identity blocks: (stage, H, Cmid); Cout = Cin = 4 Cmid
STAGES = (("layer1", 56, 64), ("layer2", 28, 128), ("layer3", 14, 256),
          ("layer4", 7, 512))


# -- on the CPU ---------------------------------------------------------------

# (block, B) -> (cluster size, tiles a block) of layer1-layer4 on 132 SMs
# (the rule in tail_plan's docstring)
PLAN = {
    (False, 1): ((1, 1), (2, 1), (4, 1), (8, 1)),
    (False, 8): ((1, 2), (1, 1), (2, 1), (8, 1)),
    (False, 128): ((1, 2), (1, 2), (1, 2), (1, 1)),
    (True, 1): ((1, 1), (2, 1), (4, 1), (8, 1)),
    (True, 8): ((1, 1), (1, 1), (2, 1), (8, 1)),
    (True, 128): ((1, 1), (1, 1), (1, 2), (1, 1)),
}


@pytest.mark.parametrize("block", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("stage,H,cmid", STAGES)
def test_tail_plan_resnet50(block, B, stage, H, cmid):
    plan = k5.tail_plan(B, H, H, cmid, 4 * cmid, sms=132, block=block)
    assert (plan.cs, plan.tm) == PLAN[(block, B)][
        [st for st, _, _ in STAGES].index(stage)]
    tiles = B * (-(-H // 8)) ** 2
    assert (plan.tiles, plan.grid) == (tiles,
                                       -(-tiles // plan.tm) * plan.cs)
    assert cmid % (64 * plan.cs) == 0 and 4 * cmid % (128 * plan.cs) == 0
    assert k5.MIN_STAGES <= plan.stages <= k5.MAX_STAGES
    assert plan.nc in (1, 2) and 1 <= plan.nres <= k5.MAX_RES
    assert 1 <= plan.per_sm <= 2
    assert plan.smem == k5.wg_smem_bytes(cmid, 4 * cmid, block=block,
                                         stages=plan.stages, cs=plan.cs,
                                         tm=plan.tm, nc=plan.nc,
                                         nres=plan.nres)
    assert plan.nres == min(4, 4 * cmid // plan.cs // 128) or plan.nres < 4
    assert plan.per_sm * (plan.smem + 1024) <= k5.SMEM_SM
    assert plan.rows == (1.0 if H == 56 else H * H / (-(-H // 8) * 8) ** 2)


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("block", [False, True], ids=["K5", "K6"])
def test_every_plan_fits_a_block(sms, block):
    for cmid in (64, 128, 192, 256, 384, 512, 640):
        for cout in (128, 256, 4 * cmid):
            for B in (1, 2, 8, 32, 128, 256):
                for H in (1, 3, 7, 14, 28, 56):
                    for cs, tm in ((None, None), (1, 1), (2, 2), (4, 1),
                                   (8, 2), (1, 2)):
                        if cs and cs > k5.cluster_max(cmid, cout):
                            continue
                        plan = k5.tail_plan(B, H, H + 1, cmid, cout,
                                            sms=sms, block=block, cs=cs,
                                            tm=tm)
                        if plan is None:
                            assert k5.wg_smem_bytes(
                                cmid, cout, block=block, stages=4,
                                cs=cs or 8, tm=tm or 1, nc=1,
                                nres=1) > k5.SMEM_LIMIT
                            continue
                        assert plan.smem <= k5.SMEM_LIMIT
                        assert plan.smem == k5.wg_smem_bytes(
                            cmid, cout, block=block, stages=plan.stages,
                            cs=plan.cs, tm=plan.tm, nc=plan.nc,
                            nres=plan.nres)
                        assert plan.tm == 1 or plan.smem <= \
                            k5.tail_smem_bytes(cmid, cout, block=block) * 2 \
                            + 4 * (k5.STAGE_W + 2 * k5.STAGE_X) + 8 * k5.SLAB
                        assert cs is None or (plan.cs, plan.tm) == (cs, tm)


def test_tail_smem_bytes_is_the_routed_kernels():
    for cmid in (16, 32, 48, 64, 512):
        for block in (False, True):
            got = k5.tail_smem_bytes(cmid, 4 * cmid, block=block)
            want = (k5.wg_smem_bytes(cmid, 4 * cmid, block=block, stages=4,
                                     nc=1, nres=1) if cmid % 64 == 0 else
                    k5.igemm_smem_bytes(cmid, block=block))
            assert got == want <= k5.SMEM_LIMIT


def test_cluster_max_and_forced_sizes():
    assert [k5.cluster_max(c, 4 * c) for c in (64, 128, 256, 512, 1024)] == \
        [1, 2, 4, 8, 8]
    assert k5.cluster_max(512, 256) == 2
    assert k5.tail_plan(8, 7, 7, 64, 64, sms=132) is None   # Cout off 128
    with pytest.raises(ValueError):
        k5.tail_plan(8, 7, 7, 128, 512, sms=132, cs=4)
    with pytest.raises(ValueError):
        k5.tail_plan(8, 7, 7, 512, 2048, sms=132, cs=3)
    with pytest.raises(ValueError):
        k5.tail_plan(8, 7, 7, 512, 2048, sms=132, tm=3)
    assert k5.tail_plan(8, 7, 7, 48, 192, sms=132) is None


def _requant(n, k, dev, zp_out, **kw):
    """Folded coefficients of an affine requant with relu, on ``dev``."""
    return tq.epilogue_coeffs(
        act_scale=0.02, act_zp=int(RNG.integers(-20, 20)),
        w_scale=torch.tensor(RNG.uniform(0.001, 0.01, n).astype(np.float32),
                             device=dev),
        colsum=torch.tensor(RNG.integers(-127 * k // 8, 127 * k // 8, n)
                            .astype(np.int32), device=dev),
        bias=torch.tensor(RNG.standard_normal(n).astype(np.float32),
                          device=dev),
        requant_scale=0.05, requant_zp=zp_out, relu=True, **kw)


def test_tail_path_routing():
    z = torch.zeros(64, dtype=torch.int8)
    co, mode = _requant(256, 64, "cpu", -3)
    for cmid, cout, want in ((64, 256, "wgmma"), (512, 2048, "wgmma"),
                             (48, 192, "igemm"), (16, 64, "igemm"),
                             (64, 72, "igemm"), (64, 64, "igemm")):
        assert k5.tail_path(cmid, cout, co, mode, z) == want
        assert k5.tail_path(cmid, cout, co, mode, z, block=True) == want
    odd = tq.EpilogueCoeffs(A=co.A, B=co.B, C=co.C, lo=co.lo + 0.5, hi=co.hi)
    assert k5.tail_path(64, 256, odd, mode, z) == "igemm"
    assert k5.tail_path(64, 256, co, mode, z[1:17]) == "igemm"  # unaligned
    assert k5.choose(None, "wgmma", "K5") == "wgmma"
    assert k5.choose("igemm", "wgmma", "K5") == "igemm"
    with pytest.raises(ValueError):
        k5.choose("wgmma", "igemm", "K5")


def test_engine_selects_all_identity_blocks():
    """A frozen ResNet-50 (3, 4, 6, 3) at full width: every one of its 12
    identity blocks goes to K5 with ``use_qtail`` and to K6 with
    ``use_qblock``, with folded coefficients."""
    model = get_model("resnet50", num_classes=10, cifar_stem=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    policy = QuantPolicy.int8_ptq(exclude=("stem*",))
    tree = freeze(model, policy, calibrate(model, policy, [x]))
    arch = resnet_arch("resnet50", num_classes=10, image_size=16,
                       cifar_stem=True)
    ident = [name for name, _, j in ExperimentalResNetInt8Engine(
        tree, arch, device="cpu")._block_names() if j > 0]
    assert len(ident) == 12
    for flag, table in (("use_qtail", "_qtail_prep"),
                        ("use_qblock", "_qblock_prep")):
        eng = ExperimentalResNetInt8Engine(tree, arch, device="cpu",
                                           **{flag: True, "use_qproj": True})
        prep = getattr(eng, table)
        assert sorted(prep) == sorted(ident)
        assert all(v is not None for v in prep.values())


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _i8(dev, *shape):
    return torch.tensor(RNG.integers(-128, 128, shape).astype(np.int8),
                        device=dev)


def _counts(fn):
    return fn.launches, fn.launches_wgmma, fn.launches_igemm


def _k5_case(dev, B, Hin, Win, cmid, cout, pad):
    H, W = Hin + 2 * pad - 2, Win + 2 * pad - 2
    a, r = _i8(dev, B, Hin, Win, cmid), _i8(dev, B, H, W, cout)
    w2, w3 = _i8(dev, cmid, 9 * cmid), _i8(dev, cout, cmid)
    co2, mode2 = _requant(cmid, 9 * cmid, dev, 7)
    co3, mode3 = _requant(cout, cmid, dev, -3, res_scale=0.03, res_zp=6)
    return a, r, w2, w3, co2, mode2, co3, mode3


def _k6_case(dev, B, H, W, cin, cmid):
    x = _i8(dev, B, H, W, cin)
    w1, w2, w3 = (_i8(dev, cmid, cin), _i8(dev, cmid, 9 * cmid),
                  _i8(dev, cin, cmid))
    co1, mode1 = _requant(cmid, cin, dev, 11)
    co2, mode2 = _requant(cmid, 9 * cmid, dev, 7)
    co3, mode3 = _requant(cin, cmid, dev, -3, res_scale=0.03, res_zp=6)
    return x, w1, w2, w3, co1, mode1, co2, mode2, co3, mode3


def _fits(B, H, W, cmid, cout, block, cs, tm):
    return k5.tail_plan(B, H, W, cmid, cout, block=block, cs=cs, tm=tm,
                        sms=torch.cuda.get_device_properties(
                            0).multi_processor_count) is not None


def _run_k5(args, *, pad, zp, want, cs=None, tm=None):
    fn = k5.qtail_folded
    c0 = _counts(fn)
    got = fn(*args, pad=pad, zp=zp, cs=cs, tm=tm)
    torch.cuda.synchronize()
    assert _counts(fn) == (c0[0] + 1, c0[1] + (want == "wgmma"),
                           c0[2] + (want == "igemm"))
    ref = k5.qtail_folded_plain(*args, pad=pad, zp=zp)
    old = fn(*args, pad=pad, zp=zp, path="igemm")
    assert got.dtype == ref.dtype == torch.int8 and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref.cpu()), "K5 differs from plain"
    assert torch.equal(got, old), "K5's kernels differ"


def _run_k6(args, *, zp2, want, cs=None, tm=None):
    fn = k6.qblock_folded
    c0 = _counts(fn)
    got = fn(*args, zp2=zp2, cs=cs, tm=tm)
    torch.cuda.synchronize()
    assert _counts(fn) == (c0[0] + 1, c0[1] + (want == "wgmma"),
                           c0[2] + (want == "igemm"))
    ref = k6.qblock_folded_plain(*args, zp2=zp2)
    old = fn(*args, zp2=zp2, path="igemm")
    assert torch.equal(got.cpu(), ref.cpu()), "K6 differs from plain"
    assert torch.equal(got, old), "K6's kernels differ"


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("stage,H,cmid", STAGES)
def test_k5_resnet50_stages(cuda, B, stage, H, cmid):
    args = _k5_case(cuda, B, H, H, cmid, 4 * cmid, 1)
    _run_k5(args, pad=1, zp=-9, want="wgmma")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("stage,H,cmid", STAGES)
def test_k6_resnet50_stages(cuda, B, stage, H, cmid):
    args = _k6_case(cuda, B, H, H, 4 * cmid, cmid)
    _run_k6(args, zp2=-9, want="wgmma")


@pytest.mark.gpu
@pytest.mark.parametrize("tm", [1, 2])
@pytest.mark.parametrize("zp", [-128, 0, 37])
@pytest.mark.parametrize("B,Hin,Win,cmid,cout,pad,cs", [
    (2, 1, 2, 64, 256, 1, 1), (1, 3, 3, 128, 256, 1, 2),
    (2, 9, 10, 256, 512, 1, 4), (1, 5, 13, 512, 1024, 1, 8),
    (1, 5, 6, 64, 128, 0, 1), (2, 11, 10, 128, 256, 0, 2),
    (1, 4, 4, 512, 1024, 0, 8)])
def test_k5_ragged_zero_points_clusters(cuda, tm, zp, B, Hin, Win, cmid,
                                        cout, pad, cs):
    args = _k5_case(cuda, B, Hin, Win, cmid, cout, pad)
    H, W = Hin + 2 * pad - 2, Win + 2 * pad - 2
    if _fits(B, H, W, cmid, cout, False, cs, tm):
        _run_k5(args, pad=pad, zp=zp, want="wgmma", cs=cs, tm=tm)
    else:       # two 512-channel tiles a block: more shared memory than fits
        with pytest.raises(ValueError, match="no wgmma plan"):
            k5.qtail_folded(*args, pad=pad, zp=zp, cs=cs, tm=tm)


@pytest.mark.gpu
@pytest.mark.parametrize("tm", [1, 2])
@pytest.mark.parametrize("zp2", [-128, 0, 37])
@pytest.mark.parametrize("B,H,W,cin,cmid,cs", [
    (2, 1, 2, 256, 64, 1), (1, 3, 3, 512, 128, 2), (2, 9, 10, 512, 256, 4),
    (1, 5, 13, 1024, 512, 8), (3, 7, 7, 128, 64, 1), (1, 2, 17, 256, 128, 2)])
def test_k6_ragged_zero_points_clusters(cuda, tm, zp2, B, H, W, cin, cmid,
                                        cs):
    args = _k6_case(cuda, B, H, W, cin, cmid)
    if _fits(B, H, W, cmid, cin, True, cs, tm):
        _run_k6(args, zp2=zp2, want="wgmma", cs=cs, tm=tm)
    else:
        with pytest.raises(ValueError, match="no wgmma plan"):
            k6.qblock_folded(*args, zp2=zp2, cs=cs, tm=tm)


@pytest.mark.gpu
@pytest.mark.parametrize("cmid", [16, 32, 48])
def test_narrow_channels_take_the_older_kernel(cuda, cmid):
    _run_k5(_k5_case(cuda, 2, 9, 10, cmid, 4 * cmid, 1), pad=1, zp=5,
            want="igemm")
    _run_k6(_k6_case(cuda, 2, 9, 10, 4 * cmid, cmid), zp2=5, want="igemm")
    with pytest.raises(ValueError):
        k5.qtail_folded(*_k5_case(cuda, 1, 4, 4, cmid, 64, 1), path="wgmma")


@pytest.mark.gpu
def test_cluster_kernels_capture_in_a_cuda_graph(cuda):
    a5 = _k5_case(cuda, 2, 7, 7, 512, 2048, 1)
    a6 = _k6_case(cuda, 2, 14, 14, 1024, 256)

    def run():
        return (k5.qtail_folded(*a5, pad=1, zp=-4),
                k6.qblock_folded(*a6, zp2=3))

    want = [t.clone() for t in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    c0 = (_counts(k5.qtail_folded), _counts(k6.qblock_folded))
    with torch.cuda.graph(graph):
        got = run()
    assert _counts(k5.qtail_folded)[1] == c0[0][1] + 1
    assert _counts(k6.qblock_folded)[1] == c0[1][1] + 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
