"""K7 (qstage) and K9 (qivr) on the wgmma runner: the plan, its routing and
the kernels.

On the CPU (Tier-1): ``chain_plan``'s choices for ResNet-50's identity runs
and MobileNet-v2's inverted-residual runs on a 132-SM card, the shared-
memory formula of every plan within a block's 227 KB, ``stage_path`` and
``ivr_path``'s routing, and frozen full-depth ResNet-50 and MobileNet-v2
trees whose chained runs all route to the runner (MobileNet-v2's block2,
C = 24, on its narrow-row path).

On the card (``gpu``-marked, skipped without one): at every run of both
engines at B = 1, 8 and 128, the runner (``launches_wgmma``) equal to the
plain version, to the older kernel forced with ``path="igemm"`` and to the
unfused K1/K2/K3 sequence; both modes and both tiles-a-block of every run;
ragged images (1×2, 3×3, 5×7, 9×9, 12×10) at zero points −128, 0 and 37;
chains of 1-5 blocks; K9's narrow rows (C = 24 and 8: bulk copies and 3D
maps) at ragged images and zero points; a CUDA-graph capture.  Every epilogue is the unfused sequence's, in its order, so every
output must be bit-exact.  ResNet-50's layer3 run at B = 128 (five blocks,
every phase's outputs read back by TMA on other SMs after a grid barrier)
is the row that catches a missing proxy fence.

This file imports no JAX, so it runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_k7k9.py``.
"""
import numpy as np
import pytest
import torch

from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn.config import QuantPolicy
from qtpu_torch.ops import chain_plan as cp
from qtpu_torch.ops import qivr as k9
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops import qstage as k7
from qtpu_torch.ops.qtail import _sm_count
from qtpu_torch.serve.dispatch import resnet_arch
from qtpu_torch.serve.experimental import (ExperimentalMobileNetV2Int8Engine,
                                           ExperimentalResNetInt8Engine)
from qtpu_torch.transform import calibrate, freeze

RNG = np.random.default_rng(9)
SMS = 132
# ResNet-50's identity runs: (stage, H, Cin, Cmid, blocks)
STAGES = (("layer1", 56, 256, 64, 2), ("layer2", 28, 512, 128, 3),
          ("layer3", 14, 1024, 256, 5), ("layer4", 7, 2048, 512, 2))
# MobileNet-v2's inverted-residual runs: (run, H, C, E, blocks)
RUNS = (("block2", 56, 24, 144, 1), ("block4-5", 28, 32, 192, 2),
        ("block7-9", 14, 64, 384, 3), ("block11-12", 14, 96, 576, 2),
        ("block14-15", 7, 160, 960, 2))


# -- on the CPU ---------------------------------------------------------------

# (B) -> (mode, w, tm) of layer1-layer4 on 132 SMs (chain_plan's rule)
K7_PLAN = {
    1: (("split", 64, 1), ("split", 128, 1), ("split", 128, 1),
        ("split", 128, 1)),
    8: (("fused", 64, 1), ("fused", 128, 1), ("split", 128, 1),
        ("split", 128, 1)),
    128: (("fused", 64, 2), ("fused", 128, 2), ("fused", 128, 2),
          ("fused", 128, 1)),
}
# (B) -> mode of block2 ... block14-15 (K9: w 64, one tile a unit; block2's
# narrow rows fused only)
K9_PLAN = {1: ("fused",) + ("split",) * 4,
           8: ("fused", "fused", "fused", "fused", "split"),
           128: ("fused",) * 5}


def _check_plan(kind, plan, B, H, c, cm):
    split = plan.mode == "split"
    assert plan.smem == cp.phase_smem_bytes(kind, c, cm, tm=plan.tm,
                                            stages=plan.stages,
                                            nres=plan.nres, split=split)
    assert plan.smem <= cp.SMEM_LIMIT
    assert cp.MIN_STAGES <= plan.stages <= cp.MAX_STAGES
    assert plan.nres in (1, 2) and (not split or plan.nres == 2)
    assert plan.tiles == cp.phase_tiles(kind, plan.mode, B, H, H, c, cm,
                                        plan.w, plan.tm)
    assert plan.grid == min(max(plan.tiles), SMS)
    # the ring takes what the rest leaves, up to MAX_STAGES
    assert (plan.stages == cp.MAX_STAGES
            or plan.smem + cp.STAGE > cp.SMEM_LIMIT)


@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("stage,H,cin,cmid,n", STAGES)
def test_chain_plan_resnet50(B, stage, H, cin, cmid, n):
    plan = cp.chain_plan("stage", B, H, H, cin, cmid, sms=SMS)
    want = K7_PLAN[B][[s[0] for s in STAGES].index(stage)]
    assert (plan.mode, plan.w, plan.tm) == want
    _check_plan("stage", plan, B, H, cin, cmid)


@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("run,H,c,e,n", RUNS)
def test_chain_plan_mobilenet_v2(B, run, H, c, e, n):
    plan = cp.chain_plan("ivr", B, H, H, c, e, sms=SMS)
    assert (plan.mode, plan.w, plan.tm) == (
        K9_PLAN[B][[r[0] for r in RUNS].index(run)], 64, 1)
    _check_plan("ivr", plan, B, H, c, e)


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("kind", ["stage", "ivr"])
def test_every_plan_fits_a_block(sms, kind):
    shapes = ([(cin, cmid) for cmid in (64, 128, 192, 256, 384, 512)
               for cin in (128, 256, 4 * cmid)] if kind == "stage" else
              [(c, e) for c in (16, 32, 64, 96, 160, 320)
               for e in (96, 144, 6 * c)])
    for c, cm in shapes:
        for B in (1, 3, 8, 128):
            for H in (1, 5, 7, 14, 28):
                for mode, tm in ((None, None), ("fused", 1), ("fused", 2),
                                 ("split", 1)):
                    if tm == 2 and kind == "ivr":
                        continue
                    plan = cp.chain_plan(kind, B, H, H + 2, c, cm, sms=sms,
                                         mode=mode, tm=tm)
                    if plan is None:    # the least layout does not fit
                        assert mode is not None and cp.phase_smem_bytes(
                            kind, c, cm, tm=tm, stages=cp.MIN_STAGES,
                            nres=2 if mode == "split" else 1,
                            split=mode == "split") > cp.SMEM_LIMIT
                        continue
                    assert plan.smem <= cp.SMEM_LIMIT
                    assert plan.smem == cp.phase_smem_bytes(
                        kind, c, cm, tm=plan.tm, stages=plan.stages,
                        nres=plan.nres, split=plan.mode == "split")
                    assert mode is None or (plan.mode, plan.tm) == (mode,
                                                                    tm)
                    assert 1 <= plan.grid <= sms


def test_phase_smem_bytes_by_hand():
    # K7 layer1, two tiles a unit, 16 stages, two residual buffers: slack,
    # ring, four output slabs, 2 x 2 residual slabs, two halos of 4
    # chunks, two mids of 64 x 64, K1's rows, conv2's and conv3's rows,
    # barriers
    assert cp.phase_smem_bytes("stage", 256, 64, tm=2, stages=16, nres=2) \
        == (1024 + 16 * 8192 + 4 * 8192 + 4 * 8192 + 2 * 4 * 1664
            + 2 * 64 * 64 + 2048 + 8 * (64 + 256) + 512)
    # K9 block2-like E = 144 pads to 192, C = 24 to 128; split drops mid
    fused = cp.phase_smem_bytes("ivr", 24, 144, tm=1, stages=4, nres=1)
    assert fused == (1024 + 4 * 8192 + 4 * 8192 + 8192 + 64 * 192 + 2048
                     + 8 * (192 + 128) + 512)
    assert cp.phase_smem_bytes("ivr", 24, 144, tm=1, stages=4, nres=1,
                               split=True) == fused - 64 * 192


def test_chain_plan_rejects():
    with pytest.raises(ValueError):
        cp.chain_plan("tail", 8, 7, 7, 256, 64, sms=SMS)
    with pytest.raises(ValueError):
        cp.chain_plan("stage", 8, 7, 7, 256, 64, sms=SMS, mode="both")
    with pytest.raises(ValueError):
        cp.chain_plan("stage", 8, 7, 7, 256, 64, sms=SMS, tm=3)
    with pytest.raises(ValueError):
        cp.chain_plan("ivr", 8, 7, 7, 32, 192, sms=SMS, tm=2)
    with pytest.raises(ValueError):
        cp.chain_plan("stage", 8, 7, 7, 256, 64, sms=SMS, mode="split",
                      tm=2)
    assert cp.chain_plan("stage", 0, 7, 7, 256, 64, sms=SMS) is None
    assert k7.plan_args(cp.chain_plan("stage", 8, 7, 7, 2048, 512,
                                      sms=SMS))[:3] == (1, 128, 1)


def _chain(kind, c, cm, n, dev="cpu", zp=-9, lo_shift=0.0):
    """Random codes' operands of a run: (w1, w2 or wd, w3, ChainCoeffs)."""
    def coeffs(nn, k, **kw):
        return tq.epilogue_coeffs(
            act_scale=0.02, act_zp=int(RNG.integers(-20, 20)),
            w_scale=torch.tensor(RNG.uniform(0.001, 0.01, nn)
                                 .astype(np.float32), device=dev),
            colsum=torch.tensor(RNG.integers(-127 * k // 8, 127 * k // 8, nn)
                                .astype(np.int32), device=dev),
            bias=torch.tensor(RNG.standard_normal(nn).astype(np.float32),
                              device=dev), **kw)

    def i8(*shape):
        return torch.tensor(RNG.integers(-127, 128, shape).astype(np.int8),
                            device=dev)
    req = dict(requant_scale=0.05, requant_zp=-20, relu=True)
    blocks = []
    for _ in range(n):
        if kind == "stage":
            b = (coeffs(cm, c, **req), coeffs(cm, 9 * cm, **req),
                 coeffs(c, cm, res_scale=0.04, res_zp=-7, **req), zp)
        else:
            r6 = dict(relu=True, act_max=6.0, requant_scale=0.05,
                      requant_zp=-128)
            b = (coeffs(cm, c, **r6), coeffs(cm, 9, **r6),
                 coeffs(c, cm, requant_scale=0.05, requant_zp=-20,
                        res_scale=0.04, res_zp=-7), zp)
        if lo_shift:
            (co1, m1), rest = b[0], b[1:]
            b = ((tq.EpilogueCoeffs(A=co1.A, B=co1.B, C=co1.C,
                                    lo=co1.lo + lo_shift, hi=co1.hi), m1),
                 *rest)
        blocks.append(b)
    w2 = i8(n, cm, 9 * cm) if kind == "stage" else i8(n, 9, cm)
    return i8(n, cm, c), w2, i8(n, c, cm), k7.stack_chain(blocks)


def test_stage_path_routing():
    for cin, cmid, want in ((256, 64, "wgmma"), (2048, 512, "wgmma"),
                            (256, 48, "igemm"), (192, 64, "igemm"),
                            (64, 16, "igemm")):
        w1, w2, w3, co = _chain("stage", cin, cmid, 2)
        assert k7.stage_path(8, 14, 14, cin, cmid, co, w1, w2, w3,
                             sms=SMS) == want
    w1, w2, w3, co = _chain("stage", 256, 64, 2, lo_shift=0.5)
    assert not k7.int_grids(co)
    assert k7.stage_path(8, 14, 14, 256, 64, co, w1, sms=SMS) == "igemm"
    w1, w2, w3, co = _chain("stage", 256, 64, 2)
    odd = torch.zeros(65, dtype=torch.int8)[1:]     # not 16-byte aligned
    assert k7.stage_path(8, 14, 14, 256, 64, co, odd, sms=SMS) == "igemm"


def test_ivr_path_routing():
    # narrow rows: C a multiple of 8 up to 32 (8, 24) on the runner; C =
    # 20 (rows not of 8 bytes) and 40 (a 320-byte tile row, past TMA's
    # 256-element box) on the older kernel
    for c, e, want in ((24, 144, "wgmma"), (32, 192, "wgmma"),
                       (160, 960, "wgmma"), (8, 48, "wgmma"),
                       (20, 128, "igemm"), (40, 240, "igemm")):
        w1, wd, w3, co = _chain("ivr", c, e, 2)
        assert k9.ivr_path(8, 14, 14, c, e, co, w1, wd, w3,
                           sms=SMS) == want
    assert k9.narrow_rows(8, 56, 56, 24)
    assert not k9.narrow_rows(1, 3, 3, 24)       # 72-byte image rows
    assert not k9.narrow_rows(8, 14, 14, 32)     # a TMA tensor
    assert cp.chain_plan("ivr", 8, 56, 56, 24, 144, sms=SMS,
                         mode="split") is None
    w1, wd, w3, co = _chain("ivr", 32, 192, 2, lo_shift=0.5)
    assert k9.ivr_path(8, 14, 14, 32, 192, co, w1, sms=SMS) == "igemm"


def test_resolve_plan():
    """A wrapper's ``plan``: chain_plan's for the shape by default; a
    forced one only where chain_plan gives it for this shape; none on the
    older kernel."""
    auto = cp.chain_plan("stage", 8, 14, 14, 1024, 256, sms=SMS)
    assert k7.resolve_plan(None, "wgmma", "stage", 8, 14, 14, 1024, 256,
                           SMS) == auto
    fused = cp.chain_plan("stage", 8, 14, 14, 1024, 256, sms=SMS,
                          mode="fused")
    assert fused.mode == "fused" != auto.mode
    assert k7.resolve_plan(fused, "wgmma", "stage", 8, 14, 14, 1024, 256,
                           SMS) == fused
    assert k7.resolve_plan(None, "igemm", "stage", 8, 14, 14, 1024, 256,
                           SMS) is None
    for bad in (("wgmma", 8, 28, 1024, 256),     # another image size
                ("wgmma", 8, 14, 2048, 512),     # other widths
                ("igemm", 8, 14, 1024, 256)):    # the older kernel
        path, B, H, c, cm = bad
        with pytest.raises(ValueError):
            k7.resolve_plan(fused, path, "stage", B, H, H, c, cm, SMS)
    split = cp.chain_plan("ivr", 8, 56, 56, 32, 192, sms=SMS, mode="split")
    with pytest.raises(ValueError):     # block2's narrow rows run fused
        k7.resolve_plan(split, "wgmma", "ivr", 8, 56, 56, 24, 144, SMS)


@pytest.fixture(scope="module")
def frozen_engines():
    """Frozen full-depth ResNet-50 (3, 4, 6, 3) and MobileNet-v2 trees at
    full width, random weights, calibrated on two small images."""
    policy = QuantPolicy.int8_ptq(exclude=("stem*",))
    out = {}
    for name, hw, kw in (("resnet50", 16, dict(cifar_stem=True)),
                         ("mobilenet_v2", 32, {})):
        model = get_model(name, num_classes=10, **kw)
        init_weights(model, torch.Generator().manual_seed(0))
        model.eval()
        x = np.random.default_rng(0).standard_normal((2, hw, hw, 3)).astype(
            np.float32)
        out[name] = freeze(model, policy, calibrate(model, policy, [x]))
    arch = resnet_arch("resnet50", num_classes=10, image_size=16,
                       cifar_stem=True)
    stage = ExperimentalResNetInt8Engine(out["resnet50"], arch, device="cpu",
                                         use_qstage=True, qstage_proj=True,
                                         use_qproj=True)
    ivr = ExperimentalMobileNetV2Int8Engine(out["mobilenet_v2"],
                                            num_classes=10, device="cpu",
                                            use_qivr=True)
    return stage, ivr


@pytest.mark.parametrize("B", [8, 128])
def test_engine_routes_every_chained_run(frozen_engines, B):
    """ResNet-50's four runs and MobileNet-v2's five go to the runner at
    the 224² models' sizes (layer1's run behind K8, whose chain the same
    operands feed; block2's C = 24 on its narrow-row path)."""
    stage, ivr = frozen_engines
    prep = stage._qstage_prep
    assert {i: p["nrun"] for i, p in prep.items()} == {0: 2, 1: 3, 2: 5,
                                                       3: 2}
    for i, (_, H, cin, cmid, n) in enumerate(STAGES):
        run = prep[i]["run"]
        assert tuple(run.w1.shape) == (n, cmid, cin)
        assert k7.stage_path(B, H, H, cin, cmid, run.co, run.w1, run.w2,
                             run.w3, sms=SMS) == "wgmma"
    runs = ivr._qivr_prep
    assert {i: p["nrun"] for i, p in runs.items()} == {2: 1, 4: 2, 7: 3,
                                                       11: 2, 14: 2}
    for (i, p), (label, H, c, e, n) in zip(sorted(runs.items()), RUNS):
        run = p["run"]
        assert tuple(run.w1.shape) == (n, e, c)
        assert k9.ivr_path(B, H, H, c, e, run.co, run.w1, run.w2, run.w3,
                           sms=SMS) == "wgmma"


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _x(dev, B, H, W, c):
    return torch.tensor(RNG.integers(-128, 128, (B, H, W, c)).astype(
        np.int8), device=dev)


def _plan(kind, x, ops, **kw):
    """``chain_plan``'s plan for ``x`` and ``ops`` on this card with the
    forced ``mode`` / ``tm`` in ``kw``."""
    B, H, W, c = x.shape
    return cp.chain_plan(kind, B, H, W, c, ops[0].shape[1],
                         sms=_sm_count(x.device.index), **kw)


def _all_equal(kind, x, ops, **kw):
    """The runner (with ``kw``, ``mode`` and / or ``tm``: the plan they
    force) = plain = the older kernel = the unfused sequence; the runner's
    launch counted on its kernel."""
    from qtpu_torch.ops.time_chain import unfused
    fn, plain = ((k7.qstage_folded, k7.qstage_folded_plain)
                 if kind == "stage" else
                 (k9.qivr_folded, k9.qivr_folded_plain))
    before = (fn.launches, fn.launches_wgmma, fn.launches_igemm)
    got = fn(x, *ops, plan=_plan(kind, x, ops, **kw) if kw else None)
    path = "wgmma" if fn.launches_wgmma > before[1] else "igemm"
    assert fn.launches == before[0] + 1
    torch.cuda.synchronize()
    ref = plain(x, *ops)
    assert torch.equal(got, ref)
    assert torch.equal(fn(x, *ops, path="igemm"), ref)
    assert torch.equal(unfused("K7" if kind == "stage" else "K9", x, *ops),
                       ref)
    return path


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("stage,H,cin,cmid,n", STAGES)
def test_k7_engine_runs(cuda, B, stage, H, cin, cmid, n):
    ops = _chain("stage", cin, cmid, n, dev=cuda)
    assert _all_equal("stage", _x(cuda, B, H, H, cin), ops) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("run,H,c,e,n", RUNS)
def test_k9_engine_runs(cuda, B, run, H, c, e, n):
    ops = _chain("ivr", c, e, n, dev=cuda)
    assert _all_equal("ivr", _x(cuda, B, H, H, c), ops) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("mode,tm", [("fused", 1), ("fused", 2),
                                     ("split", 1)])
@pytest.mark.parametrize("stage,H,cin,cmid,n", STAGES)
def test_k7_every_plan(cuda, mode, tm, stage, H, cin, cmid, n):
    if cp.chain_plan("stage", 8, H, H, cin, cmid, sms=SMS, mode=mode,
                     tm=tm) is None:
        pytest.skip("no layout of this plan fits a block")
    ops = _chain("stage", cin, cmid, n, dev=cuda)
    assert _all_equal("stage", _x(cuda, 8, H, H, cin), ops, mode=mode,
                      tm=tm) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("run,H,c,e,n", RUNS[1:])
def test_k9_every_plan(cuda, mode, run, H, c, e, n):
    ops = _chain("ivr", c, e, n, dev=cuda)
    assert _all_equal("ivr", _x(cuda, 8, H, H, c), ops, mode=mode) == \
        "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("zp", [-128, 0, 37])
@pytest.mark.parametrize("B,H,W", [(1, 1, 2), (3, 3, 3), (2, 5, 7),
                                   (1, 9, 9), (2, 12, 10)])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_ragged_images_and_zero_points(cuda, zp, B, H, W, mode):
    for kind, c, cm in (("stage", 256, 64), ("stage", 512, 128),
                        ("ivr", 32, 192), ("ivr", 96, 144)):
        ops = _chain(kind, c, cm, 2, dev=cuda, zp=zp)
        tms = (1, 2) if kind == "stage" and mode == "fused" else (1,)
        for tm in tms:
            kw = dict(mode=mode, tm=tm) if kind == "stage" else \
                dict(mode=mode)
            assert _all_equal(kind, _x(cuda, B, H, W, c), ops, **kw) == \
                "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_chains_of_one_to_five_blocks(cuda, n):
    for kind, c, cm, H in (("stage", 512, 128, 14), ("ivr", 64, 384, 14)):
        ops = _chain(kind, c, cm, n, dev=cuda)
        for B in (2, 8):
            assert _all_equal(kind, _x(cuda, B, H, H, c), ops) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("zp", [-128, 0, 37])
@pytest.mark.parametrize("B,H,W", [(8, 56, 56), (1, 3, 2), (2, 5, 10),
                                   (1, 9, 6), (3, 7, 2)])
def test_narrow_rows(cuda, zp, B, H, W):
    """K9 on rows TMA cannot address (block2's C = 24, and C = 8): x's and
    w1's rows by bulk copies, the residual and output by 3D maps."""
    for c, e, n in ((24, 144, 1), (24, 144, 3), (8, 48, 2)):
        ops = _chain("ivr", c, e, n, dev=cuda, zp=zp)
        assert _all_equal("ivr", _x(cuda, B, H, W, c), ops) == "wgmma"
    # the split mode takes TMA rows: a split plan (of C = 32) is refused
    x32 = _x(cuda, B, H, W, 32)
    split = _plan("ivr", x32, _chain("ivr", 32, 192, 1, dev=cuda),
                  mode="split")
    assert split is not None
    with pytest.raises(ValueError):
        k9.qivr_folded(_x(cuda, B, H, W, 24), *_chain("ivr", 24, 144, 1,
                                                      dev=cuda),
                       plan=split)


@pytest.mark.gpu
def test_graph_capture(cuda):
    """The runner's cooperative launches replay from a CUDA graph (the
    grid barrier keeps no state across launches but a zero count)."""
    cases = [("stage", _x(cuda, 8, 14, 14, 1024),
              _chain("stage", 1024, 256, 5, dev=cuda)),
             ("ivr", _x(cuda, 8, 7, 7, 160),
              _chain("ivr", 160, 960, 2, dev=cuda))]
    for kind, x, ops in cases:
        fn = k7.qstage_folded if kind == "stage" else k9.qivr_folded
        ref = fn(x, *ops)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(x, *ops)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
