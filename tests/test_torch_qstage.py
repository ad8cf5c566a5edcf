"""qtpu_torch's chained stage kernels (K7 qstage, K8 qstage_proj) on the CPU,
where their wrappers take the plain versions.

* Port vs qtpu: qtpu's ``qstage_fused`` / ``qstage_proj_fused`` in Pallas
  interpret mode (``k=1``) against the port's call forms on the same numpy
  inputs, both fed qtpu's coefficients: the codes follow the tie rule
  (equal except one step on ≤ 0.1% of elements: XLA may contract the
  interpret-mode epilogue into FMAs, which moves a code at an fp32 tie —
  one of 32,768 in the 8×8, three-block case).  The port's
  ``stage_coeffs`` / ``proj_stage_coeffs`` equal qtpu's to rtol 1e-6.
  Cases: qtpu's own (tests/test_pallas_qstage.py,
  tests/test_pallas_qstage_proj.py) and an odd 5×5 image at B = 1.
* Chained vs unfused in the port: ``fused_ops.stage`` / ``proj_stage`` on
  operands built from prepared nodes are bit-identical to the K1 → K2 →
  K1 (+ K4's pair) sequence the product engine runs, block by block.

The CUDA kernels run only on the card: ``tests/test_torch_gpu_kernels.py``
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops.pallas.qstage import proj_stage_coeffs as j_proj_stage_coeffs
from qtpu.ops.pallas.qstage import qstage_fused as j_qstage
from qtpu.ops.pallas.qstage import qstage_proj_fused as j_qstage_proj
from qtpu.ops.pallas.qstage import stage_coeffs as j_stage_coeffs
from qtpu_torch.ops import qstage as tstage
from qtpu_torch.serve import fused_ops as fo
from qtpu_torch.serve.fused_ops import Grid

RNG = np.random.default_rng(41)
NEXT = (0.019, -3)


def _np_node(kh, ci, co, zp, scale):
    w = RNG.integers(-127, 128, (kh, kh, ci, co)).astype(np.int8)
    return dict(kernel_q=w,
                w_scale=RNG.uniform(0.002, 0.02, co).astype(np.float32),
                colsum=w.astype(np.int32).sum((0, 1, 2)),
                bias=(RNG.standard_normal(co) * 0.1).astype(np.float32),
                act_scale=np.float32(scale), act_zp=np.int32(zp))


def _chain(nblk, cin, cmid):
    """qtpu's test chain: conv1/conv3 grids move along the chain."""
    return [(_np_node(1, cin, cmid, 5 - i, 0.021 + 0.002 * i),
             _np_node(3, cmid, cmid, -17 + i, 0.013),
             _np_node(1, cmid, cin, 9, 0.017 - 0.001 * i))
            for i in range(nblk)]


def _proj(cp, cm, co):
    c1 = _np_node(1, cp, cm, 3, 0.02)
    down = dict(_np_node(1, cp, co, 0, 0.02), act_scale=c1["act_scale"],
                act_zp=c1["act_zp"])
    return (c1, _np_node(3, cm, cm, -11, 0.015), _np_node(1, cm, co, 7, 0.018),
            down)


def _j(node):
    return {k: jnp.asarray(v) for k, v in node.items()}


def _t(node):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in node.items()}


def _jt(d):
    """qtpu's operands (jax arrays) as torch tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _codes(*shape):
    return RNG.integers(-128, 128, shape).astype(np.int8)


def assert_codes(a, b, frac=1e-3):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def assert_coeffs(t, j):
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, err_msg=k)


def _chain_weights(blocks):
    cin, cmid = blocks[0][0]["kernel_q"].shape[-2:]
    return dict(
        w1=np.stack([c1["kernel_q"].reshape(cin, cmid) for c1, _, _ in blocks]),
        w2=np.concatenate([c2["kernel_q"].reshape(9, cmid, cmid)
                           for _, c2, _ in blocks]),
        w3=np.stack([c3["kernel_q"].reshape(cmid, cin) for _, _, c3 in blocks]))


def _j_next():
    return (jnp.float32(NEXT[0]), jnp.int32(NEXT[1]))


@pytest.mark.parametrize("B,H,cin,cmid,nblk", [
    (2, 7, 256, 64, 2), (2, 8, 256, 128, 3), (4, 4, 128, 128, 1),
    (1, 5, 64, 32, 2)])
def test_qstage_matches_qtpu(B, H, cin, cmid, nblk):
    blocks = _chain(nblk, cin, cmid)
    jco = j_stage_coeffs([tuple(_j(n) for n in b) for b in blocks], _j_next())
    tco = tstage.stage_coeffs([tuple(_t(n) for n in b) for b in blocks], NEXT)
    assert_coeffs(tco, jco)
    w = _chain_weights(blocks)
    x = _codes(B * H * H, cin)
    ref = j_qstage(jnp.asarray(x), **w, **jco, h=H, w=H, k=1, interpret=True)
    n0 = tstage.qstage_folded_plain.calls
    got = tstage.qstage_fused(torch.from_numpy(x),
                              **{k: torch.from_numpy(v) for k, v in w.items()},
                              **_jt(jco), h=H, w=H)
    assert tstage.qstage_folded_plain.calls == n0 + 1
    assert tstage.qstage_folded.launches == 0
    assert got.dtype == torch.int8
    assert_codes(got.numpy(), ref)


@pytest.mark.parametrize("B,H,cp,cm,co,cmid,nblk", [
    (2, 7, 64, 64, 256, 64, 2), (2, 5, 128, 64, 256, 128, 1),
    (3, 7, 64, 32, 128, 32, 3)])
def test_qstage_proj_matches_qtpu(B, H, cp, cm, co, cmid, nblk):
    proj = _proj(cp, cm, co)
    blocks = _chain(nblk, co, cmid)
    jco = j_proj_stage_coeffs(tuple(_j(n) for n in proj),
                              [tuple(_j(n) for n in b) for b in blocks],
                              _j_next())
    tco = tstage.proj_stage_coeffs(tuple(_t(n) for n in proj),
                                   [tuple(_t(n) for n in b) for b in blocks],
                                   NEXT)
    assert_coeffs(tco, jco)
    c1, c2, c3, down = proj
    w = dict(_chain_weights(blocks), wp1=c1["kernel_q"].reshape(cp, cm),
             wp2=c2["kernel_q"].reshape(9, cm, cm),
             wp3=c3["kernel_q"].reshape(cm, co),
             wd=down["kernel_q"].reshape(cp, co))
    x = _codes(B * H * H, cp)
    ref = j_qstage_proj(jnp.asarray(x), **w, **jco, h=H, w=H, k=1,
                        interpret=True)
    n0 = tstage.qstage_proj_folded_plain.calls
    got = tstage.qstage_proj_fused(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in w.items()},
        **_jt(jco), h=H, w=H)
    assert tstage.qstage_proj_folded_plain.calls == n0 + 1
    assert tstage.qstage_proj_folded.launches == 0
    assert_codes(got.numpy(), ref)


def _prepared(nodes):
    return tuple(fo.prepare_node(_t(n), torch.device("cpu")) for n in nodes)


def _unfused_block(x, c1, c2, c3, nxt):
    """The product engine's identity block: K1 → K2 → K1 + residual."""
    a = fo.gemm_1x1(x, c1, relu=True, requant=c2["grid"],
                    out_dtype=torch.int8)
    b = fo.conv(a, c2, strides=(1, 1), relu=True, requant=c3["grid"])
    return fo.gemm_1x1(b, c3, relu=True, requant=nxt, out_dtype=torch.int8,
                       residual=x, res_grid=c1["grid"])


@pytest.mark.parametrize("B,H,W,cin,cmid,nblk", [
    (2, 5, 6, 64, 16, 3), (1, 4, 4, 32, 32, 1)])
def test_stage_bit_identical_to_unfused(B, H, W, cin, cmid, nblk):
    blocks = [_prepared(b) for b in _chain(nblk, cin, cmid)]
    nxt = Grid(*NEXT)
    x = torch.from_numpy(_codes(B, H, W, cin))
    ref = x
    for i, (c1, c2, c3) in enumerate(blocks):
        tgt = blocks[i + 1][0]["grid"] if i + 1 < nblk else nxt
        ref = _unfused_block(ref, c1, c2, c3, tgt)
    got = fo.stage(x, fo.chain_operands(blocks, nxt))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_proj_stage_bit_identical_to_unfused():
    B, H, W, cp, cm, co, cmid = 2, 5, 4, 32, 16, 64, 16
    c1, c2, c3, down = _prepared(_proj(cp, cm, co))
    blocks = [_prepared(b) for b in _chain(2, co, cmid)]
    nxt = Grid(*NEXT)
    x = torch.from_numpy(_codes(B, H, W, cp))
    a = fo.gemm_1x1(x, c1, relu=True, requant=c2["grid"],
                    out_dtype=torch.int8)
    b = fo.conv(a, c2, strides=(1, 1), relu=True, requant=c3["grid"])
    res = fo.gemm_1x1(x, down, relu=False, requant=None,
                      out_dtype=torch.float32)
    ref = fo.gemm_1x1(b, c3, relu=True, requant=blocks[0][0]["grid"],
                      out_dtype=torch.int8, residual=res, res_grid=None)
    for i, (k1, k2, k3) in enumerate(blocks):
        ref = _unfused_block(ref, k1, k2, k3,
                             blocks[1][0]["grid"] if i == 0 else nxt)
    got = fo.proj_stage(
        x, fo.proj_operands(c1, c2, c3, down, blocks[0][0]["grid"]),
        fo.chain_operands(blocks, nxt))
    assert got.shape == (B, H, W, co)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
