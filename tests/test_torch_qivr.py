"""qtpu_torch's chained inverted-residual kernel (K9 qivr) on the CPU, where
its wrapper takes the plain version.

* Port vs qtpu: qtpu's ``qivr_fused`` in Pallas interpret mode (``k=1``)
  against the port's call form on the same numpy inputs, both fed qtpu's
  operands: the codes follow the tie rule (equal except one step on ≤ 0.1%
  of elements; XLA may contract the interpret-mode epilogue into FMAs).
  The port's ``ivr_coeffs`` equal qtpu's to rtol 1e-6 and its
  ``stack_ivr_weights`` qtpu's exactly.  Cases: qtpu's own
  (tests/test_pallas_qivr.py), MobileNet-v2 block2's C = 24, E = 144 (the
  kernel's bytewise expand) and an odd 5×5 image at B = 1.
* Chained vs unfused in the port: ``fused_ops.ivr`` on operands built from
  prepared nodes is bit-identical to the K1 → K3 → K1 sequence the product
  engine runs, block by block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops.pallas.qivr import ivr_coeffs as j_ivr_coeffs
from qtpu.ops.pallas.qivr import qivr_fused as j_qivr
from qtpu.ops.pallas.qivr import stack_ivr_weights as j_stack
from qtpu_torch.ops import qivr as tivr
from qtpu_torch.serve import fused_ops as fo
from qtpu_torch.serve.fused_ops import Grid

RNG = np.random.default_rng(43)
NEXT = (0.021, -2)


def _np_node(kh, ci, co, zp, scale):
    w = RNG.integers(-127, 128, (kh, kh, ci, co)).astype(np.int8)
    return dict(kernel_q=w,
                w_scale=RNG.uniform(0.002, 0.02, co).astype(np.float32),
                colsum=w.astype(np.int32).sum((0, 1, 2)),
                bias=(RNG.standard_normal(co) * 0.1).astype(np.float32),
                act_scale=np.float32(scale), act_zp=np.int32(zp))


def _chain(nblk, c, e):
    """qtpu's test run: the depthwise on a post-relu6 grid (zp −128)."""
    return [(_np_node(1, c, e, 3 - i, 0.019 + 0.002 * i),
             _np_node(3, 1, e, -128, 0.0235),
             _np_node(1, e, c, 7, 0.016 - 0.001 * i)) for i in range(nblk)]


def _j(node):
    return {k: jnp.asarray(v) for k, v in node.items()}


def _t(node):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in node.items()}


def assert_codes(a, b, frac=1e-3):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


@pytest.mark.parametrize("B,H,c,e,nblk", [
    (2, 7, 160, 960, 2), (2, 8, 64, 384, 3), (4, 4, 32, 192, 1),
    (2, 6, 96, 576, 2), (2, 6, 24, 144, 2), (1, 5, 32, 192, 2)])
def test_qivr_matches_qtpu(B, H, c, e, nblk):
    blocks = _chain(nblk, c, e)
    jb = [tuple(_j(n) for n in b) for b in blocks]
    tb = [tuple(_t(n) for n in b) for b in blocks]
    jco = j_ivr_coeffs(jb, (jnp.float32(NEXT[0]), jnp.int32(NEXT[1])))
    tco = tivr.ivr_coeffs(tb, NEXT)
    assert sorted(tco) == sorted(jco)
    for k in tco:
        np.testing.assert_allclose(tco[k].numpy(), np.asarray(jco[k]),
                                   rtol=1e-6, err_msg=k)
    jw, tw = j_stack(jb), tivr.stack_ivr_weights(tb)
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    x = RNG.integers(-128, 128, (B * H * H, c)).astype(np.int8)
    ref = j_qivr(jnp.asarray(x), **jw, **jco, h=H, w=H, k=1, interpret=True)
    n0 = tivr.qivr_folded_plain.calls
    got = tivr.qivr_fused(torch.from_numpy(x), **tw,
                          **{k: torch.from_numpy(np.array(v))
                             for k, v in jco.items()}, h=H, w=H)
    assert tivr.qivr_folded_plain.calls == n0 + 1
    assert tivr.qivr_folded.launches == 0
    assert got.dtype == torch.int8
    assert_codes(got.numpy(), ref)


@pytest.mark.parametrize("B,H,W,c,e,nblk", [
    (2, 5, 6, 24, 144, 2), (1, 4, 4, 16, 96, 3)])
def test_ivr_bit_identical_to_unfused(B, H, W, c, e, nblk):
    dev = torch.device("cpu")
    blocks = [(fo.prepare_node(_t(c1), dev),
               fo.prepare_node(_t(c2), dev, depthwise=True),
               fo.prepare_node(_t(c3), dev))
              for c1, c2, c3 in _chain(nblk, c, e)]
    nxt = Grid(*NEXT)
    x = torch.from_numpy(RNG.integers(-128, 128, (B, H, W, c)).astype(
        np.int8))
    ref = x
    for i, (ex, dw, pr) in enumerate(blocks):
        tgt = blocks[i + 1][0]["grid"] if i + 1 < nblk else nxt
        y = fo.gemm_1x1(ref, ex, relu=True, act_max=6.0, requant=dw["grid"],
                        out_dtype=torch.int8)
        y = fo.depthwise(y, dw, relu=True, act_max=6.0, requant=pr["grid"])
        ref = fo.gemm_1x1(y, pr, relu=False, requant=tgt,
                          out_dtype=torch.int8, residual=ref,
                          res_grid=ex["grid"])
    got = fo.ivr(x, fo.ivr_operands(blocks, nxt))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
