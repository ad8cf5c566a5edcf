"""qtpu_torch's fused bottleneck kernels (K4 qproj, K5 qtail, K6 qblock) on
the CPU, where their wrappers take the plain versions.

* Port vs qtpu: qtpu's ``qproj_fused``/``qproj2d_fused``/``qtail_fused``/
  ``qbottleneck_fused`` in Pallas interpret mode (``pair`` 1, and 2 where W
  is even) against the port's call forms on the same numpy inputs.  Codes
  follow the tie rule (equal except one step on ≤ 0.1% of elements: XLA may
  contract the interpret-mode epilogue into FMAs); the folded coefficients
  (``proj_coeffs``/``tail_coeffs``/``block_coeffs``) agree to rtol 1e-6.
* Fused vs unfused in the port: each fused piece of ``serve.fused_ops``
  (``proj``, ``tail``, ``bottleneck``) is bit-identical to the K1/K2
  sequence the product engine runs for the same block.

The CUDA kernels run only on the card: ``tests/test_torch_gpu_kernels.py``
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops.pallas.qblock import block_coeffs as j_block_coeffs
from qtpu.ops.pallas.qblock import qbottleneck_fused as j_qblock
from qtpu.ops.pallas.qproj import proj_coeffs as j_proj_coeffs
from qtpu.ops.pallas.qproj import qproj2d_fused as j_qproj2d
from qtpu.ops.pallas.qproj import qproj_fused as j_qproj
from qtpu.ops.pallas.qtail import qtail_fused as j_qtail
from qtpu.ops.pallas.qtail import tail_coeffs as j_tail_coeffs
from qtpu_torch.ops import qblock as tblock
from qtpu_torch.ops import qproj as tproj
from qtpu_torch.ops import qtail as ttail
from qtpu_torch.serve import fused_ops as fo
from qtpu_torch.serve.fused_ops import Grid

RNG = np.random.default_rng(23)


def _np_node(kh, ci, co, zp, scale):
    w = RNG.integers(-127, 128, (kh, kh, ci, co)).astype(np.int8)
    return dict(kernel_q=w,
                w_scale=RNG.uniform(0.002, 0.02, co).astype(np.float32),
                colsum=w.astype(np.int32).sum((0, 1, 2)),
                bias=(RNG.standard_normal(co) * 0.1).astype(np.float32),
                act_scale=np.float32(scale), act_zp=np.int32(zp))


def _j(node):
    return {k: jnp.asarray(v) for k, v in node.items()}


def _t(node):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in node.items()}


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


NEXT = (0.019, -3)

# (B, H, W, Cmid, Cin): odd H, W = H + 1, Cout = 4·Cmid
SHAPES = [(1, 5, 6, 16, 16), (2, 4, 4, 32, 64), (2, 7, 8, 16, 32)]
# K4's too: 180 rows (90 at stride 2), more than one 128-row tile and not a
# multiple of it
PROJ_SHAPES = SHAPES + [(2, 9, 10, 16, 32)]


@pytest.mark.parametrize("B,H,W,cmid,cin", PROJ_SHAPES)
def test_qproj_matches_qtpu(B, H, W, cmid, cin):
    cout = 4 * cmid
    c3 = _np_node(1, cmid, cout, 9, 0.017)
    down = _np_node(1, cin, cout, -4, 0.023)
    b, xd = _codes(B, H, W, cmid), _codes(B, H, W, cin)
    jco = j_proj_coeffs(_j(c3), _j(down), (jnp.float32(NEXT[0]),
                                           jnp.int32(NEXT[1])))
    tco = tproj.proj_coeffs(_t(c3), _t(down), NEXT)
    assert_coeffs(tco, jco)
    w = dict(w3=c3["kernel_q"].reshape(cmid, cout),
             wd=down["kernel_q"].reshape(cin, cout))
    got = tproj.qproj_fused(torch.from_numpy(b), torch.from_numpy(xd),
                            **{k: torch.from_numpy(v) for k, v in w.items()},
                            **tco).numpy()
    for pair in (1, 2) if W % 2 == 0 else (1,):
        ref = j_qproj(jnp.asarray(b), jnp.asarray(xd), **w, **jco,
                      pair=pair, interpret=True)
        assert_codes(got, ref)
    m = B * H * W
    got2 = tproj.qproj2d_fused(torch.from_numpy(b.reshape(m, cmid)),
                               torch.from_numpy(xd.reshape(m, cin)),
                               **{k: torch.from_numpy(v)
                                  for k, v in w.items()}, **tco).numpy()
    ref2 = j_qproj2d(jnp.asarray(b.reshape(m, cmid)),
                     jnp.asarray(xd.reshape(m, cin)), **w, **jco, bm=m,
                     interpret=True)
    assert_codes(got2, ref2)
    np.testing.assert_array_equal(got2, got.reshape(m, cout))
    # the block input whole at stride 2 (odd sides 2H - 1, 2W - 1: the
    # strided pixels are xd), as the port's engines pass it
    x = _codes(B, 2 * H - 1, 2 * W - 1, cin)
    x[:, ::2, ::2] = xd
    co3, mode3, cod = tproj.unfold_proj(*(tco[k] for k in (
        "scalars", "a3", "b3", "ad", "bd")))
    got3 = tproj.qproj_folded(
        torch.from_numpy(b), torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w["w3"].T)),
        torch.from_numpy(np.ascontiguousarray(w["wd"].T)), co3, mode3, cod,
        stride=2).numpy()
    np.testing.assert_array_equal(got3, got)


@pytest.mark.parametrize("B,H,W,cmid,cin", SHAPES)
def test_qtail_matches_qtpu(B, H, W, cmid, cin):
    cout = 4 * cmid
    c2 = _np_node(3, cmid, cmid, -17, 0.013)
    c3 = _np_node(1, cmid, cout, 9, 0.017)
    res = (0.021, 5)
    a, r = _codes(B, H, W, cmid), _codes(B, H, W, cout)
    a_pad = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)),
                   constant_values=-17)
    jco = j_tail_coeffs(_j(c2), _j(c3), (jnp.float32(NEXT[0]),
                                         jnp.int32(NEXT[1])),
                        (jnp.float32(res[0]), jnp.int32(res[1])))
    tco = ttail.tail_coeffs(_t(c2), _t(c3), NEXT, res)
    assert_coeffs(tco, jco)
    w = dict(w2=c2["kernel_q"].reshape(9, cmid, cmid),
             w3=c3["kernel_q"].reshape(cmid, cout))
    got = ttail.qtail_fused(torch.from_numpy(a_pad), torch.from_numpy(r),
                            **{k: torch.from_numpy(v) for k, v in w.items()},
                            **tco).numpy()
    for pair in (1, 2) if W % 2 == 0 else (1,):
        ref = j_qtail(jnp.asarray(a_pad), jnp.asarray(r), **w, **jco,
                      pair=pair, interpret=True)
        assert_codes(got, ref)


@pytest.mark.parametrize("B,H,W,cmid,cin", SHAPES)
def test_qblock_matches_qtpu(B, H, W, cmid, cin):
    c1 = _np_node(1, cin, cmid, 5, 0.021)
    c2 = _np_node(3, cmid, cmid, -17, 0.013)
    c3 = _np_node(1, cmid, cin, 9, 0.017)
    x = _codes(B, H, W, cin)
    jco = j_block_coeffs(_j(c1), _j(c2), _j(c3), (jnp.float32(NEXT[0]),
                                                  jnp.int32(NEXT[1])))
    tco = tblock.block_coeffs(_t(c1), _t(c2), _t(c3), NEXT)
    assert_coeffs(tco, jco)
    w = dict(w1=c1["kernel_q"].reshape(cin, cmid),
             w2=c2["kernel_q"].reshape(9, cmid, cmid),
             w3=c3["kernel_q"].reshape(cmid, cin))
    got = tblock.qbottleneck_fused(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in w.items()},
        **tco).numpy()
    for pair in (1, 2) if W % 2 == 0 else (1,):
        ref = j_qblock(jnp.asarray(x), **w, **jco, pair=pair, interpret=True)
        assert_codes(got, ref)


def _grid(node):
    return Grid(float(node["act_scale"]), int(node["act_zp"]))


@pytest.mark.parametrize("B,H,W,cmid,cin", PROJ_SHAPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_proj_bit_identical_to_unfused(B, H, W, cmid, cin, stride):
    cout = 4 * cmid
    c3 = _t(_np_node(1, cmid, cout, 9, 0.017))
    down = _t(_np_node(1, cin, cout, -4, 0.023))
    x = torch.from_numpy(_codes(B, H, W, cin))
    x_d = x[:, ::stride, ::stride, :]
    b = torch.from_numpy(_codes(*x_d.shape[:3], cmid))
    n0 = tproj.qproj_folded_plain.calls
    got = fo.proj(b, x, c3, down, strides=(stride, stride),
                  requant=Grid(*NEXT))
    assert tproj.qproj_folded_plain.calls == n0 + 1
    assert tproj.qproj_folded.launches == 0
    res = fo.gemm_1x1(x_d.contiguous(), down, relu=False, requant=None,
                      out_dtype=torch.float32)
    ref = fo.gemm_1x1(b, c3, relu=True, requant=Grid(*NEXT),
                      out_dtype=torch.int8, residual=res, res_grid=None)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("B,H,W,cmid,cin", SHAPES)
def test_tail_and_block_bit_identical_to_unfused(B, H, W, cmid, cin):
    c1 = _t(_np_node(1, cin, cmid, 5, 0.021))
    c2 = _t(_np_node(3, cmid, cmid, -17, 0.013))
    c3 = _t(_np_node(1, cmid, cin, 9, 0.017))
    x = torch.from_numpy(_codes(B, H, W, cin))
    xg, nxt = _grid(c1), Grid(*NEXT)
    a = fo.gemm_1x1(x, c1, relu=True, requant=_grid(c2),
                    out_dtype=torch.int8)
    b = fo.conv(a, c2, strides=(1, 1), relu=True, requant=_grid(c3))
    ref = fo.gemm_1x1(b, c3, relu=True, requant=nxt, out_dtype=torch.int8,
                      residual=x, res_grid=xg)
    n_tail = ttail.qtail_folded_plain.calls
    n_block = tblock.qblock_folded_plain.calls
    tail = fo.tail(a, x, c2, c3, x_grid=xg, requant=nxt)
    block = fo.bottleneck(x, c1, c2, c3, x_grid=xg, requant=nxt)
    assert ttail.qtail_folded_plain.calls == n_tail + 1
    assert tblock.qblock_folded_plain.calls == n_block + 1
    assert ttail.qtail_folded.launches == tblock.qblock_folded.launches == 0
    np.testing.assert_array_equal(tail.numpy(), ref.numpy())
    np.testing.assert_array_equal(block.numpy(), ref.numpy())
