"""qtpu_torch numerics core vs qtpu (fakequant + qops), on the CPU.

Same numpy inputs through both packages.  Tolerances (qtpu/ops/qops.py
exactness notes): integer results bit-exact; int8 codes equal except one
step at fp32 ties on at most 0.1% of elements; folded coefficients, which
both packages compute in float32 in the same order, bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops import fakequant as jfq
from qtpu.ops import qops as jq
from qtpu_torch.ops import fakequant as tfq
from qtpu_torch.ops import qops as tq

RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_codes(a, b, frac=1e-3):
    """Tie rule: equal, except one step on at most ``frac`` of elements."""
    a, b = _np(a).astype(np.int32), _np(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


@pytest.mark.parametrize("bits,signed,symmetric", [
    (8, True, True), (8, True, False), (8, False, False), (4, True, True)])
def test_qrange(bits, signed, symmetric):
    assert (tfq.qrange(bits, signed, symmetric)
            == jfq.qrange(bits, signed, symmetric))


def test_scales_and_qparams():
    amax = RNG.uniform(0.0, 3.0, (7,)).astype(np.float32)
    amax[0] = 0.0
    np.testing.assert_array_equal(_np(tfq.symmetric_scale(_t(amax), 8)),
                                  np.asarray(jfq.symmetric_scale(amax, 8)))
    for lo, hi in ((-1.3, 2.7), (0.4, 5.0), (-3.0, -0.5), (0.0, 0.0)):
        ts, tz = tfq.affine_qparams(lo, hi, 8)
        js, jz = jfq.affine_qparams(lo, hi, 8)
        assert _np(ts) == np.asarray(js) and _np(tz) == np.asarray(jz)
    w = RNG.standard_normal((3, 3, 8, 16)).astype(np.float32)
    for axis in (None, 3):
        np.testing.assert_array_equal(
            _np(tfq.weight_qparams(_t(w), bits=8, channel_axis=axis)),
            np.asarray(jfq.weight_qparams(jnp.asarray(w), bits=8,
                                          channel_axis=axis)))
    np.testing.assert_array_equal(
        _np(tfq.channel_amax(_t(w), 2)),
        np.asarray(jfq.channel_amax(jnp.asarray(w), 2)))


def test_quantize_dequantize_ties():
    s = np.float32(0.05)
    k = RNG.integers(-200, 200, (4096,)).astype(np.float32)
    x = ((k + 0.5) * s).astype(np.float32)            # tie-heavy
    x[:100] = RNG.standard_normal(100).astype(np.float32)
    for zp, signed, sym in ((0.0, True, True), (3.0, True, False),
                            (130.0, False, False)):
        tq8 = tfq.quantize(_t(x), s, zp, signed=signed, symmetric=sym)
        jq8 = jfq.quantize(x, s, zp, signed=signed, symmetric=sym)
        np.testing.assert_array_equal(_np(tq8), np.asarray(jq8))
        np.testing.assert_array_equal(
            _np(tfq.dequantize(tq8, s, zp)),
            np.asarray(jfq.dequantize(jq8, s, zp)))


def test_int4_pack_roundtrip_matches_qtpu():
    q = RNG.integers(-7, 8, (6, 10)).astype(np.int8)
    for axis in (-1, 0):
        tp = tfq.pack_int4(_t(q), axis=axis)
        np.testing.assert_array_equal(
            _np(tp), np.asarray(jfq.pack_int4(jnp.asarray(q), axis=axis)))
        np.testing.assert_array_equal(_np(tfq.unpack_int4(tp, axis=axis)), q)
    with pytest.raises(ValueError):
        tfq.pack_int4(_t(q[:, :9]))


@pytest.mark.parametrize("symmetric,zp", [(False, -5), (False, 120),
                                          (True, 0)])
def test_quantize_act_matches_qtpu_on_ties(symmetric, zp):
    s = np.float32(0.037)
    k = RNG.integers(-300, 300, (8, 9, 9, 4)).astype(np.float32)
    x = ((k + 0.5) * s).astype(np.float32)
    x.reshape(-1)[:50] *= 1.7
    got = tq.quantize_act(_t(x), float(s), zp, symmetric=symmetric)
    ref = jq.quantize_act(jnp.asarray(x), jnp.float32(s), jnp.int32(zp),
                          symmetric=symmetric)
    assert got.dtype == torch.int8
    assert_codes(got, ref)
    # a 0-d tensor scale and zero point give the same codes
    got_t = tq.quantize_act(_t(x), torch.tensor(s), torch.tensor(zp),
                            symmetric=symmetric)
    np.testing.assert_array_equal(_np(got_t), _np(got))


EPI_CASES = {
    "f32": dict(),
    "f32_relu_actmax": dict(relu=True, act_max=6.0),
    "f32_res_i8": dict(res_scale=0.03, res_zp=-4),
    "requant_affine_relu": dict(requant_scale=0.05, requant_zp=-3,
                                relu=True),
    "requant_affine_actmax": dict(requant_scale=0.05, requant_zp=7,
                                  relu=True, act_max=6.0),
    "requant_symmetric": dict(requant_scale=0.04),
    "requant_symmetric_flag": dict(requant_scale=0.04, requant_zp=2,
                                   requant_symmetric=True, relu=True),
    "requant_res_i8": dict(requant_scale=0.05, requant_zp=-3, relu=True,
                           res_scale=0.02, res_zp=6),
    "requant_res_f32": dict(requant_scale=0.05, requant_zp=-3, relu=True,
                            res_f32=True),
}


@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("case", sorted(EPI_CASES))
def test_epilogue_coeffs_and_apply(case, per_tensor):
    n = 24
    kw = EPI_CASES[case]
    ws = (np.float32(0.004) if per_tensor
          else RNG.uniform(0.001, 0.01, (n,)).astype(np.float32))
    cs = RNG.integers(-3000, 3000, (n,)).astype(np.int32)
    b = RNG.standard_normal(n).astype(np.float32)
    base = dict(act_scale=0.02, act_zp=5)
    tco, tmode = tq.epilogue_coeffs(w_scale=_t(np.asarray(ws)), colsum=_t(cs),
                                    bias=_t(b), **base, **kw)
    jco, jmode = jq.epilogue_coeffs(
        w_scale=jnp.asarray(ws), colsum=jnp.asarray(cs), bias=jnp.asarray(b),
        act_scale=jnp.float32(0.02), act_zp=jnp.int32(5),
        **{k: (jnp.float32(v) if isinstance(v, float) else v)
           for k, v in kw.items()})
    np.testing.assert_array_equal(_np(tco.A), np.asarray(jco.A))
    np.testing.assert_array_equal(_np(tco.B), np.asarray(jco.B))
    for f in ("C", "lo", "hi"):
        assert np.float32(getattr(tco, f)) == np.asarray(getattr(jco, f)), f
    assert tuple(tmode) == tuple(jmode)
    acc = RNG.integers(-40000, 40000, (64, n)).astype(np.int32)
    res = None
    if "res_scale" in kw:
        res = RNG.integers(-128, 128, (64, n)).astype(np.int8)
    elif kw.get("res_f32"):
        res = RNG.standard_normal((64, n)).astype(np.float32)
    got = tq.apply_epilogue(_t(acc), tco, tmode,
                            residual=None if res is None else _t(res))
    ref = jq.apply_epilogue(jnp.asarray(acc), jco, jmode,
                            residual=None if res is None else jnp.asarray(res))
    if tmode.requant:
        assert got.dtype == torch.int8
        assert_codes(got, ref)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_dequant_epilogue_matches_qtpu():
    acc = RNG.integers(-50000, 50000, (8, 12)).astype(np.int32)
    ws = RNG.uniform(0.001, 0.01, (12,)).astype(np.float32)
    cs = RNG.integers(-900, 900, (12,)).astype(np.int32)
    b = RNG.standard_normal(12).astype(np.float32)
    got = tq.dequant_epilogue(_t(acc), act_scale=0.015, act_zp=-9,
                              w_scale=_t(ws), colsum=_t(cs), bias=_t(b))
    ref = jq.dequant_epilogue(jnp.asarray(acc), act_scale=jnp.float32(0.015),
                              act_zp=jnp.int32(-9), w_scale=jnp.asarray(ws),
                              colsum=jnp.asarray(cs), bias=jnp.asarray(b))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("n,k,s", [(9, 3, 1), (9, 4, 1), (10, 3, 2),
                                   (224, 7, 2), (56, 3, 2), (7, 1, 2)])
def test_same_pads(n, k, s):
    assert tq.same_pads((n, n), (k, k), (s, s)) == jq.same_pads(
        (n, n), (k, k), (s, s))


@pytest.mark.parametrize("padding", ["SAME", "valid", ((1, 1), (1, 1)),
                                     ((0, 2), (3, 0))])
def test_resolve_and_pad_uses_zero_point(padding):
    x = RNG.integers(-100, 100, (2, 7, 8, 3)).astype(np.int8)
    got = tq.resolve_and_pad(_t(x), (3, 3), (2, 2), padding, 7)
    ref = jq.resolve_and_pad(jnp.asarray(x), (3, 3), (2, 2), padding,
                             jnp.int32(7))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_unknown_padding_raises():
    x = _t(np.zeros((1, 4, 4, 2), np.int8))
    with pytest.raises(ValueError, match="unknown padding"):
        tq.resolve_and_pad(x, (3, 3), (1, 1), "SAEM", 0)
    with pytest.raises(ValueError, match="unknown padding"):
        jq.resolve_and_pad(jnp.zeros((1, 4, 4, 2), jnp.int8), (3, 3),
                           (1, 1), "SAEM", jnp.int32(0))


@pytest.mark.parametrize("k,s,padding", [(3, 1, "SAME"), (3, 2, "SAME"),
                                         (1, 2, "VALID"),
                                         (3, 2, ((1, 1), (1, 1))),
                                         (7, 2, "SAME")])
def test_plain_qconv2d_and_qmatmul_exact(k, s, padding):
    x = RNG.integers(-128, 128, (2, 11, 11, 16)).astype(np.int8)
    w = RNG.integers(-127, 128, (k, k, 16, 8)).astype(np.int8)
    got = tq.qconv2d(_t(x), _t(w), strides=(s, s), padding=padding, zp=-3)
    ref = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), strides=(s, s),
                     padding=padding, zp=jnp.int32(-3))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    a = RNG.integers(-128, 128, (33, 2048)).astype(np.int8)
    m = RNG.integers(-127, 128, (2048, 10)).astype(np.int8)
    np.testing.assert_array_equal(
        _np(tq.qmatmul(_t(a), _t(m))),
        np.asarray(jq.qmatmul(jnp.asarray(a), jnp.asarray(m))))
