"""qtpu_torch K3 (depthwise) plain version vs qtpu, on the CPU.

``qdepthwise_folded_plain`` — which the K3 wrapper takes for CPU tensors —
against qtpu's Pallas ``qdepthwise_fused`` in interpret mode at stride 1
(mirroring tests/test_pallas_qdepthwise.py), and against qtpu's exact
``qops.qconv2d(groups=C)`` plus its folded epilogue at stride 2, with SAME
and torch-style ((1, 1), (1, 1)) pads, relu6 requant and C ∈ {8, 24, 40}
(MobileNet's narrow widths, which take the kernel's scalar path on the
card).  Int32 accumulators and int8 codes must be bit-exact (both sides
apply the same folded formula in float32, step by step), f32 outputs to
rtol 1e-6.

The CUDA kernel runs only on the card: the ``gpu``-marked K3 cases of
tests/test_torch_gpu_kernels.py hold it against this plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops import qops as jq
from qtpu.ops.pallas.qconv import pad_for_conv as j_pad
from qtpu.ops.pallas.qdepthwise import qdepthwise_fused as j_qdw
from qtpu_torch.ops import qdepthwise as tdw
from qtpu_torch.ops import qops as tq
from qtpu_torch.ops.qmatmul import fold

RNG = np.random.default_rng(3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(B=2, H=8, C=128):
    x = RNG.integers(-127, 128, (B, H, H, C)).astype(np.int8)
    w = RNG.integers(-127, 128, (3, 3, 1, C)).astype(np.int8)
    ws = RNG.uniform(0.001, 0.01, (C,)).astype(np.float32)
    cs = w.astype(np.int32).sum((0, 1, 2))
    b = RNG.standard_normal(C).astype(np.float32)
    return x, w, ws, cs, b


@pytest.mark.parametrize("zp", [0, 4])
def test_plain_matches_pallas_f32(zp):
    x, w, ws, cs, b = _setup()
    xp = np.asarray(j_pad(jnp.asarray(x), (3, 3), jnp.int32(zp)))
    ref = j_qdw(jnp.asarray(xp), jnp.asarray(w), act_scale=jnp.float32(0.02),
                act_zp=jnp.int32(zp), w_scale=jnp.asarray(ws),
                colsum=jnp.asarray(cs), bias=jnp.asarray(b), bb=1,
                interpret=True)
    kw = dict(act_scale=0.02, act_zp=zp, w_scale=_t(ws), colsum=_t(cs),
              bias=_t(b))
    got = tdw.qdepthwise_fused_plain(_t(xp), _t(w), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
    # the kernel wrapper takes the plain version for CPU tensors
    launches = tdw.qdepthwise_folded.launches
    np.testing.assert_array_equal(tdw.qdepthwise_fused(_t(xp), _t(w), **kw),
                                  got)
    assert tdw.qdepthwise_folded.launches == launches
    # the raw accumulator is qtpu's grouped conv, exactly
    raw = tdw.qdepthwise_fused_plain(_t(xp), _t(w), raw_acc=True, **kw)
    np.testing.assert_array_equal(
        raw.numpy(), np.asarray(jq.qconv2d(jnp.asarray(x), jnp.asarray(w),
                                           groups=128, zp=jnp.int32(zp))))


def test_plain_matches_pallas_relu_affine_requant():
    x, w, ws, cs, b = _setup(C=64)
    zp = 3
    xp = np.asarray(j_pad(jnp.asarray(x), (3, 3), jnp.int32(zp)))
    ref = j_qdw(jnp.asarray(xp), jnp.asarray(w), act_scale=jnp.float32(0.02),
                act_zp=jnp.int32(zp), w_scale=jnp.asarray(ws),
                colsum=jnp.asarray(cs), bias=jnp.asarray(b),
                requant_scale=jnp.float32(0.05), requant_zp=jnp.int32(-3),
                relu=True, out_dtype=jnp.int8, bb=2, interpret=True)
    got = tdw.qdepthwise_fused_plain(
        _t(xp), _t(w), act_scale=0.02, act_zp=zp, w_scale=_t(ws),
        colsum=_t(cs), bias=_t(b), requant_scale=0.05, requant_zp=-3,
        relu=True)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("C", [8, 24, 40])
@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
@pytest.mark.parametrize("H", [8, 9])
def test_stride2_relu6_requant_matches_qtpu_oracle(C, padding, H):
    """Stride 2, relu6 requant (MobileNet's dw epilogue): qtpu's exact
    grouped conv plus ``epilogue_coeffs``/``apply_epilogue``."""
    x, w, ws, cs, b = _setup(B=2, H=H, C=C)
    zp = -5
    grid = dict(act_scale=0.02, act_zp=zp, requant_scale=0.04,
                requant_zp=-7)
    acc = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), strides=(2, 2),
                     padding=padding, groups=C, zp=jnp.int32(zp))
    co, mode = jq.epilogue_coeffs(
        act_scale=jnp.float32(0.02), act_zp=jnp.int32(zp),
        w_scale=jnp.asarray(ws), colsum=jnp.asarray(cs), bias=jnp.asarray(b),
        requant_scale=jnp.float32(0.04), requant_zp=jnp.int32(-7), relu=True,
        act_max=6.0)
    ref = jq.apply_epilogue(acc, co, mode, out_dtype=jnp.int8)
    tco, tmode = fold(w_scale=_t(ws), colsum=_t(cs), bias=_t(b), relu=True,
                      act_max=6.0, **grid)
    got = tdw.qdepthwise_folded(_t(x), tdw.weight_taps(_t(w)), tco, tmode,
                                kernel_hw=(3, 3), stride=2, padding=padding,
                                zp=zp)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the plain accumulator is qtpu's, and qconv2d(groups=C) takes it
    t_acc = tq.qconv2d(_t(x), _t(w), strides=(2, 2), padding=padding,
                       groups=C, zp=zp)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(acc))


def test_qconv2d_refuses_other_groups():
    x = torch.zeros((1, 5, 5, 8), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="groups=2"):
        tq.qconv2d(x, torch.zeros((3, 3, 4, 8), dtype=torch.int8), groups=2)
    with pytest.raises(ValueError):
        tdw.weight_taps(torch.zeros((3, 3, 2, 8), dtype=torch.int8))
