"""qtpu_torch's im2col conv vs qtpu's ``qconv2d_im2col``, on the CPU.

The cases of tests/test_qim2col.py ((2, 2)/7/3 — the 7×7×3 stem shape,
K = 147 padded to 160 —, (1, 1)/3/16, (2, 2)/3/32), inputs from numpy with
a seed, qtpu's Pallas GEMM in interpret mode.  The port's op (patches +
K1's plain version on the CPU) and its plain version (the direct conv)
must equal qtpu's output exactly, in f32 and in requant mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops.pallas.qim2col import qconv2d_im2col as j_im2col
from qtpu_torch.ops import qim2col, qmatmul


@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("strides,k,ci", [((2, 2), 7, 3), ((1, 1), 3, 16),
                                          ((2, 2), 3, 32)])
def test_im2col_matches_qtpu(strides, k, ci, requant):
    B, H, Co = 2, 16, 32
    rng = np.random.default_rng(k * 100 + ci)
    xq = rng.integers(-127, 128, (B, H, H, ci)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, ci, Co)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, (Co,)).astype(np.float32)
    cs = wq.astype(np.int32).sum((0, 1, 2))
    b = rng.standard_normal(Co).astype(np.float32)
    kw = dict(act_scale=np.float32(0.02), act_zp=np.int32(6))
    if requant:
        kw.update(requant_scale=np.float32(0.05), requant_zp=np.int32(-3))
    ref = np.asarray(j_im2col(
        jnp.asarray(xq), jnp.asarray(wq), strides=strides,
        w_scale=jnp.asarray(ws), colsum=jnp.asarray(cs), bias=jnp.asarray(b),
        relu=requant, out_dtype=jnp.int8 if requant else jnp.float32,
        interpret=True, **{n: jnp.asarray(v) for n, v in kw.items()}))
    kw["relu"] = requant
    tkw = dict(kw, w_scale=torch.from_numpy(ws), colsum=torch.from_numpy(cs),
               bias=torch.from_numpy(b))
    x_t, w_t = torch.from_numpy(xq), torch.from_numpy(wq)
    n0 = qmatmul.qmatmul_folded_plain.calls
    l0 = qim2col.qconv2d_im2col.launches
    got = qim2col.qconv2d_im2col(x_t, w_t, strides=strides, **tkw)
    assert qmatmul.qmatmul_folded_plain.calls == n0 + 1   # one GEMM
    assert qim2col.qconv2d_im2col.launches == l0          # no launch on the CPU
    assert got.dtype == (torch.int8 if requant else torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        qim2col.qconv2d_im2col_plain(x_t, w_t, strides=strides,
                                     **tkw).numpy(), ref)


def test_im2col_pads_k_to_16_with_zeros():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -128, 128, (1, 9, 9, 3)).astype(np.int8))
    w = torch.ones((7, 7, 3, 8), dtype=torch.int8)
    p = qim2col.im2col_patches(x, (7, 7), (2, 2), -5)
    wk = qim2col.im2col_weight(w)
    assert p.shape == (25, 160) and wk.shape == (8, 160)
    assert not p[:, 147:].any() and not wk[:, 147:].any()
    # SAME pads of the first output pixel's top-left taps hold the zero point
    assert p[0, 0].item() == -5
