"""qtpu_torch kernel modules vs the qtpu Pallas kernels, on the CPU.

The port's plain versions (``*_plain``, which the wrappers take for CPU
tensors) against ``qmatmul_fused`` / ``qconv2d_fused`` /
``qconv2d_strided`` in Pallas interpret mode, mirroring
tests/test_pallas_qmatmul.py, test_pallas_qconv.py and
test_qconv_dispatch.py at small shapes.  Tolerances: int32 accumulators
bit-exact; int8 codes equal except one step at fp32 ties (≤ 0.1%); f32
outputs to rtol 1e-6 (atol 1e-6 of the output's scale, for values that
cancel to near zero).

The CUDA kernels themselves run only on the card: the ``gpu``-marked tests
of tests/test_torch_gpu_kernels.py hold them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops import qops as jq
from qtpu.ops.pallas.qconv import qconv2d_fused as j_qconv
from qtpu.ops.pallas.qconv_dispatch import qconv2d_strided as j_strided
from qtpu.ops.pallas.qmatmul import qmatmul_fused as j_qmm
from qtpu_torch.ops import qconv as tconv
from qtpu_torch.ops import qmatmul as tmm
from qtpu_torch.ops.qconv_dispatch import (qconv2d_strided,
                                           qconv2d_strided_plain)

RNG = np.random.default_rng(7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_codes(a, b, frac=1e-3):
    a, b = _np(a).astype(np.int32), _np(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def assert_f32(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-6,
                               atol=1e-6 * float(np.abs(b).max()))


def _mm_setup(M=64, K=256, N=32):
    x = RNG.integers(-127, 128, (M, K)).astype(np.int8)
    w = RNG.integers(-127, 128, (K, N)).astype(np.int8)
    ws = RNG.uniform(0.001, 0.01, (N,)).astype(np.float32)
    cs = w.astype(np.int32).sum(0)
    b = RNG.standard_normal(N).astype(np.float32)
    return x, w, ws, cs, b


def _both(d):
    """(torch kwargs, jax kwargs) from one dict of numpy / python values."""
    tk, jk = {}, {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            tk[k], jk[k] = _t(v), jnp.asarray(v)
        elif k in ("act_zp", "requant_zp"):
            tk[k], jk[k] = v, jnp.int32(v)
        elif k in ("act_scale", "requant_scale", "res_scale", "res_zp"):
            tk[k], jk[k] = v, jnp.float32(v)
        else:
            tk[k] = jk[k] = v
    return tk, jk


MM_CASES = {
    "f32_zp0": dict(act_zp=0),
    "f32_zp5": dict(act_zp=5),
    "f32_zp-7": dict(act_zp=-7),
    "f32_relu_actmax": dict(act_zp=3, relu=True, act_max=6.0),
    "requant_sym": dict(act_zp=5, requant_scale=0.05),
    "requant_affine_relu": dict(act_zp=5, requant_scale=0.05,
                                requant_zp=-3, relu=True),
    "res_i8_requant": dict(act_zp=2, requant_scale=0.05, requant_zp=4,
                           relu=True, res="i8", res_scale=0.03, res_zp=-6.0),
    "res_f32": dict(act_zp=2, res="f32"),
    "res_f32_requant": dict(act_zp=-1, requant_scale=0.06, requant_zp=1,
                            relu=True, res="f32"),
}


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_qmatmul_plain_matches_pallas(case):
    spec = dict(MM_CASES[case])
    res_kind = spec.pop("res", None)
    x, w, ws, cs, b = _mm_setup()
    d = dict(act_scale=0.02, w_scale=ws, colsum=cs, bias=b, **spec)
    if res_kind == "i8":
        d["residual"] = RNG.integers(-128, 128, (64, 32)).astype(np.int8)
    elif res_kind == "f32":
        d["residual"] = RNG.standard_normal((64, 32)).astype(np.float32)
    tk, jk = _both(d)
    requant = "requant_scale" in spec
    out_dtype = jnp.int8 if requant else jnp.float32
    ref = j_qmm(jnp.asarray(x), jnp.asarray(w), bm=32, bn=32, bk=128,
                out_dtype=out_dtype, interpret=True, **jk)
    got = tmm.qmatmul_fused_plain(_t(x), _t(w), **tk)
    if requant:
        assert got.dtype == torch.int8
        assert_codes(got, ref)
    else:
        assert_f32(got, ref)
    # the kernel wrapper takes the plain version for CPU tensors
    launches = tmm.qmatmul_folded.launches
    np.testing.assert_array_equal(_np(tmm.qmatmul_fused(_t(x), _t(w), **tk)),
                                  _np(got))
    assert tmm.qmatmul_folded.launches == launches


def test_qmatmul_raw_acc_exact():
    x, w, ws, cs, b = _mm_setup(M=8, K=2048, N=40)
    got = tmm.qmatmul_fused_plain(_t(x), _t(w), act_scale=0.02, act_zp=3,
                                  w_scale=_t(ws), colsum=_t(cs),
                                  raw_acc=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(jq.qmatmul(jnp.asarray(x), jnp.asarray(w))))


def test_qmatmul_multi_k_and_ragged_shapes():
    """Shapes that do not tile (the kernel masks its ragged edges; the
    plain version has none to mask) hold against qtpu's oracle."""
    x, w, ws, cs, b = _mm_setup(M=37, K=200, N=13)
    kw = dict(act_scale=0.01, act_zp=3, w_scale=ws, colsum=cs, bias=b,
              requant_scale=0.07, requant_zp=-2, relu=True)
    tk, jk = _both(kw)
    jk = {k: v for k, v in jk.items() if k not in ("relu",)}

    def oracle():
        acc = jq.qmatmul(jnp.asarray(x), jnp.asarray(w))
        co, mode = jq.epilogue_coeffs(relu=True, **jk)
        return jq.apply_epilogue(acc, co, mode, out_dtype=jnp.int8)
    assert_codes(tmm.qmatmul_fused_plain(_t(x), _t(w), **tk), oracle())


def _conv_setup(B=2, H=8, Ci=16, Co=16, k=3):
    x = RNG.integers(-127, 128, (B, H, H, Ci)).astype(np.int8)
    w = RNG.integers(-127, 128, (k, k, Ci, Co)).astype(np.int8)
    ws = RNG.uniform(0.001, 0.01, (Co,)).astype(np.float32)
    cs = w.astype(np.int32).sum((0, 1, 2))
    b = RNG.standard_normal(Co).astype(np.float32)
    return x, w, ws, cs, b


CONV_CASES = {
    "f32_zp0": (dict(act_zp=0), dict()),
    "f32_zp5": (dict(act_zp=5), dict()),
    "relu_requant_affine": (dict(act_zp=3, requant_scale=0.04,
                                 requant_zp=-6, relu=True), dict()),
    "requant_symmetric": (dict(act_zp=0, requant_scale=0.05),
                          dict(Ci=8)),
    "5x5": (dict(act_zp=2), dict(H=10, Ci=8, k=5)),
}


# (label, M, K, N, out dtype, residual dtype, requant zp, expected kernel)
K1_PATH_CASES = [
    ("resnet 1x1, int8 residual", 64, 256, 64, torch.int8, torch.int8, -20,
     "wgmma"),
    ("f32 out, f32 residual", 64, 64, 64, torch.float32, torch.float32, None,
     "wgmma"),
    ("raw int32, N = 1000", 8, 2048, 1000, torch.int32, None, None, "wgmma"),
    # M = 64, below the narrow-row kernel's 512 rows: the old loop, or the
    # TMA ring where it can address every row
    ("K = 24 rows of 24 bytes", 64, 24, 64, torch.int8, None, -20, "igemm"),
    ("N = 24 int8 out", 64, 144, 24, torch.int8, None, -20, "igemm"),
    ("N = 24 f32 out (96-byte rows)", 64, 144, 24, torch.float32, None, None,
     "wgmma"),
    ("N = 24 int8 residual, f32 out", 64, 144, 24, torch.float32, torch.int8,
     None, "igemm"),
    ("requant grid off the integers", 64, 64, 64, torch.int8, None, -20.5,
     "igemm"),
    # the same rows at MobileNet-v2's M (B = 8, 56²): the narrow-row kernel
    ("M 25088: K = 24 rows of 24 bytes", 25088, 24, 64, torch.int8, None,
     -20, "wgmma_cp"),
    ("M 25088: N = 24 int8 out", 25088, 144, 24, torch.int8, None, -20,
     "wgmma_cp"),
    ("M 25088: N = 24 f32 out (96-byte rows)", 25088, 144, 24,
     torch.float32, None, None, "wgmma_cp"),
    ("M 25088: N = 24 int8 residual, f32 out", 25088, 144, 24,
     torch.float32, torch.int8, None, "wgmma_cp"),
    ("MNv2 expand K = 24 N = 144 relu6", 25088, 24, 144, torch.int8, None,
     -20, "wgmma_cp"),
    ("M 512, the narrow kernel's least", 512, 24, 144, torch.int8, None, -20,
     "wgmma_cp"),
    ("M 511", 511, 24, 144, torch.int8, None, -20, "igemm"),
    # a batch's fc: fewer than 512 rows, the old loop (or the ring)
    ("LeNet fc3 K = 84 N = 10 raw", 8, 84, 10, torch.int32, None, None,
     "igemm"),
    ("LeNet fc2 K = 120 N = 84 raw", 8, 120, 84, torch.int32, None, None,
     "igemm"),
    ("CIFAR fc K = 512 N = 10 raw, B = 128", 128, 512, 10, torch.int32, None,
     None, "igemm"),
    ("K = 120 N = 84 f32, int8 residual, M 1024", 1024, 120, 84,
     torch.float32, torch.int8, None, "wgmma_cp"),
    ("TMA rows, N = 32 int8 out", 4096, 144, 32, torch.int8, None, -20,
     "wgmma_cp"),
    ("TMA rows, N = 32, M 64: the ring", 64, 144, 32, torch.int8, None, -20,
     "wgmma"),
    ("K = 6: rows of 6 bytes", 64, 6, 64, torch.int8, None, -20, "igemm"),
    ("N = 10 int8 out: rows of 10 bytes", 64, 64, 10, torch.int8, None, -20,
     "igemm"),
    ("N = 10 int8 residual: rows of 10 bytes", 64, 64, 10, torch.float32,
     torch.int8, None, "igemm"),
    ("K = 24 off-integer grid", 64, 24, 144, torch.int8, None, -20.5,
     "igemm"),
]


@pytest.mark.parametrize("case", K1_PATH_CASES, ids=lambda c: c[0])
def test_k1_path_dispatch(case):
    """K1's per-call choice among its three kernels: the TMA + wgmma one
    where TMA can address every operand (16-byte aligned bases, rows that
    are multiples of 16 bytes) and N >= 64 (or M < 512), the narrow-row one
    where every row is a multiple of 4 bytes and M >= 512, both only on an
    integer requant grid; the mma.sync loop otherwise.  Decided from shapes,
    pointers and the folded grid."""
    _, M, K, N, odt, rdt, zp, want = case
    x = torch.zeros((M, K), dtype=torch.int8)
    w = torch.zeros((N, K), dtype=torch.int8)
    res = None if rdt is None else torch.zeros((M, N), dtype=rdt)
    co = mode = None
    if odt == torch.int8:
        from qtpu_torch.ops import qops as tq
        co, mode = tq.epilogue_coeffs(
            act_scale=0.02, act_zp=3, w_scale=torch.full((N,), 0.01),
            colsum=torch.zeros(N, dtype=torch.int32), requant_scale=0.05,
            requant_zp=zp, relu=True)
    assert tmm.k1_path(x, w, odt, res, co, mode) == want


def test_k1_path_unaligned_views_and_int4_rows():
    w = torch.zeros((64, 64), dtype=torch.int8)
    x = torch.zeros((65, 64), dtype=torch.int8)
    assert tmm.k1_path(x[1:], w, torch.float32, None) == "wgmma"  # 64 B on
    xs = torch.zeros((65 * 64 + 8,), dtype=torch.int8)[8:].view(65, 64)
    assert tmm.k1_path(xs, w, torch.float32, None) == "igemm"  # 8 B off
    # from 512 rows on, x 8 B off comes by cp.async on the narrow-row
    # kernel; 2 B off stays on the old loop; so does a residual 4 B off
    # below 512 rows
    xl = torch.zeros((1024 * 64 + 16,), dtype=torch.int8)
    assert tmm.k1_path(xl[8:8 + 1024 * 64].view(1024, 64), w, torch.float32,
                       None) == "wgmma_cp"
    assert tmm.k1_path(xl[2:2 + 1024 * 64].view(1024, 64), w, torch.float32,
                       None) == "igemm"
    r = torch.zeros((65 * 64 + 8,), dtype=torch.float32)[1:4161].view(65, 64)
    assert tmm.k1_path(x[1:], w, torch.float32, r[1:]) == "igemm"
    # the int4 weight's rows hold K/2 bytes: K % 32 == 0 for TMA
    for K, want in ((48, "igemm"), (64, "wgmma"), (96, "wgmma"),
                    (200, "igemm")):
        w4 = torch.zeros((64, K // 2), dtype=torch.int8)
        x = torch.zeros((8, K), dtype=torch.int8)
        assert tmm.k1_path(x, w4, torch.float32, None) == want


def test_k1_forced_path_refused_where_it_cannot_go():
    """path= forces a kernel the operands allow: the narrow-row kernel needs
    4-byte rows and int8 weights, the TMA ring 16-byte rows (any N when
    forced, for a comparison); the old loop takes everything."""
    x24, w24 = (torch.zeros((64, 24), dtype=torch.int8),
                torch.zeros((144, 24), dtype=torch.int8))
    assert tmm._path("wgmma_cp", x24, w24, None, None, torch.int32, True,
                     None) == "wgmma_cp"
    with pytest.raises(ValueError):
        tmm._path("wgmma", x24, w24, None, None, torch.int32, True, None)
    x6, w6 = (torch.zeros((64, 6), dtype=torch.int8),
              torch.zeros((64, 6), dtype=torch.int8))
    with pytest.raises(ValueError):
        tmm._path("wgmma_cp", x6, w6, None, None, torch.int32, True, None)
    assert tmm._path("igemm", x6, w6, None, None, torch.int32, True,
                     None) == "igemm"
    # TMA rows with N = 24: narrow by default, the ring when forced
    x, w = (torch.zeros((1024, 144), dtype=torch.int8),
            torch.zeros((24, 144), dtype=torch.int8))
    assert tmm._path(None, x, w, None, None, torch.int32, True,
                     None) == "wgmma_cp"
    assert tmm._path("wgmma", x, w, None, None, torch.int32, True,
                     None) == "wgmma"
    # int4 weights never take the narrow-row kernel
    w4 = torch.zeros((24, 72), dtype=torch.int8)
    with pytest.raises(ValueError):
        tmm._path("wgmma_cp", x, w4, None, None, torch.int32, True, None)
    with pytest.raises(ValueError):
        tmm._path("bogus", x, w, None, None, torch.int32, True, None)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_qconv_plain_matches_pallas(case):
    spec, shape = CONV_CASES[case]
    x, w, ws, cs, b = _conv_setup(**shape)
    k = w.shape[0]
    d = dict(act_scale=0.02, w_scale=ws, colsum=cs, bias=b, **spec)
    tk, jk = _both(d)
    requant = "requant_scale" in spec
    xp_t = tconv.pad_for_conv(_t(x), (k, k), spec["act_zp"])
    xp_j = jnp.asarray(np.asarray(xp_t))
    ref = j_qconv(xp_j, jnp.asarray(w), bb=1, interpret=True,
                  out_dtype=jnp.int8 if requant else jnp.float32, **jk)
    got = tconv.qconv2d_fused_plain(xp_t, _t(w), **tk)
    if requant:
        assert_codes(got, ref)
    else:
        assert_f32(got, ref)
    launches = tconv.qconv2d_folded.launches
    np.testing.assert_array_equal(
        _np(tconv.qconv2d_fused(xp_t, _t(w), **tk)), _np(got))
    assert tconv.qconv2d_folded.launches == launches
    raw = tconv.qconv2d_fused_plain(xp_t, _t(w), raw_acc=True, **tk)
    np.testing.assert_array_equal(
        _np(raw), np.asarray(jq.qconv2d(jnp.asarray(x), jnp.asarray(w),
                                        zp=jnp.int32(spec["act_zp"]))))


@pytest.mark.parametrize("res", ["i8", "f32"])
def test_qconv_residual_matches_qtpu_oracle(res):
    """K2 takes K1's residual modes; qtpu's conv kernel has none, so the
    oracle is qtpu's exact conv plus its folded epilogue with the residual."""
    x, w, ws, cs, b = _conv_setup()
    r = (RNG.integers(-128, 128, (2, 8, 8, 16)).astype(np.int8) if res == "i8"
         else RNG.standard_normal((2, 8, 8, 16)).astype(np.float32))
    kw = dict(act_scale=0.02, act_zp=3, w_scale=ws, colsum=cs, bias=b,
              requant_scale=0.05, requant_zp=-2, relu=True, residual=r,
              res_scale=0.03, res_zp=-5.0)
    tk, jk = _both(kw)
    got = tconv.qconv2d_fused_plain(tconv.pad_for_conv(_t(x), (3, 3), 3),
                                    _t(w), **tk)
    jres = jk.pop("residual")
    if res == "f32":
        jk.pop("res_scale"), jk.pop("res_zp")
    acc = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), zp=jnp.int32(3))
    co, mode = jq.epilogue_coeffs(res_f32=res == "f32", **jk)
    assert_codes(got, jq.apply_epilogue(acc, co, mode, residual=jres,
                                        out_dtype=jnp.int8))


def test_pad_for_conv_matches_qtpu_even_kernels():
    x = RNG.integers(-100, 100, (2, 9, 9, 4)).astype(np.int8)
    from qtpu.ops.pallas.qconv import pad_for_conv as j_pad
    for k in ((4, 4), (2, 2), (3, 3), (5, 5)):
        np.testing.assert_array_equal(
            _np(tconv.pad_for_conv(_t(x), k, 3)),
            np.asarray(j_pad(jnp.asarray(x), k, jnp.int32(3))))


@pytest.mark.parametrize("KH,Ci,Co,H,padding,requant", [
    (3, 16, 16, 12, "SAME", False),
    (7, 8, 16, 16, "SAME", False),
    (3, 16, 16, 10, "SAME", True),
    (3, 8, 16, 9, ((1, 1), (1, 1)), True),
])
def test_strided_plain_matches_pallas(KH, Ci, Co, H, padding, requant):
    x, w, ws, cs, b = _conv_setup(B=2, H=H, Ci=Ci, Co=Co, k=KH)
    spec = dict(act_scale=0.02, act_zp=-6, w_scale=ws, colsum=cs, bias=b)
    if requant:
        spec.update(requant_scale=0.05, requant_zp=-2, relu=True)
    tk, jk = _both(spec)
    ref = j_strided(jnp.asarray(x), jnp.asarray(w), strides=(2, 2),
                    padding=padding, bb=2, interpret=True, **jk)
    got = qconv2d_strided_plain(_t(x), _t(w), strides=(2, 2),
                                padding=padding, **tk)
    if requant:
        assert got.dtype == torch.int8
        assert_codes(got, ref)
    else:
        assert_f32(got, ref)
    # the stride-2 K2 route (pad, then the kernel's plain version on CPU)
    np.testing.assert_array_equal(
        _np(qconv2d_strided(_t(x), _t(w), strides=(2, 2), padding=padding,
                            **tk)), _np(got))
