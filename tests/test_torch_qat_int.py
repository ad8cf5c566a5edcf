"""qtpu_torch's integer-forward QAT conv (``ops.qat_int``) against qtpu's,
on the CPU (mirrors tests/test_qat_int.py).

The same seeded numpy inputs go through qtpu's ``qat_int_conv`` (NHWC /
HWIO) and the port's (NCHW / OIHW).  The codes, the exact int32
accumulator (float64 here, qtpu's integer conv there) and the
dequantization are the same float32 operations, so the forward is held to
rtol 1e-6 (it is bit-equal in practice).  The gradients are float32 conv
transposes of the dequantized codes, computed by XLA and by PyTorch in
different orders: rtol 1e-5 with an absolute floor of 1e-5 of the largest
value.  On grid inputs (power-of-two scales) the port's integer forward
equals its own fp32 simulation exactly, as qtpu's does; off the grid they
agree to the fp32 accumulation error qtpu's test allows (rtol/atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qtpu.ops import fakequant as jfq
from qtpu.ops.qat_int import qat_int_conv as j_qat_int_conv
from qtpu_torch.nn import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.nn.layers import Conv
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops import qops
from qtpu_torch.ops.qat_int import (conv_kind, int_forward_ok, qat_int_conv,
                                    qat_int_conv_plain)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _grid_inputs(seed, shape, kshape, *, w_bits=8, act_symmetric=False,
                 act_scale=2.0 ** -6, zp_u=30.0):
    """(x NHWC, w HWIO, act_scale, zp_u) exactly on power-of-two grids,
    each output channel's largest weight code pinned to qmax (qtpu's
    recipe)."""
    rng = np.random.default_rng(seed)
    _, qmax = jfq.qrange(w_bits, signed=True, symmetric=True)
    codes = rng.integers(-qmax, qmax + 1, kshape)
    codes[0, 0, 0, :] = qmax
    w = (codes * 2.0 ** -7).astype(np.float32)
    if act_symmetric:
        q = rng.integers(-127, 128, shape)
        return (q * act_scale).astype(np.float32), w, act_scale, 0.0
    q = rng.integers(0, 256, shape)
    return ((q - zp_u) * act_scale).astype(np.float32), w, act_scale, zp_u


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _port(x, w, s, zp, g=None, fn=qat_int_conv, **kw):
    """The port's conv on NHWC/HWIO numpy operands: y NHWC and, given the
    NHWC upstream gradient ``g``, (dx NHWC, dw HWIO)."""
    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    y = fn(xt, wt, torch.tensor(np.float32(s)), torch.tensor(np.float32(zp)),
           **kw)
    out = y.detach().permute(0, 2, 3, 1).numpy()
    if g is None:
        return out
    (y * _nchw(g)).sum().backward()
    return (out, xt.grad.permute(0, 2, 3, 1).numpy(),
            wt.grad.permute(2, 3, 1, 0).numpy())


def _qtpu(x, w, s, zp, g, **kw):
    def f(xx, ww):
        return j_qat_int_conv(xx, ww, jnp.float32(s), jnp.float32(zp), **kw)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


# name, act_symmetric, per_channel, w_bits, strides, padding, groups, kernel
CASES = [
    ("affine_pc_int8", False, True, 8, (1, 1), "SAME", 1, 3),
    ("affine_pt_int8", False, False, 8, (1, 1), "SAME", 1, 3),
    ("symmetric_pc_int8", True, True, 8, (1, 1), "SAME", 1, 3),
    ("affine_pc_int4w", False, True, 4, (1, 1), "SAME", 1, 3),
    ("stride2_valid", False, True, 8, (2, 2), "VALID", 1, 3),
    ("stride2_same", False, True, 8, (2, 2), "SAME", 1, 3),
    ("explicit_pads", False, True, 8, (2, 2), ((1, 1), (1, 1)), 1, 3),
    ("depthwise", False, True, 8, (1, 1), "SAME", 16, 3),
    ("depthwise_stride2", False, True, 8, (2, 2), "SAME", 16, 3),
    ("gemm_1x1", False, True, 8, (1, 1), "SAME", 1, 1),
    ("down_1x1_stride2", True, True, 4, (2, 2), "SAME", 1, 1),
]
IDS = [c[0] for c in CASES]


def _case(name, act_sym, per_ch, w_bits, strides, padding, groups, k,
          seed=7):
    cin, cout = 16, 16
    x, w, s, zp = _grid_inputs(seed, (2, 8, 8, cin),
                               (k, k, cin // groups, cout), w_bits=w_bits,
                               act_symmetric=act_sym)
    kw = dict(a_bits=8, w_bits=w_bits, per_channel=per_ch,
              act_symmetric=act_sym, strides=strides, padding=padding,
              groups=groups)
    return x, w, s, zp, kw


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_grads_match_qtpu(case):
    x, w, s, zp, kw = _case(*case)
    y_shape = _port(x, w, s, zp, **kw).shape
    g = (np.random.default_rng(3).integers(-4, 5, y_shape) * 2.0 ** -4
         ).astype(np.float32)
    yj, dxj, dwj = _qtpu(x, w, s, zp, g, **kw)
    yt, dxt, dwt = _port(x, w, s, zp, g, **kw)
    _close(yt, yj, 1e-6, "y")
    _close(dxt, dxj, 1e-5, "dx")
    _close(dwt, dwj, 1e-5, "dw")


@pytest.mark.parametrize("act_sym", [False, True])
def test_forward_off_grid_matches_qtpu(act_sym):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 24)) * 0.1).astype(np.float32)
    if act_sym:
        s, zp = np.float32(np.abs(x).max() / 127), np.float32(0.0)
    else:
        s, zp = (np.asarray(v) for v in jfq.affine_qparams(x.min(), x.max(),
                                                           8))
    g = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)
    yj, dxj, dwj = _qtpu(x, w, s, zp, g, act_symmetric=act_sym)
    yt, dxt, dwt = _port(x, w, s, zp, g, act_symmetric=act_sym)
    _close(yt, yj, 1e-6, "y")
    _close(dxt, dxj, 1e-5, "dx")
    _close(dwt, dwj, 1e-5, "dw")


def _sim(x, w, s, zp, *, w_bits=8, per_channel=True, act_symmetric=False,
         strides=(1, 1), padding="SAME", groups=1, a_bits=8):
    """The port's fp32 fake-quant simulation of the same conv (NCHW)."""
    xq = fq.fake_quant(x, s, zp, bits=a_bits, signed=act_symmetric,
                       symmetric=act_symmetric)
    wq = fq.fake_quant_weight(w, bits=w_bits,
                              channel_axis=0 if per_channel else None)
    (hlo, hhi), (wlo, whi) = qops.resolve_pads(x.shape[2:], w.shape[2:],
                                               strides, padding)
    return F.conv2d(F.pad(xq, (wlo, whi, hlo, hhi)), wq, stride=strides,
                    groups=groups)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_int_equals_sim_on_grid(case):
    """Exact, forward and both gradients: on grid inputs both sides are
    integer math scaled by powers of two."""
    x, w, s, zp, kw = _case(*case)
    xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    xs, ws = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    st, zt = torch.tensor(np.float32(s)), torch.tensor(np.float32(zp))
    y_int = qat_int_conv(xt, wt, st, zt, **kw)
    y_sim = _sim(xs, ws, st, zt, **kw)
    assert torch.equal(y_int, y_sim)
    g = torch.randint(-4, 5, y_int.shape,
                      generator=torch.Generator().manual_seed(0)) / 16.0
    (y_int * g).sum().backward()
    (y_sim * g).sum().backward()
    assert torch.equal(xt.grad, xs.grad) and torch.equal(wt.grad, ws.grad)


def test_int_close_to_sim_off_grid():
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal((2, 16, 8, 8)).astype(np.float32))
    w = torch.tensor((rng.standard_normal((24, 16, 3, 3)) * 0.1).astype(
        np.float32))
    s, zp = fq.affine_qparams(x.min(), x.max(), 8)
    np.testing.assert_allclose(qat_int_conv(x, w, s, zp).numpy(),
                               _sim(x, w, s, zp).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_entry_equals_the_wrapper_on_cpu():
    x, w, s, zp, kw = _case(*CASES[0])
    a = _port(x, w, s, zp, **kw)
    b = _port(x, w, s, zp, fn=qat_int_conv_plain, **kw)
    np.testing.assert_array_equal(a, b)


def test_grid_params_get_zero_grad():
    x, w, s, zp, _ = _case(*CASES[0])
    st = torch.tensor(np.float32(s), requires_grad=True)
    zt = torch.tensor(np.float32(zp), requires_grad=True)
    qat_int_conv(_nchw(x), _oihw(w), st, zt).sum().backward()
    assert float(st.grad) == 0.0 and float(zt.grad) == 0.0


def test_int_forward_ok_fallback_logic():
    ok_spec = LayerQuantSpec()
    mode = QuantMode.QUANT_EMA
    assert int_forward_ok(ok_spec, mode)
    assert not int_forward_ok(None, mode)
    assert not int_forward_ok(ok_spec, QuantMode.OFF)
    assert not int_forward_ok(ok_spec, QuantMode.CALIB_RANGE)
    assert not int_forward_ok(LayerQuantSpec(ste="clip"), mode)
    assert not int_forward_ok(LayerQuantSpec(act_observer="pact"), mode)
    assert not int_forward_ok(LayerQuantSpec(quantize_weights=False), mode)
    assert not int_forward_ok(LayerQuantSpec(quantize_acts=False), mode)


@pytest.mark.parametrize("kernel,stride,padding,groups,want", [
    ((1, 1), (1, 1), "SAME", 1, "gemm"),
    ((1, 1), (1, 1), "VALID", 1, "gemm"),
    ((1, 1), (2, 2), "SAME", 1, "conv"),
    ((1, 1), (1, 1), ((1, 1), (0, 0)), 1, "conv"),
    ((3, 3), (1, 1), "SAME", 1, "conv"),
    ((3, 3), (2, 2), ((1, 1), (1, 1)), 1, "conv"),
    ((3, 3), (1, 1), "SAME", 32, "depthwise"),
])
def test_conv_kind_routes_as_the_serve_path(kernel, stride, padding, groups,
                                            want):
    """K1 for a 1×1/1 conv without pads, K3 for depthwise, K2 for the rest
    (the module SERVE path's ``kind_of`` calls the same function)."""
    assert conv_kind(kernel, stride, padding, groups, 32, 32) == want


def test_grouped_conv_has_no_kernel():
    with pytest.raises(ValueError, match="grouped"):
        conv_kind((3, 3), (1, 1), "SAME", 2, 32, 32)


def test_conv_layer_int_vs_sim_and_same_state():
    """qtpu's test_quantconv_layer_int_vs_sim: the bias conv on the integer
    forward matches the simulation, and both carry the same state."""
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (2, 8, 8, 8)).astype(np.float32))
    outs, keys = {}, {}
    base = Conv(8, 16, 3)
    for engine in ("sim", "int"):
        m = Conv(8, 16, 3)
        m.load_state_dict(base.state_dict())
        m.set_quant(QuantPolicy.int8_qat(qat_forward=engine), "conv")
        m.train()
        outs[engine] = m(x).detach()
        keys[engine] = sorted(m.state_dict())
    assert keys["sim"] == keys["int"]
    np.testing.assert_allclose(outs["int"].numpy(), outs["sim"].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_conv_layer_int_qat_step_trains():
    """One SGD step through the integer forward changes the weights."""
    x = torch.randn(2, 8, 8, 8, generator=torch.Generator().manual_seed(1))
    m = Conv(8, 16, 3)
    m.set_quant(QuantPolicy.int8_qat(qat_forward="int"), "conv")
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    before = m.conv.weight.detach().clone()
    for _ in range(2):
        loss = (m.train()(x) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert torch.isfinite(loss)
    assert (m.conv.weight.detach() - before).abs().max() > 0
    assert int(m.in_q.count) == 2
