"""qtpu_torch's QAT quantizers against qtpu's, on the CPU: ``fake_quant``
with the pass-through and clip STE, ``fake_quant_pact`` (PACT's learnable
clip, with qtpu's gradients at ties) and ``fake_quant_weight`` (per tensor
and per channel, int8 and int4).

The same seeded numpy inputs go through both.  Values must be bit-equal
(the same float32 operations in the same order).  The gradients with
respect to x and w are masks of 0, 0.5 and 1 times the upstream gradient,
so they must be equal too; PACT's dα is a sum over the tensor, whose order
differs between XLA and PyTorch: rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ops import fakequant as jfq
from qtpu_torch.ops import fakequant as fq

RNG = np.random.default_rng(0)


def _grad_t(fn, x, g):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    (y * torch.tensor(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _grad_j(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


# (name, bits, signed, symmetric, per-channel scale)
GRIDS = [("int8_sym", 8, True, True, False),
         ("uint8_affine", 8, False, False, False),
         ("int4_sym", 4, True, True, False),
         ("int8_affine_signed", 8, True, False, False),
         ("int8_sym_per_channel", 8, True, True, True)]


@pytest.mark.parametrize("ste", ["passthrough", "clip"])
@pytest.mark.parametrize("name,bits,signed,symmetric,per_ch", GRIDS,
                         ids=[g[0] for g in GRIDS])
def test_fake_quant_values_and_grads(name, bits, signed, symmetric, per_ch,
                                     ste):
    x = (RNG.standard_normal((4, 6, 6, 5)) * 3).astype(np.float32)
    g = RNG.standard_normal(x.shape).astype(np.float32)
    if per_ch:
        scale = (RNG.random((1, 1, 1, 5)) * 0.05 + 0.01).astype(np.float32)
    else:
        scale = np.float32(0.037)
    zp = np.float32(0.0 if symmetric else (-3.0 if signed else 101.0))
    kw = dict(bits=bits, signed=signed, symmetric=symmetric, ste=ste)
    yj, dj = _grad_j(lambda v: jfq.fake_quant(v, scale, zp, **kw), x, g)
    yt, dt = _grad_t(lambda v: fq.fake_quant(v, torch.tensor(scale), zp,
                                             **kw), x, g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dt, dj)
    if ste == "clip":
        assert (dt == 0).any() and (dt != 0).any()


def test_no_grad_to_scale_or_zero_point():
    x = torch.tensor(RNG.standard_normal(16).astype(np.float32),
                     requires_grad=True)
    s = torch.tensor(0.05, requires_grad=True)
    zp = torch.tensor(7.0, requires_grad=True)
    fq.fake_quant(x, s, zp, signed=False, symmetric=False).sum().backward()
    assert s.grad is None and zp.grad is None
    assert torch.equal(x.grad, torch.ones(16))


def _pact(x, alpha, g, bits=8, ste="passthrough"):
    def fj(v, a):
        return jfq.fake_quant_pact(v, a, bits=bits, ste=ste)
    yj, vjp = jax.vjp(fj, jnp.asarray(x), jnp.float32(alpha))
    dxj, daj = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(np.float32(alpha), requires_grad=True)
    yt = fq.fake_quant_pact(xt, at, bits=bits, ste=ste)
    (yt * torch.tensor(g)).sum().backward()
    return ((np.asarray(yj), np.asarray(dxj), float(daj)),
            (yt.detach().numpy(), xt.grad.numpy(), float(at.grad)))


def test_pact_ties_match_qtpu():
    """x = [0, 1, 6, 7], α = 6: JAX's clip splits the gradient at x = 0 and
    at x = α — dx = [0.5, 1, 0.5, 0], dα = 1.5 (torch.clamp would give
    [1, 1, 1, 0] and 1)."""
    x = np.array([0.0, 1.0, 6.0, 7.0], np.float32)
    (yj, dxj, daj), (yt, dxt, dat) = _pact(x, 6.0, np.ones(4, np.float32))
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dxt, [0.5, 1.0, 0.5, 0.0])
    np.testing.assert_array_equal(dxt, dxj)
    assert dat == daj == 1.5


@pytest.mark.parametrize("bits,ste", [(8, "passthrough"), (4, "passthrough"),
                                      (8, "clip")])
def test_pact_values_and_grads(bits, ste):
    """ReLU and ReLU6 outputs: many exact zeros and exact sixes (= α)."""
    x = np.clip(RNG.standard_normal((4, 8, 8, 6)) * 4, 0.0, 6.0).astype(
        np.float32)
    x[0, 0, 0, :3] = [7.5, -0.0, 6.0]
    g = RNG.standard_normal(x.shape).astype(np.float32)
    (yj, dxj, daj), (yt, dxt, dat) = _pact(x, 6.0, g, bits, ste)
    assert (x == 0).sum() > 10 and (x == 6).sum() > 10
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dxt, dxj)
    np.testing.assert_allclose(dat, daj, rtol=1e-6)


def test_pact_values_and_alpha_mask():
    """qtpu's test_pact: values on the [0, α] grid, ∂/∂α Σ y = #{x ≥ α}."""
    x = np.array([-0.5, 0.4, 1.0, 1.6, 3.0], np.float32)
    (yj, dxj, daj), (yt, dxt, dat) = _pact(x, 1.5, np.ones(5, np.float32))
    np.testing.assert_array_equal(yt, yj)
    assert dat == daj == 2.0
    np.testing.assert_array_equal(dxt, [0, 1, 1, 0, 0])


@pytest.mark.parametrize("ste", ["passthrough", "clip"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_weight_fake_quant(bits, per_channel, ste):
    """HWIO (qtpu, channel axis 3) against OIHW (the port, axis 0): the
    same values per output channel, bit for bit, and their gradients."""
    w = (RNG.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    g = RNG.standard_normal(w.shape).astype(np.float32)
    yj, dj = _grad_j(lambda v: jfq.fake_quant_weight(
        v, bits=bits, channel_axis=3 if per_channel else None, ste=ste),
        w, g)
    perm = (3, 2, 0, 1)
    yt, dt = _grad_t(lambda v: fq.fake_quant_weight(
        v, bits=bits, channel_axis=0 if per_channel else None, ste=ste),
        w.transpose(perm).copy(), g.transpose(perm).copy())
    back = (2, 3, 1, 0)
    np.testing.assert_array_equal(yt.transpose(back), yj)
    np.testing.assert_array_equal(dt.transpose(back), dj)
    levels = np.unique(np.round(yt / np.abs(yt).max(
        axis=(1, 2, 3) if per_channel else None, keepdims=per_channel)
        * ((1 << (bits - 1)) - 1)))
    assert len(levels) <= (1 << bits) - 1
