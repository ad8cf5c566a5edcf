"""``qtpu_torch.utils.numerics.sqrt_rn`` against the correctly rounded root
and against ``jnp.sqrt``, on the CPU.

PyTorch's float32 ``torch.sqrt`` on the CPU (its AVX-512 path) misses the
correctly rounded root by one ulp on about 0.7% of uniform inputs; XLA's
``jnp.sqrt`` does not.  The port's BatchNorm fold takes ``sqrt_rn``, whose
forward must equal the float64 root rounded once to float32 on every input
(among them eight where ``torch.sqrt`` was one ulp off on an AVX-512 CPU)
and whose backward must equal ``jax.grad(jnp.sqrt)`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu_torch.utils.numerics import sqrt_rn

# float32 bit patterns where torch.sqrt (2.13, CPU capability AVX512) gave a
# root one ulp off inside a 1M-element tensor
TORCH_OFF = np.array([0x40941E23, 0x40BD68AE, 0x40AEA3C0, 0x41126B42,
                      0x40864859, 0x41095983, 0x410F14ED, 0x40F657AF],
                     np.uint32).view(np.float32)


def _inputs(seed, lo, hi, n=1 << 20):
    rs = np.random.default_rng(seed)
    x = rs.uniform(lo, hi, n).astype(np.float32)
    x[:len(TORCH_OFF)] = TORCH_OFF
    return x


@pytest.mark.parametrize("seed,lo,hi", [(0, 1e-6, 10.0), (1, 1e-5, 4.0),
                                        (2, 0.5, 2.0), (3, 1e-30, 1e30)])
def test_sqrt_rn_is_correctly_rounded(seed, lo, hi):
    x = _inputs(seed, lo, hi)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.sqrt(x)))


def test_sqrt_rn_backward_is_jax_grad():
    x = _inputs(4, 1e-6, 10.0, n=1 << 16)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    sqrt_rn(xt).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jnp.sqrt, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    gs = jax.vmap(jax.grad(jnp.sqrt))(jnp.asarray(x))
    one = torch.from_numpy(x).requires_grad_()
    sqrt_rn(one).backward(torch.ones_like(one))
    np.testing.assert_array_equal(one.grad.numpy(), np.asarray(gs))


def test_sqrt_rn_keeps_other_dtypes():
    x = torch.rand(100, dtype=torch.float64) + 0.1
    assert torch.equal(sqrt_rn(x), torch.sqrt(x))
