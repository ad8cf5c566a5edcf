"""qtpu_torch ResNetInt8Engine vs qtpu's ResNetInt8Engine, on the CPU.

Both engines load qtpu's frozen tree (the port through ``from_numpy_tree``)
and are walked block by block — ``_stem`` and ``_bottleneck``/``_basic`` —
with each block fed qtpu's codes from the block before, so each block's
agreement is seen on its own.  The codes after every block follow the tie
rule (equal, except one step on at most 0.1% of elements).  Logits of the
full forwards agree to rel-L2 ≤ 1e-4: the head's mean-pool sums in another
order, and a code moved at a tie moves the logits a little.

The reference logits are qtpu's ``_forward`` run op by op, the folded
formula as written.  Under ``jax.jit`` XLA fuses the epilogues and may
contract them into FMAs, which moves codes at ties: on the BasicBlock case
qtpu's own jitted forward differs from its op-by-op forward by 8.0e-4
rel-L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.serve.fused_ops import grid_of as j_grid_of
from qtpu.serve.resnet_engine import ResNetInt8Engine as JEngine
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.ops import qconv, qmatmul
from qtpu_torch.serve.frozen import from_numpy_tree
from qtpu_torch.serve.fused_ops import grid_of as t_grid_of
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine as TEngine

KEY = jax.random.PRNGKey(0)

CASES = {
    "full_int8": dict(model="resnet50", cifar=True, size=32, width=16,
                      exclude=(), torch_pad=False),
    "fp32stem_maxpool": dict(model="resnet50", cifar=False, size=64,
                             width=16, exclude=("stem*",), torch_pad=False),
    "torch_pad": dict(model="resnet50", cifar=False, size=64, width=16,
                      exclude=("stem*",), torch_pad=True),
    "basic_block": dict(model="resnet18", cifar=True, size=32, width=16,
                        exclude=(), torch_pad=False),
}


def assert_codes(a, b, frac=1e-3):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _frozen(model, cifar, size, width, exclude, torch_pad):
    m = j_get_model(model, num_classes=10, cifar_stem=cifar, width=width,
                    torch_pad=torch_pad).clone(stage_sizes=(1, 1, 1, 1))
    x = jax.random.normal(KEY, (2, size, size, 3))
    qm = convert_model(m, JPolicy.int8_ptq(exclude=exclude))
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    tr = jax.jit(lambda v, xx: qm.apply(
        v, xx, train=True, mutable=["batch_stats", "quant_stats"]))
    _, mut = tr(v, jax.random.normal(jax.random.fold_in(KEY, 1), x.shape))
    v.update(mut)
    v = j_calibrate(qm, v, [x])
    _, sv = j_freeze(qm, v, x)
    arch = dict(stage_sizes=(1, 1, 1, 1), width=width,
                bottleneck=model == "resnet50", cifar_stem=cifar,
                num_classes=10, torch_pad=torch_pad)
    return sv, arch, np.asarray(x)


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    c = CASES[request.param]
    sv, arch, x = _frozen(**c)
    jeng = JEngine(sv, arch, use_pallas=False)
    teng = TEngine(from_numpy_tree(jax.tree_util.tree_map(np.asarray, sv),
                                   device="cpu"), arch, device="cpu")
    return c, jeng, teng, x


def test_blocks_follow_tie_rule(engines):
    c, jeng, teng, x = engines
    names = jeng._block_names()
    first = names[0][0]
    jg = j_grid_of(jeng._node(first, "conv1"))
    tg = t_grid_of(teng._node(first, "conv1"))
    j_codes = jeng._stem(jnp.asarray(x), jg)
    t_codes = teng._stem(torch.tensor(x), tg)
    assert t_codes.dtype == torch.int8
    assert_codes(t_codes.numpy(), j_codes)
    fc_j, fc_t = jeng._node("fc"), teng._node("fc")
    for idx, (name, i, j) in enumerate(names):
        strides = (2, 2) if (i > 0 and j == 0) else (1, 1)
        if idx + 1 < len(names):
            nj = j_grid_of(jeng._node(names[idx + 1][0], "conv1"))
            nt = t_grid_of(teng._node(names[idx + 1][0], "conv1"))
        else:
            nj, nt = j_grid_of(fc_j), t_grid_of(fc_t)
        jstep = jeng._bottleneck if arch_bottleneck(c) else jeng._basic
        tstep = teng._bottleneck if arch_bottleneck(c) else teng._basic
        j_out = jstep(j_codes, jg, name, strides, nj)
        t_out = tstep(torch.tensor(np.asarray(j_codes)), tg, name,
                      strides, nt)
        assert_codes(t_out.numpy(), j_out)
        j_codes, jg, tg = j_out, nj, nt


def arch_bottleneck(c):
    return c["model"] == "resnet50"


def test_logits_match(engines):
    c, jeng, teng, x = engines
    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    n_mm = qmatmul.qmatmul_folded_plain.calls
    n_cv = qconv.qconv2d_folded_plain.calls
    got = teng.forward(torch.tensor(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    # on the CPU every int8 layer ran the kernels' plain versions
    n_blocks = 4
    convs3 = n_blocks + (0 if arch_bottleneck(c) else n_blocks)
    if not c["exclude"]:
        convs3 += 1                                  # quantized stem
    assert qconv.qconv2d_folded_plain.calls - n_cv == convs3
    gemms = (2 * n_blocks + 4 + 1 if arch_bottleneck(c)
             else 3 + 1)                             # 1x1s (+ downs) + fc
    assert qmatmul.qmatmul_folded_plain.calls - n_mm == gemms
    assert qmatmul.qmatmul_folded.launches == 0
    assert qconv.qconv2d_folded.launches == 0
    if not c["exclude"]:
        # int8 ingest: codes on the stem's grid give the same logits
        from qtpu_torch.ops.qops import quantize_act
        g = teng.stem_grid()
        codes = quantize_act(torch.tensor(x), g.scale, g.zp, symmetric=g.sym)
        np.testing.assert_array_equal(teng.forward_codes(codes).numpy(), got)


def test_forward_u8_matches_forward_and_qtpu():
    """forward_u8(raw uint8) ≈ forward((u8/255 − mean)/std) in the port, and
    equals qtpu's forward_u8 on the same pixels."""
    c = CASES["fp32stem_maxpool"]
    sv, arch, _ = _frozen(**c)
    mean, std = (0.5, 0.4, 0.45), (0.25, 0.3, 0.2)
    x8 = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
    xf = ((x8.astype(np.float32) / 255.0 - np.asarray(mean, np.float32))
          / np.asarray(std, np.float32))
    teng = TEngine(from_numpy_tree(jax.tree_util.tree_map(np.asarray, sv),
                                   device="cpu"), arch, device="cpu",
                   normalize=(mean, std))
    y_u8 = teng.forward_u8(torch.from_numpy(x8)).numpy()
    y_f32 = teng.forward(torch.from_numpy(xf)).numpy()
    assert np.argmax(y_u8, -1).tolist() == np.argmax(y_f32, -1).tolist()
    assert rel_l2(y_u8, y_f32) < 0.05
    jeng = JEngine(sv, arch, normalize=(mean, std))
    ref = np.asarray(jeng._forward(jnp.asarray(x8), raw_u8=True))
    assert rel_l2(y_u8, ref) <= 1e-4, rel_l2(y_u8, ref)
    with pytest.raises(ValueError):
        teng.stem_grid()           # excluded stem has no int8 ingest grid


def test_engine_needs_a_device_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine({"qweights": {}}, {"stage_sizes": (1,)})
