"""qtpu_torch's ExperimentalResNetInt8Engine vs qtpu's, on the CPU.

Model: ResNet-50 at full width with ``stage_sizes=(2, 2, 1, 1)``, CIFAR
stem, 16×16 images, 10 classes, frozen by qtpu and loaded into the port
with ``from_numpy_tree``.  Two configurations, as served on the card:
``tail`` (``use_qtail`` + ``use_qproj``) and ``block`` (``use_qblock`` +
``use_qproj``).  qtpu runs its Pallas kernels in interpret mode through its
op-by-op ``_forward``; the port runs the kernels' plain versions.

* The prep tables name the same blocks as qtpu's.
* Walked block by block, each fed qtpu's codes from the block before, the
  codes follow the tie rule (equal except one step on ≤ 0.1% of elements);
  the logits agree to rel-L2 ≤ 1e-4.
* With every flag off the engine is the product engine, and the product
  engine's tables are empty.

The chained configuration ``stage`` (``use_qstage`` + ``qstage_proj`` +
``use_qproj``) runs on a second frozen tree, ``stage_sizes=(3, 3, 2, 2)``,
so that stage 0 chains its projection block with two identity blocks (K8),
stage 1 runs two identity blocks (K7) and stages 2-3 one each:

* ``_qstage_prep`` names the same stages as qtpu's, with the same ``nrun``
  and the projection block in the same one;
* walked run by run (the port's ``_plan``), each step fed qtpu's codes
  from the step before, the codes follow the tie rule; the logits agree
  with qtpu's (its chained kernels in interpret mode) to rel-L2 ≤ 1e-4 and
  equal the port's product engine's;
* one forward runs the plain versions of K8 once, K7 three times, K4
  three times and the unfused K1/K2 only where no run covers a block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.serve.experimental import ExperimentalResNetInt8Engine as JExp
from qtpu.serve.fused_ops import grid_of as j_grid_of
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.ops import qblock, qconv, qivr, qmatmul, qproj, qstage, qtail
from qtpu_torch.serve.experimental import ExperimentalResNetInt8Engine
from qtpu_torch.serve.frozen import from_numpy_tree
from qtpu_torch.serve.fused_ops import grid_of as t_grid_of
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

KEY = jax.random.PRNGKey(0)
STAGES = (2, 2, 1, 1)
ARCH = dict(stage_sizes=STAGES, width=64, bottleneck=True, cifar_stem=True,
            num_classes=10)
CONFIGS = {"tail": dict(use_qtail=True, use_qproj=True),
           "block": dict(use_qblock=True, use_qproj=True)}
TABLES = ("_qtail_prep", "_qproj_prep", "_qblock_prep")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def assert_codes(a, b, frac=1e-3):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


STAGE_SIZES = (3, 3, 2, 2)
STAGE_ARCH = dict(ARCH, stage_sizes=STAGE_SIZES)
STAGE_FLAGS = dict(use_qstage=True, qstage_proj=True, use_qproj=True)


def _freeze(stages):
    m = j_get_model("resnet50", num_classes=10, cifar_stem=True).clone(
        stage_sizes=stages)
    x = jax.random.normal(KEY, (2, 16, 16, 3))
    qm = convert_model(m, JPolicy.int8_ptq())
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    v = j_calibrate(qm, v, [x])
    _, sv = j_freeze(qm, v, x)
    tree = from_numpy_tree(jax.tree_util.tree_map(np.asarray, sv),
                           device="cpu")
    return sv, tree, np.asarray(x)


@pytest.fixture(scope="module")
def frozen():
    return _freeze(STAGES)


@pytest.fixture(scope="module")
def frozen_stage():
    return _freeze(STAGE_SIZES)


def _engines(frozen, config):
    sv, tree, x = frozen
    flags = CONFIGS[config]
    jeng = JExp(sv, ARCH, qtail_interpret=True, qblock_interpret=True,
                **flags)
    teng = ExperimentalResNetInt8Engine(tree, ARCH, device="cpu", **flags)
    return jeng, teng, x


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_prep_tables_match_qtpu(frozen, config):
    jeng, teng, _ = _engines(frozen, config)
    for tbl in TABLES:
        assert sorted(getattr(teng, tbl)) == sorted(getattr(jeng, tbl)), tbl
    fused = "_qblock_prep" if config == "block" else "_qtail_prep"
    assert sorted(getattr(teng, fused)) == ["layer1_1", "layer2_1"]
    assert sorted(teng._qproj_prep) == [f"layer{i}_0" for i in range(1, 5)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_blocks_and_logits_match_qtpu(frozen, config):
    jeng, teng, x = _engines(frozen, config)
    names = jeng._block_names()
    jg = j_grid_of(jeng._node(names[0][0], "conv1"))
    tg = t_grid_of(teng._node(names[0][0], "conv1"))
    j_codes = jeng._stem(jnp.asarray(x), jg)
    assert_codes(teng._stem(torch.tensor(x), tg).numpy(), j_codes)
    for idx, (name, i, j) in enumerate(names):
        strides = (2, 2) if (i > 0 and j == 0) else (1, 1)
        nxt = ((names[idx + 1][0], "conv1") if idx + 1 < len(names)
               else ("fc",))
        nj, nt = j_grid_of(jeng._node(*nxt)), t_grid_of(teng._node(*nxt))
        j_out = jeng._bottleneck(j_codes, jg, name, strides, nj)
        t_out = teng._bottleneck(torch.tensor(np.asarray(j_codes)), tg, name,
                                 strides, nt)
        assert_codes(t_out.numpy(), j_out)
        j_codes, jg, tg = j_out, nj, nt

    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    before = (qproj.qproj_folded_plain.calls, qtail.qtail_folded_plain.calls,
              qblock.qblock_folded_plain.calls,
              qconv.qconv2d_folded_plain.calls,
              qmatmul.qmatmul_folded_plain.calls)
    got = teng.forward(torch.tensor(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    ran = tuple(a - b for a, b in zip(
        (qproj.qproj_folded_plain.calls, qtail.qtail_folded_plain.calls,
         qblock.qblock_folded_plain.calls, qconv.qconv2d_folded_plain.calls,
         qmatmul.qmatmul_folded_plain.calls), before))
    # per forward: 4 projection tails, 2 fused identity blocks; the
    # projection blocks' conv1 and conv2 (and the tail's conv1s) unfused
    if config == "tail":
        assert ran == (4, 2, 0, 1 + 4, 4 + 2 + 1)   # + the stem, + the fc
    else:
        assert ran == (4, 0, 2, 1 + 4, 4 + 1)
    for k in (qproj.qproj_folded, qtail.qtail_folded, qblock.qblock_folded):
        assert k.launches == 0


def test_flags_off_is_the_product_engine(frozen):
    _, tree, x = frozen
    prod = ResNetInt8Engine(tree, ARCH, device="cpu")
    exp = ExperimentalResNetInt8Engine(tree, ARCH, device="cpu")
    for tbl in TABLES:
        assert getattr(prod, tbl) == {} and getattr(exp, tbl) == {}, tbl
    np.testing.assert_array_equal(prod.forward(torch.tensor(x)).numpy(),
                                  exp.forward(torch.tensor(x)).numpy())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_engine_equals_product_engine(frozen, config):
    """The fused pieces take the product engine's coefficients: the logits
    are identical, not just close."""
    _, tree, x = frozen
    prod = ResNetInt8Engine(tree, ARCH, device="cpu")
    exp = ExperimentalResNetInt8Engine(tree, ARCH, device="cpu",
                                       **CONFIGS[config])
    np.testing.assert_array_equal(prod.forward(torch.tensor(x)).numpy(),
                                  exp.forward(torch.tensor(x)).numpy())


# -- the chained stage configuration -----------------------------------------

def _plain_calls():
    return (qstage.qstage_proj_folded_plain.calls,
            qstage.qstage_folded_plain.calls, qproj.qproj_folded_plain.calls,
            qconv.qconv2d_folded_plain.calls,
            qmatmul.qmatmul_folded_plain.calls,
            qtail.qtail_folded_plain.calls, qblock.qblock_folded_plain.calls,
            qivr.qivr_folded_plain.calls)


@pytest.fixture(scope="module")
def stage_engines(frozen_stage):
    sv, tree, x = frozen_stage
    jeng = JExp(sv, STAGE_ARCH, qstage_interpret=True, qtail_interpret=True,
                **STAGE_FLAGS)
    teng = ExperimentalResNetInt8Engine(tree, STAGE_ARCH, device="cpu",
                                        **STAGE_FLAGS)
    return jeng, teng, x


def test_qstage_prep_matches_qtpu(stage_engines):
    jeng, teng, _ = stage_engines
    got = {i: (p["nrun"], p["proj"] is not None)
           for i, p in teng._qstage_prep.items()}
    ref = {i: (p["nrun"], "wp1" in p["weights"])
           for i, p in jeng._qstage_prep.items()}
    assert got == ref == {0: (2, True), 1: (2, False), 2: (1, False),
                          3: (1, False)}
    for i, p in teng._qstage_prep.items():
        assert tuple(p["tgt"][:2]) == pytest.approx(
            tuple(jeng._qstage_prep[i]["tgt"][:2]))
    # one step per run, one per block left over
    assert teng._plan() == [(0, 3, 0), (3, 1, None), (4, 2, 1),
                            (6, 1, None), (7, 1, 2), (8, 1, None),
                            (9, 1, 3)]


def test_stage_runs_and_logits_match_qtpu(stage_engines, frozen_stage):
    jeng, teng, x = stage_engines
    names = teng._block_names()
    jg = j_grid_of(jeng._node(names[0][0], "conv1"))
    tg = t_grid_of(teng._node(names[0][0], "conv1"))
    j_codes = jeng._stem(jnp.asarray(x), jg)
    assert_codes(teng._stem(torch.tensor(x), tg).numpy(), j_codes)
    for step in teng._plan():
        idx, n, stage = step
        t_out, tg = teng._step(torch.tensor(np.asarray(j_codes)), tg, step)
        if stage is not None:
            j_codes, jg = jeng._qstage(j_codes, stage)
        else:
            name, i, j = names[idx]
            nxt = ((names[idx + 1][0], "conv1") if idx + 1 < len(names)
                   else ("fc",))
            nj = j_grid_of(jeng._node(*nxt))
            j_codes = jeng._bottleneck(j_codes, jg, name,
                                       (2, 2) if j == 0 else (1, 1), nj)
            jg = nj
        assert_codes(t_out.numpy(), j_codes)

    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    before = _plain_calls()
    got = teng.forward(torch.tensor(x)).numpy()
    ran = tuple(a - b for a, b in zip(_plain_calls(), before))
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    # K8 once, K7 three times, K4 for layer2_0-layer4_0, whose conv2 (K2,
    # + the stem) and conv1 (K1, + the fc) stay unfused
    assert ran == (1, 3, 3, 3 + 1, 3 + 1, 0, 0, 0)
    for k in (qstage.qstage_folded, qstage.qstage_proj_folded):
        assert k.launches == 0
    prod = ResNetInt8Engine(frozen_stage[1], STAGE_ARCH, device="cpu")
    np.testing.assert_array_equal(prod.forward(torch.tensor(x)).numpy(), got)
