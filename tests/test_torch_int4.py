"""qtpu_torch's int4-weight serving path vs qtpu, on the CPU.

BASELINE config 5, ``resnet50_int4w_int8a_qat`` (int4 per-channel weights,
int8 affine activations on the EMA observer, stem and fc in fp32), served
as qtpu's ``build_engine`` serves it: calibrate, freeze, flat engine.

* K1's int4 mode: qtpu's ``pack_int4_halves`` bytes; the port's
  ``qmatmul_fused(w_packed=True)`` and ``qmatmul_folded_w4`` on
  ``pack_int4_nk`` against qtpu's ``qmatmul_fused(w_packed=True)`` in
  interpret mode, exactly; ``pack_int4_nk`` round trips and refuses odd K.
* The EMA observer: the state after several batches equals qtpu's jitted
  ``ema_update``.
* ``calibrate`` with the EMA observer on a narrow ResNet-50 (stage sizes
  1-1-1-1, width 16, 32×32 input, qtpu's fp32 params carried over):
  ``act_scale`` to rtol 1e-6, ``act_zp`` exact.
* ``freeze`` at ``w_bits=4``: ``kernel_q`` bytes equal (nibble-packed, and
  unpacked where Co is odd: the width-9 case), ``colsum`` equal,
  ``w_scale`` and ``bias`` to rtol 1e-6 (as tests/test_torch_freeze.py:
  the same float32 BN fold, evaluated by XLA on the CPU and by PyTorch,
  puts one bias of layer2_0's downsample one ulp apart; ROADMAP C13), the
  excluded stem and fc in ``params``.
* ``ResNetInt8Engine(packed_int4=True)`` on qtpu's frozen tree against
  qtpu's ``ResNetInt8Engine(use_pallas=False)``, its op-by-op ``_forward``
  (ROADMAP C10): codes after every step by the tie rule, logits rel-L2 ≤
  1e-4; the packed and unpacked port engines give identical codes, and
  only the packed one runs the int4 entry's plain version.
* ``build_engine`` for config 5, narrowed, answers requests through
  ``ServingEngine``; the packed engine served with a forward factory
  answers them identically.
* ``ExperimentalResNetInt8Engine(packed_int4=True, use_qstage=True,
  qstage_proj=True, use_qproj=True)`` gives the packed product engine's
  codes on a 1-3-1-1 tree, whose stage 1 chains two identity blocks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.calib import observers as j_obs
from qtpu.examples.configs import CONFIGS as J_CONFIGS
from qtpu.models import get_model as j_get_model
from qtpu.ops.pallas.qmatmul import pack_int4_halves as j_pack_halves
from qtpu.ops.pallas.qmatmul import qmatmul_fused as j_qmatmul_fused
from qtpu.serve.fused_ops import grid_of as j_grid_of
from qtpu.serve.resnet_engine import ResNetInt8Engine as JEngine
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.calib import observers as t_obs
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.models import get_model, init_weights, load_flax_variables
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops import qconv, qmatmul
from qtpu_torch.serve.cli import build_engine
from qtpu_torch.serve.dispatch import resnet_arch
from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.serve.experimental import ExperimentalResNetInt8Engine
from qtpu_torch.serve.frozen import from_numpy_tree, to_numpy_tree
from qtpu_torch.serve.fused_ops import grid_of as t_grid_of
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
from qtpu_torch.transform import calibrate, freeze

KEY = jax.random.PRNGKey(0)
CFG5 = "resnet50_int4w_int8a_qat"
SIZE = 32
CASES = {
    # config 5's policy, narrowed: every conv has an even Co (packed)
    "config5": dict(width=16, num_classes=10, exclude=("stem*", "fc")),
    # odd Co (layer1's conv1/conv2 at width 9, the 5-class fc): unpacked
    "odd_width": dict(width=9, num_classes=5, exclude=("stem*",)),
}


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


# -- K1's int4 mode -------------------------------------------------------------

@pytest.mark.parametrize("bn", [256, 512])
def test_pack_int4_halves_matches_qtpu(bn):
    w4 = np.random.default_rng(bn).integers(-7, 8, (64, 1024)).astype(
        np.int8)
    got = qmatmul.pack_int4_halves(torch.from_numpy(w4), bn)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_pack_halves(jnp.asarray(w4),
                                                           bn)))
    np.testing.assert_array_equal(
        qmatmul.unpack_int4_halves(got, bn).numpy(), w4)


def test_pack_int4_nk_round_trip_and_odd_k():
    w = np.random.default_rng(3).integers(-7, 8, (6, 10)).astype(np.int8)
    w[0, :4] = (-7, 7, 7, -7)
    p = qmatmul.pack_int4_nk(torch.from_numpy(w))
    assert p.shape == (6, 5) and p.dtype == torch.int8
    assert p[0, 0].item() == 0x79 and p[0, 1].item() == -(0x100 - 0x97)
    np.testing.assert_array_equal(fq.unpack_int4(p, axis=-1).numpy(), w)
    with pytest.raises(ValueError, match="even K"):
        qmatmul.pack_int4_nk(torch.zeros((4, 7), dtype=torch.int8))
    x = torch.zeros((2, 7), dtype=torch.int8)
    with pytest.raises(ValueError, match="even K"):
        qmatmul.qmatmul_folded_w4(x, p, None, None, raw_acc=True)


@pytest.mark.parametrize("case", ["relu_requant", "int8_residual"])
def test_w_packed_matches_qtpu_interpret(case):
    """tests/test_pallas_qmatmul.py's int4 case (M=128, K=256, N=512,
    bn=256, relu + requant) and the same with an int8 residual."""
    M, K, N, bn = 128, 256, 512, 256
    rng = np.random.default_rng(9)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w4 = rng.integers(-7, 8, (K, N)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, (N,)).astype(np.float32)
    cs = w4.astype(np.int32).sum(0)
    b = rng.standard_normal(N).astype(np.float32)
    kw = dict(act_scale=np.float32(0.02), act_zp=np.int32(5), w_scale=ws,
              colsum=cs, bias=b, requant_scale=np.float32(0.05),
              requant_zp=np.int32(-3), relu=True)
    if case == "int8_residual":
        kw.update(residual=rng.integers(-128, 128, (M, N)).astype(np.int8),
                  res_scale=np.float32(0.03), res_zp=np.float32(-6.0))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = np.asarray(j_qmatmul_fused(
        jnp.asarray(xq), j_pack_halves(jnp.asarray(w4), bn), w_packed=True,
        out_dtype=jnp.int8, bm=128, bn=bn, bk=128, interpret=True, **jkw))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.ndim
           else v for k, v in kw.items()}
    x_t, w_t = torch.from_numpy(xq), torch.from_numpy(w4)
    got = qmatmul.qmatmul_fused(x_t, qmatmul.pack_int4_halves(w_t, bn),
                                w_packed=True, bn=bn, **tkw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    co, mode = qmatmul.fold(**tkw)
    n0 = qmatmul.qmatmul_folded_w4_plain.calls
    got4 = qmatmul.qmatmul_folded_w4(
        x_t, qmatmul.pack_int4_nk(w_t.t().contiguous()), co, mode,
        tkw.get("residual"))
    assert qmatmul.qmatmul_folded_w4_plain.calls == n0 + 1
    np.testing.assert_array_equal(got4.numpy(), ref)


@pytest.mark.parametrize("case", ["relu_requant", "f32"])
def test_w_packed_odd_k_matches_qtpu_interpret(case):
    """qtpu's int4 call form takes an odd K (bk = K, (bn/2) % 128 == 0):
    the port pads x_q with a zero column and the weight with a zero row
    before its K-packed layout, and gives qtpu's values exactly."""
    M, K, N, bn = 128, 147, 256, 256
    rng = np.random.default_rng(147)
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w4 = rng.integers(-7, 8, (K, N)).astype(np.int8)
    kw = dict(act_scale=np.float32(0.02), act_zp=np.int32(-9),
              w_scale=rng.uniform(0.001, 0.01, (N,)).astype(np.float32),
              colsum=w4.astype(np.int32).sum(0),
              bias=rng.standard_normal(N).astype(np.float32), relu=True)
    out = jnp.float32
    if case == "relu_requant":
        kw.update(requant_scale=np.float32(0.05), requant_zp=np.int32(-3))
        out = jnp.int8
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = np.asarray(j_qmatmul_fused(
        jnp.asarray(xq), j_pack_halves(jnp.asarray(w4), bn), w_packed=True,
        out_dtype=out, bm=128, bn=bn, interpret=True, **jkw))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.ndim
           else v for k, v in kw.items()}
    n0 = qmatmul.qmatmul_folded_w4_plain.calls
    got = qmatmul.qmatmul_fused(
        torch.from_numpy(xq),
        qmatmul.pack_int4_halves(torch.from_numpy(w4), bn), w_packed=True,
        bn=bn, **tkw)
    assert qmatmul.qmatmul_folded_w4_plain.calls == n0 + 1
    assert got.shape == (M, N) and str(got.dtype)[6:] == np.dtype(out).name
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the EMA observer ---------------------------------------------------------------

def test_ema_update_matches_qtpu():
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((4, 8, 8, 3)) * (1 + i)).astype(
        np.float32) for i in range(5)]
    step = jax.jit(j_obs.ema_update)
    js, ts = j_obs.ema_init(), t_obs.minmax_init()
    for b in batches:
        js = step(js, jnp.asarray(b))
        ts = t_obs.ema_update(ts, torch.from_numpy(b))
    assert ts["count"] == int(js["count"]) == 5
    for k in ("min", "max"):
        assert ts[k].dtype == torch.float32
        assert ts[k].item() == np.float32(js[k]), k


# -- calibrate and freeze on config 5's policy ------------------------------------

def _qtpu_run(width, num_classes, exclude):
    policy = dataclasses.replace(J_CONFIGS[CFG5].policy(), exclude=exclude)
    m = j_get_model("resnet50", num_classes=num_classes, cifar_stem=False,
                    width=width).clone(stage_sizes=(1, 1, 1, 1))
    x = jax.random.normal(KEY, (2, SIZE, SIZE, 3))
    qm = convert_model(m, policy)
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    _, mut = jax.jit(lambda v, xx: qm.apply(
        v, xx, train=True, mutable=["batch_stats", "quant_stats"]))(
            v, jax.random.normal(jax.random.fold_in(KEY, 1), x.shape))
    v.update(mut)
    fp32 = {c: jax.tree_util.tree_map(np.asarray, v[c])
            for c in ("params", "batch_stats")}
    batches = [np.asarray(jax.random.normal(jax.random.fold_in(KEY, 10 + i),
                                            x.shape)) * (1 + 0.5 * i)
               for i in range(3)]
    v = j_calibrate(qm, v, [jnp.asarray(b) for b in batches])
    _, sv = j_freeze(qm, v, x)
    return (fp32, batches, jax.tree_util.tree_map(np.asarray, v["quant_params"]),
            jax.tree_util.tree_map(np.asarray, sv), np.asarray(x))


@functools.lru_cache(maxsize=None)
def _frozen(name):
    """qtpu's calibrate + freeze of case ``name``, and the port's on the
    same fp32 weights and batches."""
    c = CASES[name]
    fp32, batches, j_qparams, sv, x = _qtpu_run(**c)
    model = get_model("resnet50", num_classes=c["num_classes"],
                      cifar_stem=False, width=c["width"],
                      stage_sizes=(1, 1, 1, 1))
    load_flax_variables(model, fp32["params"], fp32["batch_stats"])
    policy = dataclasses.replace(CONFIGS[CFG5].policy(), exclude=c["exclude"])
    calib = calibrate(model, policy, batches)
    return dict(case=name, c=c, j_qparams=j_qparams, sv=sv, x=x,
                calib=calib, tree=freeze(model, policy, calib))


@pytest.fixture(params=sorted(CASES))
def frozen(request):
    return _frozen(request.param)


def _nodes(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            yield p, v
        elif hasattr(v, "items"):
            yield from _nodes(v, p)


def test_ema_calibrate_matches_qtpu(frozen):
    got = frozen["calib"]["quant_params"]
    assert got
    for path, q in got.items():
        node = frozen["j_qparams"]
        for k in path.split("/") + ["in_q"]:
            node = node[k]
        assert bool(node["calibrated"]) and q["calibrated"]
        np.testing.assert_allclose(q["act_scale"].numpy(), node["act_scale"],
                                   rtol=1e-6, err_msg=path)
        np.testing.assert_array_equal(q["act_zp"].numpy(), node["act_zp"],
                                      err_msg=path)
        assert frozen["calib"]["quant_stats"][path]["count"] == 3


def test_int4_freeze_matches_qtpu(frozen):
    got_all = to_numpy_tree(frozen["tree"])
    got = dict(_nodes(got_all["qweights"]))
    ref = dict(_nodes(frozen["sv"]["qweights"]))
    assert sorted(got) == sorted(ref) and "stem" not in got
    n_packed = n_plain = 0
    for path, r in ref.items():
        g = got[path]
        packed = r["kernel_q"].shape[-1] != r["colsum"].shape[0]
        n_packed += packed
        n_plain += not packed
        assert packed == (r["colsum"].shape[0] % 2 == 0), path
        for leaf in ("kernel_q", "colsum", "act_zp"):
            assert g[leaf].dtype == r[leaf].dtype, (path, leaf)
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        for leaf in ("w_scale", "bias"):
            assert g[leaf].dtype == r[leaf].dtype, (path, leaf)
            np.testing.assert_array_equal(g[leaf], r[leaf], err_msg=path)
        np.testing.assert_allclose(g["act_scale"], r["act_scale"],
                                   rtol=1e-6, err_msg=path)
    assert n_packed > 0
    assert (n_plain > 0) == (frozen["case"] == "odd_width")
    excluded = ["stem", "fc"] if "fc" in frozen["c"]["exclude"] else ["stem"]
    assert sorted(got_all["params"]) == sorted(excluded)
    for col in ("params", "batch_stats"):
        for name, leaves in frozen["sv"][col].items():
            for leaf, val in leaves.items():
                np.testing.assert_array_equal(got_all[col][name][leaf], val)


# -- the packed engine ------------------------------------------------------------

def _arch(c):
    return dict(stage_sizes=(1, 1, 1, 1), width=c["width"], bottleneck=True,
                cifar_stem=False, num_classes=c["num_classes"])


@pytest.fixture(scope="module")
def engines():
    f = _frozen("config5")
    sv, arch = f["sv"], _arch(f["c"])
    tree = from_numpy_tree(sv, device="cpu")
    return (JEngine(sv, arch, use_pallas=False),
            ResNetInt8Engine(tree, arch, device="cpu", packed_int4=True),
            ResNetInt8Engine(tree, arch, device="cpu"), f["x"])


def test_packed_engine_steps_match_qtpu(engines):
    jeng, packed, unpacked, x = engines
    names = jeng._block_names()
    jg = j_grid_of(jeng._node(names[0][0], "conv1"))
    tg = t_grid_of(packed._node(names[0][0], "conv1"))
    j_codes = jeng._stem(jnp.asarray(x), jg)
    t_in = packed._stem(torch.tensor(x), tg)
    assert_codes(t_in.numpy(), j_codes)
    assert packed._plan() == [(i, 1, None) for i in range(len(names))]
    for step in packed._plan():
        idx = step[0]
        name, i, j = names[idx]
        nj = (j_grid_of(jeng._node(names[idx + 1][0], "conv1"))
              if idx + 1 < len(names) else None)
        j_out = jeng._bottleneck(j_codes, jg, name,
                                 (2, 2) if (i > 0 and j == 0) else (1, 1), nj)
        t_feed = torch.tensor(np.asarray(j_codes))
        t_out, tg = packed._step(t_feed, tg, step)
        u_out, _ = unpacked._step(t_feed, tg if nj is None else
                                  t_grid_of(unpacked._node(name, "conv1")),
                                  step)
        assert torch.equal(t_out, u_out), step
        if nj is None:          # excluded fc: the last block emits f32
            assert t_out.dtype == torch.float32
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                       rtol=1e-6, atol=1e-6)
        else:
            assert_codes(t_out.numpy(), j_out)
        j_codes, jg = j_out, nj


def test_packed_engine_logits_match_qtpu(engines):
    jeng, packed, unpacked, x = engines
    ref = np.asarray(jeng._forward(jnp.asarray(x)))
    n4 = qmatmul.qmatmul_folded_w4_plain.calls
    n8 = qmatmul.qmatmul_folded_plain.calls
    n2 = qconv.qconv2d_folded_plain.calls
    l4 = qmatmul.qmatmul_folded_w4.launches
    got = packed.forward(torch.tensor(x)).numpy()
    # every 1×1 (4 conv1, 4 conv3, 4 downsamples) on the int4 entry's plain
    # version, which unpacks and runs K1's; the four 3×3 on K2's
    assert qmatmul.qmatmul_folded_w4_plain.calls - n4 == 12
    assert qmatmul.qmatmul_folded_plain.calls - n8 == 12
    assert qconv.qconv2d_folded_plain.calls - n2 == 4
    assert qmatmul.qmatmul_folded_w4.launches == l4
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-4, rel_l2(got, ref)
    n4 = qmatmul.qmatmul_folded_w4_plain.calls
    np.testing.assert_array_equal(unpacked.forward(torch.tensor(x)).numpy(),
                                  got)
    assert qmatmul.qmatmul_folded_w4_plain.calls == n4
    node = packed._node("layer4_0", "down")
    assert node["w_nk4"].shape == (node["w_nk"].shape[0],
                                   node["w_nk"].shape[1] // 2)
    assert "w_nk4" not in unpacked._node("layer4_0", "down")
    assert "w_nk4" not in packed._node("layer1_0", "conv2")


# -- build_engine and the experimental engine -------------------------------------

def _narrow_cfg(**kw):
    return dataclasses.replace(CONFIGS[CFG5], image_size=SIZE,
                               num_classes=10, width=16, calib_batches=2,
                               batch_size=4, n_train=8, **kw)


def test_build_engine_serves_config5():
    cfg = _narrow_cfg()
    assert cfg.w_bits == 4 and cfg.act_observer == "ema"
    eng, info = build_engine(cfg, buckets=(2, 4), max_wait_ms=5.0,
                             device="cpu")
    arch = resnet_arch("resnet50", num_classes=10, image_size=SIZE,
                       width=16, cifar_stem=False)
    packed = ServingEngine(
        None, eng.vars, batch_buckets=(2, 4), max_wait_ms=5.0,
        forward_factory=lambda sv: ResNetInt8Engine(
            sv, arch, device="cpu", packed_int4=True).forward, device="cpu")
    try:
        assert info["serve_path"] == "flat-engine"
        assert not eng.vars["qweights"].get("fc")
        assert sorted(eng.vars["params"]) == ["fc", "stem"]
        x = np.random.default_rng(0).standard_normal(
            (5, SIZE, SIZE, 3)).astype(np.float32)
        y = eng.predict(x)
        assert y.shape == (5, 10) and np.isfinite(y).all()
        np.testing.assert_array_equal(packed.predict(x), y)
    finally:
        eng.stop()
        packed.stop()


def test_experimental_packed_stage_equals_packed_product():
    model = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=(1, 3, 1, 1))
    init_weights(model, torch.Generator().manual_seed(0))
    policy = CONFIGS[CFG5].policy()
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    tree = freeze(model.eval(), policy, calibrate(model, policy, [x, -x]))
    arch = dict(stage_sizes=(1, 3, 1, 1), width=16, bottleneck=True,
                cifar_stem=True, num_classes=10)
    prod = ResNetInt8Engine(tree, arch, device="cpu", packed_int4=True)
    exp = ExperimentalResNetInt8Engine(tree, arch, device="cpu",
                                       packed_int4=True, use_qstage=True,
                                       qstage_proj=True, use_qproj=True)
    assert sorted(exp._qstage_prep) == [1] and exp._qstage_prep[1]["nrun"] == 2
    plan = exp._plan()
    assert plan == [(0, 1, None), (1, 1, None), (2, 2, 1), (4, 1, None),
                    (5, 1, None)]
    xt = torch.from_numpy(x)
    g = t_grid_of(exp._node("layer1_0", "conv1"))
    codes = exp._stem(xt, g)
    assert torch.equal(codes, prod._stem(xt, g))
    for step in plan:
        out, gn = exp._step(codes, g, step)
        ref, rg = codes, g
        for k in range(step[0], step[0] + step[1]):
            ref, rg = prod._step(ref, rg, (k, 1, None))
        assert torch.equal(out, ref), step
        codes, g = out, gn
    y_prod = prod.forward(xt).numpy()
    n4 = qmatmul.qmatmul_folded_w4_plain.calls
    np.testing.assert_array_equal(exp.forward(xt).numpy(), y_prod)
    # the int4 entry runs the unfused 1×1s: the conv1 of the four unchained
    # blocks, and layer4_0's conv3 and downsample (K4 cannot requant onto
    # the excluded fc); K4/K7 take the unpacked int8 weights
    assert qmatmul.qmatmul_folded_w4_plain.calls - n4 == 6
