"""The module SERVE path's kernel calls and the KL configs' engines on the
card (no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu_serve.py``).

Every test here is ``gpu``-marked and skips without a CUDA device:

* K2's raw int32 accumulator at zero-point-padded shapes — LeNet-5's conv1
  (28², Ci = 1, 5×5 SAME) and conv2 (14², Ci = 6, VALID) on the
  small-channel kernel (pads written in the kernel), ResNet-50's layer1 3×3
  and a 3×3/2 on the implicit GEMM
  (TMA's zero fill repaired by ``zp · tapsum``), the 1×1/2 downsample as a
  1×1 window — exact against the plain version, on the kernel ``k2_path``
  gives and on the old loop forced, with the launches and pad copies
  counted;
* K3's raw accumulator at a MobileNet-v2 depthwise shape;
* K1's raw accumulator at LeNet-5's fc shapes (K = 400 / 120 / 84, N = 120
  / 84 / 10), and K1 and K2 requantising onto a symmetric grid (shift 0)
  at ResNet-18's shapes, the stem kernel included;
* the module SERVE path's models (LeNet-5, a narrowed ResNet-18 with its
  downsamples in fp32) on the card against the same models on the CPU
  (codes by the tie rule through the logits: rel-L2 ≤ 1e-4), with the
  launches per forward counted by kernel family;
* ``build_engine`` for ``lenet_mnist_int8`` (3 K1 + 2 K2 a forward) and
  ``resnet18_cifar10_int8_kl`` (4 K1 + 17 K2 a forward, every K2 launch
  on the stem kernel or wgmma), none on the plain path, on the old
  ``igemm`` loops only the narrow fcs of a batch (fewer than 512 rows),
  no pad copy;
* ``ServingEngine``'s CUDA graphs (one a bucket) on a narrow ResNet
  (bottleneck, width 16, CIFAR stem): every bucket graphed at ``warmup``,
  every response of every round bit-equal to the eager forward of the
  same rows padded as served, with and without the pipeline; a bucket
  ``warmup`` did not see captured at its first round; a forward that
  syncs with the host makes ``warmup`` raise, naming the bucket; the
  launch counters a replayed round advances equal an eager round's;
* the flat engines' own entries compiled per input shape, on the narrow
  ResNet (int8 stem, and an fp32-stem twin for ``forward_u8``): each
  entry's replays bit-equal to its eager body at two batch sizes, with the
  counters a replay advances equal to an eager call's; outputs kept across
  calls on other inputs still right; graphs at eight batch sizes in the
  engine's one memory pool, the seven after the first growing it by less
  than a 2 MiB segment in all, calls alternating between two streams
  still right; a forward inside an outer capture
  records the body's kernels and captures no graph of its own; a body
  that syncs with the host raises ``GraphCaptureError`` naming the entry
  and shape, and stores no graph;
* calibration's passes replayed per batch shape: ``quant_stats`` and
  ``quant_params`` bit-equal to the eager calibration's (min-max, EMA,
  KL) on the narrow ResNet's fp32 model.
"""
import dataclasses

import numpy as np
import pytest
import torch

from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.nn import LayerQuantSpec, QuantPolicy
from qtpu_torch.nn.serve_layers import serve_model
from qtpu_torch.ops import qconv as tconv
from qtpu_torch.ops import qdepthwise as tdw
from qtpu_torch.ops import qmatmul as tmm
from qtpu_torch.ops import qops as tq
from qtpu_torch.serve.cli import build_engine
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.transform import calibrate, freeze

RNG = np.random.default_rng(21)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _dev(a, dev):
    return torch.tensor(np.asarray(a), device=dev)


def _k2_counts():
    f = tconv.qconv2d_folded
    return (f.launches, f.launches_wgmma, f.launches_stem, f.launches_small,
            f.launches_igemm, tq.resolve_and_pad.calls)


# (B, H, Ci, Co, k, stride, padding, zp, the path k2_path gives)
K2_RAW = [
    (8, 28, 1, 6, 5, 1, "SAME", -17, "small"),      # LeNet conv1
    (8, 14, 6, 16, 5, 1, "VALID", 5, "small"),      # LeNet conv2
    (2, 56, 64, 64, 3, 1, "SAME", -9, "wgmma"),     # RN50 layer1 3x3
    (2, 28, 128, 128, 3, 2, "SAME", 23, "wgmma"),   # a 3x3/2
    (2, 14, 256, 512, 1, 2, "SAME", 7, "wgmma"),    # 1x1/2 downsample
    (3, 9, 16, 24, 3, 2, ((1, 1), (1, 1)), -128, "small"),
    (3, 9, 40, 24, 3, 2, ((1, 1), (1, 1)), -128, "igemm"),  # K = 360
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Ci,Co,k,stride,padding,zp,want", K2_RAW)
def test_k2_raw_accumulator_matches_plain(cuda, B, H, Ci, Co, k, stride,
                                          padding, zp, want):
    x = _dev(RNG.integers(-128, 128, (B, H, H, Ci)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (Co, k * k * Ci)).astype(np.int8), cuda)
    pads = tq.resolve_pads((H, H), (k, k), (stride, stride), padding)
    args = dict(kernel_hw=(k, k), stride=stride, pads=pads, zp=zp,
                raw_acc=True)
    path = tconv.k2_path(x, w, pads, stride, kernel_hw=(k, k),
                         out_dtype=torch.int32)
    assert path == want
    ref = tconv.qconv2d_folded_plain(x, w, None, None, **args)
    padded = pads != ((0, 0), (0, 0))
    for force in (None, "igemm"):
        c0 = _k2_counts()
        got = tconv.qconv2d_folded(x, w, None, None, path=force,
                                   tapsum=tconv.tapsum_of(w, (k, k)), **args)
        torch.cuda.synchronize()
        used = force or path
        assert _k2_counts() == tuple(c + d for c, d in zip(c0, (
            1, used == "wgmma", used == "stem", used == "small",
            used == "igemm", used == "igemm" and padded)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,C,stride", [(8, 56, 144, 1), (8, 112, 96, 2),
                                         (2, 7, 960, 1)])
def test_k3_raw_accumulator_matches_plain(cuda, B, H, C, stride):
    x = _dev(RNG.integers(-128, 128, (B, H, H, C)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (9, C)).astype(np.int8), cuda)
    args = dict(kernel_hw=(3, 3), stride=stride, padding="SAME", zp=-41,
                raw_acc=True)
    f = tdw.qdepthwise_folded
    n0, h0 = f.launches, f.launches_halo
    got = f(x, w, None, None, **args)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_halo) == (n0 + 1, h0 + 1)
    ref = tdw.qdepthwise_folded_plain(x, w, None, None, **args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(8, 400, 120), (8, 120, 84), (8, 84, 10),
                                   (128, 400, 120), (128, 120, 84),
                                   (128, 84, 10)])
def test_k1_raw_at_lenet_shapes(cuda, M, K, N):
    x = _dev(RNG.integers(-128, 128, (M, K)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (N, K)).astype(np.int8), cuda)
    f = tmm.qmatmul_folded
    path = tmm.k1_path(x, w, torch.int32, None)
    c0 = (f.launches, f.launches_wgmma, f.launches_wgmma_cp,
          f.launches_igemm)
    got = f(x, w, None, None, raw_acc=True)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_wgmma, f.launches_wgmma_cp,
            f.launches_igemm) == (
        c0[0] + 1, c0[1] + (path == "wgmma"), c0[2] + (path == "wgmma_cp"),
        c0[3] + (path == "igemm"))
    # rows of 120 and 84 bytes and 40-byte output rows: below 512 rows the
    # old loop, which beats the narrow-row kernel there
    assert path == ("wgmma" if K % 16 == 0 and N * 4 % 16 == 0 else "igemm")
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        tmm.qmatmul_folded_plain(x, w, None, None, raw_acc=True)
        .cpu().numpy())


def _sym_coeffs(n, k, dev, relu):
    return tq.epilogue_coeffs(
        act_scale=0.02, act_zp=0,
        w_scale=_dev(RNG.uniform(0.001, 0.01, n).astype(np.float32), dev),
        colsum=_dev(RNG.integers(-127 * k // 8, 127 * k // 8, n)
                    .astype(np.int32), dev),
        bias=_dev(RNG.standard_normal(n).astype(np.float32), dev),
        requant_scale=0.05, requant_zp=None, requant_symmetric=True,
        relu=relu)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,relu", [(8 * 256, 64, 128, False),
                                        (8 * 1024, 64, 64, True),
                                        (130, 512, 10, False)])
def test_k1_symmetric_requant_matches_plain(cuda, M, K, N, relu):
    x = _dev(RNG.integers(-127, 128, (M, K)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (N, K)).astype(np.int8), cuda)
    co, mode = _sym_coeffs(N, K, cuda, relu)
    assert mode.shift == 0.0 and co.lo == (0.0 if relu else -127.0)
    ref = tmm.qmatmul_folded_plain(x, w, co, mode)
    for force in (None, "igemm"):
        got = tmm.qmatmul_folded(x, w, co, mode, path=force)
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Ci,Co,stride,want", [
    (8, 32, 3, 64, 1, "stem"),        # ResNet-18's CIFAR stem
    (8, 32, 64, 64, 1, "wgmma"),      # layer1
    (8, 16, 128, 256, 2, "wgmma")])   # layer3_0 conv1
def test_k2_symmetric_requant_matches_plain(cuda, B, H, Ci, Co, stride, want):
    x = _dev(RNG.integers(-127, 128, (B, H, H, Ci)).astype(np.int8), cuda)
    w = _dev(RNG.integers(-127, 128, (Co, 9 * Ci)).astype(np.int8), cuda)
    co, mode = _sym_coeffs(Co, 9 * Ci, cuda, True)
    pads = tq.same_pads((H, H), (3, 3), (stride, stride))
    args = dict(kernel_hw=(3, 3), stride=stride, pads=pads, zp=0)
    assert tconv.k2_path(x, w, pads, stride, co, mode, kernel_hw=(3, 3),
                         out_dtype=torch.int8) == want
    ref = tconv.qconv2d_folded_plain(x, w, co, mode, **args)
    for force in (None, "igemm"):
        got = tconv.qconv2d_folded(x, w, co, mode, path=force, **args)
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


def _launches():
    return (tmm.qmatmul_folded.launches, tconv.qconv2d_folded.launches,
            tdw.qdepthwise_folded.launches,
            tmm.qmatmul_folded_plain.calls + tconv.qconv2d_folded_plain.calls
            + tdw.qdepthwise_folded_plain.calls)


def _frozen(name, policy, cuda, **kw):
    m = get_model(name, **kw)
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(cuda).eval()
    shape = (4, 28, 28, 1) if name == "lenet5" else (4, 16, 16, 3)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    return freeze(m, policy, calibrate(m, policy, [x])), x


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,policy,per_forward", [
    ("lenet5", dict(num_classes=10),
     QuantPolicy(default=LayerQuantSpec(per_channel=False)), (3, 2, 0)),
    ("lenet5", dict(num_classes=10),
     QuantPolicy(default=LayerQuantSpec(act_observer="kl")), (3, 2, 0)),
    ("resnet18", dict(num_classes=10, cifar_stem=True, width=64,
                      stage_sizes=(1, 1, 1, 1)),
     QuantPolicy.int8_ptq(exclude=("*/down",)), (1, 9, 0))])
def test_module_serve_on_the_card_matches_cpu(cuda, name, kw, policy,
                                              per_forward):
    tree, x = _frozen(name, policy, cuda, **kw)
    card = serve_model(name, policy, tree, device=cuda, **kw)
    cpu = serve_model(name, policy, _to_cpu(tree), device="cpu", **kw)
    c0 = _launches()
    y = card(torch.tensor(x))
    torch.cuda.synchronize()
    got = tuple(b - a for a, b in zip(c0, _launches()))
    assert got == (*per_forward, 0)
    y_cpu = cpu(torch.tensor(x)).numpy()
    y = y.cpu().numpy()
    assert np.isfinite(y).all()
    assert (np.linalg.norm(y - y_cpu) / np.linalg.norm(y_cpu)) <= 1e-4


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.gpu
@pytest.mark.parametrize("name,per_forward,fc_igemm", [
    ("lenet_mnist_int8", (3, 2), 2), ("resnet18_cifar10_int8_kl", (4, 17), 1)])
def test_build_engine_launches(cuda, name, per_forward, fc_igemm):
    cfg = dataclasses.replace(CONFIGS[name], calib_batches=2, n_train=256)
    eng, info = build_engine(cfg, buckets=(8,), max_wait_ms=5.0, device=cuda)
    try:
        x = np.random.default_rng(7).standard_normal(
            (8, *info["image_shape"])).astype(np.float32)
        f2 = tconv.qconv2d_folded
        f1 = tmm.qmatmul_folded

        def counts():
            return (*_launches(), f2.launches_wgmma, f2.launches_stem,
                    tq.resolve_and_pad.calls, f1.launches_igemm,
                    f2.launches_igemm)

        c0 = counts()
        y = eng.predict(x)
        torch.cuda.synchronize()
        d = tuple(b - a for a, b in zip(c0, counts()))
        assert d[:4] == (*per_forward, 0, 0)
        # the old loop takes only the narrow fcs below 512 rows (LeNet-5's
        # fc2 and fc3, the CIFAR fc)
        assert d[6:] == (0, fc_igemm, 0)
        assert y.shape == (8, 10) and np.isfinite(y).all()
        if name.startswith("resnet18"):
            assert d[4] + d[5] == 17 and d[5] == 1
    finally:
        eng.stop()


NARROW = dict(stage_sizes=(1, 1, 1, 1), width=16, bottleneck=True,
              cifar_stem=True, num_classes=10)


@pytest.fixture
def narrow_resnet(cuda):
    """(frozen tree, a forward factory) of a narrow ResNet on the card."""
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    m = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                  stage_sizes=NARROW["stage_sizes"])
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(RNG.standard_normal((8, 32, 32, 3)).astype(
        np.float32))
    policy = QuantPolicy.int8_ptq()
    tree = freeze(m, policy, calibrate(m, policy, [x]))
    return tree, lambda v: ResNetInt8Engine(v, NARROW,
                                            device=cuda).eager_forward


def _logged(engine):
    """[(bucket, futures)] of every round ``engine`` resolves."""
    rounds, resolve = [], engine._resolve_round

    def logged(batch, b, *rest):
        rounds.append((b, [f for _, f, _ in batch]))
        return resolve(batch, b, *rest)
    engine._resolve_round = logged
    return rounds


def _eager(engine, rows, b):
    from qtpu_torch.data.native import pack_batch

    packed = pack_batch(list(rows), pad_to=b, dtype=np.float32,
                        shape=rows[0].shape)
    with torch.no_grad():
        return engine._fwd(engine.vars, engine._upload(packed)).cpu(
        ).numpy()[:len(rows)]


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", [True, False])
def test_graphed_rounds_bit_equal_to_eager(cuda, narrow_resnet, pipeline):
    from qtpu_torch.serve.engine import ServingEngine

    tree, factory = narrow_resnet
    eng = ServingEngine(None, tree, batch_buckets=(2, 4, 8), max_wait_ms=20.0,
                        forward_factory=factory, pipeline=pipeline,
                        device=cuda)
    xs = RNG.standard_normal((40, 32, 32, 3)).astype(np.float32)
    try:
        eng.warmup((32, 32, 3))
        st = eng.stats()
        assert eng.graphed_buckets == [2, 4, 8]
        assert st["graphed"] == {2: 1, 4: 1, 8: 1}
        assert all(st["graph_bytes"][b] > 0 for b in (2, 4, 8))
        rounds = _logged(eng)
        futs = []
        for n in (1, 2, 3, 4, 5):               # one burst a round
            burst = [eng.submit(x) for x in xs[len(futs):len(futs) + n]]
            for f in burst:
                f.result(timeout=120)
            futs += burst
        futs += [eng.submit(x) for x in xs[len(futs):]]   # back to back
        for f in futs:
            f.result(timeout=120)
    finally:
        eng.stop()
    index = {id(f): i for i, f in enumerate(futs)}
    assert {b for b, _ in rounds} == {2, 4, 8}
    assert sum(b == 8 for b, _ in rounds) >= 3
    for b, rf in rounds:
        rows = [xs[index[id(f)]] for f in rf]
        got = np.stack([f.result() for f in rf])
        np.testing.assert_array_equal(got, _eager(eng, rows, b))


@pytest.mark.gpu
def test_bucket_captured_at_first_round(cuda, narrow_resnet):
    from qtpu_torch.serve.engine import ServingEngine

    tree, factory = narrow_resnet
    eng = ServingEngine(None, tree, batch_buckets=(2, 4), max_wait_ms=20.0,
                        forward_factory=factory, device=cuda)
    try:
        assert eng.graphed_buckets == []
        xs = RNG.standard_normal((3, 32, 32, 3)).astype(np.float32)
        got = eng.predict(xs)
        assert 4 in eng.graphed_buckets
        np.testing.assert_array_equal(got, _eager(eng, list(xs), 4))
    finally:
        eng.stop()


@pytest.mark.gpu
def test_host_sync_in_forward_raises_at_warmup(cuda):
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.utils.graphs import GraphCaptureError

    def syncs(_v, x):
        scale = float(x.abs().max())          # a read on the host
        return x.reshape(x.shape[0], -1)[:, :10] * scale

    eng = ServingEngine(None, {}, batch_buckets=(2, 4), forward_fn=syncs,
                        device=cuda)
    try:
        with pytest.raises(GraphCaptureError, match="bucket 2"):
            eng.warmup((8, 8, 1))
        assert eng.graphed_buckets == []
    finally:
        eng.stop()


@pytest.mark.gpu
def test_replay_advances_the_counters_as_an_eager_round(cuda, narrow_resnet):
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.utils import graphs

    tree, factory = narrow_resnet
    counters = graphs.launch_counters()

    def moved(run):
        before = graphs.read_counters(counters)
        run()
        torch.cuda.synchronize()
        after = graphs.read_counters(counters)
        return {k: after[k] - before[k] for k in counters
                if after[k] != before[k]}

    xs = RNG.standard_normal((8, 32, 32, 3)).astype(np.float32)
    eager = ServingEngine(None, tree, batch_buckets=(8,), max_wait_ms=20.0,
                          forward_factory=factory, device=cuda)
    eager.serve_eagerly()
    graphed = ServingEngine(None, tree, batch_buckets=(8,), max_wait_ms=20.0,
                            forward_factory=factory, device=cuda)
    try:
        eager.warmup((32, 32, 3))
        graphed.warmup((32, 32, 3))
        want = moved(lambda: eager.predict(xs))
        got = moved(lambda: graphed.predict(xs))
        assert eager.stats()["rounds_per_bucket"] == {8: 1}
        assert graphed.stats()["rounds_per_bucket"] == {8: 1}
        held = graphed.stats()["graph_launches"][8]
    finally:
        eager.stop()
        graphed.stop()
    assert want and got == want == held
    assert not any(k.endswith("_plain.calls") for k in got)


# ---- the flat engines' entries and calibration's passes, graphed ------------

@pytest.fixture
def narrow_trees(cuda):
    """{"int8": the narrow ResNet's tree, "fp32": its fp32-stem twin}."""
    out = {}
    for kind, exclude in (("int8", ()), ("fp32", ("stem*",))):
        m = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=NARROW["stage_sizes"])
        init_weights(m, torch.Generator().manual_seed(0))
        x = torch.from_numpy(RNG.standard_normal((8, 32, 32, 3)).astype(
            np.float32))
        policy = QuantPolicy.int8_ptq(exclude=exclude)
        out[kind] = freeze(m, policy, calibrate(m, policy, [x]))
    return out


def _entry_input(eng, entry, b, seed):
    rs = np.random.default_rng(seed)
    if entry == "forward_u8":
        return torch.from_numpy(rs.integers(0, 256, (b, 32, 32, 3),
                                            dtype=np.uint8))
    x = torch.from_numpy(rs.standard_normal((b, 32, 32, 3)).astype(
        np.float32))
    if entry == "forward_codes":
        g = eng.stem_grid()
        return tq.quantize_act(x, g.scale, g.zp, symmetric=g.sym)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("entry,tree", [("forward", "int8"),
                                        ("forward_codes", "int8"),
                                        ("forward_u8", "fp32")])
def test_graphed_entries_bit_equal_to_eager(cuda, narrow_trees, entry, tree):
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.utils import graphs

    eng = ResNetInt8Engine(narrow_trees[tree], NARROW, device=cuda)
    counters = graphs.launch_counters()

    def moved(run):
        before = graphs.read_counters(counters)
        out = run()
        torch.cuda.synchronize()
        after = graphs.read_counters(counters)
        return out, {k: after[k] - before[k] for k in counters
                     if after[k] != before[k]}

    eager = getattr(eng, f"eager_{entry}")
    for b in (2, 8):
        for seed in range(3):
            x = _entry_input(eng, entry, b, seed).to(cuda)
            want, n_eager = moved(lambda: eager(x))
            got, n_call = moved(lambda: getattr(eng, entry)(x))
            assert torch.equal(got, want), (b, seed)
            if seed:                     # the first call also warmed up
                assert n_call == n_eager and n_eager, (b, n_call)
    assert sorted(eng.graphs) == [(entry, (2, 32, 32, 3)),
                                  (entry, (8, 32, 32, 3))]
    assert all(g.nbytes > 0 for g in eng.graphs.values())
    assert eng.graphs[entry, (8, 32, 32, 3)].launches == n_eager
    eng.free_graphs()
    assert not eng.graphs


@pytest.mark.gpu
def test_graphed_outputs_are_new_tensors(cuda, narrow_trees):
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    eng = ResNetInt8Engine(narrow_trees["int8"], NARROW, device=cuda)
    xs = [_entry_input(eng, "forward", 4, s) for s in range(4)]
    held = [eng.forward(x) for x in xs]           # on the host: copied in
    assert len({y.data_ptr() for y in held}) == len(held)
    for x, y in zip(xs, held):
        assert torch.equal(y, eng.eager_forward(x))
    assert not torch.equal(held[0], held[1])


@pytest.mark.gpu
def test_graphs_of_changing_batch_sizes_share_one_pool(cuda, narrow_trees):
    """Calls at batch sizes 8, 7, ..., 1 capture eight graphs into the
    engine's one memory pool: the first capture makes it, the later seven
    make no other and grow it by less than one 2 MiB segment in all, where
    a pool of each graph's own takes at least one a graph.  Calls
    alternating between two streams keep every output equal to the eager
    body's; ``free_graphs`` gives the pool back."""
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    eng = ResNetInt8Engine(narrow_trees["int8"], NARROW, device=cuda)
    xs = {b: _entry_input(eng, "forward", b, b).to(cuda)
          for b in range(1, 9)}
    want = {b: eng.eager_forward(x) for b, x in xs.items()}

    def pools():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {seg["segment_pool_id"] for seg in torch.cuda.memory_snapshot()}

    before = pools()
    eng.forward(xs[8])
    after_first = pools()
    ours = after_first - before
    assert len(ours) == 1, (before, after_first)
    for b in range(7, 0, -1):
        eng.forward(xs[b])
    assert not pools() - after_first
    later = [eng.graphs["forward", (b, 32, 32, 3)].nbytes
             for b in range(1, 8)]
    assert len(eng.graphs) == 8 and sum(later) < 2 ** 21, later
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    held = []
    for b in range(8, 0, -1):
        with torch.cuda.stream(side if b % 2 else main):
            held.append((b, eng.forward(xs[b])))
    torch.cuda.synchronize()
    for b, y in held:
        assert torch.equal(y, want[b]), b
    eng.free_graphs()
    assert not pools() & ours


@pytest.mark.gpu
def test_forward_inside_an_outer_capture(cuda, narrow_trees):
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    eng = ResNetInt8Engine(narrow_trees["int8"], NARROW, device=cuda)
    x = _entry_input(eng, "forward", 4, 0).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            eng.eager_forward(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = eng.forward(x)
    assert not eng.graphs                  # no graph nested in the capture
    x.copy_(_entry_input(eng, "forward", 4, 1))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eng.eager_forward(x))


@pytest.mark.gpu
def test_host_sync_in_an_entry_raises(cuda, narrow_trees):
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.utils.graphs import GraphCaptureError

    class Syncs(ResNetInt8Engine):
        def _forward(self, x, **kw):
            scale = float(x.abs().max())          # a read on the host
            return super()._forward(x * (scale / scale), **kw)

    eng = Syncs(narrow_trees["int8"], NARROW, device=cuda)
    x = _entry_input(eng, "forward", 2, 0)
    for _ in range(2):                       # tried again, never eager
        with pytest.raises(GraphCaptureError,
                           match=r"Syncs\.forward at input \(2, 32, 32, 3\)"):
            eng.forward(x)
        assert not eng.graphs
    assert torch.isfinite(eng.eager_forward(x)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("observer", ["minmax", "ema", "kl"])
def test_graphed_calibration_equals_eager(cuda, observer):
    m = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                  stage_sizes=NARROW["stage_sizes"])
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(cuda)
    shapes = [(8, 32, 32, 3)] * 4 + [(3, 32, 32, 3)] + [(8, 32, 32, 3)]
    batches = [(RNG.standard_normal(s) * (1 + 0.3 * i)).astype(np.float32)
               for i, s in enumerate(shapes)]
    policy = QuantPolicy(default=LayerQuantSpec(act_observer=observer))
    ref = calibrate(m, policy, batches, graphed=False)
    got = calibrate(m, policy, batches)
    assert got["quant_stats"].keys() == ref["quant_stats"].keys()
    for p, st in got["quant_stats"].items():
        assert st["count"] == ref["quant_stats"][p]["count"] == len(shapes)
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, ref["quant_stats"][p][k]), (p, k)
    for p, q in got["quant_params"].items():
        for k in ("act_scale", "act_zp"):
            assert torch.equal(q[k], ref["quant_params"][p][k]), (p, k)
