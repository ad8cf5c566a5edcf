"""The flat engines' entry points compiled per input shape: the logic that
needs no card (the graphs themselves run on the card:
tests/test_torch_gpu_serve.py).

* ``entry_plan`` in every case: eager on the CPU, for a tree sliced for
  tensor parallelism and inside an outer capture; else the first call of
  an (entry, shape) captured, every later one replayed.
* The flow of an engine's calls driven on the CPU with the capture replaced
  by a recorder (a graph replays the body's kernels, so the recorder runs
  the body): one capture per (entry, shape), replays after, outputs equal
  to the eager body's; every capture of an engine into its one pool, which
  ``free_graphs`` drops with the graphs; a failed capture raises and
  stores nothing, with no eager fallback; a sliced tree never captures.
* ``dispatch.make_flat_forward``'s factories return the eager bodies
  (``ServingEngine`` compiles per bucket itself); on the CPU ``forward``,
  ``forward_codes`` and ``forward_u8`` agree with the bodies qtpu's
  entries jit, on the same frozen tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import get_model as j_get_model
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.serve.resnet_engine import ResNetInt8Engine as JEngine
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model, freeze as j_freeze
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn import QuantPolicy
from qtpu_torch.ops.qops import quantize_act
from qtpu_torch.serve import dispatch as td
from qtpu_torch.serve import flat_engine
from qtpu_torch.serve.frozen import from_numpy_tree
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
from qtpu_torch.transform import calibrate, freeze
from qtpu_torch.utils.graphs import GraphCaptureError

KEY = jax.random.PRNGKey(0)
RNG = np.random.default_rng(19)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the forwards here are small, and beside the
    suite's other workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the plan -----------------------------------------------------------------

# (device, sharded, capturing, captured) → plan
PLANS = [
    (("cpu", False, False, False), "eager"),
    (("cpu", False, False, True), "eager"),
    (("cpu", True, True, False), "eager"),
    (("cuda", True, False, False), "eager"),
    (("cuda", True, False, True), "eager"),
    (("cuda", False, True, False), "eager"),
    (("cuda", False, True, True), "eager"),
    (("cuda", True, True, False), "eager"),
    (("cuda", False, False, False), "capture"),
    (("cuda", False, False, True), "replay"),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_entry_plan(args, want):
    assert flat_engine.entry_plan(*args) == want


# ---- the flow, the capture recorded ------------------------------------------

ARCH = dict(stage_sizes=(1, 1, 1, 1), width=8, bottleneck=True,
            cifar_stem=True, num_classes=10)


@pytest.fixture(scope="module")
def tree():
    """A narrow ResNet frozen on the CPU (int8 CIFAR stem)."""
    m = get_model("resnet50", num_classes=10, cifar_stem=True, width=8,
                  stage_sizes=ARCH["stage_sizes"])
    init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(RNG.standard_normal((4, 16, 16, 3)).astype(
        np.float32))
    policy = QuantPolicy.int8_ptq()
    return freeze(m, policy, calibrate(m, policy, [x]))


class _Recorder:
    """Stands in for ``capture_forward`` on the CPU: a capture is logged
    and stores a graph whose call runs the body again and copies it out, as
    a replay runs the body's kernels; ``fail`` makes the capture raise."""

    def __init__(self, fail=False):
        self.log = []
        self.pools = []
        self.names = []
        self.fail = fail

    def capture(self, forward, x, device, what, pool, name):
        self.log.append(("capture", what))
        self.pools.append(pool)
        self.names.append(name)
        if self.fail:
            raise GraphCaptureError(f"{what} cannot be captured as a CUDA "
                                    "graph (a host sync)")
        rec = self

        class Graph:
            nbytes = 100

            def call(self, xx):
                rec.log.append(("replay", tuple(xx.shape), xx.dtype))
                return forward(xx).clone()
        return Graph()


def _on_card(monkeypatch, fail=False):
    """The engine's calls planned as on a card, captures recorded."""
    rec = _Recorder(fail)
    plan = flat_engine.entry_plan
    monkeypatch.setattr(flat_engine, "entry_plan",
                        lambda _dev, *a: plan("cuda", *a))
    monkeypatch.setattr(flat_engine, "capture_forward", rec.capture)
    monkeypatch.setattr(flat_engine, "GraphPool", object)
    return rec


def _codes(eng, x):
    g = eng.stem_grid()
    return quantize_act(x, g.scale, g.zp, symmetric=g.sym)


def test_one_graph_per_entry_and_shape(tree, monkeypatch):
    eng = ResNetInt8Engine(tree, ARCH, device="cpu")
    x4 = torch.from_numpy(RNG.standard_normal((4, 16, 16, 3)).astype(
        np.float32))
    x2 = x4[:2].clone()
    ref4, ref2 = eng.eager_forward(x4), eng.eager_forward(x2)
    refc = eng.eager_forward_codes(_codes(eng, x4))
    rec = _on_card(monkeypatch)
    got = [eng.forward(x4), eng.forward(x4), eng.forward(x2),
           eng.forward_codes(_codes(eng, x4)), eng.forward(x2)]
    name = "ResNetInt8Engine"
    assert rec.log == [
        ("capture", f"{name}.forward at input (4, 16, 16, 3) torch.float32"),
        ("replay", (4, 16, 16, 3), torch.float32),
        ("replay", (4, 16, 16, 3), torch.float32),
        ("capture", f"{name}.forward at input (2, 16, 16, 3) torch.float32"),
        ("replay", (2, 16, 16, 3), torch.float32),
        ("capture", f"{name}.forward_codes at input (4, 16, 16, 3) "
                    "torch.int8"),
        ("replay", (4, 16, 16, 3), torch.int8),
        ("replay", (2, 16, 16, 3), torch.float32)]
    assert sorted(eng.graphs) == [("forward", (2, 16, 16, 3)),
                                  ("forward", (4, 16, 16, 3)),
                                  ("forward_codes", (4, 16, 16, 3))]
    assert sum(g.nbytes for g in eng.graphs.values()) == 300
    for y, ref in zip(got, (ref4, ref4, ref2, refc, ref2)):
        assert torch.equal(y, ref)
    assert got[0] is not got[1]
    # one pool for all of the engine's graphs, each named by its entry
    assert len(rec.pools) == 3 and all(p is rec.pools[0] for p in rec.pools)
    assert rec.names == ["forward", "forward", "forward_codes"]
    # the eager bodies never touch the graphs
    n = len(rec.log)
    assert torch.equal(eng.eager_forward(x4), ref4) and len(rec.log) == n
    with pytest.raises(ValueError, match="expected torch.float32"):
        eng.forward(x4.double())


def test_free_graphs_drops_the_pool(tree, monkeypatch):
    """``free_graphs`` drops the graphs and their pool: the next call
    captures again, into a new pool, and each engine has its own."""
    eng = ResNetInt8Engine(tree, ARCH, device="cpu")
    other = ResNetInt8Engine(tree, ARCH, device="cpu")
    x = torch.from_numpy(RNG.standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    rec = _on_card(monkeypatch)
    y = eng.forward(x)
    eng.free_graphs()
    assert not eng.graphs and eng._pool is None
    assert torch.equal(eng.forward(x), y)
    other.forward(x)
    assert [e[0] for e in rec.log] == ["capture", "replay"] * 3
    p1, p2, p3 = rec.pools
    assert p1 is not p2 and p3 not in (p1, p2)


def test_failed_capture_raises_without_fallback(tree, monkeypatch):
    eng = ResNetInt8Engine(tree, ARCH, device="cpu")
    calls = []
    body = eng._forward
    monkeypatch.setattr(eng, "_forward", lambda *a, **k: (
        calls.append(1), body(*a, **k))[1])
    rec = _on_card(monkeypatch, fail=True)
    x = torch.zeros((2, 16, 16, 3))
    with pytest.raises(GraphCaptureError,
                       match=r"forward at input \(2, 16, 16, 3\)"):
        eng.forward(x)
    assert not eng.graphs and not calls
    with pytest.raises(GraphCaptureError):
        eng.forward(x)                       # tried again, not run eagerly
    assert [e[0] for e in rec.log] == ["capture", "capture"] and not calls


def test_sliced_tree_runs_eagerly(tree, monkeypatch):
    """A node tagged ``_tp`` (``parallel.mesh.shard_variables``' slices)
    makes the engine eager: gloo's all-gathers go through the host."""
    sliced = {**tree, "qweights": {**tree["qweights"], "fc": {
        **tree["qweights"]["fc"], "_tp": None}}}
    eng = ResNetInt8Engine(sliced, ARCH, device="cpu")
    assert eng._sharded
    assert not ResNetInt8Engine(tree, ARCH, device="cpu")._sharded
    rec = _on_card(monkeypatch)
    x = torch.zeros((2, 16, 16, 3))
    eng.forward(x)
    eng.forward(x)
    assert rec.log == [] and not eng.graphs


# ---- dispatch's factories, and the bodies qtpu's entries jit -------------------

@pytest.fixture(scope="module")
def rn20_tree():
    """ResNet-20 (3 stages of 3 BasicBlocks, width 16, 32² CIFAR stem)
    frozen on the CPU; its fp32-stem twin."""
    out = {}
    for exclude in ((), ("stem*",)):
        m = get_model("resnet20", num_classes=10, cifar_stem=True)
        init_weights(m, torch.Generator().manual_seed(1))
        x = torch.from_numpy(RNG.standard_normal((2, 32, 32, 3)).astype(
            np.float32))
        policy = QuantPolicy.int8_ptq(exclude=exclude)
        out[exclude] = freeze(m, policy, calibrate(m, policy, [x]))
    return out


@pytest.mark.parametrize("uint8_ingest,exclude,entry", [
    (False, (), "forward"), (True, (), "forward_codes"),
    (True, ("stem*",), "forward_u8")])
def test_factories_return_eager_bodies(rn20_tree, uint8_ingest, exclude,
                                       entry):
    factory = td.make_flat_forward(
        "resnet20", exclude=exclude, num_classes=10, image_size=32,
        uint8_ingest=uint8_ingest, device="cpu")[0]
    fn = factory(rn20_tree[exclude])
    eng = fn.__self__
    assert isinstance(eng, ResNetInt8Engine)
    assert fn.__func__ is getattr(ResNetInt8Engine, f"eager_{entry}")
    x = RNG.standard_normal((2, 32, 32, 3)).astype(np.float32)
    if entry == "forward_codes":
        x = _codes(eng, torch.from_numpy(x))
    elif entry == "forward_u8":
        x = torch.from_numpy(RNG.integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8))
    else:
        x = torch.from_numpy(x)
    assert torch.equal(fn(x), getattr(eng, entry)(x))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("exclude", [(), ("stem*",)])
def test_entries_match_the_bodies_qtpu_jits(exclude):
    """qtpu's frozen tree of a narrow bottleneck ResNet (32², stages
    1-1-1-1) on both engines: ``forward`` and, by the stem,
    ``forward_codes`` (int8 stem) or ``forward_u8`` (fp32 stem) against
    the bodies qtpu's entries jit, run op by op, rel-L2 ≤ 1e-4, as
    tests/test_torch_engine.py holds the forward (under ``jax.jit`` XLA
    contracts the epilogues into FMAs and moves codes at ties: here the
    jitted forward is 3.5e-3 off the op-by-op one)."""
    size, arch = 32, dict(ARCH, width=16)
    m = j_get_model("resnet50", num_classes=10, cifar_stem=True,
                    width=16).clone(stage_sizes=(1, 1, 1, 1))
    x = jax.random.normal(KEY, (2, size, size, 3))
    qm = convert_model(m, JPolicy.int8_ptq(exclude=exclude))
    v = dict(jax.jit(qm.init, static_argnames="train")(KEY, x, train=True))
    _, mut = jax.jit(lambda v, xx: qm.apply(
        v, xx, train=True, mutable=["batch_stats", "quant_stats"]))(
            v, jax.random.normal(jax.random.fold_in(KEY, 1), x.shape))
    v.update(mut)
    v = j_calibrate(qm, v, [x])
    _, sv = j_freeze(qm, v, x)
    norm = ((0.5, 0.4, 0.45), (0.25, 0.3, 0.2))
    jeng = JEngine(sv, arch, use_pallas=False, normalize=norm)
    teng = ResNetInt8Engine(from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, sv), device="cpu"), arch,
        device="cpu", normalize=norm)
    xn = np.array(x)
    got = teng.forward(torch.from_numpy(xn)).numpy()
    assert _rel_l2(got, jeng._forward(x)) <= 1e-4
    if not exclude:
        codes = _codes(teng, torch.from_numpy(xn))
        got_c = teng.forward_codes(codes).numpy()
        ref_c = jeng._forward(jnp.asarray(codes.numpy()), pre_quantized=True)
        assert _rel_l2(got_c, ref_c) <= 1e-4
        return
    x8 = RNG.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    got_u8 = teng.forward_u8(torch.from_numpy(x8)).numpy()
    ref_u8 = jeng._forward(jnp.asarray(x8), raw_u8=True)
    assert _rel_l2(got_u8, ref_u8) <= 1e-4
