"""qtpu_torch's meshes, tensor-parallel serving and lockstep engine on a
world of four CPU ranks (gloo), against qtpu (mirrors tests/test_parallel.py
case for case).

The parent pytest process builds qtpu's frozen LeNet-5 (int8 PTQ) and a
narrowed ResNet-18 (CIFAR stem, stage sizes (1, 1, 1, 1), width 16: qtpu's
case at a quarter of its width) and their logits — qtpu's unsharded
forwards, which tests/test_parallel.py holds equal to its sharded ones —
and hands the trees (in the port's format) and inputs to four worker ranks
that import no JAX (``python tests/test_torch_parallel.py world <dir>``,
``file://`` rendezvous, one thread each, killed past their deadline).  The
ranks run:

* ``make_mesh`` shapes and its refusal;
* LeNet-5's module SERVE path over ``shard_variables`` at (dp, tp) = (2, 2)
  and (1, 4): logits bit-equal to the unsharded port model, and to qtpu's
  to rel-L2 ≤ 1e-4 (the port's module-path tolerance against qtpu,
  tests/test_torch_module_serve.py); the all-gathers the TP forward issues
  are counted;
* ``ServingEngine`` with ``mesh=`` (2, 2): each rank submits its own rows
  and gets exactly those rows' logits;
* the flat ``ResNetInt8Engine`` as a forward factory over the sliced tree
  at (2, 2), bit-equal to the unsharded port engine and within the port's
  engine tolerance of qtpu's (rel-L2 ≤ 1e-4, tests/test_torch_engine.py);
* a QAT train step with ``mesh=`` (dp = 4): finite loss, replicated shapes.

The single-rank cases (one request at a time, a custom ``forward_fn``, a
crashing scheduler) run in the parent.  qtpu's ``collective_report`` cases
parse XLA's HLO, which the port has not: their counterparts read the
port's own collective counts.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_ARCH = dict(stage_sizes=(1, 1, 1, 1), width=16, bottleneck=False,
                   cifar_stem=True, num_classes=10)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def run_ranks(role, n, d, timeout_s=60.0):
    """Run this file as ``n`` ranks of ``role``; each rank's saved result."""
    from qtpu_torch.parallel.launch import run_world

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = run_world([sys.executable, os.path.abspath(__file__), role,
                     str(d)], n, os.path.join(d, f"rdzv_{role}"),
                    timeout_s=timeout_s, backend="gloo", env=env)
    for r in res:
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
    return [torch.load(os.path.join(d, f"{role}_rank{r}.pt"),
                       weights_only=False) for r in range(n)]


# -- the parent: qtpu's references, the world, the assertions -----------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from qtpu.models import get_model as j_get_model
    from qtpu.nn import QuantPolicy as JPolicy
    from qtpu.serve.resnet_engine import ResNetInt8Engine as JEngine
    from qtpu.transform import calibrate as j_calibrate
    from qtpu.transform import convert_model, freeze as j_freeze
    from qtpu_torch.serve.frozen import from_numpy_tree
    from qtpu_torch.utils import checkpoint as ckpt

    d = str(tmp_path_factory.mktemp("parallel"))
    key = jax.random.PRNGKey(0)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731

    m = j_get_model("lenet5")
    x = jax.random.normal(key, (8, 28, 28, 1))
    qm = convert_model(m, JPolicy.int8_ptq())
    qv = jax.jit(qm.init)(key, x)
    qv = j_calibrate(qm, qv, [x])
    sm, sv = j_freeze(qm, qv, x)
    lenet_ref = np.asarray(sm.apply(sv, x))
    ckpt.save(os.path.join(d, "lenet"), from_numpy_tree(np_tree(sv),
                                                         device="cpu"))

    rm = j_get_model("resnet18", num_classes=10, cifar_stem=True,
                     width=16).clone(stage_sizes=(1, 1, 1, 1))
    xr = jax.random.normal(key, (8, 32, 32, 3))
    qr = convert_model(rm, JPolicy.int8_ptq())
    v = dict(jax.jit(qr.init, static_argnames="train")(key, xr, train=True))
    v = j_calibrate(qr, v, [xr])
    _, rsv = j_freeze(qr, v, xr)
    rn_ref = np.asarray(JEngine(rsv, RESNET_ARCH, use_pallas=False)._forward(
        jnp.asarray(xr)))
    ckpt.save(os.path.join(d, "resnet"), from_numpy_tree(np_tree(rsv),
                                                         device="cpu"))
    np.savez(os.path.join(d, "inputs.npz"), x=np.asarray(x),
             xr=np.asarray(xr))
    out = run_ranks("world", 4, d)
    return dict(out=out, lenet_ref=lenet_ref, rn_ref=rn_ref, dir=d,
                x=np.asarray(x))


def test_four_ranks_available(world):
    for r, o in enumerate(world["out"]):
        assert o["world"] == (4, r, "cpu")


def test_make_mesh_shapes(world):
    o = world["out"][0]
    assert o["mesh_shape"] == {"data": 2, "model": 2}
    assert o["bad_mesh"] == "ValueError"
    assert [w["coords"] for w in world["out"]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_specs_and_rank_devices(world):
    """qtpu's sharding rules by leaf (kernel_q on its last axis, the 1-D
    per-channel vectors alike, the grid replicated), the batch over
    'data', and one device a rank."""
    for o in world["out"]:
        s = o["fc1_specs"]
        assert s["kernel_q"] == (None, "model")
        assert s["w_scale"] == s["colsum"] == s["bias"] == ("model",)
        assert s["act_scale"] == s["act_zp"] == ()
        assert o["batch_spec"] == ("data",)
        assert o["local_devices"] == ["cpu"]


def test_sharded_forward_matches_single_device(world):
    for o in world["out"]:
        y = o["lenet"][(2, 2)]
        # fc1 kernel (400, 120): 120 % 2 == 0 -> sharded over 'model'
        assert o["fc1_sharded"][(2, 2)]
        np.testing.assert_array_equal(y, o["lenet_tp1"])
        assert rel_l2(y, world["lenet_ref"]) <= 1e-4


def test_tp_only_mesh(world):
    for o in world["out"]:
        y = o["lenet"][(1, 4)]
        np.testing.assert_array_equal(y, o["lenet_tp1"])
        assert rel_l2(y, world["lenet_ref"]) <= 1e-4
        # conv1 (6 channels) does not divide by 4: replicated
        assert not o["conv1_sharded"][(1, 4)] and o["conv1_sharded"][(2, 2)]


def test_serving_engine_end_to_end(world):
    for r, o in enumerate(world["out"]):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(o["served"], o["lenet_tp1"][rows])
        assert rel_l2(o["served"], world["lenet_ref"][rows]) <= 1e-4
        assert o["served_stats"]["images"] == 2
        assert o["served_stats"]["p99_ms"] > 0
        assert o["buckets"] == (4, 8)       # (1, 2, 4, 8) in multiples of 4


def test_dp_train_step_on_mesh(world):
    for o in world["out"]:
        assert np.isfinite(o["train_loss"])
        assert o["conv1_kernel"] == (6, 1, 5, 5)
    # the state stays replicated
    k = [o["conv1_value"] for o in world["out"]]
    for other in k[1:]:
        np.testing.assert_array_equal(other, k[0])


def test_collective_counts_of_the_tp_forward(world):
    """Counterpart of qtpu's collective_report (HLO) case: the port counts
    its collectives itself — one all-gather per sharded layer of LeNet-5's
    forward at tp = 2 (its five layers all divide), none staged on the
    host on the CPU."""
    for o in world["out"]:
        assert o["counts_tp2"]["all_gather"] == 5
        assert o["counts_tp2"].get("all_gather.host_staged", 0) == 0


def test_tp_serve_emits_collectives(world):
    """Counterpart of the virtual-mesh HLO case: the TP serve forward
    issues all-gathers over the model group, the unsharded one none."""
    for o in world["out"]:
        assert o["counts_tp4"]["all_gather"] > 0
        assert o["counts_tp1"].get("all_gather", 0) == 0


def test_serving_engine_flat_resnet_forward_tp(world):
    for r, o in enumerate(world["out"]):
        np.testing.assert_array_equal(o["rn_tp"], o["rn_tp1"])
        assert rel_l2(o["rn_tp1"], world["rn_ref"]) <= 1e-4
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(o["rn_served"], o["rn_tp1"][rows])


# -- single rank (the parent itself) ------------------------------------------

@pytest.fixture(scope="module")
def lenet_local(world):
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.nn.serve_layers import serve_model
    from qtpu_torch.utils import checkpoint as ckpt

    tree = ckpt.load(os.path.join(world["dir"], "lenet"))
    return serve_model("lenet5", QuantPolicy.int8_ptq(), tree, device="cpu",
                       num_classes=10), tree


def test_serving_engine_single_requests(world, lenet_local):
    from qtpu_torch.serve.engine import ServingEngine

    sm, tree = lenet_local
    eng = ServingEngine(sm, tree, batch_buckets=(1, 2, 4), max_wait_ms=1.0,
                        device="cpu")
    try:
        futs = [eng.submit(world["x"][i]) for i in range(3)]
        outs = [f.result(timeout=120) for f in futs]
        assert all(o.shape == (10,) for o in outs)
    finally:
        eng.stop()


def test_serving_engine_with_flat_engine_forward(world, lenet_local):
    from qtpu_torch.serve.engine import ServingEngine

    sm, tree = lenet_local
    calls = []

    def fwd(variables, batch):
        calls.append(1)
        return sm(batch)

    eng = ServingEngine(sm, tree, batch_buckets=(4, 8), max_wait_ms=5.0,
                        forward_fn=fwd, device="cpu")
    try:
        out = eng.predict(world["x"][:4])
        assert out.shape == (4, 10)
        assert calls
    finally:
        eng.stop()


def test_serving_engine_scheduler_crash_fails_futures(world, lenet_local):
    from qtpu_torch.serve.engine import ServingEngine

    sm, tree = lenet_local

    def boom(_v, _x):
        raise RuntimeError("device exploded")

    eng = ServingEngine(sm, tree, batch_buckets=(1, 2), max_wait_ms=1.0,
                        forward_fn=boom, device="cpu")
    try:
        assert eng.healthy
        futs = [eng.submit(world["x"][i]) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        deadline = time.monotonic() + 30
        while eng.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.healthy
        with pytest.raises(RuntimeError):
            eng.submit(world["x"][0])
    finally:
        eng.stop()


# -- the ranks (no JAX) -------------------------------------------------------

def _rank_world(d):
    import torch.distributed as dist

    from qtpu_torch.models import get_model, init_weights
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.nn.serve_layers import serve_model
    from qtpu_torch.parallel import (batch_sharding, collectives,
                                     distributed, initialize_from_env,
                                     make_mesh, process_local_devices,
                                     serve_variable_specs, shard_variables)
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.train import create_train_state, train_step
    from qtpu_torch.transform import convert_model
    from qtpu_torch.utils import checkpoint as ckpt

    initialize_from_env(backend="gloo")
    rank = dist.get_rank()
    sync = dist.new_group(backend="gloo")
    inp = np.load(os.path.join(d, "inputs.npz"))
    x, xr = torch.from_numpy(inp["x"]), torch.from_numpy(inp["xr"])
    out = {"world": (dist.get_world_size(), rank,
                     str(distributed.rank_device("cpu")))}
    mesh = make_mesh(dp=2, tp=2)
    out["mesh_shape"] = mesh.shape
    out["coords"] = (mesh.coord("data"), mesh.coord("model"))
    try:
        make_mesh(dp=3, tp=2)
    except ValueError:
        out["bad_mesh"] = "ValueError"
    out["batch_spec"] = tuple(batch_sharding(mesh))
    out["local_devices"] = [str(d) for d in process_local_devices("cpu")]

    tree = ckpt.load(os.path.join(d, "lenet"))
    specs = serve_variable_specs(tree)["qweights"]["fc1"]
    out["fc1_specs"] = {k: tuple(v) for k, v in specs.items()}
    pol = QuantPolicy.int8_ptq()
    lenet = lambda t: serve_model("lenet5", pol, t, device="cpu",  # noqa
                                  num_classes=10)
    out["lenet_tp1"] = lenet(tree)(x).numpy()
    out["lenet"], out["fc1_sharded"], out["conv1_sharded"] = {}, {}, {}
    for dp, tp in ((2, 2), (1, 4)):
        sv = shard_variables(tree, make_mesh(dp=dp, tp=tp))
        model = lenet(sv)
        collectives.reset_counts()
        out["lenet"][(dp, tp)] = model(x).numpy()
        out[f"counts_tp{tp}"] = dict(collectives.counts)
        out["fc1_sharded"][(dp, tp)] = "_tp" in sv["qweights"]["fc1"]
        out["conv1_sharded"][(dp, tp)] = "_tp" in sv["qweights"]["conv1"]
    collectives.reset_counts()
    lenet(tree)(x)
    out["counts_tp1"] = dict(collectives.counts)

    sv = shard_variables(tree, mesh)
    eng = ServingEngine(lenet(sv), tree, mesh=mesh,
                        batch_buckets=(1, 2, 4, 8), max_wait_ms=20.0,
                        device="cpu")
    eng.warmup((28, 28, 1))
    out["served"] = eng.predict(x[2 * rank:2 * rank + 2].numpy())
    out["served_stats"] = eng.stats()
    out["buckets"] = eng.buckets
    dist.barrier(group=sync)
    eng.stop()

    rtree = ckpt.load(os.path.join(d, "resnet"))
    out["rn_tp1"] = ResNetInt8Engine(rtree, RESNET_ARCH,
                                     device="cpu").forward(xr).numpy()
    out["rn_tp"] = ResNetInt8Engine(shard_variables(rtree, mesh), RESNET_ARCH,
                                    device="cpu").forward(xr).numpy()
    eng = ServingEngine(None, rtree, mesh=mesh, batch_buckets=(8,),
                        max_wait_ms=5.0, device="cpu",
                        forward_factory=lambda s: ResNetInt8Engine(
                            s, RESNET_ARCH, device="cpu").forward)
    eng.warmup((32, 32, 3))
    out["rn_served"] = eng.predict(xr[2 * rank:2 * rank + 2].numpy())
    dist.barrier(group=sync)
    eng.stop()

    fp32 = get_model("lenet5")
    init_weights(fp32, torch.Generator().manual_seed(0))   # same on every rank
    model = convert_model(fp32, QuantPolicy.int8_qat())
    state = create_train_state(model)
    g = np.random.default_rng(0)
    xs = g.standard_normal((16, 28, 28, 1)).astype(np.float32)
    m = train_step(state, xs, np.zeros(16, np.int64),
                   mesh=make_mesh(dp=4, tp=1))
    out["train_loss"] = float(m["loss"])
    out["conv1_kernel"] = tuple(model.conv1.conv.weight.shape)
    out["conv1_value"] = model.conv1.conv.weight.detach().numpy()
    torch.save(out, os.path.join(d, f"world_rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
