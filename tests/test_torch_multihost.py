"""Lockstep serving over several ranks: real OS processes on the gloo CPU
backend (mirrors tests/test_multihost.py, and the wedged-peer case of
tests/test_serve_cli.py).

* Four ranks serve a (data = 2, model = 2) mesh — qtpu's two processes of
  two devices each, one process per rank here — a frozen int8 LeNet-5
  through ``ServingEngine``'s lockstep scheduler.  Each rank submits its
  own distinct requests, unequal counts (3, 2, 2, 1), so the last round
  has idle ranks contributing zero shares, and gets exactly its own rows:
  bit-equal to the unsharded port model on the same tree and within the
  port's module-path tolerance (rel-L2 ≤ 1e-4) of qtpu's logits, which
  the parent computes as tests/multihost_worker.py does.
* A wedged peer (C16): two ranks warm up, the parent stops rank 1 with
  ``SIGSTOP`` and only then lets rank 0 submit; rank 0's round watchdog
  fails the in-flight future with a ``TimeoutError`` naming
  ``round_timeout_s``, turns ``healthy`` false, and refuses later
  requests.  The round's age when the watchdog fired lies between
  ``round_timeout_s`` and ``round_timeout_s`` plus one period (and a
  scheduling allowance) — measured on rank 0's own clock from the round's
  start, so it does not depend on when the peer stopped.
* qtpu's overlap-flag case has no counterpart (libtpu flags, ROADMAP.md
  A13); its place is taken by ``initialize_from_env``'s no-op and
  idempotence.

Ranks run as ``python tests/test_torch_multihost.py <role> <dir>``.
"""
import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = (3, 2, 2, 1)          # requests per rank: the last round is uneven
ROUND_TIMEOUT_S = 2.0


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)


def _cmd(role, d):
    return [sys.executable, os.path.abspath(__file__), role, str(d)]


@pytest.fixture(scope="module")
def lenet(tmp_path_factory):
    """qtpu's frozen LeNet-5 and logits, built as the qtpu worker builds
    them, the tree saved in the port's format."""
    import jax
    import jax.numpy as jnp

    from qtpu.models import get_model
    from qtpu.nn import QuantPolicy
    from qtpu.transform import calibrate, convert_model, freeze
    from qtpu_torch.serve.frozen import from_numpy_tree
    from qtpu_torch.utils import checkpoint as ckpt

    d = tmp_path_factory.mktemp("multihost")
    key = jax.random.PRNGKey(0)
    x0 = jax.random.normal(key, (4, 28, 28, 1))
    qm = convert_model(get_model("lenet5", num_classes=10),
                       QuantPolicy.int8_ptq())
    qv = jax.jit(qm.init, static_argnames="train")(key, x0, train=True)
    qv = calibrate(qm, dict(qv), [x0])
    smodel, svars = freeze(qm, qv, x0)
    imgs = np.asarray(jax.random.normal(jax.random.fold_in(key, 9),
                                        (8, 28, 28, 1)))
    ref = np.asarray(smodel.apply(svars, jnp.asarray(imgs)))
    ckpt.save(str(d / "lenet"), from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, svars), device="cpu"))
    np.save(d / "imgs.npy", imgs)
    return d, ref


def test_four_rank_lockstep_serving(lenet):
    from qtpu_torch.parallel.launch import run_world

    d, ref = lenet
    res = run_world(_cmd("serve", d), 4, str(d / "rdzv_serve"),
                    timeout_s=60, backend="gloo", env=_env())
    start = 0
    for r, n in zip(res, COUNTS):
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
        o = torch.load(d / f"serve_rank{r.rank}.pt", weights_only=False)
        rows = slice(start, start + n)
        start += n
        assert o["got"].shape == (n, 10)
        np.testing.assert_array_equal(o["got"], o["local"][rows])
        assert rel_l2(o["got"], ref[rows]) <= 1e-4
        assert (o["got"].argmax(-1) == ref[rows].argmax(-1)).all()
        assert o["stats"]["images"] == n
        # two rounds: every rank's share of bucket 8 is 2 rows
        assert o["stats"]["batches"] == 2 and o["buckets"] == (4, 8)


def test_wedged_peer_round_timeout(lenet):
    from qtpu_torch.parallel.launch import join_world, kill_world, start_world

    d, _ = lenet
    procs = start_world(_cmd("wedge", d), 2, str(d / "rdzv_wedge"),
                        backend="gloo", env=_env())
    try:
        deadline = time.monotonic() + 60
        while not all((d / f"ready{r}").exists() for r in range(2)):
            assert time.monotonic() < deadline, "ranks never warmed up"
            assert all(p.poll() is None for p, _ in procs), \
                [out.read_text() for _, out in procs]
            time.sleep(0.05)
        os.kill(procs[1][0].pid, signal.SIGSTOP)      # the wedged peer
        (d / "go").write_text("")
        rank0 = join_world(procs[:1], 60)[0]
    finally:
        kill_world(procs)
    assert rank0.returncode == 0, rank0.output
    o = json.loads((d / "wedge.json").read_text())
    assert o["error"] == "TimeoutError" and "round_timeout_s" in o["message"]
    assert o["healthy"] is False and o["submit_refused"]
    period = max(0.05, min(1.0, ROUND_TIMEOUT_S / 4))
    assert ROUND_TIMEOUT_S < o["age"] <= ROUND_TIMEOUT_S + period + 3.0, o


def test_initialize_from_env_noop_and_idempotent(monkeypatch):
    import torch.distributed as dist

    from qtpu_torch import parallel

    for k in ("QTPU_COORDINATOR", "QTPU_NUM_PROCESSES", "QTPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_from_env() is False
    assert parallel.initialize_from_env() is False
    assert not dist.is_initialized()
    assert not hasattr(parallel, "enable_overlap_flags")


# -- the ranks (no JAX) -------------------------------------------------------

def _engine(d, mesh, **kw):
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.nn.serve_layers import serve_model
    from qtpu_torch.parallel import shard_variables
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.utils import checkpoint as ckpt

    tree = ckpt.load(os.path.join(d, "lenet"))
    pol = QuantPolicy.int8_ptq()
    model = serve_model("lenet5", pol, shard_variables(tree, mesh),
                        device="cpu", num_classes=10)
    local = serve_model("lenet5", pol, tree, device="cpu", num_classes=10)
    eng = ServingEngine(model, tree, mesh=mesh, batch_buckets=(2, 4, 8),
                        device="cpu", **kw)
    eng.warmup((28, 28, 1))
    return eng, local


def _rank_serve(d):
    import torch.distributed as dist

    from qtpu_torch.parallel import initialize_from_env, make_mesh

    initialize_from_env(backend="gloo")
    rank = dist.get_rank()
    sync = dist.new_group(backend="gloo")
    eng, local = _engine(d, make_mesh(dp=2, tp=2), max_wait_ms=50.0)
    imgs = np.load(os.path.join(d, "imgs.npy"))
    start = sum(COUNTS[:rank])
    got = eng.predict(imgs[start:start + COUNTS[rank]])
    dist.barrier(group=sync)          # every rank served before any stops
    eng.stop()
    torch.save(dict(got=got, local=local(torch.from_numpy(imgs)).numpy(),
                    stats=eng.stats(), buckets=eng.buckets),
               os.path.join(d, f"serve_rank{rank}.pt"))
    return 0


def _rank_wedge(d):
    import torch.distributed as dist

    from qtpu_torch.parallel import initialize_from_env, make_mesh

    initialize_from_env(backend="gloo")
    rank = dist.get_rank()
    eng, _ = _engine(d, make_mesh(dp=2, tp=1), max_wait_ms=10.0,
                     round_timeout_s=ROUND_TIMEOUT_S)
    open(os.path.join(d, f"ready{rank}"), "w").close()
    if rank == 1:                     # serves idle rounds until stopped
        time.sleep(600)
        return 1
    while not os.path.exists(os.path.join(d, "go")):
        time.sleep(0.02)
    fut = eng.submit(np.zeros((28, 28, 1), np.float32))
    try:
        fut.result(timeout=60)
        err = None
    except Exception as e:            # noqa: BLE001 — reported below
        err = e
    try:
        eng.submit(np.zeros((28, 28, 1), np.float32))
        refused = False
    except RuntimeError:
        refused = True
    with open(os.path.join(d, "wedge.json"), "w") as f:
        json.dump(dict(error=type(err).__name__, message=str(err),
                       healthy=eng.healthy, submit_refused=refused,
                       age=eng.round_age_at_timeout), f)
    sys.stdout.flush()
    os._exit(0)     # the scheduler thread is stuck in the collective


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
