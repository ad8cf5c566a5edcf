"""Data-parallel training on a world of four CPU ranks (gloo) against
qtpu's single-device step (mirrors tests/test_dp_train.py case for case).

The parent computes qtpu's three AdamW steps of LeNet-5 — fp32 and int8
QAT (EMA observers) — on the global batch of 16, as tests/test_dp_train.py
does, and hands the initial state and the batches to four worker ranks
that import no JAX (``python tests/test_torch_dp_train.py dp <dir>``).
Each rank carries qtpu's initial state into the port's model and takes the
same three steps with ``train_step(..., mesh=make_mesh(dp=4))``, four rows
a rank.  Held, with qtpu's bounds — losses rtol 1e-4, every parameter and
observer buffer rtol 2e-4 / atol 2e-5:

* the DP step against qtpu's single-device step on the global batch;
* the DP step against the port's own single-process step on it (rank 0
  takes those too);
* the state replicated: every rank's parameters, buffers and AdamW
  moments bit-equal;
* a global batch that does not divide by the data axis raises
  ``ValueError`` ("divide") from ``fit``;
* ``run_experiment(..., dp=4)`` runs the whole LeNet-5 experiment (fp32
  fit → PTQ → eval) data-parallel and prints qtpu's keys.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, DP = 3, 16, 4


def _assert_state(got, want, what):
    for k, w in want.items():
        if w.dtype.is_floating_point:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(),
                                          err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    import jax
    import optax

    from qtpu.models import get_model as j_get_model
    from qtpu.nn import QuantPolicy as JPolicy
    from qtpu.train import create_train_state, make_train_step
    from qtpu.transform import convert_model as j_convert
    from qtpu_torch.parallel.launch import run_world

    d = tmp_path_factory.mktemp("dp_train")
    key = jax.random.PRNGKey(0)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    xs, ys = [], []
    for i in range(STEPS):
        kx = jax.random.fold_in(key, i)
        xs.append(np.asarray(jax.random.normal(kx, (BATCH, 28, 28, 1))))
        ys.append(np.asarray(jax.random.randint(jax.random.fold_in(kx, 1),
                                                (BATCH,), 0, 10)))
    np.savez(d / "batches.npz", x=np.stack(xs), y=np.stack(ys))
    ref = {}
    for quantized in (False, True):
        model = j_get_model("lenet5")
        if quantized:
            model = j_convert(model, JPolicy.int8_qat())
        tx = optax.adamw(1e-3)
        st = create_train_state(model, key, jax.numpy.zeros((2, 28, 28, 1)),
                                tx)
        init = np_tree(st.variables())
        step = make_train_step(model, tx)
        losses = []
        for x, y in zip(xs, ys):
            st, m = step(st, x, y)
            losses.append(float(m["loss"]))
        ref[quantized] = dict(init=init, final=np_tree(st.variables()),
                              losses=losses)
    torch.save({q: r["init"] for q, r in ref.items()}, d / "init.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = run_world([sys.executable, os.path.abspath(__file__), "dp",
                     str(d)], DP, str(d / "rdzv"), timeout_s=90,
                    backend="gloo", env=env)
    for r in res:
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
    out = [torch.load(d / f"dp_rank{r}.pt", weights_only=False)
           for r in range(DP)]
    return out, ref


def _port_state(variables, quantized):
    """qtpu's variables carried into the port's model, as a state_dict."""
    from qtpu_torch.models import get_model, load_flax_variables
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.transform import convert_model

    m = get_model("lenet5")
    if quantized:
        m = convert_model(m, QuantPolicy.int8_qat())
    load_flax_variables(m, variables["params"],
                        variables.get("batch_stats", {}),
                        variables.get("quant_stats"),
                        variables.get("quant_params"))
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("quantized", [False, True])
def test_dp_step_equivalence(dp, quantized):
    out, ref = dp
    got = out[0]["runs"][quantized]
    np.testing.assert_allclose(got["losses"], ref[quantized]["losses"],
                               rtol=1e-4)
    want = _port_state(ref[quantized]["final"], quantized)
    assert sorted(got["state"]) == sorted(want)
    # parameters, and with quantized the observers' min / max / count
    _assert_state(got["state"], want, "against qtpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_dp_step_equals_single_process_step(dp, quantized):
    out, _ = dp
    got = out[0]["runs"][quantized]
    np.testing.assert_allclose(got["losses"], got["single_losses"],
                               rtol=1e-4)
    _assert_state(got["state"], got["single_state"], "against one process")


def test_dp_state_stays_replicated(dp):
    out, _ = dp
    for q in (False, True):
        first = out[0]["runs"][q]
        for o in out[1:]:
            for part in ("state", "moments"):
                for k, v in first[part].items():
                    assert torch.equal(o["runs"][q][part][k], v), (q, k)


def test_dp_batch_divisibility_error(dp):
    out, _ = dp
    for o in out:
        assert o["divide_error"][0] == "ValueError"
        assert "divide" in o["divide_error"][1]


def test_run_experiment_dp_reachable(dp):
    out, _ = dp
    for o in out:
        assert "top1_delta" in o["experiment"]
    assert out[0]["experiment"] == out[-1]["experiment"]


# -- the ranks (no JAX) -------------------------------------------------------

def _rank_dp(d):
    import torch.distributed as dist

    from qtpu_torch.data import Dataset
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.examples.run import run_experiment
    from qtpu_torch.models import get_model, load_flax_variables
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.parallel import initialize_from_env, make_mesh
    from qtpu_torch.parallel.distributed import shutdown
    from qtpu_torch.train import create_train_state, fit, train_step
    from qtpu_torch.transform import convert_model

    initialize_from_env(backend="gloo")
    rank = dist.get_rank()
    mesh = make_mesh(dp=DP, tp=1)
    b = np.load(os.path.join(d, "batches.npz"))
    init = torch.load(os.path.join(d, "init.pt"), weights_only=False)

    def model_for(q):
        m = get_model("lenet5")
        if q:
            m = convert_model(m, QuantPolicy.int8_qat())
        v = init[q]
        return load_flax_variables(m, v["params"], v.get("batch_stats", {}),
                                   v.get("quant_stats"),
                                   v.get("quant_params"))

    def run(q, mesh):
        st = create_train_state(model_for(q), 1e-3)
        losses = [float(train_step(st, x, y, mesh=mesh)["loss"])
                  for x, y in zip(b["x"], b["y"])]
        state = {k: v.detach().clone()
                 for k, v in st.model.state_dict().items()}
        moments = {f"{i}.{k}": v.clone()
                   for i, s in enumerate(st.optimizer.state.values())
                   for k, v in s.items()}
        return losses, state, moments

    out = {"runs": {}}
    for q in (False, True):
        losses, state, moments = run(q, mesh)
        r = dict(losses=losses, state=state, moments=moments)
        if rank == 0:
            r["single_losses"], r["single_state"], _ = run(q, None)
        out["runs"][q] = r
    ds = Dataset(images=np.zeros((8, 28, 28, 1), np.float32),
                 labels=np.zeros((8,), np.int32), num_classes=10,
                 synthetic=True)
    try:
        fit(get_model("lenet5"), ds, epochs=1, batch_size=6, mesh=mesh)
    except ValueError as e:
        out["divide_error"] = ("ValueError", str(e))
    cfg = dataclasses.replace(
        CONFIGS["lenet_mnist_int8"], fp32_epochs=1, batch_size=8,
        n_train=32, n_eval=16, calib_batches=1)
    out["experiment"] = run_experiment(cfg, verbose=False, device="cpu",
                                       dp=DP)
    torch.save(out, os.path.join(d, f"dp_rank{rank}.pt"))
    shutdown()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
