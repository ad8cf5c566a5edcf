"""Pipeline parallelism (GPipe over a ``'pipe'`` axis) on a world of four
CPU ranks (gloo) against qtpu's sequential oracle (mirrors
tests/test_pipeline.py case for case; tests/test_torch_pipeline.py is the
data pipeline's).

The parent computes qtpu's stages applied in sequence and hands the
stacked stage weights and the microbatches to four worker ranks that
import no JAX (``python tests/test_torch_pipeline_parallel.py pipe
<dir>``); each rank keeps its own stage (``stage_local``) and runs
``pipeline_apply``.  Every rank must return the whole output: fp32 to
qtpu's rtol 1e-5 / atol 1e-6, int8 stages bit-exact (qtpu's int8 case has
eight stages; four ranks run four).  The one-stage and mismatched-count
cases need no world and run in the parent.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STAGES = 4


def _mlp_stage(p, x):
    w, b = p
    return x + torch.relu(x @ w + b)


def _int8_stage(w, xq):
    from qtpu_torch.ops import qops

    acc = qops.qmatmul(xq, w)
    return torch.clamp(torch.div(acc, 64, rounding_mode="floor"), -128,
                       127).to(torch.int8)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from qtpu.ops import qops
    from qtpu_torch.parallel.launch import run_world

    d = tmp_path_factory.mktemp("pipeline")
    key = jax.random.PRNGKey(0)
    n_micro, mb, dim = 6, 2, 16
    ws = jax.random.normal(key, (N_STAGES, dim, dim)) * 0.1
    bs = jax.random.normal(jax.random.fold_in(key, 1), (N_STAGES, dim)) * 0.1
    x = jax.random.normal(jax.random.fold_in(key, 2), (n_micro, mb, dim))
    ref = x
    for i in range(N_STAGES):
        ref = ref + jax.nn.relu(ref @ ws[i] + bs[i])
    wq = jax.random.randint(key, (N_STAGES, 8, 8), -128, 128,
                            dtype=jnp.int8)
    xq = jax.random.randint(jax.random.fold_in(key, 1), (5, 3, 8), -128,
                            128, dtype=jnp.int8)
    refq = xq
    for i in range(N_STAGES):
        refq = jnp.clip(qops.qmatmul(refq, wq[i]) // 64, -128,
                        127).astype(jnp.int8)
    np.savez(d / "inputs.npz", ws=np.asarray(ws), bs=np.asarray(bs),
             x=np.asarray(x), wq=np.asarray(wq), xq=np.asarray(xq))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = run_world([sys.executable, os.path.abspath(__file__), "pipe",
                     str(d)], N_STAGES, str(d / "rdzv"), timeout_s=60,
                    backend="gloo", env=env)
    for r in res:
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
    out = [torch.load(d / f"pipe_rank{r}.pt", weights_only=False)
           for r in range(N_STAGES)]
    return out, np.asarray(ref), np.asarray(refq)


def test_pipeline_fp32_residual_mlp(pipe):
    out, ref, _ = pipe
    for o in out:
        np.testing.assert_allclose(o["mlp"], ref, rtol=1e-5, atol=1e-6)


def test_pipeline_int8_stage_exact(pipe):
    out, _, refq = pipe
    for o in out:
        assert o["int8"].dtype == np.int8
        np.testing.assert_array_equal(o["int8"], refq)


def test_pipeline_single_stage_degenerate():
    from qtpu_torch.parallel import (make_pipeline_mesh, pipeline_apply,
                                     stage_local)

    g = torch.Generator().manual_seed(0)
    w = torch.randn((1, 4, 4), generator=g)
    x = torch.randn((3, 2, 4), generator=g)
    mesh = make_pipeline_mesh(1)
    out = pipeline_apply(lambda p, xx: xx @ p, stage_local(w, mesh), x, mesh)
    np.testing.assert_allclose(out.numpy(), (x @ w[0]).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_pipeline_rejects_mismatched_stage_count(pipe):
    from qtpu_torch.parallel import make_pipeline_mesh

    with pytest.raises(ValueError):
        make_pipeline_mesh(3)            # one rank here
    for o in pipe[0]:
        assert o["mismatch"] == "ValueError"    # 3 stages on 4 ranks


# -- the ranks (no JAX) -------------------------------------------------------

def _rank_pipe(d):
    import torch.distributed as dist

    from qtpu_torch.parallel import (initialize_from_env, make_pipeline_mesh,
                                     pipeline_apply, stage_local)
    from qtpu_torch.parallel.distributed import shutdown

    initialize_from_env(backend="gloo")
    a = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(d, "inputs.npz")).items()}
    mesh = make_pipeline_mesh(N_STAGES)
    out = {"mlp": pipeline_apply(_mlp_stage,
                                 stage_local((a["ws"], a["bs"]), mesh),
                                 a["x"], mesh).numpy(),
           "int8": pipeline_apply(_int8_stage, stage_local(a["wq"], mesh),
                                  a["xq"], mesh).numpy()}
    try:
        make_pipeline_mesh(3)
        out["mismatch"] = "none"
    except ValueError:
        out["mismatch"] = "ValueError"
    torch.save(out, os.path.join(d, f"pipe_rank{dist.get_rank()}.pt"))
    shutdown()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
