"""Run the two-rank world of ``test_torch_scaling.py::test_tp_forward_records``
many times and count the worlds in which a rank failed.

    python tests/torch_world_loop.py N WORKDIR [--root CHECKOUT]

A rank that fails only now and then (the abort at interpreter exit that
``parallel.distributed.shutdown`` repairs) shows in a loop of hundreds of
worlds, best beside other load (e.g. ``pytest -n 6`` on the parallel test
files).  ``--root`` runs another checkout's test file and package, so that
one loop can count a parent commit's failures beside this one's.  Prints
each failed world's exit codes and output, then ``F of N worlds failed``;
exits 1 if any did.  No JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("workdir")
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from qtpu_torch.models import get_model, init_weights
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.parallel.launch import run_world
    from qtpu_torch.transform import calibrate, freeze
    from qtpu_torch.utils import checkpoint as ckpt

    d = Path(args.workdir)
    d.mkdir(parents=True, exist_ok=True)
    # the test's tree and batch
    model = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=(1, 1, 1, 1))
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    policy = QuantPolicy.int8_ptq()
    ckpt.save(str(d / "tree"),
              freeze(model, policy, calibrate(model, policy, [x])))
    torch.save(x, d / "x.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    test = os.path.join(root, "tests", "test_torch_scaling.py")
    failed = 0
    for i in range(args.n):
        res = run_world([sys.executable, test, "tp", str(d)], 2,
                        str(d / f"rdzv{i}"), timeout_s=120, backend="gloo",
                        env=env)
        if any(r.returncode for r in res):
            failed += 1
            print(f"world {i}: exit codes {[r.returncode for r in res]}; "
                  + "; ".join(f"rank {r.rank}: {r.output[-300:]!r}"
                              for r in res), flush=True)
    print(f"{failed} of {args.n} worlds failed", flush=True)
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
