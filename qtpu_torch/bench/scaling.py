"""DP scaling: forward images/s against the number of data-parallel ranks
(port of qtpu/bench/scaling.py).

qtpu timed one SPMD program over a mesh of dp devices.  The port's rank
model is one process and one device a rank (ROADMAP C21), so for each dp
:func:`dp_scaling` starts a world of dp ranks (``parallel.launch.
run_world``).  Each rank builds the forward from an importable factory
(``"module:function"``, called as ``factory(device, **factory_kwargs)``
and returning a callable from an f32 NHWC batch to logits), and times its
local batch of ``batch_per_device`` images with ``timing.time_scan_fit``
— a chain whose every forward reads the carry the last one produced.
Rank 0 gathers the ranks' times and reports the world's images/s as
dp · batch_per_device over the slowest rank's time, and the efficiency
against linear scaling from the smallest dp — qtpu's formula and keys.

DP inference exchanges nothing between ranks in the forward, so on cards
the number measures whether the ranks slow each other through the host.
On one card only dp = 1 measures anything: two ranks sharing a card would
time their contention for it, not scaling, so ``dp_scaling`` refuses a dp
above the card count.  On the CPU (``device="cpu"``, gloo) the ranks share
the host's cores, one thread each, and the times are the host's: a
structural check, not a device metric.

``factory_forward`` is the usual factory: the forward ``serve.cli.
build_forward`` builds for a config, over a saved frozen tree or one
frozen from the config — a flat engine's eager body:
``time_scan_fit`` captures each chain whole on the card.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
from typing import Any, Dict, Optional, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def factory_forward(device, *, config: str, load_frozen: Optional[str] = None):
    """The forward ``config`` serves on ``device`` (``serve.cli.
    build_forward``)."""
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_forward

    return build_forward(CONFIGS[config], load_frozen=load_frozen,
                         device=device)


def _load_factory(spec: str):
    module, _, name = spec.partition(":")
    if not module or not name:
        raise ValueError(f"factory {spec!r}: expected 'module:function'")
    return getattr(importlib.import_module(module), name)


def dp_scaling(factory: str, image_shape: Sequence[int], *,
               dps: Sequence[int], batch_per_device: int = 8,
               factory_kwargs: Optional[Dict[str, Any]] = None,
               device: str = "cuda", n_short: int = 5, n_long: int = 20,
               timeout_s: float = 600.0, workdir: Optional[str] = None
               ) -> Dict[str, Any]:
    """Forward images/s at each dp in ``dps``, the global batch growing
    with dp (module docstring).  ``device``: ``"cuda"`` (a card per rank,
    NCCL) or ``"cpu"`` (gloo).  Raises if a rank fails or a dp needs more
    cards than there are."""
    import torch

    from qtpu_torch.parallel.launch import run_world

    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        short = [dp for dp in dps if dp > cards]
        if short:
            raise ValueError(
                f"dp {short} needs a card per rank and {cards} are present: "
                "ranks sharing a card would time their contention, not "
                "scaling")
    elif device != "cpu":
        raise ValueError(f"device {device!r}: cuda or cpu")
    _load_factory(factory)                       # fail here, not in a rank
    workdir = workdir or tempfile.mkdtemp(prefix="qtpu_dp_scaling_")
    # CPU ranks take one thread each, as the host's cores are shared
    env = dict(os.environ, **({"OMP_NUM_THREADS": "1"} if device == "cpu"
                              else {}))
    results = {}
    for dp in dps:
        spec = dict(factory=factory, kwargs=factory_kwargs or {},
                    image_shape=list(image_shape), batch=batch_per_device,
                    device=device, n_short=n_short, n_long=n_long,
                    out=os.path.join(workdir, f"dp{dp}.json"))
        res = run_world([sys.executable, "-m", "qtpu_torch.bench.scaling",
                         "--rank", json.dumps(spec)], dp,
                        os.path.join(workdir, f"dp{dp}.rdzv"),
                        timeout_s=timeout_s, cwd=_REPO, env=env,
                        backend="gloo" if device == "cpu" else None)
        for r in res:
            if r.returncode != 0:
                raise RuntimeError(f"dp {dp} rank {r.rank} exited "
                                   f"{r.returncode}:\n{r.output[-4000:]}")
        with open(spec["out"]) as f:
            results[dp] = json.load(f)["images_per_sec"]
    base = results[min(results)] / min(results)
    eff = {dp: results[dp] / (dp * base) for dp in results}
    return {"images_per_sec": results, "efficiency_vs_linear": eff}


def _rank_main(spec: Dict[str, Any]) -> int:
    """One rank of a :func:`dp_scaling` world: time the local batch, then
    rank 0 writes the world's images/s."""
    import torch
    import torch.distributed as dist

    from qtpu_torch.bench.timing import time_scan_fit
    from qtpu_torch.parallel import distributed

    distributed.initialize_from_env()
    dev = distributed.rank_device(spec["device"])
    forward = _load_factory(spec["factory"])(dev, **spec["kwargs"])
    x = torch.zeros((spec["batch"], *spec["image_shape"]), device=dev)

    def body(c):
        return c + 0.0 * forward(c).sum()

    with torch.inference_mode():
        dt = time_scan_fit(body, x, n_short=spec["n_short"],
                           n_long=spec["n_long"])
    times = [dt]
    if dist.is_initialized():
        times = [None] * dist.get_world_size()
        dist.all_gather_object(times, dt,
                               group=dist.new_group(backend="gloo"))
    if distributed.rank() == 0:
        with open(spec["out"], "w") as f:
            json.dump(dict(seconds=times, images_per_sec=(
                len(times) * spec["batch"] / max(times))), f)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["--rank"] or len(sys.argv) != 3:
        raise SystemExit("usage: python -m qtpu_torch.bench.scaling --rank "
                         "SPEC_JSON (a rank of dp_scaling's world)")
    raise SystemExit(_rank_main(json.loads(sys.argv[2])))
