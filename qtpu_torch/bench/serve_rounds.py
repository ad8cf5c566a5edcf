"""The wall time of a served round, on the scheduler's clock.

    python qtpu_torch/bench/serve_rounds.py [--root CHECKOUT]

A round of ``ServingEngine`` runs from its dispatch (pack the requests into
the bucket, upload, run the forward — a graph replay, or the eager forward
— and copy the output out) to its resolve (the logits on the host, the
futures set).  :func:`round_ms` times each round between those two points,
with ``time.perf_counter`` around the engine's own ``_dispatch_round`` and
``_resolve_round``, while one burst of ``batch`` requests at a time is
served (the next burst is submitted once the last one's results are in, so
rounds never overlap; a burst reaches the scheduler at once).  It reads
no statistic the engine has to offer, so it times any ``ServingEngine`` of
the port since the server slice, the eager engines before the CUDA graphs
too.

As a script it builds ``resnet50_imagenet_int8_ptq_fp32stem``'s product
engine (seed-0 weights, the config's calibration) from the ``qtpu_torch``
of ``--root`` (default: the checkout holding this file), serves it through
``ServingEngine`` with buckets 8, 32 and 128, times ``ROUNDS`` rounds of
each bucket after one untimed, and prints one JSON line per engine: graphed
(where the checkout's engine captures graphs: its ``stats()`` has
``graphed``) and eager (``ServingEngine.serve_eagerly`` before ``warmup``;
a checkout without graphs has only this one), each bucket's rounds in ms,
and the card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

CONFIG = "resnet50_imagenet_int8_ptq_fp32stem"
BUCKETS = (8, 32, 128)
ROUNDS = 20


def submit_burst(engine, images) -> list:
    """Submit ``images`` to ``engine`` as one arrival: each goes through
    ``submit`` (its checks, its future), but the requests reach the
    scheduler's queue together, under the queue's lock, so the scheduler
    takes none of them before it can take all.  Submitted one by one, a
    burst of 128 on a loaded host can outlast ``max_wait_ms`` and be
    served as two rounds."""
    q = engine._queue
    staged: list = []
    q.put = staged.append                # submit enqueues here instead
    try:
        futs = [engine.submit(im) for im in images]
    finally:
        del q.put
    with q.mutex:
        for item in staged:
            q._put(item)
        q.unfinished_tasks += len(staged)
        q.not_empty.notify()
    return futs


def round_ms(engine, images: np.ndarray, batch: int, rounds: int
             ) -> List[float]:
    """Wall ms of each of ``rounds`` rounds of ``batch`` requests (rows of
    ``images``, cycled) served by ``engine``; the burst arrives at once
    (:func:`submit_burst`), and a round that did not take the whole burst
    raises."""
    marks: List[tuple] = []
    resolved = threading.Event()
    dispatch, resolve = engine._dispatch_round, engine._resolve_round

    def timed_dispatch(reqs):
        t0 = time.perf_counter()
        out = dispatch(reqs)
        marks.append(("dispatch", t0, len(out[0])))
        return out

    def timed_resolve(*args):
        resolve(*args)
        marks.append(("resolve", time.perf_counter(), len(args[0])))
        resolved.set()

    engine._dispatch_round, engine._resolve_round = (timed_dispatch,
                                                     timed_resolve)
    try:
        out = []
        for r in range(rounds):
            marks.clear()
            resolved.clear()
            idx = [(r * batch + i) % len(images) for i in range(batch)]
            futs = submit_burst(engine, [images[i] for i in idx])
            for f in futs:
                f.result(timeout=300)
            # the futures are set inside the resolve: wait for its mark too,
            # so that it is not appended after the next round's clear
            resolved.wait(timeout=300)
            if [m[2] for m in marks] != [batch, batch]:
                raise RuntimeError(
                    f"a burst of {batch} requests was not one round: "
                    f"{[(m[0], m[2]) for m in marks]}")
            out.append((marks[1][1] - marks[0][1]) * 1e3)
        return out
    finally:
        del engine._dispatch_round, engine._resolve_round


def summary(ms: List[float]) -> Dict[str, float]:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "rounds": len(ms)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose qtpu_torch serves")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    # run as a file, this directory leads sys.path, and its profile.py
    # would shadow the standard library's
    here = Path(__file__).resolve().parent
    sys.path[:] = [root] + [d for d in sys.path
                            if Path(d or ".").resolve() != here]
    import torch

    from qtpu_torch.bench.timing import device_label
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import freeze_from_config, make_flat_forward
    from qtpu_torch.serve.engine import ServingEngine

    if not torch.cuda.is_available():
        print("serve_rounds: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = CONFIGS[CONFIG]
    factory, preprocess, raw_dtype, _ = make_flat_forward(
        cfg.model, exclude=cfg.exclude, num_classes=cfg.num_classes,
        image_size=cfg.image_size, width=cfg.width,
        cifar_stem=cfg.cifar_stem, device=dev)
    tree = freeze_from_config(cfg, device=dev)
    shape = (cfg.image_size, cfg.image_size, 3)
    images = np.random.default_rng(5).standard_normal(
        (max(BUCKETS), *shape)).astype(np.float32)
    card = device_label(dev)
    for mode in ("graphed", "eager"):
        eng = ServingEngine(None, tree, batch_buckets=BUCKETS,
                            max_wait_ms=50.0, forward_factory=factory,
                            preprocess_fn=preprocess, raw_dtype=raw_dtype,
                            device=dev)
        has_graphs = "graphed" in eng.stats()
        if mode == "graphed" and not has_graphs:
            eng.stop()
            continue
        if mode == "eager" and has_graphs:
            eng.serve_eagerly()
        t0 = time.perf_counter()
        eng.warmup(shape)
        warm_s = time.perf_counter() - t0
        try:
            rows = {}
            for b in BUCKETS:
                round_ms(eng, images, b, 1)          # untimed
                rows[b] = summary(round_ms(eng, images, b, ROUNDS))
            st = eng.stats()
        finally:
            eng.stop()
        line = dict(root=root, mode=mode, config=CONFIG, device=card,
                    warmup_s=warm_s, rounds=rows,
                    graph_bytes=st.get("graph_bytes", {}))
        print(json.dumps(line), flush=True)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
