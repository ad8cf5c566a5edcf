"""Projected 1→N-card scaling efficiency — a MODEL, not a measurement
(port of qtpu/bench/scaling_projection.py).

qtpu compiled the sharded serving program ahead of time for TPU
topologies and read its collectives from the optimized HLO.  The port has
no compiler that partitions a program: its TP forward issues its
collectives itself (``parallel.collectives``), so the projection reads
them from a real TP forward run under ``collectives.recording()`` — each
collective's kind, group size and the bytes this rank hands in (taken
before any host staging, so the records are the same under gloo and
NCCL).  Then, as qtpu:

1. each collective becomes its per-card traffic and link time;
2. with the measured single-card step time ``t1``: step(N) = t1/tp +
   alpha · t_link(N); efficiency = (t1/tp) / step(N).

Model assumptions (stated so the number is interpretable):

* compute splits ideally (t1/tp) — optimistic for TP at narrow per-card
  channel counts, so the projection brackets the truth from above;
* traffic per card follows qtpu's ring rules: all-gather and all-to-all
  move S·(n−1)/n bytes of the full tensor S, reduce-scatter the full
  tensor's S·(n−1)/n, all-reduce twice that, point to point S; a
  broadcast is counted as point to point (each receiving card takes S
  once);
* the link is NVLink 4 through NVSwitch: 450 GB/s each way per H100 SXM
  (18 links, NVIDIA's data sheet), a card's traffic leaving at that rate
  whatever the group — the switch joins every pair, so there is no torus
  ring to split across two directions;
* ``alpha`` = 1: the port's collectives are synchronous host calls between
  kernel launches, so none is hidden behind compute (qtpu read the
  overlap from its schedule's async pairs; the port has none);
* the forward only: the lockstep server's per-round barrier (a few bytes a
  round) is omitted as negligible, not silently uncounted.

``python -m qtpu_torch.bench.scaling_projection --records R.json
[--t1-ms T]`` projects the records a TP forward wrote (a JSON object with
``records``, ``tp``, ``batch`` and ``config``, as ``chip_smoke.py``'s phase
8 ranks write them); without ``--t1-ms`` it measures t1 itself, the graph-timed
TP = 1 forward of the records' ``config`` at their batch on the card, and
raises without a card.  No fallback time exists.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

NVLINK_BPS = 450e9      # H100 SXM NVLink 4, each way, per card


def traffic(kind: str, nbytes: int, n: int) -> float:
    """Bytes one card moves for a collective over ``n`` cards whose operand
    on this card is ``nbytes`` (qtpu's ring rules; module docstring)."""
    if kind == "all_gather":
        full = nbytes * n                  # the gathered tensor
        return full * (n - 1) / n
    if kind in ("all_to_all", "reduce_scatter"):
        return nbytes * (n - 1) / n       # the full operand
    if kind == "all_reduce":
        return 2 * nbytes * (n - 1) / n
    if kind in ("ppermute", "broadcast"):
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_link(records: Sequence[Dict[str, Any]], n_devices: int,
                    link_bps: float = NVLINK_BPS) -> Dict[str, Any]:
    """Per-step traffic and link time of a forward's collectives (qtpu's
    ``collective_ici`` over recorded collectives).  A record's group is
    its own size, else ``n_devices``; groups of one and empty tensors move
    nothing.  Rows per collective, the summed per-card bytes and µs."""
    rows: List[Dict[str, Any]] = []
    t_total = 0.0
    bytes_total = 0
    for r in records:
        n = int(r.get("group") or n_devices)
        size = int(r["bytes"])
        if n <= 1 or size == 0:
            continue
        moved = traffic(r["kind"], size, n)
        t = moved / link_bps
        rows.append(dict(kind=r["kind"], bytes=size, group=n,
                         ici_bytes=int(moved), t_us=round(t * 1e6, 2)))
        t_total += t
        bytes_total += int(moved)
    return dict(rows=rows, n_collectives=len(rows),
                ici_bytes_per_device=bytes_total,
                t_ici_us=round(t_total * 1e6, 2))


def overlap_alpha(records: Sequence[Dict[str, Any]]) -> float:
    """The exposed share of the collectives' time: 1 — the port's
    collectives are synchronous host calls, so none overlaps compute."""
    return 1.0


def project(t1_s: float, records: Sequence[Dict[str, Any]], n_devices: int,
            tp: int = 1, link_bps: float = NVLINK_BPS) -> Dict[str, Any]:
    """Projected step time and efficiency at ``n_devices`` from one
    forward's records — qtpu's formula and keys (``t_ici_ms`` and
    ``ici_bytes_per_device`` are the NVLink time and bytes here).  The data
    axis is weak-scaled (per-card batch held, compute t1); the model axis
    strong-scales compute: t_compute = t1 / tp."""
    link = collective_link(records, n_devices, link_bps)
    alpha = overlap_alpha(records)
    t_comp = t1_s / tp
    t_coll = link["t_ici_us"] / 1e6
    out = dict(n_devices=n_devices, tp=tp,
               t1_ms=round(t1_s * 1e3, 3),
               t_compute_ms=round(t_comp * 1e3, 3),
               t_ici_ms=round(t_coll * 1e3, 3),
               ici_bytes_per_device=link["ici_bytes_per_device"],
               n_collectives=link["n_collectives"],
               alpha_exposed=round(alpha, 3))
    for name, a in (("eff_worstcase_pct", 1.0), ("eff_scheduled_pct", alpha)):
        step = t_comp + a * t_coll
        out[name] = round(100.0 * t_comp / step, 1)
    return out


def measure_t1_ms(batch: int, config: str, iters: int = 5) -> float:
    """The graph-timed TP = 1 forward (ms) of ``config``'s engine at
    ``batch`` on the card; raises without one."""
    import torch

    from qtpu_torch.bench.timing import timed
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_forward

    if not torch.cuda.is_available():
        raise RuntimeError("no --t1-ms and no card to measure t1 on: the "
                           "projection has no fallback time")
    cfg = CONFIGS[config]
    fwd = build_forward(cfg, device="cuda")
    x = torch.randn((batch, cfg.image_size, cfg.image_size, 3),
                    generator=torch.Generator().manual_seed(0)).cuda()
    with torch.inference_mode():
        return timed(lambda: fwd(x), iters)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="project 1→N scaling from a TP forward's collectives")
    ap.add_argument("--records", required=True,
                    help="JSON: {records, tp, batch, config} of one TP "
                         "forward")
    ap.add_argument("--t1-ms", type=float, default=None,
                    help="the TP = 1 step time; measured on the card if "
                         "absent")
    args = ap.parse_args(argv)
    with open(args.records) as f:
        rec = json.load(f)
    tp, batch = int(rec["tp"]), int(rec["batch"])
    if args.t1_ms is not None:
        t1_ms, src = args.t1_ms, "--t1-ms"
    else:
        from qtpu_torch.bench.timing import device_label

        t1_ms = measure_t1_ms(batch, rec["config"])
        src = f"graph-timed TP = 1 forward, {device_label('cuda')}"
    print(json.dumps(dict(t1_ms=round(t1_ms, 3), batch=batch,
                          t1_source=src)), flush=True)
    row = project(t1_ms / 1e3, rec["records"], tp, tp=tp)
    row.update(dp=1, batch_per_chip=batch, batch_total=batch,
               config=rec["config"], model="MODEL")
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
