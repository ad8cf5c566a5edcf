"""One run of one cell: set-up, the window, the traced readings, the
comparison, the metrics.

Set-up (counted in ``setup_s``, phase by phase): the system's imports,
the CUDA context, the configuration's kernels built into the package's
fixed build directory, the weights and inputs made on the device from the
seed, the system's calibration and freeze on the benchmark's batches, the
engine with its CUDA graphs captured for the cell's shapes only.  Then the
window, driven by the traffic file's client; with ``trace`` a slice of it
under the profiler and, offline, a few eager forwards of the timed batch
traced with their scopes.  Then the peak memory is read, the system's
state freed, and the reference run on the sampled inputs.
"""
from __future__ import annotations

import gc
from concurrent import futures
import importlib.util
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import check, clients, system, traffic, weights
from benchmark.harness import trace as tr
from benchmark.harness.spec import BENCH, Cell
from benchmark.harness.stats import percentile
from benchmark.harness.workcount import ScopeWork, model_ops_per_image
from benchmark.reference import pipeline as ref


def subseed(seed: int, stream: int) -> int:
    """An independent 63-bit seed of stream ``stream`` of ``seed``."""
    st = np.random.SeedSequence([int(seed), int(stream)])
    return int(st.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def reader(metric: str):
    """``benchmark/metrics/<metric>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the metric readers read."""
    client: str
    window: clients.Window
    setup_s: float
    ops_per_image: float
    work: Optional[ScopeWork] = None
    slice: Optional[tr.SliceReading] = None
    scopes: Optional[tuple] = None


class Phases:
    def __init__(self, device):
        self.device = device
        self.t = time.monotonic()
        self.seconds: Dict[str, float] = {}

    def done(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        self.seconds[name] = now - self.t
        self.t = now


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """The run's result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` (traced), ``checks``, and for
    the lines before the last ``setup`` (by phase) and ``generator``.
    ``control``: the checks also read the control (the reference one
    precision lower in the program's place), under ``control``."""
    cfg, tf = cell.config, cell.traffic
    on_card = device.type == "cuda"
    ph = Phases(device)
    ph.seconds["start"] = ph.t - t_start     # the interpreter, torch, CLI
    import qtpu_torch.serve.dispatch  # noqa: F401  (the system's imports)
    ph.done("import")
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    ph.done("cuda")
    if on_card and cfg.get("kernels"):
        system.build_kernels(cfg["kernels"])
    ph.done("build")

    arch = ref.arch_module(cfg["architecture"])
    g = weights.generator(subseed(seed, 0), device)
    params = weights.make_params(arch.param_specs(cfg), g, device)
    ph.done("weights")
    hw = (cfg["image_size"], cfg["image_size"], cfg["in_channels"])
    cal = cfg["calibration"]
    g = weights.generator(subseed(seed, 1), device)
    coeffs = ref.normalize_coeffs(cfg["ingest"]["mean"],
                                  cfg["ingest"]["std"], device)
    calib = [ref.normalize(weights.pixels(cal["batch_size"], hw, g, device),
                           coeffs) for _ in range(cal["batches"])]
    g = weights.generator(subseed(seed, 2), device)
    client = tf["client"]
    if client == "offline":
        pool_dev = [weights.pixels(tf["batch"], hw, g, device)
                    for _ in range(tf["pool_batches"])]
        pool = [x.to("cpu").pin_memory() if on_card else x
                for x in pool_dev]
        del pool_dev
    else:
        images = weights.pixels(tf["image_pool"], hw, g, device).cpu()
        images = np.ascontiguousarray(images.numpy())
    ph.done("inputs")

    m = system.model(cfg, weights.state_dict(params))
    ph.done("model")
    tree = system.quantize(cfg, m, calib, ph)
    del m

    rows = cfg["correctness"]["sample_rows"]
    if client == "offline":
        engine = system.offline_engine(cfg, tree, device)
        engine.forward_u8(pool[0])
        ph.done("engine")
        B = tf["batch"]
        keep = traffic.sample(tf["pool_batches"], max(1, rows // B),
                              subseed(seed, 3)).tolist()
        setup_s = time.monotonic() - t_start
        win = clients.offline(engine, pool, cfg["num_classes"], seconds,
                              tf["ahead"], keep,
                              tf["trace_slice_batches"] if trace else 0)
        sampled = sorted(win.outputs)
        prog = [win.outputs[k] for k in sampled]
        x_ref = [pool[k] for k in sampled]
        missing = (len(keep) - len(sampled)) * B
    else:
        engine = system.serving_engine(cfg, tree, tf, device)
        # the round's host path once, before the window (a warm-up
        # request that fails fails again in the window, where it counts)
        futures.wait([engine.submit(images[i % len(images)])
                      for i in range(max(tf["buckets"]))])
        ph.done("engine")
        due = traffic.arrivals(tf["rate_per_s"], seconds, subseed(seed, 4))
        which = traffic.image_indices(len(due), len(images),
                                      subseed(seed, 5))
        keep = traffic.sample(len(due), rows, subseed(seed, 6)).tolist()
        setup_s = time.monotonic() - t_start
        win = clients.open_loop(engine, images, due, which, keep,
                                tf["drain_s"],
                                tf["trace_slice_s"] if trace else 0.0,
                                device_type=device.type)
        sampled = sorted(win.outputs)
        prog = [win.outputs[k][None] for k in sampled]
        x_ref = [torch.from_numpy(images[which[k]][None]) for k in sampled]
        missing = len(keep) - len(sampled)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    scopes = None
    if trace and client == "offline":
        x = pool[0].to(device)
        engine.eager_forward_u8(x)

        def forwards():
            for _ in range(3):
                with tr.mark(tr.FORWARD):
                    engine.eager_forward_u8(x)
        scopes = tr.scope_times(tr.record(forwards, device.type))
        del x
    slice_reading = (tr.slice_reading(win.slice_events)
                     if win.slice_events is not None and on_card else None)

    # the system's state goes before the reference runs
    if client == "offline":
        engine.free_graphs()
    else:
        engine.stop()
    del engine, tree
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reference = check.Reference(cfg, params, calib, device)
    got = np.concatenate(prog) if prog else np.zeros((0, cfg["num_classes"]))
    xs = torch.cat(x_ref) if x_ref else None
    want = (reference.logits(xs, rows=cfg["correctness"]["reference_rows"])
            if xs is not None else got)
    correct, checks = check.checks(got, want, missing, win.failed,
                                   cfg["correctness"]["limits"])
    control = (check.rel_l2_max(reference.logits(
        xs, w_bits=cfg["correctness"]["control_w_bits"],
        rows=cfg["correctness"]["reference_rows"]), want)
        if control and xs is not None else None)

    run = Run(client=client, window=win, setup_s=setup_s,
              ops_per_image=model_ops_per_image(cfg),
              work=ScopeWork(cfg, tf["batch"]) if client == "offline"
              else None,
              slice=slice_reading, scopes=scopes)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m.name)(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": metrics, "device": dev}
    if trace and slice_reading is not None:
        dev["busy_s"] = slice_reading.busy_s
        dev["window_s"] = slice_reading.window_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in slice_reading.device_ops],
            "idle_gaps": [[n, s] for n, s in slice_reading.idle_gaps]}
    out["checks"] = checks
    extra = {"setup": dict(ph.seconds, total=setup_s),
             "missing_metrics": [m.name for m in wanted
                                 if m.name not in metrics]}
    if client == "open_loop":
        late = np.asarray(win.late_s) * 1e3
        extra["generator"] = {
            "requests": len(late),
            "late_p50_ms": float(np.percentile(late, 50)),
            "late_p99_ms": float(np.percentile(late, 99)),
            "late_max_ms": float(late.max())}
        lat = [x * 1e3 for x in win.latencies_s]
        fifth = max(1, len(lat) // 5)
        extra["load"] = {
            "offered_per_s": len(late) / win.seconds,
            "completed_per_s": win.completed / win.seconds,
            "p50_first_fifth_ms": percentile(lat[:fifth], 50),
            "p50_last_fifth_ms": percentile(lat[-fifth:], 50),
            "p95_by_quarter_ms": [percentile(q.tolist(), 95) for q in
                                  np.array_split(np.asarray(lat), 4)]}
    if control is not None:
        extra["control"] = control
    return {"result": out, "extra": extra}

