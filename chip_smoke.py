#!/usr/bin/env python3
"""Smoke run of qtpu_torch on one NVIDIA GPU — the quickest proof that the
port builds and serves on the card.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases (any failure exits non-zero; the last line is printed only on
success):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``qtpu_torch/csrc`` (one ``nvcc`` per source,
   all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the ResNet-50 main path gives it at batch 8 — outputs must be identical
   (same formula, same order, same card);
4. the slice: ``build_engine`` for ``resnet50_imagenet_int8_ptq_fp32stem`` at
   full width (224×224, 1000 classes, seeded random weights, calibrate,
   freeze) serves requests spanning two batch buckets through
   ``ServingEngine``; the launch counters, zeroed just before, show every
   int8 layer on the kernels (37 K1 and 16 K2 launches per forward) and
   none on the plain path; the served logits are finite and match the
   flat engine's forward;
5. the same frozen tree through the engine on the CPU (the plain path) on
   two images: codes after every block follow the tie rule (equal except one
   step on ≤ 0.1% of elements), logits agree to rel-L2 ≤ 1e-4;
6. timings with CUDA events after warm-up: engine images/s at B = 32 and
   128 as served (launched from Python), with the device time of the same
   forward captured as one CUDA graph beside it; each kernel's device time
   (repeated launches captured in a CUDA graph) beside its bound, its plain
   version and, for K1, ``torch._int_mm`` (int32 accumulator only) as the
   library yardstick; a profiler breakdown of one B = 128 forward.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bandwidth
SRC_K1 = "qtpu_torch/csrc/qmatmul.cu"
SRC_K2 = "qtpu_torch/csrc/qconv.cu"
TPU_K1 = "qtpu/ops/pallas/qmatmul.py:108"
TPU_K2 = "qtpu/ops/pallas/qconv.py:70"
TPU_K2S = "qtpu/ops/pallas/qconv_dispatch.py:42"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.ops import _build, qops
    from qtpu_torch.ops import qconv as k2
    from qtpu_torch.ops import qmatmul as k1
    from qtpu_torch.serve.cli import build_engine
    from qtpu_torch.serve.dispatch import resnet_arch
    from qtpu_torch.serve.fused_ops import grid_of
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    dev = torch.device("cuda")

    # -- 1. the card ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    # -- 2. build ------------------------------------------------------------------
    t0 = time.monotonic()
    info = _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s (" + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in info.items()) + ")")
    for k, v in info.items():
        for line in v["log"].splitlines():
            if "registers" in line:
                log(f"  {k}: {line.strip()}")

    def events_ms(run, iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def timed(fn, iters):
        """Device ms per call: ``iters`` calls captured in one CUDA graph,
        the replay timed with CUDA events.  Launched one by one from
        Python, a call of a few tens of microseconds is bound by the host's
        launch rate, which would be timed instead of the kernel."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return events_ms(graph.replay, iters)

    def timed_eager(fn, iters):
        """ms per call issued from Python (host overhead included)."""
        fn()
        torch.cuda.synchronize()

        def run():
            for _ in range(iters):
                fn()
        return events_ms(run, iters)

    # -- 3. kernels against their plain versions, main-path shapes at B=8 ----------
    g = torch.Generator(device="cpu").manual_seed(0)

    def i8(*shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int8).to(dev)

    def coeffs(n, ncols_k, **kw):
        w_scale = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(dev)
        colsum = torch.randint(-127 * ncols_k // 8, 127 * ncols_k // 8, (n,),
                               generator=g, dtype=torch.int32).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        return qops.epilogue_coeffs(act_scale=0.02, act_zp=-9,
                                    w_scale=w_scale, colsum=colsum,
                                    bias=bias, **kw)

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
        return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

    requant = dict(requant_scale=0.05, requant_zp=-20, relu=True)
    k1_cases = [
        ("layer1 conv3 +int8 residual", 25088, 64, 256,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("layer1 conv1 requant", 25088, 256, 64, requant, None),
        ("layer2_0 downsample f32", 6272, 256, 512, {}, None),
        ("fc raw_acc", 8, 2048, 1000, None, None),
    ]
    kernels = []
    for label, M, K, N, kw, res in k1_cases:
        x, w = i8(M, K), i8(N, K, lo=-127)
        raw = kw is None
        co, mode = (None, None) if raw else coeffs(N, K, **kw)
        r = i8(M, N) if res == "i8" else None

        def run_k(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
            return k1.qmatmul_folded(x, w, co, mode, r, raw_acc=raw)

        def run_p(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
            return k1.qmatmul_folded_plain(x, w, co, mode, r, raw_acc=raw)

        y, y_ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs().max().item()
        check(y.dtype == y_ref.dtype and err == 0,
              f"K1 {label}: kernel differs from plain (max abs {err})")
        out_b = y.element_size() * M * N
        nbytes = M * K + N * K + out_b + (0 if raw else 8 * N) + \
            (M * N if r is not None else 0)
        b_ms, b_by = bound(nbytes, 2 * M * N * K)
        lib_ms = None
        if M > 16:        # torch._int_mm needs more than 16 rows
            wt = w.t()
            lib_ms = timed(lambda: torch._int_mm(x, wt), 50)
        kernels.append(dict(
            name=f"qmatmul_fused [{label}]", route="cuda", source=SRC_K1,
            replaces=TPU_K1, shape=f"M={M} K={K} N={N}",
            max_abs_err=err, ms=timed(run_k, 50),
            eager_ms=timed_eager(run_k, 50), plain_ms=timed(run_p, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"K1 {label}: exact vs plain")

    k2_cases = [
        ("layer1 conv2 3x3/1", 8, 56, 64, 64, 1, TPU_K2),
        ("layer2_0 conv2 3x3/2", 8, 56, 128, 128, 2, TPU_K2S),
    ]
    for label, B, H, Ci, Co, s, tpu in k2_cases:
        x = i8(B, H, H, Ci)
        pads = qops.same_pads((H, H), (3, 3), (s, s))
        xp = qops.pad_nhwc(x, pads, -9).contiguous()
        w = i8(Co, 9 * Ci, lo=-127)
        co, mode = coeffs(Co, 9 * Ci, **requant)

        def run_k(xp=xp, w=w, co=co, mode=mode, s=s):
            return k2.qconv2d_folded(xp, w, co, mode, kernel_hw=(3, 3),
                                     stride=s)

        def run_p(xp=xp, w=w, co=co, mode=mode, s=s):
            return k2.qconv2d_folded_plain(xp, w, co, mode, kernel_hw=(3, 3),
                                           stride=s)

        y, y_ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs().max().item()
        check(y.dtype == y_ref.dtype and err == 0,
              f"K2 {label}: kernel differs from plain (max abs {err})")
        OH = y.shape[1]
        M = B * OH * OH
        nbytes = xp.numel() + w.numel() + 8 * Co + y.numel()
        b_ms, b_by = bound(nbytes, 2 * M * Co * 9 * Ci)
        kernels.append(dict(
            name=f"qconv2d_fused [{label}]", route="cuda", source=SRC_K2,
            replaces=tpu, shape=f"B={B} H={H} Ci={Ci} Co={Co} 3x3/{s}",
            max_abs_err=err, ms=timed(run_k, 50),
            eager_ms=timed_eager(run_k, 50), plain_ms=timed(run_p, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"K2 {label}: exact vs plain")

    # -- 4. the slice through ServingEngine -----------------------------------------
    cfg = CONFIGS["resnet50_imagenet_int8_ptq_fp32stem"]
    t0 = time.monotonic()
    # a 20 ms collection window: the burst of 40 lands in a bucket above 8
    engine, info = build_engine(cfg, buckets=(8, 32, 128), max_wait_ms=20.0,
                                device=dev)
    log(f"build_engine ({cfg.name}): {time.monotonic() - t0:.1f} s, "
        f"{info['serve_path']}, buckets {info['buckets']}")
    arch = resnet_arch(cfg.model, num_classes=cfg.num_classes,
                       image_size=cfg.image_size, width=cfg.width,
                       cifar_stem=cfg.cifar_stem)
    flat = ResNetInt8Engine(engine.vars, arch, device=dev)
    rng = np.random.default_rng(1)
    try:
        imgs = rng.standard_normal((45, 224, 224, 3)).astype(np.float32)

        def zero_counts():
            k1.qmatmul_folded.launches = k2.qconv2d_folded.launches = 0
            k1.qmatmul_folded_plain.calls = 0
            k2.qconv2d_folded_plain.calls = 0

        def counts():
            return (k1.qmatmul_folded.launches, k2.qconv2d_folded.launches,
                    k1.qmatmul_folded_plain.calls +
                    k2.qconv2d_folded_plain.calls)

        zero_counts()
        with torch.inference_mode():
            flat.forward(torch.from_numpy(imgs[:8]))
        torch.cuda.synchronize()
        per_fwd = counts()
        check(per_fwd == (37, 16, 0),
              f"one forward launched K1/K2/plain = {per_fwd}, "
              "expected (37, 16, 0)")
        log("per forward: K1 37, K2 16, plain path 0")

        rounds0 = engine.stats()["batches"]
        zero_counts()
        wave1 = [engine.submit(im) for im in imgs[:5]]
        got1 = [f.result(timeout=300) for f in wave1]
        wave2 = [engine.submit(im) for im in imgs[5:]]
        served = np.stack(got1 + [f.result(timeout=300) for f in wave2])
        torch.cuda.synchronize()
        run_counts = counts()
        st = engine.stats()
    finally:
        engine.stop()
    rounds = st["batches"] - rounds0
    check(run_counts == (37 * rounds, 16 * rounds, 0),
          f"serving {rounds} rounds launched K1/K2/plain = {run_counts}")
    check(len(st["rounds_per_bucket"]) >= 2,
          f"requests did not span two buckets: {st['rounds_per_bucket']}")
    check(served.shape == (45, cfg.num_classes) and
          np.isfinite(served).all(), "served logits not finite / mis-shaped")
    with torch.inference_mode():
        direct = flat.forward(torch.from_numpy(imgs)).cpu().numpy()
    rel = float(np.linalg.norm(served - direct) / np.linalg.norm(direct))
    check(rel <= 1e-4, f"served logits vs forward: rel-L2 {rel}")
    log(f"served 45 requests in {rounds} rounds {st['rounds_per_bucket']}: "
        f"K1 {run_counts[0]}, K2 {run_counts[1]} launches, plain 0; "
        f"rel-L2 vs forward {rel:.2e}")
    for kern in kernels:
        kern["launches"] = run_counts[0 if kern["source"] == SRC_K1 else 1]

    # -- 5. the same tree on the CPU plain path ---------------------------------------
    cpu = ResNetInt8Engine(engine.vars, arch, device="cpu")
    x2 = torch.from_numpy(imgs[:2])
    worst = 0.0
    with torch.inference_mode():
        names = flat._block_names()
        gg = grid_of(flat._node(names[0][0], "conv1"))
        cg = grid_of(cpu._node(names[0][0], "conv1"))
        g_codes = flat._stem(x2.to(dev), gg)
        c_codes = cpu._stem(x2, cg)

        def tie_rule(a, b, where):
            d = (a.cpu().int() - b.int()).abs()
            frac = (d > 0).float().mean().item()
            check(d.max().item() <= 1 and frac <= 1e-3,
                  f"{where}: card vs CPU codes max diff {d.max().item()}, "
                  f"{frac:.2e} of codes differ")
            return frac

        worst = max(worst, tie_rule(g_codes, c_codes, "stem"))
        for idx, (name, i, j) in enumerate(names):
            s = (2, 2) if (i > 0 and j == 0) else (1, 1)
            nxt = (names[idx + 1][0], "conv1") if idx + 1 < len(names) \
                else ("fc",)
            gn, cn = grid_of(flat._node(*nxt)), grid_of(cpu._node(*nxt))
            g_out = flat._bottleneck(g_codes, gg, name, s, gn)
            c_out = cpu._bottleneck(g_codes.cpu(), cg, name, s, cn)
            worst = max(worst, tie_rule(g_out, c_out, name))
            g_codes, gg, cg = g_out, gn, cn
        y_gpu = flat.forward(x2).cpu().numpy()
        y_cpu = cpu.forward(x2).numpy()
    rel_cpu = float(np.linalg.norm(y_gpu - y_cpu) / np.linalg.norm(y_cpu))
    check(rel_cpu <= 1e-4, f"card vs CPU logits rel-L2 {rel_cpu}")
    log(f"card vs CPU plain path: worst block {worst:.2e} of codes differ, "
        f"logits rel-L2 {rel_cpu:.2e}")

    # -- 6. engine throughput and a profile ------------------------------------------
    for B in (32, 128):
        x = torch.randn((B, 224, 224, 3), generator=g).to(dev)
        with torch.inference_mode():
            ms = timed_eager(lambda: flat.forward(x), 10)
            graph_ms = timed(lambda: flat.forward(x), 5)
        log(f"engine forward B={B}: {ms:.3f} ms, {B / ms * 1e3:.1f} img/s "
            f"(device time as one CUDA graph: {graph_ms:.3f} ms)")
    profile_forward(flat, x, torch)
    for kern in kernels:
        log(f"{kern['name']}: {kern['ms']:.4f} ms on the device, "
            f"{kern['eager_ms']:.4f} ms launched from Python (bound "
            f"{kern['bound_ms']:.4f} ms, {kern['bound_by']}; plain "
            f"{kern['plain_ms']:.3f} ms; library {kern['library_ms']})")
    log("K2 library: none — no PyTorch call computes an int8 conv with an "
        "int32 accumulator")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_forward(flat, x, torch):
    """Device time of one forward by kernel (torch.profiler), and the share
    of the forward's wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        flat.forward(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            flat.forward(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    fams = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        fam = ("K1 qmatmul_fused" if "GemmLoader" in e.key else
               "K2 qconv2d_fused" if "ConvLoader" in e.key else e.key[:70])
        n, us = fams.get(fam, (0, 0.0))
        fams[fam] = (n + e.count, us + e.self_device_time_total)
    total = sum(us for _, us in fams.values())
    if not total:
        log("profile: no device time reported (not measured)")
        return
    top = sorted(fams.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"profile B={x.shape[0]} forward: device busy {total / 1e3:.3f} ms of "
        f"{wall_ms:.3f} ms wall (profiled); by kernel: " + "; ".join(
            f"{k} x{n} {us / 1e3:.3f} ms ({100 * us / total:.1f}%)"
            for k, (n, us) in top))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
