"""Serve CLI: ``python -m qtpu_torch.serve --config <name>`` — the
launchable server (port of qtpu/serve/cli.py, single host).

``build_engine`` assembles the serving stack for an experiment config:

1. weights — ``load_frozen`` (a tree saved by an earlier ``save_frozen``:
   no calibration), or build: the config's fp32 model (seeded random
   weights; ``torch_ckpt``, a torchvision-named ``.pth``, through
   ``data.import_torch``; or ``load_state``, an fp32 ``state_dict`` saved
   by ``examples.run --save-state``), calibrated on qtpu's data (the
   config's observer — min-max, KL for the CIFAR ResNets, EMA for
   ``resnet50_int4w_int8a_qat`` — on the first ``calib_batches`` batches
   of ``load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=0)``,
   real images under ``$QTPU_DATA_DIR`` or the synthetic set) and frozen
   (int8, or nibble-packed int4 weights); at most one weight source;
2. the engine ``serve.dispatch`` picks: a flat int8 engine (ResNet,
   MobileNet-v1/v2; ``stem``/``fc`` excludes in fp32 inside it,
   ``stem_dtype=torch.bfloat16`` for its stem conv), or for LeNet-5 and
   excludes beyond stem/fc the SERVE-mode model (:func:`serve_module`);
   ``uint8_ingest`` puts uint8 pixels on the wire, quantized on the host
   onto a quantized stem's grid or normalized on the device before an
   fp32 stem;
3. the ranks' mesh, ``dp`` × ``tp`` over the world's processes (one
   device each; ``parallel.make_mesh``), the tree sliced over ``model``
   for tensor parallelism (``parallel.shard_variables``) — with several
   ranks rank 0 builds the tree and broadcasts it, so every rank serves
   the same grids;
4. :class:`ServingEngine`, warmed on every bucket (a collective with
   several ranks, whose rounds then run in lockstep; ``round_timeout_s``
   arms the round watchdog).

As qtpu's, the engine runs int4 trees on the unpacked weights;
``ResNetInt8Engine(..., packed_int4=True)`` served through a forward
factory runs K1's int4 entry.  A torch checkpoint carries torchvision's
stride-2 geometry, so ``torch_ckpt`` implies ``torch_pad``.

``main`` serves it over HTTP (``serve.http_front``) until SIGINT or
SIGTERM: the handlers are installed before the port is bound, the line
``QTPU_SERVE_READY {json}`` is printed once it is bound, and
``QTPU_SERVE_STOPPED {stats}`` when it stops; the exit code is 0 unless
the engine died.  The server runs on the card unless ``--device cpu``
asks for the CPU.

Several ranks: start one process per rank with ``QTPU_COORDINATOR``
(``host:port`` or an ``init_method`` URL such as ``file:///tmp/rdzv``),
``QTPU_NUM_PROCESSES`` and ``QTPU_PROCESS_ID`` set (``parallel.
initialize_from_env``; ``QTPU_DIST_BACKEND`` picks ``nccl`` or ``gloo``,
else ``nccl`` with a card per rank and ``gloo`` otherwise, and always
``gloo`` with ``--device cpu``), and ``--tp`` / ``--dp`` with ``dp · tp``
equal to the number of ranks.  Each rank binds its own HTTP front — at
``--port`` plus its rank, or a free port with ``--port 0`` — and answers
its own clients; ``info`` names the mesh, the processes and the backend.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from qtpu_torch.data import load_dataset
from qtpu_torch.data.import_torch import (import_torch_state,
                                          load_torch_checkpoint,
                                          supported_models)
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn.serve_layers import serve_model
from qtpu_torch.parallel import distributed
from qtpu_torch.parallel.mesh import make_mesh, shard_variables
from qtpu_torch.serve.dispatch import make_flat_forward
from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.transform import calibrate, freeze
from qtpu_torch.utils import checkpoint as ckpt
from qtpu_torch.utils.device import resolve_device


def _model_kwargs(cfg, torch_pad: bool) -> dict:
    return dict(num_classes=cfg.num_classes, torch_pad=torch_pad,
                width=cfg.width, cifar_stem=cfg.cifar_stem,
                in_channels=1 if cfg.dataset == "mnist" else 3)


def build_model(cfg, *, torch_pad: bool = False, seed: int = 0,
                device=None) -> torch.nn.Module:
    """The config's fp32 model with seeded random weights on ``device``."""
    model = get_model(cfg.model, **_model_kwargs(cfg, torch_pad))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()


def calibration_inputs(cfg, *, torch_pad: bool = False, seed: int = 0,
                       device=None, torch_ckpt: Optional[str] = None,
                       load_state: Optional[str] = None):
    """``(model, policy, batches)`` of :func:`calibrate_from_config`: the
    fp32 weights are the seed's, a torchvision ``.pth`` (``torch_ckpt``)
    or an fp32 ``state_dict`` checkpoint (``load_state``, loaded
    strictly); the calibration batches are ``ds.images[i*bs:(i+1)*bs]``,
    ``i < calib_batches``, of the config's training set (empty ones
    dropped); only those images are built."""
    model = build_model(cfg, torch_pad=torch_pad, seed=seed, device=device)
    if torch_ckpt:
        import_torch_state(cfg.model, load_torch_checkpoint(torch_ckpt),
                           model)
    if load_state:
        model.load_state_dict(ckpt.load(load_state), strict=True)
    bs = cfg.batch_size
    ds = load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=0,
                      first=bs * cfg.calib_batches)
    batches = [ds.images[i * bs:(i + 1) * bs]
               for i in range(cfg.calib_batches)]
    return model, cfg.policy(), [b for b in batches if len(b)]


def calibrate_from_config(cfg, **kw):
    """model → calibrate, as qtpu's ``_freeze_from_config``, on
    :func:`calibration_inputs` (``kw``: its keywords).  Returns ``(model,
    policy, calib)``, the arguments of ``freeze``."""
    model, policy, batches = calibration_inputs(cfg, **kw)
    return model, policy, calibrate(model, policy, batches)


def freeze_from_config(cfg, *, torch_pad: bool = False, seed: int = 0,
                       device=None) -> dict:
    """model → calibrate → freeze; returns the frozen tree."""
    return freeze(*calibrate_from_config(cfg, torch_pad=torch_pad, seed=seed,
                                         device=device))


def serve_module(cfg, tree: dict, *, torch_pad: bool = False, device=None):
    """The config's SERVE-mode model over a frozen ``tree`` (qtpu's
    ``_serve_module``): only the config and the tree are needed."""
    return serve_model(cfg.model, cfg.policy(), tree, device=device,
                       **_model_kwargs(cfg, torch_pad))


def build_forward(cfg, *, load_frozen: Optional[str] = None, seed: int = 0,
                  device=None):
    """The forward ``build_engine`` serves for ``cfg``, alone (no
    scheduler, one process): the flat engine's eager body
    (``eager_forward``, what ``ServingEngine`` compiles per bucket: its
    per-layer scopes run, and a timer that captures its calls captures
    the kernels) or the SERVE-mode model, f32 NHWC images → logits, over
    the frozen tree at ``load_frozen`` or one frozen from the config as
    ``build_engine`` freezes it (seeded weights, the config's
    calibration)."""
    dev = resolve_device(device)
    factory, _, _, serve_path = make_flat_forward(
        cfg.model, exclude=cfg.exclude, num_classes=cfg.num_classes,
        image_size=cfg.image_size, width=cfg.width,
        cifar_stem=cfg.cifar_stem, device=dev)
    tree = (ckpt.load(load_frozen, device=dev) if load_frozen
            else freeze_from_config(cfg, seed=seed, device=dev))
    if serve_path == "module":
        return serve_module(cfg, tree, device=dev)
    return factory(tree)


def check_torch_ckpt(model: str) -> None:
    """SystemExit unless ``model`` has a torchvision importer."""
    if model not in supported_models():
        raise SystemExit(
            f"--torch-ckpt: no torch importer for '{model}' (available: "
            f"{', '.join(supported_models())}; see "
            "qtpu_torch/data/import_torch.py for why)")


def build_engine(cfg, *, tp: int = 1, dp: Optional[int] = None,
                 buckets: Sequence[int] = (8, 32, 128),
                 uint8_ingest: bool = False,
                 load_state: Optional[str] = None,
                 torch_ckpt: Optional[str] = None, torch_pad: bool = False,
                 load_frozen: Optional[str] = None,
                 save_frozen: Optional[str] = None,
                 max_wait_ms: float = 2.0,
                 round_timeout_s: Optional[float] = None,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 stem_dtype: Optional[torch.dtype] = None,
                 pipeline: bool = True, seed: int = 0, device=None):
    """Build the serving stack for an ExperimentConfig (module docstring);
    returns ``(engine, info)``.  ``info["calib_seconds"]``: the
    calibration's range pass, histogram pass and threshold search
    (``calibrate``'s ``seconds``; None for a loaded tree or a rank other
    than 0).  ``tp`` / ``dp``: the mesh over the world's ranks (``dp``
    defaults to the ranks over ``tp``); ``device`` is this rank's
    (``parallel.distributed.rank_device``)."""
    sources = [f for f, v in (("--torch-ckpt", torch_ckpt),
                              ("--load-state", load_state),
                              ("--load-frozen", load_frozen)) if v]
    if len(sources) > 1:
        raise SystemExit(f"{' and '.join(sources)} conflict: pick one fp32 "
                         "weight source")
    if torch_ckpt:
        check_torch_ckpt(cfg.model)
    torch_pad = torch_pad or bool(torch_ckpt)
    dev = distributed.rank_device(device)
    world = distributed.world_size()
    if dp is None:
        dp = world // tp
    mesh = make_mesh(dp=dp, tp=tp)
    shape = (cfg.image_size, cfg.image_size,
             1 if cfg.dataset == "mnist" else 3)
    forward_factory, preprocess_fn, raw_dtype, serve_path = make_flat_forward(
        cfg.model, exclude=cfg.exclude, num_classes=cfg.num_classes,
        image_size=cfg.image_size, width=cfg.width, torch_pad=torch_pad,
        cifar_stem=cfg.cifar_stem, uint8_ingest=uint8_ingest, mean=mean,
        std=std, stem_dtype=stem_dtype, device=dev)
    calib_seconds = tree = None
    if load_frozen:
        tree = ckpt.load(load_frozen, device=dev)
    elif distributed.rank() == 0:
        model, policy, calib = calibrate_from_config(
            cfg, torch_pad=torch_pad, seed=seed, device=dev,
            torch_ckpt=torch_ckpt, load_state=load_state)
        tree = freeze(model, policy, calib)
        calib_seconds = dict(calib["seconds"])
    if not load_frozen and world > 1:
        tree = distributed.broadcast_tree(tree, dev)
    if save_frozen and distributed.rank() == 0:
        ckpt.save(save_frozen, tree)
    tree = shard_variables(tree, mesh)
    smodel = (serve_module(cfg, tree, torch_pad=torch_pad, device=dev)
              if serve_path == "module" else None)
    engine = ServingEngine(
        smodel, tree, mesh=mesh, batch_buckets=tuple(buckets),
        max_wait_ms=max_wait_ms, forward_factory=forward_factory,
        preprocess_fn=preprocess_fn, raw_dtype=raw_dtype,
        round_timeout_s=round_timeout_s, pipeline=pipeline, device=dev)
    engine.warmup(shape)
    info = dict(config=cfg.name, model=cfg.model, image_shape=shape,
                mesh=f"dp={dp},tp={tp}", processes=world,
                backend=distributed.backend(), rank=distributed.rank(),
                round_timeout_s=round_timeout_s,
                watchdog=engine.watchdog_armed,
                buckets=list(engine.buckets),
                graphed_buckets=engine.graphed_buckets,
                graph_bytes=sum(engine.stats()["graph_bytes"].values()),
                serve_path=serve_path,
                torch_pad=torch_pad, device=str(dev),
                raw_dtype=str(np.dtype(raw_dtype)),
                calib_seconds=calib_seconds)
    return engine, info


def main(argv=None) -> int:
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.http_front import serve_http

    p = argparse.ArgumentParser(prog="python -m qtpu_torch.serve",
                                description=__doc__)
    p.add_argument("--config", required=True,
                   help="experiment config name (qtpu_torch.examples.configs)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds a free port (the READY line names it)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--tp", type=int, default=1,
                   help="model-axis size: ranks that split each layer's "
                        "output channels")
    p.add_argument("--dp", type=int, default=None,
                   help="data-axis size (default: the ranks over --tp)")
    p.add_argument("--buckets", default="8,32,128",
                   help="comma-separated batch buckets")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-body-mb", type=float, default=256.0,
                   help="reject POST bodies larger than this (HTTP 413)")
    p.add_argument("--round-timeout", type=float, default=None,
                   help="deadline in seconds of one lockstep round of "
                        "several ranks (a wedged peer fails the round's "
                        "requests and /healthz)")
    p.add_argument("--uint8-ingest", action="store_true",
                   help="accept uint8 images: quantized on the host onto a "
                        "quantized stem's grid, or normalized on the card "
                        "before an fp32 stem")
    p.add_argument("--mean", default="0.0",
                   help="per-channel normalize mean(s), for --uint8-ingest")
    p.add_argument("--std", default="1.0",
                   help="per-channel normalize std(s), for --uint8-ingest")
    p.add_argument("--stem-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="an excluded stem's conv inputs (f32 accumulation)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="serial upload -> forward -> download rounds")
    p.add_argument("--load-state",
                   help="fp32 state_dict checkpoint (examples.run "
                        "--save-state) to quantize")
    p.add_argument("--torch-ckpt",
                   help="torchvision-named .pth to import as the fp32 "
                        "baseline (torchvision geometry)")
    p.add_argument("--torch-pad", action="store_true",
                   help="with --load-frozen: the tree came from a "
                        "torchvision-geometry model")
    p.add_argument("--load-frozen", help="frozen serving tree to serve")
    p.add_argument("--save-frozen", help="save the frozen serving tree here")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.config not in CONFIGS:
        p.error(f"unknown config {args.config!r}; "
                f"choices: {', '.join(sorted(CONFIGS))}")
    try:
        resolve_device(args.device)
        distributed.initialize_from_env(
            backend="gloo" if args.device == "cpu" else None)
        dev = distributed.rank_device(args.device)
    except (RuntimeError, ValueError) as e:
        p.exit(2, f"{p.prog}: {e}\n")
    world = distributed.world_size()
    dp = args.dp if args.dp is not None else world // max(args.tp, 1)
    if args.tp < 1 or dp * args.tp != world:
        p.exit(2, f"{p.prog}: --dp {dp} x --tp {args.tp} needs as many "
                  f"ranks, and {world} run: start one process a rank with "
                  "QTPU_COORDINATOR, QTPU_NUM_PROCESSES and "
                  "QTPU_PROCESS_ID set\n")

    engine, info = build_engine(
        CONFIGS[args.config], tp=args.tp, dp=args.dp,
        buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        uint8_ingest=args.uint8_ingest, load_state=args.load_state,
        torch_ckpt=args.torch_ckpt, torch_pad=args.torch_pad,
        load_frozen=args.load_frozen, save_frozen=args.save_frozen,
        max_wait_ms=args.max_wait_ms, round_timeout_s=args.round_timeout,
        mean=[float(v) for v in args.mean.split(",")],
        std=[float(v) for v in args.std.split(",")],
        stem_dtype=(torch.bfloat16 if args.stem_dtype == "bfloat16"
                    else None),
        pipeline=not args.no_pipeline, seed=args.seed, device=dev)

    # Handlers before the bind, READY only after it: a supervisor that
    # stops a slow start still gets a clean exit, and a READY reader never
    # races the bind.
    stop_evt = threading.Event()
    signal.signal(signal.SIGINT, lambda _s, _f: stop_evt.set())
    signal.signal(signal.SIGTERM, lambda _s, _f: stop_evt.set())
    port = args.port + distributed.rank() if args.port else 0
    server, _ = serve_http(engine, host=args.host, port=port,
                           block=False,
                           max_body_bytes=int(args.max_body_mb * 2**20))
    info.update(host=args.host, port=int(server.server_address[1]))
    print("QTPU_SERVE_READY " + json.dumps(info), flush=True)
    try:
        while not stop_evt.is_set() and engine.healthy:
            stop_evt.wait(0.5)
    finally:
        server.shutdown()
        engine.stop()
        print("QTPU_SERVE_STOPPED " + json.dumps(engine.stats()), flush=True)
    return 0 if engine._error is None else 1


if __name__ == "__main__":
    sys.exit(main())
