"""Experiment runner: ``python -m qtpu_torch.examples.run --config <name>``
(port of qtpu/examples/run.py).

fp32 training → convert → quantize (``ptq``: calibrate on the first
``calib_batches`` training batches; ``qat``: fine-tune with STE fake-quant
and fake-BN, the EMA observers tracking the activation ranges; ``online``:
per-batch ranges) → evaluate, reporting fp32 and quantized top-1/top-5 and
their deltas as one JSON line with qtpu's keys.  With ``serve`` the
quantized model is then frozen (from its calibrated or EMA state) and the
eval set served through the single-host ``ServingEngine`` on the engine
``serve.dispatch`` picks — the dispatch ``build_engine`` uses.

The fp32 baseline is trained, or imported from a torchvision-named
``.pth`` (``--torch-ckpt``: torchvision's geometry, no fp32 training), or
restored from an fp32 ``state_dict`` checkpoint (``--load-state``, loaded
strictly; ``--save-state`` writes one after the fp32 phase,
``utils.checkpoint``).  Any config field can be overridden: ``--set
fp32_epochs=5``, ``--set qat_forward=int``.  It runs on the card unless
``--device cpu`` asks for the CPU.

``--dp N`` trains data-parallel (``train.fit(mesh=)``) over a world of N
ranks, one process each, started with the ``QTPU_*`` variables of
``parallel.initialize_from_env`` (``gloo`` with ``--device cpu``); each
rank runs the experiment on its device and prints the same JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import NamedTuple, Optional

import torch

from qtpu_torch.data import load_dataset
from qtpu_torch.examples.configs import CONFIGS, ExperimentConfig
from qtpu_torch.nn import QuantMode
from qtpu_torch.parallel import distributed
from qtpu_torch.parallel.mesh import make_mesh
from qtpu_torch.data.import_torch import (import_torch_state,
                                          load_torch_checkpoint)
from qtpu_torch.serve.cli import build_model, check_torch_ckpt, serve_module
from qtpu_torch.serve.dispatch import make_flat_forward
from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.train import evaluate, fit
from qtpu_torch.transform import calibrate, convert_model, freeze, set_mode
from qtpu_torch.utils import checkpoint as ckpt


class Experiment(NamedTuple):
    """What a run leaves: its JSON result, the trained fp32 model, the
    quantized model it evaluated and, when it served, the frozen tree."""
    result: dict
    model: torch.nn.Module
    eval_model: torch.nn.Module
    tree: Optional[dict]


def _serve(cfg: ExperimentConfig, eval_model, eval_ds, dev) -> tuple:
    """Freeze ``eval_model`` and serve the first ``4 × batch_size`` eval
    images through ``ServingEngine``; returns (stats, tree)."""
    tree = freeze(eval_model, eval_model.quant)
    forward_factory, preprocess_fn, raw_dtype, serve_path = make_flat_forward(
        cfg.model, exclude=cfg.exclude, num_classes=cfg.num_classes,
        image_size=cfg.image_size, width=cfg.width,
        cifar_stem=cfg.cifar_stem, device=dev)
    smodel = (serve_module(cfg, tree, device=dev)
              if serve_path == "module" else None)
    engine = ServingEngine(smodel, tree, batch_buckets=(cfg.batch_size,),
                           forward_factory=forward_factory,
                           preprocess_fn=preprocess_fn, raw_dtype=raw_dtype,
                           device=dev)
    try:
        engine.warmup(eval_ds.images.shape[1:])
        n_serve = min(len(eval_ds.images), 4 * cfg.batch_size)
        preds = engine.predict(eval_ds.images[:n_serve])
        stats = engine.stats()
    finally:
        engine.stop()
    serve_top1 = float((preds.argmax(-1) == eval_ds.labels[:n_serve]).mean())
    return ({**{k: round(float(v), 2) for k, v in stats.items()
                if isinstance(v, (int, float))},
             "serve_top1": round(serve_top1, 4), "mesh": "dp=1,tp=1",
             "serve_path": serve_path}, tree)


def experiment(cfg: ExperimentConfig, seed: int = 0, verbose: bool = True,
               device=None, save_state: Optional[str] = None,
               load_state: Optional[str] = None,
               torch_ckpt: Optional[str] = None,
               dp: Optional[int] = None) -> Experiment:
    """Train (or import, or restore), quantize, evaluate (and serve)
    ``cfg``; prints the JSON line.  ``dp``: data-parallel training over
    that many ranks (the world's, initialized from the environment)."""
    if torch_ckpt:
        check_torch_ckpt(cfg.model)
    mesh = None
    if dp is not None and dp > 1:
        distributed.initialize_from_env(
            backend="gloo" if device == "cpu" else None)
        mesh = make_mesh(dp=dp, tp=1)
    dev = distributed.rank_device(device)
    train_ds = load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=seed)
    eval_ds = load_dataset(cfg.dataset, "test", n=cfg.n_eval, seed=seed)
    log_every = 50 if verbose else 0

    model = build_model(cfg, torch_pad=bool(torch_ckpt), seed=seed,
                        device=dev)
    if torch_ckpt:
        import_torch_state(cfg.model, load_torch_checkpoint(torch_ckpt),
                           model)
    elif load_state:
        model.load_state_dict(ckpt.load(load_state), strict=True)
    else:
        fit(model, train_ds, epochs=cfg.fp32_epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, seed=seed,
            log_every=log_every, mesh=mesh)
    if save_state and distributed.rank() == 0:
        ckpt.save(save_state, model.state_dict())
    fp32_top1, fp32_top5 = evaluate(model, eval_ds, cfg.batch_size)

    qmodel = convert_model(model, cfg.policy())   # the trained fp32 state
    if cfg.method == "ptq":
        bs = cfg.batch_size
        calib = [train_ds.images[i * bs:(i + 1) * bs]
                 for i in range(cfg.calib_batches)]
        calibrate(qmodel, qmodel.quant, [c for c in calib if len(c) == bs])
        eval_model = set_mode(qmodel, QuantMode.QUANT)
    elif cfg.method == "qat":
        fit(qmodel, train_ds, epochs=cfg.qat_epochs,
            batch_size=cfg.batch_size, lr=cfg.qat_lr, seed=seed + 1,
            log_every=log_every, mesh=mesh)
        eval_model = qmodel       # QUANT_EMA: the EMA ranges in eval
    else:
        eval_model = qmodel
    q_top1, q_top5 = evaluate(eval_model, eval_ds, cfg.batch_size)

    serving = tree = None
    if cfg.serve:
        serving, tree = _serve(cfg, eval_model, eval_ds, dev)
    result = {
        "config": cfg.name,
        "dataset": cfg.dataset,
        "synthetic_data": bool(train_ds.synthetic),
        "fp32_top1": round(fp32_top1, 4), "fp32_top5": round(fp32_top5, 4),
        "quant_top1": round(q_top1, 4), "quant_top5": round(q_top5, 4),
        "top1_delta": round(fp32_top1 - q_top1, 4),
        "top5_delta": round(fp32_top5 - q_top5, 4),
        "w_bits": cfg.w_bits, "a_bits": cfg.a_bits,
        "method": cfg.method, "act_observer": cfg.act_observer,
    }
    if serving is not None:
        result["serving"] = serving
    print(json.dumps(result), flush=True)
    return Experiment(result, model, eval_model, tree)


def run_experiment(cfg: ExperimentConfig, seed: int = 0, verbose: bool = True,
                   device=None, save_state: Optional[str] = None,
                   load_state: Optional[str] = None,
                   torch_ckpt: Optional[str] = None,
                   dp: Optional[int] = None) -> dict:
    """qtpu's ``run_experiment``: the JSON result of :func:`experiment`."""
    return experiment(cfg, seed=seed, verbose=verbose, device=device,
                      save_state=save_state, load_state=load_state,
                      torch_ckpt=torch_ckpt, dp=dp).result


def _override(cfg: ExperimentConfig, k: str, v: str) -> ExperimentConfig:
    field_type = type(getattr(cfg, k))
    if field_type is bool:
        value = v.lower() in ("1", "true", "yes")
    elif field_type is tuple:
        value = tuple(s for s in v.split(",") if s)
    elif getattr(cfg, k) is None:
        value = int(v)
    else:
        value = field_type(v)
    return dataclasses.replace(cfg, **{k: value})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", action="append", default=[],
                   help="override config fields, e.g. --set fp32_epochs=5")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--save-state",
                   help="save the fp32 model's state_dict here")
    p.add_argument("--load-state",
                   help="restore the fp32 model from a --save-state "
                        "checkpoint instead of training it")
    p.add_argument("--torch-ckpt",
                   help="torchvision-named .pth as the fp32 baseline (no "
                        "fp32 training)")
    p.add_argument("--dp", type=int,
                   help="data-parallel training over this many ranks "
                        "(one process each, QTPU_* variables set)")
    args = p.parse_args(argv)

    cfg = CONFIGS[args.config]
    for override in args.set:
        k, _, v = override.partition("=")
        if not hasattr(cfg, k):
            p.error(f"unknown config field {k!r}")
        cfg = _override(cfg, k, v)
    run_experiment(cfg, seed=args.seed, verbose=not args.quiet,
                   device=args.device, save_state=args.save_state,
                   load_state=args.load_state, torch_ckpt=args.torch_ckpt,
                   dp=args.dp)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
