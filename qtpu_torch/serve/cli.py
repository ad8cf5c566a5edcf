"""Serving stack assembly (port of ``build_engine`` of qtpu/serve/cli.py).

model (seeded random weights) → calibration on qtpu's data (the config's
observer: min-max, KL for the CIFAR ResNets, or EMA for
``resnet50_int4w_int8a_qat``): the first ``calib_batches`` batches of
``load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=0)``, real images
under ``$QTPU_DATA_DIR`` or the synthetic set, at the dataset's own image
size → ``freeze`` (int8, or nibble-packed int4 weights) → the flat int8
engine, or for the configs dispatch sends to the module SERVE path
(LeNet-5, excludes beyond stem/fc) the SERVE-mode model
(:func:`serve_module`) → :class:`ServingEngine`, warmed on every
bucket.  As qtpu's, the engine
runs int4 trees on the unpacked weights; ``ResNetInt8Engine(...,
packed_int4=True)`` served through a forward factory runs K1's int4
entry.  No mesh, checkpoint or torch-checkpoint import yet; the HTTP
front and the CLI ``main`` wait too (ROADMAP.md).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from qtpu_torch.data import load_dataset
from qtpu_torch.models import get_model, init_weights
from qtpu_torch.nn.serve_layers import serve_model
from qtpu_torch.serve.dispatch import make_flat_forward
from qtpu_torch.serve.engine import ServingEngine
from qtpu_torch.transform import calibrate, freeze
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


def calibrate_from_config(cfg, *, torch_pad: bool = False, seed: int = 0,
                          device=None):
    """model → calibrate, as qtpu's ``_freeze_from_config``: the
    calibration batches are ``ds.images[i*bs:(i+1)*bs]``, ``i <
    calib_batches``, of the config's training set (empty ones dropped);
    only those images are built.  Returns ``(model, policy, calib)``, the
    arguments of ``freeze``."""
    model = build_model(cfg, torch_pad=torch_pad, seed=seed, device=device)
    bs = cfg.batch_size
    ds = load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=0,
                      first=bs * cfg.calib_batches)
    batches = [ds.images[i * bs:(i + 1) * bs]
               for i in range(cfg.calib_batches)]
    batches = [b for b in batches if len(b)]
    policy = cfg.policy()
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


def build_engine(cfg, *, buckets: Sequence[int] = (8, 32, 128),
                 uint8_ingest: bool = False, torch_pad: bool = False,
                 max_wait_ms: float = 2.0, mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,), pipeline: bool = True,
                 seed: int = 0, device=None):
    """Build the serving stack for an ExperimentConfig; returns
    ``(engine, info)``.  ``info["calib_seconds"]``: the calibration's range
    pass, histogram pass and threshold search (``calibrate``'s
    ``seconds``)."""
    dev = resolve_device(device)
    shape = (cfg.image_size, cfg.image_size,
             1 if cfg.dataset == "mnist" else 3)
    model, policy, calib = calibrate_from_config(
        cfg, torch_pad=torch_pad, seed=seed, device=dev)
    tree = freeze(model, policy, calib)
    forward_factory, preprocess_fn, raw_dtype, serve_path = make_flat_forward(
        cfg.model, exclude=cfg.exclude, num_classes=cfg.num_classes,
        image_size=cfg.image_size, width=cfg.width, torch_pad=torch_pad,
        cifar_stem=cfg.cifar_stem, uint8_ingest=uint8_ingest, mean=mean,
        std=std, device=dev)
    smodel = (serve_module(cfg, tree, torch_pad=torch_pad, device=dev)
              if serve_path == "module" else None)
    engine = ServingEngine(
        smodel, tree, batch_buckets=tuple(buckets), max_wait_ms=max_wait_ms,
        forward_factory=forward_factory, preprocess_fn=preprocess_fn,
        raw_dtype=raw_dtype, pipeline=pipeline, device=dev)
    engine.warmup(shape)
    info = dict(config=cfg.name, model=cfg.model, image_shape=shape,
                buckets=list(engine.buckets), serve_path=serve_path,
                torch_pad=torch_pad, device=str(dev),
                raw_dtype=str(np.dtype(raw_dtype)),
                calib_seconds=dict(calib["seconds"]))
    return engine, info
