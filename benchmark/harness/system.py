"""The system under test, ``qtpu_torch``, assembled as its server assembles
it (``qtpu_torch.serve.cli.build_engine``): the configuration's model
holding the benchmark's weights → ``transform.calibrate`` on the
benchmark's calibration batches → ``transform.freeze`` → the flat int8
engine that ``serve.dispatch.make_flat_forward`` picks for uint8 ingest,
called directly (offline) or served by ``ServingEngine`` (open loop).

The only module of the benchmark that imports the system; it takes from it
the system and nothing that the yardstick needs.
"""
from __future__ import annotations

import numpy as np
import torch


def experiment(cfg: dict):
    """The system's experiment config the configuration file names, checked
    against what the file states."""
    from qtpu_torch.examples.configs import CONFIGS

    ec = CONFIGS[cfg["experiment"]]
    q = cfg["quantization"]
    stated = dict(model=cfg["model"], num_classes=cfg["num_classes"],
                  image_size=cfg["image_size"], w_bits=q["w_bits"],
                  a_bits=q["a_bits"], per_channel=True,
                  act_observer=q["act_observer"], fold_bn=True,
                  exclude=tuple(q["exclude"]))
    for k, v in stated.items():
        if getattr(ec, k) != v:
            raise ValueError(f"{cfg['experiment']}.{k} is {getattr(ec, k)!r}"
                             f", the configuration file states {v!r}")
    return ec


def build_kernels(names) -> None:
    """Build the named CUDA sources (all together) into the package's
    fixed build directory; a later run finds them built."""
    from qtpu_torch.ops import _build

    _build.build(list(names))


def model(cfg: dict, state: dict) -> torch.nn.Module:
    """The configuration's float model holding copies of ``state``'s tensors,
    on their device: built without storage and given them (no weight of the
    system's own initialisation is made; ``to_empty`` would take seconds)."""
    from qtpu_torch.models import get_model

    ec = experiment(cfg)
    with torch.device("meta"):
        m = get_model(ec.model, num_classes=ec.num_classes, torch_pad=False,
                      width=ec.width, cifar_stem=ec.cifar_stem,
                      in_channels=cfg["in_channels"])
    m.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True,
                      assign=True)
    return m.eval()


def quantize(cfg: dict, m: torch.nn.Module, batches, phases) -> dict:
    """model → calibrate → freeze: the frozen tree (``phases.done`` marks
    the end of each)."""
    from qtpu_torch.transform import calibrate, freeze

    policy = experiment(cfg).policy()
    calib = calibrate(m, policy, batches)
    phases.done("calibrate")
    tree = freeze(m, policy, calib)
    phases.done("freeze")
    return tree


def _flat(cfg: dict, device):
    from qtpu_torch.serve.dispatch import make_flat_forward

    ec = experiment(cfg)
    ing = cfg["ingest"]
    factory, preprocess, raw_dtype, path = make_flat_forward(
        ec.model, exclude=ec.exclude, num_classes=ec.num_classes,
        image_size=ec.image_size, width=ec.width, cifar_stem=ec.cifar_stem,
        uint8_ingest=True, mean=ing["mean"], std=ing["std"], device=device)
    if path != "flat-engine+u8-ingest" or preprocess is not None:
        raise ValueError(f"{cfg['name']}: dispatch chose {path}, not the "
                         "flat engine with uint8 pixels normalized on the "
                         "device")
    return factory, raw_dtype


def offline_engine(cfg: dict, tree: dict, device):
    """The flat engine itself (its ``forward_u8`` compiles per shape)."""
    factory, _ = _flat(cfg, device)
    return factory(tree).__self__


def serving_engine(cfg: dict, tree: dict, traffic: dict, device):
    """``ServingEngine`` over the flat engine's uint8 forward, warmed on
    every bucket, as ``build_engine`` builds it on one process."""
    from qtpu_torch.parallel.mesh import make_mesh, shard_variables
    from qtpu_torch.serve.engine import ServingEngine

    factory, raw_dtype = _flat(cfg, device)
    mesh = make_mesh(dp=1, tp=1)
    eng = ServingEngine(
        None, shard_variables(tree, mesh), mesh=mesh,
        batch_buckets=tuple(traffic["buckets"]),
        max_wait_ms=float(traffic["max_wait_ms"]), forward_factory=factory,
        preprocess_fn=None, raw_dtype=raw_dtype,
        pipeline=bool(traffic["pipeline"]), device=device)
    eng.warmup((cfg["image_size"], cfg["image_size"], cfg["in_channels"]))
    if np.dtype(raw_dtype) != np.uint8:
        raise ValueError(f"ingest dtype {raw_dtype}, not uint8")
    return eng
