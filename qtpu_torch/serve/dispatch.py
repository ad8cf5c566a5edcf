"""Flat-engine dispatch policy (port of qtpu/serve/dispatch.py).

Eligibility is decided as the conversion decides exclusion — ``fnmatch``
globs over the model's quantizable layer paths — and the flat engines
(ResNet, MobileNet-v1/v2) run ``stem``/``fc`` exclusions in fp32
themselves.  Every other config (LeNet-5, or excludes beyond stem/fc)
takes the module SERVE path (``qtpu_torch.nn.serve_layers``).  The
host-quantized int8 ingest (which needs the native preprocessor) is still
to port (ROADMAP.md).
"""
from __future__ import annotations

import fnmatch
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from qtpu_torch.serve.mobilenet_engine import (V2_BLOCKS,
                                               MobileNetV2Int8Engine)
from qtpu_torch.serve.mobilenet_v1_engine import (V1_STRIDES,
                                                  MobileNetV1Int8Engine)
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

_RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet20": (3, 3, 3),
                  "resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3),
                  "resnet56": (9, 9, 9), "resnet101": (3, 4, 23, 3)}
_RESNET_BOTTLENECK = frozenset({"resnet50", "resnet101"})
_RESNET_WIDTH = {"resnet20": 16, "resnet56": 16}

_MOBILENET_ENGINES = {"mobilenet_v1": MobileNetV1Int8Engine,
                      "mobilenet_v2": MobileNetV2Int8Engine}

ENGINE_FP32_OK = frozenset({"stem", "fc"})


def quantized_layer_paths(model: str) -> Tuple[str, ...]:
    """Every quantizable layer path of ``model``, as the policy matcher
    sees them."""
    if model == "mobilenet_v2":
        paths = ["stem", "head", "fc"]
        for name, t, _ in V2_BLOCKS:
            if t != 1:
                paths.append(f"{name}/expand")
            paths += [f"{name}/dw", f"{name}/project"]
        return tuple(paths)
    if model == "mobilenet_v1":
        paths = ["stem", "fc"]
        for i in range(len(V1_STRIDES)):
            paths += [f"block{i}/dw", f"block{i}/pw"]
        return tuple(paths)
    if model not in _RESNET_STAGES:
        return ()
    bottleneck = model in _RESNET_BOTTLENECK
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
    paths = ["stem", "fc"]
    for i, n in enumerate(_RESNET_STAGES[model]):
        for j in range(n):
            blk = f"layer{i + 1}_{j}"
            paths += [f"{blk}/{c}" for c in convs]
            if j == 0 and (i > 0 or bottleneck):
                paths.append(f"{blk}/down")
    return tuple(paths)


def excluded_paths(model: str, exclude: Iterable[str]) -> frozenset:
    pats = tuple(exclude)
    return frozenset(p for p in quantized_layer_paths(model)
                     if any(fnmatch.fnmatch(p, pat) for pat in pats))


def flat_engine_eligible(model: str, exclude: Iterable[str]
                         ) -> Tuple[bool, frozenset]:
    """(eligible, excluded-layer set) for the flat int8 engines."""
    if model not in (*_RESNET_STAGES, *_MOBILENET_ENGINES):
        return False, frozenset()
    exc = excluded_paths(model, exclude)
    return exc <= ENGINE_FP32_OK, exc


def resnet_arch(model: str, *, num_classes: int, image_size: int,
                width: Optional[int] = None, torch_pad: bool = False,
                cifar_stem: Optional[bool] = None) -> dict:
    """ResNetInt8Engine arch dict.  ``cifar_stem`` defaults to qtpu's rule
    (image_size ≤ 64); callers that built the model pass its own flag."""
    return dict(stage_sizes=_RESNET_STAGES[model],
                width=width or _RESNET_WIDTH.get(model, 64),
                bottleneck=model in _RESNET_BOTTLENECK,
                cifar_stem=(image_size <= 64 if cifar_stem is None
                            else cifar_stem),
                num_classes=num_classes, torch_pad=torch_pad)


def make_flat_forward(model: str, *, exclude: Sequence[str] = (),
                      num_classes: int = 1000, image_size: int = 224,
                      width: Optional[int] = None, torch_pad: bool = False,
                      cifar_stem: Optional[bool] = None,
                      uint8_ingest: bool = False,
                      mean: Sequence[float] = (0.0,),
                      std: Sequence[float] = (1.0,), device=None):
    """(forward_factory, preprocess_fn, raw_dtype, serve_path).

    * ineligible config → ``(None, None, float32, "module")``, the module
      SERVE path; with ``uint8_ingest`` there, SystemExit — the module
      path takes f32 images;
    * f32 ingest → the engine's ``forward``; with an excluded fp32 stem,
      ``uint8_ingest`` puts raw 0-255 pixels on the wire, normalized on the
      device (``forward_u8``).  Host-quantized int8 ingest is not ported
      and raises."""
    eligible, exc = flat_engine_eligible(model, exclude)
    if not eligible:
        if uint8_ingest:
            raise SystemExit(
                "--uint8-ingest needs a flat-engine config (resnet/mobilenet "
                f"with excludes limited to stem/fc; this one excludes "
                f"{sorted(exc) or list(exclude)}): the module SERVE path "
                "takes f32 images")
        return None, None, np.float32, "module"
    stem_excluded = "stem" in exc
    if uint8_ingest and not stem_excluded:
        raise NotImplementedError(
            "uint8 ingest onto a quantized stem needs the native host "
            "preprocessor, not ported yet (ROADMAP.md)")
    channels = 1 if image_size <= 28 else 3
    normalize = (
        tuple(np.broadcast_to(np.asarray(mean, np.float32),
                              (channels,)).tolist()),
        tuple(np.broadcast_to(np.asarray(std, np.float32),
                              (channels,)).tolist()))

    def build(sv):
        if model in _MOBILENET_ENGINES:
            return _MOBILENET_ENGINES[model](
                sv, num_classes=num_classes, torch_pad=torch_pad,
                device=device, normalize=normalize)
        arch = resnet_arch(model, num_classes=num_classes,
                           image_size=image_size, width=width,
                           torch_pad=torch_pad, cifar_stem=cifar_stem)
        return ResNetInt8Engine(sv, arch, device=device, normalize=normalize)

    if not uint8_ingest:
        return (lambda sv: build(sv).forward), None, np.float32, "flat-engine"
    return ((lambda sv: build(sv).forward_u8), None, np.uint8,
            "flat-engine+u8-ingest")
