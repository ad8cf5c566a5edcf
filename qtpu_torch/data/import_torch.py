"""Import torchvision-named checkpoints into the port's models (port of
qtpu/data/import_torch.py).

A ``.pth`` the user supplies, with torchvision's ``state_dict`` names
(ResNet-18/34/50/101, MobileNet-v2), becomes the fp32 baseline that
calibration and freeze start from::

    sd = load_torch_checkpoint("resnet50.pth")
    model = get_model("resnet50", num_classes=1000, torch_pad=True)
    import_torch_state("resnet50", sd, model)

Build the model with ``torch_pad=True``: torchvision pads its stride-2
convs symmetrically ((1, 1), (3, 3)) where SAME pads (0, 1), (2, 3).  Both
sides keep weights in OIHW (depthwise (C, 1, k, k)) and linear weights as
(out, in), so the import is a rename with no transpose (qtpu's goes to
HWIO):

    torchvision                      port (``qtpu_torch.models``)
    conv1 / bn1                      stem.conv / stem.bn
    layer{s}.{b}.conv{k} / bn{k}     layer{s}_{b}.conv{k}.conv / .bn
    layer{s}.{b}.downsample.0 / .1   layer{s}_{b}.down.conv / .bn
    features.0.0 / features.0.1      stem (MobileNet-v2)
    features.{i+1}.conv.*            block{i}.expand / dw / project
    features.{N+1}.0 / .1            head
    fc, classifier.1                 fc

The import is strict both ways: every weight and BatchNorm statistic of
the model is filled from a tensor of the same shape, and every tensor of
the checkpoint (but ``num_batches_tracked``) is used, so a naming or
architecture drift raises instead of leaving a layer at its seed.

Coverage is qtpu's: ``supported_models()``.  MobileNet-v1 is left out on
purpose: torchvision has no MobileNet-v1, so there is no canonical naming
to map from (third-party checkpoints disagree on layer names).  LeNet-5
has no model-zoo convention either.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn as nn

__all__ = ["load_torch_checkpoint", "import_torch_state",
           "import_resnet_state", "import_mobilenet_v2_state",
           "supported_models"]

_BN = ("weight", "bias", "running_mean", "running_var")


class _Importer:
    """Copies checkpoint tensors into a model's parameters and buffers,
    checking both sides."""

    def __init__(self, state_dict: Mapping[str, Any], model: nn.Module):
        self.sd = dict(state_dict)
        self.model = model
        self.used: set = set()
        self.filled: set = set()
        self.targets = {**dict(model.named_parameters()),
                        **dict(model.named_buffers())}

    def copy(self, dst: str, src: str) -> None:
        if src not in self.sd:
            raise KeyError(f"checkpoint is missing '{src}'")
        if dst not in self.targets:
            raise KeyError(f"model has no tensor '{dst}'")
        value = torch.as_tensor(self.sd[src])
        t = self.targets[dst]
        if tuple(t.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {dst}: model "
                             f"{tuple(t.shape)} vs checkpoint "
                             f"{tuple(value.shape)} ('{src}')")
        with torch.no_grad():
            t.copy_(value.to(dtype=t.dtype, device=t.device))
        self.used.add(src)
        self.filled.add(dst)

    def convbn(self, path: str, conv_key: str, bn_key: str) -> None:
        """torchvision's ``<conv>.weight`` and ``<bn>.*`` onto ConvBN
        ``path``."""
        if f"{conv_key}.bias" in self.sd:     # torchvision convs have none
            raise ValueError(f"unexpected conv bias at {conv_key}")
        self.copy(f"{path}.conv.weight", f"{conv_key}.weight")
        for leaf in _BN:
            self.copy(f"{path}.bn.{leaf}", f"{bn_key}.{leaf}")

    def dense(self, path: str, key: str) -> None:
        self.copy(f"{path}.weight", f"{key}.weight")
        self.copy(f"{path}.bias", f"{key}.bias")

    def finish(self) -> nn.Module:
        leftover = [k for k in self.sd if k not in self.used
                    and not k.endswith("num_batches_tracked")]
        if leftover:
            raise ValueError(
                f"{len(leftover)} checkpoint tensors were not consumed "
                f"(first: {leftover[:5]}) — architecture/naming mismatch")
        unfilled = [k for k in self.targets if k not in self.filled
                    and not k.endswith("num_batches_tracked")]
        if unfilled:
            raise ValueError(f"{len(unfilled)} model tensors were not "
                             f"filled (first: {unfilled[:5]})")
        return self.model


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` a ``.pth`` (``weights_only``), unwrap a
    ``{"state_dict": ...}`` wrapper and strip DDP's ``module.`` prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in obj.items()}


def import_resnet_state(state_dict: Mapping[str, Any],
                        model: nn.Module) -> nn.Module:
    """torchvision ResNet (BasicBlock or Bottleneck, v1.5: the stride on
    the 3×3) → the port's :class:`~qtpu_torch.models.ResNet`, in place.
    The structure is the model's, so any stage sizes, width or stem the
    checkpoint matches will import."""
    imp = _Importer(state_dict, model)
    for name, child in model.named_children():
        if name == "stem":
            imp.convbn("stem", "conv1", "bn1")
        elif name == "fc":
            imp.dense("fc", "fc")
        elif name.startswith("layer"):
            stage, blk = name[len("layer"):].split("_")
            t = f"layer{stage}.{blk}"
            for sub, _ in child.named_children():
                if sub == "down":
                    imp.convbn(f"{name}.down", f"{t}.downsample.0",
                               f"{t}.downsample.1")
                else:                           # conv1 / conv2 / conv3
                    k = sub[len("conv"):]
                    imp.convbn(f"{name}.{sub}", f"{t}.conv{k}", f"{t}.bn{k}")
        else:
            raise ValueError(f"unexpected ResNet module '{name}'")
    return imp.finish()


def import_mobilenet_v2_state(state_dict: Mapping[str, Any],
                              model: nn.Module) -> nn.Module:
    """torchvision MobileNetV2 → the port's
    :class:`~qtpu_torch.models.MobileNetV2`, in place.  A torchvision
    block ``features.{i+1}.conv`` is [expand ConvBNReLU, dw ConvBNReLU,
    project conv, project BN], or without the expand (block 0, t = 1)
    [dw, project conv, project BN]."""
    imp = _Importer(state_dict, model)
    names = [n for n, _ in model.named_children()]
    n_blocks = sum(1 for n in names if n.startswith("block"))
    for name in names:
        if name == "stem":
            imp.convbn("stem", "features.0.0", "features.0.1")
        elif name == "head":
            t = f"features.{n_blocks + 1}"
            imp.convbn("head", f"{t}.0", f"{t}.1")
        elif name == "fc":
            imp.dense("fc", "classifier.1")
        elif name.startswith("block"):
            t = f"features.{int(name[len('block'):]) + 1}.conv"
            if getattr(model, name).expand is not None:
                imp.convbn(f"{name}.expand", f"{t}.0.0", f"{t}.0.1")
                imp.convbn(f"{name}.dw", f"{t}.1.0", f"{t}.1.1")
                imp.convbn(f"{name}.project", f"{t}.2", f"{t}.3")
            else:
                imp.convbn(f"{name}.dw", f"{t}.0.0", f"{t}.0.1")
                imp.convbn(f"{name}.project", f"{t}.1", f"{t}.2")
        else:
            raise ValueError(f"unexpected MobileNetV2 module '{name}'")
    return imp.finish()


_IMPORTERS = {
    "resnet18": import_resnet_state,
    "resnet34": import_resnet_state,
    "resnet50": import_resnet_state,
    "resnet101": import_resnet_state,
    "mobilenet_v2": import_mobilenet_v2_state,
}


def supported_models() -> tuple:
    """Model names with a torchvision importer (the module docstring says
    why MobileNet-v1 and LeNet-5 are not among them)."""
    return tuple(sorted(_IMPORTERS))


def import_torch_state(model_name: str, state_dict: Mapping[str, Any],
                       model: nn.Module) -> nn.Module:
    """The importer of ``model_name`` (a ``qtpu_torch.models`` name)."""
    try:
        fn = _IMPORTERS[model_name]
    except KeyError:
        raise ValueError(
            f"no torch importer for '{model_name}' "
            f"(available: {sorted(_IMPORTERS)})") from None
    return fn(state_dict, model)
