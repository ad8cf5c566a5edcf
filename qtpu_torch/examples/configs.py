"""Typed experiment configs (port of qtpu/examples/configs.py): the INT8
PTQ serving configs of ResNet-50 and MobileNet-v1/v2.  The others, and the
training fields, arrive with their models and the trainer (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from qtpu_torch.nn import LayerQuantSpec, QuantPolicy


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    dataset: str
    num_classes: int
    image_size: int
    per_channel: bool = True
    act_observer: str = "minmax"
    exclude: Tuple[str, ...] = ()
    cifar_stem: bool = False
    width: Optional[int] = None
    batch_size: int = 128         # calibration batch size
    calib_batches: int = 8

    def policy(self) -> QuantPolicy:
        """INT8 PTQ with this config's granularity, observer and excludes."""
        spec = LayerQuantSpec(per_channel=self.per_channel,
                              act_observer=self.act_observer)
        return QuantPolicy(default=spec, exclude=self.exclude)


CONFIGS = {
    "resnet50_imagenet_int8_ptq": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16),
    "resnet50_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq_fp32stem", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        exclude=("stem*",)),
    "mobilenetv1_imagenet_int8_ptq": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16),
    "mobilenetv1_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq_fp32stem", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        exclude=("stem*",)),
    "mobilenetv2_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv2_imagenet_int8_ptq_fp32stem", model="mobilenet_v2",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        exclude=("stem*",)),
}
