"""Typed experiment configs (port of qtpu/examples/configs.py): BASELINE
config 1 ``lenet_mnist_int8`` (per-tensor weights, min-max; served on the
module SERVE path), config 2 ``resnet18_cifar10_int8_kl`` and
``resnet20_cifar10_int8_kl`` (per-channel weights, KL activations on
symmetric grids, CIFAR stem), the INT8 PTQ serving configs of
ResNet-50/101 and MobileNet-v1/v2, and ``resnet50_int4w_int8a_qat``
(BASELINE config 5: int4 per-channel weights, int8 affine activations on
the EMA observer, stem and fc in fp32).  The port serves config 5 as
qtpu's ``build_engine`` does — calibrate and freeze — since its QAT loop
waits for the trainer.  Config 3 and the training fields arrive with the
trainer (ROADMAP.md)."""
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
    method: str = "ptq"           # 'ptq' | 'qat' | 'online'
    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    act_observer: str = "minmax"
    exclude: Tuple[str, ...] = ()
    cifar_stem: bool = False
    width: Optional[int] = None
    batch_size: int = 128         # calibration batch size
    calib_batches: int = 8
    n_train: Optional[int] = 8192  # the training split calibration reads

    def policy(self) -> QuantPolicy:
        """This config's bits, granularity, observer and excludes."""
        spec = LayerQuantSpec(w_bits=self.w_bits, a_bits=self.a_bits,
                              per_channel=self.per_channel,
                              act_observer=self.act_observer)
        return QuantPolicy(default=spec, exclude=self.exclude)


CONFIGS = {
    "lenet_mnist_int8": ExperimentConfig(
        name="lenet_mnist_int8", model="lenet5", dataset="mnist",
        num_classes=10, image_size=28, method="ptq", per_channel=False,
        act_observer="minmax"),
    "resnet18_cifar10_int8_kl": ExperimentConfig(
        name="resnet18_cifar10_int8_kl", model="resnet18", dataset="cifar10",
        num_classes=10, image_size=32, method="ptq", per_channel=True,
        act_observer="kl", cifar_stem=True, batch_size=64),
    "resnet20_cifar10_int8_kl": ExperimentConfig(
        name="resnet20_cifar10_int8_kl", model="resnet20", dataset="cifar10",
        num_classes=10, image_size=32, method="ptq", per_channel=True,
        act_observer="kl", cifar_stem=True, batch_size=64),
    "resnet50_imagenet_int8_ptq": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16, n_train=2048),
    "resnet50_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq_fp32stem", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        n_train=2048, exclude=("stem*",)),
    "mobilenetv1_imagenet_int8_ptq": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16, n_train=2048),
    "mobilenetv1_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq_fp32stem", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        n_train=2048, exclude=("stem*",)),
    "mobilenetv2_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv2_imagenet_int8_ptq_fp32stem", model="mobilenet_v2",
        dataset="imagenet", num_classes=1000, image_size=224,
        per_channel=True, act_observer="minmax", batch_size=16,
        n_train=2048, exclude=("stem*",)),
    "resnet101_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="resnet101_imagenet_int8_ptq_fp32stem", model="resnet101",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", batch_size=16,
        n_train=2048, exclude=("stem*",)),
    "resnet50_int4w_int8a_qat": ExperimentConfig(
        name="resnet50_int4w_int8a_qat", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224, method="qat",
        w_bits=4, a_bits=8, act_observer="ema", batch_size=16,
        n_train=2048, exclude=("stem*", "fc")),
}
