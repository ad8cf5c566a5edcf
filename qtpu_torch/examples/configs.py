"""Typed experiment configs (port of qtpu/examples/configs.py), one per
BASELINE configuration and a few beyond it: config 1 ``lenet_mnist_int8``
(per-tensor weights, min-max; served on the module SERVE path), config 2
``resnet18_cifar10_int8_kl`` and ``resnet20_cifar10_int8_kl`` (per-channel
weights, KL activations on symmetric grids, CIFAR stem), config 3
``mobilenetv2_imagenet_int8_qat`` (INT8 QAT with the EMA observer, STE and
BN folding), the INT8 PTQ serving configs of ResNet-50/101 and
MobileNet-v1/v2, and config 5 ``resnet50_int4w_int8a_qat`` (int4
per-channel weights, int8 affine activations on the EMA observer, stem
and fc in fp32, a QAT fine-tune).  ``python -m qtpu_torch.examples.run``
trains, quantizes (``method``: ``ptq`` calibrates, ``qat`` fine-tunes,
``online`` quantizes each batch on its own range) and evaluates any of
them; ``serve/cli.build_engine`` calibrates and freezes one for serving.
The training budget is sized for the synthetic data; ``--set`` scales it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from qtpu_torch.nn import LayerQuantSpec, QuantMode, QuantPolicy


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    dataset: str
    num_classes: int
    image_size: int
    method: str                   # 'ptq' | 'qat' | 'online'
    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    act_observer: str = "minmax"  # minmax | ema | kl | pact
    fold_bn: bool = True
    fake_bn: str = "exact"        # 'exact' | 'approx' (QAT fake-BN scheme)
    qat_forward: str = "sim"      # 'sim' | 'int' (QAT conv engine)
    exclude: Tuple[str, ...] = ()
    cifar_stem: bool = False
    width: Optional[int] = None
    # training / calibration budget
    fp32_epochs: int = 3
    qat_epochs: int = 1
    batch_size: int = 128
    lr: float = 2e-3
    qat_lr: float = 2e-4
    calib_batches: int = 8
    n_train: Optional[int] = 8192
    n_eval: Optional[int] = 2048
    serve: bool = False           # serve the frozen model after evaluation

    def policy(self) -> QuantPolicy:
        """This config's bits, granularity, observer, mode (by ``method``),
        BN folding, QAT forward and excludes."""
        spec = LayerQuantSpec(w_bits=self.w_bits, a_bits=self.a_bits,
                              per_channel=self.per_channel,
                              act_observer=self.act_observer)
        mode = {"ptq": QuantMode.QUANT, "qat": QuantMode.QUANT_EMA,
                "online": QuantMode.QUANT_ONLINE}[self.method]
        return QuantPolicy(default=spec, mode=mode, fold_bn=self.fold_bn,
                           fake_bn=self.fake_bn, qat_forward=self.qat_forward,
                           exclude=self.exclude)


CONFIGS = {
    "lenet_mnist_int8": ExperimentConfig(
        name="lenet_mnist_int8", model="lenet5", dataset="mnist",
        num_classes=10, image_size=28, method="ptq", per_channel=False,
        act_observer="minmax"),
    "resnet18_cifar10_int8_kl": ExperimentConfig(
        name="resnet18_cifar10_int8_kl", model="resnet18", dataset="cifar10",
        num_classes=10, image_size=32, method="ptq", per_channel=True,
        act_observer="kl", cifar_stem=True, batch_size=64, fp32_epochs=4),
    "resnet20_cifar10_int8_kl": ExperimentConfig(
        name="resnet20_cifar10_int8_kl", model="resnet20", dataset="cifar10",
        num_classes=10, image_size=32, method="ptq", per_channel=True,
        act_observer="kl", cifar_stem=True, batch_size=64, fp32_epochs=4),
    "mobilenetv2_imagenet_int8_qat": ExperimentConfig(
        name="mobilenetv2_imagenet_int8_qat", model="mobilenet_v2",
        dataset="imagenet", num_classes=1000, image_size=224, method="qat",
        act_observer="ema", fold_bn=True, batch_size=16, n_train=2048,
        n_eval=512, fp32_epochs=2, qat_epochs=1),
    "resnet50_imagenet_int8_ptq": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, serve=True),
    "mobilenetv1_imagenet_int8_ptq": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2),
    "resnet50_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="resnet50_imagenet_int8_ptq_fp32stem", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, serve=True,
        exclude=("stem*",)),
    "mobilenetv1_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv1_imagenet_int8_ptq_fp32stem", model="mobilenet_v1",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, exclude=("stem*",)),
    "mobilenetv2_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="mobilenetv2_imagenet_int8_ptq_fp32stem", model="mobilenet_v2",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, exclude=("stem*",)),
    "resnet101_imagenet_int8_ptq_fp32stem": ExperimentConfig(
        name="resnet101_imagenet_int8_ptq_fp32stem", model="resnet101",
        dataset="imagenet", num_classes=1000, image_size=224, method="ptq",
        per_channel=True, act_observer="minmax", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, serve=True,
        exclude=("stem*",)),
    "resnet50_int4w_int8a_qat": ExperimentConfig(
        name="resnet50_int4w_int8a_qat", model="resnet50",
        dataset="imagenet", num_classes=1000, image_size=224, method="qat",
        w_bits=4, a_bits=8, act_observer="ema", fold_bn=True, batch_size=16,
        n_train=2048, n_eval=512, fp32_epochs=2, qat_epochs=2,
        exclude=("stem*", "fc")),
}
