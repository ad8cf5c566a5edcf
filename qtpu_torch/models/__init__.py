"""Model zoo (torch modules, NHWC at the boundary): LeNet-5, the ResNet
family and MobileNet-v1/v2."""
import functools

from qtpu_torch.models import resnet as _resnet
from qtpu_torch.models.lenet import LeNet5
from qtpu_torch.models.mobilenet import (DWSeparable, InvertedResidual,
                                         MobileNetV1, MobileNetV2)
from qtpu_torch.models.resnet import (BasicBlock, Bottleneck, ResNet,
                                      init_weights)
from qtpu_torch.nn.layers import (Conv, ConvBN, layer_paths,
                                  load_flax_variables)


def _lenet(*, width=None, cifar_stem=False, torch_pad=False, **kwargs):
    """LeNet-5 from a config's common fields: one width of its own, no
    CIFAR stem and no torchvision geometry (qtpu's takes none of them)."""
    if width is not None or cifar_stem or torch_pad:
        raise ValueError(f"LeNet5 takes no width={width!r}, "
                         f"cifar_stem={cifar_stem!r} or "
                         f"torch_pad={torch_pad!r}")
    return LeNet5(**kwargs)


def _mobilenet(cls):
    """A MobileNet constructor that also takes the ResNet fields of a
    config and requires them at their neutral values: a MobileNet has no
    base width, no CIFAR stem and three input channels."""
    def build(*, width=None, cifar_stem=False, in_channels=3, **kwargs):
        if width is not None or cifar_stem or in_channels != 3:
            raise ValueError(
                f"{cls.__name__} takes no width={width!r}, "
                f"cifar_stem={cifar_stem!r} or in_channels={in_channels!r}")
        return cls(**kwargs)
    return build


_REGISTRY = {
    "lenet5": _lenet,
    **{name: functools.partial(_resnet.get_model, name)
       for name in _resnet.STAGES},
    "mobilenet_v1": _mobilenet(MobileNetV1),
    "mobilenet_v2": _mobilenet(MobileNetV2),
}


def get_model(name: str, **kwargs):
    """qtpu.models.get_model.  Every family takes a config's common fields
    (``num_classes``, ``torch_pad``, ``width``, ``cifar_stem``,
    ``in_channels``); besides, ResNet takes ``stage_sizes`` and MobileNet
    ``width_mult``.  LeNet-5 takes ``num_classes`` and ``in_channels``
    and refuses the rest.  The model comes in eval mode, qtpu's ``train=
    False`` default: ``model.train()`` selects batch statistics and the
    observers' updates."""
    try:
        ctor = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_REGISTRY)} (others: ROADMAP.md)") from None
    return ctor(**kwargs).eval()


__all__ = ["BasicBlock", "Bottleneck", "Conv", "ConvBN", "DWSeparable",
           "InvertedResidual", "LeNet5", "MobileNetV1", "MobileNetV2", "ResNet",
           "get_model", "init_weights", "layer_paths", "load_flax_variables"]
