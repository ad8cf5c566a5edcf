"""Model zoo (torch modules, NHWC at the boundary) — the ResNet family so far;
LeNet-5 and MobileNet-v1/v2 are still to port (ROADMAP.md)."""
from qtpu_torch.models.resnet import (BasicBlock, Bottleneck, ConvBN, ResNet,
                                      get_model, init_weights, layer_paths,
                                      load_flax_variables)

__all__ = ["BasicBlock", "Bottleneck", "ConvBN", "ResNet", "get_model",
           "init_weights", "layer_paths", "load_flax_variables"]
