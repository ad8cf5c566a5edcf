"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
card and without an explicit ``"cpu"`` they raise instead of carrying on
on the CPU, so a run never reports CPU work as GPU work.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """Full-precision float32 convolutions and matmuls on the card: cuDNN
    would otherwise run fp32 convs in TF32 (about three decimal digits),
    which moves the codes quantized from their outputs."""
    cudnn = torch.backends.cudnn
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qtpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cpu_conv_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` made contiguous (NCHW) on the CPU, as it is elsewhere, for a
    conv whose backward runs: PyTorch's CPU conv backward corrupts the
    heap on some channels-last inputs (a 1×1 stride-2 conv of an (N, 8,
    32, 32) view of NHWC memory, with several threads), and the models'
    inputs are such views.  Forwards without autograd — the eval forms
    that calibration, freeze and the engines' fp32 layers run — do not
    call it, and keep their layout and their bits."""
    return x.contiguous() if x.device.type == "cpu" else x
