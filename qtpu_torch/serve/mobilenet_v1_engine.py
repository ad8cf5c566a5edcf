"""Flat int8 MobileNet-v1 inference engine (port of
qtpu/serve/mobilenet_v1_engine.py).

An int8-resident pipeline over a frozen MobileNet-v1 tree — a plain
depthwise-separable stack, no residuals, plain relu:

* stem 3×3/2: fp32 when excluded (BN folded at build, TF32 off), else K2
  with relu and the requant onto block0's grid;
* 13 blocks of depthwise 3×3 on K3 (relu and the requant onto the
  pointwise grid in its epilogue) and pointwise 1×1 on K1; the last
  pointwise emits f32 for the mean-pool;
* the fc: int8 on K1 with its exact dequant epilogue, or fp32 when excluded.

Layer names mirror :class:`qtpu_torch.models.mobilenet.MobileNetV1`:
``stem``, ``block{i}`` with ``dw`` / ``pw``, ``fc``.  Build, entry points
and devices: :class:`qtpu_torch.serve.flat_engine.FlatInt8Engine`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from qtpu_torch.bench.profile import annotate
from qtpu_torch.models.mobilenet import V1_CFG
from qtpu_torch.ops import qops
from qtpu_torch.serve.flat_engine import FlatInt8Engine
from qtpu_torch.serve.fused_ops import (Grid, conv, depthwise, gemm_1x1,
                                        grid_of)

V1_STRIDES = tuple(s for _, s in V1_CFG)


class MobileNetV1Int8Engine(FlatInt8Engine):
    """Flat int8 inference over a frozen MobileNet-v1 tree."""

    depthwise_keys = ("dw",)

    def __init__(self, variables: Dict[str, Any], num_classes: int,
                 torch_pad: bool = False, device=None, normalize=None,
                 stem_dtype=None):
        super().__init__(variables, torch_pad=torch_pad, device=device,
                         normalize=normalize, stem_dtype=stem_dtype)
        self.num_classes = num_classes

    def _stem(self, x: torch.Tensor, first: Grid,
              pre_quantized: bool = False) -> torch.Tensor:
        """3×3/2 stem with relu → int8 codes on block0's dw grid."""
        stem = self._node("stem")
        if stem is None:
            if pre_quantized:
                raise ValueError("int8 ingest is unavailable with an "
                                 "excluded fp32 stem")
            y = torch.clamp_min(self._stem_conv_fp32(x, (2, 2), self._pad3),
                                0.0)
            return qops.quantize_act(y, first.scale, first.zp,
                                     symmetric=first.sym)
        if not pre_quantized:
            g = grid_of(stem)
            x = qops.quantize_act(x, g.scale, g.zp, symmetric=g.sym)
        return conv(x, stem, strides=(2, 2), relu=True, requant=first,
                    padding=self._pad3)

    def _block(self, x_q: torch.Tensor, i: int,
               nxt: Optional[Grid]) -> torch.Tensor:
        """dw (K3, relu) → pw (K1, relu), requantized onto ``nxt`` (f32
        out when ``nxt`` is None)."""
        dw = self._node(f"block{i}", "dw")
        pw = self._node(f"block{i}", "pw")
        if dw is None or pw is None:
            raise NotImplementedError(
                "excluded block layers: need the module SERVE path, which "
                "is not ported (ROADMAP.md)")
        s = V1_STRIDES[i]
        y = depthwise(x_q, dw, strides=(s, s), relu=True,
                      requant=grid_of(pw), padding=self._pad3)
        return gemm_1x1(y, pw, relu=True, requant=nxt,
                        out_dtype=torch.int8 if nxt is not None
                        else torch.float32)

    def _forward(self, x: torch.Tensor, pre_quantized: bool = False,
                 raw_u8: bool = False) -> torch.Tensor:
        with annotate("stem"):
            if raw_u8:
                x = self._normalize_u8(x)
            x_q = self._stem(x, grid_of(self._node("block0", "dw")),
                             pre_quantized=pre_quantized)
        n = len(V1_STRIDES)
        for i in range(n):
            # the next consumer's grid: the next block's dw, or f32 out of
            # the last block (the mean-pool consumes f32, the fc requantizes)
            nxt = (grid_of(self._node(f"block{i + 1}", "dw"))
                   if i + 1 < n else None)
            with annotate(f"block{i}"):
                x_q = self._block(x_q, i, nxt)
        with annotate("head"):
            return self._fc(torch.mean(x_q, dim=(1, 2)))
