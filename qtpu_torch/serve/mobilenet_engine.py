"""Flat int8 MobileNet-v2 inference engine (port of
qtpu/serve/mobilenet_engine.py).

An int8-resident pipeline over a frozen MobileNet-v2 tree:

* expand and project 1×1 convs, the head and the int8 fc on K1, with relu6
  and the inverted-residual add folded into the epilogues;
* every depthwise 3×3 (stride 1 or 2) on K3, relu6 and the requant onto
  the project's grid folded into its epilogue and the zero-point pads read
  inside the kernel;
* activations stay int8 between layers on each consumer's calibrated grid;
  the head emits f32 (relu6) for the mean-pool, then the fc re-quantizes;
* an excluded stem runs in fp32 (BN folded at build, TF32 off) from the
  entry's input to int8 codes (``ops/qstem.stem_fp32_codes``); a quantized
  stem is K2 at 3×3/2.

The chained inverted-residual runs (K9) run only through
:class:`qtpu_torch.serve.experimental.ExperimentalMobileNetV2Int8Engine`,
which fills the ``_qivr_prep`` table that ``_plan`` checks and this class
leaves empty.

Layer names mirror :class:`qtpu_torch.models.mobilenet.MobileNetV2`:
``stem``, ``block{i}`` with ``expand`` (absent when t = 1) / ``dw`` /
``project``, ``head``, ``fc``.  qtpu's TPU dispatch options (``use_pallas``,
``dw_shifted``) choose between XLA forms of the same function and have no
counterpart here.  Build, entry points and devices:
:class:`qtpu_torch.serve.flat_engine.FlatInt8Engine`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from qtpu_torch.bench.profile import annotate
from qtpu_torch.models.mobilenet import V2_CFG
from qtpu_torch.ops import qops
from qtpu_torch.serve.flat_engine import FlatInt8Engine
from qtpu_torch.serve.fused_ops import (Grid, channels, conv, depthwise,
                                        gemm_1x1, grid_of, same_shard)

# (name, expansion t, stride) of the 17 inverted residuals; t = 1 has no
# expand conv
V2_BLOCKS = tuple(
    (f"block{i}", t, s) for i, (t, s) in enumerate(
        (t, s if j == 0 else 1) for t, _, n, s in V2_CFG for j in range(n)))


class MobileNetV2Int8Engine(FlatInt8Engine):
    """Flat int8 inference over a frozen MobileNet-v2 tree."""

    depthwise_keys = ("dw",)

    def __init__(self, variables: Dict[str, Any], num_classes: int,
                 torch_pad: bool = False, device=None, normalize=None,
                 stem_dtype=None):
        super().__init__(variables, torch_pad=torch_pad, device=device,
                         normalize=normalize, stem_dtype=stem_dtype)
        self.num_classes = num_classes
        # chained-run dispatch table (first block index -> run): empty here;
        # filled, with _qivr, only by the experimental subclass
        self._qivr_prep: Dict[int, Any] = {}

    def _blocks(self):
        return V2_BLOCKS

    def _block_in_grid(self, name: str) -> Grid:
        return grid_of(self._node(name, "expand") or self._node(name, "dw"))

    def _stem(self, x: torch.Tensor, first: Grid,
              pre_quantized: bool = False, raw_u8: bool = False
              ) -> torch.Tensor:
        """3×3/2 stem with relu6 → int8 codes on block0's grid."""
        stem = self._node("stem")
        if stem is None:
            if pre_quantized:
                raise ValueError("int8 ingest is unavailable with an "
                                 "excluded fp32 stem")
            return self._stem_codes(x, (2, 2), self._pad3, 6.0, first)
        if raw_u8:
            x = self._normalize_u8(x)
        if not pre_quantized:
            g = grid_of(stem)
            x = qops.quantize_act(x, g.scale, g.zp, symmetric=g.sym)
        return conv(x, stem, strides=(2, 2), relu=True, act_max=6.0,
                    requant=first, padding=self._pad3)

    def _block(self, x_q: torch.Tensor, grid: Grid, name: str, stride: int,
               nxt: Grid) -> torch.Tensor:
        """expand (K1, relu6) → dw (K3, relu6) → project (K1, + the int8
        input when the shapes allow), requantized onto ``nxt``."""
        expand = self._node(name, "expand")
        dw = self._node(name, "dw")
        project = self._node(name, "project")
        y = x_q
        if expand is not None:
            # a depthwise sharded alike takes the expand's slice as it is
            y = gemm_1x1(y, expand, relu=True, act_max=6.0,
                         requant=grid_of(dw), out_dtype=torch.int8,
                         gather=not same_shard(expand, dw))
        y = depthwise(y, dw, strides=(stride, stride), relu=True,
                      act_max=6.0, requant=grid_of(project),
                      padding=self._pad3)
        if stride == 1 and x_q.shape[-1] == channels(project):
            return gemm_1x1(y, project, relu=False, requant=nxt,
                            out_dtype=torch.int8, residual=x_q,
                            res_grid=grid)
        return gemm_1x1(y, project, relu=False, requant=nxt,
                        out_dtype=torch.int8)

    def _next_grid(self, i: int) -> Grid:
        """The grid block ``i``'s output goes to: the next block's input
        grid, or the head's."""
        blocks = self._blocks()
        return (self._block_in_grid(blocks[i + 1][0]) if i + 1 < len(blocks)
                else grid_of(self._node("head")))

    def _plan(self):
        """The forward's steps, (first block index, block count, run): a
        chained run of a ``_qivr_prep`` entry (``run`` True) or one block."""
        plan, i = [], 0
        while i < len(self._blocks()):
            run = self._qivr_prep.get(i)
            n = 1 if run is None else run["nrun"]
            plan.append((i, n, run is not None))
            i += n
        return plan

    def _scope(self, step) -> str:
        """qtpu's trace scope of a :meth:`_plan` step: the block's name, or
        ``{name}_ivrun`` (the run's first block) for a chained run."""
        i, _, run = step
        name = self._blocks()[i][0]
        return f"{name}_ivrun" if run else name

    def _step(self, x_q: torch.Tensor, grid: Grid, step):
        """One step of :meth:`_plan` on the block input ``x_q`` on ``grid``
        → (its output, the output's grid)."""
        i, _, run = step
        if run:
            return self._qivr(x_q, i), self._qivr_prep[i]["tgt"]
        name, _, stride = self._blocks()[i]
        nxt = self._next_grid(i)
        return self._block(x_q, grid, name, stride, nxt), nxt

    def _forward(self, x: torch.Tensor, pre_quantized: bool = False,
                 raw_u8: bool = False) -> torch.Tensor:
        head = self._node("head")
        if head is None:
            raise NotImplementedError(
                "excluded head: needs the module SERVE path, which is not "
                "ported (ROADMAP.md)")
        with annotate("stem"):
            grid = self._block_in_grid(self._blocks()[0][0])
            x_q = self._stem(x, grid, pre_quantized=pre_quantized,
                             raw_u8=raw_u8)
        for step in self._plan():
            with annotate(self._scope(step)):
                x_q, grid = self._step(x_q, grid, step)
        with annotate("head"):
            y = gemm_1x1(x_q, head, relu=True, act_max=6.0, requant=None,
                         out_dtype=torch.float32)
            return self._fc(torch.mean(y, dim=(1, 2)))
