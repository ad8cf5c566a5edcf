"""Flat int8 ResNet inference engine (port of qtpu/serve/resnet_engine.py).

Runs ResNet-18/50-style nets from a frozen tree (``qweights`` plus the fp32
``params``/``batch_stats`` of excluded layers) as an int8-resident
pipeline:

* every 1×1 conv and the int8 fc run on K1 (int4 nodes on its int4 entry
  with ``packed_int4``), every K×K conv on K2, with the
  dequant → (residual) → relu → requant chain folded into the kernels'
  epilogues — activations stay int8 codes between layers, each on its
  consumer's calibrated grid;
* a block input's codes, quantized once on the reduce conv's grid, are
  reused by the downsample branch;
* max-pool commutes with the monotonic quantizer, so the stem max-pool runs
  on int8 codes (padding −128);
* an excluded stem runs in fp32 (BN folded at build, TF32 off), an excluded
  fc as a plain fp32 matmul.

The fused bottleneck kernels (K4-K6) and the chained runs (K7/K8) run only
through :class:`qtpu_torch.serve.experimental.ExperimentalResNetInt8Engine`,
which fills the dispatch tables that ``_bottleneck`` and ``_plan`` check and
this class leaves empty.

Build, entry points and devices: :class:`qtpu_torch.serve.flat_engine.
FlatInt8Engine`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from qtpu_torch.bench.profile import annotate
from qtpu_torch.ops import qops
from qtpu_torch.serve.flat_engine import FlatInt8Engine
from qtpu_torch.serve.fused_ops import (conv, dequant, gemm_1x1, grid_of,
                                        grid_parts, same_shard)


def maxpool_codes(y_q: torch.Tensor, pads) -> torch.Tensor:
    """3×3/2 max-pool of int8 NHWC codes, padded with −128: the max of the
    nine strided window slices."""
    yp = qops.pad_nhwc(y_q, pads, -128)
    Hp, Wp = yp.shape[1:3]
    OH, OW = (Hp - 3) // 2 + 1, (Wp - 3) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            s = yp[:, dy:dy + 2 * (OH - 1) + 1:2, dx:dx + 2 * (OW - 1) + 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


class ResNetInt8Engine(FlatInt8Engine):
    """Flat int8 inference over a frozen ResNet tree.

    ``arch``: dict(stage_sizes, width, bottleneck, cifar_stem, num_classes
    [, torch_pad]).  ``torch_pad=True`` runs the torchvision geometry:
    explicit symmetric pads on the 7×7 stem, the 3×3/2 max-pool and the
    strided 3×3 convs, where SAME pads (0, 1).
    ``device``: ``None`` means the card (raises without one); pass
    ``"cpu"`` for the plain path.

    ``packed_int4`` (qtpu's flag): every 1×1 GEMM of an int4 node — conv1,
    conv3, the downsample, and an int4 fc — keeps its weight nibble-packed
    and runs on K1's int4 entry, which unpacks it in the kernel; the 3×3
    convs run the unpacked int8 weight on K2, as qtpu's ``conv_xla``.  The
    codes are those of the int8 entry on the unpacked weight.  Deviations
    from qtpu, with the same codes: its extra guard ``(bn // 2) % 128 == 0
    and Co % bn == 0`` (qtpu/serve/fused_ops.py:157-158) is the TPU's
    128-lane rule for its tile-halves layout and is left out on purpose
    (the port's layout, ``ops.qmatmul.pack_int4_nk``, takes any even K);
    qtpu runs an int4 fc on its unpacked weight, the port on the int4 entry
    like every other 1×1 GEMM.
    """

    def __init__(self, variables: Dict[str, Any], arch: Dict[str, Any],
                 device=None, normalize=None, packed_int4: bool = False,
                 stem_dtype=None):
        super().__init__(variables, torch_pad=arch.get("torch_pad", False),
                         device=device, normalize=normalize,
                         packed_int4=packed_int4, stem_dtype=stem_dtype)
        self.arch = dict(arch)
        self._names = self._block_names()
        # Fused-kernel dispatch tables (block name -> entry, and stage index
        # -> chained run): empty here, so the guards in _bottleneck and
        # _plan never fire; filled, with the _qblock / _qtail / _qproj /
        # _qstage methods, only by the experimental subclass.
        self._qtail_prep: Dict[str, Any] = {}
        self._qproj_prep: Dict[str, Any] = {}
        self._qblock_prep: Dict[str, Any] = {}
        self._qstage_prep: Dict[int, Any] = {}

    def _block_names(self):
        out = []
        for i, n in enumerate(self.arch["stage_sizes"]):
            for j in range(n):
                out.append((f"layer{i + 1}_{j}", i, j))
        return out

    # -- network --------------------------------------------------------------

    def _stem(self, x: torch.Tensor, first_grid, pre_quantized: bool = False
              ) -> torch.Tensor:
        node = self._node("stem")
        cifar = self.arch.get("cifar_stem", False)
        strides = (1, 1) if cifar else (2, 2)
        if self.torch_pad and not cifar:
            conv_pad, pool_pad = ((3, 3), (3, 3)), ((1, 1), (1, 1))
        else:
            conv_pad, pool_pad = "SAME", None
        if node is None:
            # Excluded stem: fp32 conv (BN folded at build, full fp32 — no
            # TF32), relu, quantize onto the first block's grid, then
            # max-pool on the int8 codes.
            if pre_quantized:
                raise ValueError(
                    "int8 ingest is unavailable with an excluded fp32 stem")
            y = torch.clamp_min(
                self._stem_conv_fp32(x, strides, conv_pad), 0.0)
            fs, fz, fsym = first_grid
            y_q = qops.quantize_act(y, fs, fz, symmetric=fsym)
        else:
            if pre_quantized:
                x_q = x
            else:
                g = grid_of(node)
                x_q = qops.quantize_act(x, g.scale, g.zp, symmetric=g.sym)
            y_q = conv(x_q, node, strides=strides, relu=True,
                       requant=first_grid, padding=conv_pad)
        if not cifar:
            if pool_pad is None:
                pool_pad = qops.same_pads(y_q.shape[1:3], (3, 3), (2, 2))
            y_q = maxpool_codes(y_q, pool_pad)
        return y_q

    def _bottleneck(self, x_q: torch.Tensor, x_grid, name: str, strides,
                    next_grid) -> torch.Tensor:
        c1, c2, c3 = (self._node(name, k) for k in ("conv1", "conv2",
                                                     "conv3"))
        down = self._node(name, "down")
        affine_next = next_grid is not None and not grid_parts(next_grid)[2]
        if (down is None and strides == (1, 1) and affine_next
                and name in self._qblock_prep):
            return self._qblock(x_q, x_grid, name, next_grid)
        if (down is None and strides == (1, 1) and affine_next
                and not grid_parts(x_grid)[2] and name in self._qtail_prep):
            return self._qtail(x_q, x_grid, name, next_grid)
        a = gemm_1x1(x_q, c1, relu=True, requant=grid_of(c2),
                     out_dtype=torch.int8)
        b = conv(a, c2, strides=strides, relu=True, requant=grid_of(c3),
                 padding=self._pad3)
        if down is not None:
            if affine_next and name in self._qproj_prep:
                return self._qproj(b, x_q, name, strides, next_grid)
            x_d = x_q[:, ::strides[0], ::strides[1], :]
            res = gemm_1x1(x_d, down, relu=False, requant=None,
                           out_dtype=torch.float32,
                           gather=not same_shard(down, c3))
            res_grid = None          # f32 residual (projection blocks)
        else:
            res = x_q                # int8 codes reused: no extra traffic
            res_grid = x_grid
        # project 1x1 with residual add + relu + requant fused in the epilogue
        # (next_grid None — excluded fp32 fc — leaves the output in fp32)
        return gemm_1x1(b, c3, relu=True, requant=next_grid,
                        out_dtype=torch.int8 if next_grid is not None
                        else torch.float32,
                        residual=res, res_grid=res_grid)

    def _basic(self, x_q: torch.Tensor, x_grid, name: str, strides,
               next_grid) -> torch.Tensor:
        c1, c2 = (self._node(name, k) for k in ("conv1", "conv2"))
        down = self._node(name, "down")
        a = conv(x_q, c1, strides=strides, relu=True, requant=grid_of(c2),
                 padding=self._pad3)
        b = conv(a, c2, strides=(1, 1), relu=False, requant=None,
                 padding=self._pad3)
        if down is not None:
            r = gemm_1x1(x_q[:, ::strides[0], ::strides[1], :], down,
                         relu=False, requant=None, out_dtype=torch.float32)
        else:
            r = dequant(x_q, x_grid)
        y = torch.clamp_min(b + r, 0.0)
        if next_grid is None:        # excluded fp32 fc consumes fp32
            return y
        ns, nz, nsym = next_grid
        return qops.quantize_act(y, ns, nz, symmetric=nsym)

    def _next_grid(self, idx: int):
        """The grid block ``idx``'s output goes to: the next block's conv1
        grid, or the fc's (None when the fc is excluded: f32 out)."""
        names = self._names
        if idx + 1 < len(names):
            return grid_of(self._node(names[idx + 1][0], "conv1"))
        fc = self._node("fc")
        return grid_of(fc) if fc is not None else None

    def _plan(self):
        """The forward's steps, (first block index, block count, stage):
        a chained run of a ``_qstage_prep`` entry (``stage`` its stage
        index) — the whole stage when it chains the projection block, the
        identity blocks from ``j == 1`` otherwise — or one block (``stage``
        None)."""
        names, plan, idx = self._names, [], 0
        while idx < len(names):
            _, i, j = names[idx]
            run = self._qstage_prep.get(i)
            if run is not None and j == (1 if run["proj"] is None else 0):
                n, stage = run["nrun"] + (1 - j), i
            else:
                n, stage = 1, None
            plan.append((idx, n, stage))
            idx += n
        return plan

    def _scope(self, step) -> str:
        """qtpu's trace scope of a :meth:`_plan` step: the block's name, or
        ``layer{i}_stage`` for a chained run that includes the projection
        block and ``layer{i}_idrun`` for an identity run."""
        idx, _, stage = step
        if stage is None:
            return self._names[idx][0]
        kind = "idrun" if self._qstage_prep[stage]["proj"] is None else "stage"
        return f"layer{stage + 1}_{kind}"

    def _step(self, x_q: torch.Tensor, grid, step):
        """One step of :meth:`_plan` on the block input ``x_q`` on ``grid``
        → (its output, the output's grid)."""
        idx, _, stage = step
        if stage is not None:
            return self._qstage(x_q, stage)
        name, i, j = self._names[idx]
        strides = (2, 2) if (i > 0 and j == 0) else (1, 1)
        nxt = self._next_grid(idx)
        block = (self._bottleneck if self.arch.get("bottleneck", True)
                 else self._basic)
        return block(x_q, grid, name, strides, nxt), nxt

    def _forward(self, x: torch.Tensor, pre_quantized: bool = False,
                 raw_u8: bool = False) -> torch.Tensor:
        first = self._node(self._names[0][0], "conv1")
        fc = self._node("fc")
        with annotate("stem"):
            if raw_u8:
                x = self._normalize_u8(x)
            x_q = self._stem(x, grid_of(first), pre_quantized=pre_quantized)
        grid = grid_of(first)
        for step in self._plan():
            with annotate(self._scope(step)):
                x_q, grid = self._step(x_q, grid, step)
        with annotate("head"):
            if fc is None:
                pooled = torch.mean(x_q, dim=(1, 2))  # fp32 from last block
            else:
                pooled = qops.spatial_mean(dequant(x_q, grid))
            return self._fc(pooled)
