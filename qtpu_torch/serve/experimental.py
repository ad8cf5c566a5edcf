"""The ResNet and MobileNet-v2 engines with the fused and chained kernels
(port of qtpu/serve/experimental.py: ExperimentalResNetInt8Engine and
ExperimentalMobileNetV2Int8Engine).

The product :class:`~qtpu_torch.serve.resnet_engine.ResNetInt8Engine` runs
every bottleneck as K1 → K2 → K1 (plus a downsample K1 in a projection
block), and each intermediate makes a round trip through device memory.
:class:`ExperimentalResNetInt8Engine` fills the dispatch tables the product
engine leaves empty, so ``_bottleneck`` hands whole pieces of a block to one
kernel each and ``_plan`` whole runs of blocks:

* ``use_qproj`` — a projection block's conv3 + downsample + relu + requant
  as K4 (``ops/qproj.py``), on the stages in ``qproj_stages``; the
  downsample's f32 output never reaches device memory and its stride is
  read in the kernel;
* ``use_qtail`` — an identity block's conv2 → requant → conv3 + residual
  → relu → requant as K5 (``ops/qtail.py``); conv1 stays on K1, and no
  zero-point-padded copy of its output is made;
* ``use_qblock`` — a whole identity block as K6 (``ops/qblock.py``);
  ``use_qtail`` is ignored when it is set;
* ``use_qstage`` — each stage's run of identity blocks (``j ≥ 1``) as one
  launch of K7 (``ops/qstage.py``), on the stages in ``qstage_stages``;
  with ``qstage_proj`` stage 0's stride-1 projection block joins the run,
  the whole stage one launch of K8.  A stage whose consumer is the
  excluded fp32 fc is skipped (its output must leave in f32), as qtpu's.

:class:`ExperimentalMobileNetV2Int8Engine` with ``use_qivr`` runs each
maximal run of identity inverted residuals (an expand, stride 1, as many
channels out as in) as one launch of K9 (``ops/qivr.py``); at full width
that is 10 blocks in 5 runs.

The flags mean what qtpu's do, and the eligibility rules are qtpu's: an
identity block (no downsample, stride 1) for K5/K6, a projection block for
K4, a run of at least two blocks for K7/K8, affine grids only, a 3×3 conv2,
and a next grid that is present and affine.  K4-K6 add their own: channel
counts in multiples of 16 (their 16-byte loads) and a conv2 tile that fits
in shared memory; the chained kernels take any channel count.  Every kernel
takes the same folded coefficients as the unfused calls it replaces
(``fused_ops``), built here once, so with any flags the codes are those of
the product engine.

Left out on purpose: qtpu's TPU-only ``*_interpret`` arguments and its
``pair`` with the ``W % pair`` guard — pairing block-diagonalises weights
for the TPU's 128-lane layout and adds only zero products, and at
ResNet-50's full width every block qtpu fuses is fused here too;
``use_pallas``, ``min_ci_pallas`` and ``dw_shifted`` (the port always runs
its kernels).  ``packed_int4`` passes to the base class, as qtpu's: the
unfused 1×1 GEMMs of int4 nodes run on K1's int4 entry, while K4-K9 take
the unpacked int8 weights.  qtpu has no CLI flag for these engines and
neither has the port: serve one with
``ServingEngine(None, tree, forward_factory=lambda sv:
ExperimentalResNetInt8Engine(sv, arch, ...).eager_forward, ...)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from qtpu_torch.ops.qtail import SMEM_LIMIT, tail_smem_bytes
from qtpu_torch.serve import fused_ops as fo
from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
from qtpu_torch.serve.resnet_engine import ResNetInt8Engine


def _affine(*grids) -> bool:
    return all(g is not None and not fo.grid_parts(g)[2] for g in grids)


class ExperimentalResNetInt8Engine(ResNetInt8Engine):
    """ResNetInt8Engine with the fused bottleneck kernels and the chained
    stage kernels (module doc).  With every flag off it is the product
    engine: the tables stay empty.  A block table maps an eligible block to
    its folded coefficients, built here once (the nodes' epilogue memo hands
    the same objects to the forward), or to None when its next grid is not
    affine (the dispatch guard then keeps the block on the unfused path, as
    qtpu's does); ``_qstage_prep`` maps a stage to its chained run:
    ``nrun`` identity blocks, the grid ``tgt`` after them, the stacked
    operands ``run`` and, for a whole stage, ``proj``."""

    def __init__(self, variables: Dict[str, Any], arch: Dict[str, Any],
                 device=None, normalize=None, packed_int4: bool = False,
                 use_qblock: Optional[bool] = None,
                 use_qtail: Optional[bool] = None,
                 use_qproj: Optional[bool] = None,
                 qproj_stages: Optional[Tuple[int, ...]] = None,
                 use_qstage: Optional[bool] = None,
                 qstage_stages: Optional[Tuple[int, ...]] = None,
                 qstage_proj: bool = False):
        super().__init__(variables, arch, device=device, normalize=normalize,
                         packed_int4=packed_int4)
        bottleneck = self.arch.get("bottleneck", True)
        self.use_qblock = bool(use_qblock) and bottleneck
        self.use_qtail = bool(use_qtail) and bottleneck and not self.use_qblock
        self.use_qproj = bool(use_qproj) and bottleneck
        self.qproj_stages = ((0, 1, 2, 3) if qproj_stages is None
                             else tuple(qproj_stages))
        self.use_qstage = bool(use_qstage) and bottleneck
        self.qstage_stages = ((0, 1, 2, 3) if qstage_stages is None
                              else tuple(qstage_stages))
        self.qstage_proj = bool(qstage_proj)
        if self.use_qtail:
            self._prepare_qtails()
        if self.use_qproj:
            self._prepare_qprojs()
        if self.use_qblock:
            self._prepare_qblocks()
        if self.use_qstage:
            self._prepare_qstages()

    # -- eligibility ---------------------------------------------------------

    def _grids(self, name: str):
        """(input grid, next grid) the forward gives block ``name``: its
        conv1's grid, and the next block's conv1's (the fc's after the last;
        None when the fc is excluded)."""
        names = [n for n, _, _ in self._block_names()]
        idx = names.index(name)
        nxt = (self._node(names[idx + 1], "conv1") if idx + 1 < len(names)
               else self._node("fc"))
        return (fo.grid_of(self._node(name, "conv1")),
                None if nxt is None else fo.grid_of(nxt))

    def _identity_nodes(self, name: str, j: int, need_conv1: bool):
        """(c1, c2, c3) of an identity block the tail kernels take, else
        None."""
        if j == 0 or self._node(name, "down") is not None:
            return None     # projection / strided block: unfused path
        nodes = tuple(self._node(name, k) for k in ("conv1", "conv2",
                                                    "conv3"))
        if any(n is None for n in nodes):
            return None
        c1, c2, c3 = nodes
        if any(fo.grid_of(n).sym for n in (nodes if need_conv1
                                           else (c2, c3))):
            return None     # the tail requants onto affine grids only
        cmid = c2["w_nk"].shape[0]
        if (c2["kernel_hw"] != (3, 3) or c2["w_nk"].shape[1] != 9 * cmid
                or c3["w_nk"].shape[1] != cmid or cmid % 16):
            return None
        cout = c3["w_nk"].shape[0]
        if tail_smem_bytes(cmid, cout, block=need_conv1) > SMEM_LIMIT:
            return None
        if need_conv1:
            cin = c1["w_nk"].shape[1]
            if c1["w_nk"].shape[0] != cmid or c3["w_nk"].shape[0] != cin \
                    or cin % 16:
                return None
        return nodes

    def _prepare_qtails(self) -> None:
        """Identity blocks for K5; their coefficients folded once."""
        for name, _, j in self._block_names():
            nodes = self._identity_nodes(name, j, need_conv1=False)
            if nodes is None:
                continue
            x_grid, nxt = self._grids(name)
            self._qtail_prep[name] = (
                fo.tail_coeffs(nodes[1], nodes[2], x_grid, nxt)
                if _affine(x_grid, nxt) else None)

    def _prepare_qblocks(self) -> None:
        """Identity blocks for K6; their coefficients folded once."""
        for name, _, j in self._block_names():
            nodes = self._identity_nodes(name, j, need_conv1=True)
            if nodes is None:
                continue
            x_grid, nxt = self._grids(name)
            self._qblock_prep[name] = (
                fo.block_coeffs(*nodes, x_grid, nxt)
                if _affine(nxt) else None)

    def _prepare_qprojs(self) -> None:
        """Projection blocks of ``qproj_stages`` for K4; their coefficients
        folded once."""
        for name, i, j in self._block_names():
            if j != 0 or i not in self.qproj_stages:
                continue
            c3, down = self._node(name, "conv3"), self._node(name, "down")
            if c3 is None or down is None:
                continue
            if fo.grid_of(c3).sym or fo.grid_of(down).sym:
                continue    # K4 requants onto affine grids only
            if c3["w_nk"].shape[1] % 16 or down["w_nk"].shape[1] % 16:
                continue
            _, nxt = self._grids(name)
            self._qproj_prep[name] = (fo.proj_coeffs(c3, down, nxt)
                                      if _affine(nxt) else None)

    def _prepare_qstages(self) -> None:
        """Stage i chains when it has at least two blocks, every identity
        block (j ≥ 1) is a frozen 3×3 bottleneck on affine grids, and the
        grid after the run (the next stage's conv1, the fc's after the last)
        is present and affine — qtpu's rule; its operands stacked once."""
        sizes = self.arch["stage_sizes"]
        for i, n in enumerate(sizes):
            if n < 2 or i not in self.qstage_stages:
                continue
            tgt_node = (self._node(f"layer{i + 2}_0", "conv1")
                        if i + 1 < len(sizes) else self._node("fc"))
            if tgt_node is None:
                print(f"qstage: stage {i} skipped (consumer excluded -> "
                      "fp32 out)", flush=True)
                continue
            tgt = fo.grid_of(tgt_node)
            if tgt.sym:
                continue
            blocks = []
            for j in range(1, n):
                name = f"layer{i + 1}_{j}"
                cs = tuple(self._node(name, k) for k in ("conv1", "conv2",
                                                         "conv3"))
                if (any(c is None for c in cs)
                        or self._node(name, "down") is not None
                        or any(fo.grid_of(c).sym for c in cs)):
                    break
                blocks.append(cs)
            if len(blocks) != n - 1 or any(
                    c2["kernel_hw"] != (3, 3) for _, c2, _ in blocks):
                continue
            proj = self._qstage_proj_nodes(i) if self.qstage_proj else None
            self._qstage_prep[i] = dict(
                nrun=n - 1, tgt=tgt, run=fo.chain_operands(blocks, tgt),
                proj=None if proj is None else fo.proj_operands(
                    *proj, blocks[0][0]["grid"]))

    def _qstage_proj_nodes(self, i: int):
        """Stage ``i``'s projection block (c1, c2, c3, down) when it can
        join the run: stage 0 only (the later ones downsample), all four
        convs present on affine grids, a 3×3 conv2; else None."""
        if i != 0:
            return None
        cs = tuple(self._node(f"layer{i + 1}_0", k)
                   for k in ("conv1", "conv2", "conv3", "down"))
        if any(c is None for c in cs) or any(fo.grid_of(c).sym for c in cs):
            return None
        return cs if cs[1]["kernel_hw"] == (3, 3) else None

    # -- the fused pieces ----------------------------------------------------

    def _qstage(self, x_q: torch.Tensor, stage: int):
        """A stage's chained run (K7), or the whole stage (K8) → (codes,
        the grid after the run)."""
        run = self._qstage_prep[stage]
        if run["proj"] is not None:
            return fo.proj_stage(x_q, run["proj"], run["run"]), run["tgt"]
        return fo.stage(x_q, run["run"]), run["tgt"]

    def _qblock(self, x_q: torch.Tensor, x_grid, name: str, next_grid
                ) -> torch.Tensor:
        c1, c2, c3 = (self._node(name, k) for k in ("conv1", "conv2",
                                                     "conv3"))
        return fo.bottleneck(x_q, c1, c2, c3, x_grid=x_grid,
                             requant=next_grid)

    def _qtail(self, x_q: torch.Tensor, x_grid, name: str, next_grid
               ) -> torch.Tensor:
        c1, c2, c3 = (self._node(name, k) for k in ("conv1", "conv2",
                                                     "conv3"))
        a = fo.gemm_1x1(x_q, c1, relu=True, requant=fo.grid_of(c2),
                        out_dtype=torch.int8)
        return fo.tail(a, x_q, c2, c3, x_grid=x_grid, requant=next_grid)

    def _qproj(self, b: torch.Tensor, x_q: torch.Tensor, name: str, strides,
               next_grid) -> torch.Tensor:
        return fo.proj(b, x_q, self._node(name, "conv3"),
                       self._node(name, "down"), strides=strides,
                       requant=next_grid)


class ExperimentalMobileNetV2Int8Engine(MobileNetV2Int8Engine):
    """MobileNetV2Int8Engine with the chained inverted-residual kernel K9
    (module doc).  ``_qivr_prep`` maps a run's first block index to its
    length ``nrun``, the grid ``tgt`` after it and its stacked operands
    ``run``; with ``use_qivr`` off it stays empty (the product engine)."""

    def __init__(self, variables: Dict[str, Any], num_classes: int,
                 torch_pad: bool = False, device=None, normalize=None,
                 use_qivr: bool = False):
        super().__init__(variables, num_classes, torch_pad=torch_pad,
                         device=device, normalize=normalize)
        self.use_qivr = bool(use_qivr)
        if self.use_qivr:
            self._prepare_qivr()

    def _chainable(self, j: int):
        """(expand, dw, project) of block ``j`` when it is an identity
        inverted residual on affine grids, else None (qtpu's rule)."""
        name, _, stride = self._blocks()[j]
        nodes = tuple(self._node(name, k) for k in ("expand", "dw",
                                                    "project"))
        if any(n is None for n in nodes) or stride != 1:
            return None
        if (nodes[0]["w_nk"].shape[1] != nodes[2]["w_nk"].shape[0]
                or any(fo.grid_of(n).sym for n in nodes)):
            return None
        return nodes

    def _prepare_qivr(self) -> None:
        """Each maximal run of chainable blocks whose consumer (the next
        block's input grid, or the head's) is affine; operands stacked
        once."""
        blocks = self._blocks()
        i = 0
        while i < len(blocks):
            run, j = [], i
            while j < len(blocks):
                nodes = self._chainable(j)
                if nodes is None:
                    break
                run.append(nodes)
                j += 1
            if not run:
                i += 1
                continue
            tgt = self._next_grid(j - 1)
            if not tgt.sym:
                self._qivr_prep[i] = dict(nrun=len(run), tgt=tgt,
                                          run=fo.ivr_operands(run, tgt))
            i = j

    def _qivr(self, x_q: torch.Tensor, i: int) -> torch.Tensor:
        return fo.ivr(x_q, self._qivr_prep[i]["run"])
