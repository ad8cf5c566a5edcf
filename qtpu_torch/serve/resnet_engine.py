"""Flat int8 ResNet inference engine (port of qtpu/serve/resnet_engine.py).

Runs ResNet-18/50-style nets from a frozen tree (``qweights`` plus the fp32
``params``/``batch_stats`` of excluded layers) as an int8-resident
pipeline:

* every 1×1 conv and the int8 fc run on K1, every K×K conv on K2, with the
  dequant → (residual) → relu → requant chain folded into the kernels'
  epilogues — activations stay int8 codes between layers, each on its
  consumer's calibrated grid;
* a block input's codes, quantized once on the reduce conv's grid, are
  reused by the downsample branch;
* max-pool commutes with the monotonic quantizer, so the stem max-pool runs
  on int8 codes (padding −128);
* an excluded stem runs in fp32 (BN folded at build, TF32 off), an excluded
  fc as a plain fp32 matmul.

At build the engine prepares every quantized node (device placement, the
kernels' weight layout, grids read into Python numbers), so a forward
issues kernels only and never waits on the device for a scalar.  On the
CPU (``device="cpu"``) the same code runs the kernels' plain versions.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from qtpu_torch.ops import qops
from qtpu_torch.serve.fused_ops import (Grid, conv as _fused_conv,
                                        dequant as _fused_dequant,
                                        fc_fp32_params as _fc_fp32_params,
                                        fold_bn_fp32 as _fold_bn_fp32,
                                        gemm_1x1 as _fused_gemm,
                                        grid_of as _grid_of,
                                        grid_parts as _grid_parts,
                                        prepare_node,
                                        u8_normalize_coeffs as _u8_coeffs)
from qtpu_torch.utils.device import fp32_exact, resolve_device

BN_EPS = 1e-5


def _is_node(v) -> bool:
    return isinstance(v, dict) and "kernel_q" in v


def _prepare_tree(tree: Dict[str, Any], device: torch.device) -> Dict:
    return {k: (prepare_node(v, device) if _is_node(v)
                else _prepare_tree(v, device)) for k, v in tree.items()}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


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


class ResNetInt8Engine:
    """Flat int8 inference over a frozen ResNet tree.

    ``arch``: dict(stage_sizes, width, bottleneck, cifar_stem, num_classes
    [, torch_pad]).  ``torch_pad=True`` runs the torchvision geometry:
    explicit symmetric pads on the 7×7 stem, the 3×3/2 max-pool and the
    strided 3×3 convs, where SAME pads (0, 1).
    ``device``: ``None`` means the card (raises without one); pass
    ``"cpu"`` for the plain path.
    """

    def __init__(self, variables: Dict[str, Any], arch: Dict[str, Any],
                 device=None, normalize=None):
        self.device = resolve_device(device)
        self.qw = _prepare_tree(variables["qweights"], self.device)
        self.params = _to_device(variables.get("params", {}), self.device)
        self.batch_stats = _to_device(variables.get("batch_stats", {}),
                                      self.device)
        self.arch = dict(arch)
        self.torch_pad = bool(self.arch.get("torch_pad", False))
        self._pad3 = ((1, 1), (1, 1)) if self.torch_pad else "SAME"
        self._stem_fp32 = None
        if self._node("stem") is None:
            w, b = _fold_bn_fp32(self.params, self.batch_stats, "stem",
                                 BN_EPS)
            # OIHW for F.conv2d, bias added after as in the reference
            self._stem_fp32 = (w.permute(3, 2, 0, 1).contiguous(), b)
        self._fc_fp32 = (_fc_fp32_params(self.params)
                         if self._node("fc") is None else None)
        norm = normalize or ((0.0,), (1.0,))
        self._u8_norm = _u8_coeffs(*norm, max(len(norm[0]), len(norm[1])),
                                   device=self.device)

    def stem_grid(self) -> Grid:
        """The grid host-side int8 ingest must quantize onto."""
        node = self._node("stem")
        if node is None:
            raise ValueError("excluded (fp32) stem has no ingest grid — "
                             "feed fp32 images via forward()")
        return _grid_of(node)

    # -- entry points ------------------------------------------------------

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """f32 NHWC images → logits (B, num_classes) on the engine's device."""
        return self._forward(self._input(x, torch.float32))

    @torch.inference_mode()
    def forward_codes(self, x_q: torch.Tensor) -> torch.Tensor:
        """int8 codes already on the stem's grid → logits."""
        return self._forward(self._input(x_q, torch.int8),
                             pre_quantized=True)

    @torch.inference_mode()
    def forward_u8(self, x8: torch.Tensor) -> torch.Tensor:
        """raw 0-255 uint8 pixels, normalized on the device → logits."""
        return self._forward(self._input(x8, torch.uint8), raw_u8=True)

    def _input(self, x, dtype) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.dtype != dtype:
            raise ValueError(f"expected {dtype} input, got {x.dtype}")
        return x.to(self.device, non_blocking=True).contiguous()

    # -- frozen-node helpers -----------------------------------------------

    def _node(self, *path: str) -> Optional[Dict[str, Any]]:
        node = self.qw
        for p in path:
            if p not in node:
                return None
            node = node[p]
        return node

    def _block_names(self):
        out = []
        for i, n in enumerate(self.arch["stage_sizes"]):
            for j in range(n):
                out.append((f"layer{i + 1}_{j}", i, j))
        return out

    # -- fused layer primitives ---------------------------------------------

    def _gemm(self, x_q, node, *, relu: bool, requant, out_dtype,
              residual=None, res_grid=None) -> torch.Tensor:
        return _fused_gemm(x_q, node, relu=relu, requant=requant,
                           out_dtype=out_dtype, residual=residual,
                           res_grid=res_grid)

    def _conv_xla(self, x_q, node, *, strides, relu: bool, requant,
                  padding="SAME") -> torch.Tensor:
        return _fused_conv(x_q, node, strides=strides, relu=relu,
                           requant=requant, padding=padding)

    @staticmethod
    def _dequant(x_q, grid) -> torch.Tensor:
        return _fused_dequant(x_q, grid)

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
            w, b = self._stem_fp32
            pads = qops.resolve_pads(x.shape[1:3], w.shape[2:], strides,
                                     conv_pad)
            xp = qops.pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2)
            with fp32_exact():
                y = F.conv2d(xp, w, stride=strides)
            y = y.permute(0, 2, 3, 1) + b
            y = torch.clamp_min(y, 0.0)
            fs, fz, fsym = _grid_parts(first_grid)
            y_q = qops.quantize_act(y, fs, fz, symmetric=fsym)
        else:
            if pre_quantized:
                x_q = x
            else:
                g = _grid_of(node)
                x_q = qops.quantize_act(x, g.scale, g.zp, symmetric=g.sym)
            y_q = self._conv_xla(x_q, node, strides=strides, relu=True,
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
        a = self._gemm(x_q, c1, relu=True, requant=_grid_of(c2),
                       out_dtype=torch.int8)
        b = self._conv_xla(a, c2, strides=strides, relu=True,
                           requant=_grid_of(c3), padding=self._pad3)
        if down is not None:
            x_d = x_q[:, ::strides[0], ::strides[1], :]
            res = self._gemm(x_d, down, relu=False, requant=None,
                             out_dtype=torch.float32)
            res_grid = None          # f32 residual (projection blocks)
        else:
            res = x_q                # int8 codes reused: no extra traffic
            res_grid = x_grid
        # project 1x1 with residual add + relu + requant fused in the epilogue
        # (next_grid None — excluded fp32 fc — leaves the output in fp32)
        return self._gemm(b, c3, relu=True, requant=next_grid,
                          out_dtype=torch.int8 if next_grid is not None
                          else torch.float32,
                          residual=res, res_grid=res_grid)

    def _basic(self, x_q: torch.Tensor, x_grid, name: str, strides,
               next_grid) -> torch.Tensor:
        c1, c2 = (self._node(name, k) for k in ("conv1", "conv2"))
        down = self._node(name, "down")
        a = self._conv_xla(x_q, c1, strides=strides, relu=True,
                           requant=_grid_of(c2), padding=self._pad3)
        b = self._conv_xla(a, c2, strides=(1, 1), relu=False, requant=None,
                           padding=self._pad3)
        if down is not None:
            r = self._gemm(x_q[:, ::strides[0], ::strides[1], :], down,
                           relu=False, requant=None, out_dtype=torch.float32)
        else:
            r = self._dequant(x_q, x_grid)
        y = torch.clamp_min(b + r, 0.0)
        if next_grid is None:        # excluded fp32 fc consumes fp32
            return y
        ns, nz, nsym = _grid_parts(next_grid)
        return qops.quantize_act(y, ns, nz, symmetric=nsym)

    def _forward(self, x: torch.Tensor, pre_quantized: bool = False,
                 raw_u8: bool = False) -> torch.Tensor:
        bottleneck = self.arch.get("bottleneck", True)
        names = self._block_names()
        first = self._node(names[0][0], "conv1")
        fc = self._node("fc")
        if raw_u8:
            a, b = self._u8_norm
            x = x.to(torch.float32) * a + b
        x_q = self._stem(x, _grid_of(first), pre_quantized=pre_quantized)
        grid = _grid_of(first)
        step = self._bottleneck if bottleneck else self._basic
        for idx, (name, i, j) in enumerate(names):
            strides = (2, 2) if (i > 0 and j == 0) else (1, 1)
            if idx + 1 < len(names):
                nxt = _grid_of(self._node(names[idx + 1][0], "conv1"))
            else:
                nxt = _grid_of(fc) if fc is not None else None
            x_q = step(x_q, grid, name, strides, nxt)
            grid = nxt
        if fc is None:
            pooled = torch.mean(x_q, dim=(1, 2))   # fp32 from final block
            w, b = self._fc_fp32
            with fp32_exact():
                return pooled @ w + b
        pooled = torch.mean(self._dequant(x_q, grid), dim=(1, 2))
        g = _grid_of(fc)
        x_fc_q = qops.quantize_act(pooled, g.scale, g.zp, symmetric=g.sym)
        B = x_fc_q.shape[0]
        acc = _fused_gemm(x_fc_q.reshape(B, 1, 1, -1), fc,
                          raw_acc=True).reshape(B, -1)
        return qops.dequant_epilogue(
            acc, act_scale=g.scale, act_zp=g.zp, w_scale=fc["w_scale"],
            colsum=fc["colsum"], bias=fc["bias"])
