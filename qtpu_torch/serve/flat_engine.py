"""The frame the flat int8 engines share (ResNet, MobileNet-v1/v2).

At build an engine prepares every quantized node of the frozen tree
(device placement, the kernels' weight layouts, grids read into Python
numbers), folds the BatchNorm of an excluded fp32 stem into its conv and
keeps an excluded fp32 fc, so a forward issues kernels only and never waits
on the device for a scalar.  The entry points are qtpu's:

* ``forward(x)`` — f32 NHWC images → logits;
* ``forward_codes(x_q)`` — int8 codes already on the stem's grid (host
  int8 ingest);
* ``forward_u8(x8)`` — raw 0-255 uint8 pixels, normalized on the device.

qtpu jits each of them (``self.forward = jax.jit(self._forward)``), so a
call is one compiled program per input shape.  Here, on a card, each entry
keeps one CUDA graph per input shape (``serve/graphs.py``): the first call
of an (entry, shape) warms the body up twice on a side stream, captures
it and replays it, every later call copies its input into the graph's
static input and replays; the result is a new tensor, the static output
copied on the card in stream order (a caller keeps what an earlier call
returned).  An engine's graphs share one memory pool (``serve.graphs.
GraphPool``), so a new input shape adds its static tensors, not a copy of
the forward's intermediates, and their calls run one at a time.  The graph
table and the captures are under a lock.  What a call does is
:func:`entry_plan`'s: the eager body on the CPU, for a tree sliced by
``shard_variables`` (its all-gathers go through the host under gloo, which
a graph cannot hold) and when the current stream is already capturing (an
outer graph records the kernels themselves: ``ServingEngine``'s buckets,
``bench.timing``'s timers).  A call that cannot be captured raises
``GraphCaptureError`` naming the entry and the shape; nothing falls back
to eager.  ``eager_forward``, ``eager_forward_codes`` and
``eager_forward_u8`` are the eager bodies themselves: ``ServingEngine``
serves them (it compiles per bucket), and traces with the per-layer scopes
and eager timings call them.

``torch_pad=True`` runs torchvision's geometry: explicit (1, 1) pads on
the strided 3×3 convs, where SAME pads (0, 1).  ``stem_dtype=torch.bfloat16``
runs an excluded stem's conv on bf16 inputs and weights with f32
accumulation, as qtpu's ``preferred_element_type=float32`` conv: both are
rounded to bf16 and back, and the conv runs in full f32 (every product of
two bf16 values is exact in f32), so the output is not rounded to bf16.
``device``: ``None`` means
the card (raises without one); pass ``"cpu"`` for the plain path, where
the same code runs the kernels' plain versions.  ``packed_int4``: the 1×1
int4 nodes keep their weights nibble-packed for K1's int4 entry
(:func:`qtpu_torch.serve.fused_ops.prepare_node`).
A tree sliced by ``parallel.mesh.shard_variables`` runs tensor parallel
(``serve/fused_ops.py``); the fp32 stem and fc are replicated, as qtpu's
rules replicate ``params``.
Subclasses implement ``_forward(x, pre_quantized, raw_u8)``.
"""
from __future__ import annotations

import threading
from typing import Any, Collection, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from qtpu_torch.nn.layers import pad3
from qtpu_torch.ops import qops
from qtpu_torch.parallel.mesh import sharded_nodes
from qtpu_torch.serve.fused_ops import (Grid, fc_fp32_params, fold_bn_fp32,
                                        gemm_1x1, grid_of, prepare_tree,
                                        tp_gather, tree_to_device,
                                        u8_normalize_coeffs)
from qtpu_torch.serve.graphs import ForwardGraph, GraphPool, capture_forward
from qtpu_torch.utils.device import fp32_exact, resolve_device

BN_EPS = 1e-5

# each entry point: the dtype of its input, ``_forward``'s keywords
ENTRIES = {"forward": (torch.float32, {}),
           "forward_codes": (torch.int8, {"pre_quantized": True}),
           "forward_u8": (torch.uint8, {"raw_u8": True})}


def entry_plan(device_type: str, sharded: bool, capturing: bool,
               captured: bool) -> str:
    """What a call of an entry point does: ``"eager"`` (the body, launched
    from Python) on the CPU, for a tensor-parallel tree or inside an outer
    capture; else ``"capture"`` at the first call of its (entry, input
    shape) — the graph is then replayed — and ``"replay"`` at every later
    one."""
    if device_type != "cuda" or sharded or capturing:
        return "eager"
    return "replay" if captured else "capture"


def _checked(x, dtype) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dtype != dtype:
        raise ValueError(f"expected {dtype} input, got {x.dtype}")
    return x


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class FlatInt8Engine:
    """Flat int8 inference over a frozen tree (``qweights`` plus the fp32
    ``params``/``batch_stats`` of excluded layers)."""

    # keys of the frozen tree whose nodes are depthwise convs (K3 layout)
    depthwise_keys: Collection[str] = ()

    def __init__(self, variables: Dict[str, Any], torch_pad: bool = False,
                 device=None, normalize=None, packed_int4: bool = False,
                 stem_dtype: Optional[torch.dtype] = None):
        if stem_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"stem_dtype {stem_dtype}: float32 or bfloat16")
        self.device = resolve_device(device)
        self.stem_dtype = stem_dtype
        self.torch_pad = bool(torch_pad)
        self._pad3 = pad3(self.torch_pad)
        self.packed_int4 = bool(packed_int4)
        self.qw = prepare_tree(variables["qweights"], self.device,
                               self.depthwise_keys, self.packed_int4)
        self.params = tree_to_device(variables.get("params", {}),
                                     self.device)
        self.batch_stats = tree_to_device(variables.get("batch_stats", {}),
                                          self.device)
        self._stem_fp32 = None
        if self._node("stem") is None:
            w, b = fold_bn_fp32(self.params, self.batch_stats, "stem",
                                BN_EPS)
            # OIHW for F.conv2d, bias added after as in the reference
            self._stem_fp32 = (w.permute(3, 2, 0, 1).contiguous(), b)
        self._fc_fp32 = (fc_fp32_params(self.params)
                         if self._node("fc") is None else None)
        norm = normalize or ((0.0,), (1.0,))
        self._u8_norm = u8_normalize_coeffs(
            *norm, max(len(norm[0]), len(norm[1])), device=self.device)
        # the compiled entries (module docstring): (entry, shape) → graph
        self._sharded = sharded_nodes(variables["qweights"]) > 0
        self._graphs: Dict[Tuple[str, tuple], ForwardGraph] = {}
        self._pool: Optional[GraphPool] = None    # made at the first capture
        self._graph_lock = threading.Lock()

    def stem_grid(self) -> Grid:
        """The grid host-side int8 ingest must quantize onto."""
        node = self._node("stem")
        if node is None:
            raise ValueError("excluded (fp32) stem has no ingest grid — "
                             "feed fp32 images via forward()")
        return grid_of(node)

    # -- entry points ------------------------------------------------------

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """f32 NHWC images → logits (B, num_classes) on the engine's device;
        on a card one CUDA graph per input shape."""
        return self._call("forward", x)

    @torch.inference_mode()
    def forward_codes(self, x_q: torch.Tensor) -> torch.Tensor:
        """int8 codes already on the stem's grid → logits."""
        return self._call("forward_codes", x_q)

    @torch.inference_mode()
    def forward_u8(self, x8: torch.Tensor) -> torch.Tensor:
        """raw 0-255 uint8 pixels, normalized on the device → logits."""
        return self._call("forward_u8", x8)

    @torch.inference_mode()
    def eager_forward(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward`'s body, launched from Python (no graph)."""
        return self._eager("forward", x)

    @torch.inference_mode()
    def eager_forward_codes(self, x_q: torch.Tensor) -> torch.Tensor:
        """:meth:`forward_codes`'s body, launched from Python."""
        return self._eager("forward_codes", x_q)

    @torch.inference_mode()
    def eager_forward_u8(self, x8: torch.Tensor) -> torch.Tensor:
        """:meth:`forward_u8`'s body, launched from Python."""
        return self._eager("forward_u8", x8)

    def free_graphs(self) -> None:
        """Give back the graphs' memory (their pool); the next call of a
        shape captures its graph again."""
        with self._graph_lock:
            self._graphs.clear()
            self._pool = None

    @property
    def graphs(self) -> Dict[Tuple[str, tuple], ForwardGraph]:
        """The captured graphs by (entry, input shape)."""
        with self._graph_lock:
            return dict(self._graphs)

    def _call(self, entry: str, x) -> torch.Tensor:
        dtype, kw = ENTRIES[entry]
        x = _checked(x, dtype)
        key = (entry, tuple(x.shape))
        with self._graph_lock:
            g = self._graphs.get(key)
            plan = entry_plan(self.device.type, self._sharded,
                              _capturing(self.device), g is not None)
            if plan == "capture":
                self._pool = self._pool or GraphPool()
                g = self._graphs[key] = capture_forward(
                    lambda xs: self._forward(xs, **kw), x, self.device,
                    f"{type(self).__name__}.{entry} at input "
                    f"{tuple(x.shape)} {dtype}", self._pool, entry)
            if plan != "eager":
                return g.call(x)
        return self._forward(self._input(x, dtype), **kw)

    def _eager(self, entry: str, x) -> torch.Tensor:
        dtype, kw = ENTRIES[entry]
        return self._forward(self._input(x, dtype), **kw)

    def _input(self, x, dtype) -> torch.Tensor:
        return _checked(x, dtype).to(self.device,
                                     non_blocking=True).contiguous()

    def _forward(self, x: torch.Tensor, pre_quantized: bool = False,
                 raw_u8: bool = False) -> torch.Tensor:
        raise NotImplementedError

    # -- shared pieces -------------------------------------------------------

    def _node(self, *path: str) -> Optional[Dict[str, Any]]:
        node = self.qw
        for p in path:
            if p not in node:
                return None
            node = node[p]
        return node

    def _normalize_u8(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self._u8_norm
        return x.to(torch.float32) * a + b

    def _stem_conv_fp32(self, x: torch.Tensor, strides, padding
                        ) -> torch.Tensor:
        """The excluded stem's conv (BN folded at build) in full fp32 — no
        TF32 — on NHWC ``x``, bias added; NHWC out, before the activation.
        With the bf16 ``stem_dtype`` ``x`` and the folded weight are rounded
        to bf16 first."""
        w, b = self._stem_fp32
        pads = qops.resolve_pads(x.shape[1:3], w.shape[2:], strides, padding)
        xp = qops.pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2)
        if self.stem_dtype == torch.bfloat16:
            xp = xp.to(torch.bfloat16).to(torch.float32)
            w = w.to(torch.bfloat16).to(torch.float32)
        with fp32_exact():
            y = F.conv2d(xp, w, stride=strides)
        return y.permute(0, 2, 3, 1) + b

    def _fc(self, pooled: torch.Tensor) -> torch.Tensor:
        """Logits from the pooled f32 features: the excluded fc as an fp32
        matmul, or the int8 fc on K1 (``raw_acc``) and its exact
        ``dequant_epilogue``, gathered over the model group when the fc is
        sharded."""
        fc = self._node("fc")
        if fc is None:
            w, b = self._fc_fp32
            with fp32_exact():
                return pooled @ w + b
        g = grid_of(fc)
        x_fc_q = qops.quantize_act(pooled, g.scale, g.zp, symmetric=g.sym)
        B = x_fc_q.shape[0]
        acc = gemm_1x1(x_fc_q.reshape(B, 1, 1, -1), fc,
                       raw_acc=True).reshape(B, -1)
        return tp_gather(qops.dequant_epilogue(
            acc, act_scale=g.scale, act_zp=g.zp, w_scale=fc["w_scale"],
            colsum=fc["colsum"], bias=fc["bias"]), fc)
