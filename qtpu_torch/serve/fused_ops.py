"""Shared fused-layer primitives for the flat int8 engines (port of
qtpu/serve/fused_ops.py).

Each op consumes a frozen node (qtpu's leaf names: ``kernel_q``,
``w_scale``, ``colsum``, ``bias``, ``act_scale``, ``act_zp``, ``act_sym``)
and an int8 NHWC activation, optionally fusing ReLU (or relu6 through
``act_max``), an int8 or f32 residual, and requantization onto the
consumer's grid.  ``gemm_1x1`` runs on K1, ``conv`` (the ``conv_xla``
counterpart) on K2 and ``depthwise`` (``conv_xla(groups=C)``) on K3 for
CUDA tensors; on the CPU they take the kernels' plain versions.  The fused
bottleneck pieces of the experimental engine — ``proj`` (K4), ``tail``
(K5) and ``bottleneck`` (K6) — take the same coefficients as the unfused
calls they replace, so their codes are the same; so do the chained runs
of the experimental engines — ``stage`` (K7), ``proj_stage`` (K8) and
``ivr`` (K9) — whose operands (``chain_operands``, ``proj_operands``,
``ivr_operands``) stack those coefficients once, at engine build.

Engines call :func:`prepare_tree` once at build: it places the leaves on
the device, stores each weight in its kernel's layout (``w_nk`` (N, K) for
K1/K2, ``w_taps`` (KH·KW, C) for a depthwise node, and with
``packed_int4`` also ``w_nk4`` (N, K/2) for a 1×1 int4 node, which
``gemm_1x1`` then runs on K1's int4 entry) and reads the activation grid
into Python numbers, so the forward never waits on the device for a
scalar.  The folded epilogue coefficients of each call site are computed at
its first call and kept in the prepared node.

Tensor parallelism: a node that ``parallel.mesh.shard_variables`` sliced
(tagged ``_tp``) runs this rank's output channels on K1, K2 or K3 and
gathers the channels over the ``model`` group (:func:`tp_gather`) unless
the caller asks for its slice (``gather=False``: a depthwise or a
residual consumer sharded alike, :func:`same_shard`); a depthwise node
takes only its own input channels.  The codes are those of the unsharded
node.
"""
from __future__ import annotations

from typing import Any, Collection, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops import qops
from qtpu_torch.ops.qconv import qconv2d_folded, tapsum_of
from qtpu_torch.ops.qdepthwise import qdepthwise_folded
from qtpu_torch.ops.qblock import qblock_folded
from qtpu_torch.ops.qivr import qivr_folded
from qtpu_torch.ops.qmatmul import (pack_int4_nk, qmatmul_folded,
                                    qmatmul_folded_w4)
from qtpu_torch.ops.qops import EpilogueCoeffs
from qtpu_torch.ops.qproj import qproj_folded
from qtpu_torch.ops.qstage import (ChainCoeffs, qstage_folded,
                                   qstage_proj_folded, stack_chain)
from qtpu_torch.ops.qtail import qtail_folded

Node = Dict[str, object]


class Grid(NamedTuple):
    """An activation grid: float32 scale and signed int zero point as Python
    numbers, and the static symmetric/affine kind."""
    scale: float
    zp: int
    sym: bool = False


def _item(v) -> float:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").reshape(()).item()
    return np.asarray(v).reshape(()).item()


def grid_of(node: Node) -> Grid:
    """(scale, zp, symmetric) grid of a frozen node, read once."""
    g = node.get("grid")
    if g is not None:
        return g
    sym = node.get("act_sym")
    return Grid(float(np.float32(_item(node["act_scale"]))),
                int(_item(node["act_zp"])),
                bool(_item(sym)) if sym is not None else False)


def grid_parts(grid):
    """(scale, zp, symmetric) of a grid; (None, None, False) for none."""
    return (None, None, False) if grid is None else tuple(grid)


def unpacked_kernel(node: Node) -> torch.Tensor:
    """int8 weights of a frozen node, unpacking int4 nibbles if needed."""
    w = node["kernel_q"]
    if w.shape[-1] != node["colsum"].shape[0]:
        w = fq.unpack_int4(w, axis=-1)
    return w


def is_int4(node: Node) -> bool:
    """Whether a frozen node holds nibble-packed int4 weights."""
    return node["kernel_q"].shape[-1] != node["colsum"].shape[0]


def dequant(x_q: torch.Tensor, grid) -> torch.Tensor:
    s, zp, _ = grid_parts(grid)
    return (x_q.to(torch.float32) - float(zp)) * s


def fold_bn_fp32(params: Dict, batch_stats: Dict, name: str,
                 bn_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-time BN fold of an EXCLUDED ConvBN's fp32 params → (W HWIO, b),
    the same fold freeze applies to quantized ConvBNs."""
    p = (params or {}).get(name)
    if p is None or "kernel" not in p:
        raise ValueError(f"layer {name} neither quantized nor in params")
    w = p["kernel"].to(torch.float32)
    bn = (batch_stats or {}).get(name)
    if bn is not None and "mean" in bn:
        gamma = p["scale"].to(torch.float32)
        sigma = torch.sqrt(bn["var"].to(torch.float32) + bn_eps)
        b = p["bias"].to(torch.float32) - gamma * bn["mean"].to(
            torch.float32) / sigma
        w = w * (gamma / sigma)
    else:
        b = p.get("bias")
        b = (torch.zeros(w.shape[-1], device=w.device) if b is None
             else b.to(torch.float32))
    return w, b


def fc_fp32_params(params: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel (in, out), bias) of an EXCLUDED fp32 fc layer."""
    p = (params or {}).get("fc")
    if p is None or "kernel" not in p:
        raise ValueError("fc neither quantized nor present in params")
    k = p["kernel"].to(torch.float32)
    b = p.get("bias")
    b = (torch.zeros(k.shape[-1], device=k.device) if b is None
         else b.to(torch.float32))
    return k, b


def u8_normalize_coeffs(mean, std, channels: int,
                        device: Optional[torch.device] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (a, b) with ``(x_u8/255 - mean)/std == x_u8*a + b``."""
    mean = np.broadcast_to(np.asarray(mean, np.float32), (channels,))
    std = np.broadcast_to(np.asarray(std, np.float32), (channels,))
    a = (1.0 / (255.0 * std)).astype(np.float32)
    b = (-mean / std).astype(np.float32)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def prepare_node(node: Node, device: torch.device,
                 depthwise: bool = False, packed_int4: bool = False) -> Node:
    """A serving copy of a frozen node on ``device``: the leaves, the weight
    in its kernel's layout (``w_nk``: (N, K) with K = KH·KW·Ci for a conv,
    and for a K×K conv ``tapsum`` (KH·KW, N), its taps' weights summed over
    Ci, K2's pad correction; ``w_taps``: (KH·KW, C) for a ``depthwise``
    (KH, KW, 1, C) node), its spatial size, the grid as Python numbers and
    an epilogue memo.  With ``packed_int4`` a 1×1 int4 node (even K) also
    keeps ``w_nk4``, its weight packed for K1's int4 entry; ``w_nk`` stays
    for the kernels that take int8 weights."""
    out = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
           for k, v in node.items() if not k.startswith("_")}
    w = unpacked_kernel(out)
    if depthwise:
        if w.dim() != 4 or w.shape[2] != 1:
            raise ValueError(f"depthwise node weight {tuple(w.shape)} is not "
                             "(KH, KW, 1, C)")
        out["w_taps"] = w.reshape(-1, w.shape[-1]).contiguous()
    else:
        out["w_nk"] = w.reshape(-1, w.shape[-1]).t().contiguous()
    out["kernel_hw"] = tuple(w.shape[:2]) if w.dim() == 4 else (1, 1)
    if not depthwise and out["kernel_hw"] != (1, 1):
        out["tapsum"] = tapsum_of(out["w_nk"], out["kernel_hw"])
    if (packed_int4 and not depthwise and is_int4(out)
            and out["kernel_hw"] == (1, 1) and out["w_nk"].shape[1] % 2 == 0):
        out["w_nk4"] = pack_int4_nk(out["w_nk"])
    out["grid"] = grid_of(node)
    out["_epi"] = {}
    if "_tp" in node:
        out["_tp"] = node["_tp"]
    return out


def _is_node(v) -> bool:
    return isinstance(v, dict) and "kernel_q" in v


def prepare_tree(tree: Dict[str, Any], device: torch.device,
                 depthwise: Collection[str] = (),
                 packed_int4: bool = False) -> Dict[str, Any]:
    """Every frozen node of ``tree`` through :func:`prepare_node`; nodes
    stored under a key in ``depthwise`` take the depthwise layout."""
    return {k: (prepare_node(v, device, depthwise=k in depthwise,
                             packed_int4=packed_int4)
                if _is_node(v) else prepare_tree(v, device, depthwise,
                                                 packed_int4))
            for k, v in tree.items()}


def tree_to_device(tree, device: torch.device):
    """Every tensor of a nested dict moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _prepared(node: Node, device: torch.device,
              depthwise: bool = False) -> Node:
    return node if "_epi" in node else prepare_node(node, device, depthwise)


def _epilogue(node: Node, *, relu: bool, act_max: Optional[float],
              requant, res_kind: Optional[torch.dtype], res_grid):
    """Folded coefficients of one call site, memoized in the prepared node
    (keys are the static flags and grids, all Python values)."""
    rs, rz, rsym = grid_parts(requant)
    gs, gz, _ = (grid_parts(res_grid) if res_kind == torch.int8
                 else (None, None, False))
    key = (relu, act_max, rs, rz, rsym, res_kind, gs, gz)
    hit = node["_epi"].get(key)
    if hit is None:
        g = node["grid"]
        hit = node["_epi"][key] = qops.epilogue_coeffs(
            act_scale=g.scale, act_zp=g.zp, w_scale=node["w_scale"],
            colsum=node["colsum"], bias=node["bias"], requant_scale=rs,
            requant_zp=rz, requant_symmetric=rsym, relu=relu,
            act_max=act_max, res_scale=gs, res_zp=gz,
            res_f32=res_kind is not None and res_kind != torch.int8)
    return hit


# -- tensor parallelism ----------------------------------------------------
# A node sliced by ``parallel.mesh.shard_variables`` (tagged ``_tp``) holds
# this rank's output channels [lo, hi): the per-channel epilogue on a slice
# is the same arithmetic, so the ops run the slice and gather the channels
# over the model group where the consumer needs all of them.

def tp_gather(y: torch.Tensor, node: Node) -> torch.Tensor:
    """``y`` (this rank's channels of ``node``, last axis) with every
    rank's channels, gathered over the model group; ``y`` for a node that
    is not sharded."""
    tp = node.get("_tp")
    if tp is None:
        return y
    from qtpu_torch.parallel import collectives

    return collectives.all_gather(y, tp.group, dim=-1)


def tp_local(x: torch.Tensor, node: Node, channels: int) -> torch.Tensor:
    """``x`` restricted to ``node``'s channels when it holds them all
    (``channels`` is the node's local count)."""
    tp = node.get("_tp")
    if tp is None or x.shape[-1] == channels:
        return x
    return x[..., tp.lo:tp.hi].contiguous()


def channels(node: Node) -> int:
    """The output channels of the whole node, every rank's together."""
    tp = node.get("_tp")
    return node["colsum"].shape[0] * (1 if tp is None else tp.size)


def same_shard(a: Node, b: Node) -> bool:
    """Whether ``a``'s output feeds ``b`` channel for channel on this rank
    (both sharded alike), so it need not be gathered in between."""
    ta, tb = a.get("_tp"), b.get("_tp")
    return (ta is not None and tb is not None and ta.lo == tb.lo
            and ta.hi == tb.hi and ta.size == tb.size)


def gemm_1x1(x_q: torch.Tensor, node: Node, *, relu: bool = False,
             act_max: Optional[float] = None, requant=None,
             out_dtype: torch.dtype = torch.float32,
             residual: Optional[torch.Tensor] = None, res_grid=None,
             raw_acc: bool = False, gather: bool = True) -> torch.Tensor:
    """1×1 conv (or fc on (B, 1, 1, C)) as a fused GEMM over a frozen node
    (K1; its int4 entry when the prepared node has ``w_nk4``).  ``raw_acc``
    returns the int32 accumulator.  A sharded node takes its channels of
    ``residual`` and, unless ``raw_acc`` or ``gather=False``, returns every
    rank's channels."""
    B, H, W, Ci = x_q.shape
    node = _prepared(node, x_q.device)
    Co = node["w_nk"].shape[0]
    M = B * H * W
    if residual is not None:
        residual = tp_local(residual, node, Co)
    res2 = residual.reshape(M, Co) if residual is not None else None
    if raw_acc:
        co = mode = None
    else:
        co, mode = _epilogue(node, relu=relu, act_max=act_max,
                             requant=requant,
                             res_kind=None if res2 is None else res2.dtype,
                             res_grid=res_grid)
    w4 = node.get("w_nk4")
    if w4 is not None:
        y = qmatmul_folded_w4(x_q.reshape(M, Ci), w4, co, mode, res2,
                              out_dtype=out_dtype, raw_acc=raw_acc)
    else:
        y = qmatmul_folded(x_q.reshape(M, Ci), node["w_nk"], co, mode, res2,
                           out_dtype=out_dtype, raw_acc=raw_acc)
    y = y.reshape(B, H, W, Co)
    return y if raw_acc or not gather else tp_gather(y, node)


def conv(x_q: torch.Tensor, node: Node, *, strides=(1, 1),
         relu: bool = False, act_max: Optional[float] = None,
         requant=None, padding="SAME", raw_acc: bool = False,
         gather: bool = True) -> torch.Tensor:
    """K×K conv (stride 1 or 2) over a frozen node (K2): the zero-point
    pads of ``padding`` ("SAME" or explicit ((lo, hi), (lo, hi))) read in
    the kernel where its path allows; int8 codes with ``requant``, f32
    otherwise, the int32 accumulator with ``raw_acc``.  A sharded node
    gathers its output channels unless ``raw_acc`` or ``gather=False``."""
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    node = _prepared(node, x_q.device)
    kh_kw = node["kernel_hw"]
    pads = qops.resolve_pads(x_q.shape[1:3], kh_kw, strides, padding)
    co = mode = None
    if not raw_acc:
        co, mode = _epilogue(node, relu=relu, act_max=act_max,
                             requant=requant, res_kind=None, res_grid=None)
    y = qconv2d_folded(x_q, node["w_nk"], co, mode, kernel_hw=kh_kw,
                       stride=strides[0], pads=pads, zp=node["grid"].zp,
                       tapsum=node.get("tapsum"), raw_acc=raw_acc)
    return y if raw_acc or not gather else tp_gather(y, node)


def depthwise(x_q: torch.Tensor, node: Node, *, strides=(1, 1),
              relu: bool = False, act_max: Optional[float] = None,
              requant=None, padding="SAME", raw_acc: bool = False,
              gather: bool = True) -> torch.Tensor:
    """Depthwise K×K conv (stride 1 or 2) over a frozen (KH, KW, 1, C) node
    (K3): the pads of ``padding`` ("SAME" or explicit ((lo, hi), (lo, hi)))
    read the zero point inside the kernel; int8 codes with ``requant``
    (relu6 as ``relu`` with ``act_max=6``), f32 otherwise, the int32
    accumulator with ``raw_acc``.  A sharded node needs only its own input
    channels (it takes them from a full ``x_q``) and gathers its output
    unless ``raw_acc`` or ``gather=False``."""
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    node = _prepared(node, x_q.device, depthwise=True)
    x_q = tp_local(x_q, node, node["w_taps"].shape[1])
    co = mode = None
    if not raw_acc:
        co, mode = _epilogue(node, relu=relu, act_max=act_max,
                             requant=requant, res_kind=None, res_grid=None)
    y = qdepthwise_folded(x_q, node["w_taps"], co, mode,
                          kernel_hw=node["kernel_hw"], stride=strides[0],
                          padding=padding, zp=node["grid"].zp,
                          raw_acc=raw_acc)
    return y if raw_acc or not gather else tp_gather(y, node)


# -- the fused bottleneck pieces (experimental engine) -------------------------
# Each folds its convs with the keys the unfused calls use, so both paths
# share one memoized set of coefficients per node.

def proj_coeffs(c3: Node, down: Node, requant):
    """(co3, mode3, cod): conv3 with an f32 residual requantised onto
    ``requant``, and the downsample's plain dequant."""
    co3, mode3 = _epilogue(c3, relu=True, act_max=None, requant=requant,
                           res_kind=torch.float32, res_grid=None)
    cod, _ = _epilogue(down, relu=False, act_max=None, requant=None,
                       res_kind=None, res_grid=None)
    return co3, mode3, cod


def tail_coeffs(c2: Node, c3: Node, x_grid, requant):
    """((co2, mode2), (co3, mode3)): conv2 requantised onto conv3's grid,
    conv3 with the int8 residual on ``x_grid`` onto ``requant``."""
    return (_epilogue(c2, relu=True, act_max=None, requant=c3["grid"],
                      res_kind=None, res_grid=None),
            _epilogue(c3, relu=True, act_max=None, requant=requant,
                      res_kind=torch.int8, res_grid=x_grid))


def block_coeffs(c1: Node, c2: Node, c3: Node, x_grid, requant):
    """((co1, mode1), (co2, mode2), (co3, mode3)) of a whole identity
    block: conv1 requantised onto conv2's grid, then :func:`tail_coeffs`."""
    return (_epilogue(c1, relu=True, act_max=None, requant=c2["grid"],
                      res_kind=None, res_grid=None),
            *tail_coeffs(c2, c3, x_grid, requant))


def proj(b_q: torch.Tensor, x_q: torch.Tensor, c3: Node, down: Node, *,
         strides=(1, 1), requant) -> torch.Tensor:
    """Projection-block tail over frozen nodes (K4): conv3 of conv2's codes
    ``b_q`` plus the downsample of the block input ``x_q`` at ``strides``,
    relu, requant onto ``requant``."""
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    c3, down = _prepared(c3, b_q.device), _prepared(down, b_q.device)
    co3, mode3, cod = proj_coeffs(c3, down, requant)
    return qproj_folded(b_q, x_q, c3["w_nk"], down["w_nk"], co3, mode3, cod,
                        stride=strides[0])


def tail(a_q: torch.Tensor, x_q: torch.Tensor, c2: Node, c3: Node, *,
         x_grid, requant) -> torch.Tensor:
    """Identity-block tail over frozen nodes (K5): conv2 (3×3/1, pads of
    its zero point read in the kernel) of conv1's codes ``a_q``, requant,
    conv3 + the block input ``x_q`` on ``x_grid``, relu, requant onto
    ``requant``."""
    c2, c3 = _prepared(c2, a_q.device), _prepared(c3, a_q.device)
    (co2, mode2), (co3, mode3) = tail_coeffs(c2, c3, x_grid, requant)
    return qtail_folded(a_q, x_q, c2["w_nk"], c3["w_nk"], co2, mode2, co3,
                        mode3, pad=1, zp=c2["grid"].zp)


def bottleneck(x_q: torch.Tensor, c1: Node, c2: Node, c3: Node, *, x_grid,
               requant) -> torch.Tensor:
    """A whole identity bottleneck over frozen nodes (K6)."""
    c1, c2, c3 = (_prepared(c, x_q.device) for c in (c1, c2, c3))
    (co1, mode1), (co2, mode2), (co3, mode3) = block_coeffs(
        c1, c2, c3, x_grid, requant)
    return qblock_folded(x_q, c1["w_nk"], c2["w_nk"], c3["w_nk"], co1, mode1,
                         co2, mode2, co3, mode3, zp2=c2["grid"].zp)


# -- the chained runs (experimental engines) ------------------------------------
# The operands are built once per run, at engine build, from the coefficients
# the unfused calls memoize, and stacked for the kernels.

class ChainOperands(NamedTuple):
    """A chained run's stacked weights (the kernels' layouts) and
    coefficients."""
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    co: ChainCoeffs


class ProjOperands(NamedTuple):
    """A stride-1 projection block's weights and coefficients for K8."""
    wp1: torch.Tensor
    wp2: torch.Tensor
    wp3: torch.Tensor
    wd: torch.Tensor
    pco: ChainCoeffs
    cod: EpilogueCoeffs


def _conv_coeffs(node: Node, nxt: Node, act_max=None):
    """A conv requantised onto the next conv's grid with relu (relu6 with
    ``act_max``), as the unfused path folds it."""
    return _epilogue(node, relu=True, act_max=act_max, requant=nxt["grid"],
                     res_kind=None, res_grid=None)


def chain_operands(blocks, requant) -> ChainOperands:
    """A run of identity bottlenecks [(c1, c2, c3), ...] (prepared nodes),
    block i requantised onto block i+1's conv1 grid, the last onto
    ``requant``: :func:`block_coeffs` per block, the residual on the
    block's own conv1 grid (the grid the forward gives its input)."""
    per = []
    for i, (c1, c2, c3) in enumerate(blocks):
        tgt = blocks[i + 1][0]["grid"] if i + 1 < len(blocks) else requant
        per.append((*block_coeffs(c1, c2, c3, c1["grid"], tgt),
                    c2["grid"].zp))
    return ChainOperands(*(torch.stack([b[k]["w_nk"] for b in blocks])
                           for k in range(3)), stack_chain(per))


def proj_operands(c1: Node, c2: Node, c3: Node, down: Node, requant
                  ) -> ProjOperands:
    """A stride-1 projection block (prepared nodes) requantised onto
    ``requant`` (the first chained block's conv1 grid): conv1 onto conv2's
    grid, conv2 onto conv3's, conv3 + downsample as :func:`proj_coeffs`."""
    co3, mode3, cod = proj_coeffs(c3, down, requant)
    pco = stack_chain([(_conv_coeffs(c1, c2), _conv_coeffs(c2, c3),
                        (co3, mode3), c2["grid"].zp)])
    return ProjOperands(c1["w_nk"], c2["w_nk"], c3["w_nk"], down["w_nk"],
                        pco, cod)


def ivr_operands(blocks, requant) -> ChainOperands:
    """A run of identity inverted residuals [(expand, dw, project), ...]
    (prepared nodes; dw in the depthwise layout), block i requantised onto
    block i+1's expand grid, the last onto ``requant``: relu6 on expand and
    depthwise, the project with the int8 residual on the expand's grid."""
    per = []
    for i, (c1, c2, c3) in enumerate(blocks):
        tgt = blocks[i + 1][0]["grid"] if i + 1 < len(blocks) else requant
        per.append((_conv_coeffs(c1, c2, 6.0), _conv_coeffs(c2, c3, 6.0),
                    _epilogue(c3, relu=False, act_max=None, requant=tgt,
                              res_kind=torch.int8, res_grid=c1["grid"]),
                    c2["grid"].zp))
    return ChainOperands(torch.stack([b[0]["w_nk"] for b in blocks]),
                         torch.stack([b[1]["w_taps"] for b in blocks]),
                         torch.stack([b[2]["w_nk"] for b in blocks]),
                         stack_chain(per))


def stage(x_q: torch.Tensor, run: ChainOperands) -> torch.Tensor:
    """A chained run of identity bottlenecks (K7)."""
    return qstage_folded(x_q, run.w1, run.w2, run.w3, run.co)


def proj_stage(x_q: torch.Tensor, proj: ProjOperands, run: ChainOperands
               ) -> torch.Tensor:
    """A whole stride-1 stage: the projection block, then the run (K8)."""
    return qstage_proj_folded(x_q, proj.wp1, proj.wp2, proj.wp3, proj.wd,
                              proj.pco, proj.cod, run.w1, run.w2, run.w3,
                              run.co)


def ivr(x_q: torch.Tensor, run: ChainOperands) -> torch.Tensor:
    """A chained run of identity inverted residuals (K9)."""
    return qivr_folded(x_q, run.w1, run.w2, run.w3, run.co)
