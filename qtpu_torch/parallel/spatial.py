"""Spatial partitioning with halo exchange — the CNN analog of sequence
parallelism (port of qtpu/parallel/spatial.py).

Activations are sharded on their height over a ``'spatial'`` mesh axis
(NHWC; the batch over ``'data'``), weights replicated.  Before a conv or a
pool each rank takes the halo rows it needs from its two neighbours —
point-to-point sends of ``kh − stride`` rows over the ``spatial`` group
(``collectives.ppermute``), never an all-gather of the activation; the
edge ranks fill their missing halo with the pad value (the zero point for
an int8 conv, 0 for fp32, the dtype's minimum for the pool).  The local
conv then runs VALID on H, so its output is H-sharded the same way and
consecutive convs chain with nothing but halos between them.

In the rank model each rank holds its own block of rows: ``x`` is this
rank's ``(B/dp, H/sp, W, C)`` block (:func:`spatial_local` cuts it from a
whole tensor) and the output is this rank's block.  The local int8 conv —
XLA's in qtpu — runs on the card through K2's raw-accumulator entry (H pads
0: the halo supplies them; W pads in the kernel, the zero point corrected
by ``zp · tapsum``), a depthwise one (``groups = C``) through K3's; on the
CPU they take their plain versions.  fp32 convs run ``F.conv2d`` with
TF32 off.  SAME geometry at stride s needs the global H to divide by the
axis and the local H by s, and halos no taller than a neighbour's block;
anything else raises ``ValueError`` as qtpu's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from qtpu_torch.ops import qops
from qtpu_torch.ops.qconv import qconv2d_folded, tapsum_of
from qtpu_torch.ops.qdepthwise import qdepthwise_folded
from qtpu_torch.parallel import collectives
from qtpu_torch.parallel.mesh import DATA_AXIS, Mesh, P, mesh_over_ranks
from qtpu_torch.utils.device import fp32_exact

SPATIAL_AXIS = "spatial"


def make_spatial_mesh(sp: int, dp: int = 1) -> Mesh:
    """``('data', 'spatial')`` mesh over the world's ranks: DP over the
    batch, halo exchange over H."""
    return mesh_over_ranks({DATA_AXIS: dp, SPATIAL_AXIS: sp})


def spatial_sharding(mesh: Mesh) -> P:
    """NHWC activations: batch over ``data``, H over ``spatial``."""
    return P(DATA_AXIS, SPATIAL_AXIS)


def spatial_local(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole NHWC tensor under
    :func:`spatial_sharding` (raises when the batch or H does not divide)."""
    dp, sp = mesh.shape[DATA_AXIS], mesh.shape[SPATIAL_AXIS]
    B, H = x.shape[:2]
    if H % sp:
        raise ValueError(f"global H={H} not divisible by spatial axis ({sp})")
    if B % dp:
        raise ValueError(f"batch {B} not divisible by data axis ({dp})")
    b, h = B // dp, H // sp
    i, j = mesh.coord(DATA_AXIS), mesh.coord(SPATIAL_AXIS)
    return x[i * b:(i + 1) * b, j * h:(j + 1) * h].contiguous()


def _halo_pad_h(x: torch.Tensor, plo: int, phi: int, *, mesh: Mesh,
                pad_val) -> torch.Tensor:
    """``x`` with ``plo`` rows of the rank above and ``phi`` rows of the
    rank below concatenated on H (axis 1); the edge ranks fill theirs with
    ``pad_val``."""
    n, idx = mesh.shape[SPATIAL_AXIS], mesh.coord(SPATIAL_AXIS)
    group = mesh.group(SPATIAL_AXIS)
    parts = []
    if plo:
        top = (collectives.ppermute(x[:, -plo:], group,
                                    [(j, j + 1) for j in range(n - 1)])
               if n > 1 else None)
        if idx == 0:
            top = torch.full_like(x[:, :plo], pad_val)
        parts.append(top)
    parts.append(x)
    if phi:
        bot = (collectives.ppermute(x[:, :phi], group,
                                    [(j + 1, j) for j in range(n - 1)])
               if n > 1 else None)
        if idx == n - 1:
            bot = torch.full_like(x[:, :phi], pad_val)
        parts.append(bot)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def _geometry(H: int, n: int, window: Tuple[int, int], strides,
              W: int) -> Tuple[int, int, int, int]:
    """(plo, phi, wlo, whi) of a SAME window over H-sharded rows, with
    qtpu's checks."""
    kh = window[0]
    if H % n:
        raise ValueError(f"global H={H} not divisible by spatial axis ({n})")
    if (H // n) % strides[0]:
        raise ValueError(f"local H={H // n} not divisible by row stride "
                         f"{strides[0]}")
    (plo, phi_pad), (wlo, whi) = qops.same_pads((H, W), window, strides)
    # rows needed below the local block: the window's reach past the last
    # output row's start, derived apart from the global SAME pad so that a
    # mismatch fails loudly instead of cropping
    phi = max(kh - strides[0] - plo, 0)
    if phi != phi_pad:
        raise ValueError(f"unsupported pad geometry: phi={phi} != global "
                         f"SAME pad {phi_pad} (H={H}, kh={kh}, "
                         f"s={strides[0]})")
    if max(plo, phi) > H // n:
        raise ValueError(
            f"halo rows ({max(plo, phi)}) exceed the local shard height "
            f"({H // n}): kernel {kh} needs H/sp > {max(plo, phi)} — use "
            f"fewer spatial shards or a larger H")
    return plo, phi, wlo, whi


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                   strides: Tuple[int, int] = (1, 1),
                   zp: Optional[int] = None, groups: int = 1
                   ) -> torch.Tensor:
    """SAME conv of this rank's H-sharded NHWC block ``x`` with the HWIO
    weight ``w`` (replicated): int8 operands give the int32 accumulator
    (qtpu's ``qops.qconv2d``) with ``zp``, the activation zero point, as
    the pad value; fp32 give fp32.  ``groups`` is 1 or C (depthwise).
    Returns this rank's block of the output."""
    n = mesh.shape[SPATIAL_AXIS]
    B, h, W, C = x.shape
    kh, kw = w.shape[:2]
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    plo, phi, wlo, whi = _geometry(h * n, n, (kh, kw), strides, W)
    integer = not x.dtype.is_floating_point
    if integer and (x.dtype != torch.int8 or w.dtype != torch.int8):
        raise ValueError(f"spatial_conv2d: integer operands must be int8 "
                         f"(got {x.dtype}, {w.dtype})")
    if groups not in (1, C):
        raise ValueError(f"groups={groups}: 1 or C ({C}) only")
    zpv = 0 if zp is None else int(zp)
    xl = _halo_pad_h(x, plo, phi, mesh=mesh,
                     pad_val=zpv if integer else 0.0).contiguous()
    pads = ((0, 0), (wlo, whi))
    if not integer:
        xp = qops.pad_nhwc(xl, pads, 0.0).permute(0, 3, 1, 2)
        with fp32_exact():
            y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=strides,
                         groups=groups)
        return y.permute(0, 2, 3, 1).contiguous()
    if groups == C and C > 1:
        return qdepthwise_folded(xl, w.reshape(kh * kw, C).contiguous(), None,
                                 None, kernel_hw=(kh, kw), stride=strides[0],
                                 padding=pads, zp=zpv, raw_acc=True)
    w_nk = w.reshape(-1, w.shape[-1]).t().contiguous()
    return qconv2d_folded(xl, w_nk, None, None, kernel_hw=(kh, kw),
                          stride=strides[0], pads=pads, zp=zpv,
                          tapsum=tapsum_of(w_nk, (kh, kw)), raw_acc=True)


def _window_max(xp: torch.Tensor, kh: int, kw: int, s: Tuple[int, int]
                ) -> torch.Tensor:
    """VALID max over (kh, kw) windows at stride ``s`` of NHWC ``xp``: the
    max of the strided window slices (any dtype)."""
    Hp, Wp = xp.shape[1:3]
    OH, OW = (Hp - kh) // s[0] + 1, (Wp - kw) // s[1] + 1
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = xp[:, dy:dy + s[0] * (OH - 1) + 1:s[0],
                   dx:dx + s[1] * (OW - 1) + 1:s[1]]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def spatial_max_pool(x: torch.Tensor, mesh: Mesh, *,
                     window: Tuple[int, int] = (3, 3),
                     strides: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """SAME max-pool of this rank's H-sharded NHWC block (the ResNet stem's
    3×3/2): the halo and pad fill is the dtype's minimum (−inf for
    floats), XLA's SAME pooling exactly."""
    n = mesh.shape[SPATIAL_AXIS]
    B, h, W, _ = x.shape
    plo, phi, wlo, whi = _geometry(h * n, n, window, strides, W)
    ident = (float("-inf") if x.dtype.is_floating_point
             else torch.iinfo(x.dtype).min)
    xl = _halo_pad_h(x, plo, phi, mesh=mesh, pad_val=ident)
    xl = qops.pad_nhwc(xl, ((0, 0), (wlo, whi)), ident)
    return _window_max(xl, window[0], window[1], strides)
