"""K5: fused identity-bottleneck tail (port of
qtpu/ops/pallas/qtail.py:qtail_fused).

conv2 (3×3, stride 1) on conv1's int8 codes → requant → conv3 (1×1) + int8
residual → relu → requant, in one kernel, ``csrc/qtail.cu``: conv2's codes
stay in shared memory instead of a round trip through device memory between
K2 and K1.  The epilogues are K2's and K1's, in their order, so the codes
are bit-identical to that unfused pair.

Two kernels, chosen per call by :func:`tail_path` and counted apart
(``launches_wgmma``, ``launches_igemm``):

* ``"wgmma"`` (``csrc/wgmma_tail.cuh``) for Cmid a multiple of 64 and Cout
  of 128:
  a cluster of ``cs`` blocks owns one 8×8 output tile; each block computes
  its share of conv2's and conv3's channels with TMA loads and wgmma
  straight from the halo, and the blocks exchange conv2's codes through
  distributed shared memory.  :func:`tail_plan` chooses ``cs`` and the
  ring from the shape and the card's SM count;
* ``"igemm"``, the older ``mma.sync`` kernel (``csrc/fused_tail.cuh``), for
  the rest (other channel counts, requant grids ``code_bits`` cannot
  take, unaligned views).

``qtail_folded`` is the kernel wrapper: on a CUDA tensor it launches K5 (or
raises), on a CPU tensor it takes ``qtail_folded_plain``, the unfused K2 →
K1 pair in plain PyTorch.  Its ``launches`` attribute counts kernel launches
and nothing else.  Its input is unpadded: the kernel reads the zero point
``zp`` for each of conv2's taps outside the image (``pad`` pixels on every
side), as K3 does, so the engine makes no zero-point-padded copy.  conv2's
weight is stored (Cmid, 9·Cmid) — K2's layout — and conv3's (Cout, Cmid).

``qtail_fused`` keeps qtpu's call form: ``a_pad`` already padded with the
zero point (pad 0 here), ``w2`` (9, Cmid, Cmid), ``w3`` (Cmid, Cout) and the
rows of :func:`tail_coeffs`; qtpu's TPU-only ``pair``, ``bb`` and
``interpret`` are not taken (pairing adds only zero products).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from qtpu_torch.bench.profile import note_work, recording
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import check_int8, check_vectors, int_grid
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode
from qtpu_torch.ops.qproj import (AFFINE_RELU, PATHS, check_requant,
                                  choose, count, flat_f32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the plan's six ints (cs, tm, stages, nc, nres, smem) follow the floats
_ARGTYPES = (_P,) * 9 + (_I,) * 7 + (_F,) * 7 + (_I,) * 6 + (_P,)
_SYMBOLS = {"wgmma": "qtpu_qtail_fused", "igemm": "qtpu_qtail_fused_igemm"}
# the largest dynamic shared memory a block may have on the H100, and what
# one SM holds (1 KB of it reserved per block)
SMEM_LIMIT = 232448
SMEM_SM = 233472

# -- the wgmma kernel's plan (csrc/wgmma_tail.cuh: Layout) -------------------
TILE = 8                 # an 8 x 8 output tile: one 64-row wgmma
HALO_PIX = 100           # its 10 x 10 halo
CHUNK_PITCH = 1664       # a 16-channel halo chunk: 104 x 16 B, 128-aligned
STAGE_W = 128 * 64       # a weight stage: up to 128 rows x 64 bytes
STAGE_X = 128 * 64       # K6's x stage: 128 halo rows x 64 bytes
SLAB = 64 * 128          # a residual or output tile: 64 pixels x 128 channels
MIN_STAGES, MAX_STAGES = 4, 8
MAX_RES = 4
BAR_BYTES = 256          # the kernel's mbarriers
MAX_CS = 8               # the portable cluster size


class TailPlan(NamedTuple):
    """The wgmma kernel's launch: a cluster of ``cs`` blocks splitting the
    channels of the same tiles, each block owning ``tm`` 8×8 tiles (1 or
    2); ``stages`` in the weight ring, ``nc`` output and ``nres`` residual
    tiles a tile, ``smem`` bytes a block, ``per_sm`` blocks an SM aimed at;
    ``tiles`` and ``grid`` (= ⌈tiles/tm⌉·cs) blocks; ``rows`` the share of
    the tiles' 64 rows that lie in the image."""
    cs: int
    tm: int
    stages: int
    nc: int
    nres: int
    smem: int
    per_sm: int
    tiles: int
    grid: int
    rows: float


def wg_smem_bytes(cmid: int, cout: int, *, block: bool, stages: int,
                  cs: int = 1, tm: int = 1, nc: int = 2,
                  nres: int = 2) -> int:
    """Shared memory of a block of the wgmma kernel (Layout in
    csrc/wgmma_tail.cuh, which checks it): alignment slack, the ring (K6's
    stages also hold each tile's x halo), per tile the residual and output
    tiles, the halo (Cmid/16 chunks) and ``mid`` (64 × Cmid), the block's A,
    B rows (conv2's and K6's conv1's Cmid/cs, conv3's Cout/cs) and the
    barriers."""
    stage = STAGE_W + (tm * STAGE_X if block else 0)
    coef = 8 * (cmid // cs * (2 if block else 1) + cout // cs)
    return (1024 + stages * stage
            + tm * ((nres + nc) * SLAB + cmid // 16 * CHUNK_PITCH + 64 * cmid)
            + coef + BAR_BYTES)


def igemm_smem_bytes(cmid: int, *, block: bool) -> int:
    """The older kernel's shared memory: the 10×10 halo, the 64-pixel
    conv2 tile, two weight stages (csrc/fused_tail.cuh), and for K6 two
    conv1 stages."""
    return (100 * (cmid + 16) + 64 * (-(-cmid // 64) * 64 + 16) + 2 * 64 * 80
            + (2 * 64 * 80 if block else 0))


def cluster_max(cmid: int, cout: int) -> int:
    """The largest cluster whose blocks each get a multiple of 64 of
    conv2's channels and of 128 of conv3's."""
    cs = MAX_CS
    while cs > 1 and (cmid % (64 * cs) or cout % (128 * cs)):
        cs //= 2
    return cs


def _fit(cmid, cout, block, cs, tm, grid, sms):
    """(per_sm, nc, nres, stages, smem) of the first layout that fits, as
    K1's plan: as many blocks an SM as the grid fills, at most 2 (the
    kernel's register bound), each with a ring of at least four stages; up
    to four residual tiles (loaded before the weights) and two output
    tiles where they fit."""
    stage = STAGE_W + (tm * STAGE_X if block else 0)
    res = min(MAX_RES, cout // cs // 128)
    bufs = sorted({(2, res), (1, res), (2, min(res, 2)), (1, min(res, 2)),
                   (2, 1), (1, 1)}, key=lambda b: (-b[1], -b[0]))
    for per_sm in range(min(-(-grid // sms), 2), 0, -1):
        budget = min(SMEM_LIMIT, SMEM_SM // per_sm - 1024)
        for nc, nres in bufs:
            fixed = wg_smem_bytes(cmid, cout, block=block, stages=0, cs=cs,
                                  tm=tm, nc=nc, nres=nres)
            stages = min(MAX_STAGES, (budget - fixed) // stage)
            if stages >= MIN_STAGES:
                return per_sm, nc, nres, stages, fixed + stages * stage
    return None


@functools.lru_cache(maxsize=None)
def tail_plan(B: int, H: int, W: int, cmid: int, cout: int, *, sms: int,
              block: bool = False, cs: Optional[int] = None,
              tm: Optional[int] = None) -> Optional[TailPlan]:
    """The wgmma kernel's plan for a (B, H, W) output with ``cmid``/``cout``
    channels on a card of ``sms`` SMs, or None where it cannot run (Cmid
    off 64 or Cout off 128, or no ring of MIN_STAGES fits).  ``cs`` and
    ``tm`` force the cluster size and the tiles a block.  The rule, from
    ``ops/time_tail.py --sweep`` on an H100 (PERF.md §6, PR 8):

    * two tiles a block (both share every weight stage: half the weight
      bytes from L2 a pixel) where the pairs alone fill the card (⌈tiles/2⌉
      ≥ sms) and either their layout keeps as many blocks an SM as one
      tile's or Cmid ≥ 256 (the weights, 9·Cmid² + Cmid·Cout bytes, then
      outweigh the blocks lost); one otherwise;
    * no cluster while the blocks fill half the card (⌈tiles/tm⌉ ≥ sms/2):
      a cluster's exchange and its copies of the halo cost more than the
      shorter serial path gains; else the smallest power of two that fills
      it, at most :func:`cluster_max`, and for one tile a block at most
      Cmid/128 (each warpgroup then keeps 64 of conv2's columns: 32-wide
      wgmmas run at about the same time a stage as 64-wide ones) unless
      that leaves fewer than sms/4 blocks;
    * the layout (:func:`_fit`)."""
    if cmid % 64 or cout % 128 or min(B, H, W) <= 0:
        return None
    ty, tx = -(-H // TILE), -(-W // TILE)
    tiles = B * ty * tx
    top = cluster_max(cmid, cout)
    if cs is not None and (cs not in (1, 2, 4, 8) or cs > top):
        raise ValueError(f"cluster size {cs} cannot split Cmid {cmid} and "
                         f"Cout {cout} (at most {top})")
    if tm is not None and tm not in (1, 2):
        raise ValueError(f"{tm} tiles a block: 1 or 2")
    if tm is None:
        tm = 1
        if -(-tiles // 2) >= sms:
            two = _fit(cmid, cout, block, cs or 1, 2, -(-tiles // 2), sms)
            one = _fit(cmid, cout, block, cs or 1, 1, tiles, sms)
            if two is not None and (one is None or two[0] >= one[0]
                                    or cmid >= 256):
                tm = 2
    units = -(-tiles // tm)
    if cs is None:
        cs = 1
        if units < sms / 2:
            while cs < top and units * cs < sms:
                cs *= 2
            if tm == 1:
                n64 = max(1, min(cs, cmid // 128))
                if units * n64 >= sms / 4:
                    cs = n64
    fit = _fit(cmid, cout, block, cs, tm, units * cs, sms)
    if fit is None:
        return None
    per_sm, nc, nres, stages, smem = fit
    return TailPlan(cs, tm, stages, nc, nres, smem, per_sm, tiles,
                    units * cs, H * W / (ty * tx * TILE * TILE))


def tail_smem_bytes(cmid: int, cout: int, *, block: bool = False) -> int:
    """The shared memory a block needs at the least on the kernel this shape
    takes: the wgmma kernel's (ring of MIN_STAGES, single tiles, one block a
    cluster) for Cmid a multiple of 64 and Cout of 128 where that fits,
    else the older kernel's.  The engines' eligibility test
    (``serve/experimental.py``) reads it."""
    if cmid % 64 == 0 and cout % 128 == 0:
        wg = wg_smem_bytes(cmid, cout, block=block, stages=MIN_STAGES, nc=1,
                           nres=1)     # one tile, one block a cluster
        if wg <= SMEM_LIMIT:
            return wg
    return igemm_smem_bytes(cmid, block=block)


def tail_path(cmid: int, cout: int, co3: EpilogueCoeffs,
              mode3: EpilogueMode, *tensors: torch.Tensor,
              block: bool = False) -> str:
    """The kernel K5 (or K6, ``block``) takes: ``"wgmma"`` for Cmid a
    multiple of 64 and Cout of 128, conv3's grid one ``code_bits`` takes and
    16-byte aligned ``tensors`` (TMA), where the smallest plan fits;
    ``"igemm"`` otherwise."""
    ok = (cmid % 64 == 0 and cout % 128 == 0 and int_grid(co3.lo, co3.hi, mode3.shift)
          and all(t.data_ptr() % 16 == 0 for t in tensors)
          and wg_smem_bytes(cmid, cout, block=block, stages=MIN_STAGES,
                            nc=1, nres=1) <= SMEM_LIMIT)
    return "wgmma" if ok else "igemm"


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count


def plan_args(path: str, B: int, H: int, W: int, cmid: int, cout: int,
              dev: torch.device, *, block: bool, cs: Optional[int],
              tm: Optional[int]):
    """(cs, tm, stages, nc, nres, smem) for the C entry (zeros for the
    older kernel, which plans itself)."""
    if path != "wgmma":
        return 0, 0, 0, 0, 0, 0
    plan = tail_plan(B, H, W, cmid, cout, block=block, cs=cs, tm=tm,
                     sms=_sm_count(dev.index))
    if plan is None:
        raise ValueError(f"no wgmma plan for Cmid {cmid}, Cout {cout}")
    return plan.cs, plan.tm, plan.stages, plan.nc, plan.nres, plan.smem


def w2_nk(w2: torch.Tensor) -> torch.Tensor:
    """qtpu's (9, Cmid, Cmid) conv2 taps → the kernel layout (Cmid, 9·Cmid)."""
    return w2.reshape(-1, w2.shape[-1]).t().contiguous()


def check_tail(dev: torch.device, cmid: int, cout: int, w2: torch.Tensor,
               w3: torch.Tensor, co2: EpilogueCoeffs, mode2: EpilogueMode,
               co3: EpilogueCoeffs, mode3: EpilogueMode, *,
               block: bool = False) -> None:
    """The checks K5 and K6 share on the tail's operands."""
    if cmid % 16:
        raise ValueError(f"Cmid {cmid} must be a multiple of 16")
    if tuple(w2.shape) != (cmid, 9 * cmid) or tuple(w3.shape) != (cout, cmid):
        raise ValueError(f"weights {tuple(w2.shape)}, {tuple(w3.shape)} do "
                         f"not match ({cmid}, 9*{cmid}) and ({cout}, {cmid})")
    if tail_smem_bytes(cmid, cout, block=block) > SMEM_LIMIT:
        raise ValueError(f"Cmid {cmid} needs more shared memory than a block "
                         "has")
    check_int8(dev, w2=w2, w3=w3)
    check_vectors(co2, cmid, dev)
    check_vectors(co3, cout, dev)
    check_requant(mode2, "tail conv2")
    check_requant(mode3, "tail conv3")


def qtail_folded(a_q: torch.Tensor, r_q: torch.Tensor, w2: torch.Tensor,
                 w3: torch.Tensor, co2: EpilogueCoeffs, mode2: EpilogueMode,
                 co3: EpilogueCoeffs, mode3: EpilogueMode, *, pad: int = 1,
                 zp: int = 0, path: Optional[str] = None,
                 cs: Optional[int] = None, tm: Optional[int] = None,
                 defines: tuple = ()) -> torch.Tensor:
    """conv2 of the int8 (B, Hin, Win, Cmid) ``a_q`` (``pad`` pixels of
    ``zp`` on every side) with the (Cmid, 9·Cmid) weight → requant
    ``co2``/``mode2`` → conv3 with the (Cout, Cmid) weight + the int8
    residual ``r_q`` (B, H, W, Cout) → requant ``co3``/``mode3`` → int8
    (B, H, W, Cout), H = Hin + 2·pad − 2.  ``path`` forces a kernel
    (``"igemm"`` takes any shape), ``cs`` and ``tm`` the wgmma kernel's
    cluster size and tiles a block (:func:`tail_plan`); ``defines`` selects
    a probe build (``ops/probe_tail.py``)."""
    if a_q.device.type == "cpu":
        return qtail_folded_plain(a_q, r_q, w2, w3, co2, mode2, co3, mode3,
                                  pad=pad, zp=zp)
    if not a_q.is_cuda:
        raise ValueError(f"unsupported device {a_q.device}")
    dev = a_q.device
    if a_q.dim() != 4:
        raise ValueError(f"a_q must be NHWC, got {tuple(a_q.shape)}")
    B, Hin, Win, Cmid = a_q.shape
    Cout = w3.shape[0]
    H, W = Hin + 2 * pad - 2, Win + 2 * pad - 2
    if pad not in (0, 1) or H <= 0 or W <= 0:
        raise ValueError(f"pad {pad} on a {Hin}x{Win} input")
    if not -128 <= int(zp) <= 127:
        raise ValueError(f"zero point {zp} off the int8 grid")
    if tuple(r_q.shape) != (B, H, W, Cout):
        raise ValueError(f"residual {tuple(r_q.shape)} is not "
                         f"{(B, H, W, Cout)}")
    check_int8(dev, a_q=a_q, r_q=r_q)
    check_tail(dev, Cmid, Cout, w2, w3, co2, mode2, co3, mode3)
    out = torch.empty((B, H, W, Cout), dtype=torch.int8, device=dev)
    path = choose(path, tail_path(Cmid, Cout, co3, mode3, a_q, r_q, w2, w3,
                                  out), "K5")
    plan = plan_args(path, B, H, W, Cmid, Cout, dev, block=False, cs=cs,
                     tm=tm)
    fn = _build.load("qtail", _SYMBOLS[path], _ARGTYPES, defines)
    err = _build.launch(
        fn, dev, a_q.data_ptr(), r_q.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        co2.A.data_ptr(), co2.B.data_ptr(), co3.A.data_ptr(), co3.B.data_ptr(),
        out.data_ptr(), B, Hin, Win, pad, int(zp), Cmid, Cout, co2.lo, co2.hi,
        mode2.shift, co3.C, co3.lo, co3.hi, mode3.shift, *plan)
    if err:
        raise RuntimeError(f"qtail_fused kernel ({path}) launch failed: CUDA "
                           f"error {err} (a {tuple(a_q.shape)}, Cout={Cout}, "
                           f"plan {plan})")
    count(qtail_folded, path)
    if recording():
        note_work(2 * B * H * W * Cmid * (9 * Cmid + Cout),
                  a_q.numel() + r_q.numel() + out.numel() + w2.numel()
                  + w3.numel() + 8 * (Cmid + Cout))
    return out


qtail_folded.launches = 0
qtail_folded.launches_wgmma = 0
qtail_folded.launches_igemm = 0


def tail_plain(a_q, r_q, w2, w3, co2, mode2, co3, mode3, *, pad, zp):
    """The unfused K2 → K1 pair in plain PyTorch: zero-point pad, conv2's
    exact accumulator and its requant, conv3's exact accumulator and its
    folded epilogue with the int8 residual."""
    B, _, _, Cmid = a_q.shape
    ap = qops.pad_nhwc(a_q, ((pad, pad), (pad, pad)), int(zp))
    acc2 = qops.conv_acc_f64(ap, w2.reshape(Cmid, 3, 3, Cmid)
                             .permute(1, 2, 3, 0))
    b = qops.apply_epilogue(acc2, co2, mode2)
    acc3 = qops.qmatmul(b.reshape(-1, Cmid), w3.t())
    out = qops.apply_epilogue(acc3, co3, mode3,
                              residual=r_q.reshape(acc3.shape[0], -1))
    return out.reshape(*b.shape[:3], -1)


def qtail_folded_plain(a_q: torch.Tensor, r_q: torch.Tensor,
                       w2: torch.Tensor, w3: torch.Tensor,
                       co2: EpilogueCoeffs, mode2: EpilogueMode,
                       co3: EpilogueCoeffs, mode3: EpilogueMode, *,
                       pad: int = 1, zp: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`qtail_folded` (:func:`tail_plain`)."""
    qtail_folded_plain.calls += 1
    return tail_plain(a_q, r_q, w2, w3, co2, mode2, co3, mode3, pad=pad,
                      zp=zp)


qtail_folded_plain.calls = 0


def qtail_fused(a_pad: torch.Tensor, r_q: torch.Tensor, *, w2: torch.Tensor,
                w3: torch.Tensor, scalars: torch.Tensor, a2: torch.Tensor,
                b2: torch.Tensor, a3: torch.Tensor, b3: torch.Tensor
                ) -> torch.Tensor:
    """qtpu's call form: ``a_pad`` (B, H+2, W+2, Cmid) already padded with
    conv2's zero point, ``r_q`` (B, H, W, Cout), w2 (9, Cmid, Cmid), w3
    (Cmid, Cout); ``scalars`` (1, 3) = [lo2, lo3, C] and the rows from
    :func:`tail_coeffs`."""
    lo2, lo3, c = (float(v) for v in scalars.reshape(-1)[:3].tolist())
    co2 = EpilogueCoeffs(A=flat_f32(a2), B=flat_f32(b2), C=0.0, lo=lo2,
                         hi=255.0)
    co3 = EpilogueCoeffs(A=flat_f32(a3), B=flat_f32(b3), C=c, lo=lo3,
                         hi=255.0)
    return qtail_folded(a_pad, r_q, w2_nk(w2), w3.t().contiguous(), co2,
                        AFFINE_RELU, co3, AFFINE_RELU, pad=0)


def tail_coeffs(c2: Dict, c3: Dict, next_grid, res_grid
                ) -> Dict[str, torch.Tensor]:
    """qtpu's folded operands for qtail: conv2 requantised onto conv3's
    grid, conv3 onto the affine ``next_grid`` with the int8 residual on
    ``res_grid`` (each (scale, zp))."""
    co2, _ = qops.epilogue_coeffs(
        act_scale=c2["act_scale"], act_zp=c2["act_zp"],
        w_scale=c2["w_scale"], colsum=c2["colsum"], bias=c2["bias"],
        requant_scale=c3["act_scale"], requant_zp=c3["act_zp"], relu=True)
    co3, _ = qops.epilogue_coeffs(
        act_scale=c3["act_scale"], act_zp=c3["act_zp"],
        w_scale=c3["w_scale"], colsum=c3["colsum"], bias=c3["bias"],
        requant_scale=next_grid[0], requant_zp=next_grid[1], relu=True,
        res_scale=res_grid[0], res_zp=res_grid[1])
    return dict(scalars=torch.tensor([[co2.lo, co3.lo, co3.C]],
                                     dtype=torch.float32),
                a2=co2.A.reshape(1, -1), b2=co2.B.reshape(1, -1),
                a3=co3.A.reshape(1, -1), b3=co3.B.reshape(1, -1))
