"""K6: a whole identity bottleneck in one kernel (port of
qtpu/ops/pallas/qblock.py:qbottleneck_fused).

conv1 (1×1) → requant → conv2 (3×3, stride 1, zero-point pads) → requant →
conv3 (1×1) + the block input as int8 residual → relu → requant, in one
kernel, ``csrc/qblock.cu``: only the block input, the weights and the
output move through device memory.  Each block of the kernel recomputes
conv1 on the one-pixel halo of its 8×8 output tile; halo pixels outside the
image hold conv2's zero point, never a conv1 result.  The epilogues are
K1's, K2's and K1's in their order, so the codes are bit-identical to that
unfused sequence.

Two kernels, chosen per call by ``qtail.tail_path`` and counted apart
(``launches_wgmma``, ``launches_igemm``), as K5's: the wgmma kernel
(``csrc/wgmma_tail.cuh``; a cluster of blocks per 8×8 tile, each computing
its share of conv1's and conv2's channels, the halo exchanged through
distributed shared memory) for Cmid a multiple of 64 and Cin of 128, the
older
``mma.sync`` kernel for the rest.

``qblock_folded`` is the kernel wrapper: on a CUDA tensor it launches K6 (or
raises), on a CPU tensor it takes ``qblock_folded_plain``, the unfused K1 →
K2 → K1 sequence in plain PyTorch.  Its ``launches`` attribute counts
kernel launches and nothing else.  Weights are stored (N, K): conv1
(Cmid, Cin), conv2 (Cmid, 9·Cmid), conv3 (Cin, Cmid).

``qbottleneck_fused`` keeps qtpu's call form: (K, N) weights, w2 (9, Cmid,
Cmid) and the operands of :func:`block_coeffs`; qtpu's TPU-only ``pair``,
``bb`` and ``interpret`` are not taken.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import check_int8, check_vectors
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode
from qtpu_torch.ops.qproj import AFFINE_RELU, check_requant, flat_f32
from qtpu_torch.ops.qtail import (check_tail, choose, count, plan_args,
                                  tail_path, tail_plain, w2_nk)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the plan's six ints (cs, tm, stages, nc, nres, smem) follow the floats
_ARGTYPES = (_P,) * 11 + (_I,) * 6 + (_F,) * 10 + (_I,) * 6 + (_P,)
_SYMBOLS = {"wgmma": "qtpu_qblock_fused", "igemm": "qtpu_qblock_fused_igemm"}


def qblock_folded(x_q: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor, co1: EpilogueCoeffs, mode1: EpilogueMode,
                  co2: EpilogueCoeffs, mode2: EpilogueMode,
                  co3: EpilogueCoeffs, mode3: EpilogueMode, *, zp2: int,
                  path: Optional[str] = None, cs: Optional[int] = None,
                  tm: Optional[int] = None, defines: tuple = ()
                  ) -> torch.Tensor:
    """The identity bottleneck on the int8 (B, H, W, Cin) ``x_q``: conv1
    with the (Cmid, Cin) weight and requant ``co1``/``mode1``; conv2 with
    the (Cmid, 9·Cmid) weight, pads of ``zp2``, requant ``co2``/``mode2``;
    conv3 with the (Cin, Cmid) weight + ``x_q`` as residual, requant
    ``co3``/``mode3`` → int8 (B, H, W, Cin).  ``path``, ``cs``, ``tm`` and
    ``defines`` as for :func:`qtpu_torch.ops.qtail.qtail_folded`."""
    if x_q.device.type == "cpu":
        return qblock_folded_plain(x_q, w1, w2, w3, co1, mode1, co2, mode2,
                                   co3, mode3, zp2=zp2)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    dev = x_q.device
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be NHWC, got {tuple(x_q.shape)}")
    B, H, W, Cin = x_q.shape
    Cmid = w1.shape[0]
    if Cin % 16 or tuple(w1.shape) != (Cmid, Cin):
        raise ValueError(f"conv1 weight {tuple(w1.shape)} does not match "
                         f"({Cmid}, {Cin}), or Cin {Cin} % 16 != 0")
    if not -128 <= int(zp2) <= 127:
        raise ValueError(f"zero point {zp2} off the int8 grid")
    check_int8(dev, x_q=x_q, w1=w1)
    check_vectors(co1, Cmid, dev)
    check_requant(mode1, "block conv1")
    check_tail(dev, Cmid, Cin, w2, w3, co2, mode2, co3, mode3, block=True)
    out = torch.empty_like(x_q)
    path = choose(path, tail_path(Cmid, Cin, co3, mode3, x_q, w1, w2, w3,
                                  out, block=True), "K6")
    plan = plan_args(path, B, H, W, Cmid, Cin, dev, block=True, cs=cs,
                     tm=tm)
    fn = _build.load("qblock", _SYMBOLS[path], _ARGTYPES, defines)
    err = _build.launch(
        fn, dev, x_q.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        co1.A.data_ptr(), co1.B.data_ptr(), co2.A.data_ptr(), co2.B.data_ptr(),
        co3.A.data_ptr(), co3.B.data_ptr(), out.data_ptr(), B, H, W, Cin, Cmid,
        int(zp2), co1.lo, co1.hi, mode1.shift, co2.lo, co2.hi, mode2.shift,
        co3.C, co3.lo, co3.hi, mode3.shift, *plan)
    if err:
        raise RuntimeError(f"qbottleneck_fused kernel ({path}) launch "
                           f"failed: CUDA error {err} (x {tuple(x_q.shape)}, "
                           f"Cmid={Cmid}, plan {plan})")
    count(qblock_folded, path)
    return out


qblock_folded.launches = 0
qblock_folded.launches_wgmma = 0
qblock_folded.launches_igemm = 0


def qblock_folded_plain(x_q: torch.Tensor, w1: torch.Tensor,
                        w2: torch.Tensor, w3: torch.Tensor,
                        co1: EpilogueCoeffs, mode1: EpilogueMode,
                        co2: EpilogueCoeffs, mode2: EpilogueMode,
                        co3: EpilogueCoeffs, mode3: EpilogueMode, *,
                        zp2: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`qblock_folded`: conv1's exact
    accumulator and its requant, then the unfused tail
    (:func:`qtpu_torch.ops.qtail.tail_plain`) with ``x_q`` as residual."""
    qblock_folded_plain.calls += 1
    return block_plain(x_q, w1, w2, w3, co1, mode1, co2, mode2, co3, mode3,
                       zp2=zp2)


qblock_folded_plain.calls = 0


def block_plain(x_q, w1, w2, w3, co1, mode1, co2, mode2, co3, mode3, *,
                zp2):
    """The unfused K1 → K2 → K1 sequence of an identity block in plain
    PyTorch (counts nothing; the chained kernels' plain versions run it)."""
    B, H, W, Cin = x_q.shape
    a = qops.apply_epilogue(qops.qmatmul(x_q.reshape(-1, Cin), w1.t()),
                            co1, mode1).reshape(B, H, W, -1)
    return tail_plain(a, x_q, w2, w3, co2, mode2, co3, mode3, pad=1, zp=zp2)


def qbottleneck_fused(x_q: torch.Tensor, *, w1: torch.Tensor,
                      w2: torch.Tensor, w3: torch.Tensor,
                      scalars: torch.Tensor, a1: torch.Tensor,
                      b1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
                      a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """qtpu's call form: x_q (B, H, W, Cin), w1 (Cin, Cmid), w2 (9, Cmid,
    Cmid), w3 (Cmid, Cin); ``scalars`` (1, 5) = [lo1, lo2, lo3, C, zp2] and
    the rows from :func:`block_coeffs`."""
    lo1, lo2, lo3, c, zp2 = (float(v) for v in
                             scalars.reshape(-1)[:5].tolist())
    co1 = EpilogueCoeffs(A=flat_f32(a1), B=flat_f32(b1), C=0.0, lo=lo1,
                         hi=255.0)
    co2 = EpilogueCoeffs(A=flat_f32(a2), B=flat_f32(b2), C=0.0, lo=lo2,
                         hi=255.0)
    co3 = EpilogueCoeffs(A=flat_f32(a3), B=flat_f32(b3), C=c, lo=lo3,
                         hi=255.0)
    return qblock_folded(x_q, w1.t().contiguous(), w2_nk(w2),
                         w3.t().contiguous(), co1, AFFINE_RELU, co2,
                         AFFINE_RELU, co3, AFFINE_RELU, zp2=int(zp2))


def block_coeffs(c1: Dict, c2: Dict, c3: Dict, next_grid
                 ) -> Dict[str, torch.Tensor]:
    """qtpu's folded operands for qblock: each conv requantised onto the
    next one's grid (conv3 onto the affine ``next_grid`` (scale, zp)), the
    residual on conv1's input grid, and conv2's zero point (the pad code)
    in slot 4 of ``scalars``."""
    def fold(node, rs, rz, **kw):
        return qops.epilogue_coeffs(
            act_scale=node["act_scale"], act_zp=node["act_zp"],
            w_scale=node["w_scale"], colsum=node["colsum"],
            bias=node["bias"], requant_scale=rs, requant_zp=rz, relu=True,
            **kw)[0]
    co1 = fold(c1, c2["act_scale"], c2["act_zp"])
    co2 = fold(c2, c3["act_scale"], c3["act_zp"])
    co3 = fold(c3, next_grid[0], next_grid[1], res_scale=c1["act_scale"],
               res_zp=c1["act_zp"])
    zp2 = float(c2["act_zp"])
    return dict(scalars=torch.tensor([[co1.lo, co2.lo, co3.lo, co3.C, zp2]],
                                     dtype=torch.float32),
                a1=co1.A.reshape(1, -1), b1=co1.B.reshape(1, -1),
                a2=co2.A.reshape(1, -1), b2=co2.B.reshape(1, -1),
                a3=co3.A.reshape(1, -1), b3=co3.B.reshape(1, -1))
