"""K5: fused identity-bottleneck tail (port of
qtpu/ops/pallas/qtail.py:qtail_fused).

conv2 (3×3, stride 1) on conv1's int8 codes → requant → conv3 (1×1) + int8
residual → relu → requant, in one kernel, ``csrc/qtail.cu``: conv2's codes
stay in shared memory instead of a round trip through device memory between
K2 and K1.  The epilogues are K2's and K1's, in their order, so the codes
are bit-identical to that unfused pair.

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
from typing import Dict

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import check_int8, check_vectors
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode
from qtpu_torch.ops.qproj import AFFINE_RELU, check_requant, flat_f32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 9 + (_I,) * 7 + (_F,) * 7 + (_P,)
# the largest dynamic shared memory a block may have on the H100
SMEM_LIMIT = 232448


def tail_smem_bytes(cmid: int) -> int:
    """K5's shared memory: the 10×10 halo, the 64-pixel conv2 tile and two
    weight stages (csrc/fused_tail.cuh)."""
    return 100 * (cmid + 16) + 64 * (-(-cmid // 64) * 64 + 16) + 2 * 64 * 80


def w2_nk(w2: torch.Tensor) -> torch.Tensor:
    """qtpu's (9, Cmid, Cmid) conv2 taps → the kernel layout (Cmid, 9·Cmid)."""
    return w2.reshape(-1, w2.shape[-1]).t().contiguous()


def check_tail(dev: torch.device, cmid: int, cout: int, w2: torch.Tensor,
               w3: torch.Tensor, co2: EpilogueCoeffs, mode2: EpilogueMode,
               co3: EpilogueCoeffs, mode3: EpilogueMode, extra_smem: int = 0
               ) -> None:
    """The checks K5 and K6 share on the tail's operands."""
    if cmid % 16:
        raise ValueError(f"Cmid {cmid} must be a multiple of 16")
    if tuple(w2.shape) != (cmid, 9 * cmid) or tuple(w3.shape) != (cout, cmid):
        raise ValueError(f"weights {tuple(w2.shape)}, {tuple(w3.shape)} do "
                         f"not match ({cmid}, 9*{cmid}) and ({cout}, {cmid})")
    if tail_smem_bytes(cmid) + extra_smem > SMEM_LIMIT:
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
                 zp: int = 0) -> torch.Tensor:
    """conv2 of the int8 (B, Hin, Win, Cmid) ``a_q`` (``pad`` pixels of
    ``zp`` on every side) with the (Cmid, 9·Cmid) weight → requant
    ``co2``/``mode2`` → conv3 with the (Cout, Cmid) weight + the int8
    residual ``r_q`` (B, H, W, Cout) → requant ``co3``/``mode3`` → int8
    (B, H, W, Cout), H = Hin + 2·pad − 2."""
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
    fn = _build.load("qtail", "qtpu_qtail_fused", _ARGTYPES)
    err = fn(a_q.data_ptr(), r_q.data_ptr(), w2.data_ptr(), w3.data_ptr(),
             co2.A.data_ptr(), co2.B.data_ptr(), co3.A.data_ptr(),
             co3.B.data_ptr(), out.data_ptr(), B, Hin, Win, pad, int(zp),
             Cmid, Cout, co2.lo, co2.hi, mode2.shift, co3.C, co3.lo, co3.hi,
             mode3.shift, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qtail_fused kernel launch failed: CUDA error "
                           f"{err} (a {tuple(a_q.shape)}, Cout={Cout})")
    qtail_folded.launches += 1
    return out


qtail_folded.launches = 0


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
