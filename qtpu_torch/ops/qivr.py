"""K9: a chained run of MobileNet-v2 inverted residuals in one launch (port
of qtpu/ops/pallas/qivr.py:qivr_fused).

Per block: expand (1×1, relu6 folded into ``hi``) → requant → depthwise
3×3 (stride 1, zero-point pads) → requant → project (1×1) + the block input
as int8 residual (no relu) → requant onto the next block's expand grid.  The
run is one cooperative launch of ``csrc/qivr.cu``, phases and grid barriers
as K7's (``ops/qstage.py``); the epilogues are the unfused K1 → K3 → K1
sequence's in its order, so the codes are bit-identical to it.

Two kernels, chosen per call by :func:`ivr_path` and counted apart
(``qivr_folded.launches_wgmma``, ``.launches_igemm``):

* ``"wgmma"`` (``csrc/qivr_wg.cu`` on ``csrc/wgmma_phase.cuh``) for
  requant grids ``code_bits`` takes and 16-byte aligned tensors: two
  phases a block — the expand on K1's TMA + wgmma tile, then on 8×8 output
  tiles the depthwise on CUDA cores from TMA-loaded 64-channel halo stages
  straight into shared memory and the project with the int8 residual on
  wgmma, no depthwise workspace — or, where the 8×8 tiles are few, three
  (the depthwise alone on (tile, 64-channel) units into a workspace, the
  project on K1's tile).  Rows of C bytes that TMA cannot address (C not
  a multiple of 16: MobileNet-v2's block2, C = 24) come as bulk copies and
  3D maps (:func:`narrow_rows`), in the fused mode;
* ``"igemm"``, the older kernel (three phases, ``csrc/qivr.cu``), for the
  rest.

``qivr_folded`` is the kernel wrapper: on a CUDA tensor it launches K9 (or
raises), on a CPU tensor it takes ``qivr_folded_plain``, that unfused
sequence per block in plain PyTorch.  Its ``launches`` attribute counts
kernel launches and nothing else.  Weights are stacked per block: expand
(N, E, C) and project (N, C, E) in the (N, K) layout, the depthwise taps
(N, 9, E); the coefficients in a :class:`~qtpu_torch.ops.qstage.
ChainCoeffs` whose ``zp`` is the depthwise pad.  Both kernels take E a
multiple of 16 (6·C for every MobileNet-v2 width, C being a multiple of
8); the older one any C (gathered bytewise where C % 16 ≠ 0).

``qivr_fused`` keeps qtpu's call form with its (K, N) weights and the
operands of :func:`ivr_coeffs` / :func:`stack_ivr_weights`; qtpu's TPU-only
``k``, ``interpret`` and ``vmem_mb`` are not taken.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from qtpu_torch.ops import _build, chain_plan as cp, qops
from qtpu_torch.ops.qmatmul import check_int8
from qtpu_torch.ops.qstage import (ChainCoeffs, barrier_words, check_chain,
                                   chain_from_rows, int_grids, plan_args,
                                   resolve_plan)
from qtpu_torch.ops.qtail import _sm_count, choose, count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 14 + (_I,) * 7 + (_P,)
# the wgmma entry: the old one's arguments but vec_c, then the plan
_WG_ARGTYPES = (_P,) * 14 + (_I,) * 6 + (_I,) * 7 + (_P,)
_SYMBOLS = {"wgmma": ("qivr_wg", "qtpu_qivr_fused_wg"),
            "igemm": ("qivr", "qtpu_qivr_fused")}


def narrow_rows(B: int, H: int, W: int, c: int) -> bool:
    """Whether the runner takes C-byte rows that are no TMA tensor (C not a
    multiple of 16): as bulk copies of whole rows and 3D maps of (b, y,
    x·C), so C a multiple of 8 up to 32 (an 8×8 tile's 8·C-byte row is one
    TMA box dimension, at most 256) and every run of rows a multiple of 16
    bytes."""
    return (c % 16 != 0 and c % 8 == 0 and c <= 32 and (W * c) % 16 == 0
            and (B * H * W * c) % 16 == 0)


def ivr_path(B: int, H: int, W: int, c: int, e: int, co: ChainCoeffs,
             *tensors: torch.Tensor, sms: int) -> str:
    """The kernel K9 takes: ``"wgmma"`` for C a multiple of 16 or narrow
    rows (:func:`narrow_rows`: MobileNet-v2's block2, C = 24), E a multiple
    of 16, grids ``code_bits`` takes, 16-byte aligned ``tensors`` (TMA)
    and a plan that fits; ``"igemm"`` otherwise."""
    ok = ((c % 16 == 0 or narrow_rows(B, H, W, c)) and e % 16 == 0
          and int_grids(co)
          and all(t.data_ptr() % 16 == 0 for t in tensors)
          and cp.chain_plan("ivr", B, H, W, c, e, sms=sms) is not None)
    return "wgmma" if ok else "igemm"


def qivr_folded(x_q: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
                w3: torch.Tensor, co: ChainCoeffs, *,
                path: Optional[str] = None,
                plan: Optional[cp.ChainPlan] = None,
                defines: tuple = ()) -> torch.Tensor:
    """N chained inverted residuals on the int8 (B, H, W, C) ``x_q`` with
    the stacked weights (N, E, C), (N, 9, E), (N, C, E) and coefficients
    ``co`` → int8 (B, H, W, C).  ``path`` forces a kernel (``"igemm"``
    takes any shape), ``plan`` the wgmma kernel's plan
    (:func:`~qtpu_torch.ops.qstage.resolve_plan`); ``defines`` selects a
    probe build (``ops/probe_chain.py``)."""
    if x_q.device.type == "cpu":
        return qivr_folded_plain(x_q, w1, wd, w3, co)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    dev = x_q.device
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be NHWC, got {tuple(x_q.shape)}")
    B, H, W, C = x_q.shape
    n, E = w1.shape[:2]
    if n < 1:
        raise ValueError("a run needs at least one block")
    if (tuple(w1.shape) != (n, E, C) or tuple(wd.shape) != (n, 9, E)
            or tuple(w3.shape) != (n, C, E)):
        raise ValueError(f"run weights {tuple(w1.shape)}, {tuple(wd.shape)}, "
                         f"{tuple(w3.shape)} do not match ({n}, {E}, {C}), "
                         f"({n}, 9, {E}), ({n}, {C}, {E})")
    if E % 16:
        raise ValueError(f"expanded width {E} must be a multiple of 16")
    check_int8(dev, x_q=x_q, w1=w1, wd=wd, w3=w3)
    check_chain(co, n, E, C, dev)
    M = B * H * W
    out = torch.empty_like(x_q)
    sms = _sm_count(dev.index)
    path = choose(path, ivr_path(B, H, W, C, E, co, x_q, w1, wd, w3, out,
                                 sms=sms), "K9")
    pl = resolve_plan(plan, path, "ivr", B, H, W, C, E, sms)
    plan = () if pl is None else plan_args(pl)
    # the expand's codes (e), the depthwise's (d; not in the runner's fused
    # mode), block outputs
    nws = 1 if pl is not None and pl.mode == "fused" else 2
    ws = torch.empty(M * E * nws + (M * C if n > 1 else 0),
                     dtype=torch.int8, device=dev)
    lib, sym = _SYMBOLS[path]
    fn = _build.load(lib, sym, _WG_ARGTYPES if path == "wgmma" else
                     _ARGTYPES, defines)
    args = (x_q.data_ptr(), w1.data_ptr(), wd.data_ptr(), w3.data_ptr(),
            co.a1.data_ptr(), co.b1.data_ptr(), co.a2.data_ptr(),
            co.b2.data_ptr(), co.a3.data_ptr(), co.b3.data_ptr(),
            co.scal.data_ptr(), out.data_ptr(), ws.data_ptr(),
            barrier_words(dev).data_ptr(), B, H, W, n, C, E)
    if path == "wgmma":
        err = _build.launch(fn, dev, *args, *plan)
    else:
        err = _build.launch(fn, dev, *args, int(C % 16 == 0))
    if err:
        raise RuntimeError(f"qivr_fused kernel ({path}) launch failed: CUDA "
                           f"error {err} (x {tuple(x_q.shape)}, {n} blocks, "
                           f"E={E}, plan {plan})")
    count(qivr_folded, path)
    return out


qivr_folded.launches = 0
qivr_folded.launches_wgmma = 0
qivr_folded.launches_igemm = 0


def qivr_folded_plain(x_q: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
                      w3: torch.Tensor, co: ChainCoeffs) -> torch.Tensor:
    """Plain PyTorch version of :func:`qivr_folded`: per block the expand's
    exact accumulator and requant, the depthwise's exact int32 tap sum on
    the zero-point-padded codes and its requant, the project's accumulator
    with the int8 residual and requant (the K1 → K3 → K1 sequence)."""
    qivr_folded_plain.calls += 1
    B, H, W, C = x_q.shape
    for i in range(w1.shape[0]):
        (co1, m1), (co2, m2), (co3, m3), zp = co.block(i)
        x2 = x_q.reshape(-1, C)
        e = qops.apply_epilogue(qops.qmatmul(x2, w1[i].t()), co1, m1)
        ep = qops.pad_nhwc(e.reshape(B, H, W, -1), ((1, 1), (1, 1)), zp)
        d = qops.apply_epilogue(
            qops.depthwise_acc(ep, wd[i].reshape(3, 3, 1, -1)), co2, m2)
        acc = qops.qmatmul(d.reshape(x2.shape[0], -1), w3[i].t())
        x_q = qops.apply_epilogue(acc, co3, m3,
                                  residual=x2).reshape(B, H, W, C)
    return x_q


qivr_folded_plain.calls = 0


def qivr_fused(x_q: torch.Tensor, *, w1: torch.Tensor, wd: torch.Tensor,
               w3: torch.Tensor, scalars: torch.Tensor, a1: torch.Tensor,
               b1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
               a3: torch.Tensor, b3: torch.Tensor, h: int, w: int
               ) -> torch.Tensor:
    """qtpu's call form: x_q (B·h·w, C) rows of NHWC images; w1 (N, C, E),
    wd (N·9, E) tap rows in (dy, dx) order, w3 (N, E, C); ``scalars`` (N, 8)
    = [lo1, hi1, lo2, hi2, lo3, hi3, C, zp_dw] and the rows of
    :func:`ivr_coeffs` → (B·h·w, C) codes."""
    M, c = x_q.shape
    n, _, e = w1.shape
    rows = [(lo1, hi1, 128.0, lo2, hi2, 128.0, lo3, hi3, 128.0, cr, zp, 0.0)
            for lo1, hi1, lo2, hi2, lo3, hi3, cr, zp
            in scalars.reshape(n, -1).tolist()]
    co = chain_from_rows(rows, a1, b1, a2, b2, a3, b3)
    out = qivr_folded(x_q.reshape(M // (h * w), h, w, c),
                      w1.transpose(1, 2).contiguous(),
                      wd.reshape(n, 9, e).contiguous(),
                      w3.transpose(1, 2).contiguous(), co)
    return out.reshape(M, c)


def ivr_coeffs(blocks: Sequence[Tuple[Dict, Dict, Dict]], next_grid,
               act_max: float = 6.0) -> Dict[str, torch.Tensor]:
    """qtpu's stacked operands for a run of identity inverted residuals
    [(expand, dw, project), ...] (frozen nodes): block i requantised onto
    block i+1's expand grid, the last onto the affine ``next_grid`` (scale,
    zp); relu6 (``act_max``) folded into the hi clips of expand and
    depthwise, no relu on the project (linear bottleneck)."""
    outs: Dict[str, List[torch.Tensor]] = {k: [] for k in (
        "scalars", "a1", "b1", "a2", "b2", "a3", "b3")}

    def fold(node, **kw):
        return qops.epilogue_coeffs(
            act_scale=node["act_scale"], act_zp=node["act_zp"],
            w_scale=node["w_scale"], colsum=node["colsum"],
            bias=node["bias"], **kw)[0]
    for i, (c1, c2, c3) in enumerate(blocks):
        tgt = ((blocks[i + 1][0]["act_scale"], blocks[i + 1][0]["act_zp"])
               if i + 1 < len(blocks) else next_grid)
        co1 = fold(c1, requant_scale=c2["act_scale"],
                   requant_zp=c2["act_zp"], relu=True, act_max=act_max)
        co2 = fold(c2, requant_scale=c3["act_scale"],
                   requant_zp=c3["act_zp"], relu=True, act_max=act_max)
        co3 = fold(c3, requant_scale=tgt[0], requant_zp=tgt[1], relu=False,
                   res_scale=c1["act_scale"], res_zp=c1["act_zp"])
        outs["scalars"].append(torch.tensor(
            [[co1.lo, co1.hi, co2.lo, co2.hi, co3.lo, co3.hi, co3.C,
              float(c2["act_zp"])]], dtype=torch.float32))
        for k, co in (("1", co1), ("2", co2), ("3", co3)):
            outs["a" + k].append(co.A.reshape(1, -1))
            outs["b" + k].append(co.B.reshape(1, -1))
    return {k: torch.cat(v, dim=0) for k, v in outs.items()}


def stack_ivr_weights(blocks: Sequence[Tuple[Dict, Dict, Dict]]
                      ) -> Dict[str, torch.Tensor]:
    """qtpu's stacked int8 weights of a run from frozen nodes: w1 (N, C, E),
    the (3, 3, 1, E) depthwise kernels as (N·9, E) tap rows, w3 (N, E, C)."""
    from qtpu_torch.serve.fused_ops import unpacked_kernel

    c, e = unpacked_kernel(blocks[0][0]).shape[-2:]
    return dict(
        w1=torch.stack([unpacked_kernel(c1).reshape(c, e)
                        for c1, _, _ in blocks]),
        wd=torch.cat([unpacked_kernel(c2).reshape(9, e)
                      for _, c2, _ in blocks]),
        w3=torch.stack([unpacked_kernel(c3).reshape(e, c)
                        for _, _, c3 in blocks]))
