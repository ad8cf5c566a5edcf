"""K4: fused projection-block tail (port of qtpu/ops/pallas/qproj.py:
qproj_fused and qproj2d_fused).

A ResNet projection block ends in ``conv3(b) + downsample(x)``: two 1×1
GEMMs whose sum feeds relu → requant.  Unfused, the port runs K1 twice and
writes the downsample branch to device memory as f32 for conv3's epilogue
to read back.  ``qproj_folded`` computes, in the order of that K1 pair,

    td  = acc_d·Ad + Bd             (the downsample, dequantized on its own)
    out = clip(round(acc_3·A3 + B3 + td·C), lo, hi) − shift

in one kernel, ``csrc/qproj.cu``, so its codes are bit-identical to the
pair.  The downsample's stride is an address computation on the block input
``x_q``: the caller passes the whole input, not the strided slice.

K4 has two kernels, chosen per call by :func:`k4_path` and counted apart
(``qproj_folded.launches_wgmma``, ``.launches_igemm``):

* ``"wgmma"``: K1's TMA + wgmma ring (``csrc/wgmma_gemm.cuh``) as a
  two-GEMM tile — the downsample's k-stages, then conv3's through one ring,
  td written as f32 into a shared-memory residual tile between the two,
  K1's f32-residual epilogue; at stride 2 the downsample's rows come as TMA
  im2col loads of a 1×1 window (K2's);
* ``"igemm"``: the older ``igemm.cuh`` tile (two ``mma.sync`` mainloops),
  for the rest.

``qproj_folded`` is the kernel wrapper: on a CUDA tensor it launches K4 (or
raises), on a CPU tensor it takes ``qproj_folded_plain``, the unfused K1
pair in plain PyTorch.  Its ``launches`` attributes count kernel launches
and nothing else.  Weights are stored (N, K), as for K1.

``qproj_fused`` (NHWC) and ``qproj2d_fused`` ((M, C) rows) keep qtpu's call
forms: (K, N) weights, the block input already sliced, and the coefficient
rows of :func:`proj_coeffs`.  qtpu's TPU-only arguments are not taken:
``pair`` block-diagonalises the weights for the TPU's 128-lane layout and
adds only zero products, ``bb``/``bm``/``vmem_mb`` size its VMEM blocks and
``interpret`` runs it on the CPU, which the plain version does here.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from qtpu_torch.bench.profile import note_work, recording
from qtpu_torch.ops import _build, qops
from qtpu_torch.ops.qmatmul import check_int8, check_vectors, int_grid
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 9 + (_I,) * 9 + (_F,) * 4 + (_P,)
# the fused kernels' two entries: the Hopper redesign and the older tile
PATHS = ("wgmma", "igemm")
_SYMBOLS = {"wgmma": "qtpu_qproj_fused", "igemm": "qtpu_qproj_fused_igemm"}
# the downsample branch: dequant only (f32, no relu)
DOWN_MODE = EpilogueMode(False, 0.0, False, None)
# the requant the TPU kernels hard-code: affine grid, relu folded into lo
AFFINE_RELU = EpilogueMode(True, 128.0, True, None)


def check_requant(mode: EpilogueMode, what: str) -> None:
    if not mode.requant:
        raise ValueError(f"{what}: the fused kernels emit int8 codes only "
                         "(requant mode)")


def choose(path: Optional[str], auto: str, what: str) -> str:
    """``path`` if given (the older kernel takes any shape), else
    ``auto``."""
    if path is None:
        return auto
    if path not in PATHS or (path == "wgmma" and auto != "wgmma"):
        raise ValueError(f"{what} path {path!r} cannot take these operands "
                         f"(they take {auto!r})")
    return path


def count(fn, path: str) -> None:
    """One launch of ``fn``'s kernel ``path``."""
    fn.launches += 1
    name = f"launches_{path}"
    setattr(fn, name, getattr(fn, name) + 1)


def k4_path(b_q: torch.Tensor, x_q: torch.Tensor, w3_nk: torch.Tensor,
            wd_nk: torch.Tensor, co3: EpilogueCoeffs, mode3: EpilogueMode,
            stride: int) -> str:
    """The kernel K4 takes: ``"wgmma"`` where Cmid and Cin are multiples of
    64 (one 64-byte k-stage each), Cout of 128 (whole 128-wide tiles),
    ``stride`` 1 or 2, every tensor 16-byte aligned (TMA) and the requant
    grid one ``code_bits`` takes (:func:`~qtpu_torch.ops.qmatmul.int_grid`);
    ``"igemm"`` otherwise."""
    cmid, cin, cout = b_q.shape[-1], x_q.shape[-1], w3_nk.shape[0]
    ok = (cmid % 64 == 0 and cin % 64 == 0 and cout % 128 == 0
          and stride in (1, 2) and int_grid(co3.lo, co3.hi, mode3.shift)
          and all(t.data_ptr() % 16 == 0 for t in (b_q, x_q, w3_nk, wd_nk)))
    return "wgmma" if ok else "igemm"


def check_proj(b_q, x_q, w3_nk, wd_nk, stride: int):
    """The shapes of a K4 call (on any device): b_q (B, H, W, Cmid) and
    x_q (B, Hx, Wx, Cin) NHWC with (H, W) = ⌈(Hx, Wx) / stride⌉, stride 1
    or 2, weights (Cout, Cmid) and (Cout, Cin) → (B, H, W, Cmid, Hx, Wx,
    Cin, Cout); raises otherwise."""
    if b_q.dim() != 4 or x_q.dim() != 4:
        raise ValueError(f"b_q and x_q must be NHWC, got {tuple(b_q.shape)} "
                         f"and {tuple(x_q.shape)}")
    B, H, W, Cmid = b_q.shape
    Bx, Hx, Wx, Cin = x_q.shape
    Cout = w3_nk.shape[0]
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} not in (1, 2)")
    if (Bx, -(-Hx // stride), -(-Wx // stride)) != (B, H, W):
        raise ValueError(f"x_q {tuple(x_q.shape)} at stride {stride} does "
                         f"not give b_q's pixels {tuple(b_q.shape)}")
    if (tuple(w3_nk.shape) != (Cout, Cmid)
            or tuple(wd_nk.shape) != (Cout, Cin)):
        raise ValueError(f"weights {tuple(w3_nk.shape)}, "
                         f"{tuple(wd_nk.shape)} do not match ({Cout}, "
                         f"{Cmid}) and ({Cout}, {Cin})")
    return B, H, W, Cmid, Hx, Wx, Cin, Cout


def qproj_folded(b_q: torch.Tensor, x_q: torch.Tensor, w3_nk: torch.Tensor,
                 wd_nk: torch.Tensor, co3: EpilogueCoeffs,
                 mode3: EpilogueMode, cod: EpilogueCoeffs, *,
                 stride: int = 1, path: Optional[str] = None,
                 defines: tuple = ()) -> torch.Tensor:
    """conv3 of the int8 (B, H, W, Cmid) ``b_q`` with the (Cout, Cmid)
    weight, plus the downsample of the block input ``x_q`` (B, Hx, Wx, Cin)
    at ``stride`` with the (Cout, Cin) weight, dequantized on ``cod``, then
    the requant ``co3``/``mode3`` → int8 (B, H, W, Cout).  ``path`` forces
    a kernel (``"igemm"`` takes any shape); ``defines`` selects a probe
    build (``ops/probe_k4.py``)."""
    B, H, W, Cmid, Hx, Wx, Cin, Cout = check_proj(b_q, x_q, w3_nk, wd_nk,
                                                  stride)
    if path not in (None, *PATHS):
        raise ValueError(f"K4 path {path!r}: one of {PATHS}")
    if b_q.device.type == "cpu":
        return qproj_folded_plain(b_q, x_q, w3_nk, wd_nk, co3, mode3, cod,
                                  stride=stride)
    if not b_q.is_cuda:
        raise ValueError(f"unsupported device {b_q.device}")
    dev = b_q.device
    if Cmid % 16 or Cin % 16:
        raise ValueError(f"Cmid {Cmid} and Cin {Cin} must be multiples of 16")
    check_int8(dev, b_q=b_q, x_q=x_q, w3_nk=w3_nk, wd_nk=wd_nk)
    check_vectors(co3, Cout, dev)
    check_vectors(cod, Cout, dev)
    check_requant(mode3, "qproj")
    path = choose(path, k4_path(b_q, x_q, w3_nk, wd_nk, co3, mode3, stride),
                  "K4")
    out = torch.empty((B, H, W, Cout), dtype=torch.int8, device=dev)
    fn = _build.load("qproj", _SYMBOLS[path], _ARGTYPES, defines)
    err = _build.launch(
        fn, dev, b_q.data_ptr(), x_q.data_ptr(), w3_nk.data_ptr(),
        wd_nk.data_ptr(), co3.A.data_ptr(), co3.B.data_ptr(), cod.A.data_ptr(),
        cod.B.data_ptr(), out.data_ptr(), B, H, W, Hx, Wx, stride, Cmid, Cin,
        Cout, co3.C, co3.lo, co3.hi, mode3.shift)
    if err:
        raise RuntimeError(f"qproj_fused kernel ({path}) launch failed: CUDA "
                           f"error {err} (b {tuple(b_q.shape)}, x "
                           f"{tuple(x_q.shape)}, Cout={Cout})")
    count(qproj_folded, path)
    if recording():
        # the downsample reads the strided rows of x only
        M = B * H * W
        note_work(2 * M * Cout * (Cmid + Cin),
                  b_q.numel() + M * Cin + w3_nk.numel() + wd_nk.numel()
                  + out.numel() + 16 * Cout)
    return out


qproj_folded.launches = 0
qproj_folded.launches_wgmma = 0
qproj_folded.launches_igemm = 0


def qproj_folded_plain(b_q: torch.Tensor, x_q: torch.Tensor,
                       w3_nk: torch.Tensor, wd_nk: torch.Tensor,
                       co3: EpilogueCoeffs, mode3: EpilogueMode,
                       cod: EpilogueCoeffs, *, stride: int = 1
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`qproj_folded`: the unfused K1 pair —
    the downsample's exact accumulator dequantized to f32, then conv3's
    with that f32 residual in its folded epilogue."""
    qproj_folded_plain.calls += 1
    return proj_plain(b_q, x_q, w3_nk, wd_nk, co3, mode3, cod, stride=stride)


qproj_folded_plain.calls = 0


def proj_plain(b_q, x_q, w3_nk, wd_nk, co3, mode3, cod, *, stride):
    """The unfused K1 pair of a projection block's tail in plain PyTorch
    (counts nothing; K8's plain version runs it)."""
    B, H, W, Cmid = b_q.shape
    xd = x_q[:, ::stride, ::stride, :]
    td = qops.apply_epilogue(qops.qmatmul(xd.reshape(-1, xd.shape[-1]),
                                          wd_nk.t()),
                             cod, DOWN_MODE, out_dtype=torch.float32)
    acc = qops.qmatmul(b_q.reshape(-1, Cmid), w3_nk.t())
    out = qops.apply_epilogue(acc, co3, mode3, residual=td)
    return out.reshape(B, H, W, -1)


def flat_f32(v: torch.Tensor) -> torch.Tensor:
    """A (1, C) coefficient row as the kernels' contiguous float32 (C,)."""
    return v.reshape(-1).to(torch.float32).contiguous()


def unfold_proj(scalars: torch.Tensor, a3: torch.Tensor, b3: torch.Tensor,
                ad: torch.Tensor, bd: torch.Tensor):
    """qtpu's kernel operands → (co3, mode3, cod) for :func:`qproj_folded`."""
    lo, c = (float(v) for v in scalars.reshape(-1)[:2].tolist())
    co3 = EpilogueCoeffs(A=flat_f32(a3), B=flat_f32(b3), C=c, lo=lo,
                         hi=255.0)
    cod = EpilogueCoeffs(A=flat_f32(ad), B=flat_f32(bd), C=1.0, lo=0.0,
                         hi=0.0)
    return co3, AFFINE_RELU, cod


def qproj_fused(b_q: torch.Tensor, xd_q: torch.Tensor, *, w3: torch.Tensor,
                wd: torch.Tensor, scalars: torch.Tensor, a3: torch.Tensor,
                b3: torch.Tensor, ad: torch.Tensor, bd: torch.Tensor
                ) -> torch.Tensor:
    """qtpu's NHWC call form: conv3(b_q) + downsample(xd_q) → relu →
    requant.  b_q (B, H, W, Cmid), xd_q (B, H, W, Cin) already sliced,
    w3 (Cmid, Cout), wd (Cin, Cout); the rest from :func:`proj_coeffs`."""
    co3, mode3, cod = unfold_proj(scalars, a3, b3, ad, bd)
    return qproj_folded(b_q, xd_q, w3.t().contiguous(), wd.t().contiguous(),
                        co3, mode3, cod)


def qproj2d_fused(b_q: torch.Tensor, xd_q: torch.Tensor, **kw
                  ) -> torch.Tensor:
    """qtpu's 2-D call form: (M, Cmid) and (M, Cin) rows → (M, Cout)."""
    M = b_q.shape[0]
    out = qproj_fused(b_q.reshape(1, M, 1, -1), xd_q.reshape(1, M, 1, -1),
                      **kw)
    return out.reshape(M, -1)


def proj_coeffs(c3: Dict, down: Dict, next_grid) -> Dict[str, torch.Tensor]:
    """qtpu's folded operands for qproj: conv3's coefficients fold the
    requant onto the affine ``next_grid`` (scale, zp) and the relu, with the
    f32 residual's C = 1/scale; the downsample keeps plain dequant
    coefficients."""
    co3, _ = qops.epilogue_coeffs(
        act_scale=c3["act_scale"], act_zp=c3["act_zp"],
        w_scale=c3["w_scale"], colsum=c3["colsum"], bias=c3["bias"],
        requant_scale=next_grid[0], requant_zp=next_grid[1], relu=True,
        res_f32=True)
    cod, _ = qops.epilogue_coeffs(
        act_scale=down["act_scale"], act_zp=down["act_zp"],
        w_scale=down["w_scale"], colsum=down["colsum"], bias=down["bias"])
    return dict(scalars=torch.tensor([[co3.lo, co3.C]], dtype=torch.float32),
                a3=co3.A.reshape(1, -1), b3=co3.B.reshape(1, -1),
                ad=cod.A.reshape(1, -1), bd=cod.B.reshape(1, -1))
