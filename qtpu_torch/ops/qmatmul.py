"""K1: fused int8 matmul with the folded epilogue (port of
qtpu/ops/pallas/qmatmul.py:qmatmul_fused).

``qmatmul_folded`` is the kernel wrapper: on a CUDA tensor it launches the
hand-written kernel of ``csrc/qmatmul.cu`` (or raises), on a CPU tensor it
takes ``qmatmul_folded_plain``, the same function in plain PyTorch.  Its
``launches`` attribute counts kernel launches and nothing else.

Two kernels compute K1, chosen per call by :func:`k1_path` from what the
operands allow (a deliberate dispatch, never a fallback after a failure):
``"wgmma"`` (``csrc/wgmma_gemm.cuh``: TMA loads, ``wgmma`` s8, a
persistent grid, a coalesced epilogue) wherever TMA can address every
operand — each base 16-byte aligned and each row (x, the weight, the
output, the residual) a multiple of 16 bytes — and whose requant grid, if
any, has integer bounds and a shift of 0 or 128 (every grid of a frozen
tree), and ``"igemm"`` (``csrc/igemm.cuh``'s ``mma.sync`` loop) for the
rest (MobileNet-v2's K = 24 and N = 24 GEMMs).  ``launches_wgmma`` and
``launches_igemm`` count each; ``launches`` stays their sum.  ``path=``
forces one (the old loop for a comparison; the new one raises on
operands it cannot take).

The weight is stored (N, K), K-contiguous — the kernel's layout, prepared
once at engine build.  ``qmatmul_fused`` keeps qtpu's call form: a (K, N)
weight and the unfolded grid arguments, folded here with
:func:`qtpu_torch.ops.qops.epilogue_coeffs`.

``raw_acc=True`` returns the int32 accumulator (the fc path: its exact
``dequant_epilogue`` runs on the integer sum).

int4 weights (qtpu's ``w_packed=True`` mode): ``qmatmul_folded_w4`` takes
the weight nibble-packed along K (:func:`pack_int4_nk`, (N, K/2) bytes) and
launches the int4 entry of the same kernel, which unpacks in the kernel; its
own ``launches`` count keeps int4 launches apart from int8 ones.
``qmatmul_fused(w_packed=True, bn=...)`` keeps qtpu's call form, a
:func:`pack_int4_halves` weight, and repacks it for the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from qtpu_torch.ops import _build, qops
from qtpu_torch.ops import fakequant as fq
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
             _F, _F, _F, _F, _I, _I, _F, _P)
OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.int32: 2}
RES_KIND = {None: 0, torch.int8: 1, torch.float32: 2}


def out_dtype_of(mode: Optional[EpilogueMode], out_dtype: torch.dtype,
                 raw_acc: bool) -> torch.dtype:
    """int32 for the raw accumulator, int8 codes for requant, else f32."""
    if raw_acc:
        return torch.int32
    if mode.requant:
        return torch.int8
    if out_dtype != torch.float32:
        raise ValueError(f"f32-mode output must be float32, got {out_dtype}")
    return out_dtype


def launch_args(co: Optional[EpilogueCoeffs], mode: Optional[EpilogueMode]
                ) -> Tuple:
    """(A, B, C, lo, hi, shift, relu, use_act_max, act_max) for the C entry."""
    if co is None:
        return None, None, 0.0, 0.0, 0.0, 0.0, 0, 0, 0.0
    act_max = mode.act_max if (mode.act_max is not None
                               and not mode.requant) else None
    return (co.A.data_ptr(), co.B.data_ptr(), co.C, co.lo, co.hi,
            mode.shift, int(mode.relu), int(act_max is not None),
            float(act_max or 0.0))


def check_vectors(co: Optional[EpilogueCoeffs], n: int,
                  device: torch.device) -> None:
    if co is None:
        return
    for name, v in (("A", co.A), ("B", co.B)):
        if (v.device != device or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != (n,)):
            raise ValueError(f"epilogue {name} must be a contiguous float32 "
                             f"({n},) tensor on {device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def check_int8(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous int8 on ``dev`` and 16-byte
    aligned (the fused kernels load 16-byte chunks)."""
    for name, t in tensors.items():
        if (t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"int8 tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")


def check_residual(residual: Optional[torch.Tensor], shape: Tuple[int, ...],
                   device: torch.device) -> int:
    """The C entries' residual kind (0 none, 1 int8, 2 f32); raises on a
    residual the kernels do not take."""
    if residual is None:
        return RES_KIND[None]
    if (residual.dtype not in (torch.int8, torch.float32)
            or tuple(residual.shape) != tuple(shape)
            or not residual.is_contiguous() or residual.device != device):
        raise ValueError(f"residual must be a contiguous int8 or float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    return RES_KIND[residual.dtype]


def qmatmul_folded(x_q: torch.Tensor, w_nk: torch.Tensor,
                   co: Optional[EpilogueCoeffs],
                   mode: Optional[EpilogueMode],
                   residual: Optional[torch.Tensor] = None, *,
                   out_dtype: torch.dtype = torch.float32,
                   raw_acc: bool = False,
                   path: Optional[str] = None) -> torch.Tensor:
    """int8 (M, K) × int8 (N, K)ᵀ → epilogue(acc) (M, N)."""
    if x_q.device.type == "cpu":
        return qmatmul_folded_plain(x_q, w_nk, co, mode, residual,
                                    out_dtype=out_dtype, raw_acc=raw_acc)
    res_kind = _check(x_q, w_nk, "w_nk", w_nk.shape[1], co, residual,
                      raw_acc)
    path = _path(path, x_q, w_nk, co, mode, out_dtype, raw_acc, residual)
    out = _launch(_SYMBOLS[False, path], x_q, w_nk, co, mode, residual,
                  res_kind, out_dtype, raw_acc)
    _count(qmatmul_folded, path)
    return out


qmatmul_folded.launches = 0
qmatmul_folded.launches_wgmma = 0
qmatmul_folded.launches_igemm = 0
PATHS = ("wgmma", "igemm")
_SYMBOLS = {(False, "wgmma"): "qtpu_qmatmul_fused",
            (False, "igemm"): "qtpu_qmatmul_fused_igemm",
            (True, "wgmma"): "qtpu_qmatmul_fused_w4",
            (True, "igemm"): "qtpu_qmatmul_fused_w4_igemm"}


def int_grid(lo: float, hi: float, shift: float) -> bool:
    """Whether the wgmma kernels' conversion-free requant (epilogue.cuh:
    code_bits) takes a requant grid: integer ``lo``, ``hi`` below 2^21 in
    magnitude, ``shift`` 0 or 128."""
    return shift in (0.0, 128.0) and all(
        abs(v) <= 2 ** 21 and float(v).is_integer() for v in (lo, hi))


def k1_path(x_q: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
            residual: Optional[torch.Tensor],
            co: Optional[EpilogueCoeffs] = None,
            mode: Optional[EpilogueMode] = None) -> str:
    """The kernel K1 takes for these operands (``w``: int8 (N, K) or
    packed int4 (N, K/2); ``out_dtype`` the output's; ``co``/``mode`` the
    folded epilogue): ``"wgmma"`` when TMA can address each of them — every
    base 16-byte aligned, every row a multiple of 16 bytes — and a requant
    grid has integer ``lo`` and ``hi`` and a ``shift`` of 0 or 128 (the
    wgmma epilogue rounds after the clip), else ``"igemm"``."""
    if (out_dtype == torch.int8 and co is not None and mode is not None
            and not int_grid(co.lo, co.hi, mode.shift)):
        return "igemm"
    N = w.shape[0]
    rows = [(x_q, x_q.shape[1]), (w, w.shape[1]),
            (None, N * torch.empty((), dtype=out_dtype).element_size())]
    if residual is not None:
        rows.append((residual, N * residual.element_size()))
    ok = all(nbytes % 16 == 0 and (t is None or t.data_ptr() % 16 == 0)
             for t, nbytes in rows)
    return "wgmma" if ok else "igemm"


def _path(path: Optional[str], x_q, w, co, mode, out_dtype, raw_acc,
          residual) -> str:
    auto = k1_path(x_q, w, out_dtype_of(mode, out_dtype, raw_acc), residual,
                   co, mode)
    if path is None:
        return auto
    if path not in PATHS or (path == "wgmma" and auto != "wgmma"):
        raise ValueError(f"K1 path {path!r} cannot take these operands "
                         f"(they take {auto!r})")
    return path


def _count(wrapper, path: str) -> None:
    wrapper.launches += 1
    name = f"launches_{path}"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _check(x_q: torch.Tensor, w: torch.Tensor, wname: str, w_k: int,
           co: Optional[EpilogueCoeffs], residual: Optional[torch.Tensor],
           raw_acc: bool) -> int:
    """Raise on operands K1 does not take (``w_k``: the K the weight
    holds); returns the residual kind."""
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    M, K = x_q.shape
    N = w.shape[0]
    dev = x_q.device
    if K != w_k:
        raise ValueError(f"K mismatch: x {tuple(x_q.shape)}, {wname} "
                         f"{tuple(w.shape)}")
    for name, t in (("x_q", x_q), (wname, w)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int8 tensor on {dev}")
    if not raw_acc:
        check_vectors(co, N, dev)
    return check_residual(residual, (M, N), dev)


def _launch(symbol: str, x_q: torch.Tensor, w: torch.Tensor,
            co: Optional[EpilogueCoeffs], mode: Optional[EpilogueMode],
            residual: Optional[torch.Tensor], res_kind: int,
            out_dtype: torch.dtype, raw_acc: bool) -> torch.Tensor:
    """Allocate the output and launch K1's C entry ``symbol`` (the int8 or
    the int4 one: the same arguments)."""
    M, K = x_q.shape
    N = w.shape[0]
    dev = x_q.device
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    out = torch.empty((M, N), dtype=odt, device=dev)
    A, B, C, lo, hi, shift, relu, use_am, am = launch_args(
        None if raw_acc else co, mode)
    fn = _build.load("qmatmul", symbol, _ARGTYPES)
    err = _build.launch(
        fn, dev, x_q.data_ptr(), w.data_ptr(), A, B,
        None if residual is None else residual.data_ptr(), res_kind,
        out.data_ptr(), OUT_KIND[odt], M, N, K, C, lo, hi, shift, relu,
        use_am, am)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K})")
    return out


def qmatmul_folded_plain(x_q: torch.Tensor, w_nk: torch.Tensor,
                         co: Optional[EpilogueCoeffs],
                         mode: Optional[EpilogueMode],
                         residual: Optional[torch.Tensor] = None, *,
                         out_dtype: torch.dtype = torch.float32,
                         raw_acc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qmatmul_folded` (exact float64
    accumulator, then the folded epilogue step by step)."""
    qmatmul_folded_plain.calls += 1
    acc = qops.qmatmul(x_q, w_nk.t())
    odt = out_dtype_of(mode, out_dtype, raw_acc)
    if raw_acc:
        return acc
    return qops.apply_epilogue(acc, co, mode, residual=residual,
                               out_dtype=odt)


qmatmul_folded_plain.calls = 0


# -- int4 weights (qtpu's w_packed mode) ------------------------------------------

def pack_int4_nk(w_nk: torch.Tensor) -> torch.Tensor:
    """The int4 entry's weight layout: int8-held int4 codes (N, K), values
    in ±7, packed along K into (N, K/2) bytes — low nibble k even, high
    nibble k odd.  Raises on odd K."""
    if w_nk.dim() != 2 or w_nk.shape[1] % 2:
        raise ValueError(f"pack_int4_nk needs an (N, K) weight with even K, "
                         f"got {tuple(w_nk.shape)}")
    return fq.pack_int4(w_nk, axis=-1)


def pack_int4_halves(w: torch.Tensor, bn: int) -> torch.Tensor:
    """qtpu's tile-halves layout (qtpu/ops/pallas/qmatmul.py:
    pack_int4_halves): int8-held int4 codes (K, N) → (K, N/2) bytes; within
    each ``bn``-column tile, byte t holds tile column t (low nibble) and
    tile column t + bn/2 (high nibble).  Needs N % bn == 0 and an even bn
    (qtpu also asks (bn/2) % 128 == 0, its TPU lane rule)."""
    K, N = w.shape
    if bn % 2 or N % bn:
        raise ValueError(f"pack_int4_halves: N={N} does not tile by an even "
                         f"bn={bn}")
    t = w.reshape(K, N // bn, 2, bn // 2)
    lo, hi = t[:, :, 0, :], t[:, :, 1, :]
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8).reshape(K, N // 2)


def unpack_int4_halves(wp: torch.Tensor, bn: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_halves`: (K, N/2) bytes → int8 (K, N),
    each nibble sign-extended."""
    K, half_n = wp.shape
    t = wp.reshape(K, half_n * 2 // bn, bn // 2)
    lo = (t << 4) >> 4
    hi = t >> 4
    return torch.stack([lo, hi], dim=2).reshape(K, half_n * 2)


def qmatmul_folded_w4(x_q: torch.Tensor, w_nk4: torch.Tensor,
                      co: Optional[EpilogueCoeffs],
                      mode: Optional[EpilogueMode],
                      residual: Optional[torch.Tensor] = None, *,
                      out_dtype: torch.dtype = torch.float32,
                      raw_acc: bool = False,
                      path: Optional[str] = None) -> torch.Tensor:
    """int8 (M, K) × int4 (N, K)ᵀ → epilogue(acc) (M, N), the weight packed
    by :func:`pack_int4_nk` ((N, K/2) bytes) and unpacked in the kernel.
    Raises on odd K."""
    if x_q.shape[-1] % 2:
        raise ValueError(f"the int4 entry needs an even K, got x "
                         f"{tuple(x_q.shape)}")
    if x_q.device.type == "cpu":
        return qmatmul_folded_w4_plain(x_q, w_nk4, co, mode, residual,
                                       out_dtype=out_dtype, raw_acc=raw_acc)
    res_kind = _check(x_q, w_nk4, "w_nk4", 2 * w_nk4.shape[1], co, residual,
                      raw_acc)
    path = _path(path, x_q, w_nk4, co, mode, out_dtype, raw_acc, residual)
    out = _launch(_SYMBOLS[True, path], x_q, w_nk4, co, mode, residual,
                  res_kind, out_dtype, raw_acc)
    _count(qmatmul_folded_w4, path)
    return out


qmatmul_folded_w4.launches = 0
qmatmul_folded_w4.launches_wgmma = 0
qmatmul_folded_w4.launches_igemm = 0


def qmatmul_folded_w4_plain(x_q: torch.Tensor, w_nk4: torch.Tensor,
                            co: Optional[EpilogueCoeffs],
                            mode: Optional[EpilogueMode],
                            residual: Optional[torch.Tensor] = None, *,
                            out_dtype: torch.dtype = torch.float32,
                            raw_acc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qmatmul_folded_w4`: unpack, then
    :func:`qmatmul_folded_plain`."""
    qmatmul_folded_w4_plain.calls += 1
    return qmatmul_folded_plain(x_q, fq.unpack_int4(w_nk4, axis=-1), co,
                                mode, residual, out_dtype=out_dtype,
                                raw_acc=raw_acc)


qmatmul_folded_w4_plain.calls = 0


def fold(*, act_scale, act_zp, w_scale, colsum, bias=None,
         requant_scale=None, requant_zp=None, residual=None, res_scale=None,
         res_zp=None, relu=False, act_max=None
         ) -> Tuple[EpilogueCoeffs, EpilogueMode]:
    """qtpu's kernel-side folding: an int8 residual brings its grid, an f32
    residual is added at unit scale before the requant."""
    res_int8 = residual is not None and residual.dtype == torch.int8
    return qops.epilogue_coeffs(
        act_scale=act_scale, act_zp=act_zp, w_scale=w_scale, colsum=colsum,
        bias=bias, requant_scale=requant_scale, requant_zp=requant_zp,
        relu=relu, act_max=act_max,
        res_scale=res_scale if res_int8 else None,
        res_zp=res_zp if res_int8 else None,
        res_f32=residual is not None and not res_int8)


def qmatmul_fused(x_q: torch.Tensor, w_q: torch.Tensor, *, act_scale,
                  act_zp, w_scale, colsum, bias=None, requant_scale=None,
                  requant_zp=None, residual=None, res_scale=None,
                  res_zp=None, out_dtype: torch.dtype = torch.float32,
                  relu: bool = False, act_max: Optional[float] = None,
                  raw_acc: bool = False, w_packed: bool = False,
                  bn: Optional[int] = None) -> torch.Tensor:
    """qtpu's call form: int8 (M, K) × int8 (K, N) → (M, N) with the fused
    epilogue (int8 codes when ``requant_scale`` is given).  ``w_packed``:
    ``w_q`` is qtpu's :func:`pack_int4_halves` (K, N/2) at tile width
    ``bn`` (qtpu's default 512, at most N), repacked by
    :func:`pack_int4_nk` for the int4 entry; an odd K gets a zero column of
    ``x_q`` and a zero weight row first (the accumulator and ``colsum`` do
    not change)."""
    co, mode = fold(act_scale=act_scale, act_zp=act_zp, w_scale=w_scale,
                    colsum=colsum, bias=bias, requant_scale=requant_scale,
                    requant_zp=requant_zp, residual=residual,
                    res_scale=res_scale, res_zp=res_zp, relu=relu,
                    act_max=act_max)
    if w_packed:
        w_nk = unpack_int4_halves(w_q, min(bn or 512, 2 * w_q.shape[1])).t()
        if x_q.shape[1] % 2:
            x_q = torch.cat([x_q, x_q.new_zeros(x_q.shape[0], 1)], 1)
            w_nk = torch.cat([w_nk, w_nk.new_zeros(w_nk.shape[0], 1)], 1)
        return qmatmul_folded_w4(x_q, pack_int4_nk(w_nk.contiguous()), co,
                                 mode, residual, out_dtype=out_dtype,
                                 raw_acc=raw_acc)
    return qmatmul_folded(x_q, w_q.t().contiguous(), co, mode, residual,
                          out_dtype=out_dtype, raw_acc=raw_acc)


def qmatmul_fused_plain(x_q: torch.Tensor, w_q: torch.Tensor, **kw
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`qmatmul_fused` (same arguments, an
    int8 weight)."""
    raw_acc = kw.pop("raw_acc", False)
    out_dtype = kw.pop("out_dtype", torch.float32)
    co, mode = fold(**kw)
    return qmatmul_folded_plain(x_q, w_q.t().contiguous(), co, mode,
                                kw.get("residual"), out_dtype=out_dtype,
                                raw_acc=raw_acc)
