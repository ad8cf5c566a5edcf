"""K7 and K8: a chained run of identity bottlenecks, and a whole stride-1
stage, each in one launch (port of qtpu/ops/pallas/qstage.py:qstage_fused
and qstage_proj_fused).

A run of N identity bottlenecks — conv1 (1×1) → requant → conv2 (3×3,
stride 1, zero-point pads) → requant → conv3 (1×1) + the block input as
int8 residual → relu → requant, each block requantising onto the next
block's conv1 grid — runs as one cooperative launch of ``csrc/qstage.cu``:
a persistent grid whose phases are the convs, with a grid-wide barrier
between them and the intermediate codes in a device workspace.  K8 first
runs a stride-1 projection block (conv1, conv2, then conv3 + downsample in
K4's order) and then the run.  The epilogues are the unfused sequence's in
its order, so the codes are bit-identical to it.

K7 has two kernels, chosen per call by :func:`stage_path` and counted
apart (``qstage_folded.launches_wgmma``, ``.launches_igemm``):

* ``"wgmma"`` (``csrc/qstage_wg.cu`` on ``csrc/wgmma_phase.cuh``) for Cin a
  multiple of 128, Cmid of 64, requant grids ``code_bits`` takes and
  16-byte aligned tensors: two phases a block on Hopper's TMA + wgmma tiles
  — conv1 on K1's tile, then K5's tile (conv2 straight from a TMA-loaded
  halo, conv3 with the residual) — or, where the 8×8 tiles are few, three
  (conv2 alone on (tile, channel pass) units, conv3 on K1's tile);
  :func:`qtpu_torch.ops.chain_plan.chain_plan` chooses;
* ``"igemm"``, the older kernel (three phases of ``igemm.cuh``'s
  ``mma.sync`` loop, ``csrc/qstage.cu``), for the rest.

K8 likewise, chosen by :func:`stage_proj_path` and counted apart
(``qstage_proj_folded.launches_wgmma``, ``.launches_igemm``):

* ``"wgmma"`` (``csrc/qstage_proj_wg.cu``, the runner's instantiation of
  its own) for Cp a multiple of 64, Cm = Cmid a multiple of 64, Co of 128,
  grids ``code_bits`` takes, 16-byte aligned tensors and at least one
  chained block: the projection block as three phases ahead of K7's chain
  — conv1 on K1's tile, conv2 on split mode's units, conv3 + downsample on
  the two-GEMM tile (the downsample's f32 td in shared memory between the
  two products) — planned by ``chain_plan("stage_proj", ...)``;
* ``"igemm"``, the older kernel's phases (``csrc/qstage.cu``), for the
  rest.

``qstage_folded`` / ``qstage_proj_folded`` are the kernel wrappers: on a
CUDA tensor they launch K7 / K8 (or raise), on a CPU tensor they take
``qstage_folded_plain`` / ``qstage_proj_folded_plain``, the unfused K1 → K2
→ K1 chain (``qblock.block_plain``; for K8 first K1 → K2 →
``qproj.proj_plain``) in plain PyTorch.  Their ``launches`` attributes count
kernel launches and nothing else.  Weights are stacked per block in the
kernels' (N, K) layout: conv1 (N, Cmid, Cin), conv2 (N, Cmid, 9·Cmid),
conv3 (N, Cin, Cmid); the coefficients in a :class:`ChainCoeffs`.

``qstage_fused`` and ``qstage_proj_fused`` keep qtpu's call forms: (B·H·W,
C) rows, (K, N) weights and the operands of :func:`stage_coeffs` /
:func:`proj_stage_coeffs`; qtpu's TPU-only ``k`` (images per grid step),
``interpret`` and ``vmem_mb`` are not taken.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from qtpu_torch.bench.profile import note_work, recording
from qtpu_torch.ops import _build, chain_plan as cp, qops
from qtpu_torch.ops.qblock import block_coeffs, block_plain
from qtpu_torch.ops.qmatmul import check_int8, check_vectors, int_grid
from qtpu_torch.ops.qops import EpilogueCoeffs, EpilogueMode
from qtpu_torch.ops.qproj import check_requant, proj_coeffs, proj_plain
from qtpu_torch.ops.qtail import _sm_count, choose, count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 14 + (_I,) * 7 + (_P,)
# the wgmma entry: the old one's arguments, then the plan (mode, w, tm,
# stages, nres, smem, grid)
_WG_ARGTYPES = (_P,) * 14 + (_I,) * 6 + (_I,) * 7 + (_P,)
_SYMBOLS = {"wgmma": ("qstage_wg", "qtpu_qstage_fused_wg"),
            "igemm": ("qstage", "qtpu_qstage_fused")}
_PROJ_ARGTYPES = (_P,) * 27 + (_I,) * 9 + (_P,)
# K8's wgmma entry: the old one's arguments but vec, then the plan
_PROJ_WG_ARGTYPES = (_P,) * 27 + (_I,) * 8 + (_I,) * 7 + (_P,)
_PROJ_SYMBOLS = {"wgmma": ("qstage_proj_wg", "qtpu_qstage_proj_fused_wg"),
                 "igemm": ("qstage", "qtpu_qstage_proj_fused")}
# scalars per block: lo/hi/shift of the three convs, C3, the pad zero point
NSCAL = 12
ConvCoeffs = Tuple[EpilogueCoeffs, EpilogueMode]


class ChainCoeffs(NamedTuple):
    """The folded coefficients of N chained blocks of three convs, stacked
    for the kernels: the (N, C) ``A``/``B`` rows of each conv and ``scal``
    (N, 12) = [lo1, hi1, shift1, lo2, hi2, shift2, lo3, hi3, shift3, C3,
    zp, 0] on the coefficients' device; ``rows`` holds the same scalars as
    Python floats for the plain versions.  ``zp`` is the zero point of the
    middle conv's pads, C3 the weight of the last conv's residual."""
    a1: torch.Tensor
    b1: torch.Tensor
    a2: torch.Tensor
    b2: torch.Tensor
    a3: torch.Tensor
    b3: torch.Tensor
    scal: torch.Tensor
    rows: Tuple[Tuple[float, ...], ...]

    def block(self, i: int) -> Tuple[ConvCoeffs, ConvCoeffs, ConvCoeffs, int]:
        """Block ``i``'s ((co1, mode1), (co2, mode2), (co3, mode3), zp)."""
        r = self.rows[i]

        def conv(a, b, k, c=0.0):
            return (EpilogueCoeffs(A=a[i], B=b[i], C=c, lo=r[3 * k],
                                   hi=r[3 * k + 1]),
                    EpilogueMode(True, r[3 * k + 2], False, None))
        return (conv(self.a1, self.b1, 0), conv(self.a2, self.b2, 1),
                conv(self.a3, self.b3, 2, r[9]), int(r[10]))


def stack_chain(blocks: Sequence[Tuple[ConvCoeffs, ConvCoeffs, ConvCoeffs,
                                       int]]) -> ChainCoeffs:
    """Stack per-block ((co1, mode1), (co2, mode2), (co3, mode3), zp), each
    mode a requant, into a :class:`ChainCoeffs` on the coefficients'
    device."""
    rows = []
    for (co1, m1), (co2, m2), (co3, m3), zp in blocks:
        for m, what in ((m1, "conv1"), (m2, "conv2"), (m3, "conv3")):
            check_requant(m, f"chained {what}")
        rows.append(tuple(float(v) for v in (
            co1.lo, co1.hi, m1.shift, co2.lo, co2.hi, m2.shift, co3.lo,
            co3.hi, m3.shift, co3.C, zp, 0.0)))
    dev = blocks[0][0][0].A.device

    def stack(k, j):
        return torch.stack([b[k][0][j].to(torch.float32).reshape(-1)
                            for b in blocks]).contiguous()
    return ChainCoeffs(stack(0, 0), stack(0, 1), stack(1, 0), stack(1, 1),
                       stack(2, 0), stack(2, 1),
                       torch.tensor(rows, dtype=torch.float32, device=dev),
                       tuple(rows))


def check_chain(co: ChainCoeffs, n: int, c_mid: int, c_out: int,
                dev: torch.device) -> None:
    """The coefficient shapes a chain of ``n`` blocks needs: (n, c_mid) for
    the first two convs, (n, c_out) for the last, (n, 12) scalars."""
    for name, v, c in (("a1", co.a1, c_mid), ("b1", co.b1, c_mid),
                       ("a2", co.a2, c_mid), ("b2", co.b2, c_mid),
                       ("a3", co.a3, c_out), ("b3", co.b3, c_out),
                       ("scal", co.scal, NSCAL)):
        if (v.device != dev or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != (n, c)):
            raise ValueError(f"chain coefficient {name} must be a contiguous "
                             f"float32 ({n}, {c}) tensor on {dev}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if len(co.rows) != n or any(not -128 <= r[10] <= 127 for r in co.rows):
        raise ValueError("chain scalars: one row per block, zero points on "
                         "the int8 grid")


_barriers: Dict[torch.device, torch.Tensor] = {}


def barrier_words(dev: torch.device) -> torch.Tensor:
    """The grid barrier's arrival count and generation on ``dev``: zero when
    made, back to a zero count after every barrier, so one pair serves
    every launch on the device (launches on one stream run in turn)."""
    bar = _barriers.get(dev)
    if bar is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first chained-kernel launch on a device "
                               "must come before any CUDA graph capture")
        bar = _barriers[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return bar


def check_stack(dev, n, c_in, c_mid, w1, w2, w3, co) -> bool:
    """The checks K7 and K8 share on a chain's weights and coefficients;
    True when every channel count allows 16-byte loads."""
    if (tuple(w1.shape) != (n, c_mid, c_in)
            or tuple(w2.shape) != (n, c_mid, 9 * c_mid)
            or tuple(w3.shape) != (n, c_in, c_mid)):
        raise ValueError(f"chain weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w3.shape)} do not match "
                         f"({n}, {c_mid}, {c_in}), ({n}, {c_mid}, "
                         f"9*{c_mid}), ({n}, {c_in}, {c_mid})")
    check_int8(dev, w1=w1, w2=w2, w3=w3)
    check_chain(co, n, c_mid, c_in, dev)
    return c_in % 16 == 0 and c_mid % 16 == 0


def int_grids(co: ChainCoeffs) -> bool:
    """Whether every requant of the chain (each row's lo, hi, shift of the
    three convs) has a grid :func:`~qtpu_torch.ops.qmatmul.int_grid`
    takes."""
    return all(int_grid(*r[3 * k:3 * k + 3]) for r in co.rows
               for k in range(3))


def stage_path(B: int, H: int, W: int, cin: int, cmid: int,
               co: ChainCoeffs, *tensors: torch.Tensor, sms: int) -> str:
    """The kernel K7 takes: ``"wgmma"`` for Cin a multiple of 128 and Cmid
    of 64, grids ``code_bits`` takes, 16-byte aligned ``tensors`` (TMA) and
    a plan that fits; ``"igemm"`` otherwise."""
    ok = (cin % 128 == 0 and cmid % 64 == 0 and int_grids(co)
          and all(t.data_ptr() % 16 == 0 for t in tensors)
          and cp.chain_plan("stage", B, H, W, cin, cmid, sms=sms)
          is not None)
    return "wgmma" if ok else "igemm"


def stage_proj_path(B: int, H: int, W: int, cp_: int, cm: int, co: int,
                    cmid: int, pco: ChainCoeffs, chain: ChainCoeffs, n: int,
                    *tensors: torch.Tensor, sms: int) -> str:
    """The kernel K8 takes: ``"wgmma"`` for Cp a multiple of 64, the
    projection's Cm equal to the chain's Cmid and a multiple of 64, Co a
    multiple of 128, ``n`` ≥ 1 chained blocks, grids ``code_bits`` takes
    (the projection's and the chain's), 16-byte aligned ``tensors`` (TMA)
    and a ``"stage_proj"`` plan that fits; ``"igemm"`` otherwise."""
    ok = (cp_ % 64 == 0 and cm == cmid and cm % 64 == 0 and co % 128 == 0
          and n >= 1 and int_grids(pco) and int_grids(chain)
          and all(t.data_ptr() % 16 == 0 for t in tensors)
          and cp.chain_plan("stage_proj", B, H, W, co, cm, sms=sms)
          is not None)
    return "wgmma" if ok else "igemm"


def resolve_plan(plan: Optional[cp.ChainPlan], path: str, kind: str,
                 B: int, H: int, W: int, c: int, cm: int,
                 sms: int) -> Optional[cp.ChainPlan]:
    """The runner's plan of a call on ``path``: ``chain_plan``'s for the
    shape, or the caller's ``plan`` (``time_chain.py --sweep``, the tests),
    which must be the one ``chain_plan`` gives this shape with its mode and
    tiles a unit; None on the older kernel, which takes no plan."""
    if path != "wgmma":
        if plan is not None:
            raise ValueError(f"a plan is the wgmma kernel's, not {path!r}'s")
        return None
    pl = cp.chain_plan(kind, B, H, W, c, cm, sms=sms,
                       mode=None if plan is None else plan.mode,
                       tm=None if plan is None else plan.tm)
    if pl is None or (plan is not None and plan != pl):
        raise ValueError(f"no wgmma plan {plan} for {kind} (B, H, W) "
                         f"({B}, {H}, {W}), widths {c}, {cm}")
    return pl


def plan_args(plan: cp.ChainPlan) -> Tuple[int, ...]:
    """The plan as the C entries take it: (mode, w, tm, stages, nres, smem,
    grid), mode 0 fused, 1 split."""
    return (cp.MODES.index(plan.mode), plan.w, plan.tm, plan.stages,
            plan.nres, plan.smem, plan.grid)


def qstage_folded(x_q: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor, co: ChainCoeffs, *,
                  path: Optional[str] = None,
                  plan: Optional[cp.ChainPlan] = None,
                  defines: tuple = ()) -> torch.Tensor:
    """N chained identity bottlenecks on the int8 (B, H, W, Cin) ``x_q``
    with the stacked weights (N, Cmid, Cin), (N, Cmid, 9·Cmid), (N, Cin,
    Cmid) and coefficients ``co`` → int8 (B, H, W, Cin).  ``path`` forces a
    kernel (``"igemm"`` takes any shape), ``plan`` the wgmma kernel's plan
    (:func:`resolve_plan`); ``defines`` selects a probe build
    (``ops/probe_chain.py``)."""
    if x_q.device.type == "cpu":
        return qstage_folded_plain(x_q, w1, w2, w3, co)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    dev = x_q.device
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be NHWC, got {tuple(x_q.shape)}")
    B, H, W, Cin = x_q.shape
    n, Cmid = w1.shape[:2]
    if n < 1:
        raise ValueError("a chain needs at least one block")
    check_int8(dev, x_q=x_q)
    vec = check_stack(dev, n, Cin, Cmid, w1, w2, w3, co)
    M = B * H * W
    out = torch.empty_like(x_q)
    sms = _sm_count(dev.index)
    path = choose(path, stage_path(B, H, W, Cin, Cmid, co, x_q, w1, w2, w3,
                                   out, sms=sms), "K7")
    pl = resolve_plan(plan, path, "stage", B, H, W, Cin, Cmid, sms)
    plan = ()
    if path == "wgmma":
        plan = plan_args(pl)
        # conv1's codes (a), conv2's in split mode (b), block outputs
        ws_bytes = M * Cmid * (2 if pl.mode == "split" else 1)
    else:
        ws_bytes = 2 * M * Cmid
    # workspace regions start 16-byte aligned (TMA)
    ws_bytes = -(-ws_bytes // 16) * 16 + (M * Cin if n > 1 else 0)
    ws = torch.empty(ws_bytes, dtype=torch.int8, device=dev)
    lib, sym = _SYMBOLS[path]
    fn = _build.load(lib, sym, _WG_ARGTYPES if path == "wgmma" else
                     _ARGTYPES, defines)
    args = (x_q.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            co.a1.data_ptr(), co.b1.data_ptr(), co.a2.data_ptr(),
            co.b2.data_ptr(), co.a3.data_ptr(), co.b3.data_ptr(),
            co.scal.data_ptr(), out.data_ptr(), ws.data_ptr(),
            barrier_words(dev).data_ptr(), B, H, W, n, Cin, Cmid)
    if path == "wgmma":
        err = _build.launch(fn, dev, *args, *plan)
    else:
        err = _build.launch(fn, dev, *args, int(vec))
    if err:
        raise RuntimeError(f"qstage_fused kernel ({path}) launch failed: "
                           f"CUDA error {err} (x {tuple(x_q.shape)}, {n} "
                           f"blocks, Cmid={Cmid}, plan {plan})")
    count(qstage_folded, path)
    if recording():
        # x in and the run's output once, the weights, each block's
        # coefficient rows and scalars
        note_work(2 * M * n * Cmid * (2 * Cin + 9 * Cmid),
                  x_q.numel() + out.numel() + w1.numel() + w2.numel()
                  + w3.numel() + n * (16 * Cmid + 8 * Cin + 48))
    return out


qstage_folded.launches = 0
qstage_folded.launches_wgmma = 0
qstage_folded.launches_igemm = 0


def chain_plain(x_q, w1, w2, w3, co: ChainCoeffs):
    """The unfused chain in plain PyTorch: ``qblock.block_plain`` per
    block."""
    for i in range(w1.shape[0]):
        (co1, m1), (co2, m2), (co3, m3), zp = co.block(i)
        x_q = block_plain(x_q, w1[i], w2[i], w3[i], co1, m1, co2, m2, co3,
                          m3, zp2=zp)
    return x_q


def qstage_folded_plain(x_q: torch.Tensor, w1: torch.Tensor,
                        w2: torch.Tensor, w3: torch.Tensor,
                        co: ChainCoeffs) -> torch.Tensor:
    """Plain PyTorch version of :func:`qstage_folded` (:func:`chain_plain`)."""
    qstage_folded_plain.calls += 1
    return chain_plain(x_q, w1, w2, w3, co)


qstage_folded_plain.calls = 0


def qstage_proj_folded(x_q: torch.Tensor, wp1: torch.Tensor,
                       wp2: torch.Tensor, wp3: torch.Tensor,
                       wd: torch.Tensor, pco: ChainCoeffs,
                       cod: EpilogueCoeffs, w1: torch.Tensor,
                       w2: torch.Tensor, w3: torch.Tensor,
                       co: ChainCoeffs, *, path: Optional[str] = None,
                       plan: Optional[cp.ChainPlan] = None,
                       defines: tuple = ()) -> torch.Tensor:
    """A whole stride-1 stage on the int8 (B, H, W, Cp) ``x_q``: the
    projection block — conv1 (Cm, Cp), conv2 (Cm, 9·Cm), conv3 (Co, Cm)
    with the downsample (Co, Cp) dequantized on ``cod`` as f32 residual,
    its coefficients one row of ``pco`` (C3 = 1 / next scale) — then the
    chain of :func:`qstage_folded` with Cin = Co → int8 (B, H, W, Co).
    ``path`` forces a kernel (``"igemm"`` takes any shape), ``plan`` the
    wgmma kernel's (a ``chain_plan("stage_proj", ...)`` of the call's
    shape, :func:`resolve_plan`); ``defines`` selects a probe build
    (``ops/probe_chain.py``)."""
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be NHWC, got {tuple(x_q.shape)}")
    B, H, W, Cp = x_q.shape
    Cm, Co = wp1.shape[0], wp3.shape[0]
    n, Cmid = w1.shape[0], w1.shape[1]
    if (tuple(wp1.shape) != (Cm, Cp) or tuple(wp2.shape) != (Cm, 9 * Cm)
            or tuple(wp3.shape) != (Co, Cm) or tuple(wd.shape) != (Co, Cp)):
        raise ValueError(f"projection weights {tuple(wp1.shape)}, "
                         f"{tuple(wp2.shape)}, {tuple(wp3.shape)}, "
                         f"{tuple(wd.shape)} do not match ({Cm}, {Cp}), "
                         f"({Cm}, 9*{Cm}), ({Co}, {Cm}), ({Co}, {Cp})")
    if path not in (None, "wgmma", "igemm"):
        raise ValueError(f"K8 path {path!r}: wgmma or igemm")
    if x_q.device.type == "cpu":
        return qstage_proj_folded_plain(x_q, wp1, wp2, wp3, wd, pco, cod, w1,
                                        w2, w3, co)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    dev = x_q.device
    check_int8(dev, x_q=x_q, wp1=wp1, wp2=wp2, wp3=wp3, wd=wd)
    check_chain(pco, 1, Cm, Co, dev)
    check_vectors(cod, Co, dev)
    vec = (check_stack(dev, n, Co, Cmid, w1, w2, w3, co)
           and Cp % 16 == 0 and Cm % 16 == 0)
    M = B * H * W
    out = torch.empty((B, H, W, Co), dtype=torch.int8, device=dev)
    sms = _sm_count(dev.index)
    path = choose(path, stage_proj_path(B, H, W, Cp, Cm, Co, Cmid, pco, co,
                                        n, x_q, wp1, wp2, wp3, wd, w1, w2,
                                        w3, out, sms=sms), "K8")
    pl = resolve_plan(plan, path, "stage_proj", B, H, W, Co, Cm, sms)
    if path == "wgmma":
        # workspaces a and b (conv1's and conv2's codes), then the block
        # outputs before the last, 16-byte aligned (TMA)
        ws_bytes = -(-2 * M * Cm // 16) * 16 + M * Co
    else:
        ws_bytes = 2 * M * max(Cm, Cmid) + (M * Co if n > 0 else 0)
    ws = torch.empty(ws_bytes, dtype=torch.int8, device=dev)
    lib, sym = _PROJ_SYMBOLS[path]
    fn = _build.load(lib, sym, _PROJ_WG_ARGTYPES if path == "wgmma" else
                     _PROJ_ARGTYPES, defines)
    args = (x_q.data_ptr(), wp1.data_ptr(), wp2.data_ptr(), wp3.data_ptr(),
            wd.data_ptr(), pco.a1.data_ptr(), pco.b1.data_ptr(),
            pco.a2.data_ptr(), pco.b2.data_ptr(), pco.a3.data_ptr(),
            pco.b3.data_ptr(), cod.A.data_ptr(), cod.B.data_ptr(),
            pco.scal.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), co.a1.data_ptr(), co.b1.data_ptr(),
            co.a2.data_ptr(), co.b2.data_ptr(), co.a3.data_ptr(),
            co.b3.data_ptr(), co.scal.data_ptr(), out.data_ptr(),
            ws.data_ptr(), barrier_words(dev).data_ptr(), B, H, W, Cp, Cm,
            n, Co, Cmid)
    if path == "wgmma":
        err = _build.launch(fn, dev, *args, *plan_args(pl))
    else:
        err = _build.launch(fn, dev, *args, int(vec))
    if err:
        raise RuntimeError(f"qstage_proj_fused kernel ({path}) launch "
                           f"failed: CUDA error {err} (x {tuple(x_q.shape)}, "
                           f"Cm={Cm}, Co={Co}, {n} chained blocks, plan "
                           f"{pl})")
    count(qstage_proj_folded, path)
    if recording():
        # the projection block (conv1, conv2, conv3, downsample), then the
        # chain of qstage_folded
        note_work(2 * M * (n * Cmid * (2 * Co + 9 * Cmid)
                           + Cm * (Cp + 9 * Cm + Co) + Cp * Co),
                  x_q.numel() + out.numel() + wp1.numel() + wp2.numel()
                  + wp3.numel() + wd.numel() + w1.numel() + w2.numel()
                  + w3.numel() + n * (16 * Cmid + 8 * Co + 48) + 16 * Cm
                  + 16 * Co + 48)
    return out


qstage_proj_folded.launches = 0
qstage_proj_folded.launches_wgmma = 0
qstage_proj_folded.launches_igemm = 0


def qstage_proj_folded_plain(x_q, wp1, wp2, wp3, wd, pco: ChainCoeffs,
                             cod: EpilogueCoeffs, w1, w2, w3,
                             co: ChainCoeffs) -> torch.Tensor:
    """Plain PyTorch version of :func:`qstage_proj_folded`: the projection
    block's K1 → K2 → ``qproj.proj_plain``, then :func:`chain_plain`."""
    qstage_proj_folded_plain.calls += 1
    B, H, W, Cp = x_q.shape
    (co1, m1), (co2, m2), (co3, m3), zp = pco.block(0)
    a = qops.apply_epilogue(qops.qmatmul(x_q.reshape(-1, Cp), wp1.t()),
                            co1, m1).reshape(B, H, W, -1)
    Cm = a.shape[-1]
    ap = qops.pad_nhwc(a, ((1, 1), (1, 1)), zp)
    b = qops.apply_epilogue(qops.conv_acc_f64(
        ap, wp2.reshape(Cm, 3, 3, Cm).permute(1, 2, 3, 0)), co2, m2)
    x1 = proj_plain(b, x_q, wp3, wd, co3, m3, cod, stride=1)
    return chain_plain(x1, w1, w2, w3, co)


qstage_proj_folded_plain.calls = 0


# -- qtpu's call forms and coefficient builders ------------------------------

def _affine_rows(scalars: torch.Tensor, cols) -> List[Tuple[float, ...]]:
    """qtpu's per-block scalar rows → the kernels' 12 scalars: every grid
    affine (shift 128), relu folded into lo, hi 255.  ``cols`` names the
    columns of lo1, lo2, lo3, C3 and zp in qtpu's row."""
    out = []
    for r in scalars.reshape(scalars.shape[0], -1).tolist():
        lo1, lo2, lo3, c, zp = (r[k] for k in cols)
        out.append((lo1, 255.0, 128.0, lo2, 255.0, 128.0, lo3, 255.0, 128.0,
                    c, zp, 0.0))
    return out


def chain_from_rows(rows, a1, b1, a2, b2, a3, b3) -> ChainCoeffs:
    """A :class:`ChainCoeffs` from rows of the 12 scalars and qtpu's (N, C)
    coefficient rows."""
    def f(v):
        return v.to(torch.float32).reshape(len(rows), -1).contiguous()
    return ChainCoeffs(f(a1), f(b1), f(a2), f(b2), f(a3), f(b3),
                       torch.tensor(rows, dtype=torch.float32,
                                    device=a1.device),
                       tuple(tuple(r) for r in rows))


def _stack_nk(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor):
    """qtpu's stacked (K, N) weights → the kernels' (N, K) stacks; w2's
    (N·9, Cmid, Cmid) taps become (N, Cmid, 9·Cmid) with k = tap·Cmid + c."""
    n, _, cmid = w1.shape
    return (w1.transpose(1, 2).contiguous(),
            w2.reshape(n, 9 * cmid, cmid).transpose(1, 2).contiguous(),
            w3.transpose(1, 2).contiguous())


def qstage_fused(x_q: torch.Tensor, *, w1: torch.Tensor, w2: torch.Tensor,
                 w3: torch.Tensor, scalars: torch.Tensor, a1: torch.Tensor,
                 b1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
                 a3: torch.Tensor, b3: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """qtpu's call form: x_q (B·h·w, Cin) rows of NHWC images; w1 (N, Cin,
    Cmid), w2 (N·9, Cmid, Cmid) in (dy, dx) tap order, w3 (N, Cmid, Cin);
    ``scalars`` (N, 5) = [lo1, lo2, lo3, C, zp2] and the (N, C) rows of
    :func:`stage_coeffs` → (B·h·w, Cin) codes."""
    M, cin = x_q.shape
    co = chain_from_rows(_affine_rows(scalars, (0, 1, 2, 3, 4)), a1, b1, a2,
                          b2, a3, b3)
    out = qstage_folded(x_q.reshape(M // (h * w), h, w, cin),
                        *_stack_nk(w1, w2, w3), co)
    return out.reshape(M, cin)


def qstage_proj_fused(x_q: torch.Tensor, *, wp1: torch.Tensor,
                      wp2: torch.Tensor, wp3: torch.Tensor, wd: torch.Tensor,
                      pscal: torch.Tensor, pa1: torch.Tensor,
                      pb1: torch.Tensor, pa2: torch.Tensor, pb2: torch.Tensor,
                      pa3: torch.Tensor, pb3: torch.Tensor,
                      pda: torch.Tensor, pdb: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, w3: torch.Tensor,
                      scalars: torch.Tensor, a1: torch.Tensor,
                      b1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
                      a3: torch.Tensor, b3: torch.Tensor, h: int, w: int
                      ) -> torch.Tensor:
    """qtpu's call form of the whole stage: x_q (B·h·w, Cp) rows; wp1 (Cp,
    Cm), wp2 (9, Cm, Cm), wp3 (Cm, Co), wd (Cp, Co); ``pscal`` (1, 5) =
    [lo1, lo2, zp2, lo3, C] and the rows of :func:`proj_stage_coeffs`; the
    chain as :func:`qstage_fused` with Cin = Co → (B·h·w, Co) codes."""
    M, cp = x_q.shape
    cm, co_ = wp1.shape[1], wp3.shape[1]
    pco = chain_from_rows(_affine_rows(pscal, (0, 1, 3, 4, 2)), pa1, pb1,
                           pa2, pb2, pa3, pb3)
    cod = EpilogueCoeffs(A=pda.reshape(-1).to(torch.float32).contiguous(),
                         B=pdb.reshape(-1).to(torch.float32).contiguous(),
                         C=1.0, lo=0.0, hi=0.0)
    co = chain_from_rows(_affine_rows(scalars, (0, 1, 2, 3, 4)), a1, b1, a2,
                          b2, a3, b3)
    out = qstage_proj_folded(
        x_q.reshape(M // (h * w), h, w, cp), wp1.t().contiguous(),
        wp2.reshape(9 * cm, cm).t().contiguous(), wp3.t().contiguous(),
        wd.t().contiguous(), pco, cod, *_stack_nk(w1, w2, w3), co)
    return out.reshape(M, co_)


def stage_coeffs(blocks: Sequence[Tuple[Dict, Dict, Dict]], next_grid
                 ) -> Dict[str, torch.Tensor]:
    """qtpu's stacked operands for a chain of identity bottlenecks
    [(c1, c2, c3), ...] (frozen nodes): block i requantised onto block
    i+1's conv1 grid, the last onto the affine ``next_grid`` (scale, zp);
    :func:`qtpu_torch.ops.qblock.block_coeffs` per block."""
    outs: Dict[str, List[torch.Tensor]] = {}
    for i, (c1, c2, c3) in enumerate(blocks):
        tgt = ((blocks[i + 1][0]["act_scale"], blocks[i + 1][0]["act_zp"])
               if i + 1 < len(blocks) else next_grid)
        for k, v in block_coeffs(c1, c2, c3, tgt).items():
            outs.setdefault(k, []).append(v)
    return {k: torch.cat(v, dim=0) for k, v in outs.items()}


def proj_stage_coeffs(proj: Tuple[Dict, Dict, Dict, Dict],
                      blocks: Sequence[Tuple[Dict, Dict, Dict]], next_grid
                      ) -> Dict[str, torch.Tensor]:
    """qtpu's operands of a whole stage: the stride-1 projection block
    ``proj`` = (c1, c2, c3, down) requantised onto chain block 0's conv1
    grid (conv3 + downsample through :func:`qtpu_torch.ops.qproj.
    proj_coeffs`), then :func:`stage_coeffs` of the chain."""
    c1, c2, c3, down = proj

    def fold(node, nxt):
        return qops.epilogue_coeffs(
            act_scale=node["act_scale"], act_zp=node["act_zp"],
            w_scale=node["w_scale"], colsum=node["colsum"],
            bias=node["bias"], requant_scale=nxt["act_scale"],
            requant_zp=nxt["act_zp"], relu=True)[0]
    co1, co2 = fold(c1, c2), fold(c2, c3)
    chain0 = (blocks[0][0]["act_scale"], blocks[0][0]["act_zp"])
    tail = proj_coeffs(c3, down, chain0)
    zp2 = float(c2["act_zp"])
    pscal = torch.tensor([[co1.lo, co2.lo, zp2, *tail["scalars"][0].tolist()]],
                         dtype=torch.float32)
    return dict(pscal=pscal, pa1=co1.A.reshape(1, -1),
                pb1=co1.B.reshape(1, -1), pa2=co2.A.reshape(1, -1),
                pb2=co2.B.reshape(1, -1), pa3=tail["a3"], pb3=tail["b3"],
                pda=tail["ad"], pdb=tail["bd"],
                **stage_coeffs(blocks, next_grid))
