"""The plan of the chained kernels on the wgmma runner (K7 ``qstage_fused``,
K8 ``qstage_proj_fused`` and K9 ``qivr_fused``, ``csrc/wgmma_phase.cuh``):
pure Python, so the CPU tests reach it.

A chained launch is one persistent cooperative grid of blocks of two wgmma
consumer warpgroups and one TMA producer warp; each chained block is a few
phases with a grid barrier between them:

* ``"fused"`` (two phases a block): conv1 / expand on K1's tile (128 rows ×
  ``w`` channels a tile) into a workspace, then K5's tile (K7: conv2 from
  the halo, conv3 with the residual) or the depthwise + project tile (K9)
  on 8×8 output tiles, ``tm`` tiles a block unit;
* ``"split"`` (three phases a block): conv1 / expand as above, then conv2
  (K7) or the depthwise (K9) alone on (8×8 tile, channel pass) units into
  a second workspace, then conv3 / the project with the residual on K1's
  tile.  It spreads a run of few 8×8 tiles (ResNet-50's layer3-4 and
  MobileNet-v2's 14² and 7² runs at B = 8) over more blocks, as K5's
  clusters do, without a handshake between the blocks at every unit.

A block holds 168 registers a thread (ptxas, PR 9), so one block an SM;
the layout takes the shared memory that leaves.

K8 (kind ``"stage_proj"``) runs its projection block as three phases
ahead of K7's chain: P0 conv1 on K1's tile, P1 conv2 on split mode's
units, P2 conv3 + downsample on the two-GEMM tile (``td_slab``), whose
128 × 128 f32 td tile lies over the residual slabs, the halo and ``mid``
(none of which P2 uses) and widens that region where it is smaller; its
chain takes K7's rule.

One ring of 8 KB stages serves every phase (K1's x and w tiles, two stages
a k-step; K5's weight stages; K9's 64-channel halo stages).
:func:`phase_smem_bytes` is the layout's size; the C entries compute the
same (``Layout``) and refuse a plan where they differ.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

SMEM_LIMIT = 232448      # dynamic shared memory of one block (H100)
STAGE = 8192             # a ring stage: up to 128 rows x 64 bytes
SLAB = 8192              # an output or residual tile: 64 rows x 128 bytes
CHUNK_PITCH = 1664       # a 16-channel halo chunk (K5's layout)
BAR_BYTES = 512
MIN_STAGES, MAX_STAGES = 4, 24
MAX_RES = 2
COEF_A = 2048            # K1's A, B rows, per warpgroup
TD_BYTES = 128 * 128 * 4  # K8's td tile: 128 x 128 f32
MODES = ("fused", "split")
KINDS = ("stage", "ivr", "stage_proj")


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


class ChainPlan(NamedTuple):
    """One chained launch: ``mode`` (``"fused"`` or ``"split"``), ``w`` the
    channels of a conv1 / expand tile (64 or 128; K7's conv2 passes too),
    ``tm`` 8×8 tiles a block unit, ``stages`` in the ring, ``nres``
    residual buffers, ``smem`` bytes a block; per chained block the tiles
    (units) of each phase and ``grid``, the blocks the launch asks for (the
    C entry caps it at what the card holds at once)."""
    mode: str
    w: int
    tm: int
    stages: int
    nres: int
    smem: int
    tiles: tuple
    grid: int


def phase_smem_bytes(kind: str, c: int, cm: int, *, tm: int, stages: int,
                     nres: int, split: bool = False) -> int:
    """Shared memory of a runner block (``Layout`` in wgmma_phase.cuh):
    alignment slack, the ring, four output slabs, ``nres`` × ``tm``
    residual slabs, K7's halo (Cmid/16 chunks a tile), the fused modes'
    ``mid`` (K7 64 × Cmid a tile, K9 64 × E padded to 64), K1's A, B rows,
    the second phase's A, B rows (K7 Cmid and Cin channels; K9 E and C
    padded to 64 and 128) and the barriers.  ``c``/``cm``: K7's Cin/Cmid,
    K9's C/E, K8's Co/Cm.  K8's td tile lies over the residual slabs, the
    halo and mid, that region at least ``TD_BYTES``."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    ivr = kind == "ivr"
    halo = 0 if ivr else tm * (cm // 16) * CHUNK_PITCH
    mid = 0 if split else tm * 64 * (_up(cm, 64) if ivr else cm)
    coef = 8 * ((_up(cm, 64) + _up(c, 128)) if ivr else cm + c)
    shared = nres * tm * SLAB + halo + mid
    if kind == "stage_proj":
        shared = max(shared, TD_BYTES)
    return (1024 + stages * STAGE + 4 * SLAB + shared + COEF_A + coef
            + BAR_BYTES)


def _fit(kind, c, cm, tm, split):
    """(stages, nres, smem) of the first layout that fits a block: two
    residual buffers where they fit, then as many stages as are left (at
    least MIN_STAGES, at most MAX_STAGES)."""
    for nres in range(MAX_RES, 0, -1):
        fixed = phase_smem_bytes(kind, c, cm, tm=tm, stages=0, nres=nres,
                                 split=split)
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // STAGE)
        if stages >= MIN_STAGES:
            return stages, nres, fixed + stages * STAGE
    return None


def phase_tiles(kind: str, mode: str, B: int, H: int, W: int, c: int,
                cm: int, w: int, tm: int) -> tuple:
    """The tiles of each phase of one chained block: conv1 / expand
    (128-row × ``w`` tiles), then K5's / K9's units (``tm`` 8×8 tiles
    each), or for ``"split"`` conv2's / the depthwise's (8×8 tile,
    ``w``-channel pass) units and conv3's / the project's 128-row tiles,
    128 channels wide (K7, K8) or 64 (K9).  K8's first: its projection's
    P0 (conv1, as conv1), P1 (conv2 on (``tm`` 8×8 tiles, ``w``-channel
    pass) units: split mode's, or with ``tm`` = 2 one tile a warpgroup)
    and P2 (128 × 128 tiles of the (M, Co) output)."""
    M = B * H * W
    t8 = B * -(-H // 8) * -(-W // 8)
    a = -(-M // 128) * -(-cm // w)
    if kind == "stage_proj":
        return (a, -(-t8 // tm) * -(-cm // w), -(-M // 128) * -(-c // 128),
                *phase_tiles("stage", mode, B, H, W, c, cm, w, tm))
    if mode == "fused":
        return (a, -(-t8 // tm))
    return (a, t8 * -(-cm // w),
            -(-M // 128) * -(-c // (128 if kind == "stage" else 64)))


@functools.lru_cache(maxsize=None)
def chain_plan(kind: str, B: int, H: int, W: int, c: int, cm: int, *,
               sms: int, mode: Optional[str] = None, tm: Optional[int] = None
               ) -> Optional[ChainPlan]:
    """The runner's plan for a chained run of ``kind`` (``"stage"``: K7,
    ``c``/``cm`` Cin/Cmid; ``"ivr"``: K9, C/E; ``"stage_proj"``: K8, Co/Cm,
    its chain's mode and tiles a unit as K7's) on (B, H, W) images and a
    card of ``sms`` SMs, or None where the layout does not fit.  ``mode``
    and ``tm`` force a choice (``time_chain.py --sweep``).  The rule:

    * ``w``: 128 where Cmid is a multiple of 128 (K7), else 64; K9 64;
    * ``"split"`` while the 8×8 tiles are few: K7 below half the card
      (tiles < sms/2: ResNet-50's layer3-4 at B = 8), K9, whose fused
      tile is lighter, below an eighth (MobileNet-v2's 7² run at B = 8);
      else ``"fused"``; K9's rows of C bytes that TMA cannot address (C
      not a multiple of 16) run fused only;
    * two 8×8 tiles a block unit (K7 fused only: both share every weight
      stage) where the pairs fill the card twice (⌈tiles/2⌉ ≥ 2·sms), or
      for Cmid ≥ 256 (the weights then outweigh the blocks lost, as in
      K5's ``ops/qtail.tail_plan``) half of it, and their layout fits;
      else one;
    * the layout (:func:`_fit`).  ``time_chain.py --sweep`` (PERF.md §6,
      PR 9) found the rule's plan the best or within 7% at every run of
      both engines at B = 8 and 128."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    if min(B, H, W) <= 0:
        return None
    if mode is not None and mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if tm is not None and tm not in (1, 2):
        raise ValueError(f"{tm} tiles a block: 1 or 2")
    if tm == 2 and (kind == "ivr" or mode == "split"):
        raise ValueError("two tiles a block: K7's fused mode only")
    k7 = kind != "ivr"      # K7, and K8's chain
    w = 128 if k7 and cm % 128 == 0 else 64
    t8 = B * -(-H // 8) * -(-W // 8)
    narrow = kind == "ivr" and c % 16 != 0
    if narrow and mode == "split":
        return None
    if mode is None:
        mode = "split" if t8 < sms / (2 if k7 else 8) and \
            not narrow else "fused"
    if tm is None:
        tm = 1
        if (k7 and mode == "fused"
                and -(-t8 // 2) >= (2 * sms if cm < 256 else sms / 2)
                and _fit(kind, c, cm, 2, False) is not None):
            tm = 2
    tiles = phase_tiles(kind, mode, B, H, W, c, cm, w, tm)
    fit = _fit(kind, c, cm, tm, mode == "split")
    if fit is None or (mode == "split" and fit[1] < 2):
        return None    # split's 128-row residual tile takes both buffers
    stages, nres, smem = fit
    return ChainPlan(mode, w, tm, stages, nres, smem, tiles,
                     min(max(tiles), sms))
