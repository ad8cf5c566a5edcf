// The persistent phased runner of the chained kernels on Hopper (K7
// qstage_wg.cu, K9 qivr_wg.cu), for sm_90a.
//
// What held the older chained kernels (grid_phase.cuh) back, from their
// clock64 probe (qtpu_torch/ops/probe_chain.py): three phases of
// igemm.cuh's mma.sync loop a chained block, whose byte-at-a-time
// epilogues took up to 55% of a block (K7 conv3 at B = 128) and whose grid
// barriers, each phase's few tiles waiting for the slowest, up to 74% (K7
// layer3 at B = 8); K9's depthwise read its nine taps from L2 per pixel.
// Here a chained block is two phases (K7 at few 8 x 8 tiles three) built
// from the TMA + wgmma tiles of K1 (wgmma_gemm.cuh) and K5 (wgmma_tail.cuh):
//
// * a block is two consumer warpgroups (wgmma) and one producer warp (TMA),
//   launched cooperatively on a grid that is all resident (the occupancy
//   query passes the block's dynamic shared memory);
// * phase A, conv1 / expand, runs K1's tile: 128 rows x w channels, x's
//   and w1's 64-byte k-stages through the ring, the requant
//   (wgmma_tail.cuh's fill_slab, on epilogue.cuh's ep_pair and code_pair,
//   the arithmetic of K1's epilogue_slab) into a swizzled shared tile
//   that TMA stores to a workspace;
// * phase B runs K5's tile (K7: conv2 straight from a TMA-loaded halo of
//   the workspace, the zero point written outside the image, conv3 with
//   the block input as int8 residual, the output stored by TMA) or the
//   depthwise + project tile (K9: the workspace's 10 x 10 halo 64 channels
//   a ring stage, the depthwise on CUDA cores with K3's arithmetic straight
//   into the K-major `mid` tile the project's wgmmas read, the project with
//   the residual);
// * K7's "split" mode, for runs of few 8 x 8 tiles (ResNet-50 layer3-4 at
//   B = 8), runs conv2 alone on (tile, w-channel pass) units into a second
//   workspace and conv3 on K1's tile with the residual: three phases, but
//   the blocks share a tile's channels.  (A cooperative launch does take a
//   cluster dimension on the H100; K5's clusters are not used here because
//   a block of the runner walks several units a phase, and the cluster's
//   halo multicast and mid exchange would then need a handshake between
//   the blocks at every unit.)
//
// One ring of STAGE-byte stages serves every phase: its slots and mbarrier
// parities carry on from phase to phase and from block to block (the
// mbarriers are set once).  So do the residual ring, the halo buffer's
// full / empty pair and the output slabs.
//
// Between phases, every output a phase stores by TMA (async proxy) is read
// by other SMs' TMA loads in the next: the storing threads wait for their
// stores' completion (cp.async.bulk.wait_group 0), and a
// fence.proxy.async.global stands on both sides of the grid barrier
// (grid_phase.cuh's: a generation word, a trap on a spin timeout, no
// global tile counter, so CUDA graphs replay it).
//
// Every epilogue step is K1's / K2's / K3's (ep_affine, the residual term,
// the requant; code_bits on integer grids, which ops/qstage.py: stage_path
// and ops/qivr.py: ivr_path require), in the unfused sequence's order, so
// the codes equal the unfused K1 -> K2 -> K1 (K1 -> K3 -> K1) sequence's
// bit for bit.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "grid_phase.cuh"   // grid_barrier, PhaseProbe, NSCAL
#include "wgmma_gemm.cuh"   // TMA, mbarriers, wgmma, desc_sw64, swz, byte_map
#include "wgmma_tail.cuh"   // K5's pieces: HaloWalk, zp_fill, requant_rows

namespace qtpu {
namespace wp {

using wg::bulk_commit;
using wg::bulk_wait_all;
using wg::bulk_wait_read;
using wg::desc_sw64;
using wg::fence_async_smem;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::named_bar;
using wg::smem_u32;
using wg::swz;
using wg::tma_load;
using wg::tma_store;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_tile;
using wg::wgmma_wait_1;
using wg::wgmma_wait_all;
using wt::desc_ns;
using wt::fill_slab;
using wt::tma_load4;
using wt::tma_store4;
using wt::wgmma_n;

constexpr int NCONS = wt::NCONS;          // two consumer warpgroups
constexpr int NTHREADS = wt::NTHREADS;    // and one producer warp
constexpr int STAGE = 8192;               // a ring stage: up to 128 x 64 B
constexpr int XBYTES = 128 * 64;          // K1's x stage (its w: the next)
constexpr int SLAB = wt::SLAB;            // 64 rows x 128 bytes
constexpr int CHP = wt::CHP, MCHP = wt::MCHP, HPIX = wt::HPIX;
constexpr int MAX_ST = 24, MAX_RES = 2;
constexpr int COEF_A = 2 * 2 * 128 * 4;   // K1's A, B rows per warpgroup
constexpr int BAR_BYTES = 512;
constexpr int DW_STAGE = 10 * 10 * 64;    // K9: a 64-channel halo stage

enum Mode { FUSED = 0, SPLIT = 1 };

// The tensor maps of a launch.
enum Map {
  M_X2, M_TMP2, M_OUT2,  // block inputs / outputs, (M, C) rows, 64 x 128
  M_X4, M_TMP4, M_OUT4,  // the same as NHWC, 128 x 8 x 8 boxes
  M_XR, M_TMPR, M_OUTR,  // (M, C) rows, 128 x 64 (split conv3: res, out)
  M_A2, M_A4,            // workspace a / e: (M, Cm) w x 64; NHWC halo
  M_B2, M_B4,            // split: workspace b, 64 x 128; NHWC w x 8 x 8
  M_W1, M_W2, M_W3,      // weights stacked per block, (rows, K) 64 x n
  // K8's projection block: x (M, Cp) 64 x 128; conv1 (Cm, Cp) 64 x w,
  // conv2 (Cm, 9 Cm) 64 x w, conv3 (C, Cm) and the downsample (C, Cp)
  // 64 x 128
  M_XP2, M_WP1, M_WP2, M_WP3, M_WD,
  NMAPS
};
struct Maps {
  CUtensorMap m[NMAPS];
};

struct Chain {
  const float *a1, *b1, *a2, *b2, *a3, *b3;  // (nblk, Cm) x 4, (nblk, C) x 2
  const float* scal;                         // (nblk, NSCAL)
  const int8_t* wd;                          // K9: (nblk, 9, E) taps
  const int8_t* act[3];                      // x, tmp, out (narrow rows)
  const int8_t* w1;                          // (nblk, Cm, C) (narrow rows)
  unsigned* bar;
  int nblk, Bn, H, W, M, C, Cm;  // C: K7's Cin, K9's C; Cm: Cmid, E
  int mode, w, tm, stages, nres;
  // K8's projection block (Cm = the chain's Cmid, its output C channels):
  // conv1's, conv2's (Cm) and conv3's (C) rows, the downsample's Ad, Bd (C)
  // and its NSCAL scalars (C3 = 1 / next scale); Cp its input channels
  const float *pa1, *pb1, *pa2, *pb2, *pa3, *pb3, *pad, *pbd, *pscal;
  int Cp;
};

__host__ __device__ constexpr int up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory offsets of a block (from a 1024-aligned base);
// ops/chain_plan.py: phase_smem_bytes computes the same total, and the host
// entry refuses a plan where they differ.  The ring, four output slabs,
// nres x tm residual slabs, K7's halo (tm tiles), the fused modes' mid (K7
// tm tiles of 64 x Cmid, K9 64 x E padded to 64), K1's A, B rows, phase
// B's A, B rows, the mbarriers.  K8 (proj) lays its projection's td tile
// (128 x 128 f32, the two-GEMM tile's residual) over the residual slabs,
// the halo and mid, which its phase P2 does not use, and extends that
// region to the td tile's size where it is smaller.
constexpr int TD_BYTES = 128 * 128 * 4;
struct Layout {
  int obuf, res, halo, mid, coef_a, coef_b, bars, total;
  __host__ __device__ Layout(bool ivr, bool split, int c, int cm, int tm,
                             int stages, int nres, bool proj = false)
      : obuf(stages * STAGE),
        res(obuf + 4 * SLAB),
        halo(res + nres * tm * SLAB),
        mid(halo + (ivr ? 0 : tm * (cm / 16) * CHP)),
        coef_a(imax(mid + (split ? 0 : tm * 64 * (ivr ? up(cm, 64) : cm)),
                   proj ? res + TD_BYTES : 0)),
        coef_b(coef_a + COEF_A),
        bars(coef_b + 8 * (ivr ? up(cm, 64) + up(c, 128) : cm + c)),
        total(1024 + bars + BAR_BYTES) {}
};

// Output tile t of the 8 x 8 tiling: image b, origin (ty0, tx0).
struct Tile8 {
  int b, ty0, tx0;
  __device__ __forceinline__ Tile8(int H, int W, int t) {
    const int ntx = (W + 7) / 8, nty = (H + 7) / 8;
    b = t / (ntx * nty);
    ty0 = (t / ntx) % nty * 8;
    tx0 = t % ntx * 8;
  }
};

// ---- the rings -------------------------------------------------------------

// Wait for the completion of the phase of parity `parity` of `bar`; a wait
// far longer than any stage takes (millions of polls) traps, so a fault in
// the protocol is a launch error and not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++polls > (1ll << 22)) __trap();
  } while (!done);
}

// A slot and its parity, counted on (never divided out of a running index).
struct Slot {
  int s = 0, ph = 0;
  __device__ __forceinline__ void step(int n) {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The stage ring as the consumers walk it (wgmma_tail.cuh's Ring, with the
// probe's slots): wait until a stage is full; after its wgmmas are issued
// as a group, wait for the group before and free that one's stages; or
// free a stage read by plain loads at once.
struct CRing {
  uint64_t *full, *empty;
  uint8_t* base;
  int stages;
  Slot at;
  int p0 = 0, p1 = 0, nprev = 0;  // the slots of the last group's stages
  PhaseProbe* pr;
  int sw = 0, sm = 1;  // the probe's slots: stage waits, wgmma waits
  __device__ __forceinline__ uint8_t* wait(int j = 0) {
    Slot t = at;
    if (j) t.step(stages);
    const long long c = PHASE_CLOCK();
    mbar_wait(&full[t.s], t.ph);
    pr->add(sw, PHASE_CLOCK() - c);
    return base + t.s * STAGE;
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) {
      if (nprev > 0) mbar_arrive(&empty[p0]);
      if (nprev > 1) mbar_arrive(&empty[p1]);
    }
  }
  // the group of the next n (1 or 2) stages is issued
  __device__ __forceinline__ void done(int lane, int n = 1) {
    wgmma_commit();
    const long long c = PHASE_CLOCK();
    wgmma_wait_1();
    pr->add(sm, PHASE_CLOCK() - c);
    release(lane);
    p0 = at.s;
    at.step(stages);
    if (n == 2) {
      p1 = at.s;
      at.step(stages);
    }
    nprev = n;
  }
  __device__ __forceinline__ void drain(int lane) {
    const long long c = PHASE_CLOCK();
    wgmma_wait_all();
    pr->add(sm, PHASE_CLOCK() - c);
    release(lane);
    nprev = 0;
  }
  // the next stage, read by this warp's plain loads, is free (no wgmma
  // group may be pending)
  __device__ __forceinline__ void free_now(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[at.s]);
    at.step(stages);
  }
};

// The producer's side: wait until the next stage is free, arm it for
// `bytes`, hand out its buffer and barrier.
struct PRing {
  uint64_t *full, *empty;
  uint8_t* base;
  int stages;
  Slot at;
  long long waits = 0;
  __device__ __forceinline__ uint8_t* take(int bytes, uint64_t*& bar) {
    const long long c = PHASE_CLOCK();
    mbar_wait(&empty[at.s], at.ph ^ 1);
    waits += PHASE_CLOCK() - c;
    mbar_expect_tx(&full[at.s], bytes);
    bar = &full[at.s];
    uint8_t* st = base + at.s * STAGE;
    at.step(stages);
    return st;
  }
};

__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// bar: the narrow rows' A tile, one contiguous run of rows.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* m,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* m,
                                           const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// K9's narrow rows (C a multiple of 8 up to 32, not of 16: MobileNet-v2's
// block2, C = 24): x's rows and w1's are no TMA tensors, so each k-stage of
// the expand comes as bulk copies of whole rows, repacked in place into the
// K-major 64-byte swizzled stages (bytes past C zero); the block inputs and
// outputs are 3D maps (b, y, x·C) whose 8 x 8 tiles are 8 rows of 8·C
// bytes.  A thread's part of a stage of such rows: row tid / 2, two of its
// four 16-byte chunks, read into registers before any is written.
struct RawRows {
  uint2 v[4];
  __device__ __forceinline__ void read(const uint8_t* st, int K, int rows,
                                       int tid) {
    const int r = tid >> 1, j0 = 2 * (tid & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 16 * (j0 + j) + 8 * h;
        v[2 * j + h] = r < rows && b < K
                           ? *reinterpret_cast<const uint2*>(st + r * K + b)
                           : make_uint2(0u, 0u);
      }
  }
  __device__ __forceinline__ void write(uint8_t* st, int rows,
                                        int tid) const {
    const int r = tid >> 1, j0 = 2 * (tid & 1);
    if (r >= rows) return;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(st + swz<64>(r * 64 + 16 * (j0 + j))) =
          make_uint4(v[2 * j].x, v[2 * j].y, v[2 * j + 1].x, v[2 * j + 1].y);
  }
};

// fill_slab for the narrow rows' output tile (8 rows of 8·C bytes: row r of
// the tile at (r / 8)·8C + (r % 8)·C), columns col0 + c below C only.
__device__ __forceinline__ void fill_narrow(const int (&acc)[32],
                                            const Epilogue& ep,
                                            const float* sA, const float* sB,
                                            const uint8_t* rs, uint8_t* cs,
                                            int col0, int C, int tw) {
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
  const unsigned flip = ep.shift != 0.f ? 0x8080u : 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (col0 + c >= C) continue;
    const float2 a = *reinterpret_cast<const float2*>(sA + c);
    const float2 b = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int off = (r >> 3) * 8 * C + (r & 7) * C + col0 + c;
      const float2 q =
          residual_pair(*reinterpret_cast<const unsigned short*>(rs + off));
      *reinterpret_cast<unsigned short*>(cs + off) = code_pair(
          ep,
          ep_pair<true>(ep, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], a, b,
                        q),
          flip);
    }
  }
}

// ---- the block's state -----------------------------------------------------

struct Ctx {
  const Maps& maps;
  const Chain& p;
  uint8_t* smem;
  Layout L;
  uint64_t *res_full, *res_empty, *halo_full, *halo_empty;
  int tid, wg, tw, lane;
};

// The residual ring: slots of `bytes`, `n` of them, from L.res.
struct Res {
  Slot at;
  int n, bytes;
};

// What the producer issued of the next phase before the grid barrier: the
// weight stages of its first unit (they depend on no earlier phase), and
// for K1's tile the armed stages its x loads go into after the barrier.
constexpr int MAX_PRE = 12;
struct Pre {
  int n = 0;
  uint8_t* st[MAX_PRE];
  uint64_t* bar[MAX_PRE];
};

// ---- phase A and split conv3: K1's tile ------------------------------------

// C = A x W^T, A the (M, K) rows of map `in` (64 x 128 boxes), W rows
// w_row0 .. of map `wmap`; 128 x BN tiles, warpgroup wg rows 64 wg ..;
// the requant (+ the int8 residual, 128 x 64 boxes of `resmap`, with RES)
// into the (M, N) rows of map `outmap` (BN x 64 boxes).
// Narrow rows (raw_w: w's K-byte rows, w_rows of them; one k-stage, K <
// 64): x and w come as bulk copies of their tiles' rows (RawRows).
struct Narrow {
  const int8_t *x, *w;
  int w_rows;
  // bytes of the tile's rows from row r0 of `rows` rows, at most n
  __device__ __forceinline__ static int bytes(int r0, int rows, int n,
                                              int K) {
    return min(n, rows - r0) * K;
  }
};

template <int BN>
__device__ void gemm_prefetch(PRing& ring, Pre& pre, const CUtensorMap* wm,
                              int M, int N, int K, int w_row0,
                              const Narrow* nw) {
  const int ntn = (N + BN - 1) / BN;
  pre.n = 0;
  if (static_cast<int>(blockIdx.x) >= (M + 127) / 128 * ntn) return;
  const int n0 = blockIdx.x % ntn * BN, kts = (K + 63) / 64;
  const int m0 = blockIdx.x / ntn * 128;
  for (; pre.n < kts && pre.n < MAX_PRE && 2 * pre.n + 4 <= ring.stages;
       ++pre.n) {
    pre.st[pre.n] = ring.take(nw ? Narrow::bytes(m0, M, 128, K) : XBYTES,
                              pre.bar[pre.n]);
    uint64_t* bar;
    if (nw) {
      const int wb = Narrow::bytes(w_row0 + n0, nw->w_rows, BN, K);
      uint8_t* st = ring.take(wb, bar);
      bulk_load(st, nw->w + static_cast<size_t>(w_row0 + n0) * K, wb, bar);
    } else {
      uint8_t* st = ring.take(BN * 64, bar);
      tma_load(st, wm, bar, pre.n * 64, w_row0 + n0);
    }
  }
}

template <int BN, bool RES>
__device__ void gemm_produce(Ctx& x, PRing& ring, Res& rr, Pre& pre, int M,
                             int N, int K, int in, int wmap, int w_row0,
                             int resmap, const Narrow* nw = nullptr) {
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (M + 127) / 128 * ntn, kts = (K + 63) / 64;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / ntn * 128, n0 = t % ntn * BN;
    const int xbytes = nw ? Narrow::bytes(m0, M, 128, K) : XBYTES;
    auto load_x = [&](uint8_t* st, uint64_t* bar, int kt) {
      if (nw)
        bulk_load(st, nw->x + static_cast<size_t>(m0) * K, xbytes, bar);
      else
        tma_load(st, &x.maps.m[in], bar, kt * 64, m0);
    };
    // the first tile's x stages armed before the barrier
    for (int kt = 0; kt < pre.n; ++kt) load_x(pre.st[kt], pre.bar[kt], kt);
    const int kt0 = pre.n;
    pre.n = 0;
    for (int kt = kt0; kt < kts; ++kt) {  // x's stage, then w's
      uint64_t* bar;
      uint8_t* st = ring.take(xbytes, bar);
      load_x(st, bar, kt);
      if (nw) {
        const int wb = Narrow::bytes(w_row0 + n0, nw->w_rows, BN, K);
        st = ring.take(wb, bar);
        bulk_load(st, nw->w + static_cast<size_t>(w_row0 + n0) * K, wb,
                  bar);
      } else {
        st = ring.take(BN * 64, bar);
        tma_load(st, &x.maps.m[wmap], bar, kt * 64, w_row0 + n0);
      }
    }
    if (RES) {  // after the tile's k-stages: the wait holds back no load
      mbar_wait(&x.res_empty[rr.at.s], rr.at.ph ^ 1);
      const bool two = m0 + 64 < M;
      mbar_expect_tx(&x.res_full[rr.at.s], (two ? 2 : 1) * 64 * BN);
      uint8_t* buf = x.smem + x.L.res + rr.at.s * rr.bytes;
      tma_load(buf, &x.maps.m[resmap], &x.res_full[rr.at.s], n0, m0);
      if (two)
        tma_load(buf + SLAB, &x.maps.m[resmap], &x.res_full[rr.at.s], n0,
                 m0 + 64);
      rr.at.step(rr.n);
    }
  }
}

// narrow: the x and w stages are K-byte rows, repacked here (RawRows).
template <int BN, bool RES>
__device__ void gemm_consume(Ctx& x, CRing& ring, Res& rr, int M, int N,
                             int K, const Epilogue& ep, int outmap,
                             bool narrow = false) {
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (M + 127) / 128 * ntn, kts = (K + 63) / 64;
  float* sA = reinterpret_cast<float*>(x.smem + x.L.coef_a) + x.wg * 256;
  float* sB = sA + 128;
  int ab_n0 = -1, par = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, par ^= 1) {
    // the warpgroup's two output slabs in turn
    uint8_t* cs = x.smem + x.L.obuf + (2 * x.wg + par) * SLAB;
    const int m0 = t / ntn * 128, n0 = t % ntn * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < kts; ++kt) {
      uint8_t* sx = ring.wait(0);
      uint8_t* sw = ring.wait(1);
      if (narrow) {
        RawRows rx, rw;
        rx.read(sx, K, 128, x.tid);
        rw.read(sw, K, BN, x.tid);
        named_bar(1, NCONS);  // every raw row read
        rx.write(sx, 128, x.tid);
        rw.write(sw, BN, x.tid);
        fence_async_smem();
        named_bar(1, NCONS);
      }
      const uint64_t da = desc_sw64(sx + x.wg * 64 * 64);
      const uint64_t db = desc_sw64(sw);
      wgmma_fence();
      wgmma_tile<BN>(acc, da, db, 1);
      wgmma_tile<BN>(acc, da + 2, db + 2, 1);  // k + 32: 32 bytes on
      ring.done(x.lane, 2);
    }
    ring.drain(x.lane);
    const long long c0 = PHASE_CLOCK();
    // the slab's last store has read it; A, B rows in while the tile
    // column stays
    if (x.tw == 0) bulk_wait_read<1>();
    if (n0 != ab_n0) {
      for (int i = x.tw; i < BN; i += 128) {
        const int n = n0 + i;
        sA[i] = n < N ? ep.A[n] : 0.f;
        sB[i] = n < N ? ep.B[n] : 0.f;
      }
      ab_n0 = n0;
    }
    named_bar(4 + x.wg, 128);
    const uint8_t* rs = nullptr;
    if (RES) {
      mbar_wait(&x.res_full[rr.at.s], rr.at.ph);
      rs = x.smem + x.L.res + rr.at.s * rr.bytes + x.wg * SLAB;
    }
    fill_slab<BN, BN, RES>(acc, ep, sA, sB, rs, cs, 0, x.tw);
    fence_async_smem();
    named_bar(4 + x.wg, 128);
    const int m = m0 + 64 * x.wg;
    if (x.tw == 0) {
      if (m < M) {
        tma_store(&x.maps.m[outmap], cs, n0, m);
        bulk_commit();
      }
      if (RES) mbar_arrive(&x.res_empty[rr.at.s]);
    }
    if (RES) rr.at.step(rr.n);
    ring.pr->add(ring.sw + 2, PHASE_CLOCK() - c0);
  }
  if (x.tw == 0) bulk_wait_all();
}

// ---- K7's phase B: K5's tile, and split mode's conv2 ------------------------

// The halo of tm 8 x 8 tiles from t0 (all Cm channels of workspace a, 16-
// channel boxes) into the halo buffer once it is free.
template <int TM>
__device__ void halo_produce(Ctx& x, Slot& hb, int t0) {
  const Chain& p = x.p;
  const int nch = p.Cm / 16, hbytes = nch * CHP;
  mbar_wait(x.halo_empty, hb.ph ^ 1);
  mbar_expect_tx(x.halo_full, TM * nch * HPIX * 16);
  for (int w = 0; w < TM; ++w) {
    const Tile8 t(p.H, p.W, t0 + w);
    for (int c = 0; c < nch; ++c)
      tma_load4(x.smem + x.L.halo + w * hbytes + c * CHP, &x.maps.m[M_A4],
                x.halo_full, 16 * c, t.tx0 - 1, t.ty0 - 1, t.b);
  }
  hb.step(1);
}

// The halo has landed: the zero point over its pixels outside the image,
// fenced for the wgmmas, every consumer past it.
template <int TM>
__device__ void halo_consume(Ctx& x, Slot& hb, int t0, int zp) {
  const Chain& p = x.p;
  mbar_wait(x.halo_full, hb.ph);
  hb.step(1);
  for (int w = 0; w < TM; ++w) {
    const Tile8 t(p.H, p.W, t0 + w);
    wt::zp_fill(x.smem + x.L.halo + w * (p.Cm / 16) * CHP, 0, p.Cm / 16,
                t.ty0 - 1, t.tx0 - 1, p.H, p.W, zp, x.tid);
  }
  fence_async_smem();
  named_bar(1, NCONS);
}

// conv2's weight stages of one W2-wide pass at channel np (k2p stages:
// with KSPLIT a zero stage past w2's rows pads them to pairs), from map
// wmap (the chain's stacked w2; K8's projection conv2).
template <int W2, bool KSPLIT>
__device__ void conv2_produce(Ctx& x, PRing& ring, int row0, int np,
                              int kt0 = 0, int wmap = M_W2) {
  const int k2t = 9 * x.p.Cm / 64, k2p = KSPLIT ? (k2t + 1) & ~1 : k2t;
  for (int kt = kt0; kt < k2p; ++kt) {
    uint64_t* bar;
    uint8_t* st = ring.take(W2 * 64, bar);
    tma_load(st, &x.maps.m[wmap], bar, 64 * kt, row0 + np);
  }
}

// conv2's first stages of pass np of the next phase's first unit, before
// the barrier (the halo, after it, lies outside the ring).
template <int W2, bool KSPLIT>
__device__ void conv2_prefetch(Ctx& x, PRing& ring, Pre& pre, int units,
                               int row0, int np, int wmap = M_W2) {
  const int k2t = 9 * x.p.Cm / 64, k2p = KSPLIT ? (k2t + 1) & ~1 : k2t;
  pre.n = 0;
  if (static_cast<int>(blockIdx.x) >= units) return;
  for (; pre.n < k2p && pre.n + 2 <= ring.stages && pre.n < MAX_PRE;
       ++pre.n) {
    uint64_t* bar;
    uint8_t* st = ring.take(W2 * 64, bar);
    tma_load(st, &x.maps.m[wmap], bar, 64 * pre.n, row0 + np);
  }
}

// conv2 of one W2-wide pass at channel np from the halo `halo`: the
// warpgroup's columns (N2 = 64 of a 128-wide pass at c2 = 64 wg), or with
// KSPLIT (64-wide passes) alternate stages summed through shared memory,
// the warpgroup ending with 32 columns at 32 wg in acc[0..15].
template <int W2, bool KSPLIT>
__device__ void conv2_pass(Ctx& x, CRing& ring, uint8_t* halo, int (&acc)[32],
                           uint8_t* scratch) {
  const int k2t = 9 * x.p.Cm / 64;
  wt::HaloWalk hw{smem_u32(halo), x.p.Cm / 64, 0, 0, 0};
  constexpr uint32_t K32_HALO = 2 * CHP >> 4;  // the next 32 channels
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  if constexpr (KSPLIT) {  // warpgroup wg: stages wg, wg + 2, ...
    const int k2p = (k2t + 1) & ~1;
    hw.advance(x.wg);
    for (int kt = 0; kt < k2p; kt += 2) {
      uint8_t* st0 = ring.wait(0);
      uint8_t* st1 = ring.wait(1);
      const uint64_t da = hw.desc();
      hw.advance(2);
      const uint64_t db = desc_sw64(x.wg ? st1 : st0);
      wgmma_fence();
      wg::wgmma_m64n64k32(acc, da, db, 1);
      wg::wgmma_m64n64k32(acc, da + K32_HALO, db + 2, 1);
      ring.done(x.lane, 2);
    }
    ring.drain(x.lane);
    wt::reduce_halves(acc, x.wg, x.tw, scratch);
    if (x.wg)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = acc[16 + i];
  } else {
    for (int kt = 0; kt < k2t; ++kt) {
      uint8_t* st = ring.wait();
      const uint64_t da = hw.desc();
      hw.advance(1);
      const uint64_t db = desc_sw64(st + x.wg * 64 * 64);
      wgmma_fence();
      wgmma_n<64>(acc, da, db);
      wgmma_n<64>(acc, da + K32_HALO, db + 2);
      ring.done(x.lane);
    }
    ring.drain(x.lane);
  }
}

// K5's tile at cs = 1 on unit u (TM tiles): the producer's side.
template <int W2, int TM>
__device__ void tail_produce(Ctx& x, PRing& ring, Res& rr, Slot& hb,
                             Pre& pre, int i, int in4) {
  const Chain& p = x.p;
  constexpr bool KSPLIT = TM == 1 && W2 == 64;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int units = (tiles + TM - 1) / TM;
  const int np3 = p.C / 128, k3t = p.Cm / 64;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t0 = u * TM;
    halo_produce<TM>(x, hb, t0);
    auto residual = [&](int q) {
      mbar_wait(&x.res_empty[rr.at.s], rr.at.ph ^ 1);
      mbar_expect_tx(&x.res_full[rr.at.s], TM * SLAB);
      for (int w = 0; w < TM; ++w) {
        const Tile8 t(p.H, p.W, t0 + w);
        tma_load4(x.smem + x.L.res + rr.at.s * rr.bytes + w * SLAB,
                  &x.maps.m[in4], &x.res_full[rr.at.s], 128 * q, t.tx0,
                  t.ty0, t.b);
      }
      rr.at.step(rr.n);
    };
    for (int q = 0; q < rr.n && q < np3; ++q) residual(q);
    for (int np = 0; np < p.Cm; np += W2) {
      conv2_produce<W2, KSPLIT>(x, ring, i * p.Cm, np, np == 0 ? pre.n : 0);
    }
    pre.n = 0;
    for (int q = 0; q < np3; ++q) {
      for (int kt = 0; kt < k3t; ++kt) {
        uint64_t* bar;
        uint8_t* st = ring.take(128 * 64, bar);
        tma_load(st, &x.maps.m[M_W3], bar, 64 * kt, i * p.C + 128 * q);
      }
      if (q >= rr.n) residual(q);
    }
  }
}

// K5's tile at cs = 1: the consumers' side.  TM = 1: conv2 as conv2_pass,
// conv3 in 128-wide passes, each warpgroup 64 of the columns, thread 0
// storing the tile; TM = 2: warpgroup wg takes tile wg whole (conv2's W2
// and conv3's 128 columns) and stores it.
template <int W2, int TM>
__device__ void tail_consume(Ctx& x, CRing& ring, Res& rr, Slot& hb,
                             int& oc, const Epilogue& ep2, const Epilogue& ep3,
                             int zp, int dst4) {
  const Chain& p = x.p;
  constexpr bool KSPLIT = TM == 1 && W2 == 64;
  constexpr int N2 = TM == 1 ? 64 : W2;   // a warpgroup's conv2 columns
  constexpr int N3 = TM == 1 ? 64 : 128;  // and conv3's
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int units = (tiles + TM - 1) / TM;
  const int np3 = p.C / 128, k3t = p.Cm / 64;
  const int tb = TM == 1 ? 0 : x.wg;
  const int c2 = TM == 1 ? x.wg * 64 : 0, c3 = TM == 1 ? x.wg * 64 : 0;
  uint8_t* my_halo = x.smem + x.L.halo + tb * (p.Cm / 16) * CHP;
  uint8_t* my_mid = x.smem + x.L.mid + tb * 64 * p.Cm;
  const float* sA2 = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sB2 = sA2 + p.Cm;
  const float* sA3 = sB2 + p.Cm;
  const float* sB3 = sA3 + p.C;
  const bool storer = TM == 1 ? x.tid == 0 : x.tw == 0;
  const int bar_id = TM == 1 ? 1 : 2 + x.wg, bar_n = TM == 1 ? NCONS : 128;
  auto all_rows = [](int) { return true; };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t0 = u * TM;
    const Tile8 my(p.H, p.W, t0 + tb);
    long long c0 = PHASE_CLOCK();
    halo_consume<TM>(x, hb, t0, zp);
    ring.pr->add(3, PHASE_CLOCK() - c0);
    // conv2 into mid
    for (int np = 0; np < p.Cm; np += W2) {
      c0 = PHASE_CLOCK();
      if constexpr (TM == 1) {
        int acc[32];
        conv2_pass<W2, KSPLIT>(x, ring, my_halo, acc,
                               x.smem + x.L.obuf + 2 * SLAB);
        ring.pr->add(4, PHASE_CLOCK() - c0);
        c0 = PHASE_CLOCK();
        if constexpr (KSPLIT) {
          int half[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) half[k] = acc[k];
          wt::requant_rows<32>(half, sA2 + np + 32 * x.wg,
                               sB2 + np + 32 * x.wg, ep2.lo, ep2.hi,
                               ep2.shift, np + 32 * x.wg, my_mid, MCHP, 0,
                               all_rows, x.tw);
        } else {
          wt::requant_rows<64>(acc, sA2 + np + c2, sB2 + np + c2, ep2.lo,
                               ep2.hi, ep2.shift, np + c2, my_mid, MCHP, 0,
                               all_rows, x.tw);
        }
      } else {  // TM = 2: the warpgroup's own tile, all W2 columns
        int acc[N2 / 2];
#pragma unroll
        for (int k = 0; k < N2 / 2; ++k) acc[k] = 0;
        wt::HaloWalk hw{smem_u32(my_halo), p.Cm / 64, 0, 0, 0};
        constexpr uint32_t K32_HALO = 2 * CHP >> 4;
        const int k2t = 9 * p.Cm / 64;
        for (int kt = 0; kt < k2t; ++kt) {
          uint8_t* st = ring.wait();
          const uint64_t da = hw.desc();
          hw.advance(1);
          const uint64_t db = desc_sw64(st);
          wgmma_fence();
          wgmma_n<N2>(acc, da, db);
          wgmma_n<N2>(acc, da + K32_HALO, db + 2);
          ring.done(x.lane);
        }
        ring.drain(x.lane);
        ring.pr->add(4, PHASE_CLOCK() - c0);
        c0 = PHASE_CLOCK();
        wt::requant_rows<N2>(acc, sA2 + np, sB2 + np, ep2.lo, ep2.hi,
                             ep2.shift, np, my_mid, MCHP, 0, all_rows, x.tw);
      }
      ring.pr->add(5, PHASE_CLOCK() - c0);
    }
    // the halo is free (every warp's wgmmas on it are done); mid is whole
    if (x.lane == 0) mbar_arrive(x.halo_empty);
    fence_async_smem();
    named_bar(1, NCONS);
    // conv3 + residual
    const uint32_t mid_a = smem_u32(my_mid);
    constexpr uint32_t K32_MID = 2 * MCHP >> 4;
    for (int q = 0; q < np3; ++q) {
      int acc[N3 / 2];
#pragma unroll
      for (int k = 0; k < N3 / 2; ++k) acc[k] = 0;
      for (int kt = 0; kt < k3t; ++kt) {
        uint8_t* st = ring.wait();
        const uint64_t da = desc_ns(mid_a + 4 * kt * MCHP, MCHP, 128);
        const uint64_t db = desc_sw64(st + c3 * 64);
        wgmma_fence();
        wgmma_n<N3>(acc, da, db);
        wgmma_n<N3>(acc, da + K32_MID, db + 2);
        ring.done(x.lane);
      }
      ring.drain(x.lane);
      c0 = PHASE_CLOCK();
      // the output slab's last store has read it
      if (storer) bulk_wait_read<1>();
      named_bar(bar_id, bar_n);
      mbar_wait(&x.res_full[rr.at.s], rr.at.ph);
      uint8_t* cs = x.smem + x.L.obuf + (TM == 1 ? oc : 2 * tb + oc) * SLAB;
      fill_slab<N3, 128, true>(acc, ep3, sA3 + 128 * q + c3,
                               sB3 + 128 * q + c3,
                               x.smem + x.L.res + rr.at.s * rr.bytes +
                                   tb * SLAB,
                               cs, c3, x.tw);
      fence_async_smem();
      named_bar(bar_id, bar_n);
      if (storer) {
        tma_store4(&x.maps.m[dst4], cs, 128 * q, my.tx0, my.ty0, my.b);
        bulk_commit();
        mbar_arrive(&x.res_empty[rr.at.s]);
      }
      rr.at.step(rr.n);
      oc ^= 1;
      ring.pr->add(8, PHASE_CLOCK() - c0);
    }
    ring.pr->add(10, TM);
  }
  if (storer) bulk_wait_all();
}

// Split mode's conv2 (and K8's projection conv2, phase P1, from map wmap):
// units (8 x 8 tile, W2-wide pass), conv2's codes into workspace b (NHWC,
// W2 x 8 x 8 boxes).
template <int W2>
__device__ void conv2_units_produce(Ctx& x, PRing& ring, Slot& hb, Pre& pre,
                                    int i, int wmap = M_W2) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int npass = p.Cm / W2;
  for (int u = blockIdx.x; u < tiles * npass; u += gridDim.x) {
    halo_produce<1>(x, hb, u / npass);
    conv2_produce<W2, W2 == 64>(x, ring, i * p.Cm, u % npass * W2, pre.n,
                                wmap);
    pre.n = 0;
  }
}

template <int W2>
__device__ void conv2_units_consume(Ctx& x, CRing& ring, Slot& hb, int& oc,
                                    const Epilogue& ep2, int zp) {
  const Chain& p = x.p;
  constexpr bool KSPLIT = W2 == 64;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int npass = p.Cm / W2;
  const float* sA2 = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sB2 = sA2 + p.Cm;
  uint8_t* halo = x.smem + x.L.halo;
  for (int u = blockIdx.x; u < tiles * npass; u += gridDim.x) {
    const Tile8 my(p.H, p.W, u / npass);
    const int np = u % npass * W2;
    long long c0 = PHASE_CLOCK();
    halo_consume<1>(x, hb, u / npass, zp);
    int acc[32];
    conv2_pass<W2, KSPLIT>(x, ring, halo, acc, x.smem + x.L.obuf + 2 * SLAB);
    if (x.lane == 0) mbar_arrive(x.halo_empty);
    // the slab's last store has read it
    if (x.tid == 0) bulk_wait_read<1>();
    named_bar(1, NCONS);
    uint8_t* cs = x.smem + x.L.obuf + oc * SLAB;
    if constexpr (KSPLIT) {
      int half[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) half[k] = acc[k];
      fill_slab<32, 64, false>(half, ep2, sA2 + np + 32 * x.wg,
                               sB2 + np + 32 * x.wg, nullptr, cs, 32 * x.wg,
                               x.tw);
    } else {
      fill_slab<64, 128, false>(acc, ep2, sA2 + np + 64 * x.wg,
                                sB2 + np + 64 * x.wg, nullptr, cs,
                                64 * x.wg, x.tw);
    }
    fence_async_smem();
    named_bar(1, NCONS);
    if (x.tid == 0) {
      tma_store4(&x.maps.m[M_B4], cs, np, my.tx0, my.ty0, my.b);
      bulk_commit();
    }
    oc ^= 1;
    ring.pr->add(11, PHASE_CLOCK() - c0);
    ring.pr->add(10, 1);
  }
  if (x.tid == 0) bulk_wait_all();
}

// K8's projection conv2 (phase P1) where a unit of the plan holds two 8 x 8
// tiles (its halo buffer two tiles): units (tile pair, W2-wide pass), each
// consumer warpgroup conv2 of its own tile over the whole K from its own
// halo, both on the same weight stages (no K split, no reduction), its
// codes into workspace b (NHWC, W2 x 8 x 8 boxes) by its own TMA store.
template <int W2>
__device__ void conv2_pairs_produce(Ctx& x, PRing& ring, Slot& hb, Pre& pre,
                                    int wmap) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int npass = p.Cm / W2;
  for (int u = blockIdx.x; u < (tiles + 1) / 2 * npass; u += gridDim.x) {
    halo_produce<2>(x, hb, u / npass * 2);
    conv2_produce<W2, false>(x, ring, 0, u % npass * W2, pre.n, wmap);
    pre.n = 0;
  }
}

template <int W2>
__device__ void conv2_pairs_consume(Ctx& x, CRing& ring, Slot& hb,
                                    const Epilogue& ep2, int zp) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int npass = p.Cm / W2, k2t = 9 * p.Cm / 64;
  constexpr uint32_t K32_HALO = 2 * CHP >> 4;  // the next 32 channels
  const float* sA2 = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sB2 = sA2 + p.Cm;
  uint8_t* my_halo = x.smem + x.L.halo + x.wg * (p.Cm / 16) * CHP;
  int par = 0;
  for (int u = blockIdx.x; u < (tiles + 1) / 2 * npass; u += gridDim.x,
           par ^= 1) {
    const int t = u / npass * 2 + x.wg, np = u % npass * W2;
    const Tile8 my(p.H, p.W, t);
    const long long c0 = PHASE_CLOCK();
    halo_consume<2>(x, hb, u / npass * 2, zp);
    int acc[W2 / 2];
#pragma unroll
    for (int k = 0; k < W2 / 2; ++k) acc[k] = 0;
    wt::HaloWalk hw{smem_u32(my_halo), p.Cm / 64, 0, 0, 0};
    for (int kt = 0; kt < k2t; ++kt) {
      uint8_t* st = ring.wait();
      const uint64_t da = hw.desc();
      hw.advance(1);
      const uint64_t db = desc_sw64(st);
      wgmma_fence();
      wgmma_n<W2>(acc, da, db);
      wgmma_n<W2>(acc, da + K32_HALO, db + 2);
      ring.done(x.lane);
    }
    ring.drain(x.lane);
    if (x.lane == 0) mbar_arrive(x.halo_empty);
    // the slab's last store has read it
    if (x.tw == 0) bulk_wait_read<1>();
    named_bar(4 + x.wg, 128);
    uint8_t* cs = x.smem + x.L.obuf + (2 * x.wg + par) * SLAB;
    fill_slab<W2, W2, false>(acc, ep2, sA2 + np, sB2 + np, nullptr, cs, 0,
                             x.tw);
    fence_async_smem();
    named_bar(4 + x.wg, 128);
    if (x.tw == 0 && t < tiles) {
      tma_store4(&x.maps.m[M_B4], cs, np, my.tx0, my.ty0, my.b);
      bulk_commit();
    }
    ring.pr->add(11, PHASE_CLOCK() - c0);
    ring.pr->add(10, 1);
  }
  if (x.tw == 0) bulk_wait_all();
}

// ---- K8's phase P2: the projection's conv3 + downsample ---------------------

// The two-GEMM tile (wgmma_gemm.cuh: td_slab) on K1's 128 x 128 tiles of the
// (M, C) output: per tile the downsample's k-stages (x's rows, map M_XP2,
// and wd's, M_WD), then conv3's (workspace b's rows, M_B2, and w3's,
// M_WP3).  The first tile's x stages go into the stages `pre` armed before
// the barrier (gemm_prefetch of wd).
__device__ void proj_produce(Ctx& x, PRing& ring, Pre& pre) {
  const Chain& p = x.p;
  const int ntn = p.C / 128;
  const int tiles = (p.M + 127) / 128 * ntn;
  const int kd = p.Cp / 64, k3 = p.Cm / 64;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / ntn * 128, n0 = t % ntn * 128;
    for (int kt = 0; kt < pre.n; ++kt)
      tma_load(pre.st[kt], &x.maps.m[M_XP2], pre.bar[kt], kt * 64, m0);
    const int kt0 = pre.n;
    pre.n = 0;
    for (int kt = kt0; kt < kd + k3; ++kt) {  // x's stage, then w's
      const bool down = kt < kd;
      const int k = down ? kt : kt - kd;
      uint64_t* bar;
      uint8_t* st = ring.take(XBYTES, bar);
      tma_load(st, &x.maps.m[down ? M_XP2 : M_B2], bar, k * 64, m0);
      st = ring.take(128 * 64, bar);
      tma_load(st, &x.maps.m[down ? M_WD : M_WP3], bar, k * 64, n0);
    }
  }
}

// The epilogue of warpgroup wg's 64 x 128 output slab (fill_slab's layout)
// with the f32 residual td from the two-GEMM tile's residual tile `td`.
__device__ __forceinline__ void fill_td(const int (&acc)[64],
                                        const Epilogue& ep, const float* sA,
                                        const float* sB, const uint8_t* td,
                                        uint8_t* cs, int wg, int tw) {
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
  const unsigned flip = ep.shift != 0.f ? 0x8080u : 0u;  // - shift, mod 256
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 a = *reinterpret_cast<const float2*>(sA + c);
    const float2 b = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float2 q = *reinterpret_cast<const float2*>(
          wg::res_at<128, 128, 4>(td, wg, r, c));
      *reinterpret_cast<unsigned short*>(cs + swz<128>(r * 128 + c)) =
          code_pair(ep,
                    ep_pair<true>(ep, acc[4 * j + 2 * h],
                                  acc[4 * j + 2 * h + 1], a, b, q),
                    flip);
    }
  }
}

// n k-steps of K1's tile (an x stage and a w stage each) into acc, zeroed
// first; every stage freed.
__device__ __forceinline__ void proj_product(Ctx& x, CRing& ring,
                                             int (&acc)[64], int n) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < n; ++kt) {
    uint8_t* sx = ring.wait(0);
    uint8_t* sw = ring.wait(1);
    const uint64_t da = desc_sw64(sx + x.wg * 64 * 64);
    const uint64_t db = desc_sw64(sw);
    wgmma_fence();
    wgmma_tile<128>(acc, da, db, 1);
    wgmma_tile<128>(acc, da + 2, db + 2, 1);  // k + 32: 32 bytes on
    ring.done(x.lane, 2);
  }
  ring.drain(x.lane);
}

// The consumers' side: accumulate the downsample, write td (Ad, Bd from
// coef_b, loaded for all C columns at the phase's start) into the td tile
// at L.res, run conv3 into the same registers, and requant with td as the
// f32 residual (C3 = ep.C) into the output slabs, stored by TMA to map
// `outmap` (128 x 64 boxes).
__device__ void proj_consume(Ctx& x, CRing& ring, const Epilogue& ep,
                             int outmap) {
  const Chain& p = x.p;
  const int ntn = p.C / 128;
  const int tiles = (p.M + 127) / 128 * ntn;
  const int kd = p.Cp / 64, k3 = p.Cm / 64;
  float* sA = reinterpret_cast<float*>(x.smem + x.L.coef_a) + x.wg * 256;
  float* sB = sA + 128;
  const float* sAd = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sBd = sAd + p.C;
  uint8_t* td = x.smem + x.L.res;
  int ab_n0 = -1, par = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, par ^= 1) {
    uint8_t* cs = x.smem + x.L.obuf + (2 * x.wg + par) * SLAB;
    const int m0 = t / ntn * 128, n0 = t % ntn * 128;
    int acc[64];
    proj_product(x, ring, acc, kd);
    wg::td_slab<128, 128>(acc, sAd + n0, sBd + n0, td, x.wg, x.tw);
    proj_product(x, ring, acc, k3);
    const long long c0 = PHASE_CLOCK();
    // the slab's last store has read it; A, B rows in while the tile
    // column stays
    if (x.tw == 0) bulk_wait_read<1>();
    if (n0 != ab_n0) {
      sA[x.tw] = ep.A[n0 + x.tw];
      sB[x.tw] = ep.B[n0 + x.tw];
      ab_n0 = n0;
    }
    named_bar(4 + x.wg, 128);
    fill_td(acc, ep, sA, sB, td, cs, x.wg, x.tw);
    fence_async_smem();
    named_bar(4 + x.wg, 128);
    const int m = m0 + 64 * x.wg;
    if (x.tw == 0 && m < p.M) {
      tma_store(&x.maps.m[outmap], cs, n0, m);
      bulk_commit();
    }
    ring.pr->add(ring.sw + 2, PHASE_CLOCK() - c0);
  }
  if (x.tw == 0) bulk_wait_all();
}

// ---- K9's phase B: the depthwise + project tile -----------------------------

template <bool NARROW>
__device__ void dwproj_produce(Ctx& x, PRing& ring, Res& rr, int i,
                               int in4) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int G = (p.Cm + 63) / 64, np3 = (p.C + 127) / 128;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    const Tile8 t(p.H, p.W, u);
    for (int g = 0; g < G; ++g) {
      uint64_t* bar;
      uint8_t* st = ring.take(DW_STAGE, bar);
      tma_load4(st, &x.maps.m[M_A4], bar, 64 * g, t.tx0 - 1, t.ty0 - 1, t.b);
    }
    auto residual = [&](int q) {
      mbar_wait(&x.res_empty[rr.at.s], rr.at.ph ^ 1);
      uint8_t* dst = x.smem + x.L.res + rr.at.s * rr.bytes;
      if constexpr (NARROW) {  // 8 rows of 8·C bytes (one pass)
        mbar_expect_tx(&x.res_full[rr.at.s], 64 * p.C);
        tma_load3(dst, &x.maps.m[in4], &x.res_full[rr.at.s], t.tx0 * p.C,
                  t.ty0, t.b);
      } else {
        mbar_expect_tx(&x.res_full[rr.at.s], SLAB);
        tma_load4(dst, &x.maps.m[in4], &x.res_full[rr.at.s], 128 * q, t.tx0,
                  t.ty0, t.b);
      }
      rr.at.step(rr.n);
    };
    for (int q = 0; q < rr.n && q < np3; ++q) residual(q);
    for (int q = 0; q < np3; ++q) {
      for (int kt = 0; kt < G; ++kt) {
        uint64_t* bar;
        uint8_t* st = ring.take(128 * 64, bar);
        tma_load(st, &x.maps.m[M_W3], bar, 64 * kt, i * p.C + 128 * q);
      }
      if (q >= rr.n) residual(q);
    }
  }
}

// The depthwise of one 64-channel halo stage `st` (10 x 10 pixels x 64
// channels, TMA's box) with qdepthwise.cu's arithmetic: a thread takes one
// output column and four channels (c .. c + 3) for four output rows (its
// half of the 8 x 8 tile), the nine taps sign-extended in registers, the
// window sliding down the column (three new words an output row), the
// zero point for a tap outside the image, the requant by code_bits; emit(k,
// codes) takes row 4 half + k's four codes.  Channels past E give zeros.
struct DwThread {
  int q4, col, half;
  unsigned rowin, colin;  // which window rows / columns lie in the image
  __device__ DwThread(const Chain& p, const Tile8& t, int tid)
      : q4(tid & 15), col((tid >> 4) & 7), half(tid >> 7), rowin(0),
        colin(0) {
    const int gy0 = t.ty0 - 1 + 4 * half, gx0 = t.tx0 - 1 + col;
#pragma unroll
    for (int r = 0; r < 6; ++r)
      rowin |= static_cast<unsigned>(gy0 + r >= 0 && gy0 + r < p.H) << r;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      colin |= static_cast<unsigned>(gx0 + d >= 0 && gx0 + d < p.W) << d;
  }
  template <class Emit>
  __device__ __forceinline__ void run(const uint8_t* st, const int8_t* wd,
                                      int E, int c, const float* sA2,
                                      const float* sB2, const Epilogue& ep2,
                                      unsigned zw, Emit emit) const {
    if (c >= E) {
#pragma unroll
      for (int k = 0; k < 4; ++k) emit(k, 0u);
      return;
    }
    const unsigned flip = ep2.shift != 0.f ? 0x80808080u : 0u;
    int wt[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned v =
          __ldg(reinterpret_cast<const unsigned*>(wd + tap * E + c));
#pragma unroll
      for (int e = 0; e < 4; ++e) wt[tap][e] = sbyte(v, e);
    }
    const float4 a = *reinterpret_cast<const float4*>(sA2 + c);
    const float4 b = *reinterpret_cast<const float4*>(sB2 + c);
    const uint8_t* colp = st + (4 * half * 10 + col) * 64 + 4 * q4;
    auto row = [&](int r, unsigned (&v)[3]) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        v[d] = ((rowin >> r) & (colin >> d) & 1u)
                   ? *reinterpret_cast<const unsigned*>(colp +
                                                        (r * 10 + d) * 64)
                   : zw;
    };
    unsigned w0[3], w1[3], w2[3];
    row(0, w0);
    row(1, w1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row(k + 2, w2);
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] += sbyte(w0[kw], e) * wt[kw][e] +
                    sbyte(w1[kw], e) * wt[3 + kw][e] +
                    sbyte(w2[kw], e) * wt[6 + kw][e];
      const float t0 = ep_affine(acc[0], a.x, b.x);
      const float t1 = ep_affine(acc[1], a.y, b.y);
      const float t2 = ep_affine(acc[2], a.z, b.z);
      const float t3 = ep_affine(acc[3], a.w, b.w);
      emit(k, __byte_perm(__byte_perm(code_bits(ep2, t0), code_bits(ep2, t1),
                                      0x0040),
                          __byte_perm(code_bits(ep2, t2), code_bits(ep2, t3),
                                      0x0040),
                          0x5410) ^
                  flip);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        w0[d] = w1[d];
        w1[d] = w2[d];
      }
    }
  }
};

// The fused tile: the depthwise of every 64-channel stage into `mid`
// ([16-channel chunk][64 rows][16 B], wgmma's K-major layout), then the
// project (K = E) with the residual, as K5's conv3.
template <bool NARROW>
__device__ void dwproj_consume(Ctx& x, CRing& ring, Res& rr, int& oc,
                               const Epilogue& ep2, const Epilogue& ep3,
                               int zp, int i, int dst4) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int G = (p.Cm + 63) / 64, np3 = (p.C + 127) / 128;
  const int E = p.Cm;
  const float* sA2 = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sB2 = sA2 + up(E, 64);
  const float* sA3 = sB2 + up(E, 64);
  const float* sB3 = sA3 + up(p.C, 128);
  uint8_t* mid = x.smem + x.L.mid;
  const unsigned zw = (static_cast<unsigned>(zp) & 0xffu) * 0x01010101u;
  const int8_t* wd = p.wd + static_cast<size_t>(i) * 9 * E;
  const int c3 = x.wg * 64;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    const Tile8 my(p.H, p.W, u);
    const DwThread dw(p, my, x.tid);
    // every consumer is done with the last tile's mid
    named_bar(1, NCONS);
    long long c0 = PHASE_CLOCK();
    for (int g = 0; g < G; ++g) {
      const uint8_t* st = ring.wait();
      uint8_t* dst = mid + (4 * g + (dw.q4 >> 2)) * MCHP + (dw.q4 & 3) * 4;
      dw.run(st, wd, E, 64 * g + 4 * dw.q4, sA2, sB2, ep2, zw,
             [&](int k, unsigned codes) {
               *reinterpret_cast<unsigned*>(
                   dst + ((4 * dw.half + k) * 8 + dw.col) * 16) = codes;
             });
      ring.free_now(x.lane);
    }
    fence_async_smem();
    named_bar(1, NCONS);
    ring.pr->add(4, PHASE_CLOCK() - c0);
    // the project + residual, 128-wide passes, each warpgroup 64 columns
    const uint32_t mid_a = smem_u32(mid);
    constexpr uint32_t K32_MID = 2 * MCHP >> 4;
    for (int q = 0; q < np3; ++q) {
      int acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0;
      for (int kt = 0; kt < G; ++kt) {
        uint8_t* st = ring.wait();
        const uint64_t da = desc_ns(mid_a + 4 * kt * MCHP, MCHP, 128);
        const uint64_t db = desc_sw64(st + c3 * 64);
        wgmma_fence();
        wgmma_n<64>(acc, da, db);
        wgmma_n<64>(acc, da + K32_MID, db + 2);
        ring.done(x.lane);
      }
      ring.drain(x.lane);
      c0 = PHASE_CLOCK();
      if (x.tid == 0) bulk_wait_read<1>();
      named_bar(1, NCONS);
      mbar_wait(&x.res_full[rr.at.s], rr.at.ph);
      uint8_t* cs = x.smem + x.L.obuf + oc * SLAB;
      const uint8_t* rs = x.smem + x.L.res + rr.at.s * rr.bytes;
      if constexpr (NARROW)
        fill_narrow(acc, ep3, sA3 + c3, sB3 + c3, rs, cs, c3, p.C, x.tw);
      else
        fill_slab<64, 128, true>(acc, ep3, sA3 + 128 * q + c3,
                                 sB3 + 128 * q + c3, rs, cs, c3, x.tw);
      fence_async_smem();
      named_bar(1, NCONS);
      if (x.tid == 0) {
        if constexpr (NARROW)
          tma_store3(&x.maps.m[dst4], cs, my.tx0 * p.C, my.ty0, my.b);
        else
          tma_store4(&x.maps.m[dst4], cs, 128 * q, my.tx0, my.ty0, my.b);
        bulk_commit();
        mbar_arrive(&x.res_empty[rr.at.s]);
      }
      rr.at.step(rr.n);
      oc ^= 1;
      ring.pr->add(8, PHASE_CLOCK() - c0);
    }
    ring.pr->add(10, 1);
  }
  if (x.tid == 0) bulk_wait_all();
}

// Split mode's depthwise: units (8 x 8 tile, 64-channel group), the codes
// into workspace d (NHWC, 64 x 8 x 8 boxes under the 64-byte swizzle).
__device__ void dw_units_produce(Ctx& x, PRing& ring) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int G = (p.Cm + 63) / 64;
  for (int u = blockIdx.x; u < tiles * G; u += gridDim.x) {
    const Tile8 t(p.H, p.W, u / G);
    uint64_t* bar;
    uint8_t* st = ring.take(DW_STAGE, bar);
    tma_load4(st, &x.maps.m[M_A4], bar, 64 * (u % G), t.tx0 - 1, t.ty0 - 1,
              t.b);
  }
}

__device__ void dw_units_consume(Ctx& x, CRing& ring, int& oc,
                                 const Epilogue& ep2, int zp, int i) {
  const Chain& p = x.p;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int G = (p.Cm + 63) / 64, E = p.Cm;
  const float* sA2 = reinterpret_cast<const float*>(x.smem + x.L.coef_b);
  const float* sB2 = sA2 + up(E, 64);
  const unsigned zw = (static_cast<unsigned>(zp) & 0xffu) * 0x01010101u;
  const int8_t* wd = p.wd + static_cast<size_t>(i) * 9 * E;
  for (int u = blockIdx.x; u < tiles * G; u += gridDim.x) {
    const Tile8 my(p.H, p.W, u / G);
    const DwThread dw(p, my, x.tid);
    const int g = u % G;
    const long long c0 = PHASE_CLOCK();
    // the slab's last store has read it
    if (x.tid == 0) bulk_wait_read<1>();
    named_bar(1, NCONS);
    uint8_t* cs = x.smem + x.L.obuf + oc * SLAB;
    const uint8_t* st = ring.wait();
    dw.run(st, wd, E, 64 * g + 4 * dw.q4, sA2, sB2, ep2, zw,
           [&](int k, unsigned codes) {
             *reinterpret_cast<unsigned*>(
                 cs + swz<64>(((4 * dw.half + k) * 8 + dw.col) * 64 +
                              4 * dw.q4)) = codes;
           });
    ring.free_now(x.lane);
    fence_async_smem();
    named_bar(1, NCONS);
    if (x.tid == 0) {
      tma_store4(&x.maps.m[M_B4], cs, 64 * g, my.tx0, my.ty0, my.b);
      bulk_commit();
    }
    oc ^= 1;
    ring.pr->add(11, PHASE_CLOCK() - c0);
    ring.pr->add(10, 1);
  }
  if (x.tid == 0) bulk_wait_all();
}

// ---- the kernel -------------------------------------------------------------

// Block i's scalars (grid_phase.cuh's NSCAL row) as the three epilogues.
struct BlockEp {
  Epilogue e1, e2, e3;
  int zp;
  __device__ BlockEp(const Chain& p, int i)
      : BlockEp(p.a1 + static_cast<size_t>(i) * p.Cm,
                p.b1 + static_cast<size_t>(i) * p.Cm,
                p.a2 + static_cast<size_t>(i) * p.Cm,
                p.b2 + static_cast<size_t>(i) * p.Cm,
                p.a3 + static_cast<size_t>(i) * p.C,
                p.b3 + static_cast<size_t>(i) * p.C, p.scal + i * NSCAL) {}
  // one block's rows and scalars (K8: its projection block's)
  __device__ BlockEp(const float* a1, const float* b1, const float* a2,
                     const float* b2, const float* a3, const float* b3,
                     const float* scal) {
    float s[NSCAL];
#pragma unroll
    for (int k = 0; k < NSCAL; ++k) s[k] = __ldg(scal + k);
    e1 = requant(a1, b1, 0.f, s[0], s[1], s[2]);
    e2 = requant(a2, b2, 0.f, s[3], s[4], s[5]);
    e3 = requant(a3, b3, s[9], s[6], s[7], s[8]);
    zp = static_cast<int>(s[10]);
  }
  // an int8 requant (the residual and the output go through tensor maps)
  __device__ static Epilogue requant(const float* A, const float* B, float C,
                                     float lo, float hi, float shift) {
    Epilogue e = {};
    e.A = A;
    e.B = B;
    e.out_kind = OUT_I8;
    e.C = C;
    e.lo = lo;
    e.hi = hi;
    e.shift = shift;
    return e;
  }
};

// Phase B's A, B rows of block i into shared memory (K7: conv2's Cm and
// conv3's C channels; K9 the same padded with zeros to 64 and 128).
template <bool IVR>
__device__ void load_coef_b(Ctx& x, const BlockEp& be) {
  const Chain& p = x.p;
  const int n2 = IVR ? up(p.Cm, 64) : p.Cm, n3 = IVR ? up(p.C, 128) : p.C;
  float* s = reinterpret_cast<float*>(x.smem + x.L.coef_b);
  for (int k = x.tid; k < n2; k += NCONS) {
    s[k] = k < p.Cm ? be.e2.A[k] : 0.f;
    s[n2 + k] = k < p.Cm ? be.e2.B[k] : 0.f;
  }
  for (int k = x.tid; k < n3; k += NCONS) {
    s[2 * n2 + k] = k < p.C ? be.e3.A[k] : 0.f;
    s[2 * n2 + n3 + k] = k < p.C ? be.e3.B[k] : 0.f;
  }
}

// The maps of block i's input and output: the inputs alternate between the
// output and tmp so that the last block writes the output.  With K8's
// projection block first (proj), block 0 reads what it wrote, at
// out_of(p, -1).
__device__ __forceinline__ int in_of(const Chain& p, int i,
                                     bool proj = false) {
  return i == 0 && !proj ? 0 : ((p.nblk - i) & 1 ? 1 : 2);
}
__device__ __forceinline__ int out_of(const Chain& p, int i) {
  return (p.nblk - 1 - i) & 1 ? 1 : 2;
}

// IVR: K9 (w = 64, one tile a unit; NARROW: C-byte rows that are no TMA
// tensor, RawRows); else K7 with conv1's tile width and conv2's pass width
// W, TM tiles a unit of the fused phase B; PROJ: K8, K7's chain behind the
// projection block's three phases (an instantiation of its own, so that
// K7's and K9's hold no code of it).
template <bool IVR, int W, int TM, bool NARROW = false, bool PROJ = false>
__global__ void __launch_bounds__(NTHREADS, 1)
    chain_kernel(const __grid_constant__ Maps maps,
                 const __grid_constant__ Chain p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(IVR, p.mode == SPLIT, p.C, p.Cm, TM, p.stages, p.nres,
                 PROJ);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + MAX_ST;
  uint64_t* res_full = empty + MAX_ST;
  uint64_t* res_empty = res_full + MAX_RES;
  uint64_t* halo_full = res_empty + MAX_RES;
  uint64_t* halo_empty = halo_full + 1;
  const int tid = threadIdx.x;
  const bool split = p.mode == SPLIT;
  constexpr bool narrow = NARROW;
  // the residual ring: split mode's conv3 takes a 128-row tile (two slabs)
  // a slot; phase B tm slabs a slot
  Res rr;
  rr.n = split ? 1 : p.nres;
  rr.bytes = split ? 2 * SLAB : TM * SLAB;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS / 32);  // one arrival per consumer warp
    }
    for (int r = 0; r < rr.n; ++r) {
      mbar_init(&res_full[r], 1);
      mbar_init(&res_empty[r], split ? 2 : TM);  // one a storing thread
    }
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, NCONS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ctx x{maps, p, smem, L, res_full, res_empty, halo_full, halo_empty, tid,
        tid >> 7, tid & 127, tid & 31};
  PhaseProbe pr;
  CRing cring{full, empty, smem, p.stages};
  cring.pr = &pr;
  PRing pring{full, empty, smem, p.stages};
  Slot hb;      // the halo buffer's uses
  int oc = 0;   // the output slab of the next store
  Pre pre;      // the producer's stages issued before a barrier
  const int nph = split ? 3 : 2;
  // split mode's conv3 / project tile width (K9's C is at most 160)
  constexpr int N3T = IVR ? 64 : 128;
  const int tiles8 = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  if constexpr (PROJ) {
    // K8's projection block: P0 conv1 (K1's tile) onto workspace a, P1
    // conv2 (split mode's units; with two tiles a unit, a tile a
    // warpgroup) onto workspace b, P2 conv3 + downsample (the two-GEMM
    // tile) onto block 0's input
    const BlockEp pe(p.pa1, p.pb1, p.pa2, p.pb2, p.pa3, p.pb3, p.pscal);
    const int pout = in_of(p, 0, true);
    for (int ph = 0; ph < 3; ++ph) {
      const long long c0 = PHASE_CLOCK();
      if (tid < NCONS) {
        cring.sw = 20;  // the probe's slots of P0 and P2's k-loops
        cring.sm = 21;
        if (ph == 0) {
          gemm_consume<W, false>(x, cring, rr, p.M, p.Cm, p.Cp, pe.e1, M_A2);
        } else if (ph == 1) {
          load_coef_b<false>(x, pe);
          if constexpr (TM == 2)
            conv2_pairs_consume<W>(x, cring, hb, pe.e2, pe.zp);
          else
            conv2_units_consume<W>(x, cring, hb, oc, pe.e2, pe.zp);
        } else {
          // Ad, Bd of every column into coef_b (conv2's rows are done)
          float* s = reinterpret_cast<float*>(smem + L.coef_b);
          for (int k = tid; k < p.C; k += NCONS) {
            s[k] = __ldg(p.pad + k);
            s[p.C + k] = __ldg(p.pbd + k);
          }
          named_bar(1, NCONS);
          proj_consume(x, cring, pe.e3, M_XR + pout);
        }
      } else if (tid == NCONS) {
        if (ph == 0)
          gemm_produce<W, false>(x, pring, rr, pre, p.M, p.Cm, p.Cp, M_XP2,
                                 M_WP1, 0, 0);
        else if (ph == 1 && TM == 2)
          conv2_pairs_produce<W>(x, pring, hb, pre, M_WP2);
        else if (ph == 1)
          conv2_units_produce<W>(x, pring, hb, pre, 0, M_WP2);
        else
          proj_produce(x, pring, pre);
        // the next phase's first weight stages, before the barrier
        if (ph == 0 && TM == 2)
          conv2_prefetch<W, false>(x, pring, pre,
                                   (tiles8 + 1) / 2 * (p.Cm / W), 0,
                                   blockIdx.x % (p.Cm / W) * W, M_WP2);
        else if (ph == 0)
          conv2_prefetch<W, W == 64>(x, pring, pre, tiles8 * (p.Cm / W), 0,
                                     blockIdx.x % (p.Cm / W) * W, M_WP2);
        else if (ph == 1)
          gemm_prefetch<128>(pring, pre, &maps.m[M_WD], p.M, p.C, p.Cp, 0,
                             nullptr);
        else
          gemm_prefetch<W>(pring, pre, &maps.m[M_W1], p.M, p.Cm, p.C, 0,
                           nullptr);
      }
      pr.add(16 + ph, PHASE_CLOCK() - c0);
      // as the chain's barriers below: the phase's stores complete and
      // ordered before it, the producer's loads after it
      const long long c1 = PHASE_CLOCK();
      if (tid < NCONS && (tid & 127) == 0) fence_proxy_global();
      grid_barrier(p.bar);
      if (tid == NCONS) fence_proxy_global();
      pr.add(19, PHASE_CLOCK() - c1);
    }
  }
  for (int i = 0; i < p.nblk; ++i) {
    const BlockEp be(p, i);
    const int in = in_of(p, i, PROJ), out = out_of(p, i);
    for (int ph = 0; ph < nph; ++ph) {
      if (tid < NCONS) {
        cring.sw = ph == 1 ? 6 : 0;  // the probe's slots of the phase
        cring.sm = cring.sw + 1;
        if (ph == 0) {  // conv1 / expand onto workspace a / e
          gemm_consume<W, false>(x, cring, rr, p.M, p.Cm, p.C, be.e1, M_A2,
                                 narrow);
        } else if (ph == 2) {  // split conv3 / project + residual
          const long long c0 = PHASE_CLOCK();
          gemm_consume<N3T, true>(x, cring, rr, p.M, p.C, p.Cm, be.e3,
                                  M_XR + out);
          pr.add(13, PHASE_CLOCK() - c0);
        } else if constexpr (IVR) {
          load_coef_b<true>(x, be);
          if (!split)
            dwproj_consume<NARROW>(x, cring, rr, oc, be.e2, be.e3, be.zp, i,
                           M_X4 + out);
          else
            dw_units_consume(x, cring, oc, be.e2, be.zp, i);
        } else {
          load_coef_b<false>(x, be);
          if (!split)
            tail_consume<W, TM>(x, cring, rr, hb, oc, be.e2, be.e3, be.zp,
                                M_X4 + out);
          else
            conv2_units_consume<W>(x, cring, hb, oc, be.e2, be.zp);
        }
      } else if (tid == NCONS) {
        if (ph == 0) {
          const Narrow nw{p.act[in], p.w1, p.nblk * p.Cm};
          gemm_produce<W, false>(x, pring, rr, pre, p.M, p.Cm, p.C,
                                 M_X2 + in, M_W1, i * p.Cm, 0,
                                 narrow ? &nw : nullptr);
        } else if (ph == 2) {
          gemm_produce<N3T, true>(x, pring, rr, pre, p.M, p.C, p.Cm, M_B2,
                                  M_W3, i * p.C, M_XR + in);
        } else if constexpr (IVR) {
          if (!split)
            dwproj_produce<NARROW>(x, pring, rr, i, M_X4 + in);
          else
            dw_units_produce(x, pring);
        } else {
          if (!split)
            tail_produce<W, TM>(x, pring, rr, hb, pre, i, M_X4 + in);
          else
            conv2_units_produce<W>(x, pring, hb, pre, i);
        }
      }
      if (i + 1 < p.nblk || ph + 1 < nph) {
        // the producer first issues the next phase's weight stages (they
        // depend on no phase); every store of this phase is complete (its
        // storing thread waited for its bulk groups): order the stores
        // before the barrier, and the producer's loads of the next phase
        // after it
        const int ni = ph + 1 < nph ? i : i + 1, nph_ = (ph + 1) % nph;
        if (tid == NCONS) {
          const Narrow nw{p.act[in_of(p, ni, PROJ)], p.w1, p.nblk * p.Cm};
          if (nph_ == 0)
            gemm_prefetch<W>(pring, pre, &maps.m[M_W1], p.M, p.Cm, p.C,
                             ni * p.Cm, narrow ? &nw : nullptr);
          else if (nph_ == 2)
            gemm_prefetch<N3T>(pring, pre, &maps.m[M_W3], p.M, p.C, p.Cm,
                               ni * p.C, nullptr);
          else if constexpr (!IVR) {
            if (!split)
              conv2_prefetch<W, TM == 1 && W == 64>(
                  x, pring, pre, (tiles8 + TM - 1) / TM, ni * p.Cm, 0);
            else
              conv2_prefetch<W, W == 64>(x, pring, pre, tiles8 * (p.Cm / W),
                                         ni * p.Cm,
                                         blockIdx.x % (p.Cm / W) * W);
          }
        }
        const long long c0 = PHASE_CLOCK();
        if (tid < NCONS && (tid & 127) == 0) fence_proxy_global();
        grid_barrier(p.bar);
        if (tid == NCONS) fence_proxy_global();
        pr.add(9, PHASE_CLOCK() - c0);
      }
    }
  }
#ifdef QTPU_PHASE_PROBE
  if (tid == NCONS)
    qtpu_phase_probe[PROBE_SLOTS * blockIdx.x + PRODUCER_SLOT] = pring.waits;
#endif
  if (tid == 0) pr.store();
}

// ---- the host side ---------------------------------------------------------

// The tensors of a launch.
struct Tensors {
  const void *x, *w1, *w2, *w3;
  void *out, *tmp, *a, *b;  // tmp: null for one block; b: split mode's, K8's
  // K8: the projection block's input (M, Cp) and weights (x is then null)
  const void *xp = nullptr, *wp1 = nullptr, *wp2 = nullptr, *wp3 = nullptr,
             *wd = nullptr;
};

// A (n, h, row) byte tensor, boxes of (1, bh, bw) bytes, no swizzle.
inline bool rows3_map(CUtensorMap* m, const void* base, int n, int h,
                      int row, uint32_t bw, uint32_t bh) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row),
                                 static_cast<cuuint64_t>(h) * row};
  const cuuint32_t box[3] = {bw, bh, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_maps(Maps& mp, const Chain& p, const Tensors& t,
                        bool ivr) {
  using wg::byte_map;
  using wt::nhwc_map;
  const CUtensorMapSwizzle NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapSwizzle SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const void* act[3] = {t.x, t.tmp, t.out};
  bool ok = true;
  for (int k = 0; k < 3 && ok; ++k) {
    if (!act[k]) continue;
    if (p.C & 15) {  // K9's narrow rows: (b, y, x·C) 8 rows of 8·C bytes
      ok = rows3_map(&mp.m[M_X4 + k], act[k], p.Bn, p.H, p.W * p.C, 8 * p.C,
                     8);
      continue;
    }
    ok = byte_map(&mp.m[M_X2 + k], act[k], p.M, p.C, 64, 128, SW64) &&
         nhwc_map(&mp.m[M_X4 + k], act[k], p.Bn, p.H, p.W, p.C, 128, 8, 8,
                  SW128) &&
         byte_map(&mp.m[M_XR + k], act[k], p.M, p.C, ivr ? 64 : 128, 64,
                  ivr ? SW64 : SW128);
  }
  const int rows_w1 = p.nblk * p.Cm, rows_w3 = p.nblk * p.C;
  ok = ok &&
       byte_map(&mp.m[M_A2], t.a, p.M, p.Cm, p.w, 64, wg::swizzle_of(p.w)) &&
       nhwc_map(&mp.m[M_A4], t.a, p.Bn, p.H, p.W, p.Cm, ivr ? 64 : 16, 10, 10,
                NONE) &&
       ((p.C & 15) ||  // narrow rows: w1 by bulk copies
        byte_map(&mp.m[M_W1], t.w1, rows_w1, p.C, 64, p.w, SW64)) &&
       byte_map(&mp.m[M_W3], t.w3, rows_w3, p.Cm, 64,
                ivr && p.mode == SPLIT ? 64 : 128, SW64) &&
       (ivr || byte_map(&mp.m[M_W2], t.w2, rows_w1, 9 * p.Cm, 64, p.w, SW64));
  if (ok && (p.mode == SPLIT || t.xp))
    ok = byte_map(&mp.m[M_B2], t.b, p.M, p.Cm, 64, 128, SW64) &&
         nhwc_map(&mp.m[M_B4], t.b, p.Bn, p.H, p.W, p.Cm, p.w, 8, 8,
                  wg::swizzle_of(p.w));
  if (ok && t.xp)  // K8's projection block
    ok = byte_map(&mp.m[M_XP2], t.xp, p.M, p.Cp, 64, 128, SW64) &&
         byte_map(&mp.m[M_WP1], t.wp1, p.Cm, p.Cp, 64, p.w, SW64) &&
         byte_map(&mp.m[M_WP2], t.wp2, p.Cm, 9 * p.Cm, 64, p.w, SW64) &&
         byte_map(&mp.m[M_WP3], t.wp3, p.C, p.Cm, 64, 128, SW64) &&
         byte_map(&mp.m[M_WD], t.wd, p.C, p.Cp, 64, 128, SW64);
  return ok;
}

// One launch of a plan (ops/chain_plan.py): `smem` its bytes, checked
// against Layout; `grid` the blocks it asks for, capped at what the card
// holds at once with that much shared memory.
template <bool IVR, int W, int TM, bool NARROW = false, bool PROJ = false>
cudaError_t launch_kernel(const Maps& mp, const Chain& p, int smem,
                          int grid, cudaStream_t stream) {
  void (*kernel)(Maps, Chain) = chain_kernel<IVR, W, TM, NARROW, PROJ>;
  // the opt-in above 48 KB is an attribute of the current device: set it at
  // every launch (cheap next to a cooperative launch), so that any device
  // of a process takes the runner
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    NTHREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int fit = per_sm * wg::num_sms();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid < fit ? grid : fit);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mp, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool IVR>
cudaError_t launch_chain(const Chain& chain, const Tensors& t, int smem,
                         int grid, cudaStream_t stream) {
  Chain p = chain;
  p.act[0] = static_cast<const int8_t*>(t.x);
  p.act[1] = static_cast<const int8_t*>(t.tmp);
  p.act[2] = static_cast<const int8_t*>(t.out);
  p.w1 = static_cast<const int8_t*>(t.w1);
  // K9's narrow rows (RawRows): fused mode, C a multiple of 8 up to 32
  // (an 8 x 8 tile's row of 8·C bytes is one TMA box dimension, at most
  // 256), every run of rows a multiple of 16 bytes
  const bool narrow_ok = IVR && p.C % 8 == 0 && p.C <= 32 &&
                         (p.W * p.C) % 16 == 0 &&
                         (static_cast<long long>(p.M) * p.C) % 16 == 0 &&
                         p.mode == FUSED;
  if (p.nblk < 1 || p.stages < 4 || p.stages > MAX_ST || p.nres < 1 ||
      p.nres > MAX_RES || (p.w != 64 && p.w != 128) || p.Cm % 16 ||
      (p.C % 16 && !narrow_ok) || grid < 1 ||
      (p.mode != FUSED && p.mode != SPLIT) || (p.tm != 1 && p.tm != 2) ||
      (p.mode == SPLIT && (p.tm != 1 || p.nres != 2)) ||
      (IVR ? p.w != 64 || p.tm != 1 : p.Cm % p.w || p.C % 128))
    return cudaErrorInvalidValue;
  const Layout L(IVR, p.mode == SPLIT, p.C, p.Cm, p.tm, p.stages,
                 p.nres);
  if (L.total != smem || smem > wg::SMEM_BLOCK_MAX)
    return cudaErrorInvalidValue;
  Maps mp = {};
  if (!encode_maps(mp, p, t, IVR)) return cudaErrorInvalidValue;
  if constexpr (IVR) {
    return p.C & 15
               ? launch_kernel<true, 64, 1, true>(mp, p, smem, grid, stream)
               : launch_kernel<true, 64, 1>(mp, p, smem, grid, stream);
  } else {
    if (p.w == 64)
      return p.tm == 1
                 ? launch_kernel<false, 64, 1>(mp, p, smem, grid, stream)
                 : launch_kernel<false, 64, 2>(mp, p, smem, grid, stream);
    return p.tm == 1
               ? launch_kernel<false, 128, 1>(mp, p, smem, grid, stream)
               : launch_kernel<false, 128, 2>(mp, p, smem, grid, stream);
  }
}

}  // namespace wp
}  // namespace qtpu
