// The Hopper identity-bottleneck tail that K5 (qtail.cu) and K6 (qblock.cu)
// share, for sm_90a:
//   [K6: conv1 (1x1) -> requant ->] conv2 (3x3, stride 1, zero-point pads)
//   -> requant -> conv3 (1x1) + int8 residual -> relu -> requant
// on 8 x 8 output tiles.
//
// What held the older kernel (fused_tail.cuh) back, from its clock64 probe
// (qtpu_torch/ops/probe_tail.py): one block of four mma.sync warps per tile
// ran every one of conv2's and conv3's channel passes in sequence (layer4:
// 8 passes of K = 4,608 and 32 of K = 512), so a launch of a few tiles took
// one block's serial path; the weights came through a two-stage cp.async
// ring, and the epilogue stored and read one byte at a time.  Here a block
// is two consumer warpgroups (wgmma) and one producer warp (TMA), and:
//
// * conv2 runs wgmma straight from the halo: the halo lies in shared memory
//   as [16-channel chunk][halo pixel][16 bytes], which is wgmma's K-major
//   no-swizzle layout of 8-row x 16-byte core matrices with the 8 pixels of
//   an output row as the 8 rows of a core matrix.  Tap (kh, kw)'s A operand
//   is the same halo with the descriptor's start moved by (kh*10 + kw)*16
//   bytes; core matrices are one halo row (160 bytes) apart along M and one
//   chunk (CHP bytes) apart along K.  No im2col copy is made.  conv3 reads
//   `mid` ([chunk][64 rows][16 bytes]) the same way;
// * TMA moves the operands.  K5's halo is one 16-channel box (1, 10, 10, 16)
//   per chunk; TMA fills pixels outside the image with 0, so the consumers
//   write the zero point over them once the load has landed (edge tiles
//   only) and fence before the wgmmas.  K6 streams x's halo box (1, 10, 10,
//   64) with conv1's weight through the ring and computes conv1 over the
//   halo's 100 pixels as two 64-row wgmma blocks, writing conv2's zero
//   point, never a conv1 result, into the pixels outside the image.  The
//   weights stream through a ring of 4-8 stages with full / empty mbarriers,
//   the residual tiles come by TMA (the first ones before any weight), and
//   each output tile is written into a 128-byte swizzled shared tile that
//   one TMA store copies out (coalesced; TMA clips a ragged tile);
// * a block owns one tile or two (both then share every weight stage, which
//   halves the weight bytes read from L2 per pixel);
// * a thread block cluster of cs blocks splits the channels of the same
//   tiles: block `rank` computes conv1's and conv2's channels [rank Cmid/cs,
//   (rank+1) Cmid/cs) and conv3's [rank Cout/cs, ...), so a block's serial
//   path is 1/cs of the tile's.  conv2 and conv3 reduce over all of Cmid,
//   so each block copies its slices of the halo (K6) and of `mid` into the
//   others' shared memory with bulk copies through distributed shared
//   memory, completing on their mbarriers; K5's halo is loaded once and
//   multicast.  ops/qtail.py's tail_plan chooses cs and the tiles a block
//   per shape, from sweeps of ops/time_tail.py.
//
// Every epilogue step is K1's and K2's (ep_affine, the residual term, the
// requant; code_bits / residual_pair for conv3 as in wgmma_gemm.cuh's
// epilogue_slab), so the codes equal the unfused K1 -> K2 -> K1 sequence's
// bit for bit.  Cmid a multiple of 64, Cout of 128 and conv3's grid one
// code_bits takes (ops/qtail.py: tail_path); other calls take the older
// kernel.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "fused_tail.cuh"   // TailProbe, splat16
#include "wgmma_gemm.cuh"   // mbarriers, TMA, wgmma, desc_sw64, swz, byte_map

namespace qtpu {
namespace wt {

using wg::bulk_commit;
using wg::bulk_wait_all;
using wg::bulk_wait_read;
using wg::desc_sw64;
using wg::fence_async_smem;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::named_bar;
using wg::smem_u32;
using wg::swz;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_m64n128k32;
using wg::wgmma_m64n64k32;
using wg::wgmma_wait_1;
using wg::wgmma_wait_all;

constexpr int NCONS = 256;            // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;  // and one producer warp
constexpr int HPIX = 100;             // the 10 x 10 halo of an 8 x 8 tile
constexpr int CHP = 1664;             // a halo chunk: 104 x 16 B, 128-aligned
constexpr int MCHP = 1024;            // a mid chunk: 64 rows x 16 bytes
constexpr int STAGE_W = 8192;         // a weight stage: up to 128 rows x 64 B
constexpr int STAGE_X = 8192;         // K6's x stage: 128 halo rows x 64 B
constexpr int SLAB = 8192;            // a residual / output tile: 64 x 128 B
constexpr int MAX_ST = 8, MAX_RES = 4;
constexpr int BAR_BYTES = 256;  // 28 mbarriers

// Shared-memory offsets of a block (from a 1024-aligned base) that owns
// `tm` tiles; `total` is the dynamic shared memory it needs.  ops/qtail.py:
// wg_smem_bytes computes the same sum, and the host entry refuses a plan
// where they differ.  Per tile: a halo (`hb` bytes), a mid (`mb`), nres
// residual and nc output tiles; `coef` holds the block's folded A, B rows:
// conv2's S2 (and K6's conv1's S2) and conv3's S3 channels.
struct Layout {
  int stage, bofs, hb, mb, res, out, halo, mid, coef, bars, total;
  __host__ __device__ Layout(int cmid, int cout, int cs, int tm, bool block,
                             int stages, int nc, int nres)
      : stage(STAGE_W + (block ? tm * STAGE_X : 0)),
        bofs(block ? tm * STAGE_X : 0),
        hb(cmid / 16 * CHP),
        mb(64 * cmid),
        res(stages * stage),
        out(res + tm * nres * SLAB),
        halo(out + tm * nc * SLAB),
        mid(halo + tm * hb),
        coef(mid + tm * mb),
        bars(coef + 8 * (cmid / cs * (block ? 2 : 1) + cout / cs)),
        total(1024 + bars + BAR_BYTES) {}
};

struct TailWg {
  const float *A1, *B1, *A2, *B2;
  float lo1, hi1, shift1, lo2, hi2, shift2;
  Epilogue ep3;       // conv3: A, B, C, lo, hi, shift (res / out by TMA)
  int Bn, H, W;       // the output images
  int Hin, Win, pad;  // conv2's input (K6: H, W, 1)
  int Cin, Cmid, Cout, zp;
  int cs, tm, stages, nc, nres;
};

// Tile t of the output: image b (Bn, outside the images, for the odd tile
// of a block of two), origin (ty0, tx0), its halo's origin (hy0, hx0).
struct Tile {
  int b, ty0, tx0, hy0, hx0;
  __device__ __forceinline__ Tile(const TailWg& p, int t) {
    const int ntx = (p.W + 7) / 8, nty = (p.H + 7) / 8;
    b = t / (ntx * nty);
    ty0 = (t / ntx) % nty * 8;
    tx0 = t % ntx * 8;
    hy0 = ty0 - p.pad;
    hx0 = tx0 - p.pad;
  }
};

// ---- PTX: 4D TMA, multicast, clusters --------------------------------------

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* m,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same box into every block of `mask` (same offset, each block's own
// mbarrier at `bar`'s offset).
__device__ __forceinline__ void tma_load4_mc(void* dst, const CUtensorMap* m,
                                             uint64_t* bar, int c0, int c1,
                                             int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_store4(const CUtensorMap* m,
                                           const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of `addr` (this block's) in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: 8-row
// x 16-byte core matrices, `lbo` bytes apart along K, `sbo` along M / N.
__device__ __forceinline__ uint64_t desc_ns(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_n(int (&d)[N / 2], uint64_t a,
                                        uint64_t b) {
  if constexpr (N == 64) {
    wgmma_m64n64k32(d, a, b, 1);
  } else {
    wgmma_m64n128k32(d, a, b, 1);
  }
}

// `bytes` of this block's shared memory at `src` into block `rank`'s at the
// same offset, completing on that block's mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_to_cluster(uint32_t src, int bytes,
                                                uint64_t* bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(mapa(src, rank)),
      "r"(src), "r"(bytes), "r"(mapa(smem_u32(bar), rank))
      : "memory");
}

// ---- the block's pieces ----------------------------------------------------

// Zero point over the halo pixels outside conv2's input, chunks [c0, c0 +
// nch); nothing on a tile whose halo lies inside.
__device__ __forceinline__ void zp_fill(uint8_t* halo, int c0, int nch,
                                        int hy0, int hx0, int Hin, int Win,
                                        int zp, int tid) {
  if (hy0 >= 0 && hx0 >= 0 && hy0 + 10 <= Hin && hx0 + 10 <= Win) return;
  const int4 z = splat16(zp);
  for (int i = tid; i < nch * HPIX; i += NCONS) {
    const int c = c0 + i / HPIX, px = i % HPIX;
    const int y = hy0 + px / 10, x = hx0 + px % 10;
    if (y < 0 || y >= Hin || x < 0 || x >= Win)
      *reinterpret_cast<int4*>(halo + c * CHP + px * 16) = z;
  }
}

// Requant a 64 x N accumulator tile (wgmma's fragment: acc[4j + 2h + e] is
// row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e) into int8
// codes at dst + (n / 16) * pitch + row * 16 + n % 16, n = n0 + column,
// with the A, B rows sA, sB (shared, indexed by column); rows `row0` + r,
// only those `keep` accepts.  tw: the thread's index in its warpgroup.
template <int N, class Keep>
__device__ __forceinline__ void requant_rows(const int (&acc)[N / 2],
                                             const float* sA, const float* sB,
                                             float lo, float hi, float shift,
                                             int n0, uint8_t* dst, int pitch,
                                             int row0, Keep keep, int tw) {
  const int lane = tw & 31;
  const int r0 = row0 + (tw >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (!keep(row)) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 a = *reinterpret_cast<const float2*>(sA + c);
      const float2 b = *reinterpret_cast<const float2*>(sB + c);
      const int8_t q0 = ep_code(ep_affine(acc[4 * j + 2 * h], a.x, b.x), lo,
                                hi, shift);
      const int8_t q1 = ep_code(ep_affine(acc[4 * j + 2 * h + 1], a.y, b.y),
                                lo, hi, shift);
      const int n = n0 + c;
      *reinterpret_cast<uint16_t*>(dst + (n >> 4) * pitch + row * 16 +
                                   (n & 15)) =
          static_cast<uint16_t>(static_cast<uint8_t>(q0) |
                                (static_cast<uint8_t>(q1) << 8));
    }
  }
}

// Requant a warpgroup's 64 x N accumulator (wgmma's fragment: acc[4j + 2h +
// e] is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e) into
// int8 codes in `cs`, 64 rows of SPAN bytes under TMA's SPAN-byte swizzle,
// at columns col0 + c; with RES + the int8 residual from `rs` (the same
// layout) weighted by ep.C.  sA, sB are indexed by c.  Each step is
// epilogue.cuh's ep_pair and code_pair, as wgmma_gemm.cuh's epilogue_slab.
// K5's conv3 (SPAN 128, RES) and the chained runner (wgmma_phase.cuh).
template <int N, int SPAN, bool RES>
__device__ __forceinline__ void fill_slab(const int (&acc)[N / 2],
                                          const Epilogue& ep, const float* sA,
                                          const float* sB, const uint8_t* rs,
                                          uint8_t* cs, int col0, int tw) {
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
  const unsigned flip = ep.shift != 0.f ? 0x8080u : 0u;  // - shift, mod 256
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 a = *reinterpret_cast<const float2*>(sA + c);
    const float2 b = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = swz<SPAN>((r0 + 8 * h) * SPAN + col0 + c);
      const float2 q = RES ? residual_pair(*reinterpret_cast<
                                 const unsigned short*>(rs + off))
                           : make_float2(0.f, 0.f);
      *reinterpret_cast<unsigned short*>(cs + off) = code_pair(
          ep,
          ep_pair<RES>(ep, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], a, b,
                       q),
          flip);
    }
  }
}

// Chunks [c0, c0 + nch) of each of the block's `tm` buffers (`stride`
// bytes apart from `buf`; chunks `pitch` bytes apart, so one contiguous
// range each) are this block's slices.  Once every consumer has written its
// part (fenced into the async proxy), thread 0 copies the slices into the
// same offsets of the cluster's other blocks, one bulk copy each,
// completing on their barrier `bar`; then each block waits on its own `bar`
// (armed at the start for the other blocks' bytes) and the buffers are
// whole for the wgmmas.
__device__ __forceinline__ void exchange(uint8_t* buf, int stride, int tm,
                                         int c0, int nch, int pitch,
                                         uint64_t* bar, int cs, int rank,
                                         int tid) {
  fence_async_smem();
  named_bar(1, NCONS);
  if (cs == 1) return;
  if (tid == 0)
    for (int r = 0; r < cs; ++r)
      for (int t = 0; t < tm && r != rank; ++t)
        bulk_to_cluster(smem_u32(buf + t * stride + c0 * pitch), nch * pitch,
                        bar, r);
  wait_cluster(bar, 0);
}

// The ring as its consumers walk it: wait until a stage is full; after its
// wgmmas are issued as a group, wait for the group before and free that
// one's stages (each warp counts once on each).  Slots and parities are
// counted on, never divided out of a running index (a division by the
// runtime stage count would cost tens of instructions a stage).
struct Ring {
  uint64_t *full, *empty;
  uint8_t* base;
  int stages, stage;
  int s, ph;          // the next stage's slot and parity
  int p0, p1, nprev;  // the slots of the last group's stages
  TailProbe* pr;
  __device__ __forceinline__ void step(int& t, int& q) const {
    if (++t == stages) {
      t = 0;
      q ^= 1;
    }
  }
  // the next stage (j = 0) or the one after it (j = 1), once full
  __device__ __forceinline__ uint8_t* wait(int j = 0) {
    int t = s, q = ph;
    if (j) step(t, q);
    const long long c = TAIL_CLOCK();
    mbar_wait(&full[t], q);
    pr->add(7, TAIL_CLOCK() - c);
    return base + t * stage;
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
    const long long c = TAIL_CLOCK();
    wgmma_wait_1();
    pr->add(8, TAIL_CLOCK() - c);
    release(lane);
    p0 = s;
    step(s, ph);
    if (n == 2) {
      p1 = s;
      step(s, ph);
    }
    nprev = n;
  }
  __device__ __forceinline__ void drain(int lane) {
    const long long c = TAIL_CLOCK();
    wgmma_wait_all();
    pr->add(8, TAIL_CLOCK() - c);
    release(lane);
    nprev = 0;
  }
};

// conv2's A operand, walked stage by stage: stage kt is 64 channels (chunk
// cc of cpt = Cmid / 64) of tap (kh, kw); its descriptor starts at chunk
// 4 cc, (kh * 10 + kw) * 16 bytes into it.  Stages past the ninth tap (the
// zero stage) read tap 0.
struct HaloWalk {
  uint32_t halo;
  int cpt, cc, kh, kw;
  __device__ __forceinline__ uint64_t desc() const {
    const int off = kh < 3 ? (kh * 10 + kw) * 16 : 0;
    return desc_ns(halo + 4 * cc * CHP + off, CHP, 160);
  }
  __device__ __forceinline__ void advance(int n) {
    for (cc += n; cc >= cpt; cc -= cpt)
      if (++kw == 3) {
        kw = 0;
        ++kh;
      }
  }
};

// The two warpgroups' 64 x 64 partial sums of conv2 (fragment layout, the
// same in both) added up through 8 KB of shared memory `scr`, in two rounds:
// warpgroup 0 ends with the sum's columns 0-31 in acc[0..15], warpgroup 1
// with columns 32-63 in acc[16..31].
__device__ __forceinline__ void reduce_halves(int (&acc)[32], int wg, int tw,
                                              uint8_t* scr) {
  int4* q = reinterpret_cast<int4*>(scr);
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const int give = round == 0 ? 1 : 0;  // the warpgroup that hands over
    const int half = round == 0 ? 0 : 16;  // the columns it hands over
    if (wg == give)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i * 128 + tw] = make_int4(acc[half + 4 * i], acc[half + 4 * i + 1],
                                    acc[half + 4 * i + 2],
                                    acc[half + 4 * i + 3]);
    named_bar(1, NCONS);
    if (wg != give)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 v = q[i * 128 + tw];
        acc[half + 4 * i] += v.x;
        acc[half + 4 * i + 1] += v.y;
        acc[half + 4 * i + 2] += v.z;
        acc[half + 4 * i + 3] += v.w;
      }
    named_bar(1, NCONS);
  }
}

// ---- the kernel ------------------------------------------------------------

// A block owns TM tiles (TM = 2 where the grid has tiles to spare: both
// share every weight stage, so each weight byte feeds twice the pixels).
// Its two consumer warpgroups share every stage:
// * TM = 1: conv1 (K6) — warpgroup w takes the halo's rows 64w .. 64w + 63
//   of W2-wide passes; conv2 — each takes 64 of a 128-wide pass's columns,
//   or, for 64-wide passes, every other stage of all 64 (the two partial
//   sums then added through shared memory: reduce_halves); conv3 — each
//   takes 64 of a 128-wide pass's columns;
// * TM = 2: warpgroup w takes tile w whole: conv1 over its halo's two
//   64-row blocks (two chains), conv2's W2 and conv3's 128 columns.
// W2 = 128 where the block's conv2 channels S2 allow, else 64.  A cluster of
// cs blocks works on the same tiles, each on its slice of the channels.
template <bool BLOCK, int W2, int TM>
__global__ void __launch_bounds__(NTHREADS, 2)
    tail_wg_kernel(const __grid_constant__ CUtensorMap tm_in,
                   const __grid_constant__ CUtensorMap tm_w1,
                   const __grid_constant__ CUtensorMap tm_w2,
                   const __grid_constant__ CUtensorMap tm_w3,
                   const __grid_constant__ CUtensorMap tm_res,
                   const __grid_constant__ CUtensorMap tm_out,
                   const __grid_constant__ TailWg p) {
  constexpr int W1 = TM == 1 ? W2 : 64;      // conv1's pass width
  constexpr int N2 = TM == 1 ? 64 : W2;      // a warpgroup's conv2 columns
  constexpr int N3 = TM == 1 ? 64 : 128;     // and conv3's
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(p.Cmid, p.Cout, p.cs, TM, BLOCK, p.stages, p.nc, p.nres);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + MAX_ST;
  uint64_t* res_full = empty + MAX_ST;
  uint64_t* res_empty = res_full + MAX_RES;
  uint64_t* halo_full = res_empty + MAX_RES;
  uint64_t* xchg = halo_full + 1;  // [0] the halo (K6), [1] mid
  uint64_t* done = xchg + 2;       // every block has its slices
  uint8_t* halo = smem + L.halo;
  uint8_t* mid = smem + L.mid;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int t0 = blockIdx.x / p.cs * TM;  // the block's first tile
  const int S2 = p.Cmid / p.cs, S3 = p.Cout / p.cs;
  const int n2 = rank * S2, n3 = rank * S3;
  const int k2t = 9 * p.Cmid / 64, k3t = p.Cmid / 64;
  // one tile and 64-wide conv2 passes: the warpgroups split the stages
  // (pairs, the last one padded with a zero stage) rather than 32 columns
  constexpr bool KSPLIT = TM == 1 && W2 == 64;
  const int k2p = KSPLIT ? (k2t + 1) & ~1 : k2t;
  const int np3 = S3 / 128;  // conv3 passes
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS / 32);
    }
    for (int i = 0; i < p.nres; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], TM);
    }
    mbar_init(halo_full, 1);
    mbar_init(&xchg[0], 1);
    mbar_init(&xchg[1], 1);
    mbar_init(done, p.cs);
    // the other blocks' slices arrive as bytes on xchg
    if (p.cs > 1) {
      if (BLOCK) mbar_expect_tx(&xchg[0], (p.cs - 1) * TM * (S2 / 16) * CHP);
      mbar_expect_tx(&xchg[1], (p.cs - 1) * TM * (S2 / 16) * MCHP);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers are set before a multicast or a copy reaches them
  cluster_sync();

  if (tid >= NCONS) {  // the producer warp: one thread issues every copy
    if (tid != NCONS) return;
    int slot_s = 0, slot_ph = 0;
    auto slot = [&](int bytes) {
      const int s = slot_s;
      mbar_wait(&empty[s], slot_ph ^ 1);
      mbar_expect_tx(&full[s], bytes);
      if (++slot_s == p.stages) {
        slot_s = 0;
        slot_ph ^= 1;
      }
      return s;
    };
    auto weights = [&](const CUtensorMap* m, int s, int k, int n) {
      tma_load(smem + s * L.stage + L.bofs, m, &full[s], k, n);
    };
    auto residual = [&](int q) {
      const int rb = q % p.nres;
      mbar_wait(&res_empty[rb], ((q / p.nres) & 1) ^ 1);
      mbar_expect_tx(&res_full[rb], TM * SLAB);
      for (int w = 0; w < TM; ++w) {
        const Tile t(p, t0 + w);
        tma_load4(smem + L.res + (rb * TM + w) * SLAB, &tm_res, &res_full[rb],
                  n3 + 128 * q, t.tx0, t.ty0, t.b);
      }
    };
    if (!BLOCK) {
      const int nch = p.Cmid / 16;
      mbar_expect_tx(halo_full, TM * nch * HPIX * 16);
      if (rank == 0)  // one halo for the cluster: block 0 multicasts it
        for (int w = 0; w < TM; ++w) {
          const Tile t(p, t0 + w);
          for (int c = 0; c < nch; ++c) {
            uint8_t* dst = halo + w * L.hb + c * CHP;
            if (p.cs == 1)
              tma_load4(dst, &tm_in, halo_full, 16 * c, t.hx0, t.hy0, t.b);
            else
              tma_load4_mc(dst, &tm_in, halo_full, 16 * c, t.hx0, t.hy0, t.b,
                           static_cast<uint16_t>((1u << p.cs) - 1));
          }
        }
    }
    // the first residual tiles now: their buffers are free
    for (int q = 0; q < p.nres && q < np3; ++q) residual(q);
    if (BLOCK) {
      for (int np = 0; np < S2; np += W1)
        for (int kc = 0; kc < p.Cin / 64; ++kc) {
          const int s = slot(TM * HPIX * 64 + W1 * 64);
          uint8_t* st = smem + s * L.stage;
          for (int w = 0; w < TM; ++w) {
            const Tile t(p, t0 + w);
            tma_load4(st + w * STAGE_X, &tm_in, &full[s], 64 * kc, t.hx0,
                      t.hy0, t.b);
          }
          weights(&tm_w1, s, 64 * kc, n2 + np);
        }
    }
    for (int np = 0; np < S2; np += W2)
      for (int kt = 0; kt < k2p; ++kt) {  // kt = k2t: past w2's rows, zeros
        const int s = slot(W2 * 64);
        weights(&tm_w2, s, 64 * kt, n2 + np);
      }
    for (int q = 0; q < np3; ++q) {
      for (int kt = 0; kt < k3t; ++kt) {
        const int s = slot(128 * 64);
        weights(&tm_w3, s, 64 * kt, n3 + 128 * q);
      }
      if (q >= p.nres) residual(q);
    }
    return;
  }

  // the consumer warpgroups: wg, tw the thread's index in it; tb the tile
  // (buffer) the warpgroup works on, c2 / c3 its first column of a pass
  TailProbe pr;
  const int lane = tid & 31, wg = tid >> 7, tw = tid & 127;
  const int tb = TM == 1 ? 0 : wg;
  const int c2 = TM == 1 ? wg * N2 : 0, c3 = TM == 1 ? wg * N3 : 0;
  const Tile my(p, t0 + tb);
  Ring ring{full, empty, smem, p.stages, L.stage, 0, 0, 0, 0, 0, &pr};
  uint8_t* my_halo = halo + tb * L.hb;
  uint8_t* my_mid = mid + tb * L.mb;
  // the block's A, B rows into shared memory
  float* sA2 = reinterpret_cast<float*>(smem + L.coef);
  float* sB2 = sA2 + S2;
  float* sA3 = sB2 + S2;
  float* sB3 = sA3 + S3;
  float* sA1 = sB3 + S3;  // K6
  float* sB1 = sA1 + S2;
  for (int i = tid; i < S2; i += NCONS) {
    sA2[i] = p.A2[n2 + i];
    sB2[i] = p.B2[n2 + i];
    if (BLOCK) {
      sA1[i] = p.A1[n2 + i];
      sB1[i] = p.B1[n2 + i];
    }
  }
  for (int i = tid; i < S3; i += NCONS) {
    sA3[i] = p.ep3.A[n3 + i];
    sB3[i] = p.ep3.B[n3 + i];
  }

  if (!BLOCK) {
    mbar_wait(halo_full, 0);
    for (int w = 0; w < TM; ++w) {
      const Tile t(p, t0 + w);
      zp_fill(halo + w * L.hb, 0, p.Cmid / 16, t.hy0, t.hx0, p.Hin, p.Win,
              p.zp, tid);
    }
    fence_async_smem();
    named_bar(1, NCONS);
    pr.lap(0);
  } else {
    for (int w = 0; w < TM; ++w) {
      const Tile t(p, t0 + w);
      zp_fill(halo + w * L.hb, n2 / 16, S2 / 16, t.hy0, t.hx0, p.H, p.W,
              p.zp, tid);
    }
    named_bar(1, NCONS);
    pr.lap(0);
    // conv1 on the halo rows (pixels 100-127 and those outside the image
    // are computed and dropped)
    auto inside = [&](int px) {
      const int y = my.hy0 + px / 10, x = my.hx0 + px % 10;
      return px < HPIX && y >= 0 && y < p.H && x >= 0 && x < p.W;
    };
    for (int np = 0; np < S2; np += W1) {
      int acc[W1 / 2], acc1[32];
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) acc[i] = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[i] = 0;
      for (int kc = 0; kc < p.Cin / 64; ++kc) {
        uint8_t* st = ring.wait();
        const uint64_t db = desc_sw64(st + L.bofs);
        wgmma_fence();
        if constexpr (TM == 1) {  // rows 64 wg .. 64 wg + 63
          const uint64_t da = desc_sw64(st + wg * 64 * 64);
          wgmma_n<W1>(acc, da, db);
          wgmma_n<W1>(acc, da + 2, db + 2);
        } else {  // tile wg's rows 0-63 and 64-127
          const uint64_t da = desc_sw64(st + wg * STAGE_X);
          const uint64_t da1 = desc_sw64(st + wg * STAGE_X + 64 * 64);
          wgmma_m64n64k32(acc, da, db, 1);
          wgmma_m64n64k32(acc, da + 2, db + 2, 1);
          wgmma_m64n64k32(acc1, da1, db, 1);
          wgmma_m64n64k32(acc1, da1 + 2, db + 2, 1);
        }
        ring.done(lane);
      }
      ring.drain(lane);
      requant_rows<W1>(acc, sA1 + np, sB1 + np, p.lo1, p.hi1, p.shift1,
                       n2 + np, my_halo, CHP, TM == 1 ? 64 * wg : 0, inside,
                       tw);
      if constexpr (TM == 2)
        requant_rows<64>(acc1, sA1 + np, sB1 + np, p.lo1, p.hi1, p.shift1,
                         n2 + np, my_halo, CHP, 64, inside, tw);
    }
    pr.lap(1);
    exchange(halo, L.hb, TM, n2 / 16, S2 / 16, CHP, &xchg[0], p.cs, rank,
             tid);
    pr.lap(6);
  }

  // conv2: this block's S2 channels, A straight from the halo; tap (kh, kw)
  // of stage kt at (kh * 10 + kw) * 16 bytes into its 16-channel chunk
  auto all_rows = [](int) { return true; };
  const uint32_t halo_a = smem_u32(my_halo), mid_a = smem_u32(my_mid);
  constexpr uint32_t K32_HALO = 2 * CHP >> 4;  // the next 32 channels
  for (int np = 0; np < S2; np += W2) {
    HaloWalk hw{halo_a, p.Cmid / 64, 0, 0, 0};
    if constexpr (KSPLIT) {  // warpgroup wg: stage kt + wg of each pair
      int acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
      hw.advance(wg);  // warpgroup wg takes stages wg, wg + 2, ...
      for (int kt = 0; kt < k2p; kt += 2) {
        uint8_t* st0 = ring.wait(0);
        uint8_t* st1 = ring.wait(1);
        const uint64_t da = hw.desc();
        hw.advance(2);
        const uint64_t db = desc_sw64((wg ? st1 : st0) + L.bofs);
        wgmma_fence();
        wgmma_m64n64k32(acc, da, db, 1);
        wgmma_m64n64k32(acc, da + K32_HALO, db + 2, 1);
        ring.done(lane, 2);
      }
      ring.drain(lane);
      pr.lap(2);
      reduce_halves(acc, wg, tw, smem + L.out);
      int half[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) half[i] = wg ? acc[16 + i] : acc[i];
      requant_rows<32>(half, sA2 + np + 32 * wg, sB2 + np + 32 * wg, p.lo2,
                       p.hi2, p.shift2, n2 + np + 32 * wg, my_mid, MCHP, 0,
                       all_rows, tw);
    } else {
      int acc[N2 / 2];
#pragma unroll
      for (int i = 0; i < N2 / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < k2t; ++kt) {
        uint8_t* st = ring.wait();
        const uint64_t da = hw.desc();
        hw.advance(1);
        const uint64_t db = desc_sw64(st + L.bofs + c2 * 64);
        wgmma_fence();
        wgmma_n<N2>(acc, da, db);
        wgmma_n<N2>(acc, da + K32_HALO, db + 2);
        ring.done(lane);
      }
      ring.drain(lane);
      pr.lap(2);
      requant_rows<N2>(acc, sA2 + np + c2, sB2 + np + c2, p.lo2, p.hi2,
                       p.shift2, n2 + np + c2, my_mid, MCHP, 0, all_rows, tw);
    }
    pr.lap(3);
  }
  exchange(mid, L.mb, TM, n2 / 16, S2 / 16, MCHP, &xchg[1], p.cs, rank,
           tid);
  pr.lap(6);

  // conv3 + residual: this block's S3 channels in 128-wide passes, A from
  // mid.  TM = 1: the two warpgroups fill one output tile and thread 0
  // stores it; TM = 2: each fills and stores its own tile's.
  const bool storer = TM == 1 ? tid == 0 : tw == 0;
  const int bar_id = TM == 1 ? 1 : 2 + wg, bar_n = TM == 1 ? NCONS : 128;
  constexpr uint32_t K32_MID = 2 * MCHP >> 4;
  for (int q = 0; q < np3; ++q) {
    int acc[N3 / 2];
#pragma unroll
    for (int i = 0; i < N3 / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < k3t; ++kt) {
      uint8_t* st = ring.wait();
      const uint64_t da = desc_ns(mid_a + 4 * kt * MCHP, MCHP, 128);
      const uint64_t db = desc_sw64(st + L.bofs + c3 * 64);
      wgmma_fence();
      wgmma_n<N3>(acc, da, db);
      wgmma_n<N3>(acc, da + K32_MID, db + 2);
      ring.done(lane);
    }
    ring.drain(lane);
    pr.lap(4);
    // the output tile's last store has read it
    if (storer) {
      if (p.nc == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    named_bar(bar_id, bar_n);
    const int rb = q % p.nres;
    mbar_wait(&res_full[rb], (q / p.nres) & 1);
    uint8_t* cs = smem + L.out + ((q % p.nc) * TM + tb) * SLAB;
    fill_slab<N3, 128, true>(acc, p.ep3, sA3 + 128 * q + c3,
                             sB3 + 128 * q + c3,
                             smem + L.res + (rb * TM + tb) * SLAB, cs, c3,
                             tw);
    fence_async_smem();
    named_bar(bar_id, bar_n);
    if (storer) {
      tma_store4(&tm_out, cs, n3 + 128 * q, my.tx0, my.ty0, my.b);
      bulk_commit();
      mbar_arrive(&res_empty[rb]);
    }
    pr.lap(5);
  }
  if (storer) bulk_wait_all();
  // no block exits while another may still copy out of it: each counts
  // itself on every block's `done` once it has received all its slices
  if (p.cs > 1) {
    named_bar(1, NCONS);
    if (tid == 0)
      for (int r = 0; r < p.cs; ++r) arrive_cluster(mapa(smem_u32(done), r));
    wait_cluster(done, 0);
  }
  pr.store();
}

// ---- the host side ---------------------------------------------------------

// An NHWC int8 tensor (n, h, w, c), boxes of (1, bh, bw, bc).
inline bool nhwc_map(CUtensorMap* m, const void* base, int n, int h, int w,
                     int c, uint32_t bc, uint32_t bw, uint32_t bh,
                     CUtensorMapSwizzle sw) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c),
                                 static_cast<cuuint64_t>(w) * c,
                                 static_cast<cuuint64_t>(h) * w * c};
  const cuuint32_t box[4] = {bc, bw, bh, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool BLOCK, int W2, int TM>
cudaError_t launch_kernel(const TailWg& p, int grid, int smem,
                          const CUtensorMap* maps, cudaStream_t stream) {
  static bool attr = false;  // once per instantiation, before its first launch
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_wg_kernel<BLOCK, W2, TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, tail_wg_kernel<BLOCK, W2, TM>, maps[0],
                         maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One launch: `in` is K5's a (Bn, Hin, Win, Cmid) or K6's x (Bn, H, W, Cin),
// `res` the residual (K6: x), `smem` the plan's bytes (checked against
// Layout).
template <bool BLOCK>
cudaError_t launch_tail(const void* in, const void* w1, const void* w2,
                        const void* w3, const void* res, void* out,
                        const TailWg& p, int smem, cudaStream_t stream) {
  if (p.cs < 1 || p.cs > 8 || (p.cs & (p.cs - 1)) || p.Cmid % (64 * p.cs) ||
      p.Cout % (128 * p.cs) || (BLOCK && p.Cin % 64) || p.tm < 1 ||
      p.tm > 2 || p.stages < 4 || p.stages > MAX_ST || p.nc < 1 ||
      p.nc > 2 || p.nres < 1 || p.nres > MAX_RES || !int_grid(p.ep3))
    return cudaErrorInvalidValue;
  const Layout L(p.Cmid, p.Cout, p.cs, p.tm, BLOCK, p.stages, p.nc, p.nres);
  if (L.total != smem || smem > wg::SMEM_BLOCK_MAX)
    return cudaErrorInvalidValue;
  const bool w128 = (p.Cmid / p.cs) % 128 == 0;
  const CUtensorMapSwizzle SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap maps[6] = {};  // in, w1, w2, w3, res, out
  const bool ok =
      (BLOCK ? nhwc_map(&maps[0], in, p.Bn, p.Hin, p.Win, p.Cin, 64, 10, 10,
                        SW64) &&
                   wg::byte_map(&maps[1], w1, p.Cmid, p.Cin, 64,
                                p.tm == 1 && w128 ? 128 : 64, SW64)
             : nhwc_map(&maps[0], in, p.Bn, p.Hin, p.Win, p.Cmid, 16, 10, 10,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) &&
      wg::byte_map(&maps[2], w2, p.Cmid, 9 * p.Cmid, 64, w128 ? 128 : 64,
                   SW64) &&
      wg::byte_map(&maps[3], w3, p.Cout, p.Cmid, 64, 128, SW64) &&
      nhwc_map(&maps[4], res, p.Bn, p.H, p.W, p.Cout, 128, 8, 8, SW128) &&
      nhwc_map(&maps[5], out, p.Bn, p.H, p.W, p.Cout, 128, 8, 8, SW128);
  if (!ok) return cudaErrorInvalidValue;
  const int tiles = p.Bn * ((p.H + 7) / 8) * ((p.W + 7) / 8);
  const int grid = (tiles + p.tm - 1) / p.tm * p.cs;
  if (p.tm == 1)
    return w128 ? launch_kernel<BLOCK, 128, 1>(p, grid, smem, maps, stream)
                : launch_kernel<BLOCK, 64, 1>(p, grid, smem, maps, stream);
  return w128 ? launch_kernel<BLOCK, 128, 2>(p, grid, smem, maps, stream)
              : launch_kernel<BLOCK, 64, 2>(p, grid, smem, maps, stream);
}

}  // namespace wt
}  // namespace qtpu
