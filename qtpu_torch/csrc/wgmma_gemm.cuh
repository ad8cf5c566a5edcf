// K1's Hopper GEMM: TMA operand loads into a ring of swizzled shared-memory
// stages, wgmma s8 consumers, a persistent grid and a coalesced epilogue.
//
// C[m, n] = epilogue(sum_k x[m, k] * w[n, k]), x int8 (M, K) and w int8
// (N, K), both K-contiguous — the K-major layout wgmma takes for .s8 — or w
// int4 nibble-packed along K ((N, K/2) bytes, pack_int4_nk).  The epilogue
// is igemm.cuh's store_one step for step (ep_affine, the residual term,
// ep_f32, each operation rounded on its own); the int8 code and the int8
// residual's float come from adds on float bits instead of conversion
// instructions (code_bits, residual_pair: epilogue.cuh), the same values.  So
// every output is the igemm path's bit for bit.
//
// What bounds K1 on the H100 is bytes: every ResNet-50 1x1 GEMM moves more
// bytes than its operations can hide at 1,979 TOP/s (K = 64: 2 operations
// per byte of x).  The clock64 probe of the mma.sync loop
// (qtpu_torch/ops/probe_k1.py) found its epilogue taking 90% of a block's
// cycles at K = 64 — one store and one residual load per element, the loads
// serialised behind the stores — and nothing in flight while it ran.  So:
//
// * a block is one or two consumer warpgroups (64 rows each) and one
//   producer warp.  The producer issues cp.async.bulk.tensor loads (TMA) of
//   the x tile (64 or 128 rows x 64) and the w tile (BN x 64, or BN x 32
//   packed bytes) into a ring of at least four stages with full / empty
//   mbarriers, and each tile's residual into one of two buffers;
// * the consumers run wgmma.m64nBNk32 from shared-memory descriptors
//   (64-byte swizzle: BK = 64 is one swizzle row, so K = 64 loads no zero
//   half), keep one group in flight and free each stage when its wgmmas are
//   done;
// * the epilogue keeps A[n], B[n] in shared memory while the tile column
//   stays, reads the residual from its shared tile, requantises in
//   registers and writes the tile into a swizzled shared tile (two, used in
//   turn) that one TMA store per 128-byte column band copies out
//   (coalesced; TMA clips the ragged edges);
// * the grid is persistent: up to six blocks per SM (as many as the tiles
//   fill and shared memory and registers allow), tiles in a static order
//   (tile += gridDim.x), so one block's epilogue runs beside the others'
//   loads and main loops, and each producer loads its next tiles during its
//   own epilogue.  No global counter: CUDA graphs replay it.
// For int4 weights the consumers unpack each packed stage into an int8
// swizzled B stage (unpack_s4x4, igemm.cuh), fence it into the async proxy
// and then run the same wgmmas.
//
// TMA needs 16-byte aligned bases and rows that are multiples of 16 bytes
// (x, w, the output, the residual); ops/qmatmul.py sends other calls to
// igemm.cuh's loop and counts them apart.  Ragged M, N and K are TMA's
// zero fill on load and clipping on store.
//
// Where x's stages come from is a policy of the kernel (its class X): GemmX
// below loads K1's 2D (M, K) tiles; K2 (qconv.cu) loads, for k-stage (tap,
// channel chunk), that tap's 64 channels for the tile's BM consecutive
// output pixels through TMA's im2col mode, and corrects the accumulators of
// the pixels whose window leaves the image (X::fix) before the epilogue.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "igemm.cuh"  // unpack_s4x4

namespace qtpu {
namespace wg {

constexpr int BK = 64;          // k values per stage (one 64-byte row)
constexpr int MIN_STAGES = 4;   // stages of a block's ring
constexpr int MAX_STAGES = 8;
constexpr int SMEM_BLOCK_MAX = 232448;  // dynamic shared memory of one block
constexpr int SMEM_SM = 233472;         // of one SM, 1 KB of it per block

// ---- PTX wrappers ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// An im2col load (4D NHWC input): the 64-channel pixels of one column
// starting at channel c and at the window corner (w, h) of image n,
// shifted by the tap (kw, kh).
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, int kw, int kh) {
  const unsigned short ow = static_cast<unsigned short>(kw);
  const unsigned short oh = static_cast<unsigned short>(kh);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the shared-memory source of all but the newest N committed stores has
// been read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// all but the newest committed group of wgmmas are done
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 64-byte rows with the
// 64-byte swizzle, 8-row groups 512 bytes apart (the base 512-byte aligned).
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(512 >> 4) << 32) |
         (2ull << 62);
}

// Byte offset `off` of a tile of SPAN-byte rows (SPAN = 64 or 128) under
// TMA's SPAN-byte swizzle: the 16-byte chunk index is XORed with the row
// bits above it (the tile 1024-byte aligned).
template <int SPAN>
__device__ __forceinline__ int swz(int off) {
  return SPAN <= 16 ? off : off ^ (((off >> 7) & (SPAN / 16 - 1)) << 4);
}

// wgmma.m64nNk32 s32 += s8 x s8, both operands from shared memory; d[4j + 2h
// + e] holds row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e of
// the warpgroup's 64 x N tile.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64k32(d, a, b, scale_d);
  } else {
    wgmma_m64n128k32(d, a, b, scale_d);
  }
}

#ifdef QTPU_WGMMA_PROBE
// Probe build only (-DQTPU_WGMMA_PROBE, qtpu_torch/ops/probe_k1.py): per
// block, clock64() cycles summed by phase — [0] the consumers' wait for a
// full stage, [1] int4 unpack, wgmma issue and wait, [2] the epilogue's start
// (output buffer free, A / B rows, barrier), [3] the wait for the residual,
// [4] the epilogue's arithmetic and store issue, [5] the producer's wait for
// a free stage, [6] for a free residual buffer, [7] the block's tiles — as
// thread 0 and the producer thread see them.
__device__ long long* qtpu_wgmma_probe;
#define WG_PROBE_START(t) const long long t = clock64()
#define WG_PROBE_ADD(i, t) probe[i] += clock64() - (t)
#else
#define WG_PROBE_START(t)
#define WG_PROBE_ADD(i, t)
#endif

// ---- the kernel --------------------------------------------------------

struct Params {
  Epilogue ep;  // A, B, the scalars (res / out go through the tensor maps)
  int M, N, K;
  int stages, stage_bytes;       // ring of stages from offset 0
  int c_off, c_bytes, nc;        // output slabs: nc per warpgroup
  int res_off, res_bytes, nres;  // residual tiles
  int ab_off, bar_off;           // A / B rows per warpgroup, mbarriers
};

// A block: WGS consumer warpgroups of 64 rows each (BM = 64 WGS rows of a
// tile) and one producer warp.  Shared bytes of one stage: x (BM x BK), the
// int8 w stage the wgmmas read (BN x BK) and, for int4, the packed stage TMA
// fills (BN x BK/2).
template <int BN, int WGS, bool W4>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int NCONS = 128 * WGS;
  static constexpr int NTHREADS = NCONS + 32;
  static constexpr int A = BM * BK;
  static constexpr int B = BN * BK;
  static constexpr int BP = W4 ? BN * BK / 2 : 0;
  static constexpr int STAGE = A + B + BP;
  static constexpr int TX = A + (W4 ? BP : B);  // bytes TMA brings a stage
};

// Where the residual of row r of warpgroup wg's 64 (r < 64), columns c and
// c + 1, lies in a BM x BN residual tile of RSIZE-byte elements: TMA's
// RSPAN-byte column bands of BM rows, each under the RSPAN-byte swizzle.
// epilogue_slab reads its residual there; the two-GEMM tile (td_slab) writes
// its f32 td there.
template <int BN, int BM, int RSIZE>
__device__ __forceinline__ const uint8_t* res_at(const uint8_t* rs, int wg,
                                                 int r, int c) {
  constexpr int RSPAN = BN * RSIZE < 128 ? BN * RSIZE : 128;
  const int rb = c * RSIZE;
  return rs + (rb / RSPAN) * BM * RSPAN +
         swz<RSPAN>((64 * wg + r) * RSPAN + rb % RSPAN);
}

// The two-GEMM tile of a projection block's tail (K4 qproj.cu, K8 on the
// runner, wgmma_phase.cuh): its first product, the downsample, becomes the
// second's f32 residual
//   td = acc_d * Ad + Bd          (ep_affine: the f32 K1 writes unfused)
// stored at this thread's own accumulator positions of an f32 residual tile
// in shared memory (res_at's layout).  Each thread later reads back only
// what it wrote (the wgmma fragment of its second product is the same), so
// no barrier stands between, and the accumulator registers are free for the
// second product: K1's count, not two sets.  sA, sB: Ad, Bd of the tile's
// columns.
template <int BN, int BM>
__device__ __forceinline__ void td_slab(const int (&acc)[BN / 2],
                                        const float* sA, const float* sB,
                                        uint8_t* rs, int wg, int tw) {
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 a = *reinterpret_cast<const float2*>(sA + c);
    const float2 b = *reinterpret_cast<const float2*>(sB + c);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          const_cast<uint8_t*>(res_at<BN, BM, 4>(rs, wg, r0 + 8 * h, c))) =
          make_float2(ep_affine(acc[4 * j + 2 * h], a.x, b.x),
                      ep_affine(acc[4 * j + 2 * h + 1], a.y, b.y));
  }
}

// The epilogue of warpgroup wg's 64 x BN slab of a BM x BN tile: requantise
// `acc` with the residual tile `rs` (shared, BM rows, swizzled like the
// output), write the output slab `cs` (shared, swizzled) and copy it out with
// TMA stores.  tw: the thread's index in its warpgroup.
template <int BN, int BM, int OK, int RK>
__device__ __forceinline__ void epilogue_slab(
    const int (&acc)[BN / 2], const Params& p, const CUtensorMap* tm_out,
    const float* sA, const float* sB, const uint8_t* rs, uint8_t* cs, int wg,
    int m0, int n0, int tw) {
  constexpr int OSIZE = OK == OUT_I8 ? 1 : 4;
  constexpr int RSIZE = RK == RES_F32 ? 4 : 1;
  constexpr int OSPAN = BN * OSIZE < 128 ? BN * OSIZE : 128;
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
  const unsigned flip = p.ep.shift != 0.f ? 0x8080u : 0u;  // - shift, mod 256
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    float2 a = make_float2(0.f, 0.f), b = a;
    if (OK != OUT_I32) {
      a = *reinterpret_cast<const float2*>(sA + c);
      b = *reinterpret_cast<const float2*>(sB + c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const int ob = c * OSIZE;
      uint8_t* dst = cs + (ob / OSPAN) * 64 * OSPAN +
                     swz<OSPAN>(r * OSPAN + ob % OSPAN);
      if (OK == OUT_I32) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        continue;
      }
      float2 q = make_float2(0.f, 0.f);
      if (RK != RES_NONE) {
        const uint8_t* src = res_at<BN, BM, RSIZE>(rs, wg, r, c);
        q = RK == RES_I8
                ? residual_pair(*reinterpret_cast<const unsigned short*>(src))
                : *reinterpret_cast<const float2*>(src);
      }
      const float2 t = ep_pair<RK != RES_NONE>(p.ep, v0, v1, a, b, q);
      if (OK == OUT_I8) {
        *reinterpret_cast<unsigned short*>(dst) = code_pair(p.ep, t, flip);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(ep_f32(p.ep, t.x), ep_f32(p.ep, t.y));
      }
    }
  }
  fence_async_smem();
  named_bar(1 + wg, 128);
  const int m = m0 + 64 * wg;
  if (tw == 0 && m < p.M) {
#pragma unroll
    for (int s = 0; s < BN * OSIZE / OSPAN; ++s)
      tma_store(tm_out, cs + s * 64 * OSPAN, n0 * OSIZE + s * OSPAN, m);
    bulk_commit();
  }
}

// Packed int4 w (BN rows x 32 bytes) -> the int8 K-major, 64-byte swizzled
// tile the wgmmas read, by the block's consumer threads, then visible to
// the async proxy.
template <int BN, int NCONS>
__device__ __forceinline__ void unpack_w4(const uint8_t* bp, uint8_t* bst,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < 2 * BN; i += NCONS) {
    const int row = i >> 1, half = i & 1;
    const uint4 q = *reinterpret_cast<const uint4*>(bp + row * 32 + half * 16);
    uint4 lo, hi;
    lo.x = unpack_s4x4(q.x & 0xFFFF);
    lo.y = unpack_s4x4(q.x >> 16);
    lo.z = unpack_s4x4(q.y & 0xFFFF);
    lo.w = unpack_s4x4(q.y >> 16);
    hi.x = unpack_s4x4(q.z & 0xFFFF);
    hi.y = unpack_s4x4(q.z >> 16);
    hi.z = unpack_s4x4(q.w & 0xFFFF);
    hi.w = unpack_s4x4(q.w >> 16);
    const int off = row * 64 + half * 32;
    *reinterpret_cast<uint4*>(bst + swz<64>(off)) = lo;
    *reinterpret_cast<uint4*>(bst + swz<64>(off + 16)) = hi;
  }
  fence_async_smem();
  named_bar(3, NCONS);
}

template <int BN, int WGS, bool W4, class X>
__global__ void __launch_bounds__(Cfg<BN, WGS, W4>::NTHREADS, WGS == 1 ? 3 : 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_res,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __grid_constant__ Params p,
                      const __grid_constant__ X xl) {
  typedef Cfg<BN, WGS, W4> S;
  constexpr int BM = S::BM, NCONS = S::NCONS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  uint64_t* res_full = empty + p.stages;
  uint64_t* res_empty = res_full + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS / 32);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&res_full[b], 1);
      mbar_init(&res_empty[b], WGS);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int ktiles = (p.K + BK - 1) / BK;
  const int rk = p.ep.res_kind;
#ifdef QTPU_WGMMA_PROBE
  long long probe[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#endif

  if (tid >= NCONS) {  // the producer warp: one thread issues every copy
    if (tid != NCONS) return;
    const int rsize = rk == RES_F32 ? 4 : 1;
    const int span = BN * rsize < 128 ? BN * rsize : 128;
    int it = 0;
    for (int tile = blockIdx.x, rt = 0; tile < tiles;
         tile += gridDim.x, ++rt) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const typename X::Tile xt = xl.tile(m0);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % p.stages;
        WG_PROBE_START(t0);
        mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        WG_PROBE_ADD(5, t0);
        mbar_expect_tx(&full[s], S::TX);
        uint8_t* st = smem + s * p.stage_bytes;
        xl.load(st, &tm_x, &full[s], xt, kt);
        tma_load(W4 ? st + S::A + S::B : st + S::A, &tm_w, &full[s],
                 W4 ? kt * BK / 2 : kt * BK, n0);
      }
      // the tile's residual, after its k-stages: waiting for a free
      // residual buffer holds back no operand load
      if (rk != RES_NONE) {
        const int rb = rt % p.nres;
        WG_PROBE_START(t0);
        mbar_wait(&res_empty[rb], ((rt / p.nres) & 1) ^ 1);
        WG_PROBE_ADD(6, t0);
        mbar_expect_tx(&res_full[rb], p.res_bytes);
        uint8_t* buf = smem + p.res_off + rb * p.res_bytes;
        for (int s = 0; s < BN * rsize / span; ++s)
          tma_load(buf + s * BM * span, &tm_res, &res_full[rb],
                   n0 * rsize + s * span, m0);
      }
    }
#ifdef QTPU_WGMMA_PROBE
    qtpu_wgmma_probe[8 * blockIdx.x + 5] = probe[5];
    qtpu_wgmma_probe[8 * blockIdx.x + 6] = probe[6];
#endif
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of a tile
  const int wg = tid >> 7, tw = tid & 127, lane = tid & 31;
  float* sA = reinterpret_cast<float*>(smem + p.ab_off) + wg * 2 * BN;
  float* sB = sA + BN;
  const int ok = p.ep.out_kind;
  int it = 0, ab_n0 = -1;
  for (int tile = blockIdx.x, rt = 0; tile < tiles; tile += gridDim.x, ++rt) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = -1;  // the stage whose wgmmas may still run
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % p.stages;
      WG_PROBE_START(t0);
      mbar_wait(&full[s], (it / p.stages) & 1);
      WG_PROBE_ADD(0, t0);
      WG_PROBE_START(t1);
      uint8_t* st = smem + s * p.stage_bytes;
      uint8_t* bst = st + S::A;
      if (W4) unpack_w4<BN, NCONS>(st + S::A + S::B, bst, tid);
      const uint64_t da = desc_sw64(st + wg * 64 * BK);
      const uint64_t db = desc_sw64(bst);
      wgmma_fence();
      wgmma_tile<BN>(acc, da, db, 1);
      wgmma_tile<BN>(acc, da + 2, db + 2, 1);  // k + 32: 32 bytes on
      wgmma_commit();
      // the previous stage's wgmmas are done: free it while these run
      wgmma_wait_1();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      WG_PROBE_ADD(1, t1);
    }
    WG_PROBE_START(t2);
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(&empty[prev]);
    xl.template fix<BN>(acc, p.M, p.N, m0 + 64 * wg, n0, tw);
    WG_PROBE_ADD(1, t2);
    WG_PROBE_START(t3);

    // epilogue: the output buffer's last store has read it; A, B rows in
    // (kept while the tile column stays the same)
    if (tw == 0) {
      if (p.nc == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    if (ok != OUT_I32 && n0 != ab_n0) {
      for (int i = tw; i < BN; i += 128) {
        const int n = n0 + i;
        sA[i] = n < p.N ? p.ep.A[n] : 0.f;
        sB[i] = n < p.N ? p.ep.B[n] : 0.f;
      }
      ab_n0 = n0;
    }
    named_bar(1 + wg, 128);
    WG_PROBE_ADD(2, t3);
    const int rb = rk != RES_NONE ? rt % p.nres : 0;
    const uint8_t* rs = smem + p.res_off + rb * p.res_bytes;
    WG_PROBE_START(t4);
    if (rk != RES_NONE) mbar_wait(&res_full[rb], (rt / p.nres) & 1);
    WG_PROBE_ADD(3, t4);
    WG_PROBE_START(t5);
    uint8_t* cs = smem + p.c_off + (wg * p.nc + rt % p.nc) * p.c_bytes;
    if (ok == OUT_I32) {
      epilogue_slab<BN, BM, OUT_I32, RES_NONE>(acc, p, &tm_out, sA, sB, rs,
                                               cs, wg, m0, n0, tw);
    } else if (ok == OUT_I8) {
      if (rk == RES_I8)
        epilogue_slab<BN, BM, OUT_I8, RES_I8>(acc, p, &tm_out, sA, sB, rs, cs,
                                              wg, m0, n0, tw);
      else if (rk == RES_F32)
        epilogue_slab<BN, BM, OUT_I8, RES_F32>(acc, p, &tm_out, sA, sB, rs,
                                               cs, wg, m0, n0, tw);
      else
        epilogue_slab<BN, BM, OUT_I8, RES_NONE>(acc, p, &tm_out, sA, sB, rs,
                                                cs, wg, m0, n0, tw);
    } else {
      if (rk == RES_I8)
        epilogue_slab<BN, BM, OUT_F32, RES_I8>(acc, p, &tm_out, sA, sB, rs,
                                               cs, wg, m0, n0, tw);
      else if (rk == RES_F32)
        epilogue_slab<BN, BM, OUT_F32, RES_F32>(acc, p, &tm_out, sA, sB, rs,
                                                cs, wg, m0, n0, tw);
      else
        epilogue_slab<BN, BM, OUT_F32, RES_NONE>(acc, p, &tm_out, sA, sB, rs,
                                                 cs, wg, m0, n0, tw);
    }
    WG_PROBE_ADD(4, t5);
#ifdef QTPU_WGMMA_PROBE
    ++probe[7];
#endif
    // the slab's residual rows have been read (epilogue_slab ends on its
    // warpgroup's barrier)
    if (rk != RES_NONE && tw == 0) mbar_arrive(&res_empty[rb]);
  }
  if (tw == 0) bulk_wait_all();
#ifdef QTPU_WGMMA_PROBE
  if (tid == 0)
    for (int i = 0; i < 8; ++i)
      if (i < 5 || i == 7) qtpu_wgmma_probe[8 * blockIdx.x + i] = probe[i];
#endif
}

// ---- the host side -----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// A row-major (rows, row_bytes) byte matrix, boxes of box_rows x box_bytes.
inline bool byte_map(CUtensorMap* m, const void* base, uint64_t rows,
                     uint64_t row_bytes, uint32_t box_bytes, uint32_t box_rows,
                     CUtensorMapSwizzle sw) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_bytes, box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline CUtensorMapSwizzle swizzle_of(int span) {
  return span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : span == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                      : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// ---- where x's stages come from --------------------------------------------

// K1: x is a row-major (M, K) byte matrix; stage kt of the tile at row m0 is
// the BM x 64 box at (kt * 64, m0).  No correction.
struct GemmX {
  const int8_t* x;
  int M, K;
  struct Tile {
    int m0;
  };
  __device__ __forceinline__ Tile tile(int m0) const { return {m0}; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* tm,
                                       uint64_t* bar, const Tile& t,
                                       int kt) const {
    tma_load(dst, tm, bar, kt * BK, t.m0);
  }
  template <int BN>
  __device__ __forceinline__ void fix(int (&)[BN / 2], int, int, int, int,
                                      int) const {}
  bool encode(CUtensorMap* tm, int BM) const {
    return byte_map(tm, x, M, K, BK, BM, CU_TENSOR_MAP_SWIZZLE_64B);
  }
};

// K2 (qconv.cu) and K4's strided downsample (qproj.cu): a convolution's
// shape, and its x stages by TMA im2col loads.
struct ConvShape {
  int Bn, H, W, Ci, Co, KH, KW, stride, pt, pl, OH, OW, zp;
};

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col from the driver the runtime already loaded.
inline EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeIm2col>(f)
               : nullptr;
  }();
  return fn;
}

// Stage kt of the tile at output pixel m0: tap = 64 kt / Ci, channels
// 64 kt % Ci .. +63, for BM consecutive output pixels.  TMA's im2col mode
// walks the window corners (ow*s - pl, oh*s - pt) of the bounding box
// [-pl, (OW-1)*s - pl] x [-pt, (OH-1)*s - pt] of each image at stride s,
// across rows and images, and loads the pixel at corner + (kw, kh); one
// outside the image reads 0.
struct ConvX {
  const int8_t* x;
  const int* tapsum;  // (KH*KW, Co) int32; null when zp == 0 or no pads
  ConvShape s;
  struct Tile {
    int w, h, n;
  };
  __device__ __forceinline__ Tile tile(int m0) const {
    const int ow = m0 % s.OW, t = m0 / s.OW;
    return {ow * s.stride - s.pl, (t % s.OH) * s.stride - s.pt, t / s.OH};
  }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* tm,
                                       uint64_t* bar, const Tile& t,
                                       int kt) const {
    const int k0 = kt * qtpu::wg::BK;
    const int tap = k0 / s.Ci;
    const int kh = tap / s.KW;
    qtpu::wg::tma_load_im2col(dst, tm, bar, k0 - tap * s.Ci, t.w, t.h, t.n,
                              tap - kh * s.KW, kh);
  }
  // The zero-point term of the taps the zero fill dropped, on the thread's
  // two rows of its warpgroup's 64-row slab at m_base (wgmma's fragment:
  // acc[4j + 2h + e] is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane %
  // 4) + e).  Rows whose window lies inside the image skip it.
  template <int BN>
  __device__ __forceinline__ void fix(int (&acc)[BN / 2], int M, int N,
                                      int m_base, int n0, int tw) const {
    if (s.zp == 0 || tapsum == nullptr) return;
    const int lane = tw & 31;
    const int r0 = (tw >> 5) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + r0 + 8 * h;
      if (m >= M) continue;
      const int ow = m % s.OW, oh = (m / s.OW) % s.OH;
      const int ih = oh * s.stride - s.pt, iw = ow * s.stride - s.pl;
      const int h0 = ih < 0 ? -ih : 0;
      const int h1 = s.H - ih < s.KH ? s.H - ih : s.KH;
      const int w0 = iw < 0 ? -iw : 0;
      const int w1 = s.W - iw < s.KW ? s.W - iw : s.KW;
      if (h0 == 0 && h1 == s.KH && w0 == 0 && w1 == s.KW) continue;
      for (int kh = 0; kh < s.KH; ++kh) {
        const bool row_in = kh >= h0 && kh < h1;
        for (int kw = 0; kw < s.KW; ++kw) {
          if (row_in && kw >= w0 && kw < w1) continue;
          const int* ts = tapsum + (kh * s.KW + kw) * N + n0 + cq;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            if (n0 + 8 * j + cq < N) {
              const int2 v = __ldg(reinterpret_cast<const int2*>(ts + 8 * j));
              acc[4 * j + 2 * h] += s.zp * v.x;
              acc[4 * j + 2 * h + 1] += s.zp * v.y;
            }
          }
        }
      }
    }
  }
  bool encode(CUtensorMap* tm, int BM) const {
    const EncodeIm2col enc = encode_im2col();
    if (!enc) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(s.Ci),
                                static_cast<cuuint64_t>(s.W),
                                static_cast<cuuint64_t>(s.H),
                                static_cast<cuuint64_t>(s.Bn)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(s.Ci),
        static_cast<cuuint64_t>(s.W) * s.Ci,
        static_cast<cuuint64_t>(s.H) * s.W * s.Ci};
    const int lower[2] = {-s.pl, -s.pt};
    const int upper[2] = {(s.OW - 1) * s.stride - s.pl - (s.W - 1),
                          (s.OH - 1) * s.stride - s.pt - (s.H - 1)};
    const cuuint32_t es[4] = {1, static_cast<cuuint32_t>(s.stride),
                              static_cast<cuuint32_t>(s.stride), 1};
    return enc(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x),
               dims, strides, lower, upper, qtpu::wg::BK, BM, es,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
};

// Per-device state.  The shared-memory opt-in (cudaFuncSetAttribute) is an
// attribute of the current device only, and SM counts and occupancy are the
// device's own: a process that launches on several devices keeps them apart
// (the Python wrappers make the tensors' device current around a launch).
constexpr int MAX_DEVICES = 64;

inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline int num_sms() {
  static int n[MAX_DEVICES] = {0};
  const int dev = current_device();
  int v = dev < MAX_DEVICES ? n[dev] : 0;
  if (!v) {
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (dev < MAX_DEVICES) n[dev] = v;
  }
  return v;
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: `done` is the caller's flag per device.
template <class K>
cudaError_t opt_in_smem(K* kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  const int dev = current_device();
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// Shared-memory plan of one call: as many blocks per SM as the tiles fill
// and shared memory holds with a ring of at least MIN_STAGES stages each, so
// that one block's epilogue runs beside the others' loads and main loops;
// double-buffered output and residual tiles where they fit, the residual's
// second first (with one, the producer cannot load a tile's residual before
// the last tile's epilogue has read its own).
template <int BN, int WGS, bool W4>
bool plan(Params& p, int osize, int rsize, bool res, long tiles, int& smem,
          int& per_sm) {
  typedef Cfg<BN, WGS, W4> S;
  const int ab = WGS * 2 * BN * 4;
  const int bars = (2 * MAX_STAGES + 4) * 8;
  p.c_bytes = 64 * BN * osize;
  p.res_bytes = res ? S::BM * BN * rsize : 0;
  const int bufs[4][2] = {{2, 2}, {1, 2}, {2, 1}, {1, 1}};
  const long waves = (tiles + num_sms() - 1) / num_sms();
  for (per_sm = waves < 6 ? static_cast<int>(waves) : 6; per_sm >= 1;
       --per_sm) {
    int budget = SMEM_SM / per_sm - 1024;
    if (budget > SMEM_BLOCK_MAX) budget = SMEM_BLOCK_MAX;
    for (const auto& nb : bufs) {
      const int rbytes = res ? nb[1] * p.res_bytes : 0;
      const int fixed = 1024 + WGS * nb[0] * p.c_bytes + rbytes + ab + bars;
      int stages = (budget - fixed) / S::STAGE;
      if (stages > MAX_STAGES) stages = MAX_STAGES;
      if (stages < MIN_STAGES) continue;
      p.stages = stages;
      p.nc = nb[0];
      p.nres = nb[1];
      p.stage_bytes = S::STAGE;
      p.c_off = stages * S::STAGE;
      p.res_off = p.c_off + WGS * p.nc * p.c_bytes;
      p.ab_off = p.res_off + rbytes;
      p.bar_off = p.ab_off + ab;
      smem = 1024 + p.bar_off + (2 * stages + 4) * 8;
      return true;
    }
  }
  return false;
}

// Blocks of this kernel one SM of the current device holds with `smem`
// bytes each (registers and shared memory), cached per device and size.
template <int BN, int WGS, bool W4, class X>
int resident_blocks(int smem) {
  static int devs[8] = {0}, sizes[8] = {0}, blocks[8] = {0};
  const int dev = current_device();
  for (int i = 0; i < 8 && sizes[i]; ++i)
    if (sizes[i] == smem && devs[i] == dev) return blocks[i];
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wgmma_gemm_kernel<BN, WGS, W4, X>, Cfg<BN, WGS, W4>::NTHREADS,
      smem);
  for (int i = 0; i < 8; ++i)
    if (!sizes[i]) {
      devs[i] = dev;
      sizes[i] = smem;
      blocks[i] = n;
      break;
    }
  return n;
}

template <int BN, int WGS, bool W4, class X>
cudaError_t launch(const X& xl, const int8_t* w, int M, int N, int K,
                   const Epilogue& ep, cudaStream_t stream) {
  typedef Cfg<BN, WGS, W4> S;
  const int osize = ep.out_kind == OUT_I8 ? 1 : 4;
  const int rsize = ep.res_kind == RES_F32 ? 4 : 1;
  const bool res = ep.res_kind != RES_NONE;
  if (ep.out_kind == OUT_I8 && !int_grid(ep)) return cudaErrorInvalidValue;
  CUtensorMap tx{}, tw{}, tr{}, to{};
  const int ospan = BN * osize < 128 ? BN * osize : 128;
  const int rspan = BN * rsize < 128 ? BN * rsize : 128;
  const bool ok =
      xl.encode(&tx, S::BM) &&
      (W4 ? byte_map(&tw, w, N, K / 2, BK / 2, BN, CU_TENSOR_MAP_SWIZZLE_NONE)
          : byte_map(&tw, w, N, K, BK, BN, CU_TENSOR_MAP_SWIZZLE_64B)) &&
      byte_map(&to, ep.out, M, static_cast<uint64_t>(N) * osize, ospan, 64,
               swizzle_of(ospan)) &&
      (!res || byte_map(&tr, ep.res, M, static_cast<uint64_t>(N) * rsize,
                        rspan, S::BM, swizzle_of(rspan)));
  if (!ok) return cudaErrorInvalidValue;

  Params p;
  p.ep = ep;
  p.M = M;
  p.N = N;
  p.K = K;
  const long tiles =
      static_cast<long>((M + S::BM - 1) / S::BM) * ((N + BN - 1) / BN);
  int smem = 0, per_sm = 0;
  if (!plan<BN, WGS, W4>(p, osize, rsize, res, tiles, smem, per_sm))
    return cudaErrorInvalidValue;
  static bool attr[MAX_DEVICES] = {};  // per device, before its first launch
  const cudaError_t e = opt_in_smem(wgmma_gemm_kernel<BN, WGS, W4, X>,
                                    SMEM_BLOCK_MAX, attr);
  if (e != cudaSuccess) return e;
  const int fit = resident_blocks<BN, WGS, W4, X>(smem);
  if (fit < per_sm) per_sm = fit > 0 ? fit : 1;
  const long slots = static_cast<long>(num_sms()) * per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  wgmma_gemm_kernel<BN, WGS, W4, X>
      <<<grid, S::NTHREADS, smem, stream>>>(tx, tw, tr, to, p, xl);
  return cudaGetLastError();
}

// The tile shape of a call.  BN 64 for N <= 64, and where 128-wide tiles
// would leave SMs idle (the fc, layer4 at a small batch); 128 otherwise.
// At BN = 128, two warpgroups (128-row tiles sharing each w stage) where K
// is long enough for w's re-reads from L2 to matter and the card still gets
// two tiles per SM; one (64-row tiles, more blocks per SM) otherwise.
template <bool W4, class X>
cudaError_t launch_tiles(const X& xl, const int8_t* w, int M, int N, int K,
                         const Epilogue& ep, cudaStream_t stream) {
  const long sms = num_sms();
  const long n128 = (N + 127) / 128;
  if (N <= 64 || (M + 63) / 64 * n128 < sms)
    return launch<64, 1, W4>(xl, w, M, N, K, ep, stream);
  if (K >= 512 && (M + 127) / 128 * n128 >= 2 * sms)
    return launch<128, 2, W4>(xl, w, M, N, K, ep, stream);
  return launch<128, 1, W4>(xl, w, M, N, K, ep, stream);
}

// K1: the GEMM of a row-major (M, K) x.
template <bool W4>
cudaError_t launch_gemm(const int8_t* x, const int8_t* w, int M, int N, int K,
                        const Epilogue& ep, cudaStream_t stream) {
  return launch_tiles<W4>(GemmX{x, M, K}, w, M, N, K, ep, stream);
}

}  // namespace wg
}  // namespace qtpu
