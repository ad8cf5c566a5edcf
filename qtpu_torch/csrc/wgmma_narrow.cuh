// K1's narrow-row GEMM, and the wgmma shapes it and K2's small-channel conv
// (qconv.cu) need beyond wgmma_gemm.cuh's two.
//
// wgmma_gemm.cuh's ring takes every operand by TMA, so it needs rows that
// are multiples of 16 bytes, and its tiles are 64 or 128 columns wide and
// 64 k-values deep.  MobileNet-v2's 24-channel blocks (K = 24 expands, N = 24
// projects) and config 3's QAT GEMMs have rows of 24 bytes, or N of 16-32:
// the ring refused them (the old mma.sync loop of igemm.cuh ran them, at
// 10-16% of their bound in a traced MobileNet-v2 forward), or wasted up to
// 62.5% of every tile.  (A batch's narrow fc, fewer than 512 rows, stays on
// the old loop: ops/qmatmul.py's NARROW_MIN_M.)
//
// narrow_gemm_kernel keeps the ring's shape — one consumer warpgroup
// running wgmma s8 from shared-memory descriptors, a producer, full / empty
// mbarriers, a persistent grid — and chooses each operand's route apart, on
// the host:
//
// * a stage is 32 k-values (one 32-byte row under the 32-byte swizzle), so
//   K = 24 pads 25% and K = 144 10%, not 62.5% and 25%;
// * x and w each come by TMA where their rows are multiples of 16 bytes and
//   their base 16-byte aligned, else by cp.async of 16, 8 or 4 bytes
//   (zero-filled past K) into the same swizzled stage, issued by a whole
//   producer warpgroup (one warp issued them too slowly: 8-30 4-byte copies
//   a thread and stage); each of its 128 threads then arrives on the
//   stage's full barrier through cp.async.mbarrier.arrive.noinc when its
//   copies land (129 arrivals: the 128 threads and the TMA's expect_tx);
// * tiles are BN = 8 ... 144 columns (narrow_bn below: N = 24 one 24-wide
//   tile, N = 10 one 16-wide, N = 144 one 144-wide) and 64 to 256 rows
//   (NarrowTile: up to four m64 wgmmas a stage on separate accumulators),
//   so a narrow tile still does a 64 x 128 tile's work for each barrier
//   wait and store; where one k-stage and one tile column cover the call
//   (MobileNet-v2's K = 24 expands) every stage holds the same w, and each
//   ring slot loads it once;
// * the epilogue is epilogue_slab's arithmetic (ep_pair, code_pair, ep_f32)
//   on a plain (BM x BN) shared slab; the slab leaves by one TMA store where
//   the output rows allow, else by the warpgroup's 16-, 8- or 4-byte stores
//   (coalesced: a row's chunks are consecutive threads).  The residual comes
//   the same two ways into a plain slab.
//
// What bounds these GEMMs on the H100 is bytes (MobileNet-v2's four 24-byte
// GEMMs at B = 128 move 9.6-77 MB each: 0.014-0.023 ms at 3.35 TB/s); the
// persistent grid keeps several tiles' stages in flight on every SM.
#pragma once

#include <initializer_list>

#include "wgmma_gemm.cuh"

namespace qtpu {
namespace wg {

// ---- more wgmma shapes: both operands from shared memory ------------------

__device__ __forceinline__ void wgmma_m64n8k32(int (&d)[4], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n16k32(int (&d)[8], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n24k32(int (&d)[12], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k32(int (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n48k32(int (&d)[24], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96k32(int (&d)[48], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n144k32(int (&d)[72], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 8) {
    wgmma_m64n8k32(d, a, b, scale_d);
  } else if constexpr (BN == 16) {
    wgmma_m64n16k32(d, a, b, scale_d);
  } else if constexpr (BN == 24) {
    wgmma_m64n24k32(d, a, b, scale_d);
  } else if constexpr (BN == 32) {
    wgmma_m64n32k32(d, a, b, scale_d);
  } else if constexpr (BN == 48) {
    wgmma_m64n48k32(d, a, b, scale_d);
  } else if constexpr (BN == 64) {
    wgmma_m64n64k32(d, a, b, scale_d);
  } else if constexpr (BN == 96) {
    wgmma_m64n96k32(d, a, b, scale_d);
  } else {
    static_assert(BN == 144, "no wgmma wrapper for this BN");
    wgmma_m64n144k32(d, a, b, scale_d);
  }
}

// ---- A from registers (K2's small-channel conv builds its A fragments from
// staged input rows): each warp of the warpgroup holds 16 rows, laid out as
// mma.sync m16n8k32's A — a[0] rows g, k 4 tg .. 4 tg + 3; a[1] rows g + 8;
// a[2], a[3] the same at k + 16 (g = lane / 4, tg = lane % 4) ---------------

__device__ __forceinline__ void wgmma_rs_m64n16k32(int (&d)[8],
                                                   const unsigned (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n32k32(int (&d)[16],
                                                   const unsigned (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k32(int (&d)[32],
                                                   const unsigned (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128k32(int (&d)[64],
                                                   const unsigned (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(int (&d)[BN / 2],
                                         const unsigned (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 16) {
    wgmma_rs_m64n16k32(d, a, b, scale_d);
  } else if constexpr (BN == 32) {
    wgmma_rs_m64n32k32(d, a, b, scale_d);
  } else if constexpr (BN == 64) {
    wgmma_rs_m64n64k32(d, a, b, scale_d);
  } else {
    static_assert(BN == 128, "no register-A wgmma wrapper for this BN");
    wgmma_rs_m64n128k32(d, a, b, scale_d);
  }
}

// Shared-memory matrix descriptor of a K-major tile of 32-byte rows under
// the 32-byte swizzle, 8-row groups 256 bytes apart (the base 1024-byte
// aligned: no base offset).
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(256 >> 4) << 32) |
         (3ull << 62);
}

// cp.async of `ch` bytes (16, 8 or 4; src and dst aligned to it); with
// `pred` false the bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async_chunk(void* dst, const void* src,
                                               int ch, bool pred) {
  const uint32_t s = smem_u32(dst);
  if (ch == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(pred ? 16 : 0)
                 : "memory");
  } else if (ch == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(pred ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(pred ? 4 : 0)
                 : "memory");
  }
}

// The mbarrier gets one arrival from this thread once every cp.async it
// issued so far has landed (its expected count includes that arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A plain copy of `ch` bytes (16, 8, 4, 2 or 1; both sides aligned to it).
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int ch) {
  if (ch == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else if (ch == 8)
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else if (ch == 4)
    *reinterpret_cast<unsigned*>(dst) =
        *reinterpret_cast<const unsigned*>(src);
  else if (ch == 2)
    *reinterpret_cast<unsigned short*>(dst) =
        *reinterpret_cast<const unsigned short*>(src);
  else
    *reinterpret_cast<uint8_t*>(dst) = *reinterpret_cast<const uint8_t*>(src);
}

// The largest of 16, 8, 4, 2, 1 bytes that divides every value (host).
inline int chunk_of(std::initializer_list<uint64_t> vals) {
  for (int c = 16; c > 1; c /= 2) {
    bool ok = true;
    for (uint64_t v : vals) ok = ok && v % c == 0;
    if (ok) return c;
  }
  return 1;
}

// ---- the narrow-row GEMM ----------------------------------------------------

constexpr int NBK = 32;                   // k values per stage
constexpr int NARROW_CONS = 128;          // one consumer warpgroup
constexpr int NARROW_PROD = 128;          // and one producer warpgroup
constexpr int NARROW_THREADS = NARROW_CONS + NARROW_PROD;
constexpr int NARROW_ARRIVALS = 1 + NARROW_PROD;  // expect_tx + cp.async
constexpr int NARROW_MAX_PER_SM = 8;

// m64 blocks a tile of BN columns: the warpgroup runs MT wgmmas a stage on
// MT x BN accumulators, so a narrow tile still carries 64 x 128 outputs'
// worth of work for each stage wait, barrier and store
template <int BN>
struct NarrowTile {
  static constexpr int MT = BN <= 32 ? 4 : BN <= 64 ? 2 : 1;
  static constexpr int BM = 64 * MT;
  static constexpr int XB = BM * NBK;     // x bytes of a stage
};

struct NarrowParams {
  Epilogue ep;
  const int8_t* x;
  const int8_t* w;
  int M, N, K;
  int xch, wch;  // cp.async chunk bytes of x's / w's rows; 0: TMA
  int och, rch;  // store / copy chunk bytes of the output / residual; 0: TMA
  int stages, stage_bytes;         // ring: x's tile, then w's
  int c_off, c_bytes, nc;          // output slabs
  int res_off, res_bytes, nres;    // residual slabs
  int ab_off, bar_off;
};

// Bytes k0 .. k0 + 31 of rows r0 .. r0 + nrows - 1 of a row-major (rows, K)
// byte matrix into a (nrows x 32) stage under the 32-byte swizzle, by the
// producer warpgroup's threads in chunks of ch bytes; zero past K (K a
// multiple of ch).  Rows past `rows` are not written: they only make
// accumulator rows (or columns) that are never stored.
__device__ __forceinline__ void cp_rows32(uint8_t* dst, const int8_t* src,
                                          int rows, int K, int r0, int nrows,
                                          int k0, int ch, int pt) {
  const int sh = ch == 16 ? 1 : ch == 8 ? 2 : 3;  // log2 of chunks a row
  const int n = (rows - r0 < nrows ? rows - r0 : nrows) << sh;
  for (int i = pt; i < n; i += NARROW_PROD) {
    const int r = i >> sh, cb = (i & ((1 << sh) - 1)) * ch;
    const int k = k0 + cb;
    const bool v = k < K;
    cp_async_chunk(dst + swz<32>(r * NBK + cb),
                   v ? src + static_cast<size_t>(r0 + r) * K + k : src, ch,
                   v);
  }
}

// Rows r0 .. r0 + nrows - 1 (those below `rows`), bytes b0 .. b0 + nbytes -
// 1 of a row-major byte matrix of `pitch`-byte rows, to or from a shared slab
// of `spitch`-byte rows, in chunks of ch bytes: by cp.async into the slab
// (TO false) or by plain stores out of it (TO true); `nthr` threads from
// `tid`.
template <bool TO>
__device__ __forceinline__ void move_seg(uint8_t* slab, int spitch,
                                         uint8_t* g, int pitch, int rows,
                                         int r0, int nrows, int b0,
                                         int nbytes, int ch, int tid,
                                         int nthr) {
  const int cpr = nbytes / ch;
  const int n = (rows - r0 < nrows ? rows - r0 : nrows) * cpr;
  for (int i = tid; i < n; i += nthr) {
    const int r = i / cpr, cb = (i - r * cpr) * ch;
    uint8_t* gp = g + static_cast<size_t>(r0 + r) * pitch + b0 + cb;
    if (TO)
      copy_chunk(gp, slab + r * spitch + cb, ch);
    else
      cp_async_chunk(slab + r * spitch + cb, gp, ch, true);
  }
}

// The epilogue of a 64 x BN block of the tile at column n0 into the plain
// slab `cs` (its first row; BN columns a row), the residual from the plain
// slab `rs`: ep_pair, then code_pair / ep_f32 as epilogue_slab; columns
// past N are not written.
template <int BN, int OK, int RK>
__device__ __forceinline__ void narrow_slab(const int (&acc)[BN / 2],
                                            const NarrowParams& p,
                                            const float* sA, const float* sB,
                                            const uint8_t* rs, uint8_t* cs,
                                            int n0, int tw) {
  constexpr int OSIZE = OK == OUT_I8 ? 1 : 4;
  constexpr int RSIZE = RK == RES_F32 ? 4 : 1;
  const int lane = tw & 31;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);
  const unsigned flip = p.ep.shift != 0.f ? 0x8080u : 0u;  // - shift, mod 256
  const int nl = p.N - n0;  // columns of the tile that exist
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (c >= nl) continue;
    const bool two = c + 1 < nl;
    float2 a = make_float2(0.f, 0.f), b = a;
    if (OK != OUT_I32) {
      a = *reinterpret_cast<const float2*>(sA + c);
      b = *reinterpret_cast<const float2*>(sB + c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      uint8_t* dst = cs + (r * BN + c) * OSIZE;
      if (OK == OUT_I32) {
        if (two)
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        else
          *reinterpret_cast<int*>(dst) = v0;
        continue;
      }
      float2 q = make_float2(0.f, 0.f);
      if (RK != RES_NONE) {
        const uint8_t* src = rs + (r * BN + c) * RSIZE;
        q = RK == RES_I8
                ? residual_pair(*reinterpret_cast<const unsigned short*>(src))
                : *reinterpret_cast<const float2*>(src);
      }
      const float2 t = ep_pair<RK != RES_NONE>(p.ep, v0, v1, a, b, q);
      if (OK == OUT_I8) {
        const unsigned short cp = code_pair(p.ep, t, flip);
        if (two)
          *reinterpret_cast<unsigned short*>(dst) = cp;
        else
          *dst = static_cast<uint8_t>(cp);
      } else if (two) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(ep_f32(p.ep, t.x), ep_f32(p.ep, t.y));
      } else {
        *reinterpret_cast<float*>(dst) = ep_f32(p.ep, t.x);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(NARROW_THREADS)
    narrow_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_res,
                       const __grid_constant__ CUtensorMap tm_out,
                       const __grid_constant__ NarrowParams p) {
  typedef NarrowTile<BN> T;
  constexpr int MT = T::MT, BM = T::BM;
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
      mbar_init(&full[s], NARROW_ARRIVALS);
      mbar_init(&empty[s], NARROW_CONS / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&res_full[b], NARROW_ARRIVALS);
      mbar_init(&res_empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int ktiles = (p.K + NBK - 1) / NBK;
  // one k-stage and one tile column: every stage holds the same w, so each
  // ring slot loads it once
  const bool w_fixed = ktiles == 1 && n_tiles == 1;
  const int rk = p.ep.res_kind, ok = p.ep.out_kind;
  const int osize = ok == OUT_I8 ? 1 : 4, rsize = rk == RES_F32 ? 4 : 1;

  if (tid >= NARROW_CONS) {  // the producer warpgroup
    const int pt = tid - NARROW_CONS;  // the thread's index in it
    int it = 0;
    for (int tile = blockIdx.x, rt = 0; tile < tiles;
         tile += gridDim.x, ++rt) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % p.stages;
        const bool load_w = !w_fixed || it < p.stages;
        mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        uint8_t* st = smem + s * p.stage_bytes;
        if (pt == 0) {
          mbar_expect_tx(&full[s], (p.xch ? 0 : T::XB) +
                                       (p.wch || !load_w ? 0 : BN * NBK));
          if (!p.xch) tma_load(st, &tm_x, &full[s], kt * NBK, m0);
          if (!p.wch && load_w)
            tma_load(st + T::XB, &tm_w, &full[s], kt * NBK, n0);
        }
        if (p.xch)
          cp_rows32(st, p.x, p.M, p.K, m0, BM, kt * NBK, p.xch, pt);
        if (p.wch && load_w)
          cp_rows32(st + T::XB, p.w, p.N, p.K, n0, BN, kt * NBK, p.wch,
                    pt);
        cp_async_arrive(&full[s]);
      }
      if (rk != RES_NONE) {  // the tile's residual, after its k-stages
        const int rb = rt % p.nres;
        mbar_wait(&res_empty[rb], ((rt / p.nres) & 1) ^ 1);
        uint8_t* buf = smem + p.res_off + rb * p.res_bytes;
        if (pt == 0) {
          mbar_expect_tx(&res_full[rb], p.rch ? 0 : BM * BN * rsize);
          if (!p.rch)
            tma_load(buf, &tm_res, &res_full[rb], n0 * rsize, m0);
        }
        if (p.rch) {
          const int nc = p.N - n0 < BN ? p.N - n0 : BN;
          move_seg<false>(buf, BN * rsize,
                          static_cast<uint8_t*>(const_cast<void*>(p.ep.res)),
                          p.N * rsize, p.M, m0, BM, n0 * rsize, nc * rsize,
                          p.rch, pt, NARROW_PROD);
        }
        cp_async_arrive(&res_full[rb]);
      }
    }
    return;
  }

  // the consumer warpgroup: the tile's BM rows as MT blocks of 64
  const int tw = tid, lane = tid & 31;
  float* sA = reinterpret_cast<float*>(smem + p.ab_off);
  float* sB = sA + BN;
  int it = 0, ab_n0 = -1;
  for (int tile = blockIdx.x, rt = 0; tile < tiles; tile += gridDim.x, ++rt) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    int acc[MT][BN / 2];
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      fence_async_smem();  // the cp.async bytes, to wgmma's async proxy
      const uint8_t* st = smem + s * p.stage_bytes;
      const uint64_t db = desc_sw32(st + T::XB);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < MT; ++b)
        wgmma_ss<BN>(acc[b], desc_sw32(st + b * 64 * NBK), db, 1);
      wgmma_commit();
      // the previous stage's wgmmas are done: free it while these run
      wgmma_wait_1();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: a TMA-stored slab's last store has read it; A, B rows in
    if (!p.och && tw == 0) {
      if (p.nc == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    if (ok != OUT_I32 && n0 != ab_n0) {
      for (int i = tw; i < BN; i += NARROW_CONS) {
        const int n = n0 + i;
        sA[i] = n < p.N ? p.ep.A[n] : 0.f;
        sB[i] = n < p.N ? p.ep.B[n] : 0.f;
      }
      ab_n0 = n0;
    }
    named_bar(1, NARROW_CONS);
    const int rb = rk != RES_NONE ? rt % p.nres : 0;
    const uint8_t* rs = smem + p.res_off + rb * p.res_bytes;
    if (rk != RES_NONE) mbar_wait(&res_full[rb], (rt / p.nres) & 1);
    uint8_t* cs = smem + p.c_off + (rt % p.nc) * p.c_bytes;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const uint8_t* rsb = rs + b * 64 * BN * rsize;
      uint8_t* csb = cs + b * 64 * BN * osize;
      if (ok == OUT_I32) {
        narrow_slab<BN, OUT_I32, RES_NONE>(acc[b], p, sA, sB, rsb, csb, n0,
                                           tw);
      } else if (ok == OUT_I8) {
        if (rk == RES_I8)
          narrow_slab<BN, OUT_I8, RES_I8>(acc[b], p, sA, sB, rsb, csb, n0,
                                          tw);
        else if (rk == RES_F32)
          narrow_slab<BN, OUT_I8, RES_F32>(acc[b], p, sA, sB, rsb, csb, n0,
                                           tw);
        else
          narrow_slab<BN, OUT_I8, RES_NONE>(acc[b], p, sA, sB, rsb, csb, n0,
                                            tw);
      } else {
        if (rk == RES_I8)
          narrow_slab<BN, OUT_F32, RES_I8>(acc[b], p, sA, sB, rsb, csb, n0,
                                           tw);
        else if (rk == RES_F32)
          narrow_slab<BN, OUT_F32, RES_F32>(acc[b], p, sA, sB, rsb, csb, n0,
                                            tw);
        else
          narrow_slab<BN, OUT_F32, RES_NONE>(acc[b], p, sA, sB, rsb, csb, n0,
                                             tw);
      }
    }
    if (!p.och) {
      fence_async_smem();
      named_bar(1, NARROW_CONS);
      if (tw == 0) {
        tma_store(&tm_out, cs, n0 * osize, m0);
        bulk_commit();
      }
    } else {
      named_bar(1, NARROW_CONS);
      const int nc = p.N - n0 < BN ? p.N - n0 : BN;
      move_seg<true>(cs, BN * osize, static_cast<uint8_t*>(p.ep.out),
                     p.N * osize, p.M, m0, BM, n0 * osize, nc * osize, p.och,
                     tw, NARROW_CONS);
    }
    // the slab's residual has been read (the barrier above)
    if (rk != RES_NONE && tw == 0) mbar_arrive(&res_empty[rb]);
  }
  if (tw == 0) bulk_wait_all();
}

// The tile width of a call: the fewest columns counting 16 more a tile (x's
// stage, read again for every tile of a row), ties to the wider (N = 24 one
// 24-wide tile, N = 10 one 16-wide, N = 84 one 96-wide, N = 144 one
// 144-wide).
inline int narrow_bn(int N) {
  static const int opts[] = {8, 16, 24, 32, 48, 64, 96, 144};
  int best = 0;
  long least = -1;
  for (int bn : opts) {
    const long cost = static_cast<long>((N + bn - 1) / bn) * (bn + 16);
    if (least < 0 || cost <= least) {
      least = cost;
      best = bn;
    }
  }
  return best;
}

// Blocks of narrow_gemm_kernel<BN> one SM of the current device holds with
// `smem` bytes each, cached per device and size.
template <int BN>
int narrow_resident(int smem) {
  static int devs[8] = {0}, sizes[8] = {0}, blocks[8] = {0};
  const int dev = current_device();
  for (int i = 0; i < 8 && sizes[i]; ++i)
    if (sizes[i] == smem && devs[i] == dev) return blocks[i];
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, narrow_gemm_kernel<BN>, NARROW_THREADS, smem);
  for (int i = 0; i < 8; ++i)
    if (!sizes[i]) {
      devs[i] = dev;
      sizes[i] = smem;
      blocks[i] = n;
      break;
    }
  return n;
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int BN>
cudaError_t launch_narrow_bn(const int8_t* x, const int8_t* w, int M, int N,
                             int K, const Epilogue& ep, cudaStream_t stream) {
  typedef NarrowTile<BN> T;
  const int osize = ep.out_kind == OUT_I8 ? 1 : 4;
  const int rsize = ep.res_kind == RES_F32 ? 4 : 1;
  const bool res = ep.res_kind != RES_NONE;
  if (ep.out_kind == OUT_I8 && !int_grid(ep)) return cudaErrorInvalidValue;
  NarrowParams p;
  p.ep = ep;
  p.x = x;
  p.w = w;
  p.M = M;
  p.N = N;
  p.K = K;
  const uint64_t xb = reinterpret_cast<uintptr_t>(x);
  const uint64_t wb = reinterpret_cast<uintptr_t>(w);
  const uint64_t ob = reinterpret_cast<uintptr_t>(ep.out);
  const uint64_t rb = reinterpret_cast<uintptr_t>(ep.res);
  const uint64_t orow = static_cast<uint64_t>(N) * osize;
  const uint64_t rrow = static_cast<uint64_t>(N) * rsize;
  // x, w: TMA where rows are 16-byte multiples from a 16-byte aligned base,
  // else cp.async chunks; the output and residual: TMA where their rows and
  // the tile's BN columns are 16-byte multiples from an aligned base and
  // fit a box row, else the threads' chunks
  const int xc = chunk_of({xb, static_cast<uint64_t>(K)});
  const int wc = chunk_of({wb, static_cast<uint64_t>(K)});
  const int oc = chunk_of({ob, orow, static_cast<uint64_t>(BN) * osize});
  const int rc =
      res ? chunk_of({rb, rrow, static_cast<uint64_t>(BN) * rsize}) : 16;
  if (xc < 4 || wc < 4 || oc < 4 || rc < 4) return cudaErrorInvalidValue;
  // (a TMA box row holds at most 256 bytes here: 256 elements of a byte map)
  p.xch = xc == 16 ? 0 : xc;
  p.wch = wc == 16 ? 0 : wc;
  p.och = oc == 16 && BN * osize <= 256 ? 0 : oc;
  p.rch = !res || (rc == 16 && BN * rsize <= 256) ? 0 : rc;
  CUtensorMap tx{}, tw{}, tr{}, to{};
  const bool ok =
      (p.xch ||
       byte_map(&tx, x, M, K, NBK, T::BM, CU_TENSOR_MAP_SWIZZLE_32B)) &&
      (p.wch || byte_map(&tw, w, N, K, NBK, BN, CU_TENSOR_MAP_SWIZZLE_32B)) &&
      (p.och || byte_map(&to, ep.out, M, orow, BN * osize, T::BM,
                         CU_TENSOR_MAP_SWIZZLE_NONE)) &&
      (!res || p.rch ||
       byte_map(&tr, ep.res, M, rrow, BN * rsize, T::BM,
                CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return cudaErrorInvalidValue;

  // shared memory: a ring of stages (x, then w at a 1024-byte boundary),
  // output and residual slabs, A / B, the barriers; as many blocks an SM as
  // the tiles fill, each with 4-8 stages
  p.stage_bytes = T::XB + round_up(BN * NBK, 1024);
  p.c_bytes = round_up(T::BM * BN * osize, 128);
  p.nc = p.och ? 1 : 2;
  p.res_bytes = res ? round_up(T::BM * BN * rsize, 128) : 0;
  p.nres = 2;
  const int fixed = 1024 + p.nc * p.c_bytes + p.nres * p.res_bytes +
                    2 * BN * 4 + (2 * MAX_STAGES + 4) * 8;
  const long tiles =
      static_cast<long>((M + T::BM - 1) / T::BM) * ((N + BN - 1) / BN);
  const long waves = (tiles + num_sms() - 1) / num_sms();
  int per_sm = waves < NARROW_MAX_PER_SM ? static_cast<int>(waves)
                                         : NARROW_MAX_PER_SM;
  int stages = 0;
  for (; per_sm >= 1; --per_sm) {
    int budget = SMEM_SM / per_sm - 1024;
    if (budget > SMEM_BLOCK_MAX) budget = SMEM_BLOCK_MAX;
    stages = (budget - fixed) / p.stage_bytes;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    if (stages >= MIN_STAGES) break;
  }
  if (per_sm < 1) return cudaErrorInvalidValue;
  p.stages = stages;
  p.c_off = stages * p.stage_bytes;
  p.res_off = p.c_off + p.nc * p.c_bytes;
  p.ab_off = p.res_off + p.nres * p.res_bytes;
  p.bar_off = round_up(p.ab_off + 2 * BN * 4, 8);
  const int smem = 1024 + p.bar_off + (2 * stages + 4) * 8;
  static bool attr[MAX_DEVICES] = {};  // per device, before its first launch
  const cudaError_t e =
      opt_in_smem(narrow_gemm_kernel<BN>, SMEM_BLOCK_MAX, attr);
  if (e != cudaSuccess) return e;
  const int fit = narrow_resident<BN>(smem);
  if (fit < per_sm) per_sm = fit > 0 ? fit : 1;
  const long slots = static_cast<long>(num_sms()) * per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  narrow_gemm_kernel<BN>
      <<<grid, NARROW_THREADS, smem, stream>>>(tx, tw, tr, to, p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace qtpu
