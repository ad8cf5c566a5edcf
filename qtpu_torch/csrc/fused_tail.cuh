// The identity-bottleneck tail that K5 (qtail.cu) and K6 (qblock.cu) share:
//   conv2 (3x3, stride 1) -> requant -> conv3 (1x1) + int8 residual
//   -> relu -> requant
// on one TH x TW spatial tile of one image, run by one block of
// TAIL_THREADS threads.  The caller has put conv2's input halo — the
// (TH + 2) x (TW + 2) pixels the tile's 3x3 windows read, each Cmid int8
// codes, the zero point where a pixel lies outside the image — in shared
// memory.  Then:
//   1. conv2 as an implicit GEMM whose A rows are read straight from the
//      halo (HaloA: tap (kh, kw) of output pixel (ty, tx) is halo pixel
//      (ty + kh, tx + kw)), Cmid / 64 output-channel passes of 64, each
//      requantised in registers into the `mid` tile (64 x Cmid codes);
//   2. conv3 with `mid` as its resident A operand, Cout / 64 passes of 64,
//      the int8 residual and the requant in registers, codes to the output.
// Only w2, w3, the residual and the output touch device memory; conv2's
// codes never do.  Every epilogue step is epilogue.cuh's (ep_affine, then
// + r * C, then ep_code), in the order of the unfused K2 -> K1 sequence, so
// the codes are bit-identical to it.
//
// Shared memory (dynamic, 16-byte aligned):
//   halo  HALO x halo_stride(Cmid)
//   mid   TailTile::BM x mid_stride(Cmid)
//   Bs    2 stages of TailTile::STAGE_B (w2 / w3 tiles)
// Rows are padded by 16 bytes so a warp's fragment loads hit distinct banks.
#pragma once

#include "igemm.cuh"

namespace qtpu {

constexpr int TH = 8, TW = 8;             // output pixels per tile
constexpr int HH = TH + 2, HW = TW + 2;   // conv2's halo
constexpr int HALO = HH * HW;
typedef TileCfg<64, 64, 2, 2> TailTile;   // TH * TW rows x 64 channels
constexpr int TAIL_THREADS = TailTile::NTHREADS;
static_assert(TailTile::BM == TH * TW, "one GEMM row per output pixel");

__host__ __device__ inline int halo_stride(int cmid) { return cmid + 16; }
__host__ __device__ inline int mid_stride(int cmid) {
  return (cmid + BK - 1) / BK * BK + 16;  // conv3 reads whole BK stages
}
inline size_t tail_smem_bytes(int cmid) {
  return static_cast<size_t>(HALO) * halo_stride(cmid) +
         static_cast<size_t>(TailTile::BM) * mid_stride(cmid) +
         2 * TailTile::STAGE_B;
}

struct TailArgs {
  const int8_t* w2;  // (Cmid, 9 * Cmid), K = (kh, kw, ci)
  const int8_t* w3;  // (Cout, Cmid)
  const float *A2, *B2, *A3, *B3;
  float lo2, hi2, shift2;
  float C3, lo3, hi3, shift3;
  const int8_t* res;  // (B, H, W, Cout) int8 residual codes
  int8_t* out;        // (B, H, W, Cout)
  int H, W, Cmid, Cout;
};

// Probe build only (-DQTPU_TAIL_PROBE, qtpu_torch/ops/probe_tail.py): thread
// 0 of each block sums clock64() cycles by phase — [0] the halo (its copy or
// fill and the barrier after it), [1] conv1 (K6), [2] conv2's main loop, [3]
// conv2's requant into mid, [4] conv3's main loop, [5] conv3's epilogue, [6]
// the cluster exchange (wgmma_tail.cuh only); within the main loops, [7] the
// waits for a full stage and [8] for the wgmmas (wgmma_tail.cuh only); [9]
// the block's total — and writes them to qtpu_tail_probe[10 * blockIdx.x +
// i].  lap(i) gives phase i the cycles since the previous lap, add(i, c)
// adds c; without the flag both compile to nothing.
#ifdef QTPU_TAIL_PROBE
__device__ long long* qtpu_tail_probe;
struct TailProbe {
  long long v[10], t0, t;
  __device__ TailProbe() {
    t0 = t = clock64();
    for (int i = 0; i < 10; ++i) v[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    const long long n = clock64();
    v[i] += n - t;
    t = n;
  }
  __device__ __forceinline__ void add(int i, long long c) { v[i] += c; }
  __device__ void store() {
    v[9] = clock64() - t0;
    if (threadIdx.x == 0)
      for (int i = 0; i < 10; ++i)
        qtpu_tail_probe[10 * blockIdx.x + i] = v[i];
  }
};
#define TAIL_CLOCK() clock64()
#else
struct TailProbe {
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void store() {}
};
#define TAIL_CLOCK() 0ll
#endif

// Which tile a block owns: image b, tile origin (ty0, tx0).
struct TileAt {
  int b, ty0, tx0;
  __device__ TileAt(int H, int W) {
    const int tx = (W + TW - 1) / TW;
    const int ty = (H + TH - 1) / TH;
    const int t = blockIdx.x;
    b = t / (tx * ty);
    ty0 = (t / tx) % ty * TH;
    tx0 = t % tx * TW;
  }
};

// conv2's A operand read from the halo.  Cmid % 16 == 0, so the four bytes a
// fragment register holds never straddle two taps.
struct HaloA {
  const int8_t* halo;
  int hs, cmid, K;
  __device__ void load(int, int) {}
  __device__ const int8_t* base(int) const { return halo; }
  __device__ int row_off(int r) const {
    return ((r / TW) * HW + r % TW) * hs;
  }
  __device__ int k_off(int k0, int kk) const {
    const int k = k0 + kk;
    if (k >= K) return 0;  // past the reduction: w2 is zero-filled there
    const int tap = k / cmid;
    const int ci = k - tap * cmid;
    return ((tap / 3) * HW + tap % 3) * hs + ci;
  }
};

// Phases 1 and 2.  Every thread of the block calls it, after the halo is
// complete and visible (a __syncthreads since it was written).
__device__ __forceinline__ void tail_phases(const TailArgs& p,
                                            const int8_t* halo, int8_t* mid,
                                            int8_t* Bs, const TileAt& at,
                                            TailProbe& pr) {
  typedef TailTile T;
  const Frag<T> f;
  const int ms = mid_stride(p.Cmid);
  int acc[T::MT][T::NT][4];

  // 1. conv2 -> requant into mid
  HaloA ha{halo, halo_stride(p.Cmid), p.Cmid, 9 * p.Cmid};
  for (int n0 = 0; n0 < p.Cmid; n0 += T::BN) {
    StagedB<T, true> b(p.w2, Bs, p.Cmid, 9 * p.Cmid, n0);
    mainloop<T>(ha, b, 9 * p.Cmid, acc);
    pr.lap(2);
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + f.col(j, e);
            if (n < p.Cmid)
              mid[f.row(i, h) * ms + n] = ep_code(
                  ep_affine(acc[i][j][2 * h + e], p.A2[n], p.B2[n]), p.lo2,
                  p.hi2, p.shift2);
          }
    pr.lap(3);
  }
  __syncthreads();  // mid complete before conv3 reads it
  pr.lap(3);

  // 2. conv3 + residual -> requant to the output
  TileA ma{mid, ms};
  for (int n0 = 0; n0 < p.Cout; n0 += T::BN) {
    StagedB<T, true> b(p.w3, Bs, p.Cout, p.Cmid, n0);
    mainloop<T>(ma, b, p.Cmid, acc);
    pr.lap(4);
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row(i, h);
        const int oy = at.ty0 + r / TW;
        const int ox = at.tx0 + r % TW;
        if (oy >= p.H || ox >= p.W) continue;
        const size_t pix =
            (static_cast<size_t>(at.b) * p.H + oy) * p.W + ox;
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + f.col(j, e);
            if (n >= p.Cout) continue;
            const size_t idx = pix * p.Cout + n;
            float t = ep_affine(acc[i][j][2 * h + e], p.A3[n], p.B3[n]);
            t = __fadd_rn(t, __fmul_rn(static_cast<float>(p.res[idx]), p.C3));
            p.out[idx] = ep_code(t, p.lo3, p.hi3, p.shift3);
          }
        }
      }
    }
    pr.lap(5);
  }
  pr.store();
}

// One int8 code replicated into 16 bytes (a zero-point fill).
__device__ __forceinline__ int4 splat16(int code) {
  const int v = static_cast<int>((static_cast<unsigned>(code) & 0xffu) *
                                 0x01010101u);
  return make_int4(v, v, v, v);
}

// Allow a kernel the dynamic shared memory an H100 block can have (227 KB;
// above 48 KB a launch needs the opt-in).
inline cudaError_t allow_big_smem(const void* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
}

}  // namespace qtpu
