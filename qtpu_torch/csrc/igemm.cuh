// Shared core of the int8 GEMM kernels: an int8 x int8 -> int32 tensor-core
// GEMM tile loop (mma.sync m16n8k32 s8) ending in the folded requant
// epilogue of epilogue.cuh.
//
// C[m, n] = sum_k A[m, k] * W[n, k], W stored (N, K) K-contiguous.  The A
// operand is addressed through a loader policy, so the same core serves the
// plain GEMM (qmatmul.cu) and the implicit-GEMM convolution (qconv.cu).
//
// Block tile BM x BN, depth BK = 64 bytes per stage, two shared-memory stages
// filled with cp.async (16-byte chunks, zero-filled past the ragged edges of
// M, N and K) while the tensor cores work on the other stage.  Shared rows are
// padded to 80 bytes so that the 32-bit fragment loads of a warp hit 32
// distinct banks.  The epilogue runs in registers on the int32 accumulators.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace qtpu {

constexpr int BK = 64;       // K bytes per pipeline stage
constexpr int SK = BK + 16;  // padded shared row stride in bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_one(const Epilogue& ep, int m, int n,
                                          int N, int acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  if (ep.out_kind == OUT_I32) {
    static_cast<int*>(ep.out)[idx] = acc;
    return;
  }
  float t = ep_affine(acc, ep.A[n], ep.B[n]);
  if (ep.res_kind == RES_I8) {
    float r = static_cast<float>(static_cast<const int8_t*>(ep.res)[idx]);
    t = __fadd_rn(t, __fmul_rn(r, ep.C));
  } else if (ep.res_kind == RES_F32) {
    t = __fadd_rn(t, __fmul_rn(static_cast<const float*>(ep.res)[idx], ep.C));
  }
  if (ep.out_kind == OUT_I8) {
    static_cast<int8_t*>(ep.out)[idx] = ep_code(ep, t);
    return;
  }
  static_cast<float*>(ep.out)[idx] = ep_f32(ep, t);
}

// WARPS_M x WARPS_N warps; each warp owns a (BM/WARPS_M) x (BN/WARPS_N) tile.
// VEC: every 16-byte chunk of K lies in one row of the source and is 16-byte
// aligned (the loader guarantees it when K, or Ci for the conv, is a multiple
// of 16); otherwise chunks are gathered byte by byte.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC, class ALoader>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    igemm_kernel(ALoader al, const int8_t* __restrict__ w, int M, int N,
                 int K, Epilogue ep) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = WN / 8;   // n8 tiles per warp
  constexpr int CPR = BK / 16; // 16-byte chunks per row and stage
  constexpr int A_CHUNKS = BM * CPR / NTHREADS;
  constexpr int B_CHUNKS = BN * CPR / NTHREADS;
  static_assert(BM * CPR % NTHREADS == 0 && BN * CPR % NTHREADS == 0,
                "tile does not split evenly over the threads");

  __shared__ __align__(16) int8_t As[2][BM * SK];
  __shared__ __align__(16) int8_t Bs[2][BN * SK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int g = lane >> 2;  // groupID
  const int tg = lane & 3;  // thread in group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Each thread loads the same rows at every stage: resolve them once.
  typename ALoader::Row arow[A_CHUNKS];
  int a_r[A_CHUNKS], a_c[A_CHUNKS];
  bool a_ok[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = tid + i * NTHREADS;
    a_r[i] = c / CPR;
    a_c[i] = (c % CPR) * 16;
    a_ok[i] = m0 + a_r[i] < M;
    arow[i] = al.row(a_ok[i] ? m0 + a_r[i] : 0);
  }
  int b_r[B_CHUNKS], b_c[B_CHUNKS];
  bool b_ok[B_CHUNKS];
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    const int c = tid + i * NTHREADS;
    b_r[i] = c / CPR;
    b_c[i] = (c % CPR) * 16;
    b_ok[i] = n0 + b_r[i] < N;
  }

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      int8_t* dst = &As[s][a_r[i] * SK + a_c[i]];
      const int k = k0 + a_c[i];
      if (VEC) {
        const bool ok = a_ok[i] && k < K;
        cp_async16(dst, ok ? al.ptr(arow[i], k) : al.base(), ok);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (a_ok[i] && k + j < K) ? *al.ptr(arow[i], k + j)
                                          : static_cast<int8_t>(0);
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      int8_t* dst = &Bs[s][b_r[i] * SK + b_c[i]];
      const int k = k0 + b_c[i];
      const int8_t* src = w + static_cast<size_t>(n0 + b_r[i]) * K + k;
      if (VEC) {
        const bool ok = b_ok[i] && k < K;
        cp_async16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (b_ok[i] && k + j < K) ? src[j] : static_cast<int8_t>(0);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest has landed
    __syncthreads();
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[MT][4];
      unsigned bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = warp_m * WM + i * 16 + g;
        const int8_t* p0 = as + r * SK + kk + tg * 4;
        const int8_t* p1 = p0 + 8 * SK;
        af[i][0] = *reinterpret_cast<const unsigned*>(p0);
        af[i][1] = *reinterpret_cast<const unsigned*>(p1);
        af[i][2] = *reinterpret_cast<const unsigned*>(p0 + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = warp_n * WN + j * 8 + g;
        const int8_t* p = bs + c * SK + kk + tg * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
    __syncthreads();  // the next iteration refills the stage just read
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * WM + i * 16 + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp_n * WN + j * 8 + tg * 2 + e;
          if (n < N) store_one(ep, m, n, N, acc[i][j][2 * h + e]);
        }
      }
    }
  }
}

// Launch on the largest tile that still gives the card about two waves of
// blocks; small or narrow problems take the 64 x 64 tile.
template <bool VEC, class ALoader>
cudaError_t launch_igemm(const ALoader& al, const int8_t* w, int M, int N,
                         int K, const Epilogue& ep, cudaStream_t stream) {
  const long big_tiles = static_cast<long>((M + 127) / 128) * ((N + 127) / 128);
  if (N >= 128 && big_tiles >= 264) {
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    igemm_kernel<128, 128, 2, 4, VEC, ALoader>
        <<<grid, 256, 0, stream>>>(al, w, M, N, K, ep);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    igemm_kernel<64, 64, 2, 2, VEC, ALoader>
        <<<grid, 128, 0, stream>>>(al, w, M, N, K, ep);
  }
  return cudaGetLastError();
}

}  // namespace qtpu
