// K1: fused int8 matmul with the folded requant epilogue, for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qmatmul.py:qmatmul_fused.  Computes
//   out[m, n] = epilogue(sum_k x[m, k] * w[n, k])
// with x int8 (M, K) row-major, w int8 (N, K) K-contiguous (stored so once at
// engine build), an int32 accumulator, and the epilogue in registers: requant
// to int8 codes, f32 out with relu / act_max, an optional int8 or f32 residual
// (M, N), or the raw int32 accumulator (the fc, whose exact dequant runs after).
//
// What bounds it on the H100: the 1x1 convs of ResNet-50 have K = 64..2048, so
// at the 1,979 TOP/s int8 tensor-core peak their arithmetic intensity (2K
// operations per output byte, fewer per input byte when K is small) leaves
// most of them bound by memory traffic at 3.35 TB/s, the narrow-K ones
// (K = 64, 256) clearly so.  The design keeps every intermediate in registers:
// the int32 accumulator never reaches device memory, and the epilogue writes
// one byte per int8 output.  This first version uses mma.sync with a two-stage
// cp.async pipeline; wgmma and TMA are later work (ROADMAP.md).
//
// The int4 entry (qtpu_qmatmul_fused_w4) replaces the same TPU kernel's
// w_packed=True mode (its in-VMEM unpack of pack_int4_halves, qmatmul.py:51).
// w is int4 in [-7, 7], nibble-packed along K: (N, K/2) bytes, low nibble
// k even, high nibble k odd.  The packed bytes cross device and shared memory
// (half the weight traffic of the int8 entry, which is what bounds the
// weight-heavy GEMMs at a small batch: ResNet-50's layer4 at B = 8) and are
// sign-extended into the mma's int8 registers at the fragment load
// (igemm.cuh: StagedB4).  The main loop, tiles and epilogue are the int8
// entry's, so both give the same codes.  No library multiplies int8 by int4.
#include "igemm.cuh"

namespace {

struct GemmLoader {
  const int8_t* x;
  int K;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    return x + static_cast<size_t>(m) * K;
  }
  __device__ __forceinline__ const int8_t* ptr(Row r, int k) const {
    return r + k;
  }
  __device__ __forceinline__ const int8_t* base() const { return x; }
};

}  // namespace

extern "C" int qtpu_qmatmul_fused(const void* x, const void* w, const void* A,
                                  const void* B, const void* res, int res_kind,
                                  void* out, int out_kind, int M, int N, int K,
                                  float C, float lo, float hi, float shift,
                                  int relu, int use_act_max, float act_max,
                                  void* stream) {
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  qtpu::Epilogue ep = qtpu::make_epilogue(
      static_cast<const float*>(A), static_cast<const float*>(B), res,
      res_kind, out, out_kind, C, lo, hi, shift, relu, use_act_max, act_max);
  GemmLoader al{xs, K};
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return qtpu::launch_igemm<true>(al, ws, M, N, K, ep, s);
  return qtpu::launch_igemm<false>(al, ws, M, N, K, ep, s);
}

extern "C" int qtpu_qmatmul_fused_w4(const void* x, const void* w4,
                                     const void* A, const void* B,
                                     const void* res, int res_kind, void* out,
                                     int out_kind, int M, int N, int K,
                                     float C, float lo, float hi, float shift,
                                     int relu, int use_act_max, float act_max,
                                     void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w4);
  qtpu::Epilogue ep = qtpu::make_epilogue(
      static_cast<const float*>(A), static_cast<const float*>(B), res,
      res_kind, out, out_kind, C, lo, hi, shift, relu, use_act_max, act_max);
  GemmLoader al{xs, K};
  // 16-byte copies of x need K % 16, of the packed rows (K/2) % 16
  const bool vec = K % 32 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return qtpu::launch_igemm<true, GemmLoader, true>(al, ws, M, N, K,
                                                             ep, s);
  return qtpu::launch_igemm<false, GemmLoader, true>(al, ws, M, N, K, ep, s);
}
