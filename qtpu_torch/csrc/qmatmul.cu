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
// them bound by memory traffic at 3.35 TB/s, the narrow-K ones (K = 64, 256)
// clearly so.  The int32 accumulator never reaches device memory; the
// epilogue writes one byte per int8 output.
//
// Three kernels, chosen per call by the wrapper (ops/qmatmul.py: k1_path):
// * qtpu_qmatmul_fused runs wgmma_gemm.cuh: TMA loads into a ring of stages,
//   wgmma s8, a persistent grid and a coalesced, TMA-stored epilogue.  It
//   takes every operand TMA can address (16-byte aligned bases, rows of x,
//   w, the output and the residual multiples of 16 bytes): every 1x1 GEMM
//   of ResNet-50.
// * qtpu_qmatmul_fused_cp runs wgmma_narrow.cuh: the same consumers and
//   ring with 32-deep stages, tiles 8-144 columns wide, and each operand
//   by TMA where it can be, else by a producer warpgroup's cp.async (x, w)
//   or the consumers' stores (the output, the residual).  It takes rows of
//   4-byte multiples, and N below 64, from 512 rows: MobileNet-v2's K = 24
//   expand and N = 16 / 24 / 32 project GEMMs, config 3's QAT GEMMs.
// * qtpu_qmatmul_fused_igemm runs igemm.cuh's mma.sync loop (two cp.async
//   stages, one block per output tile, an element-wise epilogue), which
//   also takes any K (byte gathers), unaligned rows and requant grids off
//   the integers: the calls neither wgmma kernel takes (and a batch's
//   narrow fc, LeNet-5's fc2 / fc3, where it is the faster), and the
//   comparison.
//
// The int4 entries (qtpu_qmatmul_fused_w4, _w4_igemm) replace the same TPU
// kernel's w_packed=True mode (its in-VMEM unpack of pack_int4_halves,
// qmatmul.py:51).  w is int4 in [-7, 7], nibble-packed along K: (N, K/2)
// bytes, low nibble k even, high nibble k odd.  The packed bytes cross device
// memory (half the weight traffic of the int8 entry) and are sign-extended
// into int8 in shared memory (wgmma path) or at the mma fragment load
// (igemm.cuh: StagedB4).  Main loop, tiles and epilogue are the int8
// entry's, so both give the same codes.  No library multiplies int8 by int4.
#include "igemm.cuh"
#include "wgmma_narrow.cuh"

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

qtpu::Epilogue epilogue_of(const void* A, const void* B, const void* res,
                           int res_kind, void* out, int out_kind, float C,
                           float lo, float hi, float shift, int relu,
                           int use_act_max, float act_max) {
  return qtpu::make_epilogue(static_cast<const float*>(A),
                             static_cast<const float*>(B), res, res_kind,
                             out, out_kind, C, lo, hi, shift, relu,
                             use_act_max, act_max);
}

}  // namespace

#define K1_ARGS                                                            \
  const void *x, const void *w, const void *A, const void *B,             \
      const void *res, int res_kind, void *out, int out_kind, int M, int N, \
      int K, float C, float lo, float hi, float shift, int relu,            \
      int use_act_max, float act_max, void *stream
#define K1_EPILOGUE                                                       \
  epilogue_of(A, B, res, res_kind, out, out_kind, C, lo, hi, shift, relu, \
              use_act_max, act_max)

extern "C" int qtpu_qmatmul_fused(K1_ARGS) {
  return qtpu::wg::launch_gemm<false>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), M, N, K,
      K1_EPILOGUE, static_cast<cudaStream_t>(stream));
}

extern "C" int qtpu_qmatmul_fused_w4(K1_ARGS) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  return qtpu::wg::launch_gemm<true>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), M, N, K,
      K1_EPILOGUE, static_cast<cudaStream_t>(stream));
}

// The narrow-row kernel at the tile width narrow_bn gives N: rows of x, w,
// the output and the residual multiples of 4 bytes from 4-byte aligned
// bases.
extern "C" int qtpu_qmatmul_fused_cp(K1_ARGS) {
  using qtpu::wg::launch_narrow_bn;
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const qtpu::Epilogue ep = K1_EPILOGUE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (qtpu::wg::narrow_bn(N)) {
    case 8: e = launch_narrow_bn<8>(xs, ws, M, N, K, ep, s); break;
    case 16: e = launch_narrow_bn<16>(xs, ws, M, N, K, ep, s); break;
    case 24: e = launch_narrow_bn<24>(xs, ws, M, N, K, ep, s); break;
    case 32: e = launch_narrow_bn<32>(xs, ws, M, N, K, ep, s); break;
    case 48: e = launch_narrow_bn<48>(xs, ws, M, N, K, ep, s); break;
    case 64: e = launch_narrow_bn<64>(xs, ws, M, N, K, ep, s); break;
    case 96: e = launch_narrow_bn<96>(xs, ws, M, N, K, ep, s); break;
    default: e = launch_narrow_bn<144>(xs, ws, M, N, K, ep, s); break;
  }
  return static_cast<int>(e);
}

extern "C" int qtpu_qmatmul_fused_igemm(K1_ARGS) {
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  GemmLoader al{xs, K};
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return qtpu::launch_igemm<true>(al, ws, M, N, K, K1_EPILOGUE, s);
  return qtpu::launch_igemm<false>(al, ws, M, N, K, K1_EPILOGUE, s);
}

extern "C" int qtpu_qmatmul_fused_w4_igemm(K1_ARGS) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  GemmLoader al{xs, K};
  // 16-byte copies of x need K % 16, of the packed rows (K/2) % 16
  const bool vec = K % 32 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return qtpu::launch_igemm<true, GemmLoader, true>(al, ws, M, N, K,
                                                      K1_EPILOGUE, s);
  return qtpu::launch_igemm<false, GemmLoader, true>(al, ws, M, N, K,
                                                     K1_EPILOGUE, s);
}

#ifdef QTPU_IGEMM_PROBE
// Probe build only: where igemm_kernel writes its clock64 stamps.
extern "C" int qtpu_probe_set_stamps(void* stamps) {
  return static_cast<int>(cudaMemcpyToSymbol(qtpu::qtpu_probe_stamps, &stamps,
                                             sizeof(stamps)));
}
#endif

#ifdef QTPU_WGMMA_PROBE
// Probe build only: where wgmma_gemm_kernel writes its cycles by phase.
extern "C" int qtpu_wgmma_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qtpu::wg::qtpu_wgmma_probe, &buf, sizeof(buf)));
}
#endif
