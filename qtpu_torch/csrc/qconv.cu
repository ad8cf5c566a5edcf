// K2: fused int8 convolution (implicit GEMM, stride 1 or 2), for sm_90a.
//
// Replaces the TPU kernels qtpu/ops/pallas/qconv.py:qconv2d_fused and, at
// stride 2, qtpu/ops/pallas/qconv_dispatch.py:qconv2d_strided.  The input is
// int8 NHWC (B, Hp, Wp, Ci), already padded with the activation zero point by
// the wrapper; the weight is int8 (Co, KH, KW, Ci), stored so once at engine
// build.  Output pixel m = (b, oh, ow) and reduction index k = (kh, kw, ci)
// make the conv a GEMM with
//   A[m, k] = x[b, oh*s + kh, ow*s + kw, ci]
// which the loader below gathers straight from the padded image: no im2col
// buffer is written.  On the TPU the strided conv was split into four
// stride-1 phase convs (a Mosaic limit); here the stride is an address
// computation and yields the same int32 accumulator in one launch.  The
// epilogue modes are those of K1 (igemm.cuh): requant to int8 codes, f32 with
// relu / act_max, an optional int8 or f32 residual (B, OH, OW, Co), or the
// raw int32 accumulator.
//
// What bounds it on the H100: a 3x3 conv reads each input byte up to nine
// times but only from L2 and shared memory; counted once, a ResNet-50 3x3 at
// 64..512 channels does 2*9*Ci operations per output element, which puts the
// wide ones near the int8 tensor-core peak and the 64-channel ones on the
// memory side.  The design streams 16-byte tap chunks (Ci % 16 == 0) into
// shared memory with cp.async and accumulates in registers; the int32 sum
// never reaches device memory.
#include "igemm.cuh"

namespace {

struct ConvLoader {
  const int8_t* x;
  int Hp, Wp, Ci, KW, OH, OW, stride;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    const int ow = m % OW;
    const int t = m / OW;
    const int oh = t % OH;
    const int b = t / OH;
    return x + ((static_cast<size_t>(b) * Hp + oh * stride) * Wp +
                ow * stride) * Ci;
  }
  __device__ __forceinline__ const int8_t* ptr(Row r, int k) const {
    const int tap = k / Ci;
    const int ci = k - tap * Ci;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    return r + (static_cast<size_t>(kh) * Wp + kw) * Ci + ci;
  }
  __device__ __forceinline__ const int8_t* base() const { return x; }
};

}  // namespace

extern "C" int qtpu_qconv2d_fused(const void* x, const void* w, const void* A,
                                  const void* B, const void* res, int res_kind,
                                  void* out, int out_kind, int Bn, int Hp,
                                  int Wp, int Ci, int Co, int KH, int KW,
                                  int stride, float C, float lo, float hi,
                                  float shift, int relu, int use_act_max,
                                  float act_max, void* stream) {
  const int OH = (Hp - KH) / stride + 1;
  const int OW = (Wp - KW) / stride + 1;
  const int M = Bn * OH * OW;
  const int K = KH * KW * Ci;
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  qtpu::Epilogue ep = qtpu::make_epilogue(
      static_cast<const float*>(A), static_cast<const float*>(B), res,
      res_kind, out, out_kind, C, lo, hi, shift, relu, use_act_max, act_max);
  ConvLoader al{xs, Hp, Wp, Ci, KW, OH, OW, stride};
  const bool vec = Ci % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return qtpu::launch_igemm<true>(al, ws, M, Co, K, ep, s);
  return qtpu::launch_igemm<false>(al, ws, M, Co, K, ep, s);
}
