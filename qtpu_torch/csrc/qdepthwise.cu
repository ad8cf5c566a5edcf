// K3: fused int8 depthwise convolution (stride 1 or 2), for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qdepthwise.py:qdepthwise_fused,
// generalized from stride 1 on a prepadded image to stride 1 or 2 with the
// padding taken into the address computation:
//   out[b, oh, ow, c] = epilogue_c(sum_{kh, kw} x[b, oh*s + kh - pt,
//                                                ow*s + kw - pl, c] * w[kh, kw, c])
// where a tap outside the image reads the activation zero point, which is
// what the reference computes on its zero-point-padded input.  The input is
// int8 NHWC (B, H, W, C), unpadded: no padded copy of the activation is
// written.  The weight is int8 tap-major (KH*KW, C), prepared once at engine
// build.  The epilogue is epilogue.cuh's (requant to int8 codes, f32 with
// relu / act_max, or the raw int32 accumulator), bit-identical to K1/K2.
//
// What bounds it on the H100: there is no reduction over channels, so no
// tensor-core work; per output element it does 2 * KH * KW integer
// operations on CUDA cores against one input byte read (counted once) and
// one output byte written, far below the card's operations-per-byte
// balance: it is memory-bound, (B*H*W*C + B*OH*OW*C*out_bytes + KH*KW*C +
// 8*C) bytes at 3.35 TB/s.  The design keeps each load and store 16 bytes
// wide: one thread computes one output pixel x 16 channels with nine
// 16-byte loads of x (or the zero-point fill), nine 16-byte loads of the
// weight, 16 int32 accumulators in registers and one 16-byte store of codes;
// neighbouring threads take neighbouring channel chunks of one pixel, so a
// warp's loads are contiguous.  The overlapping windows of a stride-1 conv
// are re-read from L1/L2, not from device memory.  A scalar path (one thread
// per output element) covers C % 16 != 0 and misaligned pointers.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;

struct DwShape {
  int B, H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l;
};

// Byte r (0..3) of w, sign-extended.
__device__ __forceinline__ int sbyte(unsigned w, int r) {
  return static_cast<int>(w << (24 - 8 * r)) >> 24;
}

__global__ void __launch_bounds__(THREADS)
    dw_vec_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  DwShape s, int zp, qtpu::Epilogue ep) {
  const int chunks = s.C >> 4;
  const long long total = static_cast<long long>(s.B) * s.OH * s.OW * chunks;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= total) return;
  const int c0 = static_cast<int>(i % chunks) << 4;
  const long long pix = i / chunks;  // (b * OH + oh) * OW + ow
  const int ow = static_cast<int>(pix % s.OW);
  const int oh = static_cast<int>((pix / s.OW) % s.OH);
  const int b = static_cast<int>(pix / (static_cast<long long>(s.OW) * s.OH));

  const unsigned zw = (static_cast<unsigned>(zp) & 0xffu) * 0x01010101u;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;

  for (int kh = 0; kh < s.KH; ++kh) {
    const int ih = oh * s.stride + kh - s.pad_t;
    const bool row_ok = ih >= 0 && ih < s.H;
    for (int kw = 0; kw < s.KW; ++kw) {
      const int iw = ow * s.stride + kw - s.pad_l;
      uint4 xv = make_uint4(zw, zw, zw, zw);
      if (row_ok && iw >= 0 && iw < s.W) {
        xv = __ldg(reinterpret_cast<const uint4*>(
            x + ((static_cast<size_t>(b) * s.H + ih) * s.W + iw) * s.C + c0));
      }
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(
          w + static_cast<size_t>(kh * s.KW + kw) * s.C + c0));
      const unsigned xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const unsigned ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[4 * q + r] += sbyte(xs[q], r) * sbyte(ws[q], r);
    }
  }

  const size_t o = static_cast<size_t>(pix) * s.C + c0;
  if (ep.out_kind == qtpu::OUT_I32) {
    int4* dst = reinterpret_cast<int4*>(static_cast<int*>(ep.out) + o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
    return;
  }
  float a[16], bb[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 av = __ldg(reinterpret_cast<const float4*>(ep.A + c0) + q);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(ep.B + c0) + q);
    a[4 * q] = av.x;
    a[4 * q + 1] = av.y;
    a[4 * q + 2] = av.z;
    a[4 * q + 3] = av.w;
    bb[4 * q] = bv.x;
    bb[4 * q + 1] = bv.y;
    bb[4 * q + 2] = bv.z;
    bb[4 * q + 3] = bv.w;
  }
  if (ep.out_kind == qtpu::OUT_I8) {
    unsigned packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int8_t code = qtpu::ep_code(ep, qtpu::ep_affine(acc[j], a[j], bb[j]));
      packed[j >> 2] |= (static_cast<unsigned>(static_cast<uint8_t>(code)))
                        << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(ep.out) + o) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    return;
  }
  float4* dst = reinterpret_cast<float4*>(static_cast<float*>(ep.out) + o);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      t[r] = qtpu::ep_f32(ep, qtpu::ep_affine(acc[4 * q + r], a[4 * q + r],
                                              bb[4 * q + r]));
    dst[q] = make_float4(t[0], t[1], t[2], t[3]);
  }
}

__global__ void __launch_bounds__(THREADS)
    dw_scalar_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, DwShape s, int zp,
                     qtpu::Epilogue ep) {
  const long long total = static_cast<long long>(s.B) * s.OH * s.OW * s.C;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % s.C);
  const long long pix = i / s.C;
  const int ow = static_cast<int>(pix % s.OW);
  const int oh = static_cast<int>((pix / s.OW) % s.OH);
  const int b = static_cast<int>(pix / (static_cast<long long>(s.OW) * s.OH));
  int acc = 0;
  for (int kh = 0; kh < s.KH; ++kh) {
    const int ih = oh * s.stride + kh - s.pad_t;
    const bool row_ok = ih >= 0 && ih < s.H;
    for (int kw = 0; kw < s.KW; ++kw) {
      const int iw = ow * s.stride + kw - s.pad_l;
      const int xv = (row_ok && iw >= 0 && iw < s.W)
                         ? x[((static_cast<size_t>(b) * s.H + ih) * s.W + iw) *
                                 s.C + c]
                         : zp;
      acc += xv * w[(kh * s.KW + kw) * s.C + c];
    }
  }
  if (ep.out_kind == qtpu::OUT_I32) {
    static_cast<int*>(ep.out)[i] = acc;
    return;
  }
  const float t = qtpu::ep_affine(acc, ep.A[c], ep.B[c]);
  if (ep.out_kind == qtpu::OUT_I8)
    static_cast<int8_t*>(ep.out)[i] = qtpu::ep_code(ep, t);
  else
    static_cast<float*>(ep.out)[i] = qtpu::ep_f32(ep, t);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int qtpu_qdepthwise_fused(
    const void* x, const void* w, const void* A, const void* B, void* out,
    int out_kind, int Bn, int H, int W, int C, int OH, int OW, int KH, int KW,
    int stride, int pad_t, int pad_l, int zp, float lo, float hi, float shift,
    int relu, int use_act_max, float act_max, void* stream) {
  const qtpu::Epilogue ep = qtpu::make_epilogue(
      static_cast<const float*>(A), static_cast<const float*>(B), nullptr,
      qtpu::RES_NONE, out, out_kind, 0.0f, lo, hi, shift, relu, use_act_max,
      act_max);
  const DwShape s{Bn, H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l};
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 16 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out) && aligned16(A) && aligned16(B);
  const long long items =
      static_cast<long long>(Bn) * OH * OW * (vec ? C / 16 : C);
  if (items == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((items + THREADS - 1) / THREADS);
  if (vec)
    dw_vec_kernel<<<blocks, THREADS, 0, st>>>(xs, ws, s, zp, ep);
  else
    dw_scalar_kernel<<<blocks, THREADS, 0, st>>>(xs, ws, s, zp, ep);
  return static_cast<int>(cudaGetLastError());
}
