// K3: fused int8 depthwise convolution (stride 1 or 2), for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qdepthwise.py:qdepthwise_fused,
// generalized from stride 1 on a prepadded image to stride 1 or 2 with the
// padding taken into the address computation:
//   out[b, oh, ow, c] = epilogue_c(sum_{kh, kw} x[b, oh*s + kh - pt,
//                                                ow*s + kw - pl, c] * w[kh, kw, c])
// where a tap outside the image reads the activation zero point, which is
// what the reference computes on its zero-point-padded input.  The entries
// take the pad code as zp or, where the nullable zp_dev is given, as the
// int32 it points to in device memory (the QAT step's, computed on the
// card: no host reads it); each thread loads it once.  The input is
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
// 8*C) bytes at 3.35 TB/s.  Two kernels, chosen per call by
// ops/qdepthwise.py's k3_plan from the shapes (a counted dispatch):
//
// * dw_halo_kernel (3x3, C % 16 == 0, 16-byte aligned operands): a block
//   takes (image, band of TH output rows, chunk of Cc channels) and stages
//   the band's input rows plus halo, ((TH-1)*s + 3) x ((OW-1)*s + 3) x Cc
//   bytes, into shared memory once with 16-byte cp.async copies, zp written
//   at the pads.  A thread takes one output column and four channels, holds
//   the chunk's nine taps (sign-extended) and A/B in registers, and slides
//   the 3x3 window down its column: at stride 1 it loads three new 4-byte
//   words per output row instead of nine, at stride 2 six.  The requant is
//   the conversion-free code_bits (epilogue.cuh) on integer grids.  The
//   host plan takes whole small maps with fewer channels per block (7x7,
//   C = 960: enough blocks for the 132 SMs) and bands of large ones.
// * dw_scalar_kernel: one thread per output element, for the rest (C % 16
//   != 0, other kernel sizes, misaligned pointers).
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "igemm.cuh"  // cp_async16

namespace {

constexpr int THREADS = 256;

struct DwShape {
  int B, H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l;
};

using qtpu::sbyte;

// The halo kernel (see above).  S: the stride; the kernel is 3x3.
template <int S>
__global__ void __launch_bounds__(THREADS)
    dw_halo_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   DwShape s, int zp, const int* __restrict__ zp_dev, int TH,
                   int Cc, int code_fast, qtpu::Epilogue ep) {
  if (zp_dev) zp = __ldg(zp_dev);  // the pad code from device memory
  extern __shared__ __align__(16) uint8_t tile[];  // rows x Wt x Cc bytes
  const int tid = threadIdx.x;
  const int nchunks = s.C / Cc, bands = (s.OH + TH - 1) / TH;
  const int chunk = blockIdx.x % nchunks;
  const int band = (blockIdx.x / nchunks) % bands;
  const int b = blockIdx.x / (nchunks * bands);
  const int c0 = chunk * Cc, oh0 = band * TH;
  const int rows = s.OH - oh0 < TH ? s.OH - oh0 : TH;
  const int R = (rows - 1) * S + 3, Wt = (s.OW - 1) * S + 3;
  const int ih0 = oh0 * S - s.pad_t, cpp = Cc / 16;
  const unsigned zw = (static_cast<unsigned>(zp) & 0xffu) * 0x01010101u;
  // each thread copies the same (column, chunk) pairs of every staged row
  for (int j = tid; j < Wt * cpp; j += blockDim.x) {
    const int col = j / cpp, q = j - col * cpp;
    const int iw = col - s.pad_l;
    const bool col_in = iw >= 0 && iw < s.W;
    // (read only where the pixel lies in the image)
    const int8_t* src =
        x + ((static_cast<long long>(b) * s.H + ih0) * s.W + iw) * s.C + c0 +
        16 * q;
    uint8_t* dst = tile + col * Cc + 16 * q;
    for (int r = 0; r < R; ++r) {
      const int ih = ih0 + r;
      if (col_in && ih >= 0 && ih < s.H)
        qtpu::cp_async16(dst, src, true);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(zw, zw, zw, zw);
      src += static_cast<size_t>(s.W) * s.C;
      dst += Wt * Cc;
    }
  }
  qtpu::cp_async_wait_all();
  __syncthreads();

  const int nq = Cc / 4;
  const unsigned flip = ep.shift != 0.f ? 0x80808080u : 0u;
  for (int task = tid; task < s.OW * nq; task += blockDim.x) {
    const int cq = task % nq, ow = task / nq, c = c0 + 4 * cq;
    int wt[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned v =
          __ldg(reinterpret_cast<const unsigned*>(w + tap * s.C + c));
#pragma unroll
      for (int e = 0; e < 4; ++e) wt[tap][e] = sbyte(v, e);
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bb = a;
    if (ep.out_kind != qtpu::OUT_I32) {
      a = __ldg(reinterpret_cast<const float4*>(ep.A + c));
      bb = __ldg(reinterpret_cast<const float4*>(ep.B + c));
    }
    const uint8_t* col = tile + ow * S * Cc + 4 * cq;
    const int rstride = Wt * Cc;
    auto row = [&](int r, unsigned (&v)[3]) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        v[dc] = *reinterpret_cast<const unsigned*>(col + r * rstride +
                                                   dc * Cc);
    };
    // output row i of the band from window rows r0, r1, r2 (four channels
    // a word)
    auto emit = [&](const unsigned (&r0)[3], const unsigned (&r1)[3],
                    const unsigned (&r2)[3], int i) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] += sbyte(r0[kw], e) * wt[kw][e] +
                    sbyte(r1[kw], e) * wt[3 + kw][e] +
                    sbyte(r2[kw], e) * wt[6 + kw][e];
      const size_t o =
          ((static_cast<size_t>(b) * s.OH + oh0 + i) * s.OW + ow) * s.C + c;
      if (ep.out_kind == qtpu::OUT_I32) {
        *reinterpret_cast<int4*>(static_cast<int*>(ep.out) + o) =
            make_int4(acc[0], acc[1], acc[2], acc[3]);
        return;
      }
      const float t[4] = {qtpu::ep_affine(acc[0], a.x, bb.x),
                          qtpu::ep_affine(acc[1], a.y, bb.y),
                          qtpu::ep_affine(acc[2], a.z, bb.z),
                          qtpu::ep_affine(acc[3], a.w, bb.w)};
      if (ep.out_kind == qtpu::OUT_F32) {
        *reinterpret_cast<float4*>(static_cast<float*>(ep.out) + o) =
            make_float4(qtpu::ep_f32(ep, t[0]), qtpu::ep_f32(ep, t[1]),
                        qtpu::ep_f32(ep, t[2]), qtpu::ep_f32(ep, t[3]));
        return;
      }
      unsigned codes;
      if (code_fast) {
        codes = __byte_perm(
                    __byte_perm(qtpu::code_bits(ep, t[0]),
                                qtpu::code_bits(ep, t[1]), 0x0040),
                    __byte_perm(qtpu::code_bits(ep, t[2]),
                                qtpu::code_bits(ep, t[3]), 0x0040),
                    0x5410) ^
                flip;
      } else {
        codes = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          codes |= static_cast<unsigned>(
                       static_cast<uint8_t>(qtpu::ep_code(ep, t[e])))
                   << (8 * e);
      }
      *reinterpret_cast<unsigned*>(static_cast<int8_t*>(ep.out) + o) = codes;
    };
    // slide down the column; the window rows rotate through named buffers
    // (no copies): at stride 1 one new row an output row, at stride 2 two
    unsigned ra[3], rb[3], rc[3];
    row(0, ra);
    if (S == 1) {
      row(1, rb);
      for (int i = 0; i < rows; i += 3) {
        row(i + 2, rc);
        emit(ra, rb, rc, i);
        if (i + 1 >= rows) break;
        row(i + 3, ra);
        emit(rb, rc, ra, i + 1);
        if (i + 2 >= rows) break;
        row(i + 4, rb);
        emit(rc, ra, rb, i + 2);
      }
    } else {
      for (int i = 0; i < rows; i += 2) {
        row(2 * i + 1, rb);
        row(2 * i + 2, rc);
        emit(ra, rb, rc, i);
        if (i + 1 >= rows) break;
        row(2 * i + 3, rb);
        row(2 * i + 4, ra);
        emit(rc, rb, ra, i + 1);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    dw_scalar_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, DwShape s, int zp,
                     const int* __restrict__ zp_dev, qtpu::Epilogue ep) {
  if (zp_dev) zp = __ldg(zp_dev);
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

#define K3_ARGS                                                              \
  const void *x, const void *w, const void *A, const void *B, void *out,     \
      int out_kind, int Bn, int H, int W, int C, int OH, int OW, int KH,     \
      int KW, int stride, int pad_t, int pad_l, int zp, const void *zp_dev,  \
      float lo, float hi, float shift, int relu, int use_act_max,            \
      float act_max, int TH, int Cc, int threads, void *stream
#define K3_EPILOGUE                                                        \
  qtpu::make_epilogue(static_cast<const float*>(A),                        \
                      static_cast<const float*>(B), nullptr, qtpu::RES_NONE, \
                      out, out_kind, 0.0f, lo, hi, shift, relu, use_act_max, \
                      act_max)

// The halo kernel with the host plan's TH output rows and Cc channels a
// block, `threads` threads: 3x3, stride 1 or 2, C % Cc == 0, Cc % 16 == 0,
// the operands 16-byte aligned, the staged tile within 48 KB.
extern "C" int qtpu_qdepthwise_fused(K3_ARGS) {
  const qtpu::Epilogue ep = K3_EPILOGUE;
  const DwShape s{Bn, H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l};
  const long smem = static_cast<long>((TH - 1) * stride + 3) *
                    ((OW - 1) * stride + 3) * Cc;
  if (KH != 3 || KW != 3 || (stride != 1 && stride != 2) || TH < 1 ||
      Cc < 16 || Cc % 16 || C % Cc || smem > 48 * 1024 || threads < 32 ||
      threads > THREADS || threads % 32 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || !aligned16(A) || !aligned16(B))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(Bn) * ((OH + TH - 1) / TH) * (C / Cc);
  if (blocks == 0) return 0;
  const int fast = ep.out_kind == qtpu::OUT_I8 && qtpu::int_grid(ep);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int* zd = static_cast<const int*>(zp_dev);
  if (stride == 1)
    dw_halo_kernel<1><<<grid, threads, smem, st>>>(xs, ws, s, zp, zd, TH, Cc,
                                                    fast, ep);
  else
    dw_halo_kernel<2><<<grid, threads, smem, st>>>(xs, ws, s, zp, zd, TH, Cc,
                                                    fast, ep);
  return static_cast<int>(cudaGetLastError());
}

// One thread per output element: any kernel size, C and alignment (the
// plan's TH, Cc and threads are not read).
extern "C" int qtpu_qdepthwise_fused_scalar(K3_ARGS) {
  const qtpu::Epilogue ep = K3_EPILOGUE;
  const DwShape s{Bn, H, W, C, OH, OW, KH, KW, stride, pad_t, pad_l};
  const long long items = static_cast<long long>(Bn) * OH * OW * C;
  if (items == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((items + THREADS - 1) / THREADS);
  dw_scalar_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), s, zp,
      static_cast<const int*>(zp_dev), ep);
  return static_cast<int>(cudaGetLastError());
}
