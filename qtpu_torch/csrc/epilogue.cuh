// The folded requant epilogue shared by the int8 kernels (K1 qmatmul.cu,
// K2 qconv.cu, K3 qdepthwise.cu, K4 qproj.cu, K5 qtail.cu, K6 qblock.cu,
// K7/K8 qstage.cu, K9 qivr.cu).
//
// On an int32 accumulator it computes, per output channel n,
//   t = acc * A[n] + B[n]  (+ r * C for a residual r)
// and then either int8 codes clip(round(t), lo, hi) - shift (requant) or f32
// t with optional relu and act_max.  It reproduces
// qtpu.ops.qops.apply_epilogue bit for bit: each multiply and add is rounded
// on its own (__fmul_rn / __fadd_rn: no contraction into FMA, which would
// move codes at ties), and rounding is half to even (rintf), as jnp.round.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qtpu {

// Output kinds and residual kinds, shared with the Python wrappers.
enum OutKind { OUT_I8 = 0, OUT_F32 = 1, OUT_I32 = 2 };
enum ResKind { RES_NONE = 0, RES_I8 = 1, RES_F32 = 2 };

struct Epilogue {
  const float* A;    // (N,) folded scale
  const float* B;    // (N,) folded offset
  const void* res;   // (M, N) int8 codes or f32, or null
  void* out;         // (M, N) int8 / f32 / int32
  int res_kind;
  int out_kind;
  float C, lo, hi, shift;
  int relu;
  int use_act_max;
  float act_max;
};

// Byte r (0..3) of w, sign-extended (one permute: the selector's high bit
// replicates the byte's sign).  K3's and K9's depthwise taps.
__device__ __forceinline__ int sbyte(unsigned w, int r) {
  int v;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(v)
      : "r"(w), "r"(r | (0x888 | r * 0x111) << 4));
  return v;
}

// acc * a + b, two roundings.
__device__ __forceinline__ float ep_affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

// requant mode: the int8 code clip(round(t), lo, hi) - shift.
__device__ __forceinline__ int8_t ep_code(float t, float lo, float hi,
                                          float shift) {
  float q = fminf(fmaxf(rintf(t), lo), hi);
  q = __fsub_rn(q, shift);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ int8_t ep_code(const Epilogue& ep, float t) {
  return ep_code(t, ep.lo, ep.hi, ep.shift);
}

// ---- the requant without conversion instructions --------------------------
//
// Conversions (I2F, F2I, FRND) are slow instructions (16 a clock on an SM
// in the CUDA guide's table, against 128 float adds); ep_code spends three
// per element (rintf, the int8 residual's I2F, F2I).  The same values come
// from adds on the float's bits: 1.5 * 2^23 + v holds the integer v
// (|v| < 2^22) in its low mantissa bits, and adding 1.5 * 2^23 to a float
// rounds it to an integer half to even, as rintf does.  K1's and K2's wgmma
// epilogue, K2's stem kernel and K3's halo kernel use them.

constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
constexpr unsigned MAGIC_BITS = 0x4B400000u;

// Two int8 residual codes (a 16-bit pair) as floats, exactly: each byte
// offset by 128 (r ^ 0x80) under the upper bytes of 1.5 * 2^23, less
// 1.5 * 2^23 + 128.
__device__ __forceinline__ float2 residual_pair(unsigned pair) {
  const unsigned u = pair ^ 0x8080u;
  return make_float2(
      __fsub_rn(__uint_as_float(__byte_perm(u, MAGIC_BITS, 0x7650)),
                MAGIC + 128.0f),
      __fsub_rn(__uint_as_float(__byte_perm(u, MAGIC_BITS, 0x7651)),
                MAGIC + 128.0f));
}

// ep_code for integer grids: lo and hi integers below 2^21 in magnitude,
// shift 0 or 128 (int_grid() below; the host sends other grids elsewhere).
// Clipping to integer bounds commutes with rounding to an integer, so
// clip(rint(t), lo, hi) - shift = round(clip(t, lo, hi)) - shift; the low
// byte of clip(t) + 1.5 * 2^23 is round(clip(t)) mod 256, and subtracting 0
// or 128 mod 256 is an XOR with 0 or 0x80.  The int8 code is the low byte
// of code_bits(t) ^ (shift ? 0x80 : 0).
__device__ __forceinline__ unsigned code_bits(const Epilogue& ep, float t) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(t, ep.lo), ep.hi), MAGIC));
}

// The epilogue of two accumulators of a row, columns c and c + 1 (their A,
// B coefficients a, b): ep_affine, then with RES the residual pair q
// weighted by ep.C.  Every wgmma epilogue (K1's epilogue_slab, K5's and the
// chained runner's fill_slab, the runner's narrow rows) takes t from here.
template <bool RES>
__device__ __forceinline__ float2 ep_pair(const Epilogue& ep, int v0, int v1,
                                          float2 a, float2 b, float2 q) {
  float t0 = ep_affine(v0, a.x, b.x);
  float t1 = ep_affine(v1, a.y, b.y);
  if (RES) {
    t0 = __fadd_rn(t0, __fmul_rn(q.x, ep.C));
    t1 = __fadd_rn(t1, __fmul_rn(q.y, ep.C));
  }
  return make_float2(t0, t1);
}

// The int8 codes of an ep_pair on an integer grid, the low 16 bits in
// column order; flip is 0x8080 where the shift is 128, else 0.
__device__ __forceinline__ unsigned short code_pair(const Epilogue& ep,
                                                    float2 t,
                                                    unsigned flip) {
  return static_cast<unsigned short>(
      __byte_perm(code_bits(ep, t.x), code_bits(ep, t.y), 0x0040) ^ flip);
}

// Whether code_bits serves this epilogue's grid (host side).
inline bool int_grid(const Epilogue& ep) {
  auto small_int = [](float v) {
    return v >= -2097152.f && v <= 2097152.f &&
           v == static_cast<float>(static_cast<int>(v));
  };
  return small_int(ep.lo) && small_int(ep.hi) &&
         (ep.shift == 0.f || ep.shift == 128.f);
}

// f32 mode: relu and act_max on t.
__device__ __forceinline__ float ep_f32(const Epilogue& ep, float t) {
  if (ep.relu) t = fmaxf(t, 0.0f);
  if (ep.use_act_max) t = fminf(t, ep.act_max);
  return t;
}

inline Epilogue make_epilogue(const float* A, const float* B, const void* res,
                              int res_kind, void* out, int out_kind, float C,
                              float lo, float hi, float shift, int relu,
                              int use_act_max, float act_max) {
  Epilogue ep;
  ep.A = A;
  ep.B = B;
  ep.res = res;
  ep.out = out;
  ep.res_kind = res_kind;
  ep.out_kind = out_kind;
  ep.C = C;
  ep.lo = lo;
  ep.hi = hi;
  ep.shift = shift;
  ep.relu = relu;
  ep.use_act_max = use_act_max;
  ep.act_max = act_max;
  return ep;
}

}  // namespace qtpu
