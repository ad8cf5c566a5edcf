// The folded requant epilogue shared by the int8 kernels (K1 qmatmul.cu,
// K2 qconv.cu, K3 qdepthwise.cu, K4 qproj.cu, K5 qtail.cu, K6 qblock.cu).
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
