// K4: fused projection-block tail (conv3 + downsample), for sm_90a.
//
// Replaces the TPU kernels qtpu/ops/pallas/qproj.py:qproj_fused and
// qproj2d_fused.  A ResNet projection block ends in
//   td  = acc_d * Ad + Bd                 (downsample x_d . wd, dequantized)
//   out = clip(rint(acc_3 * A3 + B3 + td * C), lo, hi) - shift
// with acc_3 = b . w3 (conv3 on conv2's codes b) and x_d the block input
// x at the block's stride.  Unfused, the port runs K1 twice and writes td to
// device memory as f32 (four bytes per element) for conv3's epilogue to read
// back.  Here one block owns a BM x BN output tile: it runs the downsample
// GEMM, turns its accumulator into f32 td in registers (ep_affine, exactly
// the f32 K1 writes), runs the conv3 GEMM into a fresh accumulator, and adds
// td through the f32-residual step of K1's epilogue (t + td * C, each step
// rounded on its own) — so the codes are bit-identical to that K1 pair.  The
// stride is an address computation on x, so no strided copy is made.
//
// What bounds it on the H100: two 1x1 GEMMs with K = Cmid + Cin = 128..2048
// per output byte; counted once, the inputs b and x_d and the int8 output
// make it memory-bound at ResNet-50's shapes, and the fusion removes the f32
// round trip (8 bytes per output element) that the unfused pair pays.  Two
// accumulator sets live in registers (ptxas reports any spill).
#include "igemm.cuh"

namespace {

// conv3's A rows: b (M, K) row-major.
struct MidRows {
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

// The downsample's A rows: output pixel m = (b, oh, ow) reads the block
// input x[b, oh * stride, ow * stride, :].
struct StridedRows {
  const int8_t* x;
  int Hx, Wx, C, H, W, stride;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    const int ow = m % W;
    const int t = m / W;
    const int oh = t % H;
    const int b = t / H;
    return x + ((static_cast<size_t>(b) * Hx + oh * stride) * Wx +
                ow * stride) * C;
  }
  __device__ __forceinline__ const int8_t* ptr(Row r, int k) const {
    return r + k;
  }
  __device__ __forceinline__ const int8_t* base() const { return x; }
};

struct ProjArgs {
  const float *A3, *B3, *Ad, *Bd;
  float C, lo, hi, shift;
  int8_t* out;  // (M, N)
};

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    qproj_kernel(MidRows bl, StridedRows xl, const int8_t* __restrict__ w3,
                 const int8_t* __restrict__ wd, int M, int N, int Kmid,
                 int Kin, ProjArgs p) {
  typedef qtpu::TileCfg<BM, BN, WARPS_M, WARPS_N> T;
  __shared__ __align__(16) int8_t As[2 * T::STAGE_A];
  __shared__ __align__(16) int8_t Bs[2 * T::STAGE_B];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const qtpu::Frag<T> f;
  int acc[T::MT][T::NT][4];
  float td[T::MT][T::NT][4];
  {
    qtpu::StagedA<T, true, StridedRows> a(xl, As, M, Kin, m0);
    qtpu::StagedB<T, true> b(wd, Bs, N, Kin, n0);
    qtpu::mainloop<T>(a, b, Kin, acc);
  }
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = min(n0 + f.col(j, e), N - 1);
          td[i][j][2 * h + e] =
              qtpu::ep_affine(acc[i][j][2 * h + e], p.Ad[n], p.Bd[n]);
        }
  {
    qtpu::StagedA<T, true, MidRows> a(bl, As, M, Kmid, m0);
    qtpu::StagedB<T, true> b(w3, Bs, N, Kmid, n0);
    qtpu::mainloop<T>(a, b, Kmid, acc);
  }
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + f.row(i, h);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + f.col(j, e);
          if (n >= N) continue;
          float t = qtpu::ep_affine(acc[i][j][2 * h + e], p.A3[n], p.B3[n]);
          t = __fadd_rn(t, __fmul_rn(td[i][j][2 * h + e], p.C));
          p.out[static_cast<size_t>(m) * N + n] =
              qtpu::ep_code(t, p.lo, p.hi, p.shift);
        }
      }
    }
  }
}

}  // namespace

// b: int8 (Bn, H, W, Cmid); x: int8 (Bn, Hx, Wx, Cin), read at `stride`;
// w3: (Cout, Cmid), wd: (Cout, Cin); out: int8 (Bn, H, W, Cout).  Cmid and
// Cin are multiples of 16 and the tensors 16-byte aligned (the wrapper
// checks).
extern "C" int qtpu_qproj_fused(const void* b, const void* x, const void* w3,
                                const void* wd, const void* A3,
                                const void* B3, const void* Ad,
                                const void* Bd, void* out, int Bn, int H,
                                int W, int Hx, int Wx, int stride, int Cmid,
                                int Cin, int Cout, float C, float lo, float hi,
                                float shift, void* stream) {
  const int M = Bn * H * W;
  MidRows bl{static_cast<const int8_t*>(b), Cmid};
  StridedRows xl{static_cast<const int8_t*>(x), Hx, Wx, Cin, H, W, stride};
  ProjArgs p{static_cast<const float*>(A3), static_cast<const float*>(B3),
             static_cast<const float*>(Ad), static_cast<const float*>(Bd),
             C, lo, hi, shift, static_cast<int8_t*>(out)};
  const int8_t* w3s = static_cast<const int8_t*>(w3);
  const int8_t* wds = static_cast<const int8_t*>(wd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtpu::use_big_tiles(M, Cout)) {
    dim3 grid((Cout + 127) / 128, (M + 127) / 128);
    qproj_kernel<128, 128, 2, 4>
        <<<grid, 256, 0, s>>>(bl, xl, w3s, wds, M, Cout, Cmid, Cin, p);
  } else {
    dim3 grid((Cout + 63) / 64, (M + 63) / 64);
    qproj_kernel<64, 64, 2, 2>
        <<<grid, 128, 0, s>>>(bl, xl, w3s, wds, M, Cout, Cmid, Cin, p);
  }
  return cudaGetLastError();
}
