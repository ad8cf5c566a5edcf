// K9: a chained run of int8 MobileNet-v2 inverted residuals in one launch,
// for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qivr.py:qivr_fused.  Per block i
// of the run, on the (B*H*W, C) codes x_i:
//   e       = requant(x_i . w1_i)                 expand 1x1, relu6 in hi1
//   d       = requant(depthwise3x3(e, pads zp))   stride 1, relu6 in hi2
//   x_{i+1} = requant(d . w3_i + x_i * C3_i)      project + int8 residual
// (the project has no relu).  The unfused port runs K1 -> K3 -> K1; every
// epilogue step here is epilogue.cuh's in that order, so the codes are
// bit-identical to it.
//
// Layout (grid_phase.cuh): one cooperative launch of a resident grid, a
// barrier between phases, the expand and depthwise codes in two device
// workspaces, the block inputs alternating between the output tensor and a
// third workspace so that the last block writes the output.  The expand and
// project phases are igemm.cuh's main loop on 64 x 64 tiles; C = 24
// (block2) is not a multiple of 16, so its expand gathers A bytewise.  The
// depthwise phase is K3's per-thread arithmetic (qdepthwise.cu): one output
// pixel x 16 channels a thread, nine 16-byte tap loads (the zero point for
// a tap outside the image), 16 int32 sums, one 16-byte store.
//
// What bounds it on the H100: counted once (x in, x out, the weights), the
// run does 2 * E * (2 C + 9) operations per pixel and block, the nine-tap
// depthwise on CUDA cores (67 TOP/s) bounding block2-block12 and the two
// GEMMs block14/15.  The design keeps the chain in one launch; the
// expanded codes (6x the block's input bytes) still cross L2, which holds
// them at B = 8.
#include "grid_phase.cuh"

namespace {

using qtpu::NSCAL;
using qtpu::PhaseSmem;
using qtpu::Requant;
using qtpu::RequantRes;
using qtpu::Rows1x1;

struct IvrParams {
  const int8_t* x;  // (M, C)
  int8_t* out;      // (M, C)
  int M, H, W, C, E, nblk;
  const int8_t* w1;  // (nblk, E, C)
  const int8_t* wd;  // (nblk, 9, E) depthwise taps, tap = (dy+1)*3 + dx+1
  const int8_t* w3;  // (nblk, C, E)
  const float *a1, *b1, *a2, *b2;  // (nblk, E)
  const float *a3, *b3;            // (nblk, C)
  const float* scal;               // (nblk, NSCAL), zp2 the depthwise pad
  int8_t* e;    // workspace (M, E): expand codes
  int8_t* d;    // workspace (M, E): depthwise codes
  int8_t* tmp;  // workspace (M, C): block outputs before the last
  unsigned* bar;
};

// Byte r (0..3) of v, sign-extended.
__device__ __forceinline__ int sbyte(unsigned v, int r) {
  return static_cast<int>(v << (24 - 8 * r)) >> 24;
}

// The depthwise phase (E % 16 == 0): items (pixel, 16-channel chunk) over
// all threads of the grid.
__device__ void dw_phase(const IvrParams& p, int blk, const float* s) {
  const int chunks = p.E >> 4;
  const long long items = static_cast<long long>(p.M) * chunks;
  const int8_t* wd = p.wd + static_cast<size_t>(blk) * 9 * p.E;
  const float* A = p.a2 + static_cast<size_t>(blk) * p.E;
  const float* B = p.b2 + static_cast<size_t>(blk) * p.E;
  const unsigned zw = (static_cast<unsigned>(static_cast<int>(s[10])) &
                       0xffu) * 0x01010101u;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(it % chunks) << 4;
    const int m = static_cast<int>(it / chunks);
    const int h = (m / p.W) % p.H, w = m % p.W;
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      uint4 xv = make_uint4(zw, zw, zw, zw);
      if (h + dy >= 0 && h + dy < p.H && w + dx >= 0 && w + dx < p.W)
        xv = __ldcg(reinterpret_cast<const uint4*>(
            p.e + static_cast<size_t>(m + dy * p.W + dx) * p.E + c0));
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(
          wd + static_cast<size_t>(tap) * p.E + c0));
      const unsigned xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const unsigned ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[4 * q + r] += sbyte(xs[q], r) * sbyte(ws[q], r);
    }
    unsigned packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int8_t code = qtpu::ep_code(
          qtpu::ep_affine(acc[j], __ldg(A + c0 + j), __ldg(B + c0 + j)),
          s[3], s[4], s[5]);
      packed[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(code))
                        << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(p.d + static_cast<size_t>(m) * p.E + c0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// VEC_C: C % 16 == 0 (16-byte chunks of the expand's A rows and w1 rows);
// E % 16 == 0 always (the wrapper checks).
template <bool VEC_C>
__global__ void __launch_bounds__(qtpu::PHASE_THREADS)
    qivr_kernel(IvrParams p) {
  __shared__ __align__(16) int8_t As[2 * qtpu::PhaseTile::STAGE_A];
  __shared__ __align__(16) int8_t Bs[2 * qtpu::PhaseTile::STAGE_B];
  const PhaseSmem sm{As, Bs};
  const int8_t* x = p.x;
  qtpu::PhaseProbe pr;
  auto barrier = [&] {
    const long long t = PHASE_CLOCK();
    qtpu::grid_barrier(p.bar);
    pr.add(9, PHASE_CLOCK() - t);
  };
  for (int i = 0; i < p.nblk; ++i) {
    float s[NSCAL];
#pragma unroll
    for (int k = 0; k < NSCAL; ++k) s[k] = __ldg(p.scal + i * NSCAL + k);
    const size_t ei = static_cast<size_t>(i) * p.E;
    const size_t ci = static_cast<size_t>(i) * p.C;
    // expand, relu6 folded into hi1
    qtpu::gemm_phase<VEC_C>(
        Rows1x1{x, p.C}, p.w1 + ei * p.C, p.M, p.E, p.C,
        Requant{p.e, p.a1 + ei, p.b1 + ei, s[0], s[1], s[2], p.E}, sm, &pr,
        0);
    barrier();
    // depthwise 3x3, the zero point outside the image
    const long long td = PHASE_CLOCK();
    dw_phase(p, i, s);
    pr.add(4, PHASE_CLOCK() - td);
    barrier();
    // project + the block input as int8 residual
    int8_t* dst = (p.nblk - 1 - i) & 1 ? p.tmp : p.out;
    qtpu::gemm_phase<true>(
        Rows1x1{p.d, p.E}, p.w3 + ci * p.E, p.M, p.C, p.E,
        RequantRes{dst, p.a3 + ci, p.b3 + ci, x, s[9], s[6], s[7], s[8],
                   p.C},
        sm, &pr, 2);
    x = dst;
    if (i + 1 < p.nblk) barrier();
  }
  if (threadIdx.x == 0) pr.store();
}

}  // namespace

// x, out: int8 (M, C), M = Bn * H * W rows of NHWC images; the run as in
// IvrParams; ws: 2 * M * E (+ M * C when nblk > 1) bytes; bar: the two
// barrier words.  E % 16 == 0 and every tensor 16-byte aligned (the wrapper
// checks); vec_c: C % 16 == 0.
extern "C" int qtpu_qivr_fused(const void* x, const void* w1, const void* wd,
                               const void* w3, const void* a1,
                               const void* b1, const void* a2,
                               const void* b2, const void* a3,
                               const void* b3, const void* scal, void* out,
                               void* ws, void* bar, int Bn, int H, int W,
                               int nblk, int C, int E, int vec_c,
                               void* stream) {
  IvrParams p = {};
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.M = Bn * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.E = E;
  p.nblk = nblk;
  p.w1 = static_cast<const int8_t*>(w1);
  p.wd = static_cast<const int8_t*>(wd);
  p.w3 = static_cast<const int8_t*>(w3);
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.scal = static_cast<const float*>(scal);
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t me = static_cast<size_t>(p.M) * E;
  p.e = wsb;
  p.d = wsb + me;
  p.tmp = wsb + 2 * me;
  p.bar = static_cast<unsigned*>(bar);
  void (*kernel)(IvrParams) =
      vec_c ? qivr_kernel<true> : qivr_kernel<false>;
  const int work = qtpu::phase_tiles(p.M, E);
  const int grid = qtpu::resident_grid(kernel, work);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(qtpu::launch_cooperative(
      kernel, grid, p, static_cast<cudaStream_t>(stream)));
}

