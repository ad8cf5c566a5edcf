// K7 and K8: a chained run of int8 identity bottlenecks, and a whole
// stride-1 stage (projection block + that chain), each in one launch, for
// sm_90a.
//
// Replaces the TPU kernels qtpu/ops/pallas/qstage.py:qstage_fused (K7) and
// qstage_proj_fused (K8).  Per identity block i of the chain, on the
// (B*H*W, Cin) codes x_i:
//   a       = requant(x_i . w1_i)                  conv1, 1x1
//   b       = requant(conv3x3(a, pads of zp2_i))   conv2, SAME, stride 1
//   x_{i+1} = requant(b . w3_i + x_i * C3_i)       conv3 + int8 residual
// with relu folded into lo.  K8 first runs the projection block on x_0:
// conv1 and conv2 as above, then conv3 + downsample in K4's order — the
// downsample's f32 acc_d * Ad + Bd kept in registers and added as the f32
// residual with C = 1 / next scale.  Every epilogue step is epilogue.cuh's,
// in the order of the unfused K1 -> K2 -> K1 sequence (K4 for the
// projection), so the codes are bit-identical to it.
//
// Layout (grid_phase.cuh): one cooperative launch of a resident grid, a
// barrier between phases, conv1's and conv2's codes in two device
// workspaces.  conv3 reads its block's input as the residual while it
// writes the next input, so the inputs alternate between the output tensor
// and a third workspace, arranged so that the last block writes the output.
//
// What bounds it on the H100: counted once (x in, x out, the weights),
// layer1's chain is bytes-bound and layer2-4 sit near the int8 tensor-core
// rate (9 * Cmid^2 + 2 * Cin * Cmid multiply-adds per pixel and block).
// The design removes the launches and K2's zero-point-padded copy; the
// intermediates still cross L2 (at B = 8 every run's workspace fits in it),
// and a phase of few tiles (layer4 at B = 8: 56 tiles for 132 SMs) leaves
// most SMs idle until the barrier.
#include <algorithm>

#include "grid_phase.cuh"

namespace {

using qtpu::NSCAL;
using qtpu::PhaseSmem;
using qtpu::Requant;
using qtpu::RequantRes;
using qtpu::Rows1x1;
using qtpu::Taps3x3;

// A stack of identity blocks: weights (N, K) K-contiguous per block.
struct Chain {
  const int8_t* w1;  // (nblk, Cmid, Cin)
  const int8_t* w2;  // (nblk, Cmid, 9 Cmid), k = tap * Cmid + c
  const int8_t* w3;  // (nblk, Cin, Cmid)
  const float *a1, *b1, *a2, *b2;  // (nblk, Cmid)
  const float *a3, *b3;            // (nblk, Cin)
  const float* scal;               // (nblk, NSCAL)
  int nblk, Cin, Cmid;
};

// The projection block of K8: conv1 (Cm, Cp), conv2 (Cm, 9 Cm), conv3
// (Co, Cm) and the downsample (Co, Cp); Co is the chain's Cin.
struct Proj {
  const int8_t *w1, *w2, *w3, *wd;
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  const float* scal;  // (1, NSCAL), C3 = 1 / next scale
  int Cp, Cm;
};

struct StageParams {
  const int8_t* x;  // (M, Cp) with the projection block, else (M, Cin)
  int8_t* out;      // (M, Cin)
  int M, H, W;
  Proj proj;
  Chain chain;
  int8_t* a;    // workspace (M, max Cmid): conv1 codes
  int8_t* b;    // workspace (M, max Cmid): conv2 codes
  int8_t* tmp;  // workspace (M, Cin): block outputs before the last
  unsigned* bar;
};

// conv3 + downsample of the projection block, per tile: the downsample's
// f32 dequant in registers, then conv3's accumulator and K1's f32-residual
// epilogue (qproj.cu's order).  In a probe build, both mainloops' copies
// and mma.sync go to slots 24 and 25, the dequant and the epilogue to 26.
template <bool VEC>
__device__ void proj_phase(const StageParams& p, const float* s,
                           int8_t* dst, PhaseSmem sm, qtpu::PhaseProbe& pr) {
  typedef qtpu::PhaseTile T;
  const Proj& q = p.proj;
  const int N = p.chain.Cin;
  const Rows1x1 xs{p.x, q.Cp}, bs{p.b, q.Cm};
  const int tn = qtpu::ceil_div(N, T::BN);
  const int tiles = qtpu::ceil_div(p.M, T::BM) * tn;
  const qtpu::Frag<T> f;
  const float c = s[9], lo = s[6], hi = s[7], shift = s[8];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tn * T::BM, n0 = t % tn * T::BN;
    int acc[T::MT][T::NT][4];
    float td[T::MT][T::NT][4];
#ifdef QTPU_PHASE_PROBE
    long long lp[3] = {0, 0, 0};
#else
    long long* lp = nullptr;
#endif
    {
      qtpu::PhaseA<T, VEC, Rows1x1> a(xs, sm.As, p.M, m0);
      qtpu::StagedB<T, VEC> b(q.wd, sm.Bs, N, q.Cp, n0);
      qtpu::mainloop<T>(a, b, q.Cp, acc, lp);
    }
#ifdef QTPU_PHASE_PROBE
    pr.add(24, lp[0] + lp[1]);
    pr.add(25, lp[2]);
    long long te = clock64();
#endif
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = min(n0 + f.col(j, e), N - 1);
            td[i][j][2 * h + e] = qtpu::ep_affine(
                acc[i][j][2 * h + e], __ldg(q.ad + n), __ldg(q.bd + n));
          }
#ifdef QTPU_PHASE_PROBE
    pr.add(26, clock64() - te);
#endif
    {
      qtpu::PhaseA<T, VEC, Rows1x1> a(bs, sm.As, p.M, m0);
      qtpu::StagedB<T, VEC> b(q.w3, sm.Bs, N, q.Cm, n0);
      qtpu::mainloop<T>(a, b, q.Cm, acc, lp);
    }
#ifdef QTPU_PHASE_PROBE
    pr.add(24, lp[0] + lp[1]);
    pr.add(25, lp[2]);
    te = clock64();
#endif
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + f.row(i, h);
        if (m >= p.M) continue;
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + f.col(j, e);
            if (n >= N) continue;
            float v = qtpu::ep_affine(acc[i][j][2 * h + e], __ldg(q.a3 + n),
                                      __ldg(q.b3 + n));
            v = __fadd_rn(v, __fmul_rn(td[i][j][2 * h + e], c));
            dst[static_cast<size_t>(m) * N + n] = qtpu::ep_code(v, lo, hi,
                                                                shift);
          }
      }
#ifdef QTPU_PHASE_PROBE
    pr.add(26, clock64() - te);
    pr.add(10, 1);
#endif
    (void)lp;
  }
  (void)pr;
}

template <bool VEC, bool PROJ>
__global__ void __launch_bounds__(qtpu::PHASE_THREADS)
    qstage_kernel(StageParams p) {
  __shared__ __align__(16) int8_t As[2 * qtpu::PhaseTile::STAGE_A];
  __shared__ __align__(16) int8_t Bs[2 * qtpu::PhaseTile::STAGE_B];
  const PhaseSmem sm{As, Bs};
  const Chain& c = p.chain;
  qtpu::PhaseProbe pr;
  auto barrier = [&] {
    const long long t = PHASE_CLOCK();
    qtpu::grid_barrier(p.bar);
    pr.add(9, PHASE_CLOCK() - t);
  };
  // block outputs, the projection block's first: the last one is `out`
  const int writes = c.nblk + (PROJ ? 1 : 0);
  int w = 0;
  const int8_t* x = p.x;
  if (PROJ) {
    // probe slots: the projection's phases at 18 + 3 ph (conv1, conv2,
    // conv3 + downsample), its barriers at 27
    auto proj_barrier = [&] {
      const long long t = PHASE_CLOCK();
      qtpu::grid_barrier(p.bar);
      pr.add(27, PHASE_CLOCK() - t);
    };
    const Proj& q = p.proj;
    float s[NSCAL];
#pragma unroll
    for (int k = 0; k < NSCAL; ++k) s[k] = __ldg(q.scal + k);
    qtpu::gemm_phase<VEC>(Rows1x1{p.x, q.Cp}, q.w1, p.M, q.Cm, q.Cp,
                          Requant{p.a, q.a1, q.b1, s[0], s[1], s[2], q.Cm},
                          sm, &pr, 6);
    proj_barrier();
    qtpu::gemm_phase<VEC>(
        Taps3x3{p.a, q.Cm, p.H, p.W, static_cast<int>(s[10])}, q.w2, p.M,
        q.Cm, 9 * q.Cm, Requant{p.b, q.a2, q.b2, s[3], s[4], s[5], q.Cm},
        sm, &pr, 7);
    proj_barrier();
    int8_t* dst = (writes - 1 - w) & 1 ? p.tmp : p.out;
    proj_phase<VEC>(p, s, dst, sm, pr);
    ++w;
    x = dst;
    if (c.nblk > 0) proj_barrier();
  }
  for (int i = 0; i < c.nblk; ++i, ++w) {
    float s[NSCAL];
#pragma unroll
    for (int k = 0; k < NSCAL; ++k) s[k] = __ldg(c.scal + i * NSCAL + k);
    const size_t mid = static_cast<size_t>(i) * c.Cmid;
    const size_t in = static_cast<size_t>(i) * c.Cin;
    // conv1
    qtpu::gemm_phase<VEC>(
        Rows1x1{x, c.Cin}, c.w1 + mid * c.Cin, p.M, c.Cmid, c.Cin,
        Requant{p.a, c.a1 + mid, c.b1 + mid, s[0], s[1], s[2], c.Cmid}, sm,
        &pr, 0);
    barrier();
    // conv2, 3x3 SAME with conv2's zero point outside the image
    qtpu::gemm_phase<VEC>(
        Taps3x3{p.a, c.Cmid, p.H, p.W, static_cast<int>(s[10])},
        c.w2 + mid * 9 * c.Cmid, p.M, c.Cmid, 9 * c.Cmid,
        Requant{p.b, c.a2 + mid, c.b2 + mid, s[3], s[4], s[5], c.Cmid}, sm,
        &pr, 1);
    barrier();
    // conv3 + the block input as int8 residual
    int8_t* dst = (writes - 1 - w) & 1 ? p.tmp : p.out;
    qtpu::gemm_phase<VEC>(
        Rows1x1{p.b, c.Cmid}, c.w3 + in * c.Cmid, p.M, c.Cin, c.Cmid,
        RequantRes{dst, c.a3 + in, c.b3 + in, x, s[9], s[6], s[7], s[8],
                   c.Cin},
        sm, &pr, 2);
    x = dst;
    if (i + 1 < c.nblk) barrier();
  }
  if (threadIdx.x == 0) pr.store();
}

template <bool PROJ>
int launch(const StageParams& p, bool vec, void* stream) {
  const Chain& c = p.chain;
  int work = qtpu::phase_tiles(p.M, c.Cin);
  if (c.nblk > 0) work = std::max(work, qtpu::phase_tiles(p.M, c.Cmid));
  if (PROJ) work = std::max(work, qtpu::phase_tiles(p.M, p.proj.Cm));
  void (*kernel)(StageParams) =
      vec ? qstage_kernel<true, PROJ> : qstage_kernel<false, PROJ>;
  const int grid = qtpu::resident_grid(kernel, work);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(qtpu::launch_cooperative(
      kernel, grid, p, static_cast<cudaStream_t>(stream)));
}

Chain make_chain(const void* w1, const void* w2, const void* w3,
                 const void* a1, const void* b1, const void* a2,
                 const void* b2, const void* a3, const void* b3,
                 const void* scal, int nblk, int Cin, int Cmid) {
  return Chain{static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
               static_cast<const int8_t*>(w3), static_cast<const float*>(a1),
               static_cast<const float*>(b1), static_cast<const float*>(a2),
               static_cast<const float*>(b2), static_cast<const float*>(a3),
               static_cast<const float*>(b3), static_cast<const float*>(scal),
               nblk, Cin, Cmid};
}

}  // namespace

// K7.  x, out: int8 (M, Cin), M = Bn * H * W rows of NHWC images; the chain
// as in `Chain`; ws: workspace of 2 * M * Cmid (+ M * Cin when nblk > 1)
// bytes; bar: the two barrier words.  vec: Cin and Cmid are multiples of 16
// and every tensor is 16-byte aligned (else byte-gather loads).
extern "C" int qtpu_qstage_fused(const void* x, const void* w1,
                                 const void* w2, const void* w3,
                                 const void* a1, const void* b1,
                                 const void* a2, const void* b2,
                                 const void* a3, const void* b3,
                                 const void* scal, void* out, void* ws,
                                 void* bar, int Bn, int H, int W, int nblk,
                                 int Cin, int Cmid, int vec, void* stream) {
  StageParams p = {};
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.M = Bn * H * W;
  p.H = H;
  p.W = W;
  p.chain = make_chain(w1, w2, w3, a1, b1, a2, b2, a3, b3, scal, nblk, Cin,
                       Cmid);
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t mid = static_cast<size_t>(p.M) * Cmid;
  p.a = wsb;
  p.b = wsb + mid;
  p.tmp = wsb + 2 * mid;
  p.bar = static_cast<unsigned*>(bar);
  return launch<false>(p, vec != 0, stream);
}

// K8.  x: int8 (M, Cp); out: int8 (M, Co); the projection block's weights
// and coefficients, then the chain with Cin = Co; ws: 2 * M * max(Cm, Cmid)
// (+ M * Co when nblk > 0) bytes.
extern "C" int qtpu_qstage_proj_fused(
    const void* x, const void* wp1, const void* wp2, const void* wp3,
    const void* wd, const void* pa1, const void* pb1, const void* pa2,
    const void* pb2, const void* pa3, const void* pb3, const void* pda,
    const void* pdb, const void* pscal, const void* w1, const void* w2,
    const void* w3, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, const void* scal,
    void* out, void* ws, void* bar, int Bn, int H, int W, int Cp, int Cm,
    int nblk, int Co, int Cmid, int vec, void* stream) {
  StageParams p = {};
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.M = Bn * H * W;
  p.H = H;
  p.W = W;
  p.proj = Proj{static_cast<const int8_t*>(wp1),
                static_cast<const int8_t*>(wp2),
                static_cast<const int8_t*>(wp3),
                static_cast<const int8_t*>(wd),
                static_cast<const float*>(pa1), static_cast<const float*>(pb1),
                static_cast<const float*>(pa2), static_cast<const float*>(pb2),
                static_cast<const float*>(pa3), static_cast<const float*>(pb3),
                static_cast<const float*>(pda), static_cast<const float*>(pdb),
                static_cast<const float*>(pscal), Cp, Cm};
  p.chain = make_chain(w1, w2, w3, a1, b1, a2, b2, a3, b3, scal, nblk, Co,
                       Cmid);
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t mid = static_cast<size_t>(p.M) * std::max(Cm, Cmid);
  p.a = wsb;
  p.b = wsb + mid;
  p.tmp = wsb + 2 * mid;
  p.bar = static_cast<unsigned*>(bar);
  return launch<true>(p, vec != 0, stream);
}

#ifdef QTPU_PHASE_PROBE
namespace {
__global__ void coop_cluster_kernel(int* out) {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int>(r);
}
}  // namespace

// Probe build only: whether a cooperative launch takes a cluster dimension
// (0, or the launch's CUDA error); out[block] = the block's cluster rank.
extern "C" int qtpu_probe_coop_cluster(void* out, int grid, int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32);
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = cs;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, coop_cluster_kernel, static_cast<int*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
#endif
