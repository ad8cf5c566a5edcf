// The machinery the chained whole-stage kernels share (K7/K8 qstage.cu,
// K9 qivr.cu): one persistent grid that runs a chain of convolutions as
// phases, each phase a loop of the grid's blocks over its output tiles, a
// grid-wide barrier between phases.
//
// Why phases and not one block per image (the TPU kernels' layout: whole
// images per grid step, the weights resident in VMEM): one 56 x 56 image at
// ResNet layer1 is 784 KB of int8 codes and MobileNet-v2 block2's expand
// output 440 KB, while an SM has at most 227 KB of shared memory; a 3x3 conv
// needs its neighbours' conv1 output, so the chain cannot be cut spatially
// either without a halo that grows by a pixel per chained block.  So each
// phase writes its int8 codes to a device workspace the wrapper allocates
// (at B = 8 it stays in the 50 MB L2), and the next phase reads them after
// the barrier.  What stays out of device memory against the unfused K1/K2/K3
// sequence is every launch but one and K2's zero-point-padded copy.
//
//   * grid_barrier: an arrival counter and a generation word (two unsigned
//     ints the wrapper keeps per device, zero at first use and back to a
//     zero count after every barrier); the last block to arrive resets the
//     count and bumps the generation.  The grid is sized to what is
//     co-resident and launched cooperatively, so every block is running; a
//     wait that still spins too long traps, so a deadlock is a launch error
//     and not a hung card.
//   * gemm_phase: the grid's blocks take the phase's 64 x 64 output tiles
//     in turn (m-major, so neighbouring blocks share A rows in L2) and run
//     igemm.cuh's main loop on each, the epilogue a functor.
//   * the A sources of a phase: Rows1x1 (an (M, K) matrix of codes, the
//     1x1 convs) and Taps3x3, the 3x3 SAME conv on unpadded NHWC rows: tap
//     (dy, dx) of output row r is input row r + dy * W + dx, and a tap whose
//     h = (r / W) % H or w = r % W leaves the image reads the zero point —
//     the TPU kernels' _edge_masks / _conv3x3 (qstage.py:52-108).  A tap
//     that would cross into the next image is always such a masked tap.
//
// Codes written during the kernel are read back through L2 only (cp.async.cg
// and __ldcg): the L1 of an SM is not coherent with the other SMs' writes.
#pragma once

#include <cstddef>

#include "igemm.cuh"

namespace qtpu {

// Probe build only (-DQTPU_PHASE_PROBE, qtpu_torch/ops/probe_chain.py):
// thread 0 of each block of a chained kernel sums clock64() cycles by slot
// and writes them to qtpu_phase_probe[PROBE_SLOTS * blockIdx.x + i] when
// the block ends.  The old kernels (this file, built with -DQTPU_IGEMM_PROBE
// too, so that igemm.cuh's mainloop splits its cycles): for the block's
// three phases p (conv1 / expand, conv2 / depthwise, conv3 / project)
// [3p] the operand copies (issue and wait), [3p + 1] the mma.sync loop (the
// whole depthwise loop for K9's phase 1), [3p + 2] the epilogue; [9] the
// waits at the grid barrier, [10] the tiles the block ran; K8's projection
// block the same at [18 + 3p ..] for its phases (conv1, conv2, conv3 +
// downsample) and [27] its barrier waits; the new kernels (wgmma_phase.cuh)
// their own slots; [31] the block's total.  add(i, c) adds c cycles to slot
// i; without the flag it compiles to nothing.
#ifdef QTPU_PHASE_PROBE
constexpr int PROBE_SLOTS = 32, PRODUCER_SLOT = 12;
__device__ long long* qtpu_phase_probe;
struct PhaseProbe {
  long long v[PROBE_SLOTS], t0;
  __device__ PhaseProbe() {
    t0 = clock64();
    for (int i = 0; i < PROBE_SLOTS; ++i) v[i] = 0;
  }
  __device__ __forceinline__ void add(int i, long long c) { v[i] += c; }
  // (slot PRODUCER_SLOT is the runner's producer thread's, written by it)
  __device__ void store() {
    v[PROBE_SLOTS - 1] = clock64() - t0;
    for (int i = 0; i < PROBE_SLOTS; ++i)
      if (i != PRODUCER_SLOT)
        qtpu_phase_probe[PROBE_SLOTS * blockIdx.x + i] = v[i];
  }
};
#define PHASE_CLOCK() clock64()
#else
struct PhaseProbe {
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void store() {}
};
#define PHASE_CLOCK() 0ll
#endif

typedef TileCfg<64, 64, 2, 2> PhaseTile;
constexpr int PHASE_THREADS = PhaseTile::NTHREADS;
// about 2^26 waits of >= 64 ns: seconds, far beyond any phase of a chain
constexpr long long BARRIER_SPINS = 1ll << 26;

// All blocks of the grid wait here until every block has arrived; writes
// before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      long long spins = 0;
      while (*gen == g) {
        __nanosleep(64);
        if (++spins > BARRIER_SPINS) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// One int8 code replicated into 16 bytes (a zero-point fill).
__device__ __forceinline__ int4 splat_code(int code) {
  const int v = static_cast<int>((static_cast<unsigned>(code) & 0xffu) *
                                 0x01010101u);
  return make_int4(v, v, v, v);
}

// A rows of a 1x1 conv: row m of the (M, K) codes x.
struct Rows1x1 {
  const int8_t* x;
  int K;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    return x + static_cast<size_t>(m) * K;
  }
  // 16 bytes k.. of row r into shared dst; zeros past K or for a row past M
  template <bool VEC>
  __device__ __forceinline__ void load(int8_t* dst, Row r, int k,
                                       bool ok) const {
    if (VEC) {
      const bool v = ok && k < K;
      cp_async16(dst, v ? r + k : x, v);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (ok && k + j < K) ? __ldcg(r + k + j) : int8_t(0);
    }
  }
};

// A rows of a 3x3 SAME conv (stride 1) on the unpadded (M, C) codes x of
// B images of H x W: reduction index k = tap * C + c, tap = (dy + 1) * 3 +
// (dx + 1); a tap outside the image reads the zero point zp.
struct Taps3x3 {
  const int8_t* x;
  int C, H, W, zp;
  struct Row {
    const int8_t* p;  // the output pixel's own row
    int h, w;
  };
  __device__ __forceinline__ Row row(int m) const {
    return Row{x + static_cast<size_t>(m) * C, (m / W) % H, m % W};
  }
  __device__ __forceinline__ bool inside(const Row& r, int tap) const {
    const int hh = r.h + tap / 3 - 1, ww = r.w + tap % 3 - 1;
    return hh >= 0 && hh < H && ww >= 0 && ww < W;
  }
  __device__ __forceinline__ const int8_t* at(const Row& r, int tap,
                                              int c) const {
    return r.p + static_cast<ptrdiff_t>((tap / 3 - 1) * W + tap % 3 - 1) *
                     C + c;
  }
  template <bool VEC>
  __device__ __forceinline__ void load(int8_t* dst, const Row& r, int k,
                                       bool ok) const {
    const int K = 9 * C;
    if (VEC) {  // C % 16 == 0: a chunk lies in one tap
      if (!ok || k >= K) {
        cp_async16(dst, x, false);
        return;
      }
      const int tap = k / C;
      if (inside(r, tap))
        cp_async16(dst, at(r, tap, k - tap * C), true);
      else
        *reinterpret_cast<int4*>(dst) = splat_code(zp);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = k + j;
        int8_t v = 0;
        if (ok && kk < K) {
          const int tap = kk / C;
          v = inside(r, tap) ? __ldcg(at(r, tap, kk - tap * C))
                             : static_cast<int8_t>(zp);
        }
        dst[j] = v;
      }
    }
  }
};

// igemm.cuh's StagedA over a phase source: each thread loads the same
// chunks at every stage, their rows resolved once per tile.
template <class T, bool VEC, class Src>
struct PhaseA {
  static constexpr int CHUNKS = T::BM * T::CPR / T::NTHREADS;
  const Src& src;
  int8_t* As;
  typename Src::Row row[CHUNKS];
  int r[CHUNKS], c[CHUNKS];
  bool ok[CHUNKS];

  __device__ PhaseA(const Src& s, int8_t* As_, int M, int m0)
      : src(s), As(As_) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int cc = threadIdx.x + i * T::NTHREADS;
      r[i] = cc / T::CPR;
      c[i] = (cc % T::CPR) * 16;
      ok[i] = m0 + r[i] < M;
      row[i] = src.row(ok[i] ? m0 + r[i] : 0);
    }
  }
  __device__ void load(int s, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
      src.template load<VEC>(As + s * T::STAGE_A + r[i] * SK + c[i], row[i],
                             k0 + c[i], ok[i]);
  }
  __device__ const int8_t* base(int s) const { return As + s * T::STAGE_A; }
  __device__ int row_off(int rr) const { return rr * SK; }
  __device__ int k_off(int, int kk) const { return kk; }
};

// The shared-memory stages of a phase: two of A and two of B.
struct PhaseSmem {
  int8_t* As;
  int8_t* Bs;
};

// One block's part of a GEMM phase: C = A x W^T over the (M, N) output
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...; epi(m, n, acc) for every
// element inside (M, N).  W is (N, K), K-contiguous.
// pr, ph: the probe and the phase's index (probe builds only).
template <bool VEC, class Src, class Epi>
__device__ __forceinline__ void gemm_phase(const Src& src,
                                           const int8_t* __restrict__ w,
                                           int M, int N, int K,
                                           const Epi& epi, PhaseSmem sm,
                                           PhaseProbe* pr = nullptr,
                                           int ph = 0) {
  typedef PhaseTile T;
  const int tn = (N + T::BN - 1) / T::BN;
  const int tiles = (M + T::BM - 1) / T::BM * tn;
  const Frag<T> f;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tn * T::BM, n0 = t % tn * T::BN;
    PhaseA<T, VEC, Src> a(src, sm.As, M, m0);
    StagedB<T, VEC> b(w, sm.Bs, N, K, n0);
    int acc[T::MT][T::NT][4];
#ifdef QTPU_PHASE_PROBE
    long long lp[3] = {0, 0, 0};
    mainloop<T>(a, b, K, acc, lp);
    const long long te = clock64();
#else
    mainloop<T>(a, b, K, acc);
#endif
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + f.row(i, h);
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + f.col(j, e);
            if (n < N) epi(m, n, acc[i][j][2 * h + e]);
          }
      }
#ifdef QTPU_PHASE_PROBE
    if (pr) {
      pr->add(3 * ph, lp[0] + lp[1]);
      pr->add(3 * ph + 1, lp[2]);
      pr->add(3 * ph + 2, clock64() - te);
      pr->add(10, 1);
    }
#endif
  }
  (void)pr;
  (void)ph;
}

// The 12 per-phase-set scalars the wrappers pass for each chained block:
// [lo1, hi1, shift1, lo2, hi2, shift2, lo3, hi3, shift3, C3, zp2, unused].
constexpr int NSCAL = 12;

// Epilogue: requant to codes (out (M, N)).
struct Requant {
  int8_t* out;
  const float* A;
  const float* B;
  float lo, hi, shift;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    out[static_cast<size_t>(m) * N + n] =
        ep_code(ep_affine(acc, __ldg(A + n), __ldg(B + n)), lo, hi, shift);
  }
};

// Epilogue: + the int8 residual res (M, N) weighted by C, then requant.
struct RequantRes {
  int8_t* out;
  const float* A;
  const float* B;
  const int8_t* res;
  float C, lo, hi, shift;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    const size_t idx = static_cast<size_t>(m) * N + n;
    float t = ep_affine(acc, __ldg(A + n), __ldg(B + n));
    t = __fadd_rn(t, __fmul_rn(static_cast<float>(__ldcg(res + idx)), C));
    out[idx] = ep_code(t, lo, hi, shift);
  }
};

// The largest grid of `kernel` (PHASE_THREADS threads, static shared memory
// only) whose blocks are all resident on the card at once, capped at
// `work` blocks; < 0 on error.
template <class Kernel>
int resident_grid(Kernel kernel, int work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, PHASE_THREADS, 0) != cudaSuccess)
    return -1;
  const int grid = per_sm * sms;
  return work < grid ? (work > 0 ? work : 1) : grid;
}

// Launch `kernel` cooperatively on `grid` blocks: the launch fails, rather
// than hangs, when the blocks cannot all be resident.
template <class Params>
cudaError_t launch_cooperative(void (*kernel)(Params), int grid,
                               const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(PHASE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Output tiles of an (M, N) GEMM phase.
inline int phase_tiles(int M, int N) {
  return ceil_div(M, PhaseTile::BM) * ceil_div(N, PhaseTile::BN);
}

}  // namespace qtpu

#ifdef QTPU_PHASE_PROBE
// Probe build only: where the chained kernels (the older ones and the
// runner) write their cycles by slot (PhaseProbe).
extern "C" int qtpu_phase_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qtpu::qtpu_phase_probe, &buf, sizeof(buf)));
}
#endif
