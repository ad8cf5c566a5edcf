// Shared core of the int8 GEMM kernels: an int8 x int8 -> int32 tensor-core
// GEMM tile loop (mma.sync m16n8k32 s8) that leaves the accumulator fragment
// in registers, and the plain GEMM kernel that ends it in the folded requant
// epilogue of epilogue.cuh.
//
// C[m, n] = sum_k A[m, k] * W[n, k], W stored (N, K) K-contiguous.  The main
// loop (`mainloop`) takes its A operand from a source policy:
//   * StagedA copies it from global memory stage by stage through a loader
//     (the plain GEMM of qmatmul.cu, the implicit-GEMM conv of qconv.cu, the
//     two GEMMs of qproj.cu, conv1 of qblock.cu);
//   * a resident source reads it from a tile that already lies in shared
//     memory (conv2 and conv3 of the fused bottleneck tail, fused_tail.cuh).
// W streams through a B source too: StagedB for int8 weights, StagedB4 for
// int4 weights nibble-packed along K (K1's int4 entry, qmatmul.cu), which
// copies the packed bytes and unpacks them at the fragment load.  So one
// block can chain GEMM phases: the accumulator of one phase is requantised in
// registers and feeds the next through shared memory, never through device
// memory.
//
// Block tile BM x BN, depth BK = 64 (k values) per stage, two shared-memory
// stages filled with cp.async (16-byte chunks, zero-filled past the ragged
// edges of M, N and K) while the tensor cores work on the other stage.
// Shared rows are padded (80 bytes, 48 for packed int4) so that the fragment
// loads of a warp hit distinct banks.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace qtpu {

constexpr int BK = 64;       // K bytes per pipeline stage
constexpr int SK = BK + 16;  // padded shared row stride in bytes
constexpr int SK4 = BK / 2 + 16;  // the same for a packed int4 B stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Four int4 values, nibbles n0..n3 of the low 16 bits of p (n0 lowest: k, k+1
// of the first byte, then k+2, k+3), as the 32-bit register of four int8
// values that mma.sync takes (byte i = n_i, sign-extended).
__device__ __forceinline__ unsigned unpack_s4x4(unsigned p) {
  unsigned t = (p | (p << 12)) & 0x0F0F0F0Fu;  // bytes n0, n2, n1, n3
  t = __byte_perm(t, 0, 0x3120);               // bytes n0, n1, n2, n3
  // arithmetic sign extension per byte: a set bit 3 fills bits 4-7
  // (0x08 * 0x1E = 0xF0, no carry into the next byte)
  return t | ((t & 0x08080808u) * 0x1Eu);
}

// A BM x BN block tile over WARPS_M x WARPS_N warps; each warp owns a
// WM x WN tile of MT x NT mma tiles.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;   // m16 tiles per warp
  static constexpr int NT = WN / 8;    // n8 tiles per warp
  static constexpr int CPR = BK / 16;  // 16-byte chunks per row and stage
  static constexpr int STAGE_A = BM * SK;  // bytes of one A stage
  static constexpr int STAGE_B = BN * SK;  // bytes of one B stage
};

// Where this thread's accumulator entries lie in the block tile:
// acc[i][j][2 * h + e] holds C[row(i, h), col(j, e)].
template <class T>
struct Frag {
  int warp_m, warp_n, g, tg;
  __device__ Frag() {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    warp_m = warp / T::WARPS_N;
    warp_n = warp % T::WARPS_N;
    g = lane >> 2;   // groupID
    tg = lane & 3;   // thread in group
  }
  __device__ int row(int i, int h) const {
    return warp_m * T::WM + i * 16 + g + 8 * h;
  }
  __device__ int col(int j, int e) const {
    return warp_n * T::WN + j * 8 + tg * 2 + e;
  }
};

// A operand copied from global memory, stage by stage, rows m0.. of an
// M x K matrix addressed through a loader (row(m), ptr(row, k), base()).
// VEC: every 16-byte chunk of K lies in one row of the source and is 16-byte
// aligned (the loader guarantees it when K, or Ci for the conv, is a multiple
// of 16); otherwise chunks are gathered byte by byte.
template <class T, bool VEC, class ALoader>
struct StagedA {
  static constexpr int CHUNKS = T::BM * T::CPR / T::NTHREADS;
  static_assert(T::BM * T::CPR % T::NTHREADS == 0,
                "A tile does not split evenly over the threads");
  ALoader al;
  int8_t* As;  // two stages of T::STAGE_A bytes
  int K;
  // Each thread loads the same rows at every stage: resolve them once.
  typename ALoader::Row row[CHUNKS];
  int r[CHUNKS], c[CHUNKS];
  bool ok[CHUNKS];

  __device__ StagedA(const ALoader& al_, int8_t* As_, int M, int K_, int m0)
      : al(al_), As(As_), K(K_) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int cc = threadIdx.x + i * T::NTHREADS;
      r[i] = cc / T::CPR;
      c[i] = (cc % T::CPR) * 16;
      ok[i] = m0 + r[i] < M;
      row[i] = al.row(ok[i] ? m0 + r[i] : 0);
    }
  }
  __device__ void load(int s, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int8_t* dst = As + s * T::STAGE_A + r[i] * SK + c[i];
      const int k = k0 + c[i];
      if (VEC) {
        const bool v = ok[i] && k < K;
        cp_async16(dst, v ? al.ptr(row[i], k) : al.base(), v);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (ok[i] && k + j < K) ? *al.ptr(row[i], k + j)
                                        : static_cast<int8_t>(0);
      }
    }
  }
  __device__ const int8_t* base(int s) const { return As + s * T::STAGE_A; }
  __device__ int row_off(int rr) const { return rr * SK; }
  __device__ int k_off(int, int kk) const { return kk; }
};

// A operand already resident in shared memory as a row-major tile.
struct TileA {
  const int8_t* t;
  int stride;  // bytes per row
  __device__ void load(int, int) {}
  __device__ const int8_t* base(int) const { return t; }
  __device__ int row_off(int rr) const { return rr * stride; }
  __device__ int k_off(int k0, int kk) const { return k0 + kk; }
};

// W (N, K) K-contiguous, rows n0.. of a BN-row tile, stage by stage.
template <class T, bool VEC>
struct StagedB {
  static constexpr int STAGE = T::STAGE_B;  // bytes of one stage
  static constexpr int CHUNKS = T::BN * T::CPR / T::NTHREADS;
  static_assert(T::BN * T::CPR % T::NTHREADS == 0,
                "B tile does not split evenly over the threads");
  const int8_t* w;
  int8_t* Bs;  // two stages of T::STAGE_B bytes
  int K, n0;
  int r[CHUNKS], c[CHUNKS];
  bool ok[CHUNKS];

  __device__ StagedB(const int8_t* w_, int8_t* Bs_, int N, int K_, int n0_)
      : w(w_), Bs(Bs_), K(K_), n0(n0_) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int cc = threadIdx.x + i * T::NTHREADS;
      r[i] = cc / T::CPR;
      c[i] = (cc % T::CPR) * 16;
      ok[i] = n0 + r[i] < N;
    }
  }
  __device__ void load(int s, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int8_t* dst = Bs + s * T::STAGE_B + r[i] * SK + c[i];
      const int k = k0 + c[i];
      const int8_t* src = w + static_cast<size_t>(n0 + r[i]) * K + k;
      if (VEC) {
        const bool v = ok[i] && k < K;
        cp_async16(dst, v ? src : w, v);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (ok[i] && k + j < K) ? src[j] : static_cast<int8_t>(0);
      }
    }
  }
  __device__ const int8_t* base(int s) const { return Bs + s * T::STAGE_B; }
  // The mma B fragment of tile row n at stage depth k (k = kk + 4 tg): k..k+3
  // and k+16..k+19.
  __device__ void frag(const int8_t* bs, int n, int k, unsigned& b0,
                       unsigned& b1) const {
    const int8_t* p = bs + n * SK + k;
    b0 = ld32(p);
    b1 = ld32(p + 16);
  }
};

// int4 W nibble-packed along K: (N, K/2) bytes, byte j of a row holding k =
// 2j (low nibble) and 2j + 1 (high nibble).  cp.async copies the packed
// (BN x BK/2) tile, so the weight crosses device and shared memory at half a
// byte per value; `frag` unpacks 16 bits into the four int8 values of an mma
// register (unpack_s4x4).  Unpacking at the fragment load instead of into an
// int8 shared tile keeps one pass through shared memory and no extra
// barrier; each packed byte is unpacked once per warp row that reads it (the
// WARPS_M warps of a block column), a few integer operations beside the mma.
// VEC: K/2 a multiple of 16 and the rows 16-byte aligned; otherwise bytes.
template <class T, bool VEC>
struct StagedB4 {
  static constexpr int STAGE = T::BN * SK4;
  static constexpr int CPR = BK / 32;  // 16-byte chunks per row and stage
  static constexpr int CHUNKS = T::BN * CPR / T::NTHREADS;
  static_assert(T::BN * CPR % T::NTHREADS == 0,
                "packed B tile does not split evenly over the threads");
  const int8_t* w;
  int8_t* Bs;  // two stages of STAGE bytes
  int KB, n0;  // KB = K / 2 bytes per row
  int r[CHUNKS], c[CHUNKS];
  bool ok[CHUNKS];

  __device__ StagedB4(const int8_t* w_, int8_t* Bs_, int N, int K, int n0_)
      : w(w_), Bs(Bs_), KB(K / 2), n0(n0_) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int cc = threadIdx.x + i * T::NTHREADS;
      r[i] = cc / CPR;
      c[i] = (cc % CPR) * 16;
      ok[i] = n0 + r[i] < N;
    }
  }
  __device__ void load(int s, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      int8_t* dst = Bs + s * STAGE + r[i] * SK4 + c[i];
      const int kb = k0 / 2 + c[i];
      const int8_t* src = w + static_cast<size_t>(n0 + r[i]) * KB + kb;
      if (VEC) {
        const bool v = ok[i] && kb < KB;
        cp_async16(dst, v ? src : w, v);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (ok[i] && kb + j < KB) ? src[j] : static_cast<int8_t>(0);
      }
    }
  }
  __device__ const int8_t* base(int s) const { return Bs + s * STAGE; }
  __device__ void frag(const int8_t* bs, int n, int k, unsigned& b0,
                       unsigned& b1) const {
    const int8_t* p = bs + n * SK4 + k / 2;
    b0 = unpack_s4x4(*reinterpret_cast<const unsigned short*>(p));
    b1 = unpack_s4x4(*reinterpret_cast<const unsigned short*>(p + 8));
  }
};

// acc = A[m0.., :] x W[n0.., :]^T over the whole depth K, into registers.
// Every thread of the block calls it (it synchronises the block), and it ends
// on a barrier, so the stage buffers are free for the next phase on return.
// In a probe build (-DQTPU_IGEMM_PROBE) it sums the calling thread's
// clock64() cycles into `phases`, when given: [0] issuing the copies (the
// loaders' address arithmetic and the cp.async instructions), [1] waiting
// for a stage to land (cp.async.wait_group and the barrier after it), [2]
// the fragment loads and mma.sync up to the stage's closing barrier.
template <class T, class ASrc, class BSrc>
__device__ __forceinline__ void mainloop(ASrc& a, BSrc& b, int K,
                                         int (&acc)[T::MT][T::NT][4],
                                         long long* phases = nullptr) {
#ifdef QTPU_IGEMM_PROBE
  long long ph_issue = 0, ph_wait = 0, ph_mma = 0, ph_t = clock64();
#define IG_PROBE_ADD(v)        \
  {                              \
    const long long t = clock64(); \
    v += t - ph_t;               \
    ph_t = t;                    \
  }
#else
#define IG_PROBE_ADD(v)
#endif
  const Frag<T> f;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int roff[T::MT][2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) roff[i][h] = a.row_off(f.row(i, h));

  const int ktiles = (K + BK - 1) / BK;
  a.load(0, 0);
  b.load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      a.load((kt + 1) & 1, (kt + 1) * BK);
      b.load((kt + 1) & 1, (kt + 1) * BK);
    }
    cp_async_commit();
    IG_PROBE_ADD(ph_issue);
    cp_async_wait_1();  // every group but the newest has landed
    __syncthreads();
    IG_PROBE_ADD(ph_wait);
    const int8_t* as = a.base(kt & 1);
    const int8_t* bs = b.base(kt & 1);
    const int k0 = kt * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int ko0 = a.k_off(k0, kk + f.tg * 4);
      const int ko1 = a.k_off(k0, kk + f.tg * 4 + 16);
      unsigned af[T::MT][4];
      unsigned bf[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        af[i][0] = ld32(as + roff[i][0] + ko0);
        af[i][1] = ld32(as + roff[i][1] + ko0);
        af[i][2] = ld32(as + roff[i][0] + ko1);
        af[i][3] = ld32(as + roff[i][1] + ko1);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
        b.frag(bs, f.warp_n * T::WN + j * 8 + f.g, kk + f.tg * 4, bf[j][0],
               bf[j][1]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
    __syncthreads();  // the next iteration refills the stage just read
    IG_PROBE_ADD(ph_mma);
  }
#ifdef QTPU_IGEMM_PROBE
  if (phases) {
    phases[0] = ph_issue;
    phases[1] = ph_wait;
    phases[2] = ph_mma;
  }
#endif
#undef IG_PROBE_ADD
  (void)phases;
}

__device__ __forceinline__ void store_one(const Epilogue& ep, int m, int n,
                                          int N, int acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  if (ep.out_kind == OUT_I32) {
    static_cast<int*>(ep.out)[idx] = acc;
    return;
  }
  float t = ep_affine(acc, ep.A[n], ep.B[n]);
  if (ep.res_kind == RES_I8) {
    float r = static_cast<float>(static_cast<const int8_t*>(ep.res)[idx]);
    t = __fadd_rn(t, __fmul_rn(r, ep.C));
  } else if (ep.res_kind == RES_F32) {
    t = __fadd_rn(t, __fmul_rn(static_cast<const float*>(ep.res)[idx], ep.C));
  }
  if (ep.out_kind == OUT_I8) {
    static_cast<int8_t*>(ep.out)[idx] = ep_code(ep, t);
    return;
  }
  static_cast<float*>(ep.out)[idx] = ep_f32(ep, t);
}

#ifdef QTPU_IGEMM_PROBE
// Probe build only (-DQTPU_IGEMM_PROBE, qtpu_torch/ops/probe_k1.py and
// probe_k2.py): thread 0 of every block writes eight int64s — its clock64()
// at the start, once the loaders have resolved their rows, after the main
// loop and after the epilogue's stores were issued, its SM, then the main
// loop's cycles by phase (issue, wait, mma: see mainloop) — to this buffer,
// indexed by the block's linear id.
constexpr int PROBE_STAMPS = 8;
__device__ long long* qtpu_probe_stamps;
#endif

// The plain GEMM: one block per BM x BN output tile, the main loop, then the
// folded epilogue in registers.  W4: the weight is int4 nibble-packed along K
// (StagedB4), K still counts values.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC, class ALoader,
          bool W4>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    igemm_kernel(ALoader al, const int8_t* __restrict__ w, int M, int N,
                 int K, Epilogue ep) {
  typedef TileCfg<BM, BN, WARPS_M, WARPS_N> T;
  typedef typename std::conditional<W4, StagedB4<T, VEC>,
                                    StagedB<T, VEC>>::type BSrc;
  __shared__ __align__(16) int8_t As[2 * T::STAGE_A];
  __shared__ __align__(16) int8_t Bs[2 * BSrc::STAGE];
#ifdef QTPU_IGEMM_PROBE
  const long long t_start = clock64();
#endif
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  StagedA<T, VEC, ALoader> a(al, As, M, K, m0);
  BSrc b(w, Bs, N, K, n0);
  int acc[T::MT][T::NT][4];
#ifdef QTPU_IGEMM_PROBE
  const long long t_setup = clock64();
  long long phases[3] = {0, 0, 0};
  mainloop<T>(a, b, K, acc, phases);
  const long long t_loop = clock64();  // mainloop ends on a block barrier
#else
  mainloop<T>(a, b, K, acc);
#endif

  const Frag<T> f;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + f.row(i, h);
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + f.col(j, e);
          if (n < N) store_one(ep, m, n, N, acc[i][j][2 * h + e]);
        }
      }
    }
  }
#ifdef QTPU_IGEMM_PROBE
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* s = qtpu_probe_stamps +
                   PROBE_STAMPS * (static_cast<size_t>(blockIdx.y) *
                                       gridDim.x + blockIdx.x);
    s[0] = t_start;
    s[1] = t_setup;
    s[2] = t_loop;
    s[3] = clock64();
    s[4] = smid;
    s[5] = phases[0];
    s[6] = phases[1];
    s[7] = phases[2];
  }
#endif
}

// Large tiles while they still give the card about two waves of blocks;
// small or narrow problems take the 64 x 64 tile.
inline bool use_big_tiles(int M, int N) {
  const long big_tiles =
      static_cast<long>((M + 127) / 128) * ((N + 127) / 128);
  return N >= 128 && big_tiles >= 264;
}

template <bool VEC, class ALoader, bool W4 = false>
cudaError_t launch_igemm(const ALoader& al, const int8_t* w, int M, int N,
                         int K, const Epilogue& ep, cudaStream_t stream) {
  if (use_big_tiles(M, N)) {
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    igemm_kernel<128, 128, 2, 4, VEC, ALoader, W4>
        <<<grid, 256, 0, stream>>>(al, w, M, N, K, ep);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    igemm_kernel<64, 64, 2, 2, VEC, ALoader, W4>
        <<<grid, 128, 0, stream>>>(al, w, M, N, K, ep);
  }
  return cudaGetLastError();
}

}  // namespace qtpu
