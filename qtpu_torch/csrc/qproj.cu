// K4: fused projection-block tail (conv3 + downsample), for sm_90a.
//
// Replaces the TPU kernels qtpu/ops/pallas/qproj.py:qproj_fused and
// qproj2d_fused.  A ResNet projection block ends in
//   td  = acc_d * Ad + Bd                 (downsample x_d . wd, dequantized)
//   out = clip(rint(acc_3 * A3 + B3 + td * C), lo, hi) - shift
// with acc_3 = b . w3 (conv3 on conv2's codes b) and x_d the block input
// x at the block's stride.  Unfused, the port runs K1 twice and writes td to
// device memory as f32 (four bytes per element) for conv3's epilogue to read
// back.  Here one tile does both products, and each step is epilogue.cuh's
// in that order (ep_affine, then the f32-residual term t + td * C, each
// rounded on its own), so the codes are bit-identical to that K1 pair.
//
// What bounds it on the H100: counted once, the inputs b and x_d, the
// weights and the int8 output make it memory-bound at ResNet-50's layer1_0
// and layer2_0 (K = Cmid + Cin = 128, 384) and near the int8 tensor-core
// rate at layer3_0-layer4_0 (K = 768, 1536); the fusion removes the f32
// round trip (8 bytes per output element) that the unfused pair pays.
//
// Two kernels, chosen per call by ops/qproj.py: k4_path:
// * qtpu_qproj_fused runs K1's Hopper ring (wgmma_gemm.cuh: TMA loads into
//   a ring of stages, one TMA producer warp, wgmma s8 consumer warpgroups, a
//   persistent grid, a coalesced TMA-stored epilogue) as a two-GEMM tile:
//   the producer streams the downsample's k-stages (x_d rows and wd), then
//   conv3's (b rows and w3) through the one ring; the consumers accumulate
//   the downsample, write td as f32 into a residual tile in shared memory
//   (td_slab: each thread its own accumulator positions), run conv3's
//   wgmmas into the same registers and close with K1's f32-residual
//   epilogue (epilogue_slab<..., OUT_I8, RES_F32>) reading td from there.
//   At stride 2 x_d's stages are TMA im2col loads of a 1x1 window at the
//   stride (K2's ConvX), so no strided copy is made; at stride 1 they are
//   K1's 2D boxes of x.  It takes Cmid and Cin multiples of 64, Cout of 128,
//   16-byte aligned tensors and integer requant grids: every ResNet-50 and
//   ResNet-101 projection block.
// * qtpu_qproj_fused_igemm runs the older igemm.cuh tile: the two mainloops
//   of mma.sync, td held in registers beside the accumulator, one byte
//   store per output (its clock64 probe, ops/probe_k4.py, found the
//   epilogue and the serial mainloops' copy waits taking most of a block).
#include "igemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using qtpu::Epilogue;
namespace wg = qtpu::wg;

// ---- the two-GEMM tile on K1's ring ------------------------------------------

// The consumers' walk over the ring: the slot and parity of the next stage.
struct ConsumerRing {
  uint64_t *full, *empty;
  uint8_t* smem;
  int stages, stage_bytes, s = 0, ph = 0;
};

// n k-stages of wgmmas into acc (zeroed first), each stage freed once its
// wgmmas are done, the last after all of them.
template <int BN, int WGS>
__device__ __forceinline__ void product(int (&acc)[BN / 2], ConsumerRing& r,
                                        int n, int w, int lane) {
  typedef wg::Cfg<BN, WGS, false> S;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int prev = -1;  // the stage whose wgmmas may still run
  for (int kt = 0; kt < n; ++kt) {
    wg::mbar_wait(&r.full[r.s], r.ph);
    uint8_t* st = r.smem + r.s * r.stage_bytes;
    const uint64_t da = wg::desc_sw64(st + w * 64 * wg::BK);
    const uint64_t db = wg::desc_sw64(st + S::A);
    wg::wgmma_fence();
    wg::wgmma_tile<BN>(acc, da, db, 1);
    wg::wgmma_tile<BN>(acc, da + 2, db + 2, 1);  // k + 32: 32 bytes on
    wg::wgmma_commit();
    // the previous stage's wgmmas are done: free it while these run
    wg::wgmma_wait_1();
    if (prev >= 0 && lane == 0) wg::mbar_arrive(&r.empty[prev]);
    prev = r.s;
    if (++r.s == r.stages) {
      r.s = 0;
      r.ph ^= 1;
    }
  }
  wg::wgmma_wait_all();
  if (prev >= 0 && lane == 0) wg::mbar_arrive(&r.empty[prev]);
}

struct ProjParams {
  wg::Params g;  // ep: conv3's requant; K = Cmid; res_off: the td tile;
                 // ab_off: A3, B3, Ad, Bd rows per warpgroup
  const float *Ad, *Bd;
  int Kd;        // Cin
};

template <int BN, int WGS, class XD>
__global__ void __launch_bounds__(wg::Cfg<BN, WGS, false>::NTHREADS,
                                  WGS == 1 ? 3 : 1)
    qproj_wg_kernel(const __grid_constant__ CUtensorMap tm_xd,
                    const __grid_constant__ CUtensorMap tm_wd,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_w3,
                    const __grid_constant__ CUtensorMap tm_out,
                    const __grid_constant__ ProjParams q,
                    const __grid_constant__ XD xl) {
  typedef wg::Cfg<BN, WGS, false> S;
  constexpr int BM = S::BM, NCONS = S::NCONS, BK = wg::BK;
  const wg::Params& p = q.g;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NCONS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int kd = (q.Kd + BK - 1) / BK, k3 = (p.K + BK - 1) / BK;

  if (tid >= NCONS) {  // the producer warp: one thread issues every copy
    if (tid != NCONS) return;
    int s = 0, ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const typename XD::Tile xt = xl.tile(m0);
      for (int kt = 0; kt < kd + k3; ++kt) {
        wg::mbar_wait(&empty[s], ph ^ 1);
        wg::mbar_expect_tx(&full[s], S::TX);
        uint8_t* st = smem + s * p.stage_bytes;
        if (kt < kd) {  // the downsample's stage, then conv3's
          xl.load(st, &tm_xd, &full[s], xt, kt);
          wg::tma_load(st + S::A, &tm_wd, &full[s], kt * BK, n0);
        } else {
          wg::tma_load(st, &tm_b, &full[s], (kt - kd) * BK, m0);
          wg::tma_load(st + S::A, &tm_w3, &full[s], (kt - kd) * BK, n0);
        }
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup w takes rows 64 w .. 64 w + 63 of a tile
  const int w = tid >> 7, tw = tid & 127, lane = tid & 31;
  float* sA = reinterpret_cast<float*>(smem + p.ab_off) + w * 4 * BN;
  float* sB = sA + BN;
  float* sAd = sB + BN;
  float* sBd = sAd + BN;
  uint8_t* td = smem + p.res_off;
  ConsumerRing ring{full, empty, smem, p.stages, p.stage_bytes};
  int ab_n0 = -1;
  for (int tile = blockIdx.x, rt = 0; tile < tiles; tile += gridDim.x, ++rt) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
    int acc[BN / 2];
    product<BN, WGS>(acc, ring, kd, w, lane);
    // the tile column's A3, B3, Ad, Bd rows (the last tile's epilogue has
    // read the old ones: it ends on this warpgroup's barrier)
    if (n0 != ab_n0) {
      for (int i = tw; i < BN; i += 128) {
        const int n = n0 + i;
        const bool in = n < p.N;
        sA[i] = in ? p.ep.A[n] : 0.f;
        sB[i] = in ? p.ep.B[n] : 0.f;
        sAd[i] = in ? q.Ad[n] : 0.f;
        sBd[i] = in ? q.Bd[n] : 0.f;
      }
      ab_n0 = n0;
    }
    wg::named_bar(1 + w, 128);
    wg::td_slab<BN, BM>(acc, sAd, sBd, td, w, tw);
    product<BN, WGS>(acc, ring, k3, w, lane);
    // the output buffer's last store has read it
    if (tw == 0) {
      if (p.nc == 2)
        wg::bulk_wait_read<1>();
      else
        wg::bulk_wait_read<0>();
    }
    wg::named_bar(1 + w, 128);
    uint8_t* cs = smem + p.c_off + (w * p.nc + rt % p.nc) * p.c_bytes;
    wg::epilogue_slab<BN, BM, qtpu::OUT_I8, qtpu::RES_F32>(
        acc, p, &tm_out, sA, sB, td, cs, w, m0, n0, tw);
  }
  if (tw == 0) wg::bulk_wait_all();
}

// The shared-memory plan of a call: as many blocks per SM as the tiles fill
// and shared memory holds with a ring of at least MIN_STAGES stages each;
// two output slabs per warpgroup where they fit.  One td tile (BM x BN f32)
// a block: each thread reads back its own positions before it writes the
// next tile's.
template <int BN, int WGS>
bool plan_proj(wg::Params& p, long tiles, int sms, int& smem, int& per_sm) {
  typedef wg::Cfg<BN, WGS, false> S;
  const int ab = WGS * 4 * BN * 4;
  const int bars = 2 * wg::MAX_STAGES * 8;
  p.c_bytes = 64 * BN;
  p.res_bytes = S::BM * BN * 4;
  p.nres = 1;
  const long waves = (tiles + sms - 1) / sms;
  for (per_sm = waves < 6 ? static_cast<int>(waves) : 6; per_sm >= 1;
       --per_sm) {
    int budget = wg::SMEM_SM / per_sm - 1024;
    if (budget > wg::SMEM_BLOCK_MAX) budget = wg::SMEM_BLOCK_MAX;
    for (int nc = 2; nc >= 1; --nc) {
      const int fixed = 1024 + WGS * nc * p.c_bytes + p.res_bytes + ab + bars;
      int stages = (budget - fixed) / S::STAGE;
      if (stages > wg::MAX_STAGES) stages = wg::MAX_STAGES;
      if (stages < wg::MIN_STAGES) continue;
      p.stages = stages;
      p.nc = nc;
      p.stage_bytes = S::STAGE;
      p.c_off = stages * S::STAGE;
      p.res_off = p.c_off + WGS * nc * p.c_bytes;
      p.ab_off = p.res_off + p.res_bytes;
      p.bar_off = p.ab_off + ab;
      smem = 1024 + p.bar_off + 2 * stages * 8;
      return true;
    }
  }
  return false;
}

template <int BN, int WGS, class XD>
cudaError_t launch_proj(const XD& xl, const int8_t* b, const int8_t* w3,
                        const int8_t* wd, int M, int N, int Kmid, int Kin,
                        const Epilogue& ep, const float* Ad, const float* Bd,
                        int sms, cudaStream_t stream) {
  typedef wg::Cfg<BN, WGS, false> S;
  CUtensorMap txd{}, twd{}, tb{}, tw3{}, to{};
  const CUtensorMapSwizzle SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  const int ospan = BN < 128 ? BN : 128;
  if (!(xl.encode(&txd, S::BM) &&
        wg::byte_map(&twd, wd, N, Kin, wg::BK, BN, SW64) &&
        wg::byte_map(&tb, b, M, Kmid, wg::BK, S::BM, SW64) &&
        wg::byte_map(&tw3, w3, N, Kmid, wg::BK, BN, SW64) &&
        wg::byte_map(&to, ep.out, M, N, ospan, 64, wg::swizzle_of(ospan))))
    return cudaErrorInvalidValue;
  ProjParams q;
  q.g.ep = ep;
  q.g.M = M;
  q.g.N = N;
  q.g.K = Kmid;
  q.Ad = Ad;
  q.Bd = Bd;
  q.Kd = Kin;
  const long tiles =
      static_cast<long>((M + S::BM - 1) / S::BM) * ((N + BN - 1) / BN);
  int smem = 0, per_sm = 0;
  if (!plan_proj<BN, WGS>(q.g, tiles, sms, smem, per_sm))
    return cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                 CUtensorMap, ProjParams, XD) = qproj_wg_kernel<BN, WGS, XD>;
  // the opt-in above 48 KB is an attribute of the current device: set at
  // every launch, so that any device of a process takes the kernel
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return e;
  int fit = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                    S::NTHREADS, smem);
  if (e != cudaSuccess) return e;
  if (fit < per_sm) per_sm = fit > 0 ? fit : 1;
  const long slots = static_cast<long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, S::NTHREADS, smem, stream>>>(txd, twd, tb, tw3, to, q, xl);
  return cudaGetLastError();
}

// The tile shape, as K1's launch_tiles chooses it with K = Cin + Cmid: BN
// 64 where 128-wide tiles would leave SMs idle (layer4_0 at a small batch);
// two warpgroups (128-row tiles sharing each w stage) where K is long and
// the card still gets two tiles per SM; one otherwise.
template <class XD>
cudaError_t launch_proj_tiles(const XD& xl, const int8_t* b,
                              const int8_t* w3, const int8_t* wd, int M,
                              int N, int Kmid, int Kin, const Epilogue& ep,
                              const float* Ad, const float* Bd,
                              cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long n128 = (N + 127) / 128;
  if ((M + 63) / 64 * n128 < sms)
    return launch_proj<64, 1>(xl, b, w3, wd, M, N, Kmid, Kin, ep, Ad, Bd,
                              sms, stream);
  if (Kin + Kmid >= 512 && (M + 127) / 128 * n128 >= 2 * sms)
    return launch_proj<128, 2>(xl, b, w3, wd, M, N, Kmid, Kin, ep, Ad, Bd,
                               sms, stream);
  return launch_proj<128, 1>(xl, b, w3, wd, M, N, Kmid, Kin, ep, Ad, Bd,
                             sms, stream);
}

// ---- the older kernel: igemm.cuh's mma.sync tile -----------------------------

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

#ifdef QTPU_PROJ_PROBE
// Probe build only (-DQTPU_PROJ_PROBE -DQTPU_IGEMM_PROBE, ops/probe_k4.py):
// thread 0 of each block (one output tile) writes its clock64() cycles by
// phase — [0] the downsample mainloop's copies (issue and wait), [1] its
// mma.sync, [2] td's dequant, [3] conv3's copies, [4] its mma.sync, [5] the
// epilogue (requant and byte stores), [6] the block's total — and [7] its
// SM id.
__device__ long long* qtpu_proj_probe;
#endif

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
#ifdef QTPU_PROJ_PROBE
  long long lp[3] = {0, 0, 0}, pr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t0 = clock64();
  long long t = t0;
#define PROJ_PROBE(i)               \
  {                                 \
    const long long c = clock64();  \
    pr[i] += c - t;                 \
    t = c;                          \
  }
#else
  long long* lp = nullptr;
#define PROJ_PROBE(i)
#endif
  {
    qtpu::StagedA<T, true, StridedRows> a(xl, As, M, Kin, m0);
    qtpu::StagedB<T, true> b(wd, Bs, N, Kin, n0);
    qtpu::mainloop<T>(a, b, Kin, acc, lp);
  }
#ifdef QTPU_PROJ_PROBE
  t = clock64();
  pr[0] = lp[0] + lp[1];
  pr[1] = lp[2];
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
          td[i][j][2 * h + e] =
              qtpu::ep_affine(acc[i][j][2 * h + e], p.Ad[n], p.Bd[n]);
        }
  PROJ_PROBE(2);
  {
    qtpu::StagedA<T, true, MidRows> a(bl, As, M, Kmid, m0);
    qtpu::StagedB<T, true> b(w3, Bs, N, Kmid, n0);
    qtpu::mainloop<T>(a, b, Kmid, acc, lp);
  }
#ifdef QTPU_PROJ_PROBE
  t = clock64();
  pr[3] = lp[0] + lp[1];
  pr[4] = lp[2];
#endif
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
          float v = qtpu::ep_affine(acc[i][j][2 * h + e], p.A3[n], p.B3[n]);
          v = __fadd_rn(v, __fmul_rn(td[i][j][2 * h + e], p.C));
          p.out[static_cast<size_t>(m) * N + n] =
              qtpu::ep_code(v, p.lo, p.hi, p.shift);
        }
      }
    }
  }
#ifdef QTPU_PROJ_PROBE
  PROJ_PROBE(5);
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
    pr[6] = clock64() - t0;
    pr[7] = smid;
    long long* dst = qtpu_proj_probe +
                     8 * (static_cast<size_t>(blockIdx.y) * gridDim.x +
                          blockIdx.x);
    for (int i = 0; i < 8; ++i) dst[i] = pr[i];
  }
#endif
#undef PROJ_PROBE
  (void)lp;
}

}  // namespace

// b: int8 (Bn, H, W, Cmid); x: int8 (Bn, Hx, Wx, Cin), read at `stride`;
// w3: (Cout, Cmid), wd: (Cout, Cin); out: int8 (Bn, H, W, Cout).  The
// wgmma entry takes Cmid and Cin multiples of 64, Cout of 128, 16-byte
// aligned tensors and an integer requant grid (the wrapper's k4_path); the
// igemm entry Cmid and Cin multiples of 16.
#define K4_ARGS                                                              \
  const void *b, const void *x, const void *w3, const void *wd,             \
      const void *A3, const void *B3, const void *Ad, const void *Bd,       \
      void *out, int Bn, int H, int W, int Hx, int Wx, int stride, int Cmid, \
      int Cin, int Cout, float C, float lo, float hi, float shift,           \
      void *stream

extern "C" int qtpu_qproj_fused(K4_ARGS) {
  const int M = Bn * H * W;
  const Epilogue ep = qtpu::make_epilogue(
      static_cast<const float*>(A3), static_cast<const float*>(B3), nullptr,
      qtpu::RES_F32, out, qtpu::OUT_I8, C, lo, hi, shift, 0, 0, 0.f);
  if (!qtpu::int_grid(ep) || Cmid % 64 || Cin % 64 || Cout % 128 ||
      (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* bs = static_cast<const int8_t*>(b);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* w3s = static_cast<const int8_t*>(w3);
  const int8_t* wds = static_cast<const int8_t*>(wd);
  const float* ad = static_cast<const float*>(Ad);
  const float* bd = static_cast<const float*>(Bd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    return static_cast<int>(launch_proj_tiles(wg::GemmX{xs, M, Cin}, bs, w3s,
                                              wds, M, Cout, Cmid, Cin, ep,
                                              ad, bd, s));
  // the 1x1 window at stride 2, no pads: K2's im2col stages
  const wg::ConvX xl{xs, nullptr,
                     wg::ConvShape{Bn, Hx, Wx, Cin, Cout, 1, 1, stride, 0, 0,
                                   H, W, 0, nullptr}};
  return static_cast<int>(launch_proj_tiles(xl, bs, w3s, wds, M, Cout, Cmid,
                                            Cin, ep, ad, bd, s));
}

extern "C" int qtpu_qproj_fused_igemm(K4_ARGS) {
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

#ifdef QTPU_PROJ_PROBE
// Probe build only: where the older kernel writes its cycles by phase.
extern "C" int qtpu_proj_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qtpu_proj_probe, &buf, sizeof(buf)));
}
#endif
