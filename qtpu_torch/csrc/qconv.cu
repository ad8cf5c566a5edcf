// K2: fused int8 convolution (implicit GEMM, stride 1 or 2), for sm_90a.
//
// Replaces the TPU kernels qtpu/ops/pallas/qconv.py:qconv2d_fused and, at
// stride 2, qtpu/ops/pallas/qconv_dispatch.py:qconv2d_strided.  Output pixel
// m = (b, oh, ow) and reduction index k = (kh, kw, ci) make the conv a GEMM
// with
//   A[m, k] = xpad[b, oh*s + kh, ow*s + kw, ci]
// against the int8 weight (Co, KH*KW*Ci), stored so once at engine build,
// where xpad is the int8 NHWC input padded with the activation zero point
// zp.  On the TPU the strided conv was split into four stride-1 phase convs
// (a Mosaic limit); here the stride is an address computation.  The epilogue
// modes are those of K1: requant to int8 codes, f32 with relu / act_max, an
// optional int8 or f32 residual (B, OH, OW, Co), or the raw int32 sum.
//
// What bounds it on the H100: counted once, a ResNet-50 3x3 at 64..512
// channels does 2*9*Ci operations per output element against its input and
// output bytes, which puts the wide ones near the int8 tensor-core peak and
// the 64-channel ones on the memory side.  The old loop (igemm.cuh, probed
// by ops/probe_k2.py) spent 36-57% of a block computing gather addresses
// (a division by Ci and KW per 16-byte chunk) and a quarter to a third in
// its element-wise epilogue, on an input the wrapper had first copied with
// its zero-point pads.  Four kernels, chosen per call by ops/qconv.py's
// k2_path from the operands:
//
// * qtpu_qconv2d_fused: K1's Hopper loop (wgmma_gemm.cuh: TMA ring, wgmma s8,
//   persistent grid, TMA-stored epilogue) with ConvX as its x-stage policy,
//   for Ci % 64 == 0 (every ResNet-50 3x3).  The producer loads stage kt =
//   (tap, 64-channel chunk) as one TMA im2col load: the chunk of tap (kh, kw)
//   for the tile's BM consecutive output pixels, walking rows and images
//   inside the bounding box of window corners at the conv's stride, so no
//   address arithmetic runs per element and the M tile and the (M, Co)
//   output store stay K1's.  The input is unpadded: TMA fills taps outside
//   the image with 0, and the epilogue adds the exact integer correction
//     acc += zp * sum_{taps (kh, kw) outside the image} tapsum[kh, kw, co]
//   (tapsum[kh, kw, co] = sum_ci w[co, kh, kw, ci], prepared once per node)
//   on the rows whose window leaves the image (ConvX::fix).
// * qtpu_qconv2d_fused_stem: Ci = 3 (the quantized 3x3/2 and 7x7/2 stems).
//   A persistent block takes a band of output rows of one image, copies the
//   input rows the band needs into shared memory with 16-byte cp.async, zp
//   written at the pads, builds each mma.sync A fragment straight from those
//   rows through a table of patch offsets (K = KH*KW*3 padded to Kpad, a
//   multiple of 32; the weight, zero past K, and A/B stay in shared memory
//   for the whole grid) and writes int8 codes into a swizzled shared tile
//   that one TMA store per output row copies out.  Each input byte is read
//   from device memory about once.
// * qtpu_qconv2d_fused_small (and _small_sync / _small_wg, its multiply
//   forced): the stem kernel generalised to Ci*KH*KW <= 320 — LeNet-5's
//   convs, ResNet-20's 16- and 32-channel 3x3s, the Ci = 3 stems with f32
//   or raw output — with any even Co up to 128 and every epilogue mode
//   (small_kernel below).
// * qtpu_qconv2d_fused_igemm: the old mma.sync loop (igemm.cuh) on the
//   zero-point-padded input, for the rest (Ci*KH*KW > 320 with Ci not a
//   multiple of 64, unaligned views, non-integer requant grids).
//
// The entries take the same arguments: the unpadded input (B, H, W,
// Ci) with its top and left pads (the bottom and right ones follow from
// OH, OW) and the pad code — the igemm entry takes a padded input with
// pads 0.  The pad code is zp, or, where the nullable zp_dev is given, the
// int32 it points to in device memory (the QAT step computes it on the
// card and no host reads it): each block of the stem and small kernels
// loads it once before its bands, the implicit GEMM once a tile in its
// border repair.
#include "igemm.cuh"
#include "wgmma_narrow.cuh"

namespace {

// ---- the old loop's A loader (prepadded input) ------------------------------

struct ConvLoader {
  const int8_t* x;
  int Hp, Wp, Ci, KW, OH, OW, stride;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    const int ow = m % OW;
    const int t = m / OW;
    const int oh = t % OH;
    const int b = t / OH;
    return x + ((static_cast<size_t>(b) * Hp + oh * stride) * Wp +
                ow * stride) * Ci;
  }
  __device__ __forceinline__ const int8_t* ptr(Row r, int k) const {
    const int tap = k / Ci;
    const int ci = k - tap * Ci;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    return r + (static_cast<size_t>(kh) * Wp + kw) * Ci + ci;
  }
  __device__ __forceinline__ const int8_t* base() const { return x; }
};

using qtpu::wg::ConvShape;
using qtpu::wg::ConvX;

// ---- the stem kernel (Ci = 3) ------------------------------------------------

constexpr int STEM_THREADS = 256;  // eight warps
constexpr int STEM_SMEM_MAX = 96 * 1024;

#ifdef QTPU_STEM_PROBE
// Probe build only (-DQTPU_STEM_PROBE, ops/probe_k2.py): per block,
// clock64() cycles of thread 0 summed by phase — [0] staging the band's
// input rows (copies issued and landed, the previous band's stores done
// reading the output tile, the barrier), [1] the A fragments and mma.sync,
// [2] the requant into the output tile and the barrier, [3] issuing the TMA
// stores — and [7] the block's bands.
__device__ long long* qtpu_stem_probe;
#define STEM_PROBE_ADD(i)            \
  {                                  \
    const long long t = clock64();   \
    probe[i] += t - probe_t;         \
    probe_t = t;                     \
  }
#else
#define STEM_PROBE_ADD(i)
#endif

struct StemParams {
  qtpu::Epilogue ep;
  const int8_t* x;
  const int8_t* w;
  ConvShape s;
  int K, Kpad, SW;  // patch depth, padded to 32; weight row stride in smem
  int TH, bands_per_image, bands;
  int lead, Ls;     // a staged row: lead bytes, then pixel -pl..; its stride
  int orb;          // bytes of one output row's shared tile (1024-aligned)
  int in_off, w_off, koff_off, ab_off;
};

// SPAN: Co bytes (16, 32, 64 or 128), the swizzle span of the output tile.
template <int SPAN>
__global__ void __launch_bounds__(STEM_THREADS)
    stem_kernel(const __grid_constant__ CUtensorMap tm_out,
                const __grid_constant__ StemParams p) {
  using qtpu::wg::swz;
  constexpr int CO = SPAN;
  constexpr int NT = CO / 8;  // n8 tiles of mma.sync
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out_tile = smem;
  uint8_t* in = smem + p.in_off;
  int8_t* ws = reinterpret_cast<int8_t*>(smem + p.w_off);
  int* koff = reinterpret_cast<int*>(smem + p.koff_off);
  float* sA = reinterpret_cast<float*>(smem + p.ab_off);
  float* sB = sA + CO;
  const ConvShape& s = p.s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
#ifdef QTPU_STEM_PROBE
  long long probe[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long probe_t = clock64();
#endif

  // resident for the whole grid: the weight (zero past K), the patch offset
  // of each k (kh rows down, kw*3 + ci along a staged row; k >= K reads the
  // row's byte 0 against a zero weight), A and B
  for (int i = tid; i < CO * p.Kpad; i += STEM_THREADS) {
    const int n = i / p.Kpad, k = i - n * p.Kpad;
    ws[n * p.SW + k] = k < p.K ? p.w[static_cast<size_t>(n) * p.K + k] : 0;
  }
  for (int k = tid; k < p.Kpad; k += STEM_THREADS) {
    const int kh = k / (s.KW * 3);
    koff[k] = k < p.K ? kh * p.Ls + (k - kh * s.KW * 3) : 0;
  }
  for (int i = tid; i < CO; i += STEM_THREADS) {
    sA[i] = p.ep.A[i];
    sB[i] = p.ep.B[i];
  }
  const unsigned zw =
      (static_cast<unsigned>(qtpu::wg::pad_code(s)) & 0xffu) * 0x01010101u;
  const uint4 zq = make_uint4(zw, zw, zw, zw);
  const unsigned flip = p.ep.shift != 0.f ? 0x8080u : 0u;
  const int row_bytes = s.W * 3;         // a multiple of 16
  const int dstart = p.lead + s.pl * 3;  // input column 0, 16-aligned
  const int chunks = p.Ls / 16;

  for (int band = blockIdx.x; band < p.bands; band += gridDim.x) {
    const int b = band / p.bands_per_image;
    const int oh0 = (band - b * p.bands_per_image) * p.TH;
    const int rows = s.OH - oh0 < p.TH ? s.OH - oh0 : p.TH;
    const int R = (rows - 1) * s.stride + s.KH;
    const int ih0 = oh0 * s.stride - s.pt;
    const int8_t* xb = p.x + static_cast<size_t>(b) * s.H * row_bytes;
    // 1. the band's input rows, zp at the pads (every 16-byte chunk is all
    //    image or all pad: the image part starts 16-aligned, W*3 % 16 == 0)
    for (int i = tid; i < R * chunks; i += STEM_THREADS) {
      const int r = i / chunks, c = i - r * chunks;
      const int ih = ih0 + r, off = 16 * c - dstart;
      uint8_t* dst = in + r * p.Ls + 16 * c;
      if (ih >= 0 && ih < s.H && off >= 0 && off < row_bytes)
        qtpu::cp_async16(dst, xb + static_cast<size_t>(ih) * row_bytes + off,
                         true);
      else
        *reinterpret_cast<uint4*>(dst) = zq;
    }
    qtpu::cp_async_wait_all();
    if (tid == 0) qtpu::wg::bulk_wait_read<0>();  // last band's stores
    __syncthreads();
    STEM_PROBE_ADD(0);

    // 2. per m16 tile of the band's rows * OW pixels: the A fragment from
    //    the staged rows, mma.sync against the resident weight, the requant
    //    into the output tile
    const int P = rows * s.OW;
    for (int mt = warp; mt * 16 < P; mt += STEM_THREADS / 32) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int pix = mt * 16 + g + 8 * h;
        if (pix >= P) pix = P - 1;  // computed, never stored
        const int r = pix / s.OW, ow = pix - r * s.OW;
        base[h] = r * s.stride * p.Ls + p.lead + ow * s.stride * 3;
      }
      int acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      for (int k0 = 0; k0 < p.Kpad; k0 += 32) {
        unsigned a[4];  // rows g, g + 8 at k .. k+3, then at k+16 .. k+19
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + tg * 4 + (q >> 1) * 16;
          const uint8_t* src = in + base[q & 1];
          unsigned v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v |= static_cast<unsigned>(src[koff[k + e]]) << (8 * e);
          a[q] = v;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* wp = ws + (8 * j + g) * p.SW + k0 + tg * 4;
          qtpu::mma_s8(acc[j], a[0], a[1], a[2], a[3], qtpu::ld32(wp),
                       qtpu::ld32(wp + 16));
        }
      }
      STEM_PROBE_ADD(1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = mt * 16 + g + 8 * h;
        if (pix >= P) continue;
        const int r = pix / s.OW, ow = pix - r * s.OW;
        uint8_t* row = out_tile + r * p.orb;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * tg;
          const float t0 = qtpu::ep_affine(acc[j][2 * h], sA[c], sB[c]);
          const float t1 =
              qtpu::ep_affine(acc[j][2 * h + 1], sA[c + 1], sB[c + 1]);
          *reinterpret_cast<unsigned short*>(row + swz<SPAN>(ow * CO + c)) =
              static_cast<unsigned short>(
                  __byte_perm(qtpu::code_bits(p.ep, t0),
                              qtpu::code_bits(p.ep, t1), 0x0040) ^
                  flip);
        }
      }
      STEM_PROBE_ADD(2);
    }
    qtpu::wg::fence_async_smem();
    __syncthreads();
    STEM_PROBE_ADD(2);
    // 3. one TMA store per output row of the band: the rows (b, oh, :) of
    //    the (M, Co) output are consecutive
    if (tid == 0) {
      const int m0 = (b * s.OH + oh0) * s.OW;
      for (int r = 0; r < rows; ++r)
        qtpu::wg::tma_store(&tm_out, out_tile + r * p.orb, 0, m0 + r * s.OW);
      qtpu::wg::bulk_commit();
    }
    STEM_PROBE_ADD(3);
#ifdef QTPU_STEM_PROBE
    ++probe[7];
#endif
  }
  if (tid == 0) qtpu::wg::bulk_wait_all();
#ifdef QTPU_STEM_PROBE
  if (tid == 0)
    for (int i = 0; i < 8; ++i) qtpu_stem_probe[8 * blockIdx.x + i] = probe[i];
#endif
}

template <int SPAN>
cudaError_t launch_stem(const int8_t* x, const int8_t* w, const ConvShape& s,
                        const qtpu::Epilogue& ep, cudaStream_t stream) {
  StemParams p;
  p.ep = ep;
  p.x = x;
  p.w = w;
  p.s = s;
  p.K = s.KH * s.KW * 3;
  p.Kpad = (p.K + 31) / 32 * 32;
  p.SW = p.Kpad + 16;  // a warp's fragment loads on distinct banks
  p.lead = (16 - (s.pl * 3) % 16) % 16;
  p.Ls = (p.lead + ((s.OW - 1) * s.stride + s.KW) * 3 + 15) / 16 * 16;
  p.orb = (s.OW * SPAN + 1023) / 1024 * 1024;
  // output rows per band: few input rows staged twice, and small enough
  // for several blocks an SM
  int smem = 0, th = 0;
  for (int t = s.KH <= 3 ? 4 : 2; t >= 1 && !th; --t) {
    const int cand = t < s.OH ? t : s.OH;
    p.in_off = cand * p.orb;
    p.w_off = p.in_off + ((cand - 1) * s.stride + s.KH) * p.Ls;
    p.koff_off = (p.w_off + SPAN * p.SW + 15) / 16 * 16;
    p.ab_off = p.koff_off + 4 * p.Kpad;
    smem = 1024 + p.ab_off + 8 * SPAN;
    if (smem <= STEM_SMEM_MAX) th = cand;
  }
  if (!th) return cudaErrorInvalidValue;
  p.TH = th;
  p.bands_per_image = (s.OH + th - 1) / th;
  p.bands = s.Bn * p.bands_per_image;
  CUtensorMap to{};
  if (!qtpu::wg::byte_map(&to, ep.out,
                          static_cast<uint64_t>(s.Bn) * s.OH * s.OW, SPAN,
                          SPAN, s.OW, qtpu::wg::swizzle_of(SPAN)))
    return cudaErrorInvalidValue;
  static bool attr[qtpu::wg::MAX_DEVICES] = {};  // per device
  const cudaError_t e =
      qtpu::wg::opt_in_smem(stem_kernel<SPAN>, STEM_SMEM_MAX, attr);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel<SPAN>,
                                                STEM_THREADS, smem);
  const long slots =
      static_cast<long>(qtpu::wg::num_sms()) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(p.bands < slots ? p.bands : slots);
  stem_kernel<SPAN><<<grid, STEM_THREADS, smem, stream>>>(to, p);
  return cudaGetLastError();
}

// ---- the small-channel kernel (Ci·KH·KW <= 320, Ci not a multiple of 64) ------
//
// The stem kernel generalised to any Ci, Co <= 128 and every epilogue mode.
// A persistent block takes a band of TH output rows of one image:
// 1. it copies the input rows the band needs into shared memory (cp.async
//    chunks of 16, 8 or 4 bytes as W·Ci and the base allow, else bytes),
//    writing zp at the pads itself — no padded copy of the input — and the
//    band's residual, which is one contiguous run of (B, OH, OW, Co);
// 2. each warp builds mma A fragments of 16 output pixels straight from those
//    rows through a table of patch offsets (k = (kh, kw, ci), K padded to a
//    multiple of 32; 4-byte loads where Ci % 4 == 0, else byte gathers) and
//    multiplies them by the weight, resident in shared memory for the whole
//    grid as 64-byte-swizzled K-major tiles of COP = Co rounded up to 8, 16,
//    32, 64 or 128 rows (zero past K and Co): by wgmma with A from
//    registers (a warpgroup, 64 pixels) or by mma.sync m16n8k32 (a warp, 16
//    pixels), WG below;
// 3. the epilogue (ep_pair, code_pair / ep_f32, as K1's) writes the band's
//    output, also one contiguous run, into shared memory, and the block
//    copies it out in 16-, 8-, 4-, 2- or 1-byte chunks.
// Each input byte crosses device memory about once ((TH - 1)·s + KH rows
// for TH output rows), and no address is divided per element.

constexpr int SMALL_THREADS = 256;  // eight warps, two warpgroups
constexpr int SMALL_KMAX = 320;     // Ci·KH·KW, padded to a multiple of 32
constexpr int SMALL_KS = SMALL_KMAX / 32;
constexpr int SMALL_SMEM_MAX = 96 * 1024;

struct SmallParams {
  qtpu::Epilogue ep;
  const int8_t* x;
  const int8_t* w;
  ConvShape s;
  int K, Kpad;      // patch depth, padded to 32
  int TH, bands_per_image, bands;
  int lead, Ls;     // a staged row: lead bytes, then pixel -pl..; its stride
  int ich, och, rch;  // chunk bytes: input rows, output run, residual run
  int wch;            // chunk bytes of the weight's rows: 16, 4 or 1
  int res_off, in_off, w_off, koff_off, ab_off;  // the output run at 0
};

// The epilogue of one output pixel's accumulators (row h of the fragment)
// into the band's output run `ot` (pixel pix, Co channels a pixel), the
// residual from the band's run `rt`.
template <int COP>
__device__ __forceinline__ void small_store(const int (&acc)[COP / 2], int h,
                                            int pix, int tg,
                                            const SmallParams& p,
                                            const float* sA, const float* sB,
                                            const uint8_t* rt, uint8_t* ot,
                                            unsigned flip) {
  const int Co = p.s.Co, ok = p.ep.out_kind, rk = p.ep.res_kind;
#pragma unroll
  for (int j = 0; j < COP / 8; ++j) {
    const int c = 8 * j + 2 * tg;  // Co is even: c < Co covers c + 1
    if (c >= Co) continue;
    const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
    const int e = pix * Co + c;
    if (ok == qtpu::OUT_I32) {
      *reinterpret_cast<int2*>(ot + 4 * e) = make_int2(v0, v1);
      continue;
    }
    const float2 a = make_float2(sA[c], sA[c + 1]);
    const float2 b = make_float2(sB[c], sB[c + 1]);
    float2 t;
    if (rk == qtpu::RES_I8) {
      t = qtpu::ep_pair<true>(
          p.ep, v0, v1, a, b,
          qtpu::residual_pair(
              *reinterpret_cast<const unsigned short*>(rt + e)));
    } else if (rk == qtpu::RES_F32) {
      t = qtpu::ep_pair<true>(p.ep, v0, v1, a, b,
                              *reinterpret_cast<const float2*>(rt + 4 * e));
    } else {
      t = qtpu::ep_pair<false>(p.ep, v0, v1, a, b, make_float2(0.f, 0.f));
    }
    if (ok == qtpu::OUT_I8)
      *reinterpret_cast<unsigned short*>(ot + e) =
          qtpu::code_pair(p.ep, t, flip);
    else
      *reinterpret_cast<float2*>(ot + 4 * e) =
          make_float2(qtpu::ep_f32(p.ep, t.x), qtpu::ep_f32(p.ep, t.y));
  }
}

// The A register q (0..3) of row h = q & 1 at k-step ks: k = 32 ks + 4 tg
// (+ 16 for q >= 2), from the staged rows at `src` (the pixel's window).
template <bool VEC4>
__device__ __forceinline__ unsigned small_a(const uint8_t* src,
                                            const int* koff, int k) {
  if (VEC4) return *reinterpret_cast<const unsigned*>(src + koff[k]);
  unsigned v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v |= static_cast<unsigned>(src[koff[k + e]]) << (8 * e);
  return v;
}

template <int COP, bool WG, bool VEC4>
__global__ void __launch_bounds__(SMALL_THREADS)
    small_kernel(const __grid_constant__ SmallParams p) {
  using qtpu::wg::swz;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ot = smem;
  uint8_t* rt = smem + p.res_off;
  uint8_t* in = smem + p.in_off;
  int8_t* ws = reinterpret_cast<int8_t*>(smem + p.w_off);
  int* koff = reinterpret_cast<int*>(smem + p.koff_off);
  float* sA = reinterpret_cast<float*>(smem + p.ab_off);
  float* sB = sA + COP;
  const ConvShape& s = p.s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ok = p.ep.out_kind, rk = p.ep.res_kind;
  const int osize = ok == qtpu::OUT_I8 ? 1 : 4;
  const int rsize = rk == qtpu::RES_F32 ? 4 : 1;
  const int nks = p.Kpad / 32;
  const int nch = (p.Kpad + 63) / 64;  // 64-byte weight tiles

  // resident for the whole grid: the weight as nch (COP x 64) K-major tiles
  // under the 64-byte swizzle, zero past K and Co; the patch offset of each
  // k (kh rows down, kw·Ci + ci along a staged row; k >= K reads the row's
  // byte 0 against a zero weight); A and B
  {
    const int wch = p.wch, per_row = 64 / wch;  // chunks of a 64-byte row
    for (int i = tid; i < nch * COP * per_row; i += SMALL_THREADS) {
      const int c = i / (COP * per_row), r = i - c * COP * per_row;
      const int n = r / per_row, kk = (r - n * per_row) * wch;
      const int k = c * 64 + kk;
      const bool in = n < s.Co && k < p.K;  // K % wch == 0
      const int8_t* src = p.w + static_cast<size_t>(n) * p.K + k;
      int8_t* dst = ws + c * COP * 64 + swz<64>(n * 64 + kk);
      if (wch == 16)
        *reinterpret_cast<uint4*>(dst) =
            in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      else if (wch == 4)
        *reinterpret_cast<unsigned*>(dst) =
            in ? *reinterpret_cast<const unsigned*>(src) : 0u;
      else
        *dst = in ? *src : static_cast<int8_t>(0);
    }
  }
  for (int k = tid; k < p.Kpad; k += SMALL_THREADS) {
    const int tap = k / s.Ci, kh = tap / s.KW;
    koff[k] = k < p.K ? kh * p.Ls + (tap - kh * s.KW) * s.Ci + (k - tap * s.Ci)
                      : 0;
  }
  if (ok != qtpu::OUT_I32)
    for (int i = tid; i < COP; i += SMALL_THREADS) {
      sA[i] = i < s.Co ? p.ep.A[i] : 0.f;
      sB[i] = i < s.Co ? p.ep.B[i] : 0.f;
    }
  if constexpr (WG) qtpu::wg::fence_async_smem();  // to wgmma's proxy
  __syncthreads();

  const unsigned zw =
      (static_cast<unsigned>(qtpu::wg::pad_code(s)) & 0xffu) * 0x01010101u;
  const unsigned flip = p.ep.shift != 0.f ? 0x8080u : 0u;
  const int row_bytes = s.W * s.Ci;
  const int dstart = p.lead + s.pl * s.Ci;  // input column 0, ich-aligned
  const int chunks = p.Ls / p.ich;

  for (int band = blockIdx.x; band < p.bands; band += gridDim.x) {
    const int b = band / p.bands_per_image;
    const int oh0 = (band - b * p.bands_per_image) * p.TH;
    const int rows = s.OH - oh0 < p.TH ? s.OH - oh0 : p.TH;
    const int R = (rows - 1) * s.stride + s.KH;
    const int ih0 = oh0 * s.stride - s.pt;
    const int P = rows * s.OW;
    const size_t m0 = (static_cast<size_t>(b) * s.OH + oh0) * s.OW;
    const int8_t* xb = p.x + static_cast<size_t>(b) * s.H * row_bytes;
    // 1. the band's input rows, zp at the pads (every chunk is all image or
    //    all pad: the image part starts ich-aligned, W·Ci % ich == 0), and
    //    its residual run
    for (int i = tid; i < R * chunks; i += SMALL_THREADS) {
      const int r = i / chunks, c = i - r * chunks;
      const int ih = ih0 + r, off = p.ich * c - dstart;
      uint8_t* dst = in + r * p.Ls + p.ich * c;
      const bool img = ih >= 0 && ih < s.H && off >= 0 && off < row_bytes;
      const int8_t* src = xb + static_cast<size_t>(ih) * row_bytes + off;
      if (p.ich >= 4) {
        if (img) {
          qtpu::wg::cp_async_chunk(dst, src, p.ich, true);
        } else if (p.ich == 16) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(zw, zw, zw, zw);
        } else if (p.ich == 8) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(zw, zw);
        } else {
          *reinterpret_cast<unsigned*>(dst) = zw;
        }
      } else {
        for (int e = 0; e < p.ich; ++e)
          dst[e] = img ? static_cast<uint8_t>(src[e])
                       : static_cast<uint8_t>(zw);
      }
    }
    if (rk != qtpu::RES_NONE) {
      const int nb = P * s.Co * rsize;
      const uint8_t* src = static_cast<const uint8_t*>(p.ep.res) +
                           m0 * s.Co * rsize;
      for (int i = tid * p.rch; i < nb; i += SMALL_THREADS * p.rch) {
        if (p.rch >= 4)
          qtpu::wg::cp_async_chunk(rt + i, src + i, p.rch, true);
        else
          qtpu::wg::copy_chunk(rt + i, src + i, p.rch);
      }
    }
    qtpu::cp_async_wait_all();
    __syncthreads();

    // 2. the accumulators of the band's P pixels, then the epilogue
    if constexpr (WG) {
      const int wl = warp & 3;  // the warp's 16 rows of its warpgroup's 64
      for (int mt = warp >> 2; mt * 64 < P; mt += SMALL_THREADS / 128) {
        int base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int pix = mt * 64 + wl * 16 + g + 8 * h;
          if (pix >= P) pix = P - 1;  // computed, never stored
          const int r = pix / s.OW, ow = pix - r * s.OW;
          base[h] = r * s.stride * p.Ls + p.lead + ow * s.stride * s.Ci;
        }
        unsigned a[SMALL_KS][4];
#pragma unroll
        for (int ks = 0; ks < SMALL_KS; ++ks)
          if (ks < nks)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[ks][q] = small_a<VEC4>(in + base[q & 1], koff,
                                       32 * ks + 4 * tg + (q >> 1) * 16);
        int acc[COP / 2];
#pragma unroll
        for (int i = 0; i < COP / 2; ++i) acc[i] = 0;
        qtpu::wg::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < SMALL_KS; ++ks)
          if (ks < nks)
            qtpu::wg::wgmma_rs<COP>(
                acc, a[ks],
                qtpu::wg::desc_sw64(ws + (ks >> 1) * COP * 64) + 2 * (ks & 1),
                1);
        qtpu::wg::wgmma_commit();
        qtpu::wg::wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = mt * 64 + wl * 16 + g + 8 * h;
          if (pix < P)
            small_store<COP>(acc, h, pix, tg, p, sA, sB, rt, ot, flip);
        }
      }
    } else {
      for (int mt = warp; mt * 16 < P; mt += SMALL_THREADS / 32) {
        int base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int pix = mt * 16 + g + 8 * h;
          if (pix >= P) pix = P - 1;  // computed, never stored
          const int r = pix / s.OW, ow = pix - r * s.OW;
          base[h] = r * s.stride * p.Ls + p.lead + ow * s.stride * s.Ci;
        }
        int acc[COP / 2];
#pragma unroll
        for (int i = 0; i < COP / 2; ++i) acc[i] = 0;
        for (int ks = 0; ks < nks; ++ks) {
          unsigned a[4];  // rows g, g + 8 at k .. k+3, then at k+16 .. k+19
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = small_a<VEC4>(in + base[q & 1], koff,
                                 32 * ks + 4 * tg + (q >> 1) * 16);
          const int8_t* wt = ws + (ks >> 1) * COP * 64;
          const int kk = (ks & 1) * 32 + 4 * tg;
#pragma unroll
          for (int j = 0; j < COP / 8; ++j) {
            const int n = 8 * j + g;
            qtpu::mma_s8(&acc[4 * j], a[0], a[1], a[2], a[3],
                         qtpu::ld32(wt + swz<64>(n * 64 + kk)),
                         qtpu::ld32(wt + swz<64>(n * 64 + kk + 16)));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = mt * 16 + g + 8 * h;
          if (pix < P)
            small_store<COP>(acc, h, pix, tg, p, sA, sB, rt, ot, flip);
        }
      }
    }
    __syncthreads();
    // 3. the band's output run: bytes m0·Co·osize .. of the (M, Co) output
    {
      const int nb = P * s.Co * osize;
      uint8_t* dst = static_cast<uint8_t*>(p.ep.out) + m0 * s.Co * osize;
      for (int i = tid * p.och; i < nb; i += SMALL_THREADS * p.och)
        qtpu::wg::copy_chunk(dst + i, ot + i, p.och);
    }
  }
}

template <int COP, bool WG, bool VEC4>
cudaError_t launch_small_t(const SmallParams& p, int smem,
                           cudaStream_t stream) {
  static bool attr[qtpu::wg::MAX_DEVICES] = {};  // per device
  const cudaError_t e = qtpu::wg::opt_in_smem(small_kernel<COP, WG, VEC4>,
                                              SMALL_SMEM_MAX, attr);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, small_kernel<COP, WG, VEC4>, SMALL_THREADS, smem);
  // each block stages the whole weight once: few enough blocks that they
  // take several bands each where it is large
  const int cap = (p.Kpad + 63) / 64 * COP * 64 >= 8192 ? 2 : 4;
  if (per_sm > cap) per_sm = cap;
  const long slots =
      static_cast<long>(qtpu::wg::num_sms()) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(p.bands < slots ? p.bands : slots);
  small_kernel<COP, WG, VEC4><<<grid, SMALL_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int COP, bool WG>
cudaError_t launch_small_v(const SmallParams& p, int smem,
                           cudaStream_t stream) {
  return p.s.Ci % 4 == 0 ? launch_small_t<COP, WG, true>(p, smem, stream)
                         : launch_small_t<COP, WG, false>(p, smem, stream);
}

// Whether the small kernel multiplies by wgmma (a warpgroup's 64 pixels)
// rather than mma.sync (a warp's 16), when the caller does not force it:
// wgmma from COP = 16 on where K takes more than one k-step.  Graph-timed
// on the H100 (python -m qtpu_torch.ops.probe_k2 --small), wgmma won or
// tied at every ResNet-20 and LeNet-5 row (e.g. ResNet-20's layer3_0 3x3/2
// at B = 128, 0.0088 against 0.0105 ms) and lost at the one-step Ci = 3
// stems (config 3's at B = 16, 0.0236 against 0.0196 ms).
inline bool small_wgmma(int cop, int kpad) { return cop >= 16 && kpad > 32; }

// mma: 0 the default (small_wgmma), 1 mma.sync, 2 wgmma.
cudaError_t launch_small(const int8_t* x, const int8_t* w, const ConvShape& s,
                         const qtpu::Epilogue& ep, int mma,
                         cudaStream_t stream) {
  const int K = s.KH * s.KW * s.Ci;
  if (K > SMALL_KMAX || s.Co % 2 || s.Co > 128 || s.Co < 1 ||
      (s.stride != 1 && s.stride != 2) ||
      (ep.out_kind == qtpu::OUT_I8 && !qtpu::int_grid(ep)))
    return cudaErrorInvalidValue;
  const int cop = s.Co <= 8 ? 8 : s.Co <= 16 ? 16 : s.Co <= 32 ? 32
                : s.Co <= 64 ? 64 : 128;
  const bool wg = mma == 2 || (mma == 0 && small_wgmma(cop, (K + 31) / 32 * 32));
  if (wg && cop < 16) return cudaErrorInvalidValue;
  const int osize = ep.out_kind == qtpu::OUT_I8 ? 1 : 4;
  const int rsize = ep.res_kind == qtpu::RES_F32 ? 4 : 1;
  const bool res = ep.res_kind != qtpu::RES_NONE;
  SmallParams p;
  p.ep = ep;
  p.x = x;
  p.w = w;
  p.s = s;
  p.K = K;
  p.Kpad = (K + 31) / 32 * 32;
  const uint64_t row_bytes = static_cast<uint64_t>(s.W) * s.Ci;
  const uint64_t orun = static_cast<uint64_t>(s.OW) * s.Co;  // bytes / size
  p.ich = qtpu::wg::chunk_of({reinterpret_cast<uintptr_t>(x), row_bytes});
  p.och = qtpu::wg::chunk_of(
      {reinterpret_cast<uintptr_t>(ep.out), orun * osize});
  p.rch = res ? qtpu::wg::chunk_of({reinterpret_cast<uintptr_t>(ep.res),
                                    orun * rsize})
              : 16;
  p.wch = qtpu::wg::chunk_of({reinterpret_cast<uintptr_t>(w),
                               static_cast<uint64_t>(K)});
  p.wch = p.wch >= 16 ? 16 : p.wch >= 4 ? 4 : 1;
  p.lead = (p.ich - (s.pl * s.Ci) % p.ich) % p.ich;
  p.Ls = (p.lead + ((s.OW - 1) * s.stride + s.KW) * s.Ci + 15) / 16 * 16;
  // output rows per band: a pass of the block's 128 pixels, fewer where
  // the bands would not give each SM one, evened out over the image
  int th = (128 + s.OW - 1) / s.OW;
  if (th > s.OH) th = s.OH;
  const long sms = qtpu::wg::num_sms();
  while (th > 1 && static_cast<long>(s.Bn) * ((s.OH + th - 1) / th) < sms)
    --th;
  th = (s.OH + (s.OH + th - 1) / th - 1) / ((s.OH + th - 1) / th);
  const int nch = (p.Kpad + 63) / 64;
  int smem = 0;
  for (; th >= 1; --th) {
    const int run = th * s.OW * s.Co;
    p.res_off = (run * osize + 127) / 128 * 128;
    p.in_off = p.res_off + (res ? (run * rsize + 127) / 128 * 128 : 0);
    p.w_off = (p.in_off + ((th - 1) * s.stride + s.KH) * p.Ls + 1023) / 1024 *
              1024;
    p.koff_off = p.w_off + nch * cop * 64;
    p.ab_off = p.koff_off + 4 * p.Kpad;
    smem = 1024 + p.ab_off + 8 * cop;
    if (smem <= SMALL_SMEM_MAX) break;
  }
  if (th < 1) return cudaErrorInvalidValue;
  p.TH = th;
  p.bands_per_image = (s.OH + th - 1) / th;
  p.bands = s.Bn * p.bands_per_image;
  switch (cop) {
    case 8: return launch_small_v<8, false>(p, smem, stream);
    case 16:
      return wg ? launch_small_v<16, true>(p, smem, stream)
                : launch_small_v<16, false>(p, smem, stream);
    case 32:
      return wg ? launch_small_v<32, true>(p, smem, stream)
                : launch_small_v<32, false>(p, smem, stream);
    case 64:
      return wg ? launch_small_v<64, true>(p, smem, stream)
                : launch_small_v<64, false>(p, smem, stream);
    default:
      return wg ? launch_small_v<128, true>(p, smem, stream)
                : launch_small_v<128, false>(p, smem, stream);
  }
}

}  // namespace

#define K2_ARGS                                                              \
  const void *x, const void *w, const void *tapsum, const void *A,           \
      const void *B, const void *res, int res_kind, void *out, int out_kind, \
      int Bn, int H, int W, int Ci, int Co, int KH, int KW, int stride,      \
      int pad_t, int pad_l, int OH, int OW, int zp, const void *zp_dev,      \
      float C, float lo, float hi, float shift, int relu, int use_act_max,   \
      float act_max, void *stream
#define K2_EPILOGUE                                                          \
  qtpu::make_epilogue(static_cast<const float*>(A),                          \
                      static_cast<const float*>(B), res, res_kind, out,      \
                      out_kind, C, lo, hi, shift, relu, use_act_max, act_max)
#define K2_SHAPE                                                     \
  ConvShape {                                                        \
    Bn, H, W, Ci, Co, KH, KW, stride, pad_t, pad_l, OH, OW, zp,      \
        static_cast<const int*>(zp_dev)                              \
  }

// The implicit GEMM on the Hopper ring: Ci % 64 == 0, the input, weight,
// output and residual 16-byte aligned with rows of multiples of 16 bytes;
// tapsum given unless the pad code is 0 (zp == 0 and no zp_dev) or the
// window never leaves the image.
extern "C" int qtpu_qconv2d_fused(K2_ARGS) {
  const bool pads = pad_t || pad_l || (OH - 1) * stride + KH > H + pad_t ||
                    (OW - 1) * stride + KW > W + pad_l;
  if (Ci % qtpu::wg::BK || ((zp || zp_dev) && pads && !tapsum))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvX xl{static_cast<const int8_t*>(x),
                 static_cast<const int*>(tapsum), K2_SHAPE};
  return static_cast<int>(qtpu::wg::launch_tiles<false>(
      xl, static_cast<const int8_t*>(w), Bn * OH * OW, Co, KH * KW * Ci,
      K2_EPILOGUE, static_cast<cudaStream_t>(stream)));
}

// The stem kernel: Ci = 3, int8 codes on an integer grid, no residual, Co
// in {16, 32, 64, 128}, W * 3 a multiple of 16 and the input 16-byte
// aligned, OW <= 256, KH * KW * 3 <= 256.
extern "C" int qtpu_qconv2d_fused_stem(K2_ARGS) {
  const qtpu::Epilogue ep = K2_EPILOGUE;
  if (Ci != 3 || out_kind != qtpu::OUT_I8 || res_kind != qtpu::RES_NONE ||
      !qtpu::int_grid(ep) || (W * 3) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || OW > 256 || KH * KW * 3 > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const ConvShape s = K2_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Co) {
    case 16: return static_cast<int>(launch_stem<16>(xs, ws, s, ep, st));
    case 32: return static_cast<int>(launch_stem<32>(xs, ws, s, ep, st));
    case 64: return static_cast<int>(launch_stem<64>(xs, ws, s, ep, st));
    case 128: return static_cast<int>(launch_stem<128>(xs, ws, s, ep, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The small-channel kernel: Ci·KH·KW <= 320, Co even and <= 128, int8
// codes only on an integer grid.  _small multiplies as small_wgmma
// chooses; _small_sync and _small_wg force mma.sync or wgmma (Co > 8).
extern "C" int qtpu_qconv2d_fused_small(K2_ARGS) {
  return static_cast<int>(launch_small(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), K2_SHAPE,
      K2_EPILOGUE, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" int qtpu_qconv2d_fused_small_sync(K2_ARGS) {
  return static_cast<int>(launch_small(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), K2_SHAPE,
      K2_EPILOGUE, 1, static_cast<cudaStream_t>(stream)));
}

extern "C" int qtpu_qconv2d_fused_small_wg(K2_ARGS) {
  return static_cast<int>(launch_small(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), K2_SHAPE,
      K2_EPILOGUE, 2, static_cast<cudaStream_t>(stream)));
}

// The old loop on an input the caller padded (pads 0, H and W padded).
extern "C" int qtpu_qconv2d_fused_igemm(K2_ARGS) {
  if (pad_t || pad_l || (H - KH) / stride + 1 != OH ||
      (W - KW) / stride + 1 != OW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  ConvLoader al{xs, H, W, Ci, KW, OH, OW, stride};
  const bool vec = Ci % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const int M = Bn * OH * OW, K = KH * KW * Ci;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return static_cast<int>(
        qtpu::launch_igemm<true>(al, ws, M, Co, K, K2_EPILOGUE, s));
  return static_cast<int>(
      qtpu::launch_igemm<false>(al, ws, M, Co, K, K2_EPILOGUE, s));
}

#ifdef QTPU_IGEMM_PROBE
// Probe build only: where igemm_kernel writes its clock64 stamps.
extern "C" int qtpu_probe_set_stamps(void* stamps) {
  return static_cast<int>(cudaMemcpyToSymbol(qtpu::qtpu_probe_stamps, &stamps,
                                             sizeof(stamps)));
}
#endif

#ifdef QTPU_WGMMA_PROBE
// Probe build only: where wgmma_gemm_kernel writes its cycles by phase.
extern "C" int qtpu_wgmma_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qtpu::wg::qtpu_wgmma_probe, &buf, sizeof(buf)));
}
#endif

#ifdef QTPU_STEM_PROBE
// Probe build only: where stem_kernel writes its cycles by phase.
extern "C" int qtpu_stem_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qtpu_stem_probe, &buf, sizeof(buf)));
}
#endif
