// K6: a whole identity bottleneck in one kernel, for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qblock.py:qbottleneck_fused:
//   conv1 (1x1) -> requant -> conv2 (3x3, stride 1, zero-point pads)
//   -> requant -> conv3 (1x1) + the block input as int8 residual
//   -> relu -> requant.
// Unfused, the port runs K1, K2 and K1: conv1's and conv2's codes each make
// a round trip through device memory.  Here only x, the three weights and
// the output move; conv1 is recomputed on each tile's one-pixel halo, whose
// pixels outside the image hold conv2's zero point, never a conv1 result —
// exactly the pad value the unfused K2 reads.
//
// What bounds it on the H100: counted once, ResNet-50's layer1 stays
// bytes-bound while layer3/4 approach the int8 tensor-core rate; the halo
// recompute adds operations, not bytes.
//
// Two kernels, chosen per call by ops/qtail.py's tail_path:
// * qtpu_qblock_fused: wgmma_tail.cuh — conv1 on wgmma over the TMA-loaded
//   halo rows of x (two 64-row blocks for the 100 halo pixels), then K5's
//   cluster tail (Cmid, Cin multiples of 64);
// * qtpu_qblock_fused_igemm: the older kernel, for the rest: conv1 on the
//   10 x 10 halo pixels as two 64-row mma.sync passes (rows outside the
//   image computed and dropped), then fused_tail.cuh's conv2 and conv3.
// Both take the same arguments; the older one ignores the plan's.
#include "fused_tail.cuh"
#include "wgmma_tail.cuh"

namespace {

// conv1's A rows: halo pixel m of the block's tile, clamped into the image
// (rows of pixels outside it are computed and dropped).
struct HaloRows {
  const int8_t* x;
  int H, W, C, b, y0, x0;
  typedef const int8_t* Row;
  __device__ __forceinline__ Row row(int m) const {
    const int y = min(max(y0 + m / qtpu::HW, 0), H - 1);
    const int xx = min(max(x0 + m % qtpu::HW, 0), W - 1);
    return x + ((static_cast<size_t>(b) * H + y) * W + xx) * C;
  }
  __device__ __forceinline__ const int8_t* ptr(Row r, int k) const {
    return r + k;
  }
  __device__ __forceinline__ const int8_t* base() const { return x; }
};

struct Conv1Args {
  const int8_t* w1;  // (Cmid, Cin)
  const float *A1, *B1;
  float lo1, hi1, shift1;
  int zp2;  // conv2's zero point, the pad code
  int Cin;
};

__global__ void __launch_bounds__(qtpu::TAIL_THREADS)
    qblock_kernel(const int8_t* __restrict__ x, Conv1Args c1,
                  qtpu::TailArgs p) {
  typedef qtpu::TailTile T;
  extern __shared__ __align__(16) int8_t smem[];
  qtpu::TailProbe pr;
  const int hs = qtpu::halo_stride(p.Cmid);
  int8_t* halo = smem;
  int8_t* mid = halo + qtpu::HALO * hs;
  int8_t* Bs = mid + T::BM * qtpu::mid_stride(p.Cmid);
  int8_t* As = Bs + 2 * T::STAGE_B;
  const qtpu::TileAt at(p.H, p.W);

  // every halo pixel starts as conv2's pad code
  const int4 zfill = qtpu::splat16(c1.zp2);
  for (int c = threadIdx.x; c < qtpu::HALO * hs / 16;
       c += qtpu::TAIL_THREADS)
    reinterpret_cast<int4*>(halo)[c] = zfill;
  pr.lap(0);

  // 0. conv1 on the halo pixels inside the image
  const qtpu::Frag<T> f;
  const HaloRows rows{x, p.H, p.W, c1.Cin, at.b, at.ty0 - 1, at.tx0 - 1};
  int acc[T::MT][T::NT][4];
  for (int m0 = 0; m0 < qtpu::HALO; m0 += T::BM) {
    for (int n0 = 0; n0 < p.Cmid; n0 += T::BN) {
      qtpu::StagedA<T, true, HaloRows> a(rows, As, qtpu::HALO, c1.Cin, m0);
      qtpu::StagedB<T, true> b(c1.w1, Bs, p.Cmid, c1.Cin, n0);
      qtpu::mainloop<T>(a, b, c1.Cin, acc);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hp = m0 + f.row(i, h);
          const int y = at.ty0 - 1 + hp / qtpu::HW;
          const int xx = at.tx0 - 1 + hp % qtpu::HW;
          if (hp >= qtpu::HALO || y < 0 || y >= p.H || xx < 0 || xx >= p.W)
            continue;
#pragma unroll
          for (int j = 0; j < T::NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + f.col(j, e);
              if (n < p.Cmid)
                halo[hp * hs + n] = qtpu::ep_code(
                    qtpu::ep_affine(acc[i][j][2 * h + e], c1.A1[n], c1.B1[n]),
                    c1.lo1, c1.hi1, c1.shift1);
            }
        }
      }
    }
  }
  __syncthreads();
  pr.lap(1);
  qtpu::tail_phases(p, halo, mid, Bs, at, pr);
}

}  // namespace

#define K6_ARGS                                                             \
  const void *x, const void *w1, const void *w2, const void *w3,             \
      const void *A1, const void *B1, const void *A2, const void *B2,        \
      const void *A3, const void *B3, void *out, int Bn, int H, int W,       \
      int Cin, int Cmid, int zp2, float lo1, float hi1, float shift1,        \
      float lo2, float hi2, float shift2, float C3, float lo3, float hi3,    \
      float shift3, int cs, int tm, int stages, int nc, int nres,          \
      int smem, void *stream

// x, out: int8 (Bn, H, W, Cin), x also the residual; w1: (Cmid, Cin), w2:
// (Cmid, 9 Cmid), w3: (Cin, Cmid).  The plan (cs, stages, nc, nres, smem)
// comes from ops/qtail.py: tail_plan.
extern "C" int qtpu_qblock_fused(K6_ARGS) {
  qtpu::wt::TailWg p{};
  p.A1 = static_cast<const float*>(A1);
  p.B1 = static_cast<const float*>(B1);
  p.A2 = static_cast<const float*>(A2);
  p.B2 = static_cast<const float*>(B2);
  p.lo1 = lo1;
  p.hi1 = hi1;
  p.shift1 = shift1;
  p.lo2 = lo2;
  p.hi2 = hi2;
  p.shift2 = shift2;
  p.ep3 = qtpu::make_epilogue(static_cast<const float*>(A3),
                              static_cast<const float*>(B3), x, qtpu::RES_I8,
                              out, qtpu::OUT_I8, C3, lo3, hi3, shift3, 0, 0,
                              0.f);
  p.H = p.Hin = H;
  p.W = p.Win = W;
  p.pad = 1;
  p.Cin = Cin;
  p.Cmid = Cmid;
  p.Cout = Cin;
  p.zp = zp2;
  p.Bn = Bn;
  p.cs = cs;
  p.tm = tm;
  p.stages = stages;
  p.nc = nc;
  p.nres = nres;
  return qtpu::wt::launch_tail<true>(x, w1, w2, w3, x, out, p, smem,
                                     static_cast<cudaStream_t>(stream));
}

// The older kernel; Cin, Cmid % 16 == 0 and 16-byte aligned tensors (the
// wrapper checks).
extern "C" int qtpu_qblock_fused_igemm(K6_ARGS) {
  static const cudaError_t attr =
      qtpu::allow_big_smem(reinterpret_cast<const void*>(qblock_kernel));
  if (attr != cudaSuccess) return attr;
  const int8_t* xs = static_cast<const int8_t*>(x);
  Conv1Args c1{static_cast<const int8_t*>(w1), static_cast<const float*>(A1),
               static_cast<const float*>(B1), lo1, hi1, shift1, zp2, Cin};
  qtpu::TailArgs p{static_cast<const int8_t*>(w2),
                   static_cast<const int8_t*>(w3),
                   static_cast<const float*>(A2),
                   static_cast<const float*>(B2),
                   static_cast<const float*>(A3),
                   static_cast<const float*>(B3),
                   lo2, hi2, shift2, C3, lo3, hi3, shift3,
                   xs, static_cast<int8_t*>(out), H, W, Cmid, Cin};
  const int tiles = Bn * ((H + qtpu::TH - 1) / qtpu::TH) *
                    ((W + qtpu::TW - 1) / qtpu::TW);
  const size_t bytes =
      qtpu::tail_smem_bytes(Cmid) + 2 * qtpu::TailTile::STAGE_A;
  qblock_kernel<<<tiles, qtpu::TAIL_THREADS, bytes,
                  static_cast<cudaStream_t>(stream)>>>(xs, c1, p);
  return cudaGetLastError();
}

#ifdef QTPU_TAIL_PROBE
// Probe build only: where both kernels write their cycles by phase
// (8 per block; fused_tail.cuh: TailProbe).
extern "C" int qtpu_tail_probe_set(void* buf) {
  return cudaMemcpyToSymbol(qtpu::qtpu_tail_probe, &buf, sizeof(buf));
}
#endif
