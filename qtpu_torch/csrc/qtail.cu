// K5: fused identity-bottleneck tail, for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qtail.py:qtail_fused:
//   conv2 (3x3, stride 1) on conv1's codes a -> requant -> conv3 (1x1)
//   + int8 residual r -> relu -> requant.
// Unfused, the port runs K2 then K1 and conv2's codes make a round trip
// through device memory.  Here they stay in shared memory, and a's pads are
// read in the kernel as the zero point (no padded copy).
//
// What bounds it on the H100: counted once, a, w2, w3, r and the output are
// the bytes; conv2 does 2 * 9 * Cmid operations per output element of its
// Cmid channels and conv3 2 * Cmid per element of Cout, which keeps
// ResNet-50's layer1 (Cmid 64) bytes-bound and brings layer3/4 (Cmid
// 256/512, where the weights are most of the bytes) to the balance point.
//
// Two kernels, chosen per call by ops/qtail.py's tail_path:
// * qtpu_qtail_fused: wgmma_tail.cuh — a cluster of blocks per 8 x 8 tile
//   splitting the channels, wgmma straight from a TMA-multicast halo, TMA
//   weight ring, residual and output (Cmid, Cout multiples of 64);
// * qtpu_qtail_fused_igemm: the older kernel (one block of mma.sync warps
//   per tile, fused_tail.cuh), for the rest.  It copies the tile's 10 x 10
//   halo of a into shared memory with cp.async, the zero point where a pixel
//   lies outside the image, and runs fused_tail.cuh's two phases on it.
// Both take the same arguments; the older one ignores the plan's.
#include "fused_tail.cuh"
#include "wgmma_tail.cuh"

namespace {

__global__ void __launch_bounds__(qtpu::TAIL_THREADS)
    qtail_kernel(const int8_t* __restrict__ a, int Hin, int Win, int pad,
                 int zp, qtpu::TailArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  qtpu::TailProbe pr;
  const int hs = qtpu::halo_stride(p.Cmid);
  int8_t* halo = smem;
  int8_t* mid = halo + qtpu::HALO * hs;
  int8_t* Bs = mid + qtpu::TailTile::BM * qtpu::mid_stride(p.Cmid);
  const qtpu::TileAt at(p.H, p.W);

  // the halo: input pixel (ty0 - pad + hy, tx0 - pad + hx), 16-byte chunks
  const int cpp = p.Cmid / 16;
  const int4 zfill = qtpu::splat16(zp);
  for (int c = threadIdx.x; c < qtpu::HALO * cpp; c += qtpu::TAIL_THREADS) {
    const int hp = c / cpp;
    const int ch = (c - hp * cpp) * 16;
    const int y = at.ty0 - pad + hp / qtpu::HW;
    const int x = at.tx0 - pad + hp % qtpu::HW;
    int8_t* dst = halo + hp * hs + ch;
    if (y >= 0 && y < Hin && x >= 0 && x < Win)
      qtpu::cp_async16(
          dst,
          a + ((static_cast<size_t>(at.b) * Hin + y) * Win + x) * p.Cmid + ch,
          true);
    else
      *reinterpret_cast<int4*>(dst) = zfill;
  }
  qtpu::cp_async_commit();
  qtpu::cp_async_wait_all();
  __syncthreads();
  pr.lap(0);
  qtpu::tail_phases(p, halo, mid, Bs, at, pr);
}

}  // namespace

#define K5_ARGS                                                             \
  const void *a, const void *r, const void *w2, const void *w3,              \
      const void *A2, const void *B2, const void *A3, const void *B3,        \
      void *out, int Bn, int Hin, int Win, int pad, int zp, int Cmid,        \
      int Cout, float lo2, float hi2, float shift2, float C3, float lo3,     \
      float hi3, float shift3, int cs, int tm, int stages, int nc,          \
      int nres, int smem, void *stream

// a: int8 (Bn, Hin, Win, Cmid), its pads (pad on each side) read as zp;
// r, out: int8 (Bn, H, W, Cout) with H = Hin + 2 pad - 2; w2: (Cmid,
// 9 Cmid), w3: (Cout, Cmid).  The plan (cs, tm, stages, nc, nres, smem) comes
// from ops/qtail.py: tail_plan.
extern "C" int qtpu_qtail_fused(K5_ARGS) {
  qtpu::wt::TailWg p{};
  p.A2 = static_cast<const float*>(A2);
  p.B2 = static_cast<const float*>(B2);
  p.lo2 = lo2;
  p.hi2 = hi2;
  p.shift2 = shift2;
  p.ep3 = qtpu::make_epilogue(static_cast<const float*>(A3),
                              static_cast<const float*>(B3), r, qtpu::RES_I8,
                              out, qtpu::OUT_I8, C3, lo3, hi3, shift3, 0, 0,
                              0.f);
  p.H = Hin + 2 * pad - 2;
  p.W = Win + 2 * pad - 2;
  p.Hin = Hin;
  p.Win = Win;
  p.pad = pad;
  p.Cin = Cmid;
  p.Cmid = Cmid;
  p.Cout = Cout;
  p.zp = zp;
  p.Bn = Bn;
  p.cs = cs;
  p.tm = tm;
  p.stages = stages;
  p.nc = nc;
  p.nres = nres;
  return qtpu::wt::launch_tail<false>(a, nullptr, w2, w3, r, out, p, smem,
                                      static_cast<cudaStream_t>(stream));
}

// The older kernel; Cmid % 16 == 0 and 16-byte aligned tensors (the wrapper
// checks).
extern "C" int qtpu_qtail_fused_igemm(K5_ARGS) {
  static const cudaError_t attr =
      qtpu::allow_big_smem(reinterpret_cast<const void*>(qtail_kernel));
  if (attr != cudaSuccess) return attr;
  const int H = Hin + 2 * pad - 2;
  const int W = Win + 2 * pad - 2;
  qtpu::TailArgs p{static_cast<const int8_t*>(w2),
                   static_cast<const int8_t*>(w3),
                   static_cast<const float*>(A2),
                   static_cast<const float*>(B2),
                   static_cast<const float*>(A3),
                   static_cast<const float*>(B3),
                   lo2, hi2, shift2, C3, lo3, hi3, shift3,
                   static_cast<const int8_t*>(r), static_cast<int8_t*>(out),
                   H, W, Cmid, Cout};
  const int tiles = Bn * ((H + qtpu::TH - 1) / qtpu::TH) *
                    ((W + qtpu::TW - 1) / qtpu::TW);
  qtail_kernel<<<tiles, qtpu::TAIL_THREADS, qtpu::tail_smem_bytes(Cmid),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), Hin, Win, pad, zp, p);
  return cudaGetLastError();
}

#ifdef QTPU_TAIL_PROBE
// Probe build only: where both kernels write their cycles by phase
// (8 per block; fused_tail.cuh: TailProbe).
extern "C" int qtpu_tail_probe_set(void* buf) {
  return cudaMemcpyToSymbol(qtpu::qtpu_tail_probe, &buf, sizeof(buf));
}
#endif
