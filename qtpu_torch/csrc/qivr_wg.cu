// K9 on Hopper: a chained run of int8 MobileNet-v2 inverted residuals in one
// launch of the wgmma runner (wgmma_phase.cuh), for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qivr.py:qivr_fused.  Per block i
// of the run, on the (B*H*W, C) codes x_i:
//   e       = requant(x_i . w1_i)                 expand 1x1, relu6 in hi1
//   d       = requant(depthwise3x3(e, pads zp))   stride 1, relu6 in hi2
//   x_{i+1} = requant(d . w3_i + x_i * C3_i)      project + int8 residual
// the epilogues in the unfused K1 -> K3 -> K1 order, so the codes are
// bit-identical to it.
//
// What bounds it on the H100: counted once (x in, x out, the weights), the
// nine-tap depthwise on CUDA cores (2 * 9 * E operations a pixel, at 67
// TOP/s) bounds block2-block12 and the two GEMMs block14/15; at B = 8 the
// bound is a few microseconds, so what the older kernel (qivr.cu) lost was
// latency: three phases a block of few tiles each, most of a block's time
// waiting at the grid barriers, and the depthwise reading its taps from L2.
// Here each block is two phases: the expand on K1's TMA + wgmma tile into
// workspace e, then on 8 x 8 output tiles the depthwise from e's halo (TMA,
// 64 channels a ring stage) straight into the project's K-major A tile in
// shared memory, and the project with the residual on wgmma; d never leaves
// shared memory.  Where the 8 x 8 tiles are too few to fill the card, three:
// the depthwise alone on (tile, 64-channel) units into workspace d, then
// the project on K1's tile (ops/chain_plan.py chooses).  Rows that are no
// TMA tensor (C a multiple of 8 up to 32, not of 16: MobileNet-v2's block2,
// C = 24) come as bulk copies repacked in shared memory and as 3D maps of
// (b, y, x·C) (wgmma_phase.cuh: RawRows), in the fused mode.
#include "wgmma_phase.cuh"

// x, out: int8 (M, C), M = Bn * H * W rows of NHWC images; w1 (nblk, E,
// C), wd (nblk, 9, E), w3 (nblk, C, E); the coefficient rows and scalars as
// qivr.cu's; ws: M * E bytes (2 M * E in split mode), then M * C when
// nblk > 1; bar: the two barrier words; the plan (ops/chain_plan.py): mode
// (0 fused, 1 split), w (64), tm (1), stages, nres, smem bytes, grid.
extern "C" int qtpu_qivr_fused_wg(
    const void* x, const void* w1, const void* wd, const void* w3,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, const void* scal, void* out, void* ws,
    void* bar, int Bn, int H, int W, int nblk, int C, int E, int mode,
    int w, int tm, int stages, int nres, int smem, int grid, void* stream) {
  qtpu::wp::Chain p = {};
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.scal = static_cast<const float*>(scal);
  p.wd = static_cast<const int8_t*>(wd);
  p.bar = static_cast<unsigned*>(bar);
  p.nblk = nblk;
  p.Bn = Bn;
  p.H = H;
  p.W = W;
  p.M = Bn * H * W;
  p.C = C;
  p.Cm = E;
  p.mode = mode;
  p.w = w;
  p.tm = tm;
  p.stages = stages;
  p.nres = nres;
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t me = static_cast<size_t>(p.M) * E;
  const bool split = mode == qtpu::wp::SPLIT;
  const qtpu::wp::Tensors t{x, w1, nullptr, w3, out,
                            nblk > 1 ? wsb + (split ? 2 : 1) * me : nullptr,
                            wsb, split ? wsb + me : nullptr};
  return static_cast<int>(qtpu::wp::launch_chain<true>(
      p, t, smem, grid, static_cast<cudaStream_t>(stream)));
}

