// K7 on Hopper: a chained run of int8 identity bottlenecks in one launch of
// the wgmma runner (wgmma_phase.cuh), for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qstage.py:qstage_fused.  Per
// identity block i of the chain, on the (B*H*W, Cin) codes x_i:
//   a       = requant(x_i . w1_i)                  conv1, 1x1
//   b       = requant(conv3x3(a, pads of zp2_i))   conv2, SAME, stride 1
//   x_{i+1} = requant(b . w3_i + x_i * C3_i)       conv3 + int8 residual
// with relu folded into lo; the epilogues in the unfused K1 -> K2 -> K1
// order, so the codes are bit-identical to it.
//
// What bounds it on the H100: counted once (x in, x out, the weights),
// layer1's chain is bytes-bound and layer2-4 sit near the int8 tensor-core
// rate (9 * Cmid^2 + 2 * Cin * Cmid multiply-adds per pixel and block).
// The older kernel (qstage.cu) reached 2-4% of that bound at B = 8: three
// phases of the mma.sync loop a block, byte-at-a-time epilogues, and most
// of a block's time waiting at the grid barriers.  Here each block is two
// phases on TMA + wgmma tiles — conv1 on K1's tile into workspace a, then
// K5's tile (conv2 from a's halo, conv3 with the residual) on 8 x 8 output
// tiles, b never leaving shared memory — or, where the 8 x 8 tiles are too
// few to fill the card, three (conv2 alone on (tile, channel pass) units
// into workspace b, conv3 on K1's tile); ops/chain_plan.py chooses.
// ops/qstage.py: stage_path sends the rest (Cin off 128, Cmid off 64,
// grids code_bits does not take, unaligned tensors) to the older kernel.
#include "wgmma_phase.cuh"

// x, out: int8 (M, Cin), M = Bn * H * W rows of NHWC images; w1 (nblk, Cmid,
// Cin), w2 (nblk, Cmid, 9 Cmid), w3 (nblk, Cin, Cmid); the coefficient rows
// and scalars as qstage.cu's; ws: M * Cmid bytes (2 M * Cmid in split mode)
// rounded up to 16, then M * Cin when nblk > 1; bar: the two barrier words;
// the plan (ops/chain_plan.py): mode (0 fused, 1 split), w, tm, stages,
// nres, smem bytes, grid.
extern "C" int qtpu_qstage_fused_wg(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, const void* scal, void* out, void* ws,
    void* bar, int Bn, int H, int W, int nblk, int Cin, int Cmid, int mode,
    int w, int tm, int stages, int nres, int smem, int grid, void* stream) {
  qtpu::wp::Chain p = {};
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.scal = static_cast<const float*>(scal);
  p.bar = static_cast<unsigned*>(bar);
  p.nblk = nblk;
  p.Bn = Bn;
  p.H = H;
  p.W = W;
  p.M = Bn * H * W;
  p.C = Cin;
  p.Cm = Cmid;
  p.mode = mode;
  p.w = w;
  p.tm = tm;
  p.stages = stages;
  p.nres = nres;
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t mid = static_cast<size_t>(p.M) * Cmid;
  const size_t work = (mid * (mode == qtpu::wp::SPLIT ? 2 : 1) + 15) / 16 * 16;
  const qtpu::wp::Tensors t{x, w1, w2, w3, out,
                            nblk > 1 ? wsb + work : nullptr, wsb,
                            mode == qtpu::wp::SPLIT ? wsb + mid : nullptr};
  return static_cast<int>(qtpu::wp::launch_chain<false>(
      p, t, smem, grid, static_cast<cudaStream_t>(stream)));
}

