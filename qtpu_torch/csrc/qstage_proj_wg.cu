// K8 on Hopper: a whole stride-1 stage — the projection block, then a
// chained run of identity bottlenecks — in one launch of the wgmma runner
// (wgmma_phase.cuh), for sm_90a.
//
// Replaces the TPU kernel qtpu/ops/pallas/qstage.py:qstage_proj_fused.  On
// the (B*H*W, Cp) codes x the projection block computes
//   a   = requant(x . wp1)                      conv1, 1x1
//   b   = requant(conv3x3(a, pads of zp2))      conv2, SAME, stride 1
//   td  = acc_d * Ad + Bd                        downsample x . wd, f32
//   x_0 = requant(b . wp3 * A3 + B3 + td * C3)   conv3 + f32 residual
// (relu folded into lo, C3 = 1 / x_0's scale), and then K7's chain runs on
// x_0 (qstage_wg.cu).  Every epilogue is epilogue.cuh's in the unfused
// K1 -> K2 -> K1 (+ K1 f32 downsample) order, so the codes are
// bit-identical to that sequence.
//
// What bounds it on the H100: counted once (x in, the last block's output
// out, the weights), ResNet-50's layer1 is bytes-bound at B = 8 and near
// the int8 tensor-core rate at B = 128.  The older kernel (qstage.cu, K8 on
// grid_phase.cuh) ran every phase on the mma.sync loop with byte-at-a-time
// epilogues, the projection's conv3 + downsample as two serial mainloops,
// and was slower than the unfused K1/K2 sequence.  Here the projection is
// three phases of the runner ahead of K7's chain, in an instantiation of
// its own (chain_kernel<..., PROJ>): P0 conv1 on K1's TMA + wgmma tile onto
// workspace a, P1 conv2 on split mode's (8 x 8 tile, channel pass) units
// straight from a TMA-loaded halo of a onto workspace b, P2 the two-GEMM
// tile (wgmma_gemm.cuh: td_slab) — the downsample's k-stages and conv3's
// through one ring, td as f32 in a shared-memory tile between the two
// products, K1's f32-residual requant, TMA-stored — onto block 0's input;
// then the chain's phases with ops/chain_plan.py's plan.  ops/qstage.py:
// stage_proj_path sends the rest to the older kernel.
#include "wgmma_phase.cuh"

namespace {

using namespace qtpu::wp;

// K8: the projection block (x (M, Cp) in t.xp; Cp a multiple of 64, its
// Cm the chain's Cmid), then K7's chain of nblk >= 1 blocks.
cudaError_t launch_stage_proj(const Chain& chain, const Tensors& t, int smem,
                              int grid, cudaStream_t stream) {
  Chain p = chain;
  p.act[0] = nullptr;
  p.act[1] = static_cast<const int8_t*>(t.tmp);
  p.act[2] = static_cast<const int8_t*>(t.out);
  if (p.nblk < 1 || p.stages < 4 || p.stages > MAX_ST || p.nres < 1 ||
      p.nres > MAX_RES || (p.w != 64 && p.w != 128) || p.Cm % p.w ||
      p.Cp % 64 || p.C % 128 || grid < 1 || !t.xp || !t.tmp || !t.b ||
      (p.mode != FUSED && p.mode != SPLIT) || (p.tm != 1 && p.tm != 2) ||
      (p.mode == SPLIT && (p.tm != 1 || p.nres != 2)))
    return cudaErrorInvalidValue;
  const Layout L(false, p.mode == SPLIT, p.C, p.Cm, p.tm, p.stages, p.nres,
                 true);
  if (L.total != smem || smem > qtpu::wg::SMEM_BLOCK_MAX)
    return cudaErrorInvalidValue;
  Maps mp = {};
  if (!encode_maps(mp, p, t, false)) return cudaErrorInvalidValue;
  if (p.w == 64)
    return p.tm == 1
               ? launch_kernel<false, 64, 1, false, true>(mp, p, smem, grid,
                                                          stream)
               : launch_kernel<false, 64, 2, false, true>(mp, p, smem, grid,
                                                          stream);
  return p.tm == 1
             ? launch_kernel<false, 128, 1, false, true>(mp, p, smem, grid,
                                                         stream)
             : launch_kernel<false, 128, 2, false, true>(mp, p, smem, grid,
                                                         stream);
}

}  // namespace

// x: int8 (M, Cp); out: int8 (M, Co); the projection block's weights
// wp1 (Cm, Cp), wp2 (Cm, 9 Cm), wp3 (Co, Cm), wd (Co, Cp), its rows
// pa1, pb1, pa2, pb2 (Cm), pa3, pb3, pda, pdb (Co) and scalars pscal
// (NSCAL); the chain's as qstage_wg.cu's with Cin = Co and Cmid = Cm; ws:
// 2 M * Cm bytes (workspaces a, b) rounded up to 16, then M * Co; bar: the
// two barrier words; the plan (ops/chain_plan.py, kind "stage_proj"):
// mode, w, tm, stages, nres, smem bytes, grid.
extern "C" int qtpu_qstage_proj_fused_wg(
    const void* x, const void* wp1, const void* wp2, const void* wp3,
    const void* wd, const void* pa1, const void* pb1, const void* pa2,
    const void* pb2, const void* pa3, const void* pb3, const void* pda,
    const void* pdb, const void* pscal, const void* w1, const void* w2,
    const void* w3, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, const void* scal,
    void* out, void* ws, void* bar, int Bn, int H, int W, int Cp, int Cm,
    int nblk, int Co, int Cmid, int mode, int w, int tm, int stages,
    int nres, int smem, int grid, void* stream) {
  if (Cm != Cmid) return static_cast<int>(cudaErrorInvalidValue);
  qtpu::wp::Chain p = {};
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3);
  p.b3 = static_cast<const float*>(b3);
  p.scal = static_cast<const float*>(scal);
  p.pa1 = static_cast<const float*>(pa1);
  p.pb1 = static_cast<const float*>(pb1);
  p.pa2 = static_cast<const float*>(pa2);
  p.pb2 = static_cast<const float*>(pb2);
  p.pa3 = static_cast<const float*>(pa3);
  p.pb3 = static_cast<const float*>(pb3);
  p.pad = static_cast<const float*>(pda);
  p.pbd = static_cast<const float*>(pdb);
  p.pscal = static_cast<const float*>(pscal);
  p.bar = static_cast<unsigned*>(bar);
  p.nblk = nblk;
  p.Bn = Bn;
  p.H = H;
  p.W = W;
  p.M = Bn * H * W;
  p.C = Co;
  p.Cm = Cm;
  p.Cp = Cp;
  p.mode = mode;
  p.w = w;
  p.tm = tm;
  p.stages = stages;
  p.nres = nres;
  int8_t* wsb = static_cast<int8_t*>(ws);
  const size_t mid = static_cast<size_t>(p.M) * Cm;
  qtpu::wp::Tensors t{nullptr, w1, w2, w3, out,
                      wsb + (2 * mid + 15) / 16 * 16, wsb, wsb + mid};
  t.xp = x;
  t.wp1 = wp1;
  t.wp2 = wp2;
  t.wp3 = wp3;
  t.wd = wd;
  return static_cast<int>(launch_stage_proj(
      p, t, smem, grid, static_cast<cudaStream_t>(stream)));
}
