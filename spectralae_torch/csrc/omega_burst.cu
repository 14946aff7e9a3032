// K5 grad_project, K6 respectra_conv, K7 fused_step and K8 itergrid — the
// omega-space burst engines: per-bin gradients, two-stage conv and Parseval
// MSE of one frozen-input burst, with the kernel spectra rebuilt from the
// compact kernels by restricted-DFT products and never stored.
//
// Replaces: spectralae/train/fft_pallas.py · burst_pallas_body (K5 = body
//   _grad_project_kernel, K6 = _respectra_conv_kernel), · burst_pallas_fused
//   (K5 for the initial pass, K7 = _fused_step_kernel), and
//   spectralae/train/fft_iter.py · burst_itergrid (K8 = _itergrid_kernel).
//
// Per bin w of the half-spectrum (W = nx * (ny/2 + 1) bins) and frame b:
//   Cf[m,d](w) = sum_p c[m*D+d, p] (cos - i sin)[p, w]   (rows of cf 0..MD-1)
//   Ff[d,m](w) = sum_p f[d*M+m, p] (cos - i sin)[p, w]   (rows MD..2MD-1)
//   H0[b,m]    = sum_d Cf[m,d] X[b,d]     (+ b[m] N at w = 0: the bias)
//   O[b,d]     = sum_m Ff[d,m] (H0 / M + bias) / D  (+ p[d] N at w = 0)
//   E = O - Y,  S[b,m] = sum_d E conj(Ff[d,m]),  H = H0 + bias (no 1/M:
//   the reference's gradient quirk, fft_backproplib.cu:395-475)
//   dc[m,d] = sum_b S conj(X) wv,  df[d,m] = sum_b E conj(H) wv
//   g[j, p] = scale * sum_w (d_re cos - d_im sin)[j, p]   (the projection)
//   db[m] = sum_b Re S(0) N scale, dp[d] = sum_b Re E(0) N scale
// with N = nx*ny, wv the Hermitian column weights and scale =
// 1 / (2 M D N^2 nb).  K5 takes O from its planes and returns g, db, dp;
// K6 returns O (conv_k's order: X times 1/M first, the bias, then 1/D) and
// sum w|O - Y|^2 / nb; K7 both, in one sweep; K8 runs the whole burst
// (iteration 0 the gradient pass on O0, then per iteration the inertia
// update, the forward and the next gradients) with E weighted by wv before
// the products, as the TPU kernel does (the same sums in another rounding).
// mxu_bf16 rounds the operands of the basis products to bf16 (the JAX
// mxu_dtype), accumulating in float32.
//
// All four are one tensor-core sweep, tc_tile, the work on one tile of 64
// bins: the spectra rebuild on the tensor cores, the per-bin pass, the
// projection on the tensor cores, the tile's partial.  K5, K6 and K7
// (tc_sweep_kernel) run it once a block and sum the tiles' partials in a
// fixed order inside their one grid; K8 (tc_itergrid_kernel) runs it every
// iteration in a persistent cooperative grid.  What bounds them:
//  - K5, K6, K7: bytes.  At the JAX benchmark's headline (one 256^2 frame,
//    W = 33,024) K7 moves 9.1 MB of planes, basis and weights, 2.7 us at
//    the card's memory rate, against 1.8 us of wgmma passes and 0.8 us of
//    per-bin float32 work; K6 reads 4 planes, writes 2 and takes one
//    rebuild, 0.0027 ms of bytes with float32 operands.
//  - K8: operations.  The planes and basis stay in L2 across iterations
//    (6.6 MB of tiles with bf16 operands, 21 MB with float32 ones), and
//    each iteration takes a rebuild (bf16x6 with float32 operands: six
//    passes of 198 MFLOP at the headline) and a projection (bf16x3), ~0.25
//    ms of tensor-core and per-bin float32 work over 100 iterations.
// The design:
//  - one block of two warpgroups per 64-bin tile, four threads a bin (each
//    the m = h mod 4 of the per-bin sums), ~89 KB of shared memory: two
//    blocks, 16 warps, an SM; 516 tiles at the headline, 130 at the
//    stream's pair-0 input (W = 8,320).  K6 holds no projection operands
//    (~73 KB) and runs three blocks an SM;
//  - the spectra rebuild [64 rows x 32 p] . [32 p x 64 bins] and the
//    projection [64 rows x 64 bins] . [64 bins x 32 p] as m64n64k16 and
//    m64n32k16 wgmma from shared memory, rows padded 60 -> 64 and P to
//    whole chunks of 32 taps with zeros (5x5: 25 -> 32, one chunk; 13x13:
//    169 -> 192, six), cos on one warpgroup and sin on the other; operands
//    as bf16 pieces (wgmma.cuh): with bf16 operands one product (the JAX
//    mxu_dtype), with float32 ones bf16x6 for the rebuild (bf16x3 left O
//    8-9e-6 from the float32 product) and bf16x3 for the projection, each
//    chunk's rebuild and each tile's projection fresh (the per-chunk
//    promotion: the tensor cores truncate as they accumulate); never TF32;
//  - a kernel of more than 32 taps (the JAX fused step takes any) runs the
//    rebuild chunk by chunk, each chunk's operands through the same shared
//    memory and its product added into the spectra, and the projection
//    chunk by chunk into its own columns of g; one chunk is the 5x5 path
//    unchanged;
//  - the host lays the basis out once in the kernel's tile order, two
//    copies ([bin][p] for the rebuild, [p][bin] for the projection), and
//    a block takes its tile's by cp.async (K6 only the rebuild's, so B7's
//    K5 and K6 share one layout); the compact kernels are split into
//    pieces in the block for each tile (in K8 from its own copy of the
//    weights, after each update), the gradient products written straight
//    into the projection's A layout as pieces;
//  - D is a template argument (the channel loops unroll without branches);
//    the first frame's planes load before anything else, each next frame's
//    during the current one;
//  - sums across tiles in a fixed order, no float atomics: groups of 16
//    tiles summed in tile order, then the groups in order, so a result
//    repeats bit for bit whatever order the blocks ran in and however many
//    ran.  K5, K6 and K7 in their one grid: the last block of each group
//    to take an atomic ticket (one fence a block, after a barrier) sums the
//    group, the last group's block the groups.  K8 between grid barriers:
//    the (group, output) sums spread over the whole grid, a barrier, the
//    outputs' sums over the groups, a barrier; then every block applies
//    the inertia to its own shared-memory copy of the weights and momenta
//    (~12 KB at the default net), the same float32 operations in every
//    block.  The grid is every block that fits (the occupancy query, two an
//    SM), at most one a tile: 264 at the headline, each striding over ~2
//    tiles an iteration; 130 at the stream input.  O is recomputed from
//    the current weights each iteration and needs no storage between them.
//    K6's one-float records are summed through shared memory, one round
//    trip to L2 a level.  K8's last iteration runs no gradient products.
// What remains (scripts/torch_omega_timeline.py, float32 operands, on an
// NVIDIA H100 80GB HBM3 at 700 W): per tile 4-5 us of setup (the 24 or 40
// KB of basis pieces a tile) and the rebuild, 2.8 us in K8, whose tiles
// stay in L2; 1.1-2.5 us of per-bin pass at nb = 1, 6-12 us at nb = 8; in
// K5 and K7 a serial tail of ~7-9 us after the last partial (two fences
// and the last group's and the groups' sums), in K6 ~3 us.  A K8
// iteration takes ~25 us at the headline: 15 us for a block's ~2 tiles,
// 1.7 us of update, ~7 us at the three barriers (with the wait for the
// slowest block) and ~1 us of sums.
//
// The masked tail: bins past W read zeros and weigh nothing, as the TPU
// kernel's zero-padded basis and wv do.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 4;
constexpr int kMaxP = 32;      // taps a chunk of the contraction over p
constexpr int kMaxChunks = 8;  // P <= kMaxP * kMaxChunks (13x13: 6 chunks)
constexpr int kMaxRows = 64;   // 2 * M * D
constexpr float kGradClip = 10.f;

constexpr int kTB = 64;          // bins a tile
constexpr int kTBS = kTB + 8;    // row stride of the per-bin arrays: the
                                 // four threads of a bin read rows D or 1
                                 // apart, 8 banks apart at D = 3
constexpr int kTC = 256;         // threads: two warpgroups, four a bin
constexpr int kTPB = kTC / kTB;  // threads a bin
constexpr int kMU = 3;           // m a thread unrolled together (their
                                 // shared-memory loads in flight at once)
constexpr int kTG = 16;          // tiles a group of the fixed-order sum
constexpr int kCopy = kMaxP * kTB;   // elements of one (piece, cos|sin)
                                     // basis tile: 32 p x 64 bins

struct Dims {
  int nb, M, D, P, W, rows, ntiles, nc;   // nc: chunks of kMaxP taps
  float norm, inv_m, inv_d, scale;
};

// K5, K6, K7; K8's iteration 0 (the gradient pass on O0) and its later
// iterations (forward and gradients, E weighted once)
enum Mode { kGradGivenO, kFwd, kFwdGrad, kItGivenO, kItFwd };

bool make_dims(int nb, int M, int D, int P, int W, float norm, float inv_m,
               float inv_d, float scale, Dims* a) {
  if (nb < 1 || M < 1 || D < 1 || D > kMaxD || P < 1 ||
      P > kMaxP * kMaxChunks || W < 1 || 2 * M * D > kMaxRows)
    return false;
  a->nb = nb;
  a->M = M;
  a->D = D;
  a->P = P;
  a->W = W;
  a->rows = 2 * M * D;
  a->ntiles = (W + kTB - 1) / kTB;
  a->nc = (P + kMaxP - 1) / kMaxP;
  a->norm = norm;
  a->inv_m = inv_m;
  a->inv_d = inv_d;
  a->scale = scale;
  return true;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// element offset of (row r, contraction k) in a tile 32 elements wide:
// 8x8 core matrices, four along K (LBO 128 bytes, SBO 512)
__host__ __device__ constexpr int off32(int r, int k) {
  return ((r >> 3) * 4 + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// the tiers by operand type (wgmma.cuh): bf16 operands "default" for both
// products; float32 operands "highest" (bf16x6) for the spectra rebuild,
// whose O error "high" would leave near 1e-5, and "high" (bf16x3) for the
// projection
template <bool BF16> struct TcTiers {
  static constexpr int kRebuild = BF16 ? 0 : 2;
  static constexpr int kProject = BF16 ? 0 : 1;
};

// elements of one chunk of kMaxP taps of one tile's basis copies in global
// memory.  A tile's record holds the rebuild's copy, chunk by chunk
// ([chunk][piece][cos|sin][off32(bin, p)]), then the projection's
// ([chunk][piece][cos|sin][tile_off(p, bin)]): nc times these elements
__host__ __device__ constexpr int tc_tile_elems(int rt, int pt) {
  return (wg::pieces(rt) + wg::pieces(pt)) * 2 * kCopy;
}

// shared memory (bytes): region X holds the compact kernels' pieces and
// the rebuild's basis copy, then the gradient products ar/ai; region Y the
// rebuilt spectra sr/si, then the projection's A pieces; region Z the
// projection's basis copy (pp pieces; none in K6); then the MSE terms, the
// bins' weights, a flag
constexpr int kRegion = 2 * kMaxRows * kTBS * 4;
__host__ __device__ constexpr int tc_smem_bytes(int pp) {
  return 2 * kRegion + pp * 2 * kCopy * 2 + (kTC + kTB + 4) * 4;
}
static_assert(2 * 3 * (kMaxRows * kMaxP + 2 * kCopy) <= kRegion,
              "the rebuild's operands fit region X");
static_assert(2 * 2 * 2 * kMaxRows * kTB <= kRegion,
              "the projection's A pieces fit region Y");

// what a mode of the sweep holds and does
template <int MODE, bool BF16> struct Tc {
  static constexpr int RT = TcTiers<BF16>::kRebuild;
  static constexpr int PT = TcTiers<BF16>::kProject;
  static constexpr int RP = wg::pieces(RT);
  static constexpr bool PROJECT = MODE != kFwd;
  static constexpr int PP = PROJECT ? wg::pieces(PT) : 0;  // Z's pieces
  static constexpr int kBlocks = PROJECT ? 2 : 3;          // an SM
};

// the sweep's dynamic shared memory for a mode and operand type
int tc_smem(int mode, int bf16) {
  const int pt = bf16 ? TcTiers<true>::kProject : TcTiers<false>::kProject;
  return tc_smem_bytes(mode == kFwd ? 0 : wg::pieces(pt));
}

// One frame's planes at one bin, as loaded (zeros past W): X, Y, and O for
// K5 and K8's iteration 0.  The pass loads the next frame's while it works
// on this one, and the tile the first frame's before anything else, so the
// loads' latency overlaps the work.
struct Frame {
  float xr[kMaxD], xi[kMaxD], yr[kMaxD], yi[kMaxD], orr[kMaxD], oii[kMaxD];
};

template <int MODE, int D>
__device__ __forceinline__ void load_frame(Frame& f,
                                           const float* __restrict__ planes,
                                           const Dims& a, int b, int w) {
  constexpr bool GIVEN_O = MODE == kGradGivenO || MODE == kItGivenO;
  const size_t plane = (size_t)a.nb * D * a.W;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    f.xr[d] = f.xi[d] = f.yr[d] = f.yi[d] = f.orr[d] = f.oii[d] = 0.f;
    if (d < D && w < a.W) {
      const size_t i = (size_t)(b * D + d) * a.W + w;
      f.xr[d] = planes[i];
      f.xi[d] = planes[plane + i];
      f.yr[d] = planes[2 * plane + i];
      f.yi[d] = planes[3 * plane + i];
      if (GIVEN_O) {
        f.orr[d] = planes[4 * plane + i];
        f.oii[d] = planes[5 * plane + i];
      }
    }
  }
}

// One bin, every frame, four threads a bin (thread h the m = h mod 4): the
// forward's O (K6, K7: written to o_out; K8), the MSE term (not in K5), and
// the gradient products accumulated over frames into ar/ai at this
// thread's rows (not in K6, nor when !grad: K8's last iteration; wv
// applied later, or in K8 to E before them).  The DC bin's threads write
// db, dp (scaled) to dbdp.  D is a template argument: with a run-time D
// every channel's loads sat behind their own branch, one shared-memory
// latency each.
template <int MODE, int D>
__device__ float tc_bin_pass(const float* __restrict__ sr,
                             const float* __restrict__ si,
                             float* __restrict__ ar, float* __restrict__ ai,
                             float* __restrict__ swv, const Dims& a,
                             const float* __restrict__ planes,
                             const float* __restrict__ wvg,
                             const float* __restrict__ bias_b,
                             const float* __restrict__ bias_p,
                             float* __restrict__ o_out, int tile,
                             float* __restrict__ dbdp, const Frame& first,
                             bool grad) {
  constexpr bool FWD = MODE == kFwd || MODE == kFwdGrad || MODE == kItFwd;
  constexpr bool GRAD = MODE != kFwd;
  constexpr bool MSE = MODE != kGradGivenO;
  constexpr bool ERW = MODE == kItGivenO || MODE == kItFwd;  // E weighted
  constexpr bool CONVK = MODE == kFwd;   // conv_k: X times 1/M first
  constexpr bool WRITE_O = MODE == kFwd || MODE == kFwdGrad;
  const int u = threadIdx.x / kTPB, h = threadIdx.x % kTPB;
  const int w = tile * kTB + u;
  const bool valid = w < a.W;
  const bool dc = w == 0;
  const int M = a.M, md = M * D;
  const size_t plane = (size_t)a.nb * D * a.W;
  const float wv = valid ? wvg[w] : 0.f;
  if (h == 0) swv[u] = wv;
  sr += u, si += u, ar += u, ai += u;
  float mse = 0.f;
  Frame cur = first;
  for (int b = 0; b < a.nb; ++b) {
    Frame next;
    if (b + 1 < a.nb) load_frame<MODE, D>(next, planes, a, b + 1, w);
    float xr[kMaxD], xi[kMaxD], er[kMaxD], ei[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      xr[d] = cur.xr[d];
      xi[d] = cur.xi[d];
      er[d] = -cur.yr[d];   // -Y, O added below
      ei[d] = -cur.yi[d];
      if (!FWD) {
        er[d] += cur.orr[d];
        ei[d] += cur.oii[d];
      }
    }
    if (FWD) {
      float ur[kMaxD], ui[kMaxD], orr[kMaxD], oii[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        ur[d] = CONVK ? xr[d] * a.inv_m : xr[d];
        ui[d] = CONVK ? xi[d] * a.inv_m : xi[d];
        orr[d] = oii[d] = 0.f;
      }
      for (int m0 = h; m0 < M; m0 += kMU * kTPB)
#pragma unroll
        for (int mi = 0; mi < kMU; ++mi) {
          const int m = m0 + mi * kTPB;
          if (m >= M) break;
          float hr = 0.f, hi = 0.f;
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            if (d < D) {
              const int jc = (m * D + d) * kTBS;
              const float cr = sr[jc], ci = si[jc];
              hr += cr * ur[d] - ci * ui[d];
              hi += cr * ui[d] + ci * ur[d];
            }
          }
          const float bias = dc ? bias_b[m] * a.norm : 0.f;
          if (CONVK) {
            hr = (hr + bias) * a.inv_d;
            hi = hi * a.inv_d;
          } else {
            hr = (hr * a.inv_m + bias) * a.inv_d;
            hi = hi * a.inv_m * a.inv_d;
          }
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            if (d < D) {
              const int j = md + d * M + m;
              const float fr = sr[j * kTBS], fi = si[j * kTBS];
              orr[d] += fr * hr - fi * hi;
              oii[d] += fr * hi + fi * hr;
            }
          }
        }
      // the four quarters of the sum over m, (a + b) + (c + d) in every
      // lane of the bin (float addition commutes)
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
#pragma unroll
          for (int x = 1; x < kTPB; x <<= 1) {
            orr[d] += __shfl_xor_sync(0xffffffffu, orr[d], x);
            oii[d] += __shfl_xor_sync(0xffffffffu, oii[d], x);
          }
          if (dc) orr[d] += bias_p[d] * a.norm;
          if (WRITE_O && valid && h == 0) {
            const size_t i = (size_t)(b * D + d) * a.W + w;
            o_out[i] = orr[d];
            o_out[plane + i] = oii[d];
          }
          er[d] += orr[d];
          ei[d] += oii[d];
        }
      }
    }
    if (MSE) {
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          if (ERW) {  // E weighted once; diff * w = E (E w)
            const float erw = er[d] * wv, eiw = ei[d] * wv;
            if (h == 0) mse += er[d] * erw + ei[d] * eiw;
            er[d] = erw;
            ei[d] = eiw;
          } else if (h == 0) {
            mse += (er[d] * er[d] + ei[d] * ei[d]) * wv;
          }
        }
      }
    }
    if (GRAD && grad) {
      for (int m0 = h; m0 < M; m0 += kMU * kTPB)
#pragma unroll
        for (int mi = 0; mi < kMU; ++mi) {
          const int m = m0 + mi * kTPB;
          if (m >= M) break;
          float hr = 0.f, hi = 0.f, s_r = 0.f, s_i = 0.f;
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            if (d < D) {
              const int jc = (m * D + d) * kTBS;
              const float cr = sr[jc], ci = si[jc];
              hr += cr * xr[d] - ci * xi[d];
              hi += cr * xi[d] + ci * xr[d];
              const int j = md + d * M + m;
              const float fr = sr[j * kTBS], fi = si[j * kTBS];
              s_r += er[d] * fr + ei[d] * fi;
              s_i += ei[d] * fr - er[d] * fi;
            }
          }
          if (dc) {
            hr += bias_b[m] * a.norm;
            dbdp[m] = (b == 0 ? 0.f : dbdp[m]) + s_r;
          }
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) {
            if (d < D) {
              const int jc = (m * D + d) * kTBS, jf = (md + d * M + m) * kTBS;
              // the first frame stores, the others add
              ar[jc] = (b ? ar[jc] : 0.f) + (s_r * xr[d] + s_i * xi[d]);
              ai[jc] = (b ? ai[jc] : 0.f) + (s_i * xr[d] - s_r * xi[d]);
              ar[jf] = (b ? ar[jf] : 0.f) + (er[d] * hr + ei[d] * hi);
              ai[jf] = (b ? ai[jf] : 0.f) + (ei[d] * hr - er[d] * hi);
            }
          }
        }
      if (dc && h == 0) {
        for (int d = 0; d < D; ++d)
          dbdp[M + d] = (b == 0 ? 0.f : dbdp[M + d]) + er[d];
      }
    }
    cur = next;
  }
  if (GRAD && grad && dc) {
    for (int m = h; m < M; m += kTPB) dbdp[m] = dbdp[m] * a.norm * a.scale;
    if (h == 0)
      for (int d = 0; d < D; ++d)
        dbdp[M + d] = dbdp[M + d] * a.norm * a.scale;
  }
  return mse;
}

// The projection's A operand from ar/ai: rows x (64 bins of d_re, then 64
// of -d_im), each times its bin's weight (WEIGHT; K8's products carry it
// already), as PIECES bf16 pieces in tile_off order ([piece][re|im][4096]);
// rows past a.rows are zeros.  One 16-byte core-matrix row (8 bins of one
// row) an item, the 8 rows of a core matrix on 8 neighbouring threads.
template <int PIECES, bool WEIGHT>
__device__ void tc_stage_a(const float* __restrict__ ar,
                           const float* __restrict__ ai,
                           const float* __restrict__ swv,
                           __nv_bfloat16* __restrict__ as, int rows) {
  for (int e = threadIdx.x; e < 2 * kMaxRows * (kTB / 8); e += kTC) {
    const int im = e >> 9, rem = e & 511;
    const int bg = (rem >> 3) & 7, j = ((rem >> 6) << 3) | (rem & 7);
    float v[8];
    if (j < rows) {
      const float4* src =
          reinterpret_cast<const float4*>((im ? ai : ar) + j * kTBS + 8 * bg);
      const float4 lo = src[0], hi = src[1];
      const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = WEIGHT ? __fmul_rn(x[k], swv[8 * bg + k]) : x[k];
        v[k] = im ? -t : t;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    __nv_bfloat16* dst[PIECES];
#pragma unroll
    for (int i = 0; i < PIECES; ++i)
      dst[i] = as + i * 2 * kMaxRows * kTB + im * kMaxRows * kTB +
               wg::tile_off(j, 8 * bg);
    wg::store_row8<PIECES>(v, dst);
  }
}

// dst[o] = sum over k < nrec, in order, of src[k * n_total + o] (times
// scale for o < n_scaled): each thread its outputs o = t + kTC * j, the
// loads of kBatch records for all of them issued before their adds (one
// block reads every record: their latency, not their bytes, bounds it)
constexpr int kOuts = (kMaxRows * kMaxP + 1 + kTC - 1) / kTC;
constexpr int kBatch = 4;
__device__ void sum_records(const float* src, int nrec, int n_total,
                            float* dst, int n_scaled, float scale) {
  // kOuts outputs a thread a pass: one pass up to 5 x 5 taps, more for
  // the chunked contraction of larger kernels
#pragma unroll 1
  for (int base = threadIdx.x; base < n_total; base += kTC * kOuts) {
    float acc[kOuts];
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int o = base + kTC * j;
      acc[j] = o < n_total ? __ldcg(src + o) : 0.f;
    }
    for (int k0 = 1; k0 < nrec; k0 += kBatch) {
      float v[kBatch][kOuts];
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk)
#pragma unroll
        for (int j = 0; j < kOuts; ++j) {
          const int o = base + kTC * j;
          v[kk][j] = (k0 + kk < nrec && o < n_total)
                         ? __ldcg(src + (size_t)(k0 + kk) * n_total + o)
                         : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk)
        if (k0 + kk < nrec)
#pragma unroll
          for (int j = 0; j < kOuts; ++j) acc[j] += v[kk][j];
    }
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int o = base + kTC * j;
      if (o < n_total) dst[o] = o < n_scaled ? acc[j] * scale : acc[j];
    }
  }
}

// dst[0] = sum over k < nrec, in order, of src[k]: records of one float
// (K6's MSE terms) staged through buf [kTC] in shared memory, kTC loaded
// at once, one a thread, and added in order by thread 0: one round trip to
// L2 a level, where sum_records' batches took nrec / 4 and sum_in_order by
// one thread (eight loads in flight) five at the headline's 33 groups.
// With sum_in_order K6 read 5 % slower, 0.0159 against 0.0150 ms
// (scripts/torch_omega_bench.py, NVIDIA H100 80GB HBM3 at 700 W).
__device__ void sum_floats(const float* src, int nrec, float* dst,
                           float* buf) {
  const int t = threadIdx.x;
  float acc = 0.f;
  for (int c0 = 0; c0 < nrec; c0 += kTC) {
    const int m = min(kTC, nrec - c0);
    if (t < m) buf[t] = __ldcg(src + c0 + t);
    __syncthreads();
    if (t == 0)
      for (int k = 0; k < m; ++k) acc = c0 + k ? acc + buf[k] : buf[k];
    __syncthreads();
  }
  if (t == 0) dst[0] = acc;
}

// After the block's stores: true in the block that takes the last of n
// tickets, which then sees every store the other n - 1 blocks made before
// theirs.  One thread fences (release, then acquire) and draws the ticket
// after a barrier, as CUTLASS's semaphore does: a fence in every thread
// cost more than the sums.
__device__ bool ticket(unsigned* counter, int n, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1u) == (unsigned)(n - 1);
    if (*flag) __threadfence();
  }
  __syncthreads();
  return *flag;
}

// The fixed-order sum of the tiles' partials (records of n_total floats):
// the last block of each group of kTG tiles to finish (an atomic ticket
// after a fence) sums the group's records in tile order into gpart; the
// last group's block sums the groups in order into out (times scale below
// n_scaled) and zeroes the tickets for the next launch.  No float atomics:
// the result repeats bit for bit, whatever order the blocks ran in.  ONE:
// records of one float (K6), summed by sum_floats through buf, kTC floats
// of shared memory the block no longer needs.
template <bool ONE>
__device__ void tc_combine(const float* part, float* gpart,
                           unsigned* tickets, float* __restrict__ out,
                           int n_total, int n_scaled, float scale, int ntiles,
                           int* flag, float* buf) {
  const int g = blockIdx.x / kTG, ng = (ntiles + kTG - 1) / kTG;
  const int t0 = g * kTG, t1 = min(ntiles, t0 + kTG);
  if (!ticket(tickets + g, t1 - t0, flag)) return;
  if (ONE)
    sum_floats(part + t0, t1 - t0, gpart + g, buf);
  else
    sum_records(part + (size_t)t0 * n_total, t1 - t0, n_total,
                gpart + (size_t)g * n_total, 0, 1.f);
  if (!ticket(tickets + ng, ng, flag)) return;
  if (ONE)
    sum_floats(gpart, ng, out, buf);
  else
    sum_records(gpart, ng, n_total, out, n_scaled, scale);
  for (int i = threadIdx.x; i <= ng; i += kTC) tickets[i] = 0u;
}

// views into the sweep's dynamic shared memory (tc_smem_bytes(PP))
struct TcSmem {
  __nv_bfloat16 *cfs, *rs, *as, *ps;
  float *ar, *ai, *sr, *si, *red, *swv;
  int* flag;
};

template <int RP, int PP>
__device__ TcSmem tc_carve(unsigned char* smem) {
  TcSmem s;
  s.cfs = reinterpret_cast<__nv_bfloat16*>(smem);              // X
  s.rs = s.cfs + RP * kMaxRows * kMaxP;
  s.ar = reinterpret_cast<float*>(smem);                       // X, later
  s.ai = s.ar + kMaxRows * kTBS;
  s.sr = reinterpret_cast<float*>(smem + kRegion);             // Y
  s.si = s.sr + kMaxRows * kTBS;
  s.as = reinterpret_cast<__nv_bfloat16*>(smem + kRegion);     // Y, later
  s.ps = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kRegion); // Z
  s.red = reinterpret_cast<float*>(s.ps + PP * 2 * kCopy);
  s.swv = s.red + kTC;
  s.flag = reinterpret_cast<int*>(s.swv + kTB);
  return s;
}

// One tile of the sweep: the spectra rebuild on the tensor cores, the
// per-bin pass, the projection on the tensor cores (not in K6; neither it
// nor the gradient products when !project), and the tile's record:
// rec[0 .. rows*P) the partial g, then the MSE term (K6: the MSE term
// alone).  Two warpgroups: each product's cos and sin halves go to one
// each.  cf, bias_b, bias_p may lie in global or shared memory.
template <int MODE, bool BF16, int D>
__device__ __forceinline__ void tc_tile(
    const TcSmem& s, const Dims& a, const float* __restrict__ planes,
    const __nv_bfloat16* __restrict__ tiles, const float* __restrict__ wv,
    const float* __restrict__ cf, const float* __restrict__ bias_b,
    const float* __restrict__ bias_p, float* __restrict__ o_out,
    float* __restrict__ dbdp, float* __restrict__ rec, int tile,
    bool project) {
  using T = Tc<MODE, BF16>;
  constexpr int RT = T::RT, PT = T::PT, RP = T::RP;
  constexpr bool ERW = MODE == kItGivenO || MODE == kItFwd;
  project = T::PROJECT && project;
  const int t = threadIdx.x;
  Frame first;
  load_frame<MODE, D>(first, planes, a, 0, tile * kTB + t / kTPB);

  // the tile's basis copies, by cp.async, a chunk of kMaxP taps at a
  // time: the rebuild's, and with the first chunk the projection's first
  // (waited for only before the projection)
  const __nv_bfloat16* rsrc =
      tiles + (size_t)tile * a.nc * tc_tile_elems(RT, PT);
  const __nv_bfloat16* psrc = rsrc + (size_t)a.nc * RP * 2 * kCopy;
  const int wgi = t / 128;
#pragma unroll 1
  for (int c = 0; c < a.nc; ++c) {
    if (c) __syncthreads();   // both warpgroups done with the last chunk
    for (int q = t; q < RP * 2 * kCopy / 8; q += kTC)
      wg::cp_async16(s.rs + 8 * q, rsrc + (size_t)c * RP * 2 * kCopy + 8 * q);
    wg::cp_async_commit();
    if (project && c == 0)
      for (int q = t; q < T::PP * 2 * kCopy / 8; q += kTC)
        wg::cp_async16(s.ps + 8 * q, psrc + 8 * q);
    wg::cp_async_commit();
    // the compact kernels' pieces: A of the rebuild, rows x the chunk's
    // taps (K = 32)
    const int p0 = c * kMaxP;
    for (int e = t; e < kMaxRows * (kMaxP / 8); e += kTC) {
      const int j = e >> 2, k0 = p0 + 8 * (e & 3);
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (j < a.rows && k0 + k < a.P) ? cf[j * a.P + k0 + k] : 0.f;
      __nv_bfloat16* dst[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i)
        dst[i] = s.cfs + i * kMaxRows * kMaxP + off32(j, k0 - p0);
      wg::store_row8<RP>(v, dst);
    }
    // this chunk's rebuild copy (and, at the first, nothing else) landed
    wg::cp_async_wait<1>();
    wg::fence_stores();
    __syncthreads();

    // the spectra: [rows x 32] . [32 x 64 bins], warpgroup 0 against cos
    // (the real parts), warpgroup 1 against sin (minus the imaginary
    // parts); each chunk accumulates afresh and is added into sr/si with
    // IEEE adds (the per-chunk promotion: the tensor cores truncate as
    // they accumulate)
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wg::pin(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kMaxP / 16; ++ks)
#pragma unroll
      for (int p = 0; p < wg::products(RT); ++p)
        wg::mma_m64n64k16(
            acc,
            wg::desc(s.cfs + wg::prod_a(RT, p) * kMaxRows * kMaxP + ks * 128,
                     512),
            wg::desc(s.rs + wg::prod_b(RT, p) * 2 * kCopy + wgi * kCopy +
                         ks * 128,
                     512),
            (ks == 0 && p == 0) ? 0 : 1);
    wg::commit();
    wg::wait_all();
    wg::pin(acc);
    float* dst = wgi ? s.si : s.sr;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = wg::acc_row(t, i), col = wg::acc_col(t, i);
      if (r < a.rows) {
        const float v = wgi ? -acc[i] : acc[i];
        dst[r * kTBS + col] = c ? dst[r * kTBS + col] + v : v;
      }
    }
  }
  __syncthreads();

  const float v = tc_bin_pass<MODE, D>(s.sr, s.si, s.ar, s.ai, s.swv, a,
                                       planes, wv, bias_b, bias_p, o_out,
                                       tile, dbdp, first, project);
  s.red[t] = v;
  __syncthreads();
  if constexpr (T::PROJECT) {
    if (project) tc_stage_a<T::PP, !ERW>(s.ar, s.ai, s.swv, s.as, a.rows);
  }
  for (int k = kTC / 2; k > 0; k >>= 1) {
    if (t < k) s.red[t] += s.red[t + k];
    __syncthreads();
  }
  const int n = T::PROJECT ? a.rows * a.P : 0;
  if (!project) {
    if (t == 0) rec[n] = s.red[0] / (float)a.nb;
    return;
  }
  wg::cp_async_wait<0>();
  wg::fence_stores();
  __syncthreads();

  // the projection, fresh for this tile, a chunk of kMaxP taps at a time
  // (each chunk's projection copy loaded after the last one's products):
  // warpgroup 0 d_re [rows x 64] . cos [64 x 32 p], warpgroup 1 -d_im
  // against sin; then the two added in that order (warpgroup 1's through
  // region X, free after staging)
  float* xch = s.ar;   // [16][128]: warpgroup 1's sums, thread-private
#pragma unroll 1
  for (int c = 0; c < a.nc; ++c) {
    if (c) {
      __syncthreads();   // both warpgroups done with s.ps and xch
      for (int q = t; q < T::PP * 2 * kCopy / 8; q += kTC)
        wg::cp_async16(s.ps + 8 * q,
                       psrc + (size_t)c * T::PP * 2 * kCopy + 8 * q);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
      wg::fence_stores();
      __syncthreads();
    }
    float g[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) g[i] = 0.f;
    wg::pin(g);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kTB / 16; ++ks)
#pragma unroll
      for (int p = 0; p < wg::products(PT); ++p)
        wg::mma_m64n32k16(
            g,
            wg::desc(s.as + wg::prod_a(PT, p) * 2 * kMaxRows * kTB +
                     wgi * kMaxRows * kTB + ks * 128),
            wg::desc(s.ps + wg::prod_b(PT, p) * 2 * kCopy + wgi * kCopy +
                     ks * 128),
            (ks == 0 && p == 0) ? 0 : 1);
    wg::commit();
    wg::wait_all();
    wg::pin(g);
    if (wgi) {
#pragma unroll
      for (int i = 0; i < 16; ++i) xch[i * 128 + t - 128] = g[i];
    }
    __syncthreads();
    if (!wgi) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = wg::acc_row(t, i);
        const int col = c * kMaxP + wg::acc_col(t, i);
        if (r < a.rows && col < a.P)
          rec[r * a.P + col] = g[i] + xch[i * 128 + t];
      }
    }
  }
  if (t == 0) rec[n] = s.red[0] / (float)a.nb;
}

// K5 (kGradGivenO), K6 (kFwd) and K7 (kFwdGrad): one tile a block, then
// the fixed-order sum of the tiles' records into out (g times scale, then
// the MSE sum; K6: the MSE sum).
template <int MODE, bool BF16, int D>
__global__ void __launch_bounds__(kTC, (Tc<MODE, BF16>::kBlocks))
tc_sweep_kernel(const float* __restrict__ planes,
                const __nv_bfloat16* __restrict__ tiles,
                const float* __restrict__ wv, const float* __restrict__ cf,
                const float* __restrict__ bias_b,
                const float* __restrict__ bias_p, float* __restrict__ o_out,
                float* part, float* gpart, unsigned* tickets,
                float* __restrict__ out, float* __restrict__ dbdp, Dims a) {
  using T = Tc<MODE, BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem s = tc_carve<T::RP, T::PP>(smem);
  const int nrec = T::PROJECT ? a.rows * a.P + 1 : 1;
  tc_tile<MODE, BF16, D>(s, a, planes, tiles, wv, cf, bias_b, bias_p, o_out,
                         dbdp, part + (size_t)blockIdx.x * nrec, blockIdx.x,
                         true);
  tc_combine<!T::PROJECT>(part, gpart, tickets, out, nrec, nrec - 1, a.scale,
                          a.ntiles, s.flag, s.red);
}

// sum over k < nrec, in order, of src[k * stride]: the loads of 8 records
// in flight before their adds (from L2: other blocks wrote them)
__device__ __forceinline__ float sum_in_order(const float* src, int nrec,
                                              size_t stride) {
  float acc = 0.f;
  for (int k0 = 0; k0 < nrec; k0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = k0 + k < nrec ? __ldcg(src + (k0 + k) * stride) : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < nrec) acc = k0 + k ? acc + v[k] : v[k];
  }
  return acc;
}

// K8: the whole burst in one cooperative launch, every block resident, each
// striding over the tiles.  state_in/state_out: cf [rows*P], b [M], p [D],
// then the momenta in that layout; mse_out [iters+1] (raw, / nb); part
// [ntiles][rows*P + 1], gpart [groups][rows*P + 1], gsum [rows*P + M + D],
// dbdp [M + D] in global scratch.  Per iteration: the inertia update from
// gsum (not at iteration 0) on the block's own copy of the state; the
// block's tiles; a grid barrier; the (group, output) sums in tile order
// spread over the grid; a barrier; each output's sum over the groups in
// order (times scale: g) and db, dp into gsum, the MSE into mse_out; a
// barrier.  The last iteration needs only its MSE: no gradient products,
// no projection.  Two blocks an SM, but one for float32 operands at D = 1:
// held to 128 registers it spilled 52 bytes (152 at one block an SM).
template <bool BF16, int D>
__global__ void __launch_bounds__(kTC, (BF16 || D > 1) ? 2 : 1)
tc_itergrid_kernel(const float* __restrict__ planes,
                   const __nv_bfloat16* __restrict__ tiles,
                   const float* __restrict__ wv,
                   const float* __restrict__ state_in,
                   float* __restrict__ state_out, float* __restrict__ mse_out,
                   float* part, float* gpart, float* gsum, float* dbdp,
                   Dims a, int iters, float lr_eff, float alpha) {
  using T = Tc<kItFwd, BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem s = tc_carve<T::RP, T::PP>(smem);
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, M = a.M;
  const int n = a.rows * a.P, ns = n + M + D;
  float* st =    // the weights, then the momenta
      reinterpret_cast<float*>(smem + tc_smem_bytes(T::PP));
  for (int i = t; i < 2 * ns; i += kTC) st[i] = state_in[i];
  __syncthreads();
  const int ng = (a.ntiles + kTG - 1) / kTG;
  const int gt = blockIdx.x * kTC + t, gn = gridDim.x * kTC;
  const size_t nrec = (size_t)n + 1;
  for (int it = 0; it <= iters; ++it) {
    if (it) {  // inertia (backprop_d) from the summed gradients
      for (int i = t; i < ns; i += kTC) {
        const float g = __ldcg(gsum + i);
        const float dw =
            (1.f - alpha) * lr_eff * g / fmaxf(fabsf(g), kGradClip) +
            alpha * st[ns + i];
        st[i] = st[i] - dw;
        st[ns + i] = dw;
      }
      __syncthreads();
    }
    const bool project = it < iters;
    for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
      if (it == 0)
        tc_tile<kItGivenO, BF16, D>(s, a, planes, tiles, wv, st, st + n,
                                    st + n + M, nullptr, dbdp,
                                    part + tile * nrec, tile, project);
      else
        tc_tile<kItFwd, BF16, D>(s, a, planes, tiles, wv, st, st + n,
                                 st + n + M, nullptr, dbdp,
                                 part + tile * nrec, tile, project);
      __syncthreads();
    }
    grid.sync();
    // level 1: each group's sum of each output over its tiles, in order
    const int o0 = project ? 0 : n, no = n + 1 - o0;
    for (int item = gt; item < ng * no; item += gn) {
      const int g = item / no, o = o0 + item - g * no;
      const int t0 = g * kTG;
      gpart[g * nrec + o] =
          sum_in_order(part + t0 * nrec + o, min(kTG, a.ntiles - t0), nrec);
    }
    grid.sync();
    // level 2: each output's sum over the groups, in order
    for (int o = o0 + gt; o <= n; o += gn) {
      const float acc = sum_in_order(gpart + o, ng, nrec);
      if (o < n) gsum[o] = acc * a.scale;
      else mse_out[it] = acc;
    }
    if (!project) break;
    for (int o = gt; o < M + D; o += gn) gsum[n + o] = __ldcg(dbdp + o);
    grid.sync();
  }
  if (blockIdx.x == 0)
    for (int i = t; i < 2 * ns; i += kTC) state_out[i] = st[i];
}

// the instantiation for (MODE, bf16, D)
typedef void (*TcKernel)(const float*, const __nv_bfloat16*, const float*,
                         const float*, const float*, const float*, float*,
                         float*, float*, unsigned*, float*, float*, Dims);
template <int MODE, bool BF16>
TcKernel tc_kernel_d(int D) {
  switch (D) {
    case 1: return tc_sweep_kernel<MODE, BF16, 1>;
    case 2: return tc_sweep_kernel<MODE, BF16, 2>;
    case 3: return tc_sweep_kernel<MODE, BF16, 3>;
    default: return tc_sweep_kernel<MODE, BF16, 4>;
  }
}
template <int MODE>
TcKernel tc_kernel(int bf16, int D) {
  return bf16 ? tc_kernel_d<MODE, true>(D) : tc_kernel_d<MODE, false>(D);
}

typedef void (*ItKernel)(const float*, const __nv_bfloat16*, const float*,
                         const float*, float*, float*, float*, float*,
                         float*, float*, Dims, int, float, float);
template <bool BF16>
ItKernel it_kernel_d(int D) {
  switch (D) {
    case 1: return tc_itergrid_kernel<BF16, 1>;
    case 2: return tc_itergrid_kernel<BF16, 2>;
    case 3: return tc_itergrid_kernel<BF16, 3>;
    default: return tc_itergrid_kernel<BF16, 4>;
  }
}
ItKernel it_kernel(int bf16, int D) {
  return bf16 ? it_kernel_d<true>(D) : it_kernel_d<false>(D);
}

// K8's dynamic shared memory: the sweep's, then the state
size_t it_smem(const Dims& a, int bf16) {
  return (size_t)tc_smem(kItFwd, bf16) +
         2 * sizeof(float) * ((size_t)a.rows * a.P + a.M + a.D);
}

template <int MODE>
int launch_tc(const void* planes, const void* tiles, const void* wv,
              const void* cf, const void* bias_b, const void* bias_p,
              void* o_out, void* out, void* dbdp, void* scratch,
              void* tickets, const Dims& a, int bf16, cudaStream_t st) {
  const TcKernel k = tc_kernel<MODE>(bf16, a.D);
  const int bytes = tc_smem(MODE, bf16);
  int err = set_smem(k, bytes);
  if (err) return err;
  const size_t nrec = MODE == kFwd ? 1 : (size_t)a.rows * a.P + 1;
  float* part = static_cast<float*>(scratch);
  float* gpart = part + a.ntiles * nrec;
  k<<<a.ntiles, kTC, bytes, st>>>(
      static_cast<const float*>(planes),
      static_cast<const __nv_bfloat16*>(tiles),
      static_cast<const float*>(wv), static_cast<const float*>(cf),
      static_cast<const float*>(bias_b), static_cast<const float*>(bias_p),
      static_cast<float*>(o_out), part, gpart,
      static_cast<unsigned*>(tickets), static_cast<float*>(out),
      static_cast<float*>(dbdp), a);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the launches below need (0 if the shape cannot run):
// a record per 64-bin tile and per group of 16 tiles, kind 0 = K5/K7
// (rows*P + 1 floats a record), 1 = K6 (one float), 2 = K8 (as K5, then its
// gradient sums and db, dp).
extern "C" long long omega_scratch_floats(int kind, int nb, int M, int D,
                                          int P, int W) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, 1.f, 1.f, 1.f, 1.f, &a)) return 0;
  const long long n = (long long)a.rows * a.P;
  const long long recs = a.ntiles + (a.ntiles + kTG - 1) / kTG;
  if (kind == 1) return recs;
  if (kind == 0) return recs * (n + 1);
  return recs * (n + 1) + n + 2 * (M + D);
}

// K5.  planes: [6][nb*D][W] f32 (X re, im, Y re, im, O re, im); tiles:
// the basis as the tensor-core sweep's tiles (bf16, tc_tile_elems a tile of
// 64 bins; ops/burst_kernels.py basis_tiles); wv [W]; cf [2MD][P] (c rows
// m*D+d, then f rows d*M+m); b [M]; out: g [2MD*P] then one unused float;
// dbdp: db [M], dp [D]; scratch: omega_scratch_floats(0, ...); tickets:
// ceil(ceil(W/64)/16) + 1 zeros, left zero by the launch.
extern "C" int omega_grad_project_launch(
    const void* planes, const void* tiles, const void* wv, const void* cf,
    const void* b, void* out, void* dbdp, void* scratch, void* tickets,
    int nb, int M, int D, int P, int W, float norm, float scale, int bf16,
    void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, 1.f, 1.f, scale, &a))
    return (int)cudaErrorInvalidValue;
  return launch_tc<kGradGivenO>(planes, tiles, wv, cf, b, nullptr, nullptr,
                                out, dbdp, scratch, tickets, a, bf16,
                                static_cast<cudaStream_t>(stream));
}

// The tensor-core sweeps with float32 or bf16 operands, for D channels
// (1..4): kind 0 = K5, 1 = K7, 2 = K6, 3 = K8 (its shared memory at the
// largest state, kMaxRows x kMaxP): registers, local bytes, static and
// dynamic shared memory (wg::attrs) into out[0..3].
extern "C" int omega_tc_attrs(int kind, int bf16, int D, int* out) {
  if (D < 1 || D > kMaxD || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  if (kind == 3) {
    Dims a;
    make_dims(1, kMaxRows / (2 * D), D, kMaxP, 1, 1.f, 1.f, 1.f, 1.f, &a);
    return wg::attrs(it_kernel(bf16, D), (int)it_smem(a, bf16), out);
  }
  const int mode = kind == 0 ? kGradGivenO : kind == 1 ? kFwdGrad : kFwd;
  const TcKernel k = mode == kGradGivenO ? tc_kernel<kGradGivenO>(bf16, D)
                     : mode == kFwdGrad  ? tc_kernel<kFwdGrad>(bf16, D)
                                         : tc_kernel<kFwd>(bf16, D);
  return wg::attrs(k, tc_smem(mode, bf16), out);
}

// K6.  planes: [4 or 6][nb*D][W] (X, Y read); tiles as K5's (K6 reads the
// rebuild's part of each tile record); o_out: [2][nb*D][W]; mse_out [1]:
// sum over bins of w |O - Y|^2 / nb; scratch: omega_scratch_floats(1, ...);
// tickets as K5's.
extern "C" int omega_respectra_launch(
    const void* planes, const void* tiles, const void* wv, const void* cf,
    const void* b, const void* p, void* o_out, void* mse_out, void* scratch,
    void* tickets, int nb, int M, int D, int P, int W, float norm,
    float inv_m, float inv_d, int bf16, void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, inv_m, inv_d, 1.f, &a))
    return (int)cudaErrorInvalidValue;
  return launch_tc<kFwd>(planes, tiles, wv, cf, b, p, o_out, mse_out,
                         nullptr, scratch, tickets, a, bf16,
                         static_cast<cudaStream_t>(stream));
}

// K7.  As K6, and the next gradients: out = g [2MD*P] then the MSE sum;
// dbdp: db [M], dp [D]; tiles, scratch and tickets as K5's.
extern "C" int omega_fused_step_launch(
    const void* planes, const void* tiles, const void* wv, const void* cf,
    const void* b, const void* p, void* o_out, void* out, void* dbdp,
    void* scratch, void* tickets, int nb, int M, int D, int P, int W,
    float norm, float inv_m, float inv_d, float scale, int bf16,
    void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, inv_m, inv_d, scale, &a))
    return (int)cudaErrorInvalidValue;
  return launch_tc<kFwdGrad>(planes, tiles, wv, cf, b, p, o_out, out, dbdp,
                             scratch, tickets, a, bf16,
                             static_cast<cudaStream_t>(stream));
}

// K8.  planes as K5 (O = O0); tiles as K5's; state_in/state_out: cf
// [2MD*P], b [M], p [D], then their momenta in the same layout; mse_out
// [iters + 1]; scratch: omega_scratch_floats(2, ...).  One cooperative
// launch; returns cudaErrorNotSupported where the device has no
// cooperative launch.
extern "C" int omega_itergrid_launch(
    const void* planes, const void* tiles, const void* wv,
    const void* state_in, void* state_out, void* mse_out, void* scratch,
    int nb, int M, int D, int P, int W, int iters, float norm, float inv_m,
    float inv_d, float scale, float lr_eff, float alpha, int bf16,
    void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, inv_m, inv_d, scale, &a) || iters < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err) return err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const ItKernel k = it_kernel(bf16, D);
  const size_t bytes = it_smem(a, bf16);
  err = set_smem(k, bytes);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kTC,
                                                           bytes);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int blocks = per_sm * sms;
  if (blocks > a.ntiles) blocks = a.ntiles;
  const size_t nrec = (size_t)a.rows * a.P + 1;
  float* part = static_cast<float*>(scratch);
  float* gpart = part + a.ntiles * nrec;
  float* gsum = gpart + ((a.ntiles + kTG - 1) / kTG) * nrec;
  float* dbdp = gsum + (nrec - 1) + M + D;
  const float* pl = static_cast<const float*>(planes);
  const __nv_bfloat16* tl = static_cast<const __nv_bfloat16*>(tiles);
  const float* w = static_cast<const float*>(wv);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  float* mo = static_cast<float*>(mse_out);
  void* args[] = {&pl, &tl, &w, &si, &so, &mo, &part, &gpart, &gsum, &dbdp,
                  &a, &iters, &lr_eff, &alpha};
  err = (int)cudaLaunchCooperativeKernel((const void*)k, dim3(blocks),
                                         dim3(kTC), args, bytes,
                                         static_cast<cudaStream_t>(stream));
  if (err) return err;
  return (int)cudaGetLastError();
}
