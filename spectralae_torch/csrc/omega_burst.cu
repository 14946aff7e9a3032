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
// K6 returns O and sum w|O - Y|^2 / nb; K7 both, in one sweep; K8 runs the
// whole burst (iteration 0 the gradient pass on O0, then per iteration the
// inertia update, the forward and the next gradients) with E weighted by wv
// before the products, as the TPU kernel does (the same sums in another
// rounding).  mxu_bf16 rounds the operands of the four basis products to
// bf16 (the JAX mxu_dtype), accumulating in float32.
//
// K6 and K8 (sweep_kernel, itergrid_kernel) keep their first design.
// What bounds them on Hopper: float32 operations.  At D = 3, M = 10, 5x5
// kernels the four basis products are 2 * 2 * 60 * 25 = 6,000 FMAs a bin
// per sweep against ~100 bytes of planes and basis, far above the card's
// flop/byte balance; they run them on the CUDA cores in IEEE float32:
//  - one block per tile of 128 bins, one thread per bin; the basis tile
//    goes to shared memory as [bin][p] (conflict-free rows of P floats),
//    the compact kernels as [row][p] (broadcast reads); each thread holds
//    its bin's 2P basis values in registers and writes the 2MD rebuilt
//    spectra to shared memory, then walks the frames and channels with
//    only D complex planes in registers, accumulating dc/df per bin in
//    shared memory;
//  - the projection is a [2MD, 128] x [128, P] product per tile, one
//    thread per (row, 5 p), from shared memory;
//  - sums across tiles are deterministic: each tile writes its partial g
//    and MSE to scratch, and a second grid (K6) or, in K8, a stage after a
//    grid-wide barrier sums them in tile order — no float atomics, so a
//    burst repeats bit for bit and its result does not depend on how many
//    blocks ran;
//  - the masked tail: bins past W read zeros and weigh nothing, as the
//    TPU kernel's zero-padded basis and wv do.
//
// K5 and K7 (tc_sweep_kernel) run the two basis products on the tensor
// cores, which leaves them bound by bytes: at the JAX benchmark's headline
// (one 256^2 frame, W = 33,024) 9.1 MB of planes, basis and weights, 2.7
// us at the card's memory rate, against 1.8 us of wgmma passes and 0.8 us
// of per-bin float32 work.  The design:
//  - one block of two warpgroups per 64-bin tile, four threads a bin
//    (each the m = h mod 4 of the per-bin sums), ~89 KB of shared memory:
//    two blocks, 16 warps, an SM; 516 blocks at the headline, 130 at the
//    stream's pair-0 input (W = 8,320);
//  - the spectra rebuild [64 rows x 32 p] . [32 p x 64 bins] and the
//    projection [64 rows x 64 bins] . [64 bins x 32 p] as m64n64k16 and
//    m64n32k16 wgmma from shared memory, rows padded 60 -> 64 and P 25 ->
//    32 with zeros, cos on one warpgroup and sin on the other; operands as
//    bf16 pieces (wgmma.cuh): with bf16 operands one product (the JAX
//    mxu_dtype), with float32 ones bf16x6 for the rebuild (bf16x3 left O
//    8-9e-6 from the float32 product) and bf16x3 for the projection, each
//    tile's projection fresh (the per-chunk promotion: the tensor cores
//    truncate as they accumulate); never TF32;
//  - the host lays the basis out once in the kernel's tile order, two
//    copies ([bin][p] for the rebuild, [p][bin] for the projection), and
//    a block takes its tile's by cp.async; the compact kernels are split
//    into pieces in the block, the gradient products written straight into
//    the projection's A layout as pieces;
//  - D is a template argument (the channel loops unroll without branches);
//    the first frame's planes load before anything else, each next frame's
//    during the current one;
//  - one grid a launch: each tile writes its partial; the last block of
//    each group of 16 tiles to take an atomic ticket (one fence a block,
//    after a barrier) sums the group's partials in tile order, the last
//    group's block sums the groups in order.  No float atomics: the result
//    repeats bit for bit, whatever order the blocks ran in.
// What remains (scripts/torch_omega_timeline.py): per block ~3.5 us of
// setup (the 40 KB of basis pieces a tile; float32 operands) and the
// rebuild, 2.3 us of per-bin pass a frame at nb = 1 and 1.5 us a frame at
// nb = 8, and a serial tail of ~7-9 us after the last partial (two fences
// and the last group's and the groups' sums).

// K8, the whole burst in one launch: a cooperative launch
// (cudaLaunchCooperativeKernel) with every block resident (grid sized by
// the occupancy query, blocks striding over the tiles).  Per iteration:
// stage A, each block sweeps its tiles and writes per-tile partials; grid
// barrier; stage B, the grid sums each partial in tile order (outputs
// spread over all threads) into a 1,513-float gradient; grid barrier; then
// every block applies the inertia to its own shared-memory copy of the
// weights and momenta, the same float32 operations in every block.  O is
// recomputed from the current weights each iteration and needs no storage
// between iterations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 128;        // bins per tile = threads per block
constexpr int kTS = kT + 1;    // padded row stride of the per-bin arrays
constexpr int kMaxD = 4;
constexpr int kMaxP = 32;
constexpr int kMaxRows = 64;   // 2 * M * D
constexpr int kGroup = 5;      // p values per projection item
constexpr float kGradClip = 10.f;

struct Dims {
  int nb, M, D, P, W, rows, ntiles;
  float norm, inv_m, inv_d, scale;
};

enum Mode { kGradGivenO, kFwd, kFwdGrad, kItGivenO, kItFwd };

template <bool BF16>
__device__ __forceinline__ float mx(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// views into dynamic shared memory
struct Smem {
  float* cf;    // [rows][P] the compact kernels in use
  float* cosT;  // [kT][P] basis tile
  float* sinT;
  float* sr;    // [rows][kTS] rebuilt spectra, re and im
  float* si;
  float* ar;    // [rows][kTS] gradient products dc/df, re and im
  float* ai;
  float* red;   // [kT]
  float* st;    // K8: mcf [rows*P], b [M], mb [M], p [D], mp [D]
};

size_t smem_floats(const Dims& a, bool itergrid) {
  const size_t n = (size_t)a.rows * a.P;
  return n + 2 * (size_t)kT * a.P + 4 * (size_t)a.rows * kTS + kT +
         (itergrid ? n + 2 * (size_t)(a.M + a.D) : 0);
}

__device__ Smem carve(float* base, const Dims& a) {
  Smem s;
  const int n = a.rows * a.P;
  s.cf = base;
  s.cosT = s.cf + n;
  s.sinT = s.cosT + kT * a.P;
  s.sr = s.sinT + kT * a.P;
  s.si = s.sr + a.rows * kTS;
  s.ar = s.si + a.rows * kTS;
  s.ai = s.ar + a.rows * kTS;
  s.red = s.ai + a.rows * kTS;
  s.st = s.red + kT;
  return s;
}

// the tile's basis columns into cosT/sinT (zeros past W)
__device__ void load_basis(const Smem& s, const Dims& a,
                           const float* __restrict__ basis, int tile) {
  const int t = threadIdx.x;
  const int w = tile * kT + t;
  const bool valid = w < a.W;
  const size_t plane = (size_t)a.P * a.W;
  for (int p = 0; p < a.P; ++p) {
    s.cosT[t * a.P + p] = valid ? basis[(size_t)p * a.W + w] : 0.f;
    s.sinT[t * a.P + p] = valid ? basis[plane + (size_t)p * a.W + w] : 0.f;
  }
}

// the rebuilt spectra of this thread's bin: re = cf . cos, im = -(cf . sin)
template <bool BF16>
__device__ void spectra(const Smem& s, const Dims& a) {
  const int t = threadIdx.x;
  float c[kMaxP], sn[kMaxP];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) {
    c[p] = p < a.P ? mx<BF16>(s.cosT[t * a.P + p]) : 0.f;
    sn[p] = p < a.P ? mx<BF16>(s.sinT[t * a.P + p]) : 0.f;
  }
  for (int j = 0; j < a.rows; ++j) {
    const float* k = s.cf + j * a.P;
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p < a.P) {
        const float kv = mx<BF16>(k[p]);
        re += kv * c[p];
        im += kv * sn[p];
      }
    }
    s.sr[j * kTS + t] = re;
    s.si[j * kTS + t] = -im;
  }
}

// One bin, every frame: the forward (O, written to o_out when given), the
// MSE term and the gradient products.  Returns this bin's MSE term; the DC
// thread writes db, dp (scaled) to dbdp.
template <int MODE>
__device__ float bin_pass(const Smem& s, const Dims& a,
                          const float* __restrict__ planes,
                          const float* __restrict__ wvg,
                          const float* __restrict__ bias_b,
                          const float* __restrict__ bias_p,
                          float* __restrict__ o_out, int tile,
                          float* __restrict__ dbdp) {
  static_assert(MODE == kFwd || MODE == kItGivenO || MODE == kItFwd,
                "K5 and K7 run tc_bin_pass");
  constexpr bool GRAD = MODE != kFwd;
  constexpr bool FWD = MODE == kFwd || MODE == kItFwd;
  constexpr bool ERW = MODE == kItGivenO || MODE == kItFwd;
  const int t = threadIdx.x;
  const int w = tile * kT + t;
  const bool valid = w < a.W;
  const bool dc = w == 0;
  const int M = a.M, D = a.D, md = M * D;
  const size_t plane = (size_t)a.nb * D * a.W;
  const float wv = valid ? wvg[w] : 0.f;
  const float* sr = s.sr + t;
  const float* si = s.si + t;
  float* ar = s.ar + t;
  float* ai = s.ai + t;
  if (GRAD) {
    for (int j = 0; j < a.rows; ++j) {
      ar[j * kTS] = 0.f;
      ai[j * kTS] = 0.f;
    }
  }
  float mse = 0.f;
  for (int b = 0; b < a.nb; ++b) {
    float xr[kMaxD], xi[kMaxD], er[kMaxD], ei[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      xr[d] = xi[d] = er[d] = ei[d] = 0.f;
      if (d < D && valid) {
        const size_t i = (size_t)(b * D + d) * a.W + w;
        xr[d] = planes[i];
        xi[d] = planes[plane + i];
        er[d] = -planes[2 * plane + i];   // -Y, O added below
        ei[d] = -planes[3 * plane + i];
        if (!FWD) {
          er[d] += planes[4 * plane + i];
          ei[d] += planes[5 * plane + i];
        }
      }
    }
    if (FWD) {
      float orr[kMaxD], oii[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) orr[d] = oii[d] = 0.f;
      for (int m = 0; m < M; ++m) {
        float hr = 0.f, hi = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) {
            const float cr = sr[(m * D + d) * kTS], ci = si[(m * D + d) * kTS];
            if (MODE == kFwd) {  // conv_k: the input scaled by 1/M first
              const float ur = xr[d] * a.inv_m, ui = xi[d] * a.inv_m;
              hr += cr * ur - ci * ui;
              hi += cr * ui + ci * ur;
            } else {
              hr += cr * xr[d] - ci * xi[d];
              hi += cr * xi[d] + ci * xr[d];
            }
          }
        }
        const float bias = dc ? bias_b[m] * a.norm : 0.f;
        if (MODE == kFwd) {
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
            const float fr = sr[j * kTS], fi = si[j * kTS];
            orr[d] += fr * hr - fi * hi;
            oii[d] += fr * hi + fi * hr;
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          if (dc) orr[d] += bias_p[d] * a.norm;
          if (valid && o_out) {
            const size_t i = (size_t)(b * D + d) * a.W + w;
            o_out[i] = orr[d];
            o_out[plane + i] = oii[d];
          }
          er[d] += orr[d];
          ei[d] += oii[d];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        if (ERW) {  // E weighted once; diff * w = E (E w)
          const float erw = er[d] * wv, eiw = ei[d] * wv;
          mse += er[d] * erw + ei[d] * eiw;
          er[d] = erw;
          ei[d] = eiw;
        } else if (FWD) {
          mse += (er[d] * er[d] + ei[d] * ei[d]) * wv;
        }
      }
    }
    if (GRAD) {
      for (int m = 0; m < M; ++m) {
        float hr = 0.f, hi = 0.f, s_r = 0.f, s_i = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) {
            const float cr = sr[(m * D + d) * kTS], ci = si[(m * D + d) * kTS];
            hr += cr * xr[d] - ci * xi[d];
            hi += cr * xi[d] + ci * xr[d];
            const int j = md + d * M + m;
            const float fr = sr[j * kTS], fi = si[j * kTS];
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
            const int jc = (m * D + d) * kTS, jf = (md + d * M + m) * kTS;
            ar[jc] += s_r * xr[d] + s_i * xi[d];
            ai[jc] += s_i * xr[d] - s_r * xi[d];
            ar[jf] += er[d] * hr + ei[d] * hi;
            ai[jf] += ei[d] * hr - er[d] * hi;
          }
        }
      }
      if (dc) {
        for (int d = 0; d < D; ++d)
          dbdp[M + d] = (b == 0 ? 0.f : dbdp[M + d]) + er[d];
      }
    }
  }
  if (GRAD && dc) {
    for (int k = 0; k < M + D; ++k) dbdp[k] = dbdp[k] * a.norm * a.scale;
  }
  return mse;
}

// sum of the block's per-thread MSE terms, in a fixed order, / nb
__device__ float block_mse(const Smem& s, const Dims& a, float v) {
  const int t = threadIdx.x;
  s.red[t] = v;
  __syncthreads();
  for (int k = kT / 2; k > 0; k >>= 1) {
    if (t < k) s.red[t] += s.red[t + k];
    __syncthreads();
  }
  const float out = s.red[0] / (float)a.nb;
  __syncthreads();
  return out;
}

// the tile's projected gradients: out[j, p] = sum_bins dr cos - sum di sin
template <bool BF16>
__device__ void project(const Smem& s, const Dims& a, float* __restrict__ out) {
  const int groups = (a.P + kGroup - 1) / kGroup;
  for (int item = threadIdx.x; item < a.rows * groups; item += kT) {
    const int j = item / groups;
    const int p0 = (item - j * groups) * kGroup;
    float gr[kGroup], gi[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) gr[k] = gi[k] = 0.f;
    const float* dr = s.ar + j * kTS;
    const float* di = s.ai + j * kTS;
    for (int u = 0; u < kT; ++u) {
      const float vr = mx<BF16>(dr[u]), vi = mx<BF16>(di[u]);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (p0 + k < a.P) {
          gr[k] += vr * mx<BF16>(s.cosT[u * a.P + p0 + k]);
          gi[k] += vi * mx<BF16>(s.sinT[u * a.P + p0 + k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (p0 + k < a.P) out[j * a.P + p0 + k] = gr[k] - gi[k];
  }
}

__device__ void load_cf(const Smem& s, const Dims& a, const float* cf) {
  for (int i = threadIdx.x; i < a.rows * a.P; i += kT) s.cf[i] = cf[i];
}

// K6: per tile, the MSE term of its bins (O written to o_out)
template <bool BF16>
__global__ void __launch_bounds__(kT)
sweep_kernel(const float* __restrict__ planes, const float* __restrict__ basis,
             const float* __restrict__ wv, const float* __restrict__ cf,
             const float* __restrict__ bias_b, const float* __restrict__ bias_p,
             float* __restrict__ o_out, float* __restrict__ part,
             float* __restrict__ dbdp, Dims a) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), a);
  const int tile = blockIdx.x;
  load_cf(s, a, cf);
  load_basis(s, a, basis, tile);
  __syncthreads();
  spectra<BF16>(s, a);
  __syncthreads();
  const float v = bin_pass<kFwd>(s, a, planes, wv, bias_b, bias_p, o_out,
                                 tile, dbdp);
  const float mse = block_mse(s, a, v);
  if (threadIdx.x == 0) part[tile] = mse;
}

// out[o] = sum over tiles, in tile order, of part[tile][o] (times scale for
// o < n_scaled); the record of a tile is n_total floats
__global__ void __launch_bounds__(kT)
reduce_kernel(const float* __restrict__ part, int ntiles, int n_total,
              int n_scaled, float scale, float* __restrict__ out) {
  const int o = blockIdx.x * kT + threadIdx.x;
  if (o >= n_total) return;
  const float f = o < n_scaled ? scale : 1.f;
  float acc = 0.f;
  for (int t = 0; t < ntiles; ++t) acc += part[(size_t)t * n_total + o] * f;
  out[o] = acc;
}

bool make_dims(int nb, int M, int D, int P, int W, float norm, float inv_m,
               float inv_d, float scale, Dims* a) {
  if (nb < 1 || M < 1 || D < 1 || D > kMaxD || P < 1 || P > kMaxP || W < 1 ||
      2 * M * D > kMaxRows)
    return false;
  a->nb = nb;
  a->M = M;
  a->D = D;
  a->P = P;
  a->W = W;
  a->rows = 2 * M * D;
  a->ntiles = (W + kT - 1) / kT;
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

// ---------------------------------------------------------------------
// K5 and K7 on the tensor cores: two warpgroups a tile of kTB bins.

constexpr int kTB = 64;          // bins a tile (block)
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

// elements of one tile's basis copies in global memory: the rebuild's
// [piece][cos|sin][off32(bin, p)], then the projection's
// [piece][cos|sin][tile_off(p, bin)]
__host__ __device__ constexpr int tc_tile_elems(int rt, int pt) {
  return (wg::pieces(rt) + wg::pieces(pt)) * 2 * kCopy;
}

// shared memory (bytes): region X holds the compact kernels' pieces and
// the rebuild's basis copy, then the gradient products ar/ai; region Y the
// rebuilt spectra sr/si, then the projection's A pieces; region Z the
// projection's basis copy; then the MSE terms, the bins' weights, a flag
constexpr int kRegion = 2 * kMaxRows * kTBS * 4;
__host__ __device__ constexpr int tc_smem_bytes(int pt) {
  return 2 * kRegion + wg::pieces(pt) * 2 * kCopy * 2 + (kTC + kTB + 4) * 4;
}
static_assert(2 * 3 * (kMaxRows * kMaxP + 2 * kCopy) <= kRegion,
              "the rebuild's operands fit region X");
static_assert(2 * 2 * 2 * kMaxRows * kTB <= kRegion,
              "the projection's A pieces fit region Y");

// One frame's planes at one bin, as loaded (zeros past W): X, Y, and O for
// K5.  The pass loads the next frame's while it works on this one, and the
// kernel the first frame's before anything else, so the loads' latency
// overlaps the work.
struct Frame {
  float xr[kMaxD], xi[kMaxD], yr[kMaxD], yi[kMaxD], orr[kMaxD], oii[kMaxD];
};

template <int MODE, int D>
__device__ __forceinline__ void load_frame(Frame& f,
                                           const float* __restrict__ planes,
                                           const Dims& a, int b, int w) {
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
      if (MODE != kFwdGrad) {
        f.orr[d] = planes[4 * plane + i];
        f.oii[d] = planes[5 * plane + i];
      }
    }
  }
}

// One bin, every frame, four threads a bin (thread h the m = h mod 4): the
// forward's O (K7; written to o_out), the MSE term, and the gradient
// products accumulated over frames into ar/ai at this thread's rows (wv
// applied later).  The DC bin's threads write db, dp (scaled) to dbdp.  D
// is a template argument: with a run-time D every channel's loads sat
// behind their own branch, one shared-memory latency each.
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
                             float* __restrict__ dbdp, const Frame& first) {
  constexpr bool FWD = MODE == kFwdGrad;
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
      float orr[kMaxD], oii[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) orr[d] = oii[d] = 0.f;
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
              hr += cr * xr[d] - ci * xi[d];
              hi += cr * xi[d] + ci * xr[d];
            }
          }
          const float bias = dc ? bias_b[m] * a.norm : 0.f;
          hr = (hr * a.inv_m + bias) * a.inv_d;
          hi = hi * a.inv_m * a.inv_d;
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
          if (valid && o_out && h == 0) {
            const size_t i = (size_t)(b * D + d) * a.W + w;
            o_out[i] = orr[d];
            o_out[plane + i] = oii[d];
          }
          er[d] += orr[d];
          ei[d] += oii[d];
          if (h == 0) mse += (er[d] * er[d] + ei[d] * ei[d]) * wv;
        }
      }
    }
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
    cur = next;
  }
  if (dc) {
    for (int m = h; m < M; m += kTPB) dbdp[m] = dbdp[m] * a.norm * a.scale;
    if (h == 0)
      for (int d = 0; d < D; ++d)
        dbdp[M + d] = dbdp[M + d] * a.norm * a.scale;
  }
  return mse;
}

// The projection's A operand from ar/ai: rows x (64 bins of d_re, then 64
// of -d_im), each times its bin's weight, as PIECES bf16 pieces in
// tile_off order ([piece][re|im][4096]); rows past a.rows are zeros.  One
// 16-byte core-matrix row (8 bins of one row) an item, the 8 rows of a core
// matrix on 8 neighbouring threads.
template <int PIECES>
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
        const float t = __fmul_rn(x[k], swv[8 * bg + k]);
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
  float acc[kOuts];
#pragma unroll
  for (int j = 0; j < kOuts; ++j) {
    const int o = threadIdx.x + kTC * j;
    acc[j] = o < n_total ? __ldcg(src + o) : 0.f;
  }
  for (int k0 = 1; k0 < nrec; k0 += kBatch) {
    float v[kBatch][kOuts];
#pragma unroll
    for (int kk = 0; kk < kBatch; ++kk)
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        const int o = threadIdx.x + kTC * j;
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
    const int o = threadIdx.x + kTC * j;
    if (o < n_total) dst[o] = o < n_scaled ? acc[j] * scale : acc[j];
  }
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
// the result repeats bit for bit, whatever order the blocks ran in.
__device__ void tc_combine(const float* part, float* gpart,
                           unsigned* tickets, float* __restrict__ out,
                           int n_total, int n_scaled, float scale, int ntiles,
                           int* flag) {
  const int g = blockIdx.x / kTG, ng = (ntiles + kTG - 1) / kTG;
  const int t0 = g * kTG, t1 = min(ntiles, t0 + kTG);
  if (!ticket(tickets + g, t1 - t0, flag)) return;
  sum_records(part + (size_t)t0 * n_total, t1 - t0, n_total,
              gpart + (size_t)g * n_total, 0, 1.f);
  if (!ticket(tickets + ng, ng, flag)) return;
  sum_records(gpart, ng, n_total, out, n_scaled, scale);
  for (int i = threadIdx.x; i <= ng; i += kTC) tickets[i] = 0u;
}

// K5 (kGradGivenO) and K7 (kFwdGrad): per tile, the spectra rebuild on the
// tensor cores, the per-bin pass, the projection on the tensor cores, the
// tile's partial g and MSE term; then the fixed-order sum into out.  Two
// warpgroups: each product's cos and sin halves go to one each.
template <int MODE, bool BF16, int D>
__global__ void __launch_bounds__(kTC, 2)
tc_sweep_kernel(const float* __restrict__ planes,
                const __nv_bfloat16* __restrict__ tiles,
                const float* __restrict__ wv, const float* __restrict__ cf,
                const float* __restrict__ bias_b,
                const float* __restrict__ bias_p, float* __restrict__ o_out,
                float* part, float* gpart, unsigned* tickets,
                float* __restrict__ out, float* __restrict__ dbdp, Dims a) {
  constexpr int RT = TcTiers<BF16>::kRebuild, PT = TcTiers<BF16>::kProject;
  constexpr int RP = wg::pieces(RT), PP = wg::pieces(PT);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* cfs = reinterpret_cast<__nv_bfloat16*>(smem);  // X
  __nv_bfloat16* rs = cfs + RP * kMaxRows * kMaxP;
  float* ar = reinterpret_cast<float*>(smem);                    // X, later
  float* ai = ar + kMaxRows * kTBS;
  float* sr = reinterpret_cast<float*>(smem + kRegion);          // Y
  float* si = sr + kMaxRows * kTBS;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + kRegion);
  __nv_bfloat16* ps =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * kRegion);      // Z
  float* red = reinterpret_cast<float*>(ps + PP * 2 * kCopy);
  float* swv = red + kTC;
  int* flag = reinterpret_cast<int*>(swv + kTB);
  const int t = threadIdx.x, tile = blockIdx.x;
  Frame first;
  load_frame<MODE, D>(first, planes, a, 0, tile * kTB + t / kTPB);

  // the tile's basis copies, by cp.async: the rebuild's, then the
  // projection's (waited for only before the projection)
  const __nv_bfloat16* src = tiles + (size_t)tile * tc_tile_elems(RT, PT);
  for (int c = t; c < RP * 2 * kCopy / 8; c += kTC)
    wg::cp_async16(rs + 8 * c, src + 8 * c);
  wg::cp_async_commit();
  src += RP * 2 * kCopy;
  for (int c = t; c < PP * 2 * kCopy / 8; c += kTC)
    wg::cp_async16(ps + 8 * c, src + 8 * c);
  wg::cp_async_commit();
  // the compact kernels' pieces: A of the rebuild, rows x P (K = 32)
  for (int e = t; e < kMaxRows * (kMaxP / 8); e += kTC) {
    const int j = e >> 2, k0 = 8 * (e & 3);
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (j < a.rows && k0 + k < a.P) ? cf[j * a.P + k0 + k] : 0.f;
    __nv_bfloat16* dst[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i)
      dst[i] = cfs + i * kMaxRows * kMaxP + off32(j, k0);
    wg::store_row8<RP>(v, dst);
  }
  wg::cp_async_wait<1>();
  wg::fence_stores();
  __syncthreads();

  // the spectra: [rows x 32] . [32 x 64 bins], warpgroup 0 against cos
  // (the real parts), warpgroup 1 against sin (minus the imaginary parts)
  const int wgi = t / 128;
  {
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
            wg::desc(cfs + wg::prod_a(RT, p) * kMaxRows * kMaxP + ks * 128,
                     512),
            wg::desc(rs + wg::prod_b(RT, p) * 2 * kCopy + wgi * kCopy +
                         ks * 128,
                     512),
            (ks == 0 && p == 0) ? 0 : 1);
    wg::commit();
    wg::wait_all();
    wg::pin(acc);
    float* dst = wgi ? si : sr;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = wg::acc_row(t, i), col = wg::acc_col(t, i);
      if (r < a.rows) dst[r * kTBS + col] = wgi ? -acc[i] : acc[i];
    }
  }
  __syncthreads();

  const float v = tc_bin_pass<MODE, D>(sr, si, ar, ai, swv, a, planes, wv,
                                    bias_b, bias_p, o_out, tile, dbdp,
                                    first);
  red[t] = v;
  __syncthreads();
  tc_stage_a<PP>(ar, ai, swv, as, a.rows);
  for (int k = kTC / 2; k > 0; k >>= 1) {
    if (t < k) red[t] += red[t + k];
    __syncthreads();
  }
  wg::cp_async_wait<0>();
  wg::fence_stores();
  __syncthreads();

  // the projection, fresh for this tile: warpgroup 0 d_re [rows x 64] .
  // cos [64 x 32 p], warpgroup 1 -d_im against sin; then the two added in
  // that order (warpgroup 1's through region X, free after staging)
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
          wg::desc(as + wg::prod_a(PT, p) * 2 * kMaxRows * kTB +
                   wgi * kMaxRows * kTB + ks * 128),
          wg::desc(ps + wg::prod_b(PT, p) * 2 * kCopy + wgi * kCopy +
                   ks * 128),
          (ks == 0 && p == 0) ? 0 : 1);
  wg::commit();
  wg::wait_all();
  wg::pin(g);
  float* xch = ar;   // [16][128]: warpgroup 1's sums, thread-private columns
  if (wgi) {
#pragma unroll
    for (int i = 0; i < 16; ++i) xch[i * 128 + t - 128] = g[i];
  }
  __syncthreads();
  const int n = a.rows * a.P;
  float* rec = part + (size_t)tile * (n + 1);
  if (!wgi) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = wg::acc_row(t, i), col = wg::acc_col(t, i);
      if (r < a.rows && col < a.P)
        rec[r * a.P + col] = g[i] + xch[i * 128 + t];
    }
  }
  if (t == 0) rec[n] = red[0] / (float)a.nb;
  tc_combine(part, gpart, tickets, out, n + 1, n, a.scale, a.ntiles, flag);
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

template <int MODE>
int launch_tc(const void* planes, const void* tiles, const void* wv,
              const void* cf, const void* bias_b, const void* bias_p,
              void* o_out, void* out, void* dbdp, void* scratch,
              void* tickets, Dims a, int bf16, cudaStream_t st) {
  const TcKernel k = tc_kernel<MODE>(bf16, a.D);
  const int bytes = tc_smem_bytes(bf16 ? TcTiers<true>::kProject
                                       : TcTiers<false>::kProject);
  int err = set_smem(k, bytes);
  if (err) return err;
  a.ntiles = (a.W + kTB - 1) / kTB;
  float* part = static_cast<float*>(scratch);
  float* gpart = part + (size_t)a.ntiles * (a.rows * a.P + 1);
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

// K8: the whole burst.  state_in/state_out: cf [rows*P], b [M], p [D],
// mcf [rows*P], mb [M], mp [D]; mse_out [iters+1] (raw, / nb); scratch:
// part [ntiles][rows*P + 1], gsum [rows*P + M + D], dbdp [M + D].
template <bool BF16>
__global__ void __launch_bounds__(kT)
itergrid_kernel(const float* __restrict__ planes,
                const float* __restrict__ basis, const float* __restrict__ wv,
                const float* __restrict__ state_in,
                float* __restrict__ state_out,
                float* __restrict__ mse_out, float* __restrict__ part,
                float* __restrict__ gsum, float* __restrict__ dbdp, Dims a,
                int iters, float lr_eff, float alpha) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), a);
  cg::grid_group grid = cg::this_grid();
  const int n = a.rows * a.P, M = a.M, D = a.D;
  // shared state: cf (s.cf) | mcf | b | mb | p | mp
  float* mcf = s.st;
  float* bs = mcf + n;
  float* mbs = bs + M;
  float* ps = mbs + M;
  float* mps = ps + D;
  for (int i = threadIdx.x; i < n; i += kT) {
    s.cf[i] = state_in[i];
    mcf[i] = state_in[n + M + D + i];
  }
  for (int i = threadIdx.x; i < M; i += kT) {
    bs[i] = state_in[n + i];
    mbs[i] = state_in[2 * n + M + D + i];
  }
  for (int i = threadIdx.x; i < D; i += kT) {
    ps[i] = state_in[n + M + i];
    mps[i] = state_in[2 * n + 2 * M + D + i];
  }
  __syncthreads();
  const int gtid = blockIdx.x * kT + threadIdx.x;
  const int gthreads = gridDim.x * kT;
  for (int it = 0; it <= iters; ++it) {
    if (it >= 1) {  // inertia (backprop_d) from the summed gradients
      for (int i = threadIdx.x; i < n + M + D; i += kT) {
        float* wp;
        float* mp;
        if (i < n) {
          wp = s.cf + i;
          mp = mcf + i;
        } else if (i < n + M) {
          wp = bs + (i - n);
          mp = mbs + (i - n);
        } else {
          wp = ps + (i - n - M);
          mp = mps + (i - n - M);
        }
        const float g = gsum[i];
        const float dw =
            (1.f - alpha) * lr_eff * g / fmaxf(fabsf(g), kGradClip) +
            alpha * *mp;
        *wp = *wp - dw;
        *mp = dw;
      }
      __syncthreads();
    }
    // stage A: this block's tiles
    for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
      load_basis(s, a, basis, tile);
      __syncthreads();
      spectra<BF16>(s, a);
      __syncthreads();
      const float v =
          it == 0 ? bin_pass<kItGivenO>(s, a, planes, wv, bs, ps, nullptr,
                                        tile, dbdp)
                  : bin_pass<kItFwd>(s, a, planes, wv, bs, ps, nullptr, tile,
                                     dbdp);
      const float mse = block_mse(s, a, v);
      if (it < iters) project<BF16>(s, a, part + (size_t)tile * (n + 1));
      if (threadIdx.x == 0) part[(size_t)tile * (n + 1) + n] = mse;
      __syncthreads();
    }
    grid.sync();
    // stage B: the sums over tiles, in tile order
    for (int o = gtid; o <= n; o += gthreads) {
      const float f = o < n ? a.scale : 1.f;
      float acc = 0.f;
      for (int t = 0; t < a.ntiles; ++t)
        acc += part[(size_t)t * (n + 1) + o] * f;
      if (o < n) gsum[o] = acc;
      else mse_out[it] = acc;
    }
    for (int o = gtid; o < M + D; o += gthreads) gsum[n + o] = dbdp[o];
    grid.sync();
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < n; i += kT) {
      state_out[i] = s.cf[i];
      state_out[n + M + D + i] = mcf[i];
    }
    for (int i = threadIdx.x; i < M; i += kT) {
      state_out[n + i] = bs[i];
      state_out[2 * n + M + D + i] = mbs[i];
    }
    for (int i = threadIdx.x; i < D; i += kT) {
      state_out[n + M + i] = ps[i];
      state_out[2 * n + 2 * M + D + i] = mps[i];
    }
  }
}

// K6: the sweep, then the MSE terms summed in tile order into out[0]
int launch_sweep(const void* planes, const void* basis, const void* wv,
                 const void* cf, const void* bias_b, const void* bias_p,
                 void* o_out, void* out, void* dbdp, void* scratch,
                 const Dims& a, int bf16, cudaStream_t st) {
  auto k = bf16 ? sweep_kernel<true> : sweep_kernel<false>;
  const size_t bytes = smem_floats(a, false) * sizeof(float);
  int err = set_smem(k, bytes);
  if (err) return err;
  float* part = static_cast<float*>(scratch);
  k<<<a.ntiles, kT, bytes, st>>>(
      static_cast<const float*>(planes), static_cast<const float*>(basis),
      static_cast<const float*>(wv), static_cast<const float*>(cf),
      static_cast<const float*>(bias_b), static_cast<const float*>(bias_p),
      static_cast<float*>(o_out), part, static_cast<float*>(dbdp), a);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_kernel<<<1, kT, 0, st>>>(part, a.ntiles, 1, 0, 1.f,
                                  static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the launches below need (0 if the shape cannot run):
// kind 0 = K5/K7 (a record per 64-bin tile and per group of 16), 1 = K6,
// 2 = K8.
extern "C" long long omega_scratch_floats(int kind, int nb, int M, int D,
                                          int P, int W) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, 1.f, 1.f, 1.f, 1.f, &a)) return 0;
  const long long n = (long long)a.rows * a.P;
  if (kind == 1) return a.ntiles;
  if (kind == 0) {
    const long long nt = (W + kTB - 1) / kTB;
    return (nt + (nt + kTG - 1) / kTG) * (n + 1);
  }
  return a.ntiles * (n + 1) + n + 2 * (M + D);
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

// K5's (fused 0) and K7's (fused 1) tensor-core sweep with float32 or
// bf16 operands, for D channels (1..4): registers, local bytes, static and
// dynamic shared memory (wg::attrs) into out[0..3].
extern "C" int omega_tc_attrs(int fused, int bf16, int D, int* out) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const TcKernel k = fused ? tc_kernel<kFwdGrad>(bf16, D)
                           : tc_kernel<kGradGivenO>(bf16, D);
  return wg::attrs(k, tc_smem_bytes(bf16 ? TcTiers<true>::kProject
                                         : TcTiers<false>::kProject),
                   out);
}

// K6.  planes: [4][nb*D][W] (X, Y); o_out: [2][nb*D][W]; mse_out [1]:
// sum over bins of w |O - Y|^2 / nb.
extern "C" int omega_respectra_launch(
    const void* planes, const void* basis, const void* wv, const void* cf,
    const void* b, const void* p, void* o_out, void* mse_out, void* scratch,
    int nb, int M, int D, int P, int W, float norm, float inv_m, float inv_d,
    int bf16, void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, inv_m, inv_d, 1.f, &a))
    return (int)cudaErrorInvalidValue;
  return launch_sweep(planes, basis, wv, cf, b, p, o_out, mse_out, nullptr,
                      scratch, a, bf16, static_cast<cudaStream_t>(stream));
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

// K8.  planes as K5 (O = O0); state_in/state_out: cf [2MD*P], b [M], p [D],
// then their momenta in the same layout; mse_out [iters + 1].  One
// cooperative launch; returns cudaErrorNotSupported where the device has no
// cooperative launch.
extern "C" int omega_itergrid_launch(
    const void* planes, const void* basis, const void* wv,
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
  auto k = bf16 ? itergrid_kernel<true> : itergrid_kernel<false>;
  const size_t bytes = smem_floats(a, true) * sizeof(float);
  err = set_smem(k, bytes);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kT,
                                                           bytes);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int blocks = per_sm * sms;
  if (blocks > a.ntiles) blocks = a.ntiles;
  const long long n = (long long)a.rows * a.P;
  float* part = static_cast<float*>(scratch);
  float* gsum = part + a.ntiles * (n + 1);
  float* dbdp = gsum + n + M + D;
  const float* pl = static_cast<const float*>(planes);
  const float* bs = static_cast<const float*>(basis);
  const float* w = static_cast<const float*>(wv);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  float* mo = static_cast<float*>(mse_out);
  void* args[] = {&pl, &bs, &w, &si, &so, &mo, &part, &gsum, &dbdp, &a,
                  &iters, &lr_eff, &alpha};
  err = (int)cudaLaunchCooperativeKernel((const void*)k, dim3(blocks),
                                         dim3(kT), args, bytes,
                                         static_cast<cudaStream_t>(stream));
  if (err) return err;
  return (int)cudaGetLastError();
}
