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
// What bounds it on Hopper: float32 operations.  At D = 3, M = 10, 5x5
// kernels the four basis products are 2 * 2 * 60 * 25 = 6,000 FMAs a bin
// per sweep against ~100 bytes of planes and basis, far above the card's
// flop/byte balance.  No tensor cores: the sums stay IEEE float32.
//
// What the design does about it:
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
//    and MSE to scratch, and a second grid (or, in K8, a stage after a
//    grid-wide barrier) sums them in tile order — no float atomics, so a
//    burst repeats bit for bit and its result does not depend on how many
//    blocks ran;
//  - the masked tail: bins past W read zeros and weigh nothing, as the
//    TPU kernel's zero-padded basis and wv do.
//
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
  constexpr bool GRAD = MODE != kFwd;
  constexpr bool FWD = MODE == kFwd || MODE == kFwdGrad || MODE == kItFwd;
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
  if (GRAD) {
    if (!ERW) {
      for (int j = 0; j < a.rows; ++j) {
        ar[j * kTS] *= wv;
        ai[j * kTS] *= wv;
      }
    }
    if (dc) {
      for (int k = 0; k < M + D; ++k) dbdp[k] = dbdp[k] * a.norm * a.scale;
    }
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

// K5 (GRAD_ONLY) and K7: per tile, partial g [rows*P] then the MSE term
template <int MODE, bool BF16>
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
  const float v = bin_pass<MODE>(s, a, planes, wv, bias_b, bias_p, o_out,
                                 tile, dbdp);
  const float mse = block_mse(s, a, v);
  const int n = MODE == kFwd ? 0 : a.rows * a.P;
  if (MODE != kFwd) project<BF16>(s, a, part + (size_t)tile * (n + 1));
  if (threadIdx.x == 0) part[(size_t)tile * (n + 1) + n] = mse;
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

template <int MODE>
int launch_sweep(const void* planes, const void* basis, const void* wv,
                 const void* cf, const void* bias_b, const void* bias_p,
                 void* o_out, void* out, void* dbdp, void* scratch,
                 const Dims& a, int bf16, cudaStream_t st) {
  auto k = bf16 ? sweep_kernel<MODE, true> : sweep_kernel<MODE, false>;
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
  const int n_total = MODE == kFwd ? 1 : a.rows * a.P + 1;
  reduce_kernel<<<(n_total + kT - 1) / kT, kT, 0, st>>>(
      part, a.ntiles, n_total, n_total - 1, a.scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the launches below need (0 if the shape cannot run):
// kind 0 = K5/K7, 1 = K6, 2 = K8.
extern "C" long long omega_scratch_floats(int kind, int nb, int M, int D,
                                          int P, int W) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, 1.f, 1.f, 1.f, 1.f, &a)) return 0;
  const long long n = (long long)a.rows * a.P;
  if (kind == 1) return a.ntiles;
  if (kind == 0) return a.ntiles * (n + 1);
  return a.ntiles * (n + 1) + n + 2 * (M + D);
}

// K5.  planes: [6][nb*D][W] f32 (X re, im, Y re, im, O re, im); basis:
// [2][P][W] (cos, sin); wv [W]; cf [2MD][P] (c rows m*D+d, then f rows
// d*M+m); b [M]; out: g [2MD*P] then one unused float; dbdp: db [M], dp [D].
extern "C" int omega_grad_project_launch(
    const void* planes, const void* basis, const void* wv, const void* cf,
    const void* b, void* out, void* dbdp, void* scratch, int nb, int M, int D,
    int P, int W, float norm, float scale, int bf16, void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, 1.f, 1.f, scale, &a))
    return (int)cudaErrorInvalidValue;
  return launch_sweep<kGradGivenO>(planes, basis, wv, cf, b, nullptr, nullptr,
                                   out, dbdp, scratch, a, bf16,
                                   static_cast<cudaStream_t>(stream));
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
  return launch_sweep<kFwd>(planes, basis, wv, cf, b, p, o_out, mse_out,
                            nullptr, scratch, a, bf16,
                            static_cast<cudaStream_t>(stream));
}

// K7.  As K6, and the next gradients: out = g [2MD*P] then the MSE sum;
// dbdp: db [M], dp [D].
extern "C" int omega_fused_step_launch(
    const void* planes, const void* basis, const void* wv, const void* cf,
    const void* b, const void* p, void* o_out, void* out, void* dbdp,
    void* scratch, int nb, int M, int D, int P, int W, float norm, float inv_m,
    float inv_d, float scale, int bf16, void* stream) {
  Dims a;
  if (!make_dims(nb, M, D, P, W, norm, inv_m, inv_d, scale, &a))
    return (int)cudaErrorInvalidValue;
  return launch_sweep<kFwdGrad>(planes, basis, wv, cf, b, p, o_out, out, dbdp,
                                scratch, a, bf16,
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
