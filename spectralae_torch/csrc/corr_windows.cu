// K3 · corr_pair_windows and K4 · anchor_windows — centred lag windows of
// per-bin correlation products, for the correlation-space burst's
// precompute.
//
// Replaces: spectralae/ops/pallas_windows.py · corr_pair_windows (K3, body
//   _make_kernel) and · anchor_windows (K4, body _make_anchor_kernel),
//   reached from train/fft_corr.py corr_precompute_fused.
//
// Both compute, for pair products P[q](w) of half-spectrum bins w = (wx, wy)
// and a centred lag window (u, v) in [-h, h]^2,
//   W[q, u, v] = (1/B) sum_b sum_wx sum_wy
//                Re( P_b[q](wx, wy) * w(wy) e^{i 2pi (u wx/nx + v wy/ny)} )
// with w the Hermitian column weights (ops/dft.lag_basis).  The transform is
// separable: a y-stage contracts wy against byc/bys [nyr, vy] (the weighted
// cos/sin), giving per x-row sums sr, si [q, vy]; an x-stage contracts wx
// against bxc/bxs [nx, vx]:  W[q, u, v] = sum_x bxc[x,u] sr[x,v] - bxs[x,u] si[x,v].
//
//  K3: P[d*E + e] = conj(X_d) Z_e, one window extent; when Z is X, only
//      the upper pairs d <= e (the reduction mirrors the lower ones, as K4's).
//  K4: the whole fused-anchor pass in one read of X:
//      - the anchor spectra K0[e, d](wx, wy) of the composed taps, from the
//        separable partials T[ed, k, wy] = taps[ed, k, :] . e^{-i theta_y}
//        (built by a first small launch, read from L2) and cx/sx [nk2, nx];
//      - EG_e = s1 * sum_d K0[e, d] X_d - X_e, bin by bin, never stored;
//      - XX products conj(X_d) X_e for d <= e at +-4h (the reduction writes
//        the lower pairs mirrored, W[e, d](l) = W[d, e](-l)), EG products
//        conj(X_d) EG_e at +-2h, sum w |EG|^2, and EG at the DC bin.
//      The signal may be read as bf16 re/im planes; all arithmetic is f32.
//
// What bounds it on Hopper: float32 operations.  K4 at D = 3, 5x5 kernels
// does about 1.7 kFLOP per bin and batch (1.5 k of them the y-stage
// against 183 lag columns) for 24 bytes of X read, far above the card's
// flop/byte balance.  No tensor cores: the sums must stay IEEE float32
// (the anchored decomposition cancels at initial-error scale).
//
// What the design does about it:
//  - one block per (x-row, batch group, wy chunk); the batch group loops
//    over its batches, so a row's anchor spectra are built once (phase 0)
//    and reused for every batch, and enough blocks exist even at 128^2;
//  - phase 1: one thread per bin forms the row's pair products into shared
//    memory (EG lives only in registers); phase 2: one thread per output
//    column (q, v) runs its y-stage dot product over the row from shared
//    memory, accumulating over the group's batches — each sum is owned by
//    one thread, so no reduction and no register pressure from the ~370
//    accumulators a bin-per-thread layout would need;
//  - the y-stage sums of every row go to a scratch buffer, and a second
//    launch (one warp per window entry) applies the x-stage and sums rows,
//    batch groups and chunks in a fixed order: no atomics, so the windows
//    repeat bit for bit;
//  - where a row's products do not fit in shared memory (227 KB), the rows
//    split into wy chunks: partial sums over disjoint bins, summed by that
//    launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 232448;  // bytes a block may opt in to
constexpr int kRowsTarget = 264;       // two blocks for each of 132 SMs

// one window extent: its pair products and its lag bases
struct Group {
  int npairs, vx, vy;
  int upper_of;       // D when the pairs are the upper d <= e of D x D (the
                      // reduction writes the lower ones mirrored), else 0
  const float* byc;   // [nyr][vy]  w(wy) cos(2pi wy v / ny)
  const float* bys;   // [nyr][vy]  w(wy) sin(...)
  const float* bxcT;  // [vx][nx]   cos(2pi wx u / nx)
  const float* bxsT;  // [vx][nx]   sin(...)
};

struct Plan {
  int yc, nchunks, nbg, R, n_out;
  size_t smem;
  // scratch, in floats: y-stage sums [n_out][2][R], seg [R], e0 [nbg][D]
  // (rounded up to even), T [D*D][nk2][nyr] float2
  size_t off_seg, off_e0, off_T, total;
};

bool make_plan(int anchor, int B, int D, int npa, int vya, int npb, int vyb,
               int nx, int nyr, int nk2, Plan* pl) {
  pl->n_out = npa * vya + npb * vyb;
  const size_t per_bin = (size_t)(npa + npb + (anchor ? D * D : 0)) * 8;
  const size_t fixed = (size_t)pl->n_out * 8 + kThreads * 4 + (size_t)D * 4;
  if (fixed + per_bin > kSmemLimit) return false;
  const int fit = (int)((kSmemLimit - fixed) / per_bin);
  pl->nchunks = (nyr + fit - 1) / fit;
  pl->yc = (nyr + pl->nchunks - 1) / pl->nchunks;
  const int rows = nx * pl->nchunks;
  int nbg = (kRowsTarget + rows - 1) / rows;
  pl->nbg = nbg < 1 ? 1 : (nbg > B ? B : nbg);
  pl->R = pl->nchunks * pl->nbg * nx;
  pl->smem = per_bin * pl->yc + fixed;
  pl->off_seg = (size_t)pl->n_out * 2 * pl->R;
  pl->off_e0 = pl->off_seg + pl->R;
  pl->off_T = pl->off_e0 + (((size_t)pl->nbg * D + 1) & ~(size_t)1);
  pl->total = pl->off_T + (anchor ? (size_t)D * D * nk2 * nyr * 2 : 0);
  return true;
}

template <bool BF16>
__device__ __forceinline__ float2 load_bin(const float2* __restrict__ X,
                                           const __nv_bfloat16* __restrict__ re,
                                           const __nv_bfloat16* __restrict__ im,
                                           size_t i) {
  if (BF16) return make_float2(__bfloat162float(re[i]), __bfloat162float(im[i]));
  return X[i];
}

// conj(a) * z
__device__ __forceinline__ float2 conj_mul(float2 a, float2 z) {
  return make_float2(a.x * z.x + a.y * z.y, a.x * z.y - a.y * z.x);
}

// T[ed, k, wy] = (sum_l taps[ed,k,l] cy[l,wy], -sum_l taps[ed,k,l] sy[l,wy])
__global__ void __launch_bounds__(kThreads)
anchor_taps_kernel(const float* __restrict__ taps, const float* __restrict__ cy,
                   const float* __restrict__ sy, float2* __restrict__ T,
                   int nl2, int nyr) {
  const int y = blockIdx.x * kThreads + threadIdx.x;
  if (y >= nyr) return;
  const int edk = blockIdx.y;
  const float* tp = taps + (size_t)edk * nl2;
  float tr = 0.f, ti = 0.f;
  for (int l = 0; l < nl2; ++l) {
    tr += tp[l] * cy[(size_t)l * nyr + y];
    ti -= tp[l] * sy[(size_t)l * nyr + y];
  }
  T[(size_t)edk * nyr + y] = make_float2(tr, ti);
}

// One block: x-row blockIdx.x, batches blockIdx.y + k*gridDim.y, wy chunk
// blockIdx.z.  Writes the row's y-stage sums, its sum w|EG|^2 and (x = 0,
// chunk 0) its EG at the DC bin.
template <bool ANCHOR, bool BF16>
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const float2* __restrict__ X, const float2* __restrict__ Z,
                   const __nv_bfloat16* __restrict__ Xre,
                   const __nv_bfloat16* __restrict__ Xim,
                   int B, int D, int E, int nx, int nyr, int yc,
                   Group ga, Group gb,
                   const float2* __restrict__ T, int nk2,
                   const float* __restrict__ cx, const float* __restrict__ sx,
                   const float* __restrict__ w, float s1,
                   float* __restrict__ s_part, float* __restrict__ seg_part,
                   float* __restrict__ e0_part, int R) {
  extern __shared__ float4 smem4[];
  const int npairs = ga.npairs + gb.npairs;
  const int na_out = ga.npairs * ga.vy;
  const int n_out = na_out + gb.npairs * gb.vy;
  float2* P = reinterpret_cast<float2*>(smem4);          // [npairs][yc]
  float2* Kh = P + (size_t)npairs * yc;                   // [D*D][yc]
  float* acc = reinterpret_cast<float*>(Kh + (ANCHOR ? (size_t)D * D * yc : 0));
  float* red = acc + 2 * n_out;                           // [kThreads]
  float* e0s = red + kThreads;                            // [D]

  const int x = blockIdx.x, bg = blockIdx.y, chunk = blockIdx.z;
  const int nbg = gridDim.y;
  const int y0 = chunk * yc;
  const int ylen = min(yc, nyr - y0);
  const int tid = threadIdx.x;
  const size_t plane = (size_t)nx * nyr;
  const size_t row = (size_t)x * nyr + y0;
  const bool dc_row = ANCHOR && x == 0 && chunk == 0;

  for (int o = tid; o < 2 * n_out; o += kThreads) acc[o] = 0.f;
  if (dc_row && tid < D) e0s[tid] = 0.f;
  if (ANCHOR) {
    // phase 0: this row's anchor spectra, once for all batches
    for (int i = tid; i < D * D * ylen; i += kThreads) {
      const int ed = i / ylen, yl = i - ed * ylen;
      const float2* t = T + (size_t)ed * nk2 * nyr + y0 + yl;
      float kr = 0.f, ki = 0.f;
#pragma unroll 9
      for (int k = 0; k < nk2; ++k) {
        const float2 tk = t[(size_t)k * nyr];
        const float c = cx[(size_t)k * nx + x], s = sx[(size_t)k * nx + x];
        kr += c * tk.x + s * tk.y;
        ki += c * tk.y - s * tk.x;
      }
      Kh[(size_t)ed * yc + yl] = make_float2(kr, ki);
    }
  }
  float seg = 0.f;
  __syncthreads();

  for (int b = bg; b < B; b += nbg) {
    // phase 1: the row's pair products
    const size_t xb = (size_t)b * D * plane + row;
    for (int yl = tid; yl < ylen; yl += kThreads) {
      if (!ANCHOR) {
        const size_t zb = (size_t)b * E * plane + row + yl;
        int q = 0;
        for (int d = 0; d < D; ++d) {
          const float2 a = X[xb + d * plane + yl];
          for (int e = ga.upper_of ? d : 0; e < E; ++e, ++q)
            P[(size_t)q * yc + yl] = conj_mul(a, Z[zb + e * plane]);
        }
        continue;
      }
      const float wy = w[y0 + yl];
      for (int e = 0; e < D; ++e) {
        float ar = 0.f, ai = 0.f;
        for (int d = 0; d < D; ++d) {
          const float2 k = Kh[(size_t)(e * D + d) * yc + yl];
          const float2 xd = load_bin<BF16>(X, Xre, Xim, xb + d * plane + yl);
          ar += k.x * xd.x - k.y * xd.y;
          ai += k.x * xd.y + k.y * xd.x;
        }
        const float2 xe = load_bin<BF16>(X, Xre, Xim, xb + e * plane + yl);
        const float2 eg = make_float2(s1 * ar - xe.x, s1 * ai - xe.y);
        seg += wy * (eg.x * eg.x + eg.y * eg.y);
        if (dc_row && yl == 0) e0s[e] += eg.x;  // thread 0 only
        for (int d = 0; d < D; ++d) {
          const float2 a = load_bin<BF16>(X, Xre, Xim, xb + d * plane + yl);
          P[(size_t)(ga.npairs + d * D + e) * yc + yl] = conj_mul(a, eg);
        }
      }
      int q = 0;
      for (int d = 0; d < D; ++d) {
        const float2 a = load_bin<BF16>(X, Xre, Xim, xb + d * plane + yl);
        for (int e = d; e < D; ++e, ++q)
          P[(size_t)q * yc + yl] =
              conj_mul(a, load_bin<BF16>(X, Xre, Xim, xb + e * plane + yl));
      }
    }
    __syncthreads();
    // phase 2: y-stage dot products, one output column (q, v) per thread
    for (int o = tid; o < n_out; o += kThreads) {
      const bool in_a = o < na_out;
      const Group& g = in_a ? ga : gb;
      const int oo = in_a ? o : o - na_out;
      const int q = oo / g.vy + (in_a ? 0 : ga.npairs);
      const int v = oo - (oo / g.vy) * g.vy;
      const float2* pq = P + (size_t)q * yc;
      const float* bc = g.byc + (size_t)y0 * g.vy + v;
      const float* bs = g.bys + (size_t)y0 * g.vy + v;
      float sr = acc[2 * o], si = acc[2 * o + 1];
#pragma unroll 4
      for (int yl = 0; yl < ylen; ++yl) {
        const float2 p = pq[yl];
        const float c = bc[(size_t)yl * g.vy], s = bs[(size_t)yl * g.vy];
        sr += p.x * c - p.y * s;
        si += p.x * s + p.y * c;
      }
      acc[2 * o] = sr;
      acc[2 * o + 1] = si;
    }
    __syncthreads();
  }

  const int r = (chunk * nbg + bg) * nx + x;
  for (int o = tid; o < 2 * n_out; o += kThreads)
    s_part[(size_t)o * R + r] = acc[o];
  if (ANCHOR) {
    red[tid] = seg;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) seg_part[r] = red[0];
    if (dc_row && tid < D) e0_part[bg * D + tid] = e0s[tid];
  }
}

// The x-stage and the sum over rows, batch groups and chunks, in a fixed
// order: one warp per window entry (group, pair, u, v), its lanes striding
// over the rows, then a shuffle tree; the warp after the last entry of K4
// sums seg and e0.  Outputs are / B.
template <bool ANCHOR>
__global__ void __launch_bounds__(kThreads)
window_reduce_kernel(const float* __restrict__ s_part,
                     const float* __restrict__ seg_part,
                     const float* __restrict__ e0_part, int R, int nx,
                     int nbg, int B, int D, Group ga, Group gb,
                     float* __restrict__ out_a, float* __restrict__ out_b,
                     float* __restrict__ seg_out, float* __restrict__ e0_out) {
  const int lane = threadIdx.x & 31;
  const int entry = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int na = ga.npairs * ga.vx * ga.vy;
  const int nb = gb.npairs * gb.vx * gb.vy;
  const float inv_b = 1.f / (float)B;
  if (entry > na + nb || (entry == na + nb && !ANCHOR)) return;
  float t = 0.f;
  if (entry == na + nb) {  // K4's scalars
    for (int r = lane; r < R; r += 32) t += seg_part[r];
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) {
      seg_out[0] = t * inv_b;
      for (int e = 0; e < D; ++e) {
        float s = 0.f;
        for (int g = 0; g < nbg; ++g) s += e0_part[g * D + e];
        e0_out[e] = s * inv_b;
      }
    }
    return;
  }
  const bool in_a = entry < na;
  const Group& g = in_a ? ga : gb;
  const int idx = in_a ? entry : entry - na;
  const int q = idx / (g.vx * g.vy);
  const int uv = idx - q * g.vx * g.vy;
  const int u = uv / g.vy, v = uv - u * g.vy;
  const int o = (in_a ? 0 : ga.npairs * ga.vy) + q * g.vy + v;
  const float* sr = s_part + (size_t)(2 * o) * R;
  const float* si = sr + R;
  const float* bc = g.bxcT + (size_t)u * nx;
  const float* bs = g.bxsT + (size_t)u * nx;
  for (int r = lane; r < R; r += 32) {
    const int xr = r % nx;
    t += bc[xr] * sr[r] - bs[xr] * si[r];
  }
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_down_sync(0xffffffffu, t, off);
  if (lane != 0) return;
  const float val = t * inv_b;
  float* out = in_a ? out_a : out_b;
  if (g.upper_of) {
    // the upper pairs, d <= e, in row order; the lower pair is the
    // lag-reversed window
    const int nd = g.upper_of;
    int d = 0, k = q;
    while (k >= nd - d) {
      k -= nd - d;
      ++d;
    }
    const int e = d + k;
    out[(((size_t)d * nd + e) * g.vx + u) * g.vy + v] = val;
    if (e != d)
      out[(((size_t)e * nd + d) * g.vx + (g.vx - 1 - u)) * g.vy +
          (g.vy - 1 - v)] = val;
  } else {
    out[((size_t)q * g.vx + u) * g.vy + v] = val;
  }
}

int reduce_blocks(const Group& ga, const Group& gb, bool anchor) {
  const int warps = ga.npairs * ga.vx * ga.vy + gb.npairs * gb.vx * gb.vy +
                    (anchor ? 1 : 0);
  return (warps + kThreads / 32 - 1) / (kThreads / 32);
}

Group group_at(const float* base, int npairs, int vx, int vy, int nx,
               int nyr, int upper_of) {
  Group g;
  g.npairs = npairs;
  g.vx = vx;
  g.vy = vy;
  g.upper_of = upper_of;
  g.byc = base;
  g.bys = g.byc + (size_t)nyr * vy;
  g.bxcT = g.bys + (size_t)nyr * vy;
  g.bxsT = g.bxcT + (size_t)vx * nx;
  return g;
}

size_t group_floats(int vx, int vy, int nx, int nyr) {
  return 2 * ((size_t)nyr * vy + (size_t)vx * nx);
}

Group empty_group() {
  Group g{};
  g.vx = g.vy = 1;
  return g;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// K3's pairs: the upper D(D+1)/2 when Z is X, else D*E
int k3_pairs(int D, int E, int same) { return same ? D * (D + 1) / 2 : D * E; }

// Floats of scratch the launch below needs (0 if the shape cannot run).
// anchor = 0: K3 at one extent (vy), same = 1 when Z is X (then E = D);
// anchor = 1: K4.
extern "C" long long corr_windows_scratch_floats(int anchor, int B, int D,
                                                 int E, int nx, int nyr,
                                                 int nk2, int nl2, int vy,
                                                 int same) {
  Plan pl;
  const bool ok = anchor
      ? make_plan(1, B, D, D * (D + 1) / 2, 2 * nl2 - 1, D * D, nl2, nx, nyr,
                  nk2, &pl)
      : make_plan(0, B, D, k3_pairs(D, E, same), vy, 0, 1, nx, nyr, 0, &pl);
  return ok ? (long long)pl.total : 0;
}

// K3.  X: [B, D, nx, nyr], Z: [B, E, nx, nyr] complex64; same = 1: Z is X
// (E = D), and only the upper pairs are formed; consts: byc, bys [nyr][vy],
// bxcT, bxsT [vx][nx]; out: [D, E, vx, vy].
extern "C" int corr_pair_windows_launch(const void* X, const void* Z,
                                        const void* consts, void* out,
                                        void* scratch, int B, int D, int E,
                                        int nx, int nyr, int hx, int hy,
                                        int same, void* stream) {
  const int vx = 2 * hx + 1, vy = 2 * hy + 1;
  if (same && E != D) return (int)cudaErrorInvalidValue;
  const int npairs = k3_pairs(D, E, same);
  Plan pl;
  if (!make_plan(0, B, D, npairs, vy, 0, 1, nx, nyr, 0, &pl))
    return (int)cudaErrorInvalidValue;
  const Group ga = group_at(static_cast<const float*>(consts), npairs, vx, vy,
                            nx, nyr, same ? D : 0);
  const Group gb = empty_group();
  float* s = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  auto rows = window_rows_kernel<false, false>;
  int err = set_smem(rows, pl.smem);
  if (err) return err;
  rows<<<dim3(nx, pl.nbg, pl.nchunks), kThreads, pl.smem, st>>>(
      static_cast<const float2*>(X), static_cast<const float2*>(Z), nullptr,
      nullptr, B, D, E, nx, nyr, pl.yc, ga, gb, nullptr, 0, nullptr, nullptr,
      nullptr, 0.f, s, s + pl.off_seg, s + pl.off_e0, pl.R);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_reduce_kernel<false><<<reduce_blocks(ga, gb, false), kThreads, 0,
                                st>>>(
      s, nullptr, nullptr, pl.R, nx, pl.nbg, B, D, ga, gb,
      static_cast<float*>(out), nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// K4.  X: [B, D, nx, nyr] complex64, or (bf16 != 0) the re/im planes
// xre, xim [B, D, nx, nyr] bf16; taps: [D*D, nk2, nl2] (composed anchor taps,
// [e, d] order); consts: cx, sx [nk2][nx], cy, sy [nl2][nyr], w [nyr], then
// the +-4h group (byc, bys [nyr][vy4], bxcT, bxsT [vx4][nx]) and the +-2h
// group (vx2 = nk2, vy2 = nl2); out: XX [D, D, vx4, vy4], EGw [D, D, vx2,
// vy2], seg [1], e0 [D].
extern "C" int anchor_windows_launch(const void* X, const void* xre,
                                     const void* xim, const void* taps,
                                     const void* consts, void* out,
                                     void* scratch, int B, int D, int nx,
                                     int nyr, int nk2, int nl2, float s1,
                                     int bf16, void* stream) {
  const int vx2 = nk2, vy2 = nl2, vx4 = 2 * nk2 - 1, vy4 = 2 * nl2 - 1;
  const int nxx = D * (D + 1) / 2, neg = D * D;
  Plan pl;
  if (!make_plan(1, B, D, nxx, vy4, neg, vy2, nx, nyr, nk2, &pl))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(consts);
  const float* cx = c;
  const float* sx = cx + (size_t)nk2 * nx;
  const float* cy = sx + (size_t)nk2 * nx;
  const float* sy = cy + (size_t)nl2 * nyr;
  const float* w = sy + (size_t)nl2 * nyr;
  const float* g4 = w + nyr;
  const Group ga = group_at(g4, nxx, vx4, vy4, nx, nyr, D);
  const Group gb = group_at(g4 + group_floats(vx4, vy4, nx, nyr), neg, vx2,
                            vy2, nx, nyr, 0);
  float* s = static_cast<float*>(scratch);
  float2* T = reinterpret_cast<float2*>(s + pl.off_T);
  float* o = static_cast<float*>(out);
  float* xx = o;
  float* egw = xx + (size_t)D * D * vx4 * vy4;
  float* seg = egw + (size_t)D * D * vx2 * vy2;
  float* e0 = seg + 1;
  auto st = static_cast<cudaStream_t>(stream);

  anchor_taps_kernel<<<dim3((nyr + kThreads - 1) / kThreads, D * D * nk2),
                       kThreads, 0, st>>>(static_cast<const float*>(taps),
                                          cy, sy, T, nl2, nyr);
  int err = (int)cudaGetLastError();
  if (err) return err;
  auto rows = bf16 ? window_rows_kernel<true, true>
                   : window_rows_kernel<true, false>;
  err = set_smem(rows, pl.smem);
  if (err) return err;
  rows<<<dim3(nx, pl.nbg, pl.nchunks), kThreads, pl.smem, st>>>(
      static_cast<const float2*>(X), nullptr,
      static_cast<const __nv_bfloat16*>(xre),
      static_cast<const __nv_bfloat16*>(xim), B, D, D, nx, nyr, pl.yc, ga,
      gb, T, nk2, cx, sx, w, s1, s, s + pl.off_seg, s + pl.off_e0, pl.R);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_reduce_kernel<true><<<reduce_blocks(ga, gb, true), kThreads, 0,
                               st>>>(
      s, s + pl.off_seg, s + pl.off_e0, pl.R, nx, pl.nbg, B, D, ga, gb, xx,
      egw, seg, e0);
  return (int)cudaGetLastError();
}
