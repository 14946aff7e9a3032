// K3 · corr_pair_windows and K4 · anchor_windows — centred lag windows of
// per-bin correlation products, for the correlation-space burst's
// precompute.
//
// Replaces: spectralae/ops/pallas_windows.py · corr_pair_windows (K3, body
//   _make_kernel) and · anchor_windows (K4, body _make_anchor_kernel),
//   reached from train/fft_corr.py corr_precompute_fused.
//
// Both compute, for pair products P[q](w) of half-spectrum bins w = (wx, wy)
// and a centred lag window (u, v) in [-hx, hx] x [-hy, hy],
//   W[q, u, v] = (1/B) sum_b sum_wx sum_wy
//                Re( P_b[q](wx, wy) * w(wy) e^{i 2pi (u wx/nx + v wy/ny)} )
// with w the Hermitian column weights (ops/dft.lag_basis).  The transform is
// separable, and the lags +-v and +-u share their cosines and flip their
// sines, so each output quadrant comes from four real sums over v, u >= 0:
//   y-stage, per x-row:  Sxc = sum_wy Re P c_v,  Sys = sum Im P s_v,
//                        Sxs = sum Re P s_v,     Syc = sum Im P c_v
//     (c_v, s_v = w cos, w sin of 2pi wy v / ny),
//   x-stage, over rows:  A1 = sum_wx cx_u Sxc,  A2 = sum cx_u Sys,
//                        A3 = sum sx_u Syc,     A4 = sum sx_u Sxs,
//   W[+-u, +v] = (A1 - A2) -+ (A3 + A4),  W[+-u, -v] = (A1 + A2) -+ (A3 - A4):
// half the multiply-adds of the full-window sums (4 per lag pair, not 8).
//
//  K3: P[d*E + e] = conj(X_d) Z_e, one window extent; when Z is X, only
//      the upper pairs d <= e (the reduction mirrors the lower ones,
//      W[e, d](l) = W[d, e](-l)).
//  K4: the whole fused-anchor pass in one read of X:
//      - the anchor spectra K0[e, d](wx, wy) of the composed taps: a block's
//        rows are fixed, so it contracts the taps over kx first (per row,
//        A[ed, ly]), then folds ly and -ly into cos/sin coefficients, and
//        builds K0 bin by bin from them (2 + 4 hy2 multiply-adds an entry);
//      - EG_e = s1 * sum_d K0[e, d] X_d - X_e, bin by bin, never stored;
//      - XX products conj(X_d) X_e for d <= e at +-4h (mirrored as K3's),
//        EG products conj(X_d) EG_e at +-2h, sum w |EG|^2, EG at the DC bin.
//      The +-2h lag basis is the first hy2 + 1 columns of the +-4h one
//      (ops/dft.lag_basis computes both from the same angles), so K4
//      stages one basis and the EG pairs read its first columns.
//      The signal may be read as bf16 re/im planes; all arithmetic is f32.
//      Row slabs (the tensor-parallel precompute, pallas_windows.py:324-333):
//      X may hold rows [row0, row0 + nx_l) of the grid only; a block then
//      reads each row's x basis (and so its anchor phases) at its grid
//      row, takes no row at or past the grid's nx, never reads past the
//      slab's own rows, and the outputs are the slab's partial sums (every
//      one is linear or additive over the rows; e0 is 0 unless the slab
//      holds grid row 0).
//
// What bounds it on Hopper: float32 operations.  K4 at D = 3, 5x5 kernels
// does about 0.9 kFLOP per bin and batch (0.8 k of them the y-stage
// against 9 + 5 lag pairs of 6 XX and 9 EG products) for 24 bytes of X
// read, far above the card's flop/byte balance.  No tensor cores and no
// TF32: the sums stay IEEE float32 (the anchored decomposition cancels at
// the scale of the initial error).
//
// What the design does about it:
//  - one block per (tile of `rows` x-rows, group of `batches` batches, wy
//    chunk), the tiles chosen on the host (ops/window_kernels.window_plan)
//    so the grid holds about two blocks for every SM; the block stages its
//    chunk's lag basis, its rows' x basis (and K4's anchor basis and taps)
//    in shared memory once, with cp.async, and reuses them over every row
//    and batch;
//  - the y-stage is a register-blocked float32 product: a thread owns one
//    (pair, row) and all of its group's lag columns (up to 9 v, 36 sums in
//    registers); per wy it reads its product (8 bytes) and the basis row
//    as 16-byte broadcasts (the lanes of a warp share the group), then
//    does 4 multiply-adds per column for every batch of the block; the
//    warps of each group are whole, so no warp diverges;
//  - the block walks its chunk in steps of `ytile` bins: the next step's
//    signal arrives by cp.async while this one is worked on; K4's anchor
//    spectra for the step's bins (shared memory, once for all batches);
//    one thread a (bin, batch) forms the products into shared memory (EG
//    only in registers; up to 4 channels of X read once); then the
//    y-stage; every thread has work in each phase, and rows and ytile are
//    powers of two, so no index needs a division;
//  - the x-stage runs in the block, over its rows, from the y-stage sums in
//    shared memory; the block writes its four sums per (pair, u, v) and a
//    second launch (one warp per (pair, u, v)) adds the blocks in a fixed
//    order and writes the four quadrants: no atomics, so the windows repeat
//    bit for bit;
//  - a lag extent past 8 takes v-chunks of 8 columns (more threads a row);
//    where a row's bins do not fit in shared memory, the plan splits wy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemLimit = 232448;  // bytes a block may opt in to
constexpr int kMaxThreads = 512;

// v columns a thread takes for a window half-extent h (h + 1 columns): one
// chunk of 3, 5 or 9, else chunks of 8 (so a chunk's basis starts on 16
// bytes)
int cols_per_thread(int h) {
  const int nv = h + 1;
  return nv <= 3 ? 3 : nv <= 5 ? 5 : nv <= 9 ? 9 : 8;
}
int round4(int n) { return (n + 3) & ~3; }
// bf16 rows of the signal tile: at least ytile + 1 bins (a copy of 4-byte
// words may start one bin early), a power of two of words: 2 * ytile bins
// (2 for ytile = 1), the bytes of a complex64 row
__host__ __device__ __forceinline__ int bf16_row(int ytile) {
  return ytile > 1 ? 2 * ytile : 2;
}
int cdiv(int n, int d) { return (n + d - 1) / d; }

// one window extent: its pairs, its lag columns, and where its work sits
struct Group {
  int npairs, hx, hy;
  int nvt, nvch;   // v columns a thread, v-chunks
  int upper_of;    // D when the pairs are the upper d <= e of D x D, else 0
  int pcol;        // first product column in P
  int toff;        // first thread (a multiple of 32)
  int nunits;      // npairs * nvch * rows: threads with a y-stage tile
  int soff;        // first (pair, v) row of the y-stage sums
  int xoff;        // first x-stage unit
  float* out;      // [npairs as (d, e)][2hx + 1][2hy + 1]
};

struct Args {
  const float2* X;
  const float2* Z;
  const __nv_bfloat16* xre;
  const __nv_bfloat16* xim;
  const float* taps;   // K4: [D*D][nk2][nl2]
  const float* ybas;   // [nyr][ystride]: (w cos, w sin) for v = 0..
  const float* xbas;   // [nx][xstride]: (cos, sin) for u = 0..
  const float* yanc;   // K4: [nyr][astride]: (cos, sin) for m = 1..hy2, w
  float4* part;        // [nxu][nblk]: the x-stage's four sums per block
  float* seg_part;     // K4: [nblk]
  float* e0_part;      // K4: [nbg][D]
  // nx: the rows of X (and Z) as stored; nxg: the rows of the frequency
  // grid, which the x basis covers; row0: the grid row of X's row 0 (K4's
  // row slabs; K3 and a whole K4 call: nx = nxg, row0 = 0)
  int B, D, E, nx, nyr, nxg, row0;
  int rows, batches, ychunk, ytile, nsub;
  int lrows, lytile;   // log2 of rows and ytile (both powers of two)
  int ystride, xstride, astride;
  int hx2, hy2;        // K4: the taps' half-extents
  float s1;
  int ngroups, nxu, nblk, same, threads;
  int pstride;         // float2 columns of one (batch, wy) row of P
  // shared-memory offsets, in floats
  int o_ybas, o_xbas, o_yanc, o_taps, o_coef, o_khat, o_sig, o_p, o_red,
      o_e0, smem_floats;
  int sig_floats;      // floats of one of the two signal-tile buffers
  Group g[2];
};

// The layout of a block's shared memory and its threads; returns false if
// the plan cannot run.
int log2_exact(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return (1 << k) == n ? k : -1;
}

bool layout(Args& a, bool anchor, int nva, int nvb) {
  a.ngroups = anchor ? 2 : 1;
  a.lrows = log2_exact(a.rows);
  a.lytile = log2_exact(a.ytile);
  if (a.lrows < 0 || a.lytile < 0) return false;
  const int nvts[2] = {nva, nvb};
  int threads = 0, pcol = 0, soff = 0, xoff = 0, nvs = 0;
  for (int i = 0; i < a.ngroups; ++i) {
    Group& g = a.g[i];
    g.nvt = nvts[i];
    g.nvch = cdiv(g.hy + 1, g.nvt);
    g.nunits = g.npairs * g.nvch * a.rows;
    g.toff = threads;
    threads += 32 * cdiv(g.nunits, 32);
    g.pcol = pcol;
    pcol += g.npairs * a.rows;
    g.soff = soff;
    soff += g.npairs * (g.hy + 1);
    g.xoff = xoff;
    xoff += g.npairs * (g.hx + 1) * (g.hy + 1);
    nvs = g.nvch * g.nvt > nvs ? g.nvch * g.nvt : nvs;
  }
  if (anchor && (a.g[1].hy > a.g[0].hy || a.g[1].hx > a.g[0].hx)) return false;
  a.threads = threads;
  a.nxu = xoff;
  // a warp's product stores run along wy (ytile lanes) and the rows: a
  // row of P that is 16 / ytile banks of 8 bytes from the next puts each
  // half-warp on 16 distinct ones
  const int want = a.ytile < 16 ? 16 / a.ytile : 1;
  a.pstride = pcol + (((want - pcol) % 16) + 16) % 16;
  a.ystride = round4(2 * nvs);
  a.xstride = round4(2 * (a.g[0].hx + 1));
  a.astride = round4(2 * a.hy2 + 1);
  a.nsub = cdiv(a.ychunk, a.ytile);
  const int ypad = a.nsub * a.ytile;
  const int dd = a.D * a.D;
  int o = 0;
  a.o_ybas = o;
  o += ypad * a.ystride;
  a.o_xbas = o;
  o += a.rows * a.xstride;
  a.o_yanc = o;
  o += anchor ? ypad * a.astride : 0;
  a.o_taps = o;
  o += anchor ? round4(dd * (2 * a.hx2 + 1) * (2 * a.hy2 + 1)) : 0;
  a.o_coef = o;
  o += anchor ? a.rows * dd * (a.hy2 + 1) * 4 : 0;
  a.o_khat = o;
  o += anchor ? round4(dd * a.rows * a.ytile * 2) : 0;
  // the step's signal (X, and K3's Z): complex64, or bf16 re/im rows of
  // ytile + 2 (a word-aligned copy starts up to one bin early)
  const int chans = a.D + (anchor || a.same ? 0 : a.E);
  a.sig_floats = round4(a.batches * chans * a.rows * 2 * a.ytile);
  a.o_sig = o;
  o += 2 * a.sig_floats;
  a.o_p = o;
  const int p = a.batches * a.ytile * a.pstride * 2;
  const int s = soff * (a.rows + 1) * 4;
  o += round4(p > s ? p : s);
  a.o_red = o;
  o += round4(threads / 32);
  a.o_e0 = o;
  o += round4(a.batches * a.D);
  a.smem_floats = o;
  return a.rows >= 1 && a.batches >= 1 && a.ychunk >= 1 && a.ytile >= 1 &&
         threads <= kMaxThreads && (size_t)o * 4 <= kSmemLimit;
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0));
}

// rows [0, n) of a [*, stride] table into shared memory from row r0 of
// global, zero past `live` rows
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int live,
                                           int stride, int tid, int nthr) {
  const int n4 = n * stride / 4;
  for (int i = tid; i < n4; i += nthr) {
    const int r = 4 * i / stride;
    const bool ok = r < live;
    copy16(dst + 4 * i, ok ? src + (size_t)r0 * stride + 4 * i : src, ok);
  }
}

__device__ __forceinline__ void copy_small(void* dst, const void* src,
                                           int bytes, int live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(live));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(live));
}

// One step's signal into shared memory, by cp.async: channels [0, C) of
// `src` ([B, C, nx, nyr]) for the block's batches, rows and the step's
// bins [yg, yg + ylen); complex64 as [b][c][r][ytile], bf16 as re and im
// planes of [b][c][r][ytile + 2] (bin yl at yl + the row's start parity)
template <bool BF16>
__device__ __forceinline__ void stage_signal(const Args& a, float* dst,
                                             const float2* src,
                                             const __nv_bfloat16* re,
                                             const __nv_bfloat16* im, int C,
                                             int b0, int nbv, int x0,
                                             int rows, int yg, int ylen,
                                             int tid, int nthr) {
  const int rt = a.rows, yt = a.ytile;
  if (!BF16) {
    float2* d2 = reinterpret_cast<float2*>(dst);
    for (int i = tid; i < nbv * C * rt * yt; i += nthr) {
      const int yl = i & (yt - 1), r = (i >> a.lytile) & (rt - 1);
      const int bc = i >> (a.lytile + a.lrows);
      if (r >= rows || yl >= ylen) continue;
      copy_small(d2 + i,
                 src + (((size_t)b0 * C + bc) * a.nx + x0 + r) * a.nyr + yg +
                     yl,
                 8, 8);
    }
    return;
  }
  const int lw = yt > 1 ? a.lytile : 0;  // log2 of the words a row
  const int nrow = nbv * C * rt;
  const size_t total = (size_t)a.B * C * a.nx * a.nyr;
  __nv_bfloat16* dre = reinterpret_cast<__nv_bfloat16*>(dst);
  __nv_bfloat16* dim = dre + (size_t)a.batches * C * rt * bf16_row(yt);
  for (int i = tid; i < (2 * nrow) << lw; i += nthr) {
    const int w = i & ((1 << lw) - 1), row2 = i >> lw;
    const int pl = row2 >= nrow, row = row2 - (pl ? nrow : 0);
    const int r = row & (rt - 1);
    const size_t start =
        (((size_t)b0 * C + (row >> a.lrows)) * a.nx + x0 + r) * a.nyr + yg;
    const size_t w0 = start / 2 + w;
    if (r >= rows || 2 * w >= (int)(start & 1) + ylen) continue;
    const int bytes = (int)min((size_t)4, 2 * (total - 2 * w0));
    copy_small((pl ? dim : dre) + (size_t)row * bf16_row(yt) + 2 * w,
               (pl ? im : re) + 2 * w0, 4, bytes);
  }
}

// bin (b, c, r, yl) of a staged step
template <bool BF16>
__device__ __forceinline__ float2 staged(const Args& a, const float* sig,
                                         int C, int b0, int x0, int yg,
                                         int b, int c, int r, int yl) {
  const int rt = a.rows, yt = a.ytile;
  const int row = (b * C + c) * rt + r;
  if (!BF16) return reinterpret_cast<const float2*>(sig)[row * yt + yl];
  // the parity of the row's first element (wrapping 32-bit products keep
  // it)
  const unsigned odd =
      ((((unsigned)(b0 + b) * C + c) * a.nx + x0 + r) * a.nyr + yg) & 1u;
  const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(sig);
  const int k = row * bf16_row(yt) + (int)odd + yl;
  const int nrow = a.batches * C * rt;
  return make_float2(__bfloat162float(re[k]),
                     __bfloat162float(re[(size_t)nrow * bf16_row(yt) + k]));
}

// conj(x) * z
__device__ __forceinline__ float2 conj_mul(float2 x, float2 z) {
  return make_float2(x.x * z.x + x.y * z.y, x.x * z.y - x.y * z.x);
}

// the y-stage of one thread's (pair, row) over one step: NVT lag columns
// from `bas` (a row of ybas, 16-byte aligned), its product column `p`
template <int NVT, int N>
__device__ __forceinline__ void ystage(float (&acc)[N][4],
                                       const float2* __restrict__ p,
                                       int pstride, int ytile, int nbv,
                                       const float* __restrict__ bas,
                                       int ystride) {
#pragma unroll 2
  for (int yl = 0; yl < ytile; ++yl) {
    float c[NVT], s[NVT];
    const float* row = bas + yl * ystride;
#pragma unroll
    for (int j = 0; j + 1 < NVT; j += 2) {
      const float4 t = *reinterpret_cast<const float4*>(row + 2 * j);
      c[j] = t.x;
      s[j] = t.y;
      c[j + 1] = t.z;
      s[j + 1] = t.w;
    }
    if (NVT & 1) {
      const float2 t = *reinterpret_cast<const float2*>(row + 2 * (NVT - 1));
      c[NVT - 1] = t.x;
      s[NVT - 1] = t.y;
    }
    for (int b = 0; b < nbv; ++b) {
      const float2 v = p[(b * ytile + yl) * pstride];
#pragma unroll
      for (int j = 0; j < NVT; ++j) {
        acc[j][0] = fmaf(v.x, c[j], acc[j][0]);
        acc[j][1] = fmaf(v.y, s[j], acc[j][1]);
        acc[j][2] = fmaf(v.x, s[j], acc[j][2]);
        acc[j][3] = fmaf(v.y, c[j], acc[j][3]);
      }
    }
  }
}

template <int NVT, int N>
__device__ __forceinline__ void store_sums(const float (&acc)[N][4],
                                           float4* __restrict__ sums,
                                           const Group& g, int q, int vc,
                                           int r, int rows) {
#pragma unroll
  for (int j = 0; j < NVT; ++j) {
    const int v = vc * NVT + j;
    if (v <= g.hy)
      sums[(g.soff + q * (g.hy + 1) + v) * (rows + 1) + r] =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

// The products of one (bin, batch) into its row of P: K3's pairs, or K4's
// EG (with its sum w|EG|^2 and DC value) and both groups' pairs.  DM, EM >
// 0: the D <= DM channels of X and E <= EM of Z are read from the staged
// step once, into registers; 0: read where used (any D, E).
template <bool ANCHOR, bool BF16, int DM, int EM>
__device__ __forceinline__ void products(const Args& a, const float* sig,
                                         float2* prow, const float2* kh,
                                         int b0, int x0, int yg, int b,
                                         int r, int yl, float wy, bool dc,
                                         float* s_e0, float& seg) {
  const int D = a.D, E = a.E, rt = a.rows, yt = a.ytile;
  const int nd = DM ? DM : D, ne = EM ? EM : E;
  float2 xr[DM ? DM : 1], zr[EM ? EM : 1];
  const float* zs = sig + a.batches * D * rt * yt * 2;
  if (DM) {
#pragma unroll
    for (int d = 0; d < (DM ? DM : 1); ++d)
      if (d < D) xr[d] = staged<BF16>(a, sig, D, b0, x0, yg, b, d, r, yl);
  }
  auto X = [&](int d) {
    return DM ? xr[d] : staged<BF16>(a, sig, D, b0, x0, yg, b, d, r, yl);
  };
  if (!ANCHOR) {
    const Group& ga = a.g[0];
    if (a.same) {
      int q = 0;
#pragma unroll
      for (int d = 0; d < nd; ++d) {
        if (d >= D) break;
#pragma unroll
        for (int e = d; e < nd; ++e) {
          if (e >= D) break;
          prow[ga.pcol + q++ * rt + r] = conj_mul(X(d), X(e));
        }
      }
      return;
    }
    if (EM) {
#pragma unroll
      for (int e = 0; e < (EM ? EM : 1); ++e)
        if (e < E) zr[e] = staged<false>(a, zs, E, b0, x0, yg, b, e, r, yl);
    }
#pragma unroll
    for (int d = 0; d < nd; ++d) {
      if (d >= D) break;
#pragma unroll
      for (int e = 0; e < ne; ++e) {
        if (e >= E) break;
        const float2 z =
            EM ? zr[e] : staged<false>(a, zs, E, b0, x0, yg, b, e, r, yl);
        prow[ga.pcol + (d * E + e) * rt + r] = conj_mul(X(d), z);
      }
    }
    return;
  }
  const Group& gx = a.g[0];
  const Group& ge = a.g[1];
#pragma unroll
  for (int e = 0; e < nd; ++e) {
    if (e >= D) break;
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int d = 0; d < nd; ++d) {
      if (d >= D) break;
      const float2 k = kh[(e * D + d) * rt * yt];
      const float2 xd = X(d);
      ar += k.x * xd.x - k.y * xd.y;
      ai += k.x * xd.y + k.y * xd.x;
    }
    const float2 xe = X(e);
    const float2 eg = make_float2(a.s1 * ar - xe.x, a.s1 * ai - xe.y);
    seg += wy * (eg.x * eg.x + eg.y * eg.y);
    if (dc) s_e0[b * D + e] = eg.x;
#pragma unroll
    for (int d = 0; d < nd; ++d) {
      if (d >= D) break;
      prow[ge.pcol + (d * D + e) * rt + r] = conj_mul(X(d), eg);
    }
  }
  int q = 0;
#pragma unroll
  for (int d = 0; d < nd; ++d) {
    if (d >= D) break;
#pragma unroll
    for (int e = d; e < nd; ++e) {
      if (e >= D) break;
      prow[gx.pcol + q++ * rt + r] = conj_mul(X(d), X(e));
    }
  }
}

// One block: x-rows [blockIdx.x * rows, +rows), batches [blockIdx.y *
// batches, +batches), wy chunk blockIdx.z.  Writes its x-stage sums (and
// K4's sum w|EG|^2 and DC error) to the scratch partials.
template <int NVA, int NVB, bool ANCHOR, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
window_rows_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_ybas = sm + a.o_ybas;
  float* s_xbas = sm + a.o_xbas;
  float* s_yanc = sm + a.o_yanc;
  float* s_taps = sm + a.o_taps;
  float4* s_coef = reinterpret_cast<float4*>(sm + a.o_coef);
  float2* s_khat = reinterpret_cast<float2*>(sm + a.o_khat);
  float2* s_p = reinterpret_cast<float2*>(sm + a.o_p);
  float4* s_sum = reinterpret_cast<float4*>(sm + a.o_p);  // after the loop
  float* s_red = sm + a.o_red;
  float* s_e0 = sm + a.o_e0;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rt = a.rows, yt = a.ytile;
  const int x0 = blockIdx.x * rt;      // the block's first row of X
  const int gx0 = a.row0 + x0;          // ... and of the grid
  // rows of X the block takes: none at or past the grid's nx
  const int rows = max(0, min(rt, min(a.nx - x0, a.nxg - gx0)));
  const int b0 = blockIdx.y * a.batches;
  const int nbv = min(a.batches, a.B - b0);
  const int y0 = blockIdx.z * a.ychunk;
  const int ylen = min(a.ychunk, a.nyr - y0);
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                  blockIdx.x;
  const int dd = a.D * a.D, m1 = a.hy2 + 1;
  const int nk2 = 2 * a.hx2 + 1, nl2 = 2 * a.hy2 + 1;
  const bool cross = !ANCHOR && !a.same;  // K3 with its own Z
  // one step's signal, by cp.async into the other of two buffers while
  // the block works on this one
  auto stage = [&](int sub) {
    float* buf = sm + a.o_sig + (sub & 1) * a.sig_floats;
    const int ys = sub * yt, n = min(yt, ylen - ys);
    stage_signal<BF16>(a, buf, a.X, a.xre, a.xim, a.D, b0, nbv, x0, rows,
                       y0 + ys, n, tid, nthr);
    if (cross)
      stage_signal<false>(a, buf + a.batches * a.D * rt * yt * 2,
                          a.Z, nullptr, nullptr, a.E, b0, nbv, x0, rows,
                          y0 + ys, n, tid, nthr);
  };

  // the chunk's bases (zero past its end), the rows' x basis, K4's taps,
  // and the first step's signal
  const int ypad = a.nsub * yt;
  stage_rows(s_ybas, a.ybas, y0, ypad, ylen, a.ystride, tid, nthr);
  stage_rows(s_xbas, a.xbas, gx0, rt, rows, a.xstride, tid, nthr);
  if (ANCHOR) {
    stage_rows(s_yanc, a.yanc, y0, ypad, ylen, a.astride, tid, nthr);
    for (int i = tid; i < dd * nk2 * nl2; i += nthr)
      copy_small(s_taps + i, a.taps + i, 4, 4);
  }
  stage(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < a.batches * a.D; i += nthr) s_e0[i] = 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (ANCHOR) {
    // the taps contracted over kx at each row: A[ed][ly], folded over +-ly
    // into (P.re, Q.im, P.im, -Q.re), P = A[+m] + A[-m], Q = A[+m] - A[-m]
    for (int i = tid; i < rt * dd * m1; i += nthr) {
      const int m = i % m1, ed = (i / m1) % dd, r = i / (m1 * dd);
      const float* tp = s_taps + ed * nk2 * nl2;
      const float* xb = s_xbas + r * a.xstride;
      float pr = 0.f, pi = 0.f, mr = 0.f, mi = 0.f;
      for (int k = 0; k < nk2; ++k) {
        const int mx = k - a.hx2, u = mx < 0 ? -mx : mx;
        const float c = xb[2 * u], s = mx < 0 ? -xb[2 * u + 1] : xb[2 * u + 1];
        const float tpl = tp[k * nl2 + a.hy2 + m];
        const float tml = tp[k * nl2 + a.hy2 - m];
        pr += tpl * c;
        pi -= tpl * s;
        mr += tml * c;
        mi -= tml * s;
      }
      s_coef[i] = m == 0 ? make_float4(pr, pi, 0.f, 0.f)
                         : make_float4(pr + mr, pi - mi, pi + mi, mr - pr);
    }
  }

  // this thread's y-stage tile: group g (whole warps), pair q, v-chunk vc,
  // row r
  const int gi = (a.ngroups == 2 && tid >= a.g[1].toff) ? 1 : 0;
  const Group& g = a.g[gi];
  const int lu = tid - g.toff;
  const bool active = lu < g.nunits;
  const int q = (lu >> a.lrows) / g.nvch, vc = (lu >> a.lrows) % g.nvch;
  const int r_own = lu & (rt - 1);
  const float2* p_own = s_p + g.pcol + q * rt + r_own;
  constexpr int kCols = NVA > NVB ? NVA : NVB;
  float acc[kCols][4];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float seg = 0.f;

  for (int sub = 0; sub < a.nsub; ++sub) {
    const int ys = sub * yt;
    if (sub + 1 < a.nsub) {
      stage(sub + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sig = sm + a.o_sig + (sub & 1) * a.sig_floats;
    const int yg = y0 + ys;
    if (ANCHOR) {
      // the step's anchor spectra, once for all batches
      for (int i = tid; i < dd * rt * yt; i += nthr) {
        const int yl = i & (yt - 1), r = (i >> a.lytile) & (rt - 1);
        const int ed = i >> (a.lytile + a.lrows);
        const float4* cf = s_coef + (r * dd + ed) * m1;
        const float* ya = s_yanc + (ys + yl) * a.astride;
        const float4 c0 = cf[0];
        float kr = c0.x, ki = c0.y;
#pragma unroll 4
        for (int m = 1; m < m1; ++m) {
          const float4 f = cf[m];
          const float c = ya[2 * m - 2], s = ya[2 * m - 1];
          kr += f.x * c + f.y * s;
          ki += f.z * c + f.w * s;
        }
        s_khat[i] = make_float2(kr, ki);
      }
      __syncthreads();
    }
    // the products, one thread a (bin, batch)
    for (int i = tid; i < nbv * rt * yt; i += nthr) {
      const int yl = i & (yt - 1), r = (i >> a.lytile) & (rt - 1);
      const int b = i >> (a.lytile + a.lrows);
      float2* prow = s_p + (b * yt + yl) * a.pstride;
      if (r >= rows || ys + yl >= ylen) {
        for (int gg = 0; gg < a.ngroups; ++gg)
          for (int qq = 0; qq < a.g[gg].npairs; ++qq)
            prow[a.g[gg].pcol + qq * rt + r] = make_float2(0.f, 0.f);
        continue;
      }
      const float wy =
          ANCHOR ? s_yanc[(ys + yl) * a.astride + 2 * a.hy2] : 0.f;
      const bool dc = ANCHOR && gx0 + r == 0 && yg + yl == 0;
      const float2* kh = s_khat + r * yt + yl;
      // up to 4 channels of X (8 of K3's Z) are read once, into registers
      if (a.D <= 4 && (ANCHOR || a.same || a.E <= 8))
        products<ANCHOR, BF16, 4, 8>(a, sig, prow, kh, b0, x0, yg, b, r, yl,
                                     wy, dc, s_e0, seg);
      else
        products<ANCHOR, BF16, 0, 0>(a, sig, prow, kh, b0, x0, yg, b, r, yl,
                                     wy, dc, s_e0, seg);
    }
    __syncthreads();
    if (active) {
      const float* bas = s_ybas + ys * a.ystride;
      if (gi == 0)
        ystage<NVA>(acc, p_own, a.pstride, yt, nbv, bas + 2 * vc * NVA,
                    a.ystride);
      else
        ystage<NVB>(acc, p_own, a.pstride, yt, nbv, bas + 2 * vc * NVB,
                    a.ystride);
    }
    __syncthreads();
  }

  // the y-stage sums to shared memory, then the x-stage over the rows
  if (active) {
    if (gi == 0)
      store_sums<NVA>(acc, s_sum, g, q, vc, r_own, rt);
    else
      store_sums<NVB>(acc, s_sum, g, q, vc, r_own, rt);
  }
  __syncthreads();
  for (int xu = tid; xu < a.nxu; xu += nthr) {
    const Group& gx = a.g[(a.ngroups == 2 && xu >= a.g[1].xoff) ? 1 : 0];
    const int k = xu - gx.xoff;
    const int u = k % (gx.hx + 1), v = (k / (gx.hx + 1)) % (gx.hy + 1);
    const int qq = k / ((gx.hx + 1) * (gx.hy + 1));
    const float4* ss = s_sum + (gx.soff + qq * (gx.hy + 1) + v) * (rt + 1);
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float4 sv = ss[r];
      const float2 cs =
          *reinterpret_cast<const float2*>(s_xbas + r * a.xstride + 2 * u);
      a1 = fmaf(cs.x, sv.x, a1);
      a2 = fmaf(cs.x, sv.y, a2);
      a3 = fmaf(cs.y, sv.w, a3);
      a4 = fmaf(cs.y, sv.z, a4);
    }
    a.part[(size_t)xu * a.nblk + blk] = make_float4(a1, a2, a3, a4);
  }
  if (ANCHOR) {
    // sum w|EG|^2 over the block in a fixed order; the DC error of the
    // block's batches
    for (int off = 16; off > 0; off >>= 1)
      seg += __shfl_down_sync(0xffffffffu, seg, off);
    if ((tid & 31) == 0) s_red[tid >> 5] = seg;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < nthr / 32; ++w) t += s_red[w];
      a.seg_part[blk] = t;
    }
    // the first block of each batch group writes its DC error: 0 where
    // the slab does not hold grid row 0
    if (x0 == 0 && y0 == 0 && tid < a.D) {
      float t = 0.f;
      for (int b = 0; b < nbv; ++b) t += s_e0[b * a.D + tid];
      a.e0_part[blockIdx.y * a.D + tid] = t;
    }
  }
}

// The sum over blocks, in a fixed order, and the four quadrants: one warp
// per (group, pair, u >= 0, v >= 0), its lanes striding over the blocks,
// then a shuffle tree; the warp after the last of K4 sums seg and e0.
// Outputs are / B.
__device__ __forceinline__ void put(const Group& g, int q, int iu, int iv,
                                    float val) {
  const int vx = 2 * g.hx + 1, vy = 2 * g.hy + 1;
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
    g.out[(((size_t)d * nd + e) * vx + iu) * vy + iv] = val;
    if (e != d)
      g.out[(((size_t)e * nd + d) * vx + (vx - 1 - iu)) * vy + (vy - 1 - iv)] =
          val;
  } else {
    g.out[((size_t)q * vx + iu) * vy + iv] = val;
  }
}

template <bool ANCHOR>
__global__ void __launch_bounds__(256)
window_reduce_kernel(const __grid_constant__ Args a, int nbg, float* __restrict__ seg_out,
                     float* __restrict__ e0_out) {
  const int lane = threadIdx.x & 31;
  const int xu = blockIdx.x * 8 + (threadIdx.x >> 5);
  const float inv_b = 1.f / (float)a.B;
  if (xu > a.nxu || (xu == a.nxu && !ANCHOR)) return;
  if (xu == a.nxu) {  // K4's scalars
    float t = 0.f;
    for (int k = lane; k < a.nblk; k += 32) t += a.seg_part[k];
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) {
      seg_out[0] = t * inv_b;
      for (int e = 0; e < a.D; ++e) {
        float s = 0.f;
        for (int k = 0; k < nbg; ++k) s += a.e0_part[k * a.D + e];
        e0_out[e] = s * inv_b;
      }
    }
    return;
  }
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* p = a.part + (size_t)xu * a.nblk;
  for (int k = lane; k < a.nblk; k += 32) {
    const float4 v = p[k];
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  for (int off = 16; off > 0; off >>= 1) {
    t.x += __shfl_down_sync(0xffffffffu, t.x, off);
    t.y += __shfl_down_sync(0xffffffffu, t.y, off);
    t.z += __shfl_down_sync(0xffffffffu, t.z, off);
    t.w += __shfl_down_sync(0xffffffffu, t.w, off);
  }
  if (lane != 0) return;
  const Group& g = a.g[(a.ngroups == 2 && xu >= a.g[1].xoff) ? 1 : 0];
  const int k = xu - g.xoff;
  const int u = k % (g.hx + 1), v = (k / (g.hx + 1)) % (g.hy + 1);
  const int q = k / ((g.hx + 1) * (g.hy + 1));
  const float dm = t.x - t.y, dp = t.x + t.y;  // x-stage of sr at +v, -v
  const float sp = t.z + t.w, sm = t.z - t.w;  // x-stage of si at +v, -v
  put(g, q, g.hx + u, g.hy + v, (dm - sp) * inv_b);
  put(g, q, g.hx + u, g.hy - v, (dp - sm) * inv_b);
  put(g, q, g.hx - u, g.hy + v, (dm + sp) * inv_b);
  put(g, q, g.hx - u, g.hy - v, (dp + sm) * inv_b);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The plan's common part: check it, lay out shared memory and scratch,
// and hand the scratch pointers to the launch.  Returns 0 or a cudaError.
int prepare(Args& a, bool anchor, int nva, int nvb, int smem_bytes,
            void* scratch, long long scratch_floats, int* nbg,
            dim3* grid) {
  if (a.B < 1 || a.D < 1 || a.nx < 1 || a.nyr < 1 || a.rows < 1 ||
      a.batches < 1 || a.ychunk < 1 || a.ytile < 1)
    return (int)cudaErrorInvalidValue;
  if (!layout(a, anchor, nva, nvb) || (long long)a.smem_floats * 4 !=
                                          (long long)smem_bytes)
    return (int)cudaErrorInvalidValue;
  *grid = dim3(cdiv(a.nx, a.rows), cdiv(a.B, a.batches),
               cdiv(a.nyr, a.ychunk));
  if (grid->y > 65535 || grid->z > 65535) return (int)cudaErrorInvalidValue;
  *nbg = (int)grid->y;
  a.nblk = (int)(grid->x * grid->y * grid->z);
  const long long need = 4LL * a.nxu * a.nblk + a.nblk + (long long)*nbg * a.D;
  if (scratch_floats < need) return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  a.part = reinterpret_cast<float4*>(s);
  a.seg_part = s + 4LL * a.nxu * a.nblk;
  a.e0_part = a.seg_part + a.nblk;
  return 0;
}

template <int NVA, int NVB, bool ANCHOR, bool BF16>
int launch(const Args& a, dim3 grid, int nbg, float* seg, float* e0,
           cudaStream_t st) {
  auto rows = window_rows_kernel<NVA, NVB, ANCHOR, BF16>;
  const size_t bytes = (size_t)a.smem_floats * 4;
  int err = set_smem(rows, bytes);
  if (err) return err;
  rows<<<grid, a.threads, bytes, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_reduce_kernel<ANCHOR><<<cdiv(a.nxu + 1, 8), 256, 0, st>>>(
      a, nbg, seg, e0);
  return (int)cudaGetLastError();
}

}  // namespace

// K3.  X: [B, D, nx, nyr], Z: [B, E, nx, nyr] complex64; same = 1: Z is X
// (E = D), and only the upper pairs are formed; consts: ybas [nyr][ystride]
// ((w cos, w sin) of 2pi wy v / ny for v = 0..hy, zero after), xbas
// [nx][xstride] ((cos, sin) of 2pi wx u / nx for u = 0..hx); out: [D, E,
// 2hx + 1, 2hy + 1].  The plan (rows, batches, ychunk, ytile) and its
// shared-memory bytes and scratch floats are window_plan's; the launch
// refuses one that does not match its own layout.
extern "C" int corr_pair_windows_launch(
    const void* X, const void* Z, const void* consts, void* out,
    void* scratch, long long scratch_floats, int B, int D, int E, int nx,
    int nyr, int hx, int hy, int same, int rows, int batches, int ychunk,
    int ytile, int smem_bytes, void* stream) {
  if ((same && E != D) || hx < 0 || hy < 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.X = static_cast<const float2*>(X);
  a.Z = static_cast<const float2*>(Z);
  a.B = B, a.D = D, a.E = E, a.nx = nx, a.nyr = nyr, a.same = same;
  a.nxg = nx, a.row0 = 0;
  a.rows = rows, a.batches = batches, a.ychunk = ychunk, a.ytile = ytile;
  a.g[0].npairs = same ? D * (D + 1) / 2 : D * E;
  a.g[0].hx = hx, a.g[0].hy = hy, a.g[0].upper_of = same ? D : 0;
  a.g[0].out = static_cast<float*>(out);
  const int nva = cols_per_thread(hy);
  int nbg;
  dim3 grid;
  int err = prepare(a, false, nva, 0, smem_bytes, scratch, scratch_floats,
                    &nbg, &grid);
  if (err) return err;
  const float* c = static_cast<const float*>(consts);
  a.ybas = c;
  a.xbas = c + (size_t)nyr * a.ystride;
  auto st = static_cast<cudaStream_t>(stream);
  switch (nva) {
    case 3: return launch<3, 3, false, false>(a, grid, nbg, 0, 0, st);
    case 5: return launch<5, 5, false, false>(a, grid, nbg, 0, 0, st);
    case 9: return launch<9, 9, false, false>(a, grid, nbg, 0, 0, st);
    default: return launch<8, 8, false, false>(a, grid, nbg, 0, 0, st);
  }
}

// K4.  X: [B, D, nx_l, nyr] complex64, or (bf16 != 0) the re/im planes
// xre, xim [B, D, nx_l, nyr] bf16: rows [row0, row0 + nx_l) of the nx-row
// grid (nx_l = nx, row0 = 0: the whole call); taps: [D*D, nk2, nl2]
// (composed anchor taps, [e, d] order; nk2 = 2 hx2 + 1, nl2 = 2 hy2 + 1);
// consts: ybas
// [nyr][ystride] (the +-4h lag basis, v = 0..2 hy2: the +-2h one is its
// first hy2 + 1 columns), xbas [nx][xstride] (u = 0..2 hx2), yanc
// [nyr][astride] ((cos, sin) of 2pi wy m / ny for m = 1..hy2, then w(wy));
// out: XX [D, D, 2nk2 - 1, 2nl2 - 1], EGw [D, D, nk2, nl2], seg [1], e0 [D]
// (the slab's partial sums).
extern "C" int anchor_windows_launch(
    const void* X, const void* xre, const void* xim, const void* taps,
    const void* consts, void* out, void* scratch, long long scratch_floats,
    int B, int D, int nx, int nx_l, int row0, int nyr, int nk2, int nl2,
    float s1, int bf16, int rows, int batches, int ychunk, int ytile,
    int smem_bytes, void* stream) {
  if (nk2 < 1 || nl2 < 1 || !(nk2 & 1) || !(nl2 & 1) || nx < 1 ||
      nx_l < 1 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.X = static_cast<const float2*>(X);
  a.xre = static_cast<const __nv_bfloat16*>(xre);
  a.xim = static_cast<const __nv_bfloat16*>(xim);
  a.taps = static_cast<const float*>(taps);
  a.B = B, a.D = D, a.E = D, a.nx = nx_l, a.nyr = nyr, a.s1 = s1;
  a.nxg = nx, a.row0 = row0;
  a.hx2 = nk2 / 2, a.hy2 = nl2 / 2;
  a.rows = rows, a.batches = batches, a.ychunk = ychunk, a.ytile = ytile;
  float* o = static_cast<float*>(out);
  const int vx4 = 2 * nk2 - 1, vy4 = 2 * nl2 - 1;
  a.g[0].npairs = D * (D + 1) / 2;
  a.g[0].hx = nk2 - 1, a.g[0].hy = nl2 - 1, a.g[0].upper_of = D;
  a.g[0].out = o;
  a.g[1].npairs = D * D;
  a.g[1].hx = a.hx2, a.g[1].hy = a.hy2, a.g[1].upper_of = 0;
  a.g[1].out = o + (size_t)D * D * vx4 * vy4;
  float* seg = a.g[1].out + (size_t)D * D * nk2 * nl2;
  float* e0 = seg + 1;
  const int nva = cols_per_thread(a.g[0].hy), nvb = cols_per_thread(a.hy2);
  int nbg;
  dim3 grid;
  int err = prepare(a, true, nva, nvb, smem_bytes, scratch, scratch_floats,
                    &nbg, &grid);
  if (err) return err;
  const float* c = static_cast<const float*>(consts);
  a.ybas = c;
  a.xbas = a.ybas + (size_t)nyr * a.ystride;
  a.yanc = a.xbas + (size_t)nx * a.xstride;
  auto st = static_cast<cudaStream_t>(stream);
  // (nva, nvb) for hy2 = 1, 2, 3-4, and beyond
  const int key = nva * 10 + nvb;
#define K4_CASE(A_, B_)                                                    \
  case A_ * 10 + B_:                                                       \
    return bf16 ? launch<A_, B_, true, true>(a, grid, nbg, seg, e0, st)    \
                : launch<A_, B_, true, false>(a, grid, nbg, seg, e0, st);
  switch (key) {
    K4_CASE(3, 3)
    K4_CASE(5, 3)
    K4_CASE(9, 5)
    K4_CASE(8, 9)
    K4_CASE(8, 8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_CASE
}
