// B5 · rfft2_mixed — the radix-4 four-step rfft2 in mixed bin order, as
// three kernels for the five Pallas bodies of spectralae/ops/pallas_fft.py.
//
// Replaces:
//  - dft_leaf_kernel<real>     : _make_y_kernel (pallas_fft.py:173), reached
//                                from rfft_y_mixed :461 (pallas_call :497);
//  - dft_leaf_kernel<complex>  : _make_yc_kernel (:387), from _fft_yc :425
//                                (:448), and _make_x_kernel (:218), from
//                                fft_x_mixed :513 (:559);
//  - bfly_round_kernel         : _make_bfly_lanes_kernel (:262), from
//                                _bfly_lanes :300 (:318), and
//                                _make_bfly_rows_kernel (:329), from
//                                _bfly_rows :352 (:375).
//
// Algebra (both axes): n = 4*m1, j = q*m1 + j1, w = 4*k1 + k2;
//   S[k2][j1] = sum_q W4^{q k2} x[q*m1 + j1]          (radix-4 butterfly)
//   P[k2][j1] = S[k2][j1] * W_n^{j1 k2}                (twiddle)
//   X[4 k1 + k2] = sum_j1 P[k2][j1] * W_m1^{j1 k1}     (leaf contraction)
// A leaf block holds a tile of P in shared memory and contracts it against
// cos/sin bases [m1][K]: X = P (bc - i bs).  The y-leaf contracts along the
// contiguous lanes of a row (K = k1p columns, w_y <= ny/2 only; the dead
// columns of the bases are zero); the x-leaf contracts along rows, carrying
// the lanes (K = m1).  The two are one template: they differ only in which
// axis of the input and output is contiguous, which the strides say.  The
// x-leaf writes [planes, 4, m1, L] (the JAX kernel's layout); the wrapper
// moves the y-groups into lanes with one copy, as the JAX package does.
// An axis longer than 4*_MAX_M1 first takes butterfly rounds (the same
// butterfly and twiddle, written out as four streams) until the leaf fits.
//
// What bounds it on Hopper, and what the design does about it.  The
// function needs an FFT's operations (5 n log2 n a complex row) and its
// bytes (input read once, output written once): at [12, 4096, 1024] 0.66
// GB, 0.195 ms at 3.35 TB/s.  The four-step's matmul DFT does m1 = n/4
// complex multiply-adds per output bin instead (64 GFLOP there), which on
// CUDA cores in float32 (67 TFLOP/s) bound the leaf by operations.  It
// runs on the tensor cores (wgmma, bf16 operands, float32 accumulate;
// csrc/wgmma.cuh), where one bf16 pass takes 0.065 ms at 989 TFLOP/s; the
// JAX precision tier chooses the passes ("default" 1, "high" 3, "highest"
// 6).  The products are not what bounds it: timed apart
// (scripts/torch_dft_ablation.py, PERF.md), staging the operands (the
// loads, butterfly, split and stores) takes longer than the products at
// every tier, and neither a second stage of the tiles that let the two
// overlap nor a cp.async ring of the bases made the leaf faster, so it
// stages once a chunk, through registers:
//  - a block of two warpgroups owns 64 data items x 32 frequencies for all
//    four k2 streams; the complex product is one real product
//    [Pr | Pi] . [[bc, -bs], [bs, bc]] of N = 64 columns (re | im),
//    contracted over 2*m1 in chunks of 32 j (64 wide); warpgroup g
//    accumulates streams 2g and 2g+1 in registers (64 floats a thread);
//  - while the tensor cores work on chunk c, each thread loads the four
//    input quarters of its data item at 8 consecutive j of chunk c + 1,
//    and its share of the chunk's bases, into registers.  The bases'
//    pieces come laid out in tile order from the host
//    (fft_kernels._leaf_tiles_on, cached), 8 KB a piece a chunk, shared
//    by the four streams.  When the products have read the tiles, each
//    thread forms butterfly and twiddle in exact float32 (no contracted
//    FMAs, so P is bit-equal to the plain version's), splits P into the
//    tier's bf16 pieces and writes them as 16-byte rows of the K-major A
//    tiles (no swizzle: wgmma.cuh), and stores the bases;
//  - above "default" each chunk's products start afresh and are added into
//    float32 totals in shared memory (wg::promote: the tensor cores
//    truncate as they accumulate);
//  - the epilogue stores the accumulators straight from registers: eight
//    neighbouring rows (x-leaf) or four frequency pairs (y-leaf) make each
//    32-byte sector.
// The butterfly round is elementwise: one thread per output position of the
// four streams, coalesced along the contiguous axis.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;    // two warpgroups
constexpr int kTD = 64;          // data items per block (y: rows, x: lanes)
constexpr int kTF = 32;          // frequencies per block (N = 64: re | im)
constexpr int kJC = 32;          // j per chunk (contraction 64: Pr | Pi)

struct Leaf {
  const float* xr;
  const float* xi;     // null: real input
  void* outr;
  void* outi;
  const uint4* tiles;  // bases: [nf][nc][pieces][64 x 64 bf16, tile order]
  const float* twc;    // [4][m1]
  const float* tws;
  int Dn, m1, K, vec;  // vec: 8 j of a row are 32 aligned, contiguous bytes
  long long in_plane, in_d, in_j;     // quarter q starts at q*m1*in_j
  long long out_plane, out_k2, out_d, out_k;
};

// the radix-4 butterfly of four complex quarters, then the twiddle of each
// stream k2 by (c[k2] - i s[k2]); real input has zero imaginary parts.
// Rounded operations only (never a contracted FMA): the result is the
// plain version's to the bit.
__device__ __forceinline__ void butterfly_twiddle(const float r[4],
                                                  const float i[4],
                                                  const float c[4],
                                                  const float s[4],
                                                  float pr[4], float pi[4]) {
  const float e_r = __fadd_rn(r[0], r[2]), e_i = __fadd_rn(i[0], i[2]);
  const float o_r = __fadd_rn(r[1], r[3]), o_i = __fadd_rn(i[1], i[3]);
  const float d_r = __fsub_rn(r[0], r[2]), d_i = __fsub_rn(i[0], i[2]);
  const float f_r = __fsub_rn(r[1], r[3]), f_i = __fsub_rn(i[1], i[3]);
  const float sr[4] = {__fadd_rn(e_r, o_r), __fadd_rn(d_r, f_i),
                       __fsub_rn(e_r, o_r), __fsub_rn(d_r, f_i)};
  const float si[4] = {__fadd_rn(e_i, o_i), __fsub_rn(d_i, f_r),
                       __fsub_rn(e_i, o_i), __fadd_rn(d_i, f_r)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pr[k] = __fadd_rn(__fmul_rn(sr[k], c[k]), __fmul_rn(si[k], s[k]));
    pi[k] = __fsub_rn(__fmul_rn(si[k], c[k]), __fmul_rn(sr[k], s[k]));
  }
}

template <bool BF16>
__device__ __forceinline__ void store(void* out, size_t i, float v) {
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// One chunk's registers of one thread: the four quarters (re, im) of its
// data item at its 8 j, and its share of the chunk's bases tile.
template <int NP>
struct Stage {
  float r[4][8], i[4][8];
  uint4 b[NP * 2];
};

template <bool CPLX, int NP>
__device__ __forceinline__ void load_stage(const Leaf& a, const float* xr,
                                           const float* xi, int d, int j0,
                                           const uint4* tiles,
                                           Stage<NP>& st) {
  const size_t qoff = (size_t)a.m1 * a.in_j;
  if (a.vec && d < a.Dn && j0 < a.m1) {       // m1 % 8 == 0: whole group
    const size_t o = (size_t)d * a.in_d + j0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(xr + o + q * qoff +
                                                          4 * h);
        st.r[q][4 * h] = v.x, st.r[q][4 * h + 1] = v.y;
        st.r[q][4 * h + 2] = v.z, st.r[q][4 * h + 3] = v.w;
        if (CPLX) {
          const float4 w = *reinterpret_cast<const float4*>(
              xi + o + q * qoff + 4 * h);
          st.i[q][4 * h] = w.x, st.i[q][4 * h + 1] = w.y;
          st.i[q][4 * h + 2] = w.z, st.i[q][4 * h + 3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) st.i[q][4 * h + e] = 0.f;
        }
      }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + e;
      const bool ok = d < a.Dn && j < a.m1;
      const size_t o = ok ? (size_t)d * a.in_d + (size_t)j * a.in_j : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        st.r[q][e] = ok ? xr[o + q * qoff] : 0.f;
        st.i[q][e] = (CPLX && ok) ? xi[o + q * qoff] : 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NP * 2; ++u)
    st.b[u] = tiles[threadIdx.x + u * kThreads];
}

// Dynamic shared memory: the A tiles [4 streams][NP pieces], then the B
// tile's NP pieces, 8 KB each; above "default" the float32 totals
// (wg::promote), 64 KB
template <int TIER>
__host__ __device__ constexpr int leaf_smem() {
  return 5 * wg::pieces(TIER) * wg::kTileElems * 2 +
         wg::total_bytes(TIER, 2, kThreads);
}

// Grid: (data tiles, frequency tiles, planes); shared memory: leaf_smem.
// While the products of chunk c run, chunk c + 1's inputs and bases load
// into registers; once the products have read the tiles, the block forms
// P from those inputs into the A tiles and stores the bases.
template <bool CPLX, bool BF16, int TIER>
__global__ void __launch_bounds__(kThreads, 1) dft_leaf_kernel(Leaf a) {
  constexpr int NP = wg::pieces(TIER);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const Bs = As + 4 * NP * wg::kTileElems;
  float4* const tot = reinterpret_cast<float4*>(Bs + NP * wg::kTileElems);
  const int tid = threadIdx.x, g = tid >> 7;
  const int d0 = blockIdx.x * kTD, f = blockIdx.y;
  const size_t plane = blockIdx.z;
  const float* xr = a.xr + plane * a.in_plane;
  const float* xi = CPLX ? a.xi + plane * a.in_plane : nullptr;
  // this thread's data item and group of 8 j in every chunk: the input's
  // contiguous axis runs across neighbouring threads
  const bool dfast = a.in_d == 1;
  const int dl = dfast ? (tid & 63) : (tid >> 2);
  const int jg = dfast ? (tid >> 6) : (tid & 3);
  const int d = d0 + dl;
  const int nc = (a.m1 + kJC - 1) / kJC;
  const uint4* tiles = a.tiles + (size_t)f * nc * NP * (wg::kTileElems / 8);

  float acc[2][1][32];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[s][0][v] = 0.f;

  Stage<NP> st;
  load_stage<CPLX, NP>(a, xr, xi, d, jg * 8, tiles, st);
  for (int c = 0; c < nc; ++c) {
    // P = twiddled butterfly of this chunk, its pieces into the A tiles
    float pr[4][8], pi[4][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = min(c * kJC + jg * 8 + e, a.m1 - 1);   // past m1: P = 0
      float r[4], im[4], cc[4], ss[4], qr[4], qi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        r[q] = st.r[q][e], im[q] = st.i[q][e];
        cc[q] = a.twc[(size_t)q * a.m1 + j];
        ss[q] = a.tws[(size_t)q * a.m1 + j];
      }
      butterfly_twiddle(r, im, cc, ss, qr, qi);
#pragma unroll
      for (int k = 0; k < 4; ++k) pr[k][e] = qr[k], pi[k][e] = qi[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat16* const t = As + k * NP * wg::kTileElems;
      __nv_bfloat16* re[NP];
      __nv_bfloat16* im[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        re[p] = t + p * wg::kTileElems + wg::tile_off(dl, jg * 8);
        im[p] = t + p * wg::kTileElems + wg::tile_off(dl, kJC + jg * 8);
      }
      wg::store_row8<NP>(pr[k], re);
      wg::store_row8<NP>(pi[k], im);
    }
#pragma unroll
    for (int u = 0; u < NP * 2; ++u)
      reinterpret_cast<uint4*>(Bs)[tid + u * kThreads] = st.b[u];
    wg::fence_stores();
    __syncthreads();
    // warpgroup g: streams 2g and 2g + 1 against the shared bases tile
#pragma unroll
    for (int s = 0; s < 2; ++s)
      wg::mma_chunk<TIER, 1>(acc[s],
                             As + (2 * g + s) * NP * wg::kTileElems,
                             wg::kTileElems, Bs, wg::kTileElems,
                             TIER > 0 || c == 0);
    if (c + 1 < nc)
      load_stage<CPLX, NP>(a, xr, xi, d, (c + 1) * kJC + jg * 8,
                           tiles + (size_t)(c + 1) * NP * (wg::kTileElems / 8),
                           st);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wg::finish<1>(acc[s]);
      if constexpr (TIER > 0)
        wg::promote<1>(acc[s], tot + s * 8 * kThreads, kThreads, c == 0);
    }
    __syncthreads();
  }
  if constexpr (TIER > 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
      wg::totals<1>(acc[s], tot + s * 8 * kThreads, kThreads);
  }

  // columns 0..31: the real parts of frequencies k0 + col, 32..63 the
  // imaginary parts
  const int k0 = f * kTF;
  const int t = tid & 127;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const size_t base = plane * a.out_plane + (size_t)(2 * g + s) * a.out_k2;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int row = d0 + wg::acc_row(t, v), col = wg::acc_col(t, v);
      const int k = k0 + (col & (kTF - 1));
      if (row >= a.Dn || k >= a.K) continue;
      const size_t o = base + (size_t)row * a.out_d + (size_t)k * a.out_k;
      store<BF16>(col < kTF ? a.outr : a.outi, o, acc[s][0][v]);
    }
  }
}

struct Round {
  const float* xr;
  const float* xi;     // null: real input
  float* outr;
  float* outi;
  const float* twc;    // [4][m]
  const float* tws;
  long long total;     // BD * S * T
  int S, T, m, tw_on_t;
  long long in_bd, in_q, in_s, in_t;
  long long out_bd, out_k2, out_s, out_t;
};

// One thread per position (bd, s, t) of the four output streams; the
// twiddle index j is t for the lane round and s for the row round.
template <bool CPLX>
__global__ void __launch_bounds__(kThreads) bfly_round_kernel(Round a) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= a.total) return;
  const long long t = idx % a.T, st = idx / a.T;
  const long long s = st % a.S, bd = st / a.S;
  const int j = (int)(a.tw_on_t ? t : s);
  const size_t in = bd * a.in_bd + s * a.in_s + t * a.in_t;
  float r[4], im[4], c[4], sn[4], pr[4], pi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = a.xr[in + q * a.in_q];
    im[q] = CPLX ? a.xi[in + q * a.in_q] : 0.f;
    c[q] = a.twc[(size_t)q * a.m + j];
    sn[q] = a.tws[(size_t)q * a.m + j];
  }
  butterfly_twiddle(r, im, c, sn, pr, pi);
  const size_t out = bd * a.out_bd + s * a.out_s + t * a.out_t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a.outr[out + k * a.out_k2] = pr[k];
    a.outi[out + k * a.out_k2] = pi[k];
  }
}

template <bool CPLX, bool BF16, int TIER>
cudaError_t launch_leaf_t(const Leaf& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = leaf_smem<TIER>();
  const cudaError_t err = cudaFuncSetAttribute(
      dft_leaf_kernel<CPLX, BF16, TIER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dft_leaf_kernel<CPLX, BF16, TIER><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool CPLX, bool BF16>
cudaError_t launch_leaf_tier(const Leaf& a, dim3 grid, int tier,
                             cudaStream_t st) {
  switch (tier) {
    case 0: return launch_leaf_t<CPLX, BF16, 0>(a, grid, st);
    case 1: return launch_leaf_t<CPLX, BF16, 1>(a, grid, st);
    case 2: return launch_leaf_t<CPLX, BF16, 2>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// tf, jc: the tile geometry the bases were laid out for (checked)
int launch_leaf(Leaf& a, const void* consts, const void* tiles, int planes,
                bool cplx, bool bf16, int tier, int tf, int jc,
                cudaStream_t st) {
  if (planes < 1 || planes > 65535 || a.Dn < 1 || a.m1 < 1 || a.K < 1 ||
      tf != kTF || jc != kJC)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Dn + kTD - 1) / kTD, (a.K + kTF - 1) / kTF, planes);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  // real input is the top-level y-leaf only, which stores float32
  if (!cplx && bf16) return (int)cudaErrorInvalidValue;
  a.twc = static_cast<const float*>(consts);
  a.tws = a.twc + (size_t)4 * a.m1;
  a.tiles = static_cast<const uint4*>(tiles);
  // whole groups of 8 j as two aligned float4 loads: contiguous j, and
  // every row and quarter 16-byte aligned
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec = a.in_j == 1 && a.m1 % 8 == 0 && a.in_d % 4 == 0 &&
          a.in_plane % 4 == 0 && aligned(a.xr) && (!cplx || aligned(a.xi));
  if (!cplx) return (int)launch_leaf_tier<false, false>(a, grid, tier, st);
  if (bf16) return (int)launch_leaf_tier<true, true>(a, grid, tier, st);
  return (int)launch_leaf_tier<true, false>(a, grid, tier, st);
}

}  // namespace

// The y-leaf (B5a, B5e).  x: [BD, R, n] float32 re (and im, or null for
// real input); consts: twc, tws [4][m1] float32 (m1 = n/4); tiles: the
// bases' bf16 pieces of the precision tier (0 default, 1 high, 2 highest)
// in tile order, [ceil(k1p/tf)][ceil(m1/jc)][tier + 1][2 tf x 2 jc]
// (fft_kernels._leaf_tiles_on), laid out for tf = kTF frequencies and
// jc = kJC j (checked); out re/im: [BD, 4, R, k1p] float32.
extern "C" int rfft_y_leaf_launch(const void* xr, const void* xi,
                                  const void* consts, const void* tiles,
                                  void* outr, void* outi, int BD, int R,
                                  int n, int k1p, int tier, int tf, int jc,
                                  void* stream) {
  if (n % 4 || n < 4) return (int)cudaErrorInvalidValue;
  Leaf a;
  a.xr = static_cast<const float*>(xr);
  a.xi = static_cast<const float*>(xi);
  a.outr = outr;
  a.outi = outi;
  a.Dn = R;
  a.m1 = n / 4;
  a.K = k1p;
  a.in_plane = (long long)R * n;
  a.in_d = n;
  a.in_j = 1;
  a.out_plane = 4LL * R * k1p;
  a.out_k2 = (long long)R * k1p;
  a.out_d = k1p;
  a.out_k = 1;
  return launch_leaf(a, consts, tiles, BD, xi != nullptr, false, tier, tf,
                     jc, static_cast<cudaStream_t>(stream));
}

// The x-leaf (B5b).  y: [BD, nx, L] float32 re, im; consts: twc, tws
// [4][m1] (m1 = nx/4); tiles: as for the y-leaf, of the symmetric [m1][m1]
// bases, [ceil(m1/tf)][ceil(m1/jc)][tier + 1][2 tf x 2 jc]; out re/im:
// [BD, 4, m1, L] = [BD, nx, L] in mixed row order, float32 or (bf16 != 0)
// bf16.
extern "C" int fft_x_leaf_launch(const void* yr, const void* yi,
                                 const void* consts, const void* tiles,
                                 void* outr, void* outi, int BD, int nx,
                                 int L, int bf16, int tier, int tf, int jc,
                                 void* stream) {
  if (nx % 4 || nx < 4 || yi == nullptr) return (int)cudaErrorInvalidValue;
  Leaf a;
  a.xr = static_cast<const float*>(yr);
  a.xi = static_cast<const float*>(yi);
  a.outr = outr;
  a.outi = outi;
  a.Dn = L;
  a.m1 = nx / 4;
  a.K = nx / 4;
  a.in_plane = (long long)nx * L;
  a.in_d = 1;
  a.in_j = L;
  a.out_plane = (long long)nx * L;
  a.out_k2 = (long long)a.m1 * L;
  a.out_d = 1;
  a.out_k = L;
  return launch_leaf(a, consts, tiles, BD, true, bf16 != 0, tier, tf, jc,
                     static_cast<cudaStream_t>(stream));
}

// One radix-4 DIF round (B5c, B5d).  lanes = 1: x [BD, A, n] (A rows; xi
// null for real input) -> [BD, 4, A, n/4]; lanes = 0: x [BD, n, A] (A lanes)
// -> [BD, 4, n/4, A].  consts: twc, tws [4][n/4]; out re/im float32.
extern "C" int bfly_round_launch(const void* xr, const void* xi,
                                 const void* consts, void* outr, void* outi,
                                 int BD, int A, int n, int lanes,
                                 void* stream) {
  if (n % 4 || n < 4 || BD < 1 || A < 1 || (!lanes && xi == nullptr))
    return (int)cudaErrorInvalidValue;
  const int m = n / 4;
  Round a;
  a.xr = static_cast<const float*>(xr);
  a.xi = static_cast<const float*>(xi);
  a.outr = static_cast<float*>(outr);
  a.outi = static_cast<float*>(outi);
  a.twc = static_cast<const float*>(consts);
  a.tws = a.twc + (size_t)4 * m;
  a.m = m;
  a.total = (long long)BD * A * m;
  if (lanes) {          // s = row, t = j
    a.S = A;
    a.T = m;
    a.tw_on_t = 1;
    a.in_bd = (long long)A * n;
    a.in_q = m;
    a.in_s = n;
    a.in_t = 1;
    a.out_bd = 4LL * A * m;
    a.out_k2 = (long long)A * m;
    a.out_s = m;
    a.out_t = 1;
  } else {              // s = j, t = lane
    a.S = m;
    a.T = A;
    a.tw_on_t = 0;
    a.in_bd = (long long)n * A;
    a.in_q = (long long)m * A;
    a.in_s = A;
    a.in_t = 1;
    a.out_bd = 4LL * m * A;
    a.out_k2 = (long long)m * A;
    a.out_s = A;
    a.out_t = 1;
  }
  const long long blocks = (a.total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (xi != nullptr)
    bfly_round_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  else
    bfly_round_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

namespace {

template <bool CPLX, bool BF16>
int leaf_attrs(int tier, int* out) {
  switch (tier) {
    case 0: return wg::attrs(dft_leaf_kernel<CPLX, BF16, 0>, leaf_smem<0>(),
                             out);
    case 1: return wg::attrs(dft_leaf_kernel<CPLX, BF16, 1>, leaf_smem<1>(),
                             out);
    case 2: return wg::attrs(dft_leaf_kernel<CPLX, BF16, 2>, leaf_smem<2>(),
                             out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The leaf kernel's registers, local bytes, static and dynamic shared
// memory (wg::attrs): out[0..3]; variant 0 real input, 1 complex, 2
// complex with bf16 out; tier 0..2.
extern "C" int dft_leaf_attrs(int variant, int tier, int* out) {
  switch (variant) {
    case 0: return leaf_attrs<false, false>(tier, out);
    case 1: return leaf_attrs<true, false>(tier, out);
    case 2: return leaf_attrs<true, true>(tier, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
