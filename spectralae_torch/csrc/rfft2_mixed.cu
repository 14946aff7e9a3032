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
// What bounds it on Hopper: float32 operations.  The four-step's matmul DFT
// does about m1 = n/4 complex multiply-adds per output bin (cuFFT about
// log2 n), so the leaf at 1024^2 is ~4 GFLOP per axis for ~30 MB of traffic,
// far above the card's flop/byte balance.  The products run as IEEE float32
// FMAs on CUDA cores (the JAX package's bf16 tiers fed the TPU's matrix
// unit); tensor cores are left for a later change.  The layout is chosen
// for correctness first and is a plain tiled product:
//  - a block computes a 32 (data items) x 32 (frequencies) tile for all four
//    k2 streams, looping over the reduction in chunks of 16: each chunk
//    loads the four input quarters of its 32 x 16 items, forms butterfly
//    and twiddle in registers and stores P to shared memory, with the
//    chunk's bases beside it;
//  - each of the 256 threads owns 4 items x 4 frequencies of one k2 (32
//    float accumulators) and reads P and the bases as float4: 4 shared
//    loads per 64 FMAs;
//  - the bases (up to 512 x 288 floats) are read from global memory a
//    chunk at a time: every block reads the same table, so L2 holds it.
// The butterfly round is elementwise: one thread per output position of the
// four streams, coalesced along the contiguous axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTD = 32;          // data items per block (y: rows, x: lanes)
constexpr int kTK = 32;          // frequencies per block
constexpr int kTJ = 16;          // reduction chunk
constexpr int kPitch = kTD + 4;  // padded shared row of the P tile

struct Leaf {
  const float* xr;
  const float* xi;     // null: real input
  void* outr;
  void* outi;
  const float* bc;     // [m1][K]
  const float* bs;
  const float* twc;    // [4][m1]
  const float* tws;
  int Dn, m1, K;
  long long in_plane, in_d, in_j;     // quarter q starts at q*m1*in_j
  long long out_plane, out_k2, out_d, out_k;
};

// the radix-4 butterfly of four complex quarters, then the twiddle of each
// stream k2 by (c[k2] - i s[k2]); real input has zero imaginary parts
__device__ __forceinline__ void butterfly_twiddle(const float r[4],
                                                  const float i[4],
                                                  const float c[4],
                                                  const float s[4],
                                                  float pr[4], float pi[4]) {
  const float e_r = r[0] + r[2], e_i = i[0] + i[2];
  const float o_r = r[1] + r[3], o_i = i[1] + i[3];
  const float d_r = r[0] - r[2], d_i = i[0] - i[2];
  const float f_r = r[1] - r[3], f_i = i[1] - i[3];
  const float sr[4] = {e_r + o_r, d_r + f_i, e_r - o_r, d_r - f_i};
  const float si[4] = {e_i + o_i, d_i - f_r, e_i - o_i, d_i + f_r};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pr[k] = sr[k] * c[k] + si[k] * s[k];
    pi[k] = si[k] * c[k] - sr[k] * s[k];
  }
}

template <bool BF16>
__device__ __forceinline__ void store(void* out, size_t i, float v) {
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// Grid: (data tiles, frequency tiles, planes).
template <bool CPLX, bool BF16>
__global__ void __launch_bounds__(kThreads) dft_leaf_kernel(Leaf a) {
  __shared__ __align__(16) float Pr[4][kTJ][kPitch];
  __shared__ __align__(16) float Pi[4][kTJ][kPitch];
  __shared__ __align__(16) float Bc[kTJ][kTK];
  __shared__ __align__(16) float Bs[kTJ][kTK];
  const int tid = threadIdx.x;
  const int kg = tid & 7, dg = (tid >> 3) & 7, k2 = tid >> 6;
  const int d0 = blockIdx.x * kTD, k0 = blockIdx.y * kTK;
  const size_t plane = blockIdx.z;
  const float* xr = a.xr + plane * a.in_plane;
  const float* xi = CPLX ? a.xi + plane * a.in_plane : nullptr;
  const size_t qoff = (size_t)a.m1 * a.in_j;
  // the input's contiguous axis runs across neighbouring threads
  const bool dfast = a.in_d == 1;
  float accr[4][4], acci[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) accr[u][v] = acci[u][v] = 0.f;

  for (int j0 = 0; j0 < a.m1; j0 += kTJ) {
    for (int e = tid; e < kTD * kTJ; e += kThreads) {
      const int dl = dfast ? e % kTD : e / kTJ;
      const int jl = dfast ? e / kTD : e % kTJ;
      const int d = d0 + dl, j = j0 + jl;
      float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
      if (d < a.Dn && j < a.m1) {
        const size_t o = (size_t)d * a.in_d + (size_t)j * a.in_j;
        float r[4], im[4], c[4], s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          r[q] = xr[o + q * qoff];
          im[q] = CPLX ? xi[o + q * qoff] : 0.f;
          c[q] = a.twc[(size_t)q * a.m1 + j];
          s[q] = a.tws[(size_t)q * a.m1 + j];
        }
        butterfly_twiddle(r, im, c, s, pr, pi);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Pr[k][jl][dl] = pr[k];
        Pi[k][jl][dl] = pi[k];
      }
    }
    for (int e = tid; e < kTJ * kTK; e += kThreads) {
      const int jl = e / kTK, kl = e % kTK;
      const int j = j0 + jl, k = k0 + kl;
      const bool ok = j < a.m1 && k < a.K;
      Bc[jl][kl] = ok ? a.bc[(size_t)j * a.K + k] : 0.f;
      Bs[jl][kl] = ok ? a.bs[(size_t)j * a.K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jl = 0; jl < kTJ; ++jl) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pr[k2][jl][dg * 4]);
      const float4 q4 = *reinterpret_cast<const float4*>(&Pi[k2][jl][dg * 4]);
      const float4 c4 = *reinterpret_cast<const float4*>(&Bc[jl][kg * 4]);
      const float4 s4 = *reinterpret_cast<const float4*>(&Bs[jl][kg * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float pi[4] = {q4.x, q4.y, q4.z, q4.w};
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // (pr + i pi)(c - i s)
          accr[u][v] = fmaf(pr[u], c[v], accr[u][v]);
          accr[u][v] = fmaf(pi[u], s[v], accr[u][v]);
          acci[u][v] = fmaf(pi[u], c[v], acci[u][v]);
          acci[u][v] = fmaf(-pr[u], s[v], acci[u][v]);
        }
    }
    __syncthreads();
  }

  const size_t base = plane * a.out_plane + (size_t)k2 * a.out_k2;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int d = d0 + dg * 4 + u;
    if (d >= a.Dn) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = k0 + kg * 4 + v;
      if (k >= a.K) continue;
      const size_t o = base + (size_t)d * a.out_d + (size_t)k * a.out_k;
      store<BF16>(a.outr, o, accr[u][v]);
      store<BF16>(a.outi, o, acci[u][v]);
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

int launch_leaf(const Leaf& a, int planes, bool cplx, bool bf16,
                cudaStream_t st) {
  if (planes < 1 || planes > 65535 || a.Dn < 1 || a.m1 < 1 || a.K < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Dn + kTD - 1) / kTD, (a.K + kTK - 1) / kTK, planes);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  // real input is the top-level y-leaf only, which stores float32
  if (!cplx && bf16) return (int)cudaErrorInvalidValue;
  if (!cplx)
    dft_leaf_kernel<false, false><<<grid, kThreads, 0, st>>>(a);
  else if (bf16)
    dft_leaf_kernel<true, true><<<grid, kThreads, 0, st>>>(a);
  else
    dft_leaf_kernel<true, false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

void set_bases(Leaf* a, const void* consts) {
  a->bc = static_cast<const float*>(consts);
  a->bs = a->bc + (size_t)a->m1 * a->K;
  a->twc = a->bs + (size_t)a->m1 * a->K;
  a->tws = a->twc + (size_t)4 * a->m1;
}

}  // namespace

// The y-leaf (B5a, B5e).  x: [BD, R, n] float32 re (and im, or null for
// real input); consts: bc, bs [m1][k1p], twc, tws [4][m1] (m1 = n/4);
// out re/im: [BD, 4, R, k1p] float32.
extern "C" int rfft_y_leaf_launch(const void* xr, const void* xi,
                                  const void* consts, void* outr, void* outi,
                                  int BD, int R, int n, int k1p,
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
  set_bases(&a, consts);
  a.in_plane = (long long)R * n;
  a.in_d = n;
  a.in_j = 1;
  a.out_plane = 4LL * R * k1p;
  a.out_k2 = (long long)R * k1p;
  a.out_d = k1p;
  a.out_k = 1;
  return launch_leaf(a, BD, xi != nullptr, false,
                     static_cast<cudaStream_t>(stream));
}

// The x-leaf (B5b).  y: [BD, nx, L] float32 re, im; consts: bc, bs [m1][m1]
// (symmetric), twc, tws [4][m1] (m1 = nx/4); out re/im: [BD, 4, m1, L] =
// [BD, nx, L] in mixed row order, float32 or (bf16 != 0) bf16.
extern "C" int fft_x_leaf_launch(const void* yr, const void* yi,
                                 const void* consts, void* outr, void* outi,
                                 int BD, int nx, int L, int bf16,
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
  set_bases(&a, consts);
  a.in_plane = (long long)nx * L;
  a.in_d = 1;
  a.in_j = L;
  a.out_plane = (long long)nx * L;
  a.out_k2 = (long long)a.m1 * L;
  a.out_d = 1;
  a.out_k = L;
  return launch_leaf(a, BD, true, bf16 != 0,
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
