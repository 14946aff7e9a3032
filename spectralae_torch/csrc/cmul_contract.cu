// K1 · cmul_contract — per-bin complex contraction for the spectral conv.
//
// Replaces: spectralae/ops/pallas_kernels.py · _cmul_contract (body
//   _cmul_contract_kernel), reached from spectral_conv_fused's forward and
//   from both contractions of its custom VJP (_conv_bwd).
//
// Computes, for every frequency bin w of a [.., W] complex64 layout,
//   out[a, b, w] = sum_k (p_scale * p[a, k, w]) * q'[k, b, w]
//                  (+ bias[b] * bias_scale  at w == 0 when bias != NULL)
// with float32 sums, where q' = conj(q) when conj_q != 0 and q otherwise.
// In the spectral conv's forward a = batch, k = D (input channels),
// b = M (output channels); p_scale = 1/M and the DC-bin bias b[m]*Nx*Ny
// are fused into this one pass.  Its backward runs the same kernel twice
// with conj_q = 1 (PyTorch's gradients of a complex-linear map carry the
// conjugate): dX[b, d] = sum_m g[b, m] conj(C[m, d]) / M, and
// dC[m, d] = sum_b g^T[m, b] conj(X[b, d]) / M, whose p = g^T is read
// through p's strides with no transposed copy.  bf16 operands (B1's
// compute_dtype path): the same kernel on __nv_bfloat162 pairs (4 bytes a
// complex bin), widened to float2 after the load; products, sums, the scale,
// the conjugation and the complex64 output stay float32.
//
// Two designs, chosen for each launch by the host from its shape alone
// (spectral_kernels.k1_plan): the lane design for the narrow launches, where
// it sits at its launch floor, and the blocked design wherever the lane
// design would fetch an operand from memory more than once.  Both compute
// every output as one thread's fixed-order chain of cmac's fmaf over
// k = 0 .. K-1, then the scale and the DC bias as one fused multiply-add
// (x * p_scale + dc, dc 0 off the DC bin), with no split of K, no atomics
// and no scratch: the two agree bit for bit, and a result repeats run to
// run.  The scale is applied to the sum (not to each p), within float32
// rounding of the plain version.
//
// What bounds it on Hopper: bytes — at K, B = 50 about one flop a byte,
// against the card's 20 (float32 on the CUDA cores: the configuration
// states TF32 off).  At the widths of the 10-wide reference net a launch
// moves 1-9 MB (0.3-2.7 us at 3.35 TB/s), so its floor is the launch plus
// one round trip to memory; at the M = 50 widths a launch moves 0.08-1.1 GB
// and its floor is the bytes.
//
// The lane design (cmul_contract_kernel, made for the 10-wide net):
//  - one thread holds one (b, w-vector) column: the output channel b is on
//    threadIdx.y, the bins on threadIdx.x (32 lanes, neighbouring lanes on
//    neighbouring bins), so a thread's serial work is one row's K products;
//  - K is a template parameter (1..16), so a thread's K loads of q and K
//    loads of p are all issued before its first FMA: one round trip to
//    memory, not K.  Above 16 a run-time loop, one round trip a k, which
//    the plan never takes (it is the blocked design's yardstick in the
//    card tests);
//  - 16-byte loads: two adjacent bins of float2, four of __nv_bfloat162,
//    where W, the strides and the pointers allow it (else one bin a lane);
//  - q[., b, w] for all k stays in registers while the thread walks up to
//    4 rows a (conjugated once, by a sign flip, after the load), so q is
//    read once per chunk of rows; the p vectors of a tile are shared by the
//    block's channel warps through L1 (ld.global.nc);
//  - the grid is (w tiles, channel groups, chunks of rows a): the rows in
//    as few equal chunks as keep 384 threads an SM, equal channel groups of
//    up to 8 warps a block, two or three warps once the grid has 8 blocks
//    an SM.
// At the 10-wide widths its launches take 2.1-3.6 us (a 256^2 b8 step's 17:
// 0.050 ms, bound 0.023) and the 1024^2 b4 step's 512^2 launches run at
// 1.3-1.5x their bytes bound.  But it reads q again for each
// chunk of 4 rows and p again for each channel group, and past K = 16 it
// loops over k with a round trip each: at M = 50 (K, B = 50, A = 16) it
// fetched the 0.66 GB of q 16 times at each 256^2 stage, 12x the launch's
// bound (31.0 ms of a 61.5 ms traced train step).
//
// The blocked design (cmul_contract_kernel_blocked, made for the M = 50
// widths and the b64 batch):
//  - a block owns a tile of 32 bins x na*4 rows a x nb*5 channels b (up to
//    20 warps): warp y takes rows (y % na)*4 + [0, 4) and channels
//    (y / na)*5 + [0, 5), a lane one bin, so a thread keeps 4 x 5 complex
//    sums in registers; a p element read from shared memory feeds 5 cmacs,
//    a q element 4;
//  - the tile's p[a-tile, k-stage, bins] and q[k-stage, b-tile, bins] are
//    staged into shared memory by cp.async (16-byte copies where the
//    layout allows, else 8 or 4), zero-filled past A, B, K and W, in a ring
//    of 2 or 3 buffers of kc = 4 or 8 values of k: the copies of the next
//    stages are in flight while this one is multiplied, one __syncthreads
//    a stage;
//  - the grid is as many blocks as stay resident; each walks every
//    gridDim-th tile, channel tiles fastest, and its ring runs on across
//    tiles, so a short K (3, 16) still overlaps copies with work.  q is
//    read from memory once a launch; p once per channel tile, after the
//    first time from L2 (the channel tiles of a bin tile are neighbours in
//    the walk).  No k needs a round trip of its own, for any K;
//  - a warp whose rows or channels all lie in a tile's padding skips the
//    multiplies; the host picks the tile that reads the operands the fewest
//    times, then pads the least, then keeps the most warps resident.
//
// Which shapes each takes (k1_plan): the blocked design for K > 16, and
// where the lane plan would read again an operand of more elements than
// half of L2 holds in complex64 (q for each chunk of rows, p for each
// channel group).  The sweep (scripts/torch_k1k2_bench.py --sweep, NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md section 6) timed both designs at every
// launch of the 256^2 b8, 1024^2 b4, M = 50 1024^2 b16 and M = 10 1024^2
// b64 steps: the lane design ahead (in 0.39-0.98 of the blocked one's
// time) wherever the operand it re-reads has under 1.3M elements — every
// 256^2 b8 launch — the two within -25 to +16 % from 1.3M to 1.6M (the
// 1024^2 b4 launches, which stay on the lane design), and the blocked
// design ahead (by 5 % to 10x) from 3.9M elements on: every launch of
// both benchmark cells.  A step's 17 K1 launches at
// M = 50 1024^2 b16 fell from 32.14 ms to 5.74 ms (bound 4.00), at M = 10
// 1024^2 b64 from 5.92 to 2.65 ms (bound 2.17).
//
// ptxas (-Xptxas=-v, the build log of _kernels.py): the lane design's 36
// instantiations take 32-168 registers, one spilling (complex64 at K = 9:
// 12 bytes at 64 registers, on no shape of the reference net); the blocked
// design's 8 (two operand types x two copy widths x kc 4, 8) 91-96
// registers under its launch bound of 640 threads, none spilling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;        // bins (vectors of bins) a warp covers
constexpr int kMaxGroupWarps = 8; // channel warps a block (blockDim.y)
// the blocked design: a thread's tile of rows a x output channels b, the
// warps of a block, and the shared memory a block may take (H100)
constexpr int kRA = 4;
constexpr int kRB = 5;
constexpr int kMaxBlockWarps = 20;
constexpr int kMaxSmem = 232448;

// A vector of V complex operand elements, loaded in one instruction.
template <typename T, int V> struct Vec;
template <> struct Vec<float2, 1> { using raw = float2; };
template <> struct Vec<float2, 2> { using raw = float4; };
// bf16 pairs travel as their 32 bits: (re, im) in the low and high half
template <> struct Vec<__nv_bfloat162, 1> { using raw = unsigned; };
template <> struct Vec<__nv_bfloat162, 4> { using raw = uint4; };

template <typename T, int V>
__device__ __forceinline__ typename Vec<T, V>::raw load(const T* ptr) {
  using R = typename Vec<T, V>::raw;
  return __ldg(reinterpret_cast<const R*>(ptr));
}

// element i of a loaded vector, widened to float2
__device__ __forceinline__ float2 elem(const float2& v, int) { return v; }
__device__ __forceinline__ float2 elem(const float4& v, int i) {
  return i == 0 ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
}
__device__ __forceinline__ float2 elem(const unsigned& v, int) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 elem(const uint4& v, int i) {
  return elem(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w, 0);
}

// conjugate every element of a loaded vector in place: flip the sign of
// each imaginary part (exact, as multiplying by -1 is)
__device__ __forceinline__ void conj(float2& v) { v.y = -v.y; }
__device__ __forceinline__ void conj(float4& v) { v.y = -v.y; v.w = -v.w; }
__device__ __forceinline__ void conj(unsigned& v) { v ^= 0x80000000u; }
__device__ __forceinline__ void conj(uint4& v) {
  v.x ^= 0x80000000u; v.y ^= 0x80000000u;
  v.z ^= 0x80000000u; v.w ^= 0x80000000u;
}

// acc += x * c over complex float32
__device__ __forceinline__ void cmac(float2& acc, float2 x, float2 c) {
  acc.x = fmaf(x.x, c.x, acc.x);
  acc.x = fmaf(-x.y, c.y, acc.x);
  acc.y = fmaf(x.x, c.y, acc.y);
  acc.y = fmaf(x.y, c.x, acc.y);
}

template <int V>
__device__ __forceinline__ void store(float2* o, const float2 (&v)[V]) {
  if constexpr (V == 1) {
    *o = v[0];
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      *reinterpret_cast<float4*>(o + e) =
          make_float4(v[e].x, v[e].y, v[e + 1].x, v[e + 1].y);
    }
  }
}

// One thread: output channel b, bins [w, w + V), rows a in
// [blockIdx.z * rows, +rows).  KT > 0: K == KT, unrolled, q held in
// registers; KT == 0: any K, a run-time loop that reads q again each row.
template <typename T, int V, int KT>
__global__ void __launch_bounds__(kLanes * kMaxGroupWarps)
cmul_contract_kernel(const T* __restrict__ p, const T* __restrict__ q,
                     float2* __restrict__ out, int A, int K, int B,
                     long long W, long long psa, long long psk,
                     long long qsk, long long qsb, int conj_q, float p_scale,
                     const float* __restrict__ bias, float bias_scale,
                     int rows) {
  using R = typename Vec<T, V>::raw;
  const long long w = ((long long)blockIdx.x * kLanes + threadIdx.x) * V;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  if (w >= W || b >= B) return;     // W % V == 0: a vector is all in or out
  const int a0 = blockIdx.z * rows;
  const int a1 = min(A, a0 + rows);
  const float dc = (bias != nullptr && w == 0) ? bias[b] * bias_scale : 0.f;
  const T* qb = q + (long long)b * qsb + w;
  float2* ob = out + (long long)b * W + w;

  if constexpr (KT > 0) {
    R qv[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) qv[k] = load<T, V>(qb + (long long)k * qsk);
    if (conj_q) {
#pragma unroll
      for (int k = 0; k < KT; ++k) conj(qv[k]);
    }
    for (int a = a0; a < a1; ++a) {
      const T* pa = p + (long long)a * psa + w;
      R pv[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) pv[k] = load<T, V>(pa + (long long)k * psk);
      float2 acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          cmac(acc[e], elem(pv[k], e), elem(qv[k], e));
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e].x *= p_scale;
        acc[e].y *= p_scale;
      }
      acc[0].x += dc;
      store<V>(ob + (long long)a * B * W, acc);
    }
  } else {
    for (int a = a0; a < a1; ++a) {
      const T* pa = p + (long long)a * psa + w;
      float2 acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = make_float2(0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const R pv = load<T, V>(pa + (long long)k * psk);
        R qv = load<T, V>(qb + (long long)k * qsk);
        if (conj_q) conj(qv);
#pragma unroll
        for (int e = 0; e < V; ++e) cmac(acc[e], elem(pv, e), elem(qv, e));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e].x *= p_scale;
        acc[e].y *= p_scale;
      }
      acc[0].x += dc;
      store<V>(ob + (long long)a * B * W, acc);
    }
  }
}

template <typename T, int V, int KT>
void launch(const T* p, const T* q, float2* out, int A, int K, int B,
            long long W, long long psa, long long psk, long long qsk,
            long long qsb, int conj_q, float p_scale, const float* bias,
            float bias_scale, int group, int rows, cudaStream_t stream) {
  const long long tile = (long long)kLanes * V;
  const dim3 grid((unsigned)((W + tile - 1) / tile),
                  (unsigned)((B + group - 1) / group),
                  (unsigned)((A + rows - 1) / rows));
  const dim3 block(kLanes, group);
  cmul_contract_kernel<T, V, KT><<<grid, block, 0, stream>>>(
      p, q, out, A, K, B, W, psa, psk, qsk, qsb, conj_q, p_scale, bias,
      bias_scale, rows);
}

// vec: bins a lane (1, or the 16-byte vector: 2 float2, 4 bf16 pairs);
// group: channel warps a block; rows: rows a a thread — the host's plan
// (spectral_kernels.k1_plan), checked here against what the kernel needs.
template <typename T, int VV>
int dispatch(const void* p, const void* q, void* out, int A, int K, int B,
             long long W, long long psa, long long psk, long long qsk,
             long long qsb, int conj_q, float p_scale, const void* bias,
             float bias_scale, int vec, int group, int rows, void* stream) {
  auto* pp = static_cast<const T*>(p);
  auto* qq = static_cast<const T*>(q);
  auto* oo = static_cast<float2*>(out);
  auto* bb = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (A < 1 || K < 1 || B < 1 || W < 1 || group < 1 ||
      group > kMaxGroupWarps || rows < 1 || (A + rows - 1) / rows > 65535 ||
      (B + group - 1) / group > 65535 || (vec != 1 && vec != VV)) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == VV) {
    const auto misaligned = [](const void* v) {
      return reinterpret_cast<std::uintptr_t>(v) % 16 != 0;
    };
    if (W % VV || psa % VV || psk % VV || qsk % VV || qsb % VV ||
        misaligned(p) || misaligned(q) || misaligned(out)) {
      return (int)cudaErrorMisalignedAddress;
    }
#define SAE_K1_CASE(N)                                                     \
  case N:                                                                  \
    launch<T, VV, N>(pp, qq, oo, A, K, B, W, psa, psk, qsk, qsb, conj_q,   \
                     p_scale, bb, bias_scale, group, rows, st);            \
    break;
    switch (K) {
      SAE_K1_CASE(1) SAE_K1_CASE(2) SAE_K1_CASE(3) SAE_K1_CASE(4)
      SAE_K1_CASE(5) SAE_K1_CASE(6) SAE_K1_CASE(7) SAE_K1_CASE(8)
      SAE_K1_CASE(9) SAE_K1_CASE(10) SAE_K1_CASE(11) SAE_K1_CASE(12)
      SAE_K1_CASE(13) SAE_K1_CASE(14) SAE_K1_CASE(15) SAE_K1_CASE(16)
      default:   // K > 16: the run-time loop (the plan takes the blocked
                 // design there; this is its yardstick)
        launch<T, VV, 0>(pp, qq, oo, A, K, B, W, psa, psk, qsk, qsb, conj_q,
                         p_scale, bb, bias_scale, group, rows, st);
    }
#undef SAE_K1_CASE
  } else {
    launch<T, 1, 0>(pp, qq, oo, A, K, B, W, psa, psk, qsk, qsb, conj_q,
                    p_scale, bb, bias_scale, group, rows, st);
  }
  return (int)cudaGetLastError();
}

// ---- the blocked design ---------------------------------------------------

// Asynchronous copy of BYTES (16, 8 or 4) into shared memory; zeros where
// the element is not live (src is then not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(live ? 16 : 0));
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(live ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(live ? 4 : 0));
  }
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one staged element, widened to float2
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// One stage's k (kn of KC) into a thread's sums: ps at its first row's
// element of k = 0, qs at its first channel's, rows of kLanes bins, KC
// rows of k per row a or channel b.  The same cmac chain over k as the
// lane design.
template <bool CONJ, int KC, typename T>
__device__ __forceinline__ void mac_stage(float2 (&acc)[kRA][kRB],
                                          const T* ps, const T* qs,
                                          int kn) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k < kn) {
      float2 qv[kRB];
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        qv[j] = widen(qs[(j * KC + k) * kLanes]);
        if (CONJ) qv[j].y = -qv[j].y;
      }
#pragma unroll
      for (int i = 0; i < kRA; ++i) {
        const float2 pv = widen(ps[(i * KC + k) * kLanes]);
#pragma unroll
        for (int j = 0; j < kRB; ++j) cmac(acc[i][j], pv, qv[j]);
      }
    }
  }
}

// A block walks its items (tiles of kLanes bins x ta rows a x tb channels
// b: item blockIdx.x, then every gridDim.x-th) and each item's k in
// stages of KC, through a ring of `stages` buffers in shared memory that
// cp.async fills stages - 1 stages ahead, across items.  A stage holds p
// as [ta][KC][kLanes] and q as [tb][KC][kLanes]; warp y owns rows
// (y % na) * kRA + [0, kRA) and channels (y / na) * kRB + [0, kRB) of the
// tile, a lane one bin.  V: elements a copy (a 16-byte vector, or 1).
template <typename T, int V, int KC>
__global__ void __launch_bounds__(kLanes * kMaxBlockWarps, 1)
cmul_contract_kernel_blocked(const T* __restrict__ p,
                             const T* __restrict__ q,
                             float2* __restrict__ out, int A, int K, int B,
                             long long W, long long psa, long long psk,
                             long long qsk, long long qsb, int conj_q,
                             float p_scale, const float* __restrict__ bias,
                             float bias_scale, int na, int nb, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kPer = kLanes / V;          // copies a row of the tile
  constexpr int kBytes = V * sizeof(T);     // bytes a copy
  const int ta = na * kRA, tb = nb * kRB;
  const int a_tiles = (A + ta - 1) / ta, b_tiles = (B + tb - 1) / tb;
  const int items = (int)((W + kLanes - 1) / kLanes) * a_tiles * b_tiles;
  const int chunks = (K + KC - 1) / KC;
  const int stage = (ta + tb) * KC * kLanes;   // elements a buffer
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kLanes + lane;
  const int row_step = blockDim.y * kLanes / kPer;
  const int a_sub = threadIdx.y % na, b_sub = threadIdx.y / na;

  // item -> its tile's first bin, row a and channel b
  const auto tile_of = [&](int it, long long& w0, int& a0, int& b0) {
    b0 = it % b_tiles * tb;
    it /= b_tiles;
    a0 = it % a_tiles * ta;
    w0 = (long long)(it / a_tiles) * kLanes;
  };

  int in_item = blockIdx.x, in_chunk = 0, in_buf = 0;
  long long w0 = 0;   // the issued item's tile
  int a0 = 0, b0 = 0;
  if (in_item < items) tile_of(in_item, w0, a0, b0);
  // the next stage's copies (none past the block's last item), as one group
  const auto issue = [&]() {
    if (in_item < items) {
      const int k0 = in_chunk * KC;
      T* const buf = smem + in_buf * stage;
      const int j = tid % kPer * V;
      const long long w = w0 + j;
      const bool w_in = w < W;
      for (int r = tid / kPer; r < (ta + tb) * KC; r += row_step) {
        const int k = k0 + r % KC;
        const T* src;
        bool live;
        if (r < ta * KC) {
          const int a = a0 + r / KC;
          live = w_in && a < A && k < K;
          src = p + a * psa + k * psk + w;
        } else {
          const int b = b0 + (r - ta * KC) / KC;
          live = w_in && b < B && k < K;
          src = q + k * qsk + b * qsb + w;
        }
        copy_async<kBytes>(buf + r * kLanes + j, live ? src : p, live);
      }
      if (++in_chunk == chunks) {
        in_chunk = 0;
        in_item += gridDim.x;
        if (in_item < items) tile_of(in_item, w0, a0, b0);
      }
    }
    commit_copies();
    if (++in_buf == stages) in_buf = 0;
  };

  float2 acc[kRA][kRB];
#pragma unroll
  for (int i = 0; i < kRA; ++i) {
#pragma unroll
    for (int j = 0; j < kRB; ++j) acc[i][j] = make_float2(0.f, 0.f);
  }
  for (int s = 0; s + 1 < stages; ++s) issue();
  int it = blockIdx.x, chunk = 0, buf = 0;
  long long cw0 = 0;   // the computed item's tile
  int ca0 = 0, cb0 = 0;
  if (it < items) tile_of(it, cw0, ca0, cb0);
  while (it < items) {
    // a warp whose rows or channels all lie past A or B (a tile's padding)
    // computes nothing
    const bool busy = ca0 + a_sub * kRA < A && cb0 + b_sub * kRB < B;
    // this stage's copies landed (each thread's), then seen by all; and
    // every warp is done with the buffer the next issue refills
    if (stages == 3) {
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    issue();
    const T* ps = smem + buf * stage + a_sub * kRA * KC * kLanes + lane;
    const T* qs = smem + buf * stage + (ta + b_sub * kRB) * KC * kLanes +
                  lane;
    const int kn = min(KC, K - chunk * KC);
    if (busy && conj_q) {
      mac_stage<true, KC>(acc, ps, qs, kn);
    } else if (busy) {
      mac_stage<false, KC>(acc, ps, qs, kn);
    }
    if (++buf == stages) buf = 0;
    if (++chunk < chunks) continue;
    // the scale and the DC bias as the lane design's compiled epilogue
    // takes them: one fused multiply-add, x * p_scale + dc (dc 0 off the DC
    // bin, where it equals the product: no sum is -0)
    const long long w = cw0 + lane;
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      const int b = cb0 + b_sub * kRB + j;
      const float dc = (bias != nullptr && w == 0 && b < B)
                           ? bias[b] * bias_scale : 0.f;
#pragma unroll
      for (int i = 0; i < kRA; ++i) {
        const int a = ca0 + a_sub * kRA + i;
        if (w < W && a < A && b < B) {
          out[((long long)a * B + b) * W + w] =
              make_float2(__fmaf_rn(acc[i][j].x, p_scale, dc),
                          __fmul_rn(acc[i][j].y, p_scale));
        }
        acc[i][j] = make_float2(0.f, 0.f);
      }
    }
    chunk = 0;
    it += gridDim.x;
    if (it < items) tile_of(it, cw0, ca0, cb0);
  }
}

// The blocked design's shared memory: `stages` buffers of p's and q's
// tiles for KC values of k.
template <typename T>
long long blocked_smem(int na, int nb, int kc, int stages) {
  return (long long)stages * (na * kRA + nb * kRB) * kc * kLanes * sizeof(T);
}

template <typename T, int V, int KC>
int launch_blocked(const T* p, const T* q, float2* out, int A, int K, int B,
                   long long W, long long psa, long long psk, long long qsk,
                   long long qsb, int conj_q, float p_scale,
                   const float* bias, float bias_scale, int na, int nb,
                   int stages, int grid, int smem, cudaStream_t stream) {
  const auto kernel = cmul_contract_kernel_blocked<T, V, KC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, dim3(kLanes, na * nb), smem, stream>>>(
      p, q, out, A, K, B, W, psa, psk, qsk, qsb, conj_q, p_scale, bias,
      bias_scale, na, nb, stages);
  return (int)cudaGetLastError();
}

// na, nb: warps along the rows a and the channels b (a block's tile is
// na * kRA rows by nb * kRB channels by kLanes bins); kc: k a stage (4 or
// 8); stages: the ring's buffers (2 or 3); grid: blocks; smem: the
// ring's bytes — the host's plan (spectral_kernels.k1_plan), checked here.
template <typename T, int VV>
int dispatch_blocked(const void* p, const void* q, void* out, int A, int K,
                     int B, long long W, long long psa, long long psk,
                     long long qsk, long long qsb, int conj_q, float p_scale,
                     const void* bias, float bias_scale, int vec, int na,
                     int nb, int kc, int stages, int grid, int smem,
                     void* stream) {
  auto* pp = static_cast<const T*>(p);
  auto* qq = static_cast<const T*>(q);
  auto* oo = static_cast<float2*>(out);
  auto* bb = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (A < 1 || K < 1 || B < 1 || W < 1 || na < 1 || nb < 1 ||
      na * nb > kMaxBlockWarps || (kc != 4 && kc != 8) ||
      (stages != 2 && stages != 3) || grid < 1 ||
      (vec != 1 && vec != VV)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long items = (W + kLanes - 1) / kLanes *
                          ((A + na * kRA - 1) / (na * kRA)) *
                          ((B + nb * kRB - 1) / (nb * kRB));
  if (items > 0x7fffffffLL ||
      blocked_smem<T>(na, nb, kc, stages) != smem || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == VV) {
    const auto misaligned = [](const void* v) {
      return reinterpret_cast<std::uintptr_t>(v) % 16 != 0;
    };
    if (W % VV || psa % VV || psk % VV || qsk % VV || qsb % VV ||
        misaligned(p) || misaligned(q)) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
#define SAE_K1B_LAUNCH(VEC, KC)                                            \
  return launch_blocked<T, VEC, KC>(pp, qq, oo, A, K, B, W, psa, psk, qsk,  \
                                    qsb, conj_q, p_scale, bb, bias_scale,  \
                                    na, nb, stages, grid, smem, st)
  if (vec == VV) {
    if (kc == 4) SAE_K1B_LAUNCH(VV, 4);
    SAE_K1B_LAUNCH(VV, 8);
  }
  if (kc == 4) SAE_K1B_LAUNCH(1, 4);
  SAE_K1B_LAUNCH(1, 8);
#undef SAE_K1B_LAUNCH
}

}  // namespace

// p: element (a, k, w) at p + a*p_stride_a + k*p_stride_k + w; q: element
// (k, b, w) at q + k*q_stride_k + b*q_stride_b + w (strides in complex
// elements).  conj_q != 0 reads conj(q).  out: [A, B, W] complex64,
// contiguous.  bias: [B] float32 or NULL.  vec, group, rows: the launch
// plan (spectral_kernels.k1_plan): bins a lane (1 or 2), channel warps a
// block (1..8), rows a a thread.
extern "C" int cmul_contract_launch(const void* p, const void* q, void* out,
                                    int A, int K, int B, long long W,
                                    long long p_stride_a,
                                    long long p_stride_k,
                                    long long q_stride_k,
                                    long long q_stride_b, int conj_q,
                                    float p_scale, const void* bias,
                                    float bias_scale, int vec, int group,
                                    int rows, void* stream) {
  return dispatch<float2, 2>(p, q, out, A, K, B, W, p_stride_a, p_stride_k,
                             q_stride_k, q_stride_b, conj_q, p_scale, bias,
                             bias_scale, vec, group, rows, stream);
}

// The same with bf16 operands: p and q hold interleaved (re, im) bf16
// pairs, 4 bytes a complex element; strides in those elements; vec 1 or 4.
extern "C" int cmul_contract_bf16_launch(
    const void* p, const void* q, void* out, int A, int K, int B,
    long long W, long long p_stride_a, long long p_stride_k,
    long long q_stride_k, long long q_stride_b, int conj_q, float p_scale,
    const void* bias, float bias_scale, int vec, int group, int rows,
    void* stream) {
  return dispatch<__nv_bfloat162, 4>(p, q, out, A, K, B, W, p_stride_a,
                                     p_stride_k, q_stride_k, q_stride_b,
                                     conj_q, p_scale, bias, bias_scale, vec,
                                     group, rows, stream);
}

// The blocked design (K > 16, or rows that the lane design would read q
// for more than once from memory): the same operands and output as
// cmul_contract_launch; vec 1 or 2; na, nb, kc, stages, grid, smem: its
// plan (spectral_kernels.k1_plan).
extern "C" int cmul_contract_blocked_launch(
    const void* p, const void* q, void* out, int A, int K, int B,
    long long W, long long p_stride_a, long long p_stride_k,
    long long q_stride_k, long long q_stride_b, int conj_q, float p_scale,
    const void* bias, float bias_scale, int vec, int na, int nb, int kc,
    int stages, int grid, int smem, void* stream) {
  return dispatch_blocked<float2, 2>(
      p, q, out, A, K, B, W, p_stride_a, p_stride_k, q_stride_k, q_stride_b,
      conj_q, p_scale, bias, bias_scale, vec, na, nb, kc, stages, grid, smem,
      stream);
}

// The blocked design with bf16 operands; vec 1 or 4.
extern "C" int cmul_contract_blocked_bf16_launch(
    const void* p, const void* q, void* out, int A, int K, int B,
    long long W, long long p_stride_a, long long p_stride_k,
    long long q_stride_k, long long q_stride_b, int conj_q, float p_scale,
    const void* bias, float bias_scale, int vec, int na, int nb, int kc,
    int stages, int grid, int smem, void* stream) {
  return dispatch_blocked<__nv_bfloat162, 4>(
      p, q, out, A, K, B, W, p_stride_a, p_stride_k, q_stride_k, q_stride_b,
      conj_q, p_scale, bias, bias_scale, vec, na, nb, kc, stages, grid, smem,
      stream);
}
