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
// What bounds it on Hopper: bytes — under one flop per byte at K, B <= 10 —
// but at the widths of the reference net a launch moves 1-9 MB (0.3-2.7 us
// at 3.35 TB/s), so its real floor is the launch plus one round trip to
// memory.  The first port (one thread a bin holding all B accumulators, a
// run-time loop over K, the batch row on gridDim.y) sat on a flat 13-16 us
// floor at every 10-wide shape: ~10 serial rounds of ~10 loads each, on
// 24-72 blocks at the 32^2-64^2 stages.
//
// What this design does about it:
//  - one thread holds one (b, w-vector) column: the output channel b is on
//    threadIdx.y, the bins on threadIdx.x (32 lanes, neighbouring lanes on
//    neighbouring bins), so a thread's serial work is one row's K products,
//    not B of them;
//  - K is a template parameter (1..16; a run-time loop above), so a
//    thread's K loads of q and K loads of p are all issued before its first
//    FMA: one round trip to memory, not K;
//  - 16-byte loads: two adjacent bins of float2, four of __nv_bfloat162,
//    where W, the strides and the pointers allow it (else one bin a lane);
//  - q[., b, w] for all k stays in registers while the thread walks its
//    rows a (conjugated once, by a sign flip, after the load), so q is read
//    once per chunk of rows; the p vectors of a tile are shared by the
//    block's channel warps through L1 (ld.global.nc);
//  - the grid is (w tiles, channel groups, chunks of rows a), sized by the
//    host from (A, K, B, W) alone (spectral_kernels.k1_plan): the rows in
//    as few equal chunks (at most 4 rows a thread) as keep 384 threads an
//    SM, so a large grid reads q once for up to 4 rows and the 32^2 stage
//    takes one row a thread; equal channel groups of up to 8 warps a block
//    sharing each p vector, two or three warps once the grid has 8 blocks
//    an SM (the sweep of plans on the card found each faster there);
//  - one grid a launch, no atomics, no scratch: every output is one
//    thread's fixed-order sum over k, so the result repeats bit for bit.
//    The scale p_scale is applied to the sum (not to each p), within
//    float32 rounding of the plain version.
//
// What the A/B run found (scripts/torch_k1k2_bench.py, parent and this
// design in one call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md section
// 6): the 10-wide launches of a 256^2 b8 step fell from 13-16 us to
// 2.1-3.6 us, every launch of that step is faster than the parent's and
// than torch.einsum at its shape, and the step's 17 launches take 0.050 ms
// (was 0.213; bound 0.023), 0.052 with bf16 operands (was 0.218).  The
// 512^2 launches of a 1024^2 b4 step run at 1.3-1.5x their bytes bound;
// three of them with B = 3 stay 8-19 % slower than the parent's one thread
// a bin, which read each p element once from memory where three channel
// warps here share it through L1.  The plan's thresholds come from the
// script's --sweep of other plans at every launch shape.
//
// ptxas (-Xptxas=-v, the build log of _kernels.py): 36 instantiations,
// 32-168 registers; one spills, complex64 operands at K = 9 (12 bytes of
// spill stores and loads at 64 registers, far under the 255 a thread may
// take: a choice of ptxas, on no shape of the reference net, whose K are
// 3, 4, 8 and 10).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;        // bins (vectors of bins) a warp covers
constexpr int kMaxGroupWarps = 8; // channel warps a block (blockDim.y)

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
      default:   // K > 16: the run-time loop
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
