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
// through p's strides with no transposed copy.
//
// What bounds it on Hopper: bytes.  Per bin it does 8*K*B flops on
// (A*K + K*B) complex loads and A*B complex stores, i.e. under one flop per
// byte at the reference widths (K, B <= 10) — far below the card's
// flop/byte balance, so only the traffic matters.
//
// What the design does about it:
//  - complex64 is read and written as interleaved float2 (8-byte loads of
//    torch.view_as_real's layout) — no split re/im copies, unlike the TPU
//    kernel whose VPU has no complex type;
//  - p and q are each addressed through two strides, so the kernel spectra
//    (forward) and the transposed cotangent (dC) are read in their own
//    layouts and no transposed copy is made;
//  - one thread owns one bin (neighbouring threads on neighbouring w, so
//    every load coalesces) and holds NB complex accumulators in registers,
//    looping over k.  The batch index a rides on gridDim.y: holding every
//    (a, b) pair per thread (8 x 10 complex = 160 floats) would spill;
//  - output channel groups of up to 16 ride on gridDim.z when B > 16.
//
// bf16 operands (B1's compute_dtype path, _conv_fwd_impl / _conv_bwd): the
// same kernel, instantiated for __nv_bfloat162 operands — each complex bin
// is 4 bytes, torch.view_as_real(z).to(torch.bfloat16) read as interleaved
// pairs — converted to float2 by __bfloat1622float2 at the load; products,
// sums, the scale, the conjugation and the complex64 output stay float32.
// A bf16 product is exact in float32, so against the plain version (which
// upcasts the same rounded operands) only the order of the sums differs.
// The float32 output is most of the traffic at the reference widths, so
// bf16 operands cut the bytes bound by only ~20 % (K=3, B=10, A=8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float2 load2(const float2* v) { return *v; }
__device__ __forceinline__ float2 load2(const __nv_bfloat162* v) {
  return __bfloat1622float2(*v);
}

template <typename T, int NB, bool EXACT>
__global__ void __launch_bounds__(kThreads)
cmul_contract_kernel(const T* __restrict__ p,
                     const T* __restrict__ q,
                     float2* __restrict__ out,
                     int K, int B, long long W,
                     long long psa, long long psk,
                     long long qsk, long long qsb, float q_im,
                     float p_scale,
                     const float* __restrict__ bias, float bias_scale) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int a = blockIdx.y;
  const int b0 = blockIdx.z * NB;

  float2 acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = make_float2(0.f, 0.f);

  const T* pa = p + (long long)a * psa + w;
  const T* qb = q + (long long)b0 * qsb + w;
  for (int k = 0; k < K; ++k) {
    float2 x = load2(pa + (long long)k * psk);
    x.x *= p_scale;
    x.y *= p_scale;
    const T* qk = qb + (long long)k * qsk;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (EXACT || b0 + j < B) {
        float2 c = load2(qk + (long long)j * qsb);
        c.y *= q_im;                      // -1 conjugates q
        acc[j].x += x.x * c.x - x.y * c.y;
        acc[j].y += x.x * c.y + x.y * c.x;
      }
    }
  }

  float2* o = out + ((long long)a * B + b0) * W + w;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (EXACT || b0 + j < B) {
      float2 v = acc[j];
      if (bias != nullptr && w == 0) v.x += bias[b0 + j] * bias_scale;
      o[(long long)j * W] = v;
    }
  }
}

template <typename T, int NB, bool EXACT>
void launch(const T* p, const T* q, float2* out, int A, int K,
            int B, long long W, long long psa, long long psk, long long qsk,
            long long qsb, float q_im, float p_scale, const float* bias,
            float bias_scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)A,
                  (unsigned)((B + NB - 1) / NB));
  cmul_contract_kernel<T, NB, EXACT><<<grid, kThreads, 0, stream>>>(
      p, q, out, K, B, W, psa, psk, qsk, qsb, q_im, p_scale, bias,
      bias_scale);
}

template <typename T>
int dispatch(const void* p, const void* q, void* out, int A, int K, int B,
             long long W, long long p_stride_a, long long p_stride_k,
             long long q_stride_k, long long q_stride_b, int conj_q,
             float p_scale, const void* bias, float bias_scale,
             void* stream) {
  auto* pp = static_cast<const T*>(p);
  auto* qq = static_cast<const T*>(q);
  auto* oo = static_cast<float2*>(out);
  auto* bb = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  const float q_im = conj_q ? -1.f : 1.f;
#define SAE_K1_CASE(N)                                                     \
  case N:                                                                  \
    launch<T, N, true>(pp, qq, oo, A, K, B, W, p_stride_a, p_stride_k,     \
                       q_stride_k, q_stride_b, q_im, p_scale, bb,          \
                       bias_scale, st);                                    \
    break;
  switch (B) {
    SAE_K1_CASE(1) SAE_K1_CASE(2) SAE_K1_CASE(3) SAE_K1_CASE(4)
    SAE_K1_CASE(5) SAE_K1_CASE(6) SAE_K1_CASE(7) SAE_K1_CASE(8)
    SAE_K1_CASE(9) SAE_K1_CASE(10) SAE_K1_CASE(11) SAE_K1_CASE(12)
    SAE_K1_CASE(13) SAE_K1_CASE(14) SAE_K1_CASE(15) SAE_K1_CASE(16)
    default:
      launch<T, kMaxGroup, false>(pp, qq, oo, A, K, B, W, p_stride_a,
                                  p_stride_k, q_stride_k, q_stride_b, q_im,
                                  p_scale, bb, bias_scale, st);
  }
#undef SAE_K1_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// p: element (a, k, w) at p + a*p_stride_a + k*p_stride_k + w; q: element
// (k, b, w) at q + k*q_stride_k + b*q_stride_b + w (strides in complex
// elements).  conj_q != 0 reads conj(q).  out: [A, B, W] complex64,
// contiguous.  bias: [B] float32 or NULL.
extern "C" int cmul_contract_launch(const void* p, const void* q, void* out,
                                    int A, int K, int B, long long W,
                                    long long p_stride_a,
                                    long long p_stride_k,
                                    long long q_stride_k,
                                    long long q_stride_b, int conj_q,
                                    float p_scale, const void* bias,
                                    float bias_scale, void* stream) {
  return dispatch<float2>(p, q, out, A, K, B, W, p_stride_a, p_stride_k,
                          q_stride_k, q_stride_b, conj_q, p_scale, bias,
                          bias_scale, stream);
}

// The same with bf16 operands: p and q hold interleaved (re, im) bf16
// pairs, 4 bytes a complex element; strides in those elements.
extern "C" int cmul_contract_bf16_launch(
    const void* p, const void* q, void* out, int A, int K, int B,
    long long W, long long p_stride_a, long long p_stride_k,
    long long q_stride_k, long long q_stride_b, int conj_q, float p_scale,
    const void* bias, float bias_scale, void* stream) {
  return dispatch<__nv_bfloat162>(p, q, out, A, K, B, W, p_stride_a,
                                  p_stride_k, q_stride_k, q_stride_b, conj_q,
                                  p_scale, bias, bias_scale, stream);
}
