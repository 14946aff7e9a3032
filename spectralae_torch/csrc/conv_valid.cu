// K2 · conv_valid — valid 2-D correlation with few channels, float32.
//
// Replaces: spectralae/ops/pallas_conv.py · conv_valid_pallas (body
//   _conv_kernel), the coordinate-domain conv of the serving forward.
//
// Computes
//   out[b, m, i, j] = sum_{d, k, l} w[m, d, k, l] * xpad[b, d, i+k, j+l]
// for xpad [B, D, H+nk-1, W+nl-1] and w [M, D, nk, nl], both contiguous
// float32; out is [B, M, H, W].  The caller pads and flips the taps
// (spectralae_torch/ops/coord.py), as in the JAX package.
//
// What bounds it on Hopper: at the reference widths (D, M <= 10, 5x5 taps)
// it does 2*M*D*nk*nl flops per output pixel (1500 at D=3, M=10) for
// (D + M) * 4 bytes of compulsory traffic, about 29 flops per byte: above
// the card's float32 balance of about 20 (67 TFLOP/s over 3.35 TB/s), so
// it is bound by the FMA pipes and by shared-memory reads — provided every
// staged input value is reused and never re-fetched from device memory.
//
// What the design does about it:
//  - one block per (batch, 8 x 32 output tile): the D input planes of the
//    tile plus the nk-1 / nl-1 halo are staged once in shared memory, and
//    all M*D*nk*nl weights next to them (every thread reads the same
//    weight at once, a broadcast);
//  - each thread owns one output pixel and up to 16 output channels in
//    registers; the channel loop is innermost, as in the TPU kernel, so
//    each staged input value feeds every accumulator; more than 16
//    channels run as further groups over the same staged tile;
//  - the ragged edge is masked (no padding of the input to a tile
//    multiple), and neighbouring threads take neighbouring j, so the
//    staging loads and the output stores coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxGroup = 16;

template <int MB, bool EXACT>
__global__ void __launch_bounds__(kThreads)
conv_valid_kernel(const float* __restrict__ xpad,
                  const float* __restrict__ w,
                  float* __restrict__ out,
                  int D, int Hp, int Wp, int M, int nk, int nl) {
  extern __shared__ float smem[];
  const int H = Hp - nk + 1;
  const int Wo = Wp - nl + 1;
  const int rows = kTileH + nk - 1;     // staged tile with its halo
  const int cols = kTileW + nl - 1;
  const int plane = rows * cols;
  const int taps = nk * nl;
  float* s_x = smem;                    // [D][rows][cols]
  float* s_w = smem + D * plane;        // [M][D][nk][nl]

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  const float* xb = xpad + (long long)b * D * Hp * Wp;
  for (int e = tid; e < D * plane; e += kThreads) {
    const int d = e / plane;
    const int r = (e - d * plane) / cols;
    const int c = e - d * plane - r * cols;
    const int gi = i0 + r;
    const int gj = j0 + c;
    s_x[e] = (gi < Hp && gj < Wp)
                 ? xb[((long long)d * Hp + gi) * Wp + gj] : 0.f;
  }
  for (int e = tid; e < M * D * taps; e += kThreads) s_w[e] = w[e];
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= H || j >= Wo) return;   // no barrier follows

  for (int m0 = 0; m0 < M; m0 += MB) {
    float acc[MB];
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) acc[mm] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float* sx = s_x + d * plane + threadIdx.y * cols + threadIdx.x;
      const float* sw = s_w + (m0 * D + d) * taps;
      for (int k = 0; k < nk; ++k) {
        for (int l = 0; l < nl; ++l) {
          const float x = sx[k * cols + l];
          const float* wt = sw + k * nl + l;
#pragma unroll
          for (int mm = 0; mm < MB; ++mm) {
            if (EXACT || m0 + mm < M) acc[mm] += wt[mm * D * taps] * x;
          }
        }
      }
    }
    float* o = out + (((long long)b * M + m0) * H + i) * Wo + j;
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      if (EXACT || m0 + mm < M) o[(long long)mm * H * Wo] = acc[mm];
    }
  }
}

template <int MB, bool EXACT>
void launch(const float* xpad, const float* w, float* out, int B, int D,
            int Hp, int Wp, int M, int nk, int nl, cudaStream_t stream) {
  const int H = Hp - nk + 1;
  const int Wo = Wp - nl + 1;
  const size_t smem = sizeof(float) *
      ((size_t)D * (kTileH + nk - 1) * (kTileW + nl - 1) +
       (size_t)M * D * nk * nl);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(conv_valid_kernel<MB, EXACT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid((unsigned)((Wo + kTileW - 1) / kTileW),
                  (unsigned)((H + kTileH - 1) / kTileH), (unsigned)B);
  const dim3 block(kTileW, kTileH);
  conv_valid_kernel<MB, EXACT><<<grid, block, smem, stream>>>(
      xpad, w, out, D, Hp, Wp, M, nk, nl);
}

}  // namespace

// xpad: [B, D, Hp, Wp], w: [M, D, nk, nl], out: [B, M, Hp-nk+1, Wp-nl+1];
// all float32, contiguous.
extern "C" int conv_valid_launch(const void* xpad, const void* w, void* out,
                                 int B, int D, int Hp, int Wp, int M, int nk,
                                 int nl, void* stream) {
  auto* xx = static_cast<const float*>(xpad);
  auto* ww = static_cast<const float*>(w);
  auto* oo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define SAE_K2_CASE(N)                                                     \
  case N:                                                                  \
    launch<N, true>(xx, ww, oo, B, D, Hp, Wp, M, nk, nl, st);              \
    break;
  switch (M) {
    SAE_K2_CASE(1) SAE_K2_CASE(2) SAE_K2_CASE(3) SAE_K2_CASE(4)
    SAE_K2_CASE(5) SAE_K2_CASE(6) SAE_K2_CASE(7) SAE_K2_CASE(8)
    SAE_K2_CASE(9) SAE_K2_CASE(10) SAE_K2_CASE(11) SAE_K2_CASE(12)
    SAE_K2_CASE(13) SAE_K2_CASE(14) SAE_K2_CASE(15) SAE_K2_CASE(16)
    default:
      launch<kMaxGroup, false>(xx, ww, oo, B, D, Hp, Wp, M, nk, nl, st);
  }
#undef SAE_K2_CASE
  return (int)cudaGetLastError();
}
