// K2 · conv_valid — valid 2-D correlation with few channels, float32.
//
// Replaces: spectralae/ops/pallas_conv.py · conv_valid_pallas (body
//   _conv_kernel), the coordinate-domain conv of the serving forward and of
//   every coord train step (spectralae_torch/ops/coord.py · conv2d).
//
// Computes
//   out[b, m, i, j] = sum_{d, k, l} w[m, d, k, l] * xpad[b, d, i+k, j+l]
// for xpad [B, D, H+nk-1, W+nl-1] and w [M, D, nk, nl], both contiguous
// float32; out is [B, M, H, W].  The caller pads and flips the taps
// (spectralae_torch/ops/coord.py), as in the JAX package.
//
// What bounds it on Hopper: operations.  At the reference widths (D, M <=
// 10, 5x5 taps) it does 2*M*D*nk*nl flops per output pixel (1500 at D=3,
// M=10) for (D + M) * 4 bytes of compulsory traffic, about 29 flops per
// byte, above the card's float32 balance of about 20 (67 TFLOP/s over
// 3.35 TB/s) — provided every staged value is reused from registers.  The
// first port (one pixel a thread: per tap one shared load of x and one of
// each weight for MB FMAs) read shared memory about once per FMA, on a
// card whose shared-memory pipe serves a warp about a quarter as often as
// its FMA pipes: 7.7-12x over the bound at the routed shapes, and a
// ~28 us floor at 32^2-64^2 on 32-64 blocks of 2,500 serial FMAs a thread.
//
// What this design does about it:
//  - register blocking: a thread computes R = 4 adjacent output pixels
//    along j for a group of MB output channels (4*MB accumulators).  For
//    each input row (d, k) it reads its R + nl - 1 inputs once, as two
//    16-byte shared loads, into registers, and for each tap l the MB
//    weights as 16-byte broadcasts ([d][k][l][m] in shared memory, m padded
//    to 4), so every shared load feeds 4-40 FMAs (200 FMAs a row for 23
//    shared wavefronts at MB = 10, nl = 5);
//  - nl = 3 and 5 are template cases (the window stays in registers); any
//    other tap width runs the same tiling with the window read from
//    shared memory;
//  - the tile (8 rows x 4*TX columns, TX = 8 or 16 threads along j,
//    whichever pads the width less) and the channel group MB are chosen by
//    the host from the shape alone (coord_kernels.k2_plan): all channels
//    in one group while the grid has 6 warps an SM, else the largest equal
//    groups that reach it (or two channels a thread), so the 32^2-64^2
//    stages launch 160-320 blocks, not 32-64;
//  - the input tile, its halo and the group's weights are staged with
//    cp.async (16-byte copies where the rows allow: Wp % 4 == 0 and an
//    aligned pointer; else 4-byte ones), the ragged edge zero-filled by
//    the copy: a thread issues its ~16 copies back to back and waits once,
//    where 16 dependent load-store rounds were 16 trips to memory (D = 10);
//    outputs are stored 16 bytes at a time where W allows;
//  - float32 throughout: no TF32, no tensor cores; every output is one
//    thread's fixed-order sum over (d, k, l), so it repeats bit for bit.
//
// What the A/B run found (scripts/torch_k1k2_bench.py, parent and this
// design in one call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md section
// 6): the two routed launches of a 256^2 b8 coord step take 0.021 ms
// (was 0.056; bound 0.006), those of a 1024^2 b4 step 0.108 (was 0.383;
// bound 0.047); the 32^2 launches 8.7-9.9 us (was 28), 64^2 11.9-16.1 us.
// Every launch measured is faster than the parent's and than cuDNN's.
// cp.async staging took the 10 -> 3 stage at 512^2 from 0.076 to 0.062
// ms; a variant with two output rows a thread (each weight read once for
// 8 pixels) was slower there and was dropped.
//
// ptxas (-Xptxas=-v, the build log of _kernels.py): 48 instantiations,
// 32-128 registers; one spills, MB = 15 at 5 taps (24 bytes of spill
// stores and loads at 96 registers, under the 255 a thread may take: a
// choice of ptxas, on no shape of the reference net, whose groups are 1,
// 2, 3, 5 and 10).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 4;             // output pixels a thread along j
constexpr int kMaxThreads = 128;  // 16 x 8

// Asynchronous copies into shared memory (cp.async): a thread issues all
// of its staging copies back to back and waits once, instead of one round
// trip to memory per load.  The copy zero-fills the bytes past src_bytes.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's tile: s_x [D][rows][cw] (cw a multiple of 4, so every row
// starts on 16 bytes), then s_w [D][nk][nl][MP].
template <int MB, int NL>
__global__ void __launch_bounds__(kMaxThreads)
conv_valid_kernel(const float* __restrict__ xpad,
                  const float* __restrict__ w, float* __restrict__ out,
                  int D, int Hp, int Wp, int M, int nk, int nl_rt,
                  int groups, int cw, int vec) {
  constexpr int MP = (MB + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nl = NL > 0 ? NL : nl_rt;
  const int TX = blockDim.x, TY = blockDim.y;
  const int H = Hp - nk + 1;
  const int Wo = Wp - nl + 1;
  const int rows = TY + nk - 1;
  const int plane = rows * cw;
  float* s_x = smem;
  float* s_w = smem + D * plane;

  const int b = blockIdx.z / groups;
  const int m0 = (blockIdx.z - b * groups) * MB;
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX * kR;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthr = TX * TY;

  // stage the input tile with its halo, zero outside the image: 16-byte
  // copies where the rows allow, else one float a copy
  const float* xb = xpad + (long long)b * D * Hp * Wp;
  const int q4 = cw / 4;
  for (int e = tid; e < D * rows * q4; e += nthr) {
    const int dr = e / q4;              // d * rows + r
    const int c = (e - dr * q4) * 4;
    const int d = dr / rows;
    const int gi = i0 + dr - d * rows;
    const int gj = j0 + c;
    // the floats of this slot inside the image (0 past its edges)
    const int n = gi < Hp ? max(0, min(4, Wp - gj)) : 0;
    const float* src = n ? xb + ((long long)d * Hp + gi) * Wp + gj : xpad;
    float* dst = s_x + dr * cw + c;
    if (vec) {
      copy16(dst, src, 4 * n);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) copy4(dst + u, u < n ? src + u : xpad,
                                        u < n ? 4 : 0);
    }
  }
  // the group's weights, [d][k][l][m], zero past M and past MB
  const int taps = nk * nl;
  for (int e = tid; e < D * taps * MP; e += nthr) {
    const int t = e / MP;               // (d * nk + k) * nl + l
    const int mm = e - t * MP;
    const int m = m0 + mm;
    const bool live = mm < MB && m < M;
    copy4(s_w + e, live ? w + (long long)m * D * taps + t : w,
          live ? 4 : 0);
  }
  copies_done();
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int jl = threadIdx.x * kR;
  const int j = j0 + jl;
  if (i >= H || j >= Wo) return;        // no barrier follows

  float acc[MB][kR];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[mm][r] = 0.f;
  }
  for (int d = 0; d < D; ++d) {
    for (int k = 0; k < nk; ++k) {
      const float* sx = s_x + (d * rows + threadIdx.y + k) * cw + jl;
      const float* sw = s_w + (d * nk + k) * nl * MP;
      if constexpr (NL > 0) {
        constexpr int NV = (kR + NL - 1 + 3) / 4;   // 16-byte window loads
        float win[NV * 4];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 x4 = *reinterpret_cast<const float4*>(sx + 4 * v);
          win[4 * v] = x4.x;
          win[4 * v + 1] = x4.y;
          win[4 * v + 2] = x4.z;
          win[4 * v + 3] = x4.w;
        }
#pragma unroll
        for (int l = 0; l < NL; ++l) {
#pragma unroll
          for (int m4 = 0; m4 < MP; m4 += 4) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(sw + l * MP + m4);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (m4 + u < MB) {
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                  acc[m4 + u][r] = fmaf(wv[u], win[r + l], acc[m4 + u][r]);
                }
              }
            }
          }
        }
      } else {
        for (int l = 0; l < nl; ++l) {
          float x[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) x[r] = sx[r + l];
#pragma unroll
          for (int m4 = 0; m4 < MP; m4 += 4) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(sw + l * MP + m4);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (m4 + u < MB) {
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                  acc[m4 + u][r] = fmaf(wv[u], x[r], acc[m4 + u][r]);
                }
              }
            }
          }
        }
      }
    }
  }

  const bool full = (Wo % 4 == 0) && (j + kR <= Wo);
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) {
    if (m0 + mm >= M) break;
    float* o = out + (((long long)b * M + m0 + mm) * H + i) * Wo + j;
    if (full) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (j + r < Wo) o[r] = acc[mm][r];
      }
    }
  }
}

template <int MB, int NL>
int launch(const float* xpad, const float* w, float* out, int B, int D,
           int Hp, int Wp, int M, int nk, int nl, int tx, int ty, int vec,
           cudaStream_t stream) {
  constexpr int MP = (MB + 3) & ~3;
  const int H = Hp - nk + 1;
  const int Wo = Wp - nl + 1;
  const int groups = (M + MB - 1) / MB;
  const int cw = (tx * kR + nl - 1 + 3) / 4 * 4;
  const size_t smem = sizeof(float) *
      ((size_t)D * (ty + nk - 1) * cw + (size_t)D * nk * nl * MP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_valid_kernel<MB, NL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((Wo + tx * kR - 1) / (tx * kR)),
                  (unsigned)((H + ty - 1) / ty), (unsigned)(B * groups));
  const dim3 block(tx, ty);
  conv_valid_kernel<MB, NL><<<grid, block, smem, stream>>>(
      xpad, w, out, D, Hp, Wp, M, nk, nl, groups, cw, vec);
  return (int)cudaGetLastError();
}

template <int NL>
int dispatch_mb(int mb, const float* xx, const float* ww, float* oo,
                int B, int D, int Hp, int Wp, int M, int nk, int nl, int tx,
                int ty, int vec, cudaStream_t st) {
#define SAE_K2_CASE(N)                                                     \
  case N:                                                                  \
    return launch<N, NL>(xx, ww, oo, B, D, Hp, Wp, M, nk, nl, tx, ty, vec, \
                         st);
  switch (mb) {
    SAE_K2_CASE(1) SAE_K2_CASE(2) SAE_K2_CASE(3) SAE_K2_CASE(4)
    SAE_K2_CASE(5) SAE_K2_CASE(6) SAE_K2_CASE(7) SAE_K2_CASE(8)
    SAE_K2_CASE(9) SAE_K2_CASE(10) SAE_K2_CASE(11) SAE_K2_CASE(12)
    SAE_K2_CASE(13) SAE_K2_CASE(14) SAE_K2_CASE(15) SAE_K2_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SAE_K2_CASE
}

}  // namespace

// xpad: [B, D, Hp, Wp], w: [M, D, nk, nl], out: [B, M, Hp-nk+1, Wp-nl+1];
// all float32, contiguous.  tx, ty, mb, vec: the launch plan
// (coord_kernels.k2_plan): threads along j (4 pixels each) and along i, the
// output channels a thread (1..16), 16-byte staging loads (needs Wp % 4 ==
// 0 and an aligned xpad).
extern "C" int conv_valid_launch(const void* xpad, const void* w, void* out,
                                 int B, int D, int Hp, int Wp, int M, int nk,
                                 int nl, int tx, int ty, int mb, int vec,
                                 void* stream) {
  auto* xx = static_cast<const float*>(xpad);
  auto* ww = static_cast<const float*>(w);
  auto* oo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 1 || M < 1 || nk < 1 || nl < 1 || Hp < nk || Wp < nl ||
      tx < 1 || ty < 1 || tx * ty > kMaxThreads || mb < 1 ||
      (long long)B * ((M + mb - 1) / mb) > 65535 ||
      (Hp - nk + ty) / ty > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && (Wp % 4 != 0 ||
              reinterpret_cast<std::uintptr_t>(xpad) % 16 != 0)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  switch (nl) {
    case 3:
      return dispatch_mb<3>(mb, xx, ww, oo, B, D, Hp, Wp, M, nk, nl, tx,
                            ty, vec, st);
    case 5:
      return dispatch_mb<5>(mb, xx, ww, oo, B, D, Hp, Wp, M, nk, nl, tx,
                            ty, vec, st);
    default:
      return dispatch_mb<0>(mb, xx, ww, oo, B, D, Hp, Wp, M, nk, nl, tx,
                            ty, vec, st);
  }
}
