// P1 · the Mosaic feature probes, and P2 · ydft_energy.
//
// P1 replaces: scripts/probe_mosaic_features.py · lane_strided,
//   sublane_strided, middle_store — three lowering-feature probes of the
//   TPU compiler (a lane-strided and a sublane-strided slice of a loaded
//   tile, a store into the middle axis of a 3-D block).  On Hopper none of
//   them is a question of the compiler: each is one thread per output
//   element, neighbouring threads on neighbouring output addresses.
//   lane_strided:    out[r, j]    = 2 * x[r, 4j + 1]
//   sublane_strided: out[i, c]    = 2 * x[4i + 1, c]
//   middle_store:    out[k, r, c] = x[r, c] * (k + 1), k < K
//   They move a few hundred KB and are bound by launch latency; the
//   results are exact (one float32 multiply by a small integer).
//
// P2 replaces: scripts/probe_fused_dft.py · ydft_energy (body _make_kernel)
//   E = sum_d sum_r sum_j w[j] * |DFT_y(x)[d, r, j]|^2 for x [D, nx, ny]
//   float32, the y-DFT a product with the [ny, nyr] cos/sin bases.
//   What bounds it: operations.  Two real products of [D*nx, ny] by
//   [ny, nyr], 4*D*nx*ny*nyr flops on ~67 MB at 2048^2 (D = 3), three
//   orders of magnitude over the card's flop/byte balance.
//   What the design does about it (kept simple; every precision tier runs
//   IEEE float32 FMAs on CUDA cores, no tensor cores):
//    - one block owns a 64-row x 64-bin tile of Y = x * (cos - i sin), the
//      rows flattened over D; 256 threads each hold a 4 x 4 tile of both
//      products in registers (32 accumulators) and step over y in chunks of
//      16, x and both bases staged through shared memory — a register-
//      blocked float32 product; the bases (16.8 MB at 2048^2) stay in the
//      50 MB L2 across blocks;
//    - the epilogue weighs |Y|^2 by w and sums the block's tile in a fixed
//      tree into one partial; a second grid of one block sums the partials
//      in a fixed order in double, so the result does not depend on block
//      scheduling and no float atomics are used.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lane_strided_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int rows,
                                    int in_cols, int out_cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (j < out_cols) {
    out[(long long)r * out_cols + j] =
        2.f * x[(long long)r * in_cols + 4 * j + 1];
  }
}

__global__ void sublane_strided_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (c < cols) {
    out[(long long)i * cols + c] = 2.f * x[(long long)(4 * i + 1) * cols + c];
  }
}

__global__ void middle_store_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (e < n) out[k * n + e] = x[e] * (float)(k + 1);
}

constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void __launch_bounds__(kThreads)
ydft_sweep_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ sb, const float* __restrict__ wt,
                  float* __restrict__ partial, int R, int ny, int nyr) {
  __shared__ float xs[kBK][kBM + 1];   // x tile, transposed; +1: no conflicts
  __shared__ float cs[kBK][kBN];
  __shared__ float ss[kBK][kBN];
  __shared__ float red[kThreads];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float ac[4][4], as[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ac[i][j] = as[i][j] = 0.f;

  for (int k0 = 0; k0 < ny; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 4, kk = idx & 15;       // x: 16 y a row
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < R && gk < ny) ? x[(long long)gr * ny + gk] : 0.f;
      const int kb = idx >> 6, c = idx & 63;        // bases: 64 bins a row
      const int gkb = k0 + kb, gc = col0 + c;
      const bool in = gkb < ny && gc < nyr;
      const long long o = (long long)gkb * nyr + gc;
      cs[kb][c] = in ? cb[o] : 0.f;
      ss[kb][c] = in ? sb[o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bc[4], bs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bc[j] = cs[kk][tx + 16 * j];
        bs[j] = ss[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ac[i][j] = fmaf(a[i], bc[j], ac[i][j]);
          as[i][j] = fmaf(a[i], bs[j], as[i][j]);
        }
    }
    __syncthreads();
  }

  // rows past R hold zeros; bins past nyr weigh nothing
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx + 16 * j;
    if (c < nyr) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s += ac[i][j] * ac[i][j] + as[i][j] * as[i][j];
      e += wt[c] * s;
    }
  }
  red[t] = e;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kThreads)
ydft_reduce_kernel(const float* __restrict__ partial, int n,
                   float* __restrict__ out) {
  __shared__ double red[kThreads];
  const int t = threadIdx.x;
  double s = 0.0;
  for (int i = t; i < n; i += kThreads) s += (double)partial[i];
  red[t] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) out[0] = (float)red[0];
}

}  // namespace

// x: [rows, in_cols] float32, contiguous; out: [rows, out_cols] with
// out_cols = ceil((in_cols - 1) / 4).
extern "C" int probe_lane_strided_launch(const void* x, void* out, int rows,
                                         int in_cols, int out_cols,
                                         void* stream) {
  const dim3 grid((unsigned)((out_cols + kThreads - 1) / kThreads),
                  (unsigned)rows);
  lane_strided_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, in_cols,
      out_cols);
  return (int)cudaGetLastError();
}

// x: [>= 4*out_rows - 2, cols] float32, contiguous; out: [out_rows, cols].
extern "C" int probe_sublane_strided_launch(const void* x, void* out,
                                            int out_rows, int cols,
                                            void* stream) {
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads),
                  (unsigned)out_rows);
  sublane_strided_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                                    stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), cols);
  return (int)cudaGetLastError();
}

// x: n float32, contiguous; out: [K, n].
extern "C" int probe_middle_store_launch(const void* x, void* out,
                                         long long n, int K, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)K);
  middle_store_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// Blocks of the sweep grid, hence the partials' scratch floats.
extern "C" long long ydft_energy_blocks(int R, int nyr) {
  return (long long)((nyr + kBN - 1) / kBN) * ((R + kBM - 1) / kBM);
}

// x: [R, ny] float32 (R = D*nx), cosb/sinb: [ny, nyr], w: [nyr], all
// contiguous float32; scratch: ydft_energy_blocks(R, nyr) floats; out: one
// float.  Two grids: the sweep, then the ordered sum of its partials.
extern "C" int ydft_energy_launch(const void* x, const void* cosb,
                                  const void* sinb, const void* w,
                                  void* scratch, void* out, int R, int ny,
                                  int nyr, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((nyr + kBN - 1) / kBN),
                  (unsigned)((R + kBM - 1) / kBM));
  ydft_sweep_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(w),
      static_cast<float*>(scratch), R, ny, nyr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ydft_reduce_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(scratch), (int)(grid.x * grid.y),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
