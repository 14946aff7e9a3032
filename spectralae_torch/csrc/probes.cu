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
//   What bounds it: the function needs x read once (50 MB at [3, 2048,
//   2048]: 0.015 ms at 3.35 TB/s), but the matmul DFT does
//   4*D*nx*ny*nyr = 51.6 GFLOP for it: 0.77 ms on CUDA cores in float32,
//   0.052 ms a bf16 pass on the tensor cores.  Each block re-reads x from
//   L2 for each of its row band's bin tiles (17 at 2048^2), ~1.25 GB a
//   call with the bases.  Timed apart (scripts/torch_dft_ablation.py,
//   PERF.md), staging the operands takes longer than the products at
//   every tier, and a second stage of the A tile that let the two overlap
//   gained nothing, so the A tile has one and the bases two.  The design
//   (wgmma, bf16 operand pieces by the JAX precision tier,
//   csrc/wgmma.cuh):
//    - a block of two warpgroups owns 128 rows (flattened over D) x 64
//      bins; B = [cos | sin] of the bins, N = 128 as two n64 products per
//      k16 step; each warpgroup accumulates its 64 rows in registers (64
//      floats a thread) over y in chunks of 64;
//    - while the tensor cores work on chunk c, the bases' pieces of chunk
//      c + 1 arrive by 16-byte cp.async in the other of two B stages, in
//      tile order from the host (probe_kernels._ydft_tiles_on, cached;
//      8.4 MB a piece at 2048^2, L2-resident), and each thread loads 4 x 8
//      consecutive y of a row of chunk c + 1 (two float4 loads where ny %
//      4 == 0); when the products have read the A tile, x is split into
//      the tier's bf16 pieces, written as 16-byte rows of the K-major A
//      tile;
//    - the grid runs the bin tiles of a row band side by side (bin tile =
//      blockIdx.x), so x comes from HBM once and from L2 for the rest;
//    - the epilogue weighs |Y|^2 by w and sums the block's tile in a fixed
//      tree into one partial; a second grid of one block sums the partials
//      in a fixed order in double, so the result does not depend on block
//      scheduling and no float atomics are used.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

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

constexpr int kPM = 128;   // rows per block: two warpgroups of 64
constexpr int kPB = 64;    // bins per block (N = 128: cos | sin)
constexpr int kPY = 64;    // y per chunk (the tile's contraction)

// One chunk's x in one thread's registers: 4 groups of 8 consecutive y
// of one row each.
struct XStage {
  float v[4][8];
};

__device__ __forceinline__ void load_xstage(const float* __restrict__ x,
                                            int row0, int y0, int R, int ny,
                                            bool vec, XStage& st) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int unit = threadIdx.x + u * kThreads;
    const int r = row0 + (unit >> 3), y = y0 + (unit & 7) * 8;
    const float* p = x + (long long)r * ny + y;
    if (vec && r < R && y + 8 <= ny) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      st.v[u][0] = a.x, st.v[u][1] = a.y, st.v[u][2] = a.z, st.v[u][3] = a.w;
      st.v[u][4] = b.x, st.v[u][5] = b.y, st.v[u][6] = b.z, st.v[u][7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        st.v[u][e] = (r < R && y + e < ny) ? p[e] : 0.f;
    }
  }
}

// Dynamic shared memory: the A tile's NP pieces (128 rows: both
// warpgroups), then two stages of the B tile's NP pieces of 128 rows, 16
// KB each; above "default" the float32 totals (wg::promote), 64 KB
template <int TIER>
__host__ __device__ constexpr int sweep_smem() {
  return 6 * wg::pieces(TIER) * wg::kTileElems * 2 +
         wg::total_bytes(TIER, 2, kThreads);
}

// Grid: (bin tiles, row bands); shared memory: sweep_smem.  While the
// products of chunk c run, chunk c + 1's bases arrive by cp.async in the
// other B stage and its x loads into registers; once the products have
// read the A tile, the block writes x's pieces into it.  At "default"
// (48 KB) two blocks share an SM, one staging while the other
// multiplies, in 128 registers a thread.
template <int TIER>
__global__ void __launch_bounds__(kThreads, TIER == 0 ? 2 : 1)
ydft_sweep_kernel(const float* __restrict__ x,
                  const uint4* __restrict__ tiles,
                  const float* __restrict__ wt, float* __restrict__ partial,
                  int R, int ny, int nyr, int vec) {
  constexpr int NP = wg::pieces(TIER);
  constexpr int kA = 2 * wg::kTileElems;       // A: one piece, 128 rows
  constexpr int kB = 2 * wg::kTileElems;       // B: one piece, 128 rows
  constexpr int kChunk = NP * kB / 8;          // uint4 of bases a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const Bs = As + NP * kA;
  float4* const tot = reinterpret_cast<float4*>(Bs + 2 * NP * kB);
  __shared__ float red[kThreads];
  const int t = threadIdx.x, g = t >> 7;
  const int row0 = blockIdx.y * kPM, b0 = blockIdx.x * kPB;
  const int nc = (ny + kPY - 1) / kPY;
  const uint4* bt = tiles + (size_t)blockIdx.x * nc * kChunk;

  float acc[2][32];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[s][v] = 0.f;

  XStage st;
  // chunk c's bases into B stage c % 2
  const auto bases = [&](int c) {
    uint4* const B = reinterpret_cast<uint4*>(Bs + (c & 1) * NP * kB);
#pragma unroll
    for (int u = 0; u < 4 * NP; ++u)
      wg::cp_async16(B + t + u * kThreads,
                     bt + (size_t)c * kChunk + t + u * kThreads);
  };
  // the x pieces in st into the A tile; the tile and the chunk's bases
  // are the products' after the barrier
  const auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int unit = t + u * kThreads;
      const int r = unit >> 3, k = (unit & 7) * 8;
      __nv_bfloat16* dst[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        dst[p] = As + p * kA + (r >> 6) * wg::kTileElems +
                 wg::tile_off(r & 63, k);
      wg::store_row8<NP>(st.v[u], dst);
    }
    wg::cp_async_wait_all();
    wg::fence_stores();
    __syncthreads();
  };
  load_xstage(x, row0, 0, R, ny, vec, st);
  bases(0);
  stage();
  for (int c = 0; c < nc; ++c) {
    wg::mma_chunk<TIER, 2>(acc, As + g * wg::kTileElems, kA,
                           Bs + (c & 1) * NP * kB, kB, TIER > 0 || c == 0);
    if (c + 1 < nc) {
      bases(c + 1);
      load_xstage(x, row0, (c + 1) * kPY, R, ny, vec, st);
    }
    wg::finish<2>(acc);
    if constexpr (TIER > 0) wg::promote<2>(acc, tot, kThreads, c == 0);
    if (c + 1 < nc) {
      __syncthreads();              // every product has read the A tile
      stage();
    }
  }
  if constexpr (TIER > 0) wg::totals<2>(acc, tot, kThreads);

  // acc[0] holds the cos products of bins b0 + col, acc[1] the sin ones;
  // rows past R hold zeros, bins past nyr weigh nothing
  float e = 0.f;
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int bin = b0 + wg::acc_col(t & 127, v);
    if (bin < nyr)
      e += wt[bin] * (acc[0][v] * acc[0][v] + acc[1][v] * acc[1][v]);
  }
  red[t] = e;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

template <int TIER>
cudaError_t launch_sweep(dim3 grid, const float* x, const uint4* tiles,
                         const float* w, float* partial, int R, int ny,
                         int nyr, int vec, cudaStream_t st) {
  constexpr int smem = sweep_smem<TIER>();
  const cudaError_t err = cudaFuncSetAttribute(
      ydft_sweep_kernel<TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ydft_sweep_kernel<TIER><<<grid, kThreads, smem, st>>>(x, tiles, w, partial,
                                                        R, ny, nyr, vec);
  return cudaGetLastError();
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
  return (long long)((nyr + kPB - 1) / kPB) * ((R + kPM - 1) / kPM);
}

// x: [R, ny] float32 (R = D*nx), contiguous; tiles: the [ny, nyr] cos and
// sin bases' bf16 pieces of the precision tier (0 default, 1 high, 2
// highest) in tile order, [ceil(nyr/tb)][ceil(ny/ty)][tier + 1][2 tb x ty]
// (probe_kernels._ydft_tiles_on), laid out for tb = kPB bins and ty = kPY
// y (checked here); w: [nyr] float32; scratch: ydft_energy_blocks(R, nyr)
// floats; out: one float.  Two grids: the sweep, then the ordered sum of
// its partials.
extern "C" int ydft_energy_launch(const void* x, const void* tiles,
                                  const void* w, void* scratch, void* out,
                                  int R, int ny, int nyr, int tier, int tb,
                                  int ty, void* stream) {
  if (tb != kPB || ty != kPY) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((nyr + kPB - 1) / kPB),
                  (unsigned)((R + kPM - 1) / kPM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* tl = static_cast<const uint4*>(tiles);
  const auto* wf = static_cast<const float*>(w);
  auto* part = static_cast<float*>(scratch);
  const int vec = ny % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  switch (tier) {
    case 0: err = launch_sweep<0>(grid, xf, tl, wf, part, R, ny, nyr, vec, st);
            break;
    case 1: err = launch_sweep<1>(grid, xf, tl, wf, part, R, ny, nyr, vec, st);
            break;
    case 2: err = launch_sweep<2>(grid, xf, tl, wf, part, R, ny, nyr, vec, st);
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ydft_reduce_kernel<<<1, kThreads, 0, st>>>(
      part, (int)(grid.x * grid.y), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The sweep kernel's registers, local bytes, static and dynamic shared
// memory at a tier (wg::attrs): out[0..3].
extern "C" int ydft_sweep_attrs(int tier, int* out) {
  switch (tier) {
    case 0: return wg::attrs(ydft_sweep_kernel<0>, sweep_smem<0>(), out);
    case 1: return wg::attrs(ydft_sweep_kernel<1>, sweep_smem<1>(), out);
    case 2: return wg::attrs(ydft_sweep_kernel<2>, sweep_smem<2>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
