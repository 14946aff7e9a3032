// Hopper warpgroup products (wgmma) from shared memory for the matmul-DFT
// kernels (rfft2_mixed.cu, probes.cu) and the omega-space sweeps
// (omega_burst.cu): bf16 operand pieces by precision tier, float32
// accumulators in registers.
//
// Precision tiers (the JAX package's dot precisions, as its Pallas kernels
// fed the TPU's matrix unit):
//   tier 0 "default": bf16(a) * bf16(b), one product;
//   tier 1 "high":    a = hi + lo, lo = bf16(a - hi), the same for b;
//                     lo*hi + hi*lo + hi*hi (bf16x3, the JAX order);
//   tier 2 "highest": three pieces each, the six products with piece
//                     indices summing to at most 2 (bf16x6, ~float32).
// Every product of two bf16 values is exact in float32.  The tensor cores
// add them into the float32 accumulators with truncation, ~2^-25 of the
// sum a step toward zero: over a 2048-long contraction at "highest" (768
// steps) ~2e-5 of P2's energy, more than its 1e-5 check.  So the tiers
// above "default" promote: each 64-wide chunk accumulates afresh (4 k16
// steps times the tier's products) and is added into a float32 total with
// IEEE adds (promote()); "default" keeps one accumulator (128 steps at
// 2048, ~4e-6, far inside its own rounding).
//
// Shared-memory tiles are K-major with no swizzle: a tile of R rows by 64
// contraction elements (bf16) is a grid of 8x8 core matrices, each 8 rows
// of 16 bytes stored as 128 contiguous bytes; core (r/8, k/8) starts at
// byte (r/8 * 8 + k/8) * 128.  So the core next along K is 128 bytes on
// (the descriptor's leading byte offset) and the next 8-row group 1024
// (its stride byte offset); a k16 step is 128 elements (256 bytes) on, a
// 64-row block 8 KB.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wg {

constexpr int kK = 64;                 // contraction elements a tile row
constexpr int kTileElems = 64 * kK;    // a 64-row tile: 8 KB of bf16
constexpr uint32_t kLBO = 128, kSBO = 1024;

// element offset of (row r, contraction k) in a tile
__host__ __device__ constexpr int tile_off(int r, int k) {
  return ((r >> 3) * 8 + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// the pieces and products of each tier; product p multiplies a's piece
// prod_a(t, p) by b's piece prod_b(t, p), the small terms first
__host__ __device__ constexpr int pieces(int t) { return t + 1; }
__host__ __device__ constexpr int products(int t) {
  return t == 0 ? 1 : t == 1 ? 3 : 6;
}
__host__ __device__ constexpr int prod_a(int t, int p) {
  return t == 2 ? (p == 0 ? 2 : (p == 1 || p == 3) ? 1 : 0)
                : (t == 1 && p == 0 ? 1 : 0);
}
__host__ __device__ constexpr int prod_b(int t, int p) {
  return t == 2 ? (p == 2 ? 2 : (p == 1 || p == 4) ? 1 : 0)
                : (t == 1 && p == 1 ? 1 : 0);
}

// v's first NP bf16 pieces: p[0] = bf16(v), p[i] = bf16(v - p[0] - ...);
// each residual is exact in float32
template <int NP>
__device__ __forceinline__ void split(float v, __nv_bfloat16 (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = __float2bfloat16_rn(v);
    v = __fsub_rn(v, __bfloat162float(p[i]));
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// eight values' pieces, each piece packed into one 16-byte row of a core
// matrix; dst[i] is piece i's row
template <int NP>
__device__ __forceinline__ void store_row8(const float (&v)[8],
                                           __nv_bfloat16* (&dst)[NP]) {
  __nv_bfloat16 p[8][NP];
#pragma unroll
  for (int e = 0; e < 8; ++e) split<NP>(v[e], p[e]);
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint4*>(dst[i]) =
        make_uint4(pack2(p[0][i], p[1][i]), pack2(p[2][i], p[3][i]),
                   pack2(p[4][i], p[5][i]), pack2(p[6][i], p[7][i]));
}

// sbo: the byte offset of the next 8-row group (kSBO for 64-wide tiles;
// 512 for a tile 32 elements wide)
__device__ __forceinline__ uint64_t desc(const void* smem,
                                         uint32_t sbo = kSBO) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// 16 bytes global -> shared without registers (cp.async, cached in L2
// only); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}
// wait for this thread's cp.async copies; fence_stores() then makes them
// visible to the products like any other store
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// close this thread's cp.async copies issued so far into one group; wait
// until at most N of its groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory stores visible to the wgmma (async)
// proxy; follow with a barrier
__device__ __forceinline__ void fence_stores() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across the async
// product
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) = A (64 x 16) * B (16 x 64) + (scale_d ? d : 0),
// both operands K-major in shared memory
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, float32) = A (64 x 16) * B (16 x 32) + (scale_d ? d : 0),
// both operands K-major in shared memory
__device__ __forceinline__ void mma_m64n32k16(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One warpgroup, one 64-wide contraction chunk: for each n64 block s,
// acc[s] (+)= A * B_s^T over the tier's products; fresh: start from zero.
// a: piece 0 of the 64-row A tile, pieces a_piece elements apart; b: piece
// 0 of the B tile (NS*64 rows), pieces b_piece elements apart.  Issues the
// products and commits them as one group; the caller may issue loads into
// other registers, then calls finish().
template <int TIER, int NS>
__device__ __forceinline__ void mma_chunk(float (&acc)[NS][32],
                                          const __nv_bfloat16* a,
                                          int a_piece,
                                          const __nv_bfloat16* b,
                                          int b_piece, bool fresh) {
#pragma unroll
  for (int s = 0; s < NS; ++s) pin(acc[s]);
  fence();
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
    for (int p = 0; p < products(TIER); ++p)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        mma_m64n64k16(acc[s],
                      desc(a + prod_a(TIER, p) * a_piece + ks * 128),
                      desc(b + prod_b(TIER, p) * b_piece + s * kTileElems +
                           ks * 128),
                      (fresh && ks == 0 && p == 0) ? 0 : 1);
  commit();
}

// wait for the committed products, then release the accumulators
template <int NS>
__device__ __forceinline__ void finish(float (&acc)[NS][32]) {
  wait_all();
#pragma unroll
  for (int s = 0; s < NS; ++s) pin(acc[s]);
}

// total (+)= acc in IEEE float32: this thread's NS*32 totals in shared
// memory, float4 v of thread t at total[v * threads + t] (thread-private,
// conflict-free)
template <int NS>
__device__ __forceinline__ void promote(const float (&acc)[NS][32],
                                        float4* total, int threads,
                                        bool first) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float4* t = total + (s * 8 + v) * threads + threadIdx.x;
      const float4 x = make_float4(acc[s][4 * v], acc[s][4 * v + 1],
                                   acc[s][4 * v + 2], acc[s][4 * v + 3]);
      if (first) {
        *t = x;
      } else {
        const float4 y = *t;
        *t = make_float4(__fadd_rn(y.x, x.x), __fadd_rn(y.y, x.y),
                         __fadd_rn(y.z, x.z), __fadd_rn(y.w, x.w));
      }
    }
}

// the totals back into the accumulator registers, for the epilogue
template <int NS>
__device__ __forceinline__ void totals(float (&acc)[NS][32],
                                       const float4* total, int threads) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float4 y = total[(s * 8 + v) * threads + threadIdx.x];
      acc[s][4 * v] = y.x, acc[s][4 * v + 1] = y.y;
      acc[s][4 * v + 2] = y.z, acc[s][4 * v + 3] = y.w;
    }
}

// shared-memory bytes of the totals of a block of `threads`, ns n64
// accumulators a thread: none at "default"
__host__ __device__ constexpr int total_bytes(int tier, int ns, int threads) {
  return tier == 0 ? 0 : ns * 32 * 4 * threads;
}


// The accumulator layout of m64nNk16: register i of thread t holds row
// 16*(t/32 % 4) + (t%32)/4 + 8*(i/2 % 2), column 8*(i/4) + 2*(t%4) + i%2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * ((t >> 5) & 3) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// A kernel's registers, local (spilled) bytes and static shared memory as
// the runtime reports them, and the dynamic shared memory its launch asks
// for: out[0..3]
template <typename Kernel>
int attrs(Kernel* kernel, int dynamic_smem, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = dynamic_smem;
  return 0;
}

}  // namespace wg
