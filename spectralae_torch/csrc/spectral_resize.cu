// The spectral pooling's resize, and its adjoint, as one 2-D remap.
//
// Replaces no TPU kernel: the JAX package leaves the resize
// (spectralae/ops/spectral.py spectral_resize, the reference's resize
// kernel, fft_backproplib.cu:87-157) to XLA's gathers.  On the card the
// port ran it as two index_select gathers and a mask multiply, and its
// gradient as a mask multiply and two index_adds into zero-filled
// buffers: five to seven passes over spectra of up to 0.8 GB.
//
// Where the resize's mask is 1 its row and column maps are one to one, so
// the resize (a crop or a zero-pad of an rfft2 half-spectrum) and its
// adjoint are the same remap of planes [h_in, w_in] -> [h_out, w_out]:
//   out[n, i, j] = rows[i] >= 0 && col(j) >= 0 ? in[n, rows[i], col(j)] : 0
// with n over the flattened leading dims, rows[] the row map (-1 where the
// output row is zero; the inverse map for the adjoint) and
//   col(j) = j < k ? j : j == w_out - 1 ? w_in - 1 : -1
// the column map, the same form in all four directions (the identity up to
// k = min(w_in, w_out) - 1, zeros, and the last column from the input's
// last, the reference's Nyquist quirk).  tests/test_torch_resize.py
// holds that form (test_resize_dims_and_column_form).
//
// What bounds it: bytes.  It reads every input bin it keeps once and
// writes every output bin once, zeros included, with no atomics, no fill
// and no second pass (0 operations).  The design does about that:
//  - a warp owns one output row; its lanes walk the row's columns, so
//    neighbouring lanes load neighbouring bins of one input row and store
//    neighbouring bins of one output row (coalesced); the row map is read
//    once a warp (a broadcast), the column map is arithmetic;
//  - rows of an rfft2 half-spectrum are odd (2^n / 2 + 1 bins), so a row
//    starts on a 16-byte boundary only every other row: each access is one
//    8-byte complex64 bin, and each lane has 4 loads in flight before its
//    stores, enough bytes in flight to cover the memory's latency;
//  - a zero row (the zero-pad's middle rows, the crop's dropped rows in
//    the adjoint) reads nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // output rows a block
constexpr int kUnroll = 4;     // loads in flight a lane

__global__ void __launch_bounds__(kWarps * 32)
spectral_resize_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                       const int* __restrict__ rows, long long n_rows,
                       int h_in, int w_in, int h_out, int w_out, int k) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long plane = row / h_out;
  const int src = __ldg(rows + (row - plane * h_out));
  float2* o = out + row * w_out;
  const float2 zero = make_float2(0.f, 0.f);
  if (src < 0) {
    for (int j = lane; j < w_out; j += 32) o[j] = zero;
    return;
  }
  const float2* s = in + (plane * h_in + src) * (long long)w_in;
  for (int j0 = lane; j0 < w_out; j0 += 32 * kUnroll) {
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      const int c = j < k ? j : (j == w_out - 1 ? w_in - 1 : -1);
      v[u] = (j < w_out && c >= 0) ? __ldg(s + c) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      if (j < w_out) o[j] = v[u];
    }
  }
}

}  // namespace

// in [planes, h_in, w_in] and out [planes, h_out, w_out] complex64,
// contiguous; rows: h_out int32 on the card; k: the column map's identity
// prefix (col(j) above).
extern "C" int spectral_resize_launch(const void* in, void* out,
                                      const void* rows, long long planes,
                                      int h_in, int w_in, int h_out,
                                      int w_out, int k, void* stream) {
  const long long n_rows = planes * h_out;
  if (planes < 1 || h_in < 1 || w_in < 1 || h_out < 1 || w_out < 1 ||
      k < 0 || k > w_in || k > w_out ||
      (n_rows + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
  spectral_resize_kernel<<<blocks, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out),
      static_cast<const int*>(rows), n_rows, h_in, w_in, h_out, w_out, k);
  return (int)cudaGetLastError();
}
