// Gram matrices of the stationary kernels from pre-scaled inputs:
//  * the cross Gram K(Xs, X2s), (N, M), any D, ragged N and M;
//  * the lower-tile Gram of K(Xs, Xs), (N, N): every 32 x 32 tile on or
//    below the diagonal holds the Gram, every strictly-upper tile is
//    written as zero.
//
// Replaces the TPU kernels gpflow_slim_tpu/ops/pallas_gram.py `_gram_kernel`
// (launched by `_gram_pallas`, and by `gram_interpret_mode` for the CPU
// tests) and `_gram_lower_kernel` (launched by `_gram_lower_pallas`).
//
// What bounds it on an H100: the writes, N * M * 4 bytes (82 MB for the
// (10000, 2048) cross Gram of a prediction request, 400 MB for the lower
// Gram at N = 10000), at one exp per entry; the inputs are N * D and M * D
// floats that stay in L1/L2. The design does what it can about that:
//  * one block per 32 x 32 output tile, 32 x 8 threads with 4 rows each, so
//    a warp writes 32 consecutive floats of one row: every store is a full
//    128-byte line;
//  * the lower-tile Gram zeroes its strictly-upper tiles without reading
//    any input or computing the map there (the TPU kernel's `pl.when` does
//    the same), so they cost their writes only;
//  * d^2 is formed directly from the coordinate differences
//    (`gfs::sq_dist`). It is the function the TPU computes with its
//    full-precision ||x||^2 - 2 x.y + ||y||^2 expansion (the expansion is
//    what its matrix unit needs), without the expansion's f32 cancellation
//    near d = 0: at |x|^2 ~ 100 that cancellation leaves ~1e-5 in d^2, and
//    sqrt(d^2 + 1e-12) turns it into ~3e-3 in the Matern12 and exponential
//    maps.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowStep = kTile / kRowsPerThread;  // block is kTile x kRowStep
constexpr int kMaxGridY = 65535;

// Block (bi, bj) = (blockIdx.x, blockIdx.y) writes output tile (bi, bj).
template <bool kLower>
__global__ void gram_kernel(const float* __restrict__ X, int N, const float* __restrict__ X2, int M,
                            int D, const float* __restrict__ var_p, int kind,
                            float* __restrict__ out) {
  const int bi = blockIdx.x;
  const int bj = blockIdx.y;
  const int col = bj * kTile + threadIdx.x;
  if (col >= M) return;
  const bool zero = kLower && bi < bj;
  const float var = zero ? 0.0f : var_p[0];
  const float* y = X2 + static_cast<size_t>(col) * D;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = bi * kTile + threadIdx.y + q * kRowStep;
    if (row >= N) break;
    const float v =
        zero ? 0.0f : gfs::apply_map(kind, var, gfs::sq_dist(X + static_cast<size_t>(row) * D, y, D));
    out[static_cast<size_t>(row) * M + col] = v;
  }
}

template <bool kLower>
int launch(const float* X, int N, const float* X2, int M, int D, const float* var, int kind,
           float* out, void* stream) {
  if (N < 0 || M < 0 || D < 1 || kind < gfs::kRbf || kind > gfs::kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gx = (N + kTile - 1) / kTile;
  const long long gy = (M + kTile - 1) / kTile;
  if (gy > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (gx > 0 && gy > 0) {
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    const dim3 block(kTile, kRowStep);
    gram_kernel<kLower><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(X, N, X2, M, D, var,
                                                                               kind, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (N, M) = K(X, X2); var is a device pointer to the signal variance.
extern "C" int gfs_gram(const float* X, int N, const float* X2, int M, int D, const float* var,
                        int kind, float* out, void* stream) {
  return launch<false>(X, N, X2, M, D, var, kind, out, stream);
}

// out (N, N): lower tiles of K(X, X), strictly-upper 32 x 32 tiles zero.
extern "C" int gfs_gram_lower(const float* X, int N, int D, const float* var, int kind, float* out,
                              void* stream) {
  return launch<true>(X, N, X, N, D, var, kind, out, stream);
}
