// Helpers shared by the hand-written kernels of gpflow_slim_tpu_torch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gfs {

// Maps a linear index t over the lower triangle of a tile grid (row-major,
// bi >= bj) to its tile coordinates: t = bi * (bi + 1) / 2 + bj. The square
// root gives the row up to rounding; the two loops correct it exactly.
__device__ __forceinline__ void tri_index(long long t, int& bi, int& bj) {
  int i = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(i) * (i + 1) / 2 > t) --i;
  while (static_cast<long long>(i + 1) * (i + 2) / 2 <= t) ++i;
  bi = i;
  bj = static_cast<int>(t - static_cast<long long>(i) * (i + 1) / 2);
}

// Stationary map kinds; ops/gram.py holds the same table (KINDS).
enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3, kExponential = 4, kCosine = 5 };

// The map of `_apply_map` (GPflow-1.x constants: exponential is
// var * exp(-r / 2), and r = sqrt(d^2 + 1e-12)).
__device__ __forceinline__ float apply_map(int kind, float var, float d2) {
  if (kind == kRbf) return var * expf(-0.5f * d2);
  const float r = sqrtf(d2 + 1e-12f);
  switch (kind) {
    case kMatern12:
      return var * expf(-r);
    case kMatern32: {
      const float s3 = 1.7320508075688772f;
      return var * (1.0f + s3 * r) * expf(-s3 * r);
    }
    case kMatern52: {
      const float s5 = 2.2360679774997896f;
      return var * (1.0f + s5 * r + (5.0f / 3.0f) * d2) * expf(-s5 * r);
    }
    case kExponential:
      return var * expf(-0.5f * r);
    default:  // kCosine
      return var * cosf(r);
  }
}

// d^2 = sum_d (x_d - y_d)^2 of two pre-scaled points, formed directly: the
// same function as the TPU's ||x||^2 - 2 x.y + ||y||^2 expansion, without
// its cancellation near d = 0 (which sqrt(d^2 + 1e-12) would amplify for
// the Matern and exponential kinds).
__device__ __forceinline__ float sq_dist(const float* __restrict__ x, const float* __restrict__ y,
                                         int D) {
  float d2 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float diff = x[d] - y[d];
    d2 = fmaf(diff, diff, d2);
  }
  return d2;
}

}  // namespace gfs
