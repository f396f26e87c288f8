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

// -- tiles of the triangular solves (trsm.cu, batched_trsm.cu) -------------

constexpr int kTriBs = 64;          // block size
constexpr int kTriLd = kTriBs + 4;  // padded shared row that keeps 16-byte alignment for float4

// Stages the kTriBs x kTriBs logical tile of T at (row0, col0) through
// registers into shared memory, as s[r][c], or as s[c][r] when kStoreT.
// The logical T[i][j] is T[i * ld + j], or T[j * ld + i] when kTrans. Global
// reads run along memory rows (coalesced) in either orientation, and each of
// the kNT threads issues all its loads before its first store, so they are
// in flight together. Entries outside N x N are the identity when
// `unit_diag`, else 0.
template <int kNT, bool kTrans, bool kStoreT>
__device__ __forceinline__ void load_tri_tile(const float* __restrict__ T, int N, int ld, int row0,
                                              int col0, float (*s)[kTriLd], bool unit_diag) {
  constexpr int kIt = kTriBs * kTriBs / kNT;
  float v[kIt];
#pragma unroll
  for (int q = 0; q < kIt; ++q) {
    const int e = threadIdx.x + q * kNT;
    const int m = e / kTriBs, n = e % kTriBs;  // memory row, memory column
    const int gr = row0 + (kTrans ? n : m), gc = col0 + (kTrans ? m : n);
    if (gr < N && gc < N) {
      v[q] = kTrans ? T[static_cast<size_t>(gc) * ld + gr] : T[static_cast<size_t>(gr) * ld + gc];
    } else {
      v[q] = (unit_diag && gr == gc) ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kIt; ++q) {
    const int e = threadIdx.x + q * kNT;
    const int m = e / kTriBs, n = e % kTriBs;
    const int r = kTrans ? n : m, c = kTrans ? m : n;
    if (kStoreT) {
      s[c][r] = v[q];
    } else {
      s[r][c] = v[q];
    }
  }
}

// Solves one right-hand-side column v (kTriBs values in registers) against a
// diagonal block stored transposed in shared memory (lt[c][r] = T_kk[r][c]),
// with the reciprocal pivots dinv[j] = 1 / T_kk[j][j]. Column-oriented: once
// x_j is final it is eliminated from every row still to solve; those updates
// are independent, so the dependent chain is one multiply and one FMA per
// row. Column j of T_kk is row j of lt, read four entries at a time (every
// thread reads the same entries: a broadcast). Only the triangle is read.
template <bool kLower>
__device__ __forceinline__ void substitute(float (&v)[kTriBs], const float (*lt)[kTriLd],
                                           const float* dinv) {
  if (kLower) {
#pragma unroll
    for (int j = 0; j < kTriBs; ++j) {
      v[j] *= dinv[j];
#pragma unroll
      for (int i0 = 0; i0 < kTriBs; i0 += 4) {
        if (i0 + 3 > j) {
          const float4 t = *reinterpret_cast<const float4*>(&lt[j][i0]);
          if (i0 > j) v[i0] = fmaf(-t.x, v[j], v[i0]);
          if (i0 + 1 > j) v[i0 + 1] = fmaf(-t.y, v[j], v[i0 + 1]);
          if (i0 + 2 > j) v[i0 + 2] = fmaf(-t.z, v[j], v[i0 + 2]);
          v[i0 + 3] = fmaf(-t.w, v[j], v[i0 + 3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = kTriBs - 1; j >= 0; --j) {
      v[j] *= dinv[j];
#pragma unroll
      for (int i0 = 0; i0 < kTriBs; i0 += 4) {
        if (i0 < j) {
          const float4 t = *reinterpret_cast<const float4*>(&lt[j][i0]);
          v[i0] = fmaf(-t.x, v[j], v[i0]);
          if (i0 + 1 < j) v[i0 + 1] = fmaf(-t.y, v[j], v[i0 + 1]);
          if (i0 + 2 < j) v[i0 + 2] = fmaf(-t.z, v[j], v[i0 + 2]);
          if (i0 + 3 < j) v[i0 + 3] = fmaf(-t.w, v[j], v[i0 + 3]);
        }
      }
    }
  }
}

// acc[qa][qb] += sum_t a[ty + 16 qa][t] * bt[tx + 16 qb][t]: one 64 x 64 x 64
// step of a shared-memory tiled product, 4 x 4 outputs per thread of 256
// (tx = tid & 15, ty = tid >> 4), the inner dimension read four at a time.
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float (*a)[kTriLd],
                                         const float (*bt)[kTriLd], int tx, int ty) {
  for (int t = 0; t < kTriBs; t += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = *reinterpret_cast<const float4*>(&a[ty + 16 * q][t]);
      bv[q] = *reinterpret_cast<const float4*>(&bt[tx + 16 * q][t]);
    }
#pragma unroll
    for (int qa = 0; qa < 4; ++qa) {
#pragma unroll
      for (int qb = 0; qb < 4; ++qb) {
        float s = acc[qa][qb];
        s = fmaf(av[qa].x, bv[qb].x, s);
        s = fmaf(av[qa].y, bv[qb].y, s);
        s = fmaf(av[qa].z, bv[qb].z, s);
        acc[qa][qb] = fmaf(av[qa].w, bv[qb].w, s);
      }
    }
  }
}

}  // namespace gfs
