// Helpers shared by the hand-written kernels of gpflow_slim_tpu_torch.
//
// Two tiled f32 products live here. `tile_fma` (64 x 64 outputs, 4 x 4 per
// thread, operands staged by the caller) serves the small steps whose
// latency matters more than their rate: the batched TRSM, the wide TRSM's
// in-group solve, the Cholesky's updates inside a panel. `mm_run` (128 x 128
// outputs, 8 x 8 per thread of 256, the inner dimension streamed through a
// two-stage cp.async ring) serves the large updates that bound the wide
// TRSM and the Cholesky on an H100: there the limit of a product without
// tensor cores is the shared-memory traffic per FMA. An SM reads 128 bytes
// of shared memory per clock and issues 128 FMAs: a 4 x 4 thread tile reads
// 2 bytes per FMA (half the FMA rate at best), 8 x 8 reads 1 byte per FMA
// (24 TFLOP/s measured, 36% of the peak; 16 x 8 per thread, 0.75 bytes per
// FMA, measured slower: 17 TFLOP/s at 255 registers and 8 warps per SM).
// The ring lets the next stage's loads fly while this stage's FMAs run.
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

// -- the 128 x 128 product with a cp.async ring (trsm.cu, chol_solve.cu) ----

constexpr int kMmTile = 128;            // output tile side
constexpr int kMmBk = 16;               // inner depth of one stage
constexpr int kMmStages = 2;            // stages in the ring
constexpr int kMmLd = kMmTile + 4;      // padded shared row, 16-byte aligned
constexpr int kMmThreads = 256;         // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMmRows = 8, kMmCols = 8;  // outputs per thread
using MmAcc = float[kMmRows][kMmCols];

// One operand of a tile product: element (o, t), o the output row (for A)
// or column (for B) within the tile and t the inner index, is
// base[o * s_outer + t * s_inner], and 0 where o >= outer or t >= inner (the
// ragged edges, masked here so callers pad nothing). `kInnerContig` says
// which index runs along memory, so that a warp's loads are coalesced.
struct MmOperand {
  const float* base;
  long long s_outer, s_inner;
  int outer, inner;
};

// Shared ring of one operand: s[stage][t][o].
using MmStage = float[kMmBk][kMmLd];

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes zeros and reads nothing: the masked edge
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Issues the copies of inner indices [t0, t0 + kMmBk) of `op` into s[t][o].
// 4-byte copies: any row stride and any alignment of the caller's views.
// With kInnerContig a warp covers 8 inner indices of 4 rows (32-byte runs
// in memory; shared banks 4 t + o, all distinct); otherwise 32 consecutive
// outer indices of one inner index.
template <bool kInnerContig>
__device__ __forceinline__ void mm_load_stage(const MmOperand& op, int t0, MmStage& s) {
#pragma unroll
  for (int q = 0; q < kMmBk * kMmTile / kMmThreads; ++q) {
    const int e = threadIdx.x + q * kMmThreads;
    int o, t;
    if (kInnerContig) {
      t = (e & 7) + 8 * (e >> 10);
      o = (e >> 3) & (kMmTile - 1);
    } else {
      o = e & (kMmTile - 1);
      t = e >> 7;
    }
    const bool valid = o < op.outer && t0 + t < op.inner;
    const float* src = valid ? op.base + o * op.s_outer + static_cast<long long>(t0 + t) * op.s_inner
                             : op.base;
    cp_async4(&s[t][o], src, valid);
  }
}

// Row of a thread's i-th output row (ty = tid >> 4) and column of its j-th
// output column (tx = tid & 15): runs of four, 64 apart, so a warp's float4
// reads of B cover 256 contiguous bytes.
constexpr int kMmRowRun = kMmTile / (kMmRows / 4), kMmColRun = kMmTile / (kMmCols / 4);
__device__ __forceinline__ int mm_row_index(int i, int ty) { return kMmRowRun * (i >> 2) + 4 * ty + (i & 3); }
__device__ __forceinline__ int mm_col_index(int j, int tx) { return kMmColRun * (j >> 2) + 4 * tx + (j & 3); }

// acc[i][j] -= sum_t A(mm_row_index(i, ty), t) * B(mm_col_index(j, tx), t)
// over t < inner, one FMA at a time in t.
// The caller loads the output tile into acc first, so every rounding is at
// the magnitude of the running remainder C - sum: a separate 256-term dot
// product subtracted at the end rounds at the magnitude of the whole dot
// and, in the Cholesky, put the half-logdet 4x further from f64. Every
// thread of the block calls it. After each stage lands and before its
// FMAs, hook(stage_a, t0) may read the A stage (sa[t][o], inner indices t0
// ...). The caller writes acc out.
template <bool kAInnerContig, bool kBInnerContig, typename Hook>
__device__ __forceinline__ void mm_run(MmAcc& acc, const MmOperand& A, const MmOperand& B,
                                       int inner, MmStage* sa, MmStage* sb, Hook hook) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int stages = (inner + kMmBk - 1) / kMmBk;
  mm_load_stage<kAInnerContig>(A, 0, sa[0]);
  mm_load_stage<kBInnerContig>(B, 0, sb[0]);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int cur = s % kMmStages;
    if (s + 1 < stages) {  // the next stage flies while this one is multiplied
      mm_load_stage<kAInnerContig>(A, (s + 1) * kMmBk, sa[(s + 1) % kMmStages]);
      mm_load_stage<kBInnerContig>(B, (s + 1) * kMmBk, sb[(s + 1) % kMmStages]);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: stage s has landed
    __syncthreads();
    hook(sa[cur], s * kMmBk);
#pragma unroll
    for (int t = 0; t < kMmBk; ++t) {
      float av[kMmRows], bv[kMmCols];
#pragma unroll
      for (int q = 0; q < kMmRows / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&sa[cur][t][kMmRowRun * q + 4 * ty]);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < kMmCols / 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(&sb[cur][t][kMmColRun * q + 4 * tx]);
        bv[4 * q] = b.x, bv[4 * q + 1] = b.y, bv[4 * q + 2] = b.z, bv[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < kMmRows; ++i) {
#pragma unroll
        for (int j = 0; j < kMmCols; ++j) acc[i][j] = fmaf(-av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

// Loads (kStore false) or stores this thread's 16 x 8 outputs of the tile
// at `tile` (row stride ld): entry (r, c) where r < rows, c < cols and
// keep(r, c); acc is 0 where nothing is loaded.
template <bool kStore, typename Keep>
__device__ __forceinline__ void mm_tile_io(MmAcc& acc, float* tile, int ld, int rows, int cols,
                                           Keep keep) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const int r = mm_row_index(i, ty);
    float* const row = tile + static_cast<size_t>(r) * ld;
#pragma unroll
    for (int j = 0; j < kMmCols; ++j) {
      const int c = mm_col_index(j, tx);
      const bool in = r < rows && c < cols && keep(r, c);
      if (kStore) {
        if (in) row[c] = acc[i][j];
      } else {
        acc[i][j] = in ? row[c] : 0.0f;
      }
    }
  }
}

// -- publishing a block row to the blocks that wait on it (trsm.cu) ---------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

}  // namespace gfs
