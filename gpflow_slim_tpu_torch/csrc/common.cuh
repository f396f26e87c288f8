// Helpers shared by the hand-written kernels of gpflow_slim_tpu_torch.
//
// Two tiled f32 products live here, beside the body of the one-launch
// dataflow solve (`flow_block_row`, shared by trsm.cu's thin schedule and
// batched_trsm.cu) and the band writer of the Gram operand and the cross
// Gram (`gram_band`).
// `tile_fma` (64 x 64 outputs, 4 x 4 per thread, operands staged by the
// caller) serves the small steps whose latency matters more than their
// rate: the wide TRSM's in-group solve, the Cholesky's updates inside a
// panel. `mm_run` (128 x 128
// outputs, 8 x 8 per thread of 256, the inner dimension streamed through a
// two-stage cp.async ring) serves the large updates that bound the wide
// TRSM and the Cholesky on an H100: there the limit of a product without
// tensor cores is the shared-memory traffic per FMA. An SM reads 128 bytes
// of shared memory per clock and issues 128 FMAs: a 4 x 4 thread tile reads
// 2 bytes per FMA (half the FMA rate at best), 8 x 8 reads 1 byte per FMA
// (24 TFLOP/s measured, 36% of the peak; 16 x 8 per thread, 0.75 bytes per
// FMA, measured slower: 17 TFLOP/s at 255 registers and 8 warps per SM).
// The ring lets the next stage's loads fly while this stage's FMAs run.
// The same ring feeds the bf16 tensor-core products of the Cholesky's
// split trailing update (`frag_a_split`, `frag_b_split`, `mma_bf16`): each
// f32 operand is split into bf16 hi + lo in registers as its fragment is
// read from the stage, whose 16 inner indices are the MMA's depth.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// The single- and double-precision functions of the maps: the float ones
// are the functions the float kernels have always called.
__device__ __forceinline__ float map_exp(float x) { return expf(x); }
__device__ __forceinline__ double map_exp(double x) { return exp(x); }
__device__ __forceinline__ float map_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double map_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ void map_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void map_sincos(double x, double* s, double* c) { sincos(x, s, c); }

// The map at unit variance, f(d2), and its slope df/dd2 (ops/gram.py's
// `_unit_map_and_slope`; GPflow-1.x constants: exponential is exp(-r / 2),
// and r = sqrt(d^2 + 1e-12)), in float (the forward kernels) or double (the
// operand's VJP). Each constant is written once and rounded to T; the float
// ones round to the same floats as their float literals did.
template <typename T>
__device__ __forceinline__ void unit_map_slope(int kind, T d2, T& f, T& s) {
  if (kind == kRbf) {
    f = map_exp(T(-0.5) * d2);
    s = T(-0.5) * f;
    return;
  }
  const T r = map_sqrt(d2 + T(1e-12));
  const T s3 = T(1.7320508075688772), s5 = T(2.2360679774997896);
  switch (kind) {
    case kMatern12:
      f = map_exp(-r);
      s = T(-0.5) * f / r;
      return;
    case kMatern32: {
      const T e = map_exp(-s3 * r);
      f = (T(1) + s3 * r) * e;
      s = T(-1.5) * e;
      return;
    }
    case kMatern52: {
      const T e = map_exp(-s5 * r);
      f = (T(1) + s5 * r + (T(5) / T(3)) * d2) * e;
      s = -(T(5) / T(6)) * e * (T(1) + s5 * d2 / r);
      return;
    }
    case kExponential:
      f = map_exp(T(-0.5) * r);
      s = T(-0.25) * f / r;
      return;
    default: {  // kCosine
      T sn;
      map_sincos(r, &sn, &f);
      s = T(-0.5) * sn / r;
      return;
    }
  }
}

// The map of `_apply_map`: var f(d2) (the slope is left to the compiler to
// drop).
__device__ __forceinline__ float apply_map(int kind, float var, float d2) {
  float f, s;
  unit_map_slope(kind, d2, f, s);
  return var * f;
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

// Streams inner indices [0, inner) of A and B through the two-stage ring:
// after stage s of `stages` lands (every thread of the block has waited
// for it), body(stage_a, stage_b, s, stages) reads it (inner indices
// s * kMmBk ...); the stage is refilled only after every thread's body has
// returned. Every thread of the block calls it.
template <bool kAInnerContig, bool kBInnerContig, typename Body>
__device__ __forceinline__ void mm_ring(const MmOperand& A, const MmOperand& B, int inner, MmStage* sa,
                                        MmStage* sb, Body body) {
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
    body(sa[cur], sb[cur], s, stages);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

// acc[i][j] -= sum_t A(mm_row_index(i, ty), t) * B(mm_col_index(j, tx), t)
// over t < inner, one FMA at a time in t.
// The caller either loads the output tile into acc first (every rounding is
// then at the magnitude of the running remainder C - sum: the wide TRSM) or
// zeroes it and adds partial sums to the tile from `done` (the Cholesky's
// trailing update, 64 inner indices at a time; see chol_solve.cu's header
// for why). Every thread of the block calls it.
// After each stage lands and before its FMAs, hook(stage_a, t0) may read
// the A stage (sa[t][o], inner indices t0 ...); after its FMAs,
// done(s, stages) may use acc (stage s of `stages`). The caller writes acc
// out.
template <bool kAInnerContig, bool kBInnerContig, typename Hook, typename Done>
__device__ __forceinline__ void mm_run(MmAcc& acc, const MmOperand& A, const MmOperand& B,
                                       int inner, MmStage* sa, MmStage* sb, Hook hook, Done done) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  mm_ring<kAInnerContig, kBInnerContig>(A, B, inner, sa, sb, [&](const MmStage& a_s, const MmStage& b_s, int s,
                                                                 int stages) {
    hook(a_s, s * kMmBk);
#pragma unroll
    for (int t = 0; t < kMmBk; ++t) {
      float av[kMmRows], bv[kMmCols];
#pragma unroll
      for (int q = 0; q < kMmRows / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[t][kMmRowRun * q + 4 * ty]);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < kMmCols / 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(&b_s[t][kMmColRun * q + 4 * tx]);
        bv[4 * q] = b.x, bv[4 * q + 1] = b.y, bv[4 * q + 2] = b.z, bv[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < kMmRows; ++i) {
#pragma unroll
        for (int j = 0; j < kMmCols; ++j) acc[i][j] = fmaf(-av[i], bv[j], acc[i][j]);
      }
    }
    done(s, stages);
  });
}

// -- the split bf16 product on the tensor cores (chol_solve.cu) ----------------
//
// mma.sync m16n8k16, A row-major (16 x 16), B column-major (16 x 8), f32
// accumulators. In a warp, lane l = 4 g + q (g = l >> 2, q = l & 3) holds:
//  * A: register r the pair (row g + 8 (r & 1), inner 2q + 8 (r >> 1) and
//    the next inner index), the lower inner index in the low 16 bits;
//  * B: register r the pair (inner 2q + 8 r and the next, column g);
//  * C: entry i at row g + 8 (i >> 1), column 2q + (i & 1).
// A stage stores an operand as s[t][o] (inner index t, outer o): with its
// row of kMmLd = 132 floats, the 32 lanes' reads of one register fall in 32
// distinct banks (132 * 2 = 8 mod 32 per q, + g).

// x0 and x1 (consecutive inner indices) split into hi = bf16(x) and
// lo = bf16(x - hi), both rounded to nearest even, packed as bf16 pairs.
// x - hi is exact in f32: hi is x's nearest bf16.
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 first, __nv_bfloat16 second) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(first)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(second)) << 16);
}

__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = bf16_pair(h0, h1);
  lo = bf16_pair(__float2bfloat16_rn(x0 - __bfloat162float(h0)), __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// d += a b over one 16 x 8 x 16 step, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows m0 .. m0 + 15 (outer indices of the stage) over
// the stage's 16 inner indices, split.
__device__ __forceinline__ void frag_a_split(const MmStage& s, int m0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = m0 + g + 8 * (r & 1), t = 2 * q + 8 * (r >> 1);
    split_pair(s[t][o], s[t + 1][o], hi[r], lo[r]);
  }
}

// The B fragment of columns n0 .. n0 + 7 (outer indices of the stage), split.
__device__ __forceinline__ void frag_b_split(const MmStage& s, int n0, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 2 * q + 8 * r;
    split_pair(s[t][n0 + g], s[t + 1][n0 + g], hi[r], lo[r]);
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

// The thread's own outputs of an output tile held in shared memory, entry
// (i, j) of its acc at ct[(i * kMmCols + j) * kMmThreads + threadIdx.x]: each
// thread touches only its own entries (conflict-free, no barrier), 64 KB
// for the block.
constexpr int kMmTileSmem = kMmRows * kMmCols * kMmThreads * static_cast<int>(sizeof(float));

// Copies the tile at `tile` (row stride ld) into ct with cp.async: entry
// (r, c) where r < rows, c < cols and keep(r, c), 0 elsewhere. The caller
// commits the group.
template <typename Keep>
__device__ __forceinline__ void mm_tile_to_smem(float* ct, const float* tile, int ld, int rows, int cols,
                                                Keep keep) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const int r = mm_row_index(i, ty);
#pragma unroll
    for (int j = 0; j < kMmCols; ++j) {
      const int c = mm_col_index(j, tx);
      const bool in = r < rows && c < cols && keep(r, c);
      cp_async4(&ct[(i * kMmCols + j) * kMmThreads + threadIdx.x], in ? tile + static_cast<size_t>(r) * ld + c : tile,
                in);
    }
  }
}

// ct += acc (one rounding each), then acc = 0.
__device__ __forceinline__ void mm_acc_flush(MmAcc& acc, float* ct) {
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
#pragma unroll
    for (int j = 0; j < kMmCols; ++j) {
      ct[(i * kMmCols + j) * kMmThreads + threadIdx.x] += acc[i][j];
      acc[i][j] = 0.0f;
    }
  }
}

// Writes ct back to the tile: entry (r, c) where r < rows, c < cols and
// keep(r, c).
template <typename Keep>
__device__ __forceinline__ void mm_tile_from_smem(const float* ct, float* tile, int ld, int rows, int cols,
                                                  Keep keep) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const int r = mm_row_index(i, ty);
#pragma unroll
    for (int j = 0; j < kMmCols; ++j) {
      const int c = mm_col_index(j, tx);
      if (r < rows && c < cols && keep(r, c)) {
        tile[static_cast<size_t>(r) * ld + c] = ct[(i * kMmCols + j) * kMmThreads + threadIdx.x];
      }
    }
  }
}

// -- the one-launch dataflow solve (trsm.cu's thin schedule, batched_trsm.cu)
//
// One block solves one 64-row block row i of T X = B for one strip of at
// most kP columns, inside a launch whose blocks take their work from an
// atomic ticket in solve order (`take_ticket`): a block only ever waits on
// work held by blocks that took their tickets before it, so already run,
// and the launch cannot deadlock however the blocks are scheduled.
//
// Off the chain, before any wait, the block loads T_ii and inverts it (one
// column per thread, by substitution), then streams its tiles T_ik for
// every block row k solved before it (register prefetch, one tile ahead)
// and subtracts T_ik x_k as soon as block row k has published x_k: a ready
// flag per block row, released by the producer (__threadfence,
// st.release.gpu) and polled by one consumer thread (ld.acquire.gpu), with
// x_k read through L2 (ld.cg), past a stale L1. On the chain, the diagonal
// step is three parallel products instead of a 64-step substitution:
// y = T_ii^-1 b, then one step of refinement, x = y + T_ii^-1 (b - T_ii y).
// The refinement is what makes the explicit inverse safe: without it, at the
// SVGP path's conditioning (cond(Kuu) ~1e6), applying inverted diagonal
// blocks put the ELBO's q_mu gradient 0.34 off f64 on the kernel route
// against the stock f32 route's 0.029 (H100, tests/test_torch_cuda.py::
// test_svgp_elbo_kernel_route_matches_f64_plain); with it the solve is as
// close to f64 as the substitution. Every elimination starts from the
// right-hand side and subtracts one FMA at a time, in order of k and of the
// inner index.

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The block's ticket from `counter` (one atomicAdd by thread 0), for every
// thread of the block.
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  return ticket;
}

constexpr int kFlowThreads = 256;

// How the 256 threads of a block split the 64 x kP products of a block row
// (kP = 1, 8, or a multiple of 16). A thread owns kRows x kCols outputs,
// rows row(a) and columns col(b), each a run of consecutive indices read as
// one vector from shared memory:
//  * kP = 1: thread (r = tid & 63, q = tid >> 6) owns row r and the inner
//    indices [16 q, 16 q + 16); the four partial sums meet in shared memory;
//  * kP = 8: thread (r, q) owns row r and columns 2 q, 2 q + 1;
//  * kP >= 16: thread (tid >> 4, tid & 15) owns four rows and kP / 16
//    columns: per inner index a warp reads two 16-byte runs of the T tile
//    (broadcasts) and one 128- or 256-byte run of X, for 4 kP / 16 FMAs a
//    thread (at kP = 8 the X read is a broadcast for 2 FMAs, which is why
//    the tile split starts at 16).
template <int kP>
struct FlowShape {
  static_assert(kP == 1 || kP == 8 || kP % 16 == 0, "kP is 1, 8 or a multiple of 16");
  static constexpr bool kTile = kP >= 16;
  static constexpr int kRows = kTile ? 4 : 1;
  static constexpr int kCols = kTile ? kP / 16 : (kP == 1 ? 1 : kP / 4);
  static constexpr int kSplit = kP == 1 ? 4 : 1;  // inner-dimension split
  static constexpr int kInner = kTriBs / kSplit;  // inner indices per thread
  // dynamic shared floats: T_ii, T_ii^-1, the T_ik tile, xs, ys, red, dinv
  static constexpr int kSmemFloats = 3 * kTriBs * kTriLd + 2 * kTriBs * kP + 4 * kTriBs + kTriBs;
  __device__ static int row(int a) { return kTile ? 4 * (threadIdx.x >> 4) + a : threadIdx.x & (kTriBs - 1); }
  __device__ static int col(int b) {
    if (kTile) return kCols * (threadIdx.x & 15) + b;
    return kP == 1 ? 0 : kCols * (threadIdx.x >> 6) + b;
  }
  // whether this thread's sums carry the right-hand side (with the inner
  // split only the first part does)
  __device__ static bool carries() { return kSplit == 1 || (threadIdx.x >> 6) == 0; }
};

// v <- kN consecutive floats at p, as one 16- or 8-byte read where kN is 4 or 2
template <int kN>
__device__ __forceinline__ void load_run(float (&v)[kN], const float* p) {
  if constexpr (kN == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (kN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < kN; ++q) v[q] = p[q];
  }
}

template <int kP>
using FlowAcc = float[FlowShape<kP>::kRows][FlowShape<kP>::kCols];

// acc -= (or += with kAdd) the sum over this thread's inner indices t of
// a[t][row] * xs[t][col] (a holds a tile transposed: a[t][r] = tile[r][t]).
template <int kP, bool kAdd = false>
__device__ __forceinline__ void flow_product(FlowAcc<kP>& acc, const float (*a)[kTriLd], const float (*xs)[kP]) {
  using S = FlowShape<kP>;
  const int t0 = S::kSplit > 1 ? (threadIdx.x >> 6) * S::kInner : 0;
  const int r0 = S::row(0), c0 = S::col(0);
#pragma unroll 16
  for (int tt = 0; tt < S::kInner; ++tt) {
    const int t = t0 + tt;
    float av[S::kRows], xv[S::kCols];
    load_run<S::kRows>(av, &a[t][r0]);
    load_run<S::kCols>(xv, &xs[t][c0]);
#pragma unroll
    for (int i = 0; i < S::kRows; ++i) {
#pragma unroll
      for (int j = 0; j < S::kCols; ++j) acc[i][j] = fmaf(kAdd ? av[i] : -av[i], xv[j], acc[i][j]);
    }
  }
}

// Writes this thread's sums into out (64 x kP); with the inner split the
// four partial sums meet in red. Every thread calls it; it ends with a
// barrier, so out may be read at once.
template <int kP>
__device__ __forceinline__ void flow_store(const FlowAcc<kP>& acc, float (*out)[kP], float* red) {
  using S = FlowShape<kP>;
  if (S::kSplit > 1) {
    const int r = threadIdx.x & (kTriBs - 1), q = threadIdx.x >> 6;
    red[q * kTriBs + r] = acc[0][0];
    __syncthreads();
    if (q == 0) out[r][0] = ((red[r] + red[kTriBs + r]) + red[2 * kTriBs + r]) + red[3 * kTriBs + r];
  } else {
#pragma unroll
    for (int i = 0; i < S::kRows; ++i) {
#pragma unroll
      for (int j = 0; j < S::kCols; ++j) out[S::row(i)][S::col(j)] = acc[i][j];
    }
  }
  __syncthreads();
}

// out = init + or - a * xs over the whole inner dimension (init may be
// null, and out may alias init or xs).
template <int kP, bool kAdd>
__device__ __forceinline__ void flow_matvec(const float (*a)[kTriLd], const float (*xs)[kP], const float (*init)[kP],
                                            float (*out)[kP], float* red) {
  using S = FlowShape<kP>;
  FlowAcc<kP> acc;
#pragma unroll
  for (int i = 0; i < S::kRows; ++i) {
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) {
      acc[i][j] = (init != nullptr && S::carries()) ? init[S::row(i)][S::col(j)] : 0.0f;
    }
  }
  flow_product<kP, kAdd>(acc, a, xs);
  __syncthreads();  // every thread has read xs and init, which out may alias
  flow_store<kP>(acc, out, red);
}

// Solves block row i (the s-th in solve order) of T X = B for columns
// [0, ncols) of one strip, ncols <= kP: T (N, N) lower or upper triangular,
// read as load_tri_tile reads it; B and X row-major with row stride ldx (X
// may be B: in place); ready[k] is block row k's flag, 0 until its x_k is
// in X. smem holds FlowShape<kP>::kSmemFloats floats, 16-byte aligned.
// Rows past N are the identity's, columns past ncols zero; nothing past N
// or ncols is written. Every thread of the block calls it.
template <bool kLower, bool kTrans, int kP>
__device__ __forceinline__ void flow_block_row(const float* __restrict__ T, int N, int ld, const float* B,
                                               float* X, int ldx, int ncols, int* ready, int s,
                                               float* smem) {
  using S = FlowShape<kP>;
  constexpr int kNT = kFlowThreads;
  auto ltd = reinterpret_cast<float (*)[kTriLd]>(smem);                    // T_ii transposed
  auto linv = reinterpret_cast<float (*)[kTriLd]>(smem + kTriBs * kTriLd);  // T_ii^-1 transposed
  auto lt = reinterpret_cast<float (*)[kTriLd]>(smem + 2 * kTriBs * kTriLd);  // each T_ik transposed
  auto xs = reinterpret_cast<float (*)[kP]>(smem + 3 * kTriBs * kTriLd);   // x_k; then right-hand sides
  auto ys = reinterpret_cast<float (*)[kP]>(smem + 3 * kTriBs * kTriLd + kTriBs * kP);  // the first solution
  float* red = smem + 3 * kTriBs * kTriLd + 2 * kTriBs * kP;  // partial sums (kP = 1)
  float* dinv = red + 4 * kTriBs;                              // 1 / T_ii[j][j]

  const int tid = threadIdx.x;
  const int nb = (N + kTriBs - 1) / kTriBs;
  const int i = kLower ? s : nb - 1 - s;
  const int row0 = i * kTriBs;
  const int rows = min(kTriBs, N - row0);

  // T_ii and its inverse (one column per thread, by substitution), before
  // any wait: off the chain
  load_tri_tile<kNT, kTrans, true>(T, N, ld, row0, row0, ltd, true);
  __syncthreads();
  for (int e = tid; e < kTriBs * kTriBs; e += kNT) {  // only the triangle is T's (the products read all)
    const int c = e / kTriBs, rr = e % kTriBs;
    if (kLower ? rr < c : rr > c) ltd[c][rr] = 0.0f;
  }
  if (tid < kTriBs) dinv[tid] = 1.0f / ltd[tid][tid];
  __syncthreads();
  if (tid < kTriBs) {
    float v[kTriBs];
#pragma unroll
    for (int rr = 0; rr < kTriBs; ++rr) v[rr] = rr == tid ? 1.0f : 0.0f;
    substitute<kLower>(v, ltd, dinv);
#pragma unroll
    for (int rr = 0; rr < kTriBs; ++rr) linv[tid][rr] = v[rr];  // linv[t][rr] = (T_ii^-1)[rr][t]
  }

  // acc starts at this thread's entries of B_i and has T_ik x_k subtracted,
  // one FMA at a time
  FlowAcc<kP> acc;
#pragma unroll
  for (int a = 0; a < S::kRows; ++a) {
#pragma unroll
    for (int b = 0; b < S::kCols; ++b) {
      const int r = S::row(a), c = S::col(b);
      acc[a][b] = (r < rows && c < ncols && S::carries()) ? B[static_cast<size_t>(row0 + r) * ldx + c] : 0.0f;
    }
  }

  // the tiles T_ik, one ahead in registers, as load_tri_tile stages them
  constexpr int kIt = kTriBs * kTriBs / kNT;
  float tv[kIt];
  const auto load_tile = [&](int k) {
#pragma unroll
    for (int e4 = 0; e4 < kIt; ++e4) {
      const int e = tid + e4 * kNT;
      const int m = e / kTriBs, n = e % kTriBs;
      const int gr = row0 + (kTrans ? n : m), gc = k * kTriBs + (kTrans ? m : n);
      tv[e4] = (gr < N && gc < N)
                   ? (kTrans ? T[static_cast<size_t>(gc) * ld + gr] : T[static_cast<size_t>(gr) * ld + gc])
                   : 0.0f;
    }
  };
  if (s > 0) load_tile(kLower ? 0 : nb - 1);
  for (int u = 0; u < s; ++u) {
    const int k = kLower ? u : nb - 1 - u;
    if (tid == 0) {
      while (ld_acquire(ready + k) == 0) {
      }
    }
    __syncthreads();  // x_k is published; every thread is done with lt and xs
#pragma unroll
    for (int e4 = 0; e4 < kIt; ++e4) {
      const int e = tid + e4 * kNT;
      const int m = e / kTriBs, n = e % kTriBs;
      lt[kTrans ? m : n][kTrans ? n : m] = tv[e4];  // lt[t][r] = T_ik[r][t]
    }
    for (int e = tid; e < kTriBs * kP; e += kNT) {
      const int t = e / kP, c = e % kP;
      const int gr = k * kTriBs + t;
      xs[t][c] = (c < ncols && gr < N) ? __ldcg(X + static_cast<size_t>(gr) * ldx + c) : 0.0f;
    }
    if (u + 1 < s) load_tile(kLower ? u + 1 : nb - 2 - u);  // in flight during this product
    __syncthreads();
    flow_product<kP>(acc, lt, xs);
  }
  __syncthreads();  // every thread is done with xs

  // the right-hand side b = B_i - sum_k T_ik x_k, into xs
  flow_store<kP>(acc, xs, red);

  // x_i = T_ii^-1 b with one step of refinement, all parallel products:
  // y = T_ii^-1 b, then x = y + T_ii^-1 (b - T_ii y)
  flow_matvec<kP, true>(linv, xs, nullptr, ys, red);
  flow_matvec<kP, false>(ltd, ys, xs, xs, red);
  flow_matvec<kP, true>(linv, xs, ys, xs, red);
#pragma unroll
  for (int a = 0; a < S::kRows; ++a) {
#pragma unroll
    for (int b = 0; b < S::kCols; ++b) {
      const int r = S::row(a), c = S::col(b);
      if (r < rows && c < ncols && S::carries()) X[static_cast<size_t>(row0 + r) * ldx + c] = xs[r][c];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(ready + i, 1);
}

// -- writing row bands of a Gram matrix (gram_operand.cu, gram.cu) ----------

constexpr int kBandRows = 8;       // rows of a band
constexpr int kBandThreads = 256;  // four columns a thread: 1024 columns a sweep

// Writes rows [r0, r1) (r1 - r0 <= kRows) and columns [c0, c1) of out
// (row stride ld): entry (r, c) is value(r, c, d2) with d2 = sum_d (Xr[r][d]
// - Xc[c][d])^2, formed directly from the differences (the same function as
// the TPU's ||x||^2 - 2 x.y + ||y||^2 expansion, without its cancellation
// near d = 0, which sqrt(d^2 + 1e-12) would amplify for the Matern and
// exponential kinds), for r < nr and c < nc, and pad(r, c) elsewhere; a
// band of pad rows only (r0 >= nr) reads no input and forms no d^2, and a
// column at or past nc is neither read nor mapped. Each thread holds four columns'
// coordinates in registers, loaded once per sweep and dimension and used for
// every row of the band (kRows of them, kBandRows unless the caller wants
// shorter bands); a row's coordinate is one load for the whole warp (the
// same address in every lane). Every thread of the block calls it.
//
// kVec (out, ld and c0 16-byte aligned, c1 a multiple of 4): a thread's
// columns are four consecutive ones, each row of four one 16-byte store,
// so a warp writes 512 contiguous bytes a row. Otherwise (any alignment, a
// ragged c1) they are kBandThreads apart and stored one float each: each
// store instruction of a warp still writes 128 contiguous bytes.
template <bool kVec = true, int kRows = kBandRows, typename Value, typename Pad>
__device__ __forceinline__ void gram_band(const float* __restrict__ Xr, int nr, const float* __restrict__ Xc,
                                          int nc, int D, int r0, int r1, int c0, int c1,
                                          float* __restrict__ out, long long ld, Value value, Pad pad) {
  constexpr int kStep = kVec ? 1 : kBandThreads;  // between a thread's columns
  for (int c = c0 + (kVec ? 4 : 1) * threadIdx.x; c < c1; c += 4 * kBandThreads) {
    float d2[kRows][4] = {};
    if (r0 < nr) {
      for (int d = 0; d < D; ++d) {
        float xc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = c + j * kStep;
          xc[j] = cj < nc ? Xc[static_cast<size_t>(cj) * D + d] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q;
          const float xr = r < nr ? Xr[static_cast<size_t>(r) * D + d] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float diff = xr - xc[j];
            d2[q][j] = fmaf(diff, diff, d2[q][j]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = r0 + q;
      if (r >= r1) break;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = c + j * kStep;
        v[j] = (r < nr && cj < nc) ? value(r, cj, d2[q][j]) : pad(r, cj);
      }
      float* row = out + r * ld;
      if (kVec) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j * kStep < c1) row[c + j * kStep] = v[j];
        }
      }
    }
  }
}

}  // namespace gfs
