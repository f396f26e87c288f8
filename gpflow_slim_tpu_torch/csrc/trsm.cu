// Blocked triangular solve with a wide right-hand side, in place:
// X <- T^-1 X, T (N, N) lower or upper triangular, X (N, P) row-major,
// any N >= 1 and P >= 1.
//
// Replaces the TPU kernel gpflow_slim_tpu/ops/pallas_trsm.py
// `_make_trsm_kernel` (launched by `_trsm_pallas`).
//
// T is read through a leading dimension `ld` and a transpose flag: the
// logical T[i][j] is L[i * ld + j], or L[j * ld + i] when transposed. So the
// upper solve of the posterior, solve_upper(L.T, .), reads the row-major
// factor L itself, without a 400 MB copy of L.T at N = 10000, and a factor
// that is a view into its padded buffer (ld = Np) is read in place.
//
// The TPU kernel walks the block rows in order, inverting each 64 x 64
// diagonal triangle once and applying it and the eliminations as matrix-unit
// products. Here the right-hand-side columns are independent, so every
// launch splits over 64-column tiles of X; the block rows are ordered by the
// stream, two launches per block column k:
//  (a) diag: X_k <- T_kk^-1 X_k. One thread per column keeps its 64 values
//      in registers and substitutes against T_kk, stored transposed in
//      shared memory (every thread of a warp reads the same T entries: a
//      broadcast, 16 bytes at a time), column by column, so the dependent
//      chain is one multiply (by the row's reciprocal pivot, computed
//      beforehand by one thread per row) and one FMA per row, with no
//      barrier in it;
//  (b) update: X_i -= T_ik X_k for the block rows i still to solve (below k
//      for a lower T, above k for an upper one), one block per (i, column
//      tile): a shared-memory tiled FMA product with 4 x 4 outputs per
//      thread and 16-byte reads along the inner dimension, as in
//      chol_solve.cu's trailing update.
// Updating every remaining row after every block column would read and
// write the rest of X once per block column (~12 GB at N = 10000,
// P = 2048). So for an X wider than one column tile the block columns go
// in groups of four: inside a group, (a) and a small (b) over the group's
// own rows; then one (b) applies the whole group (an inner dimension of
// 256) to all the rows beyond it, reading and writing each of them once per
// group.
// Both launches stage their tiles through registers, every load issued
// before the first shared store, so a block waits for device memory once
// and not once per element (a thin X, P = 1, is bound by that latency).
// The ragged edge is masked in the kernel: entries of T outside N x N read
// as the identity on the diagonal block and as 0 elsewhere, rows of X past N
// as 0, and nothing past N or P is written; the wrapper pads nothing.
//
// Arithmetic: f32 FMA, no tensor cores and no TF32 (the TPU pins these
// products to full f32, pallas_trsm.py:49-53).
//
// What bounds it on an H100: for a wide X (P = 2048 at N = 10000) the
// N^2 P / 2 FMAs of the updates (1.0e11) at the rate of a simple tiled
// kernel without tensor cores, plus X's traffic; for a thin X (P = 1) the
// chain of 2 N / 64 dependent launches, each a few memory latencies long.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBs = gfs::kTriBs;   // block size
constexpr int kDiagThreads = kBs;  // diag: one column of X per thread, one pivot per thread
constexpr int kThreads = 256;      // update: 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd4 = gfs::kTriLd;  // padded shared row that keeps 16-byte alignment for float4
constexpr int kGroup = 4;          // block columns applied together by one wide update
constexpr int kMaxGridY = 65535;

template <bool kLower, bool kTrans>
__global__ void __launch_bounds__(kDiagThreads)
    trsm_diag_kernel(const float* __restrict__ T, int N, int ld, int k, float* __restrict__ X, int P) {
  __shared__ __align__(16) float lt[kBs][kLd4];  // T_kk transposed: lt[c][r] = T_kk[r][c]
  __shared__ float dinv[kBs];                     // 1 / T_kk[j][j]
  const int row0 = k * kBs;
  gfs::load_tri_tile<kDiagThreads, kTrans, true>(T, N, ld, row0, row0, lt, true);
  __syncthreads();
  // the divisions leave the dependent chain: one reciprocal per row, all at
  // once (kDiagThreads == kBs), then a multiply in the chain
  dinv[threadIdx.x] = 1.0f / lt[threadIdx.x][threadIdx.x];
  __syncthreads();
  const int c = blockIdx.x * kDiagThreads + threadIdx.x;
  if (c >= P) return;
  const int rows = min(kBs, N - row0);
  float v[kBs];
#pragma unroll
  for (int r = 0; r < kBs; ++r) v[r] = r < rows ? X[static_cast<size_t>(row0 + r) * P + c] : 0.0f;
  gfs::substitute<kLower>(v, lt, dinv);
#pragma unroll
  for (int r = 0; r < kBs; ++r) {
    if (r < rows) X[static_cast<size_t>(row0 + r) * P + c] = v[r];
  }
}

// X_i -= sum_{d < depth} T_{i, k_d} X_{k_d} for the block rows i = i0 +
// blockIdx.y, with k_d = k0 + d for a lower T and k0 - d for an upper one:
// the contributions of `depth` solved block columns, accumulated in
// registers, so X_i is read and written once for all of them.
template <bool kLower, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    trsm_update_kernel(const float* __restrict__ T, int N, int ld, int k0, int depth, int i0,
                       float* __restrict__ X, int P) {
  __shared__ __align__(16) float a[kBs][kLd4];   // T_ik
  __shared__ __align__(16) float bt[kBs][kLd4];  // X_k transposed: bt[c][t] = X_k[t][c]
  const int tid = threadIdx.x;
  const int i = i0 + blockIdx.y;
  const int col0 = blockIdx.x * kBs;
  // rows ty + 16 qa, columns tx + 16 qb of the tile
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4] = {};
  for (int d = 0; d < depth; ++d) {
    const int k = kLower ? k0 + d : k0 - d;
    if (d > 0) __syncthreads();  // every thread is done with the previous tiles
    gfs::load_tri_tile<kThreads, kTrans, false>(T, N, ld, i * kBs, k * kBs, a, false);
    constexpr int kIt = kBs * kBs / kThreads;
    float xv[kIt];  // all loads in flight before the first store
#pragma unroll
    for (int q = 0; q < kIt; ++q) {
      const int e = tid + q * kThreads;
      const int gr = k * kBs + e / kBs, gc = col0 + e % kBs;
      xv[q] = (gr < N && gc < P) ? X[static_cast<size_t>(gr) * P + gc] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kIt; ++q) {
      const int e = tid + q * kThreads;
      bt[e % kBs][e / kBs] = xv[q];
    }
    __syncthreads();
    gfs::tile_fma(acc, a, bt, tx, ty);
  }
#pragma unroll
  for (int qa = 0; qa < 4; ++qa) {
    const int r = i * kBs + ty + 16 * qa;
    if (r >= N) break;
#pragma unroll
    for (int qb = 0; qb < 4; ++qb) {
      const int c = col0 + tx + 16 * qb;
      if (c < P) X[static_cast<size_t>(r) * P + c] -= acc[qa][qb];
    }
  }
}

// The block columns are solved in groups: within a group, each diag launch
// is followed by a depth-1 update of the group's own rows still to solve;
// then one update applies the whole group to every row beyond it. The
// grouping saves X traffic, which is proportional to P: an X of one column
// tile (P <= 64) is solved one block column at a time (measured at P = 1 on
// an H100, groups of four were 18% slower; at P = 2048, 12% faster).
template <bool kLower, bool kTrans>
int solve(const float* T, int N, int ld, float* X, int P, cudaStream_t s) {
  const int nb = (N + kBs - 1) / kBs;
  const unsigned diag_blocks = static_cast<unsigned>((P + kDiagThreads - 1) / kDiagThreads);
  const unsigned col_tiles = static_cast<unsigned>((P + kBs - 1) / kBs);
  const int group = col_tiles > 1 ? kGroup : 1;
  const auto update = [&](int k0, int depth, int i0, int rows) {
    if (rows > 0) {
      const dim3 grid(col_tiles, static_cast<unsigned>(rows));
      trsm_update_kernel<kLower, kTrans><<<grid, kThreads, 0, s>>>(T, N, ld, k0, depth, i0, X, P);
    }
  };
  for (int step = 0; step < nb; step += group) {
    const int g = min(group, nb - step);          // block columns in this group
    const int k = kLower ? step : nb - 1 - step;  // its first block column
    for (int j = 0; j < g; ++j) {
      const int kj = kLower ? k + j : k - j;
      trsm_diag_kernel<kLower, kTrans><<<diag_blocks, kDiagThreads, 0, s>>>(T, N, ld, kj, X, P);
      // the group's rows after kj (in solve order)
      update(kj, 1, kLower ? kj + 1 : k - g + 1, g - 1 - j);
    }
    update(k, g, kLower ? k + g : 0, kLower ? nb - k - g : k - g + 1);  // the rows beyond the group
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Solves T X = B in place in X (N, P), row-major. T is lower (lower != 0)
// or upper triangular; trans != 0 reads it transposed from L (see above).
extern "C" int gfs_trsm(const float* L, int N, int ld, int trans, int lower, float* X, int P,
                        void* stream) {
  if (N < 1 || P < 1 || ld < N || (N + kBs - 1) / kBs - 1 > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lower) {
    return trans ? solve<true, true>(L, N, ld, X, P, s) : solve<true, false>(L, N, ld, X, P, s);
  }
  return trans ? solve<false, true>(L, N, ld, X, P, s) : solve<false, false>(L, N, ld, X, P, s);
}
