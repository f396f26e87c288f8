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
// that is a view into its padded buffer (ld = Np) is read in place. The
// ragged edge is masked in the kernels: entries of T outside N x N read as
// the identity on the diagonal blocks and as 0 elsewhere, rows of X past N as
// 0, and nothing past N or P is written; the wrapper pads nothing.
//
// A static rule on P picks one of two schedules (ops/trsm.py states it too):
//
// Thin X (P <= kThinMaxP = 64): one launch for the whole solve. What bounds
// it on an H100 is the chain of N / 64 dependent diagonal solves; the bytes
// (T's triangle, 0.2 GB at N = 10000, 0.06 ms) are far below it, and the
// earlier schedule paid two dependent launches per block row. One block per
// block row, running common.cuh's dataflow body (`flow_block_row`, shared
// with batched_trsm.cu): an atomic ticket orders the block rows, a ready
// flag per block row publishes x_k, T_ii^-1 is formed off the chain and
// applied with one step of refinement. All 256 threads take part in the
// products (at P = 1, four threads per row split the inner dimension). The
// ticket and the flags are scratch from the wrapper, zeroed on the stream
// by the entry before the launch. Measured on an H100: ~2.1 us per block
// row (the flag's and x_k's trips through L2, then the three products),
// against ~6 us with the one-thread substitution on the chain.
//
// Wide X (P > 64): launches ordered by the stream. Updating every remaining
// row after every block column would read and write the rest of X once per
// block column (~12 GB at N = 10000, P = 2048), so the block columns go in
// groups of four. Per group, one launch solves the group's own rows (a
// block per 64-column strip of X, left-looking over the group's block rows:
// 64^3 tile products for the eliminations, then one thread per column
// substituting against T_jj; these launches are not on a single chain, so
// the substitution stays), then one update applies the whole group (an
// inner dimension of 256) to every row beyond it, reading and writing each
// once. The updates are N^2 P FMA-flop (2.0e11 at N = 10000, P = 2048), the
// bound: they run on common.cuh's 128 x 128 product (8 x 8 outputs per
// thread, a cp.async ring), at ~25 TFLOP/s on an H100, set by the
// shared-memory reads per FMA (common.cuh). Solving the next group on a
// second stream while this group's update runs was measured slower: the
// next group's rows then need an update launch of their own, too small to
// fill the card.
//
// Every elimination starts from the right-hand side and subtracts one FMA
// at a time, so its roundings are at the magnitude of the remainder.
//
// Arithmetic: f32 FMA, no tensor cores and no TF32 (the TPU pins these
// products to full f32, pallas_trsm.py:49-53).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBs = gfs::kTriBs;    // block size
constexpr int kThreads = 256;
constexpr int kLd4 = gfs::kTriLd;   // padded shared row that keeps 16-byte alignment for float4
constexpr int kGroup = 4;           // block columns applied together by one wide update
constexpr int kThinMaxP = 64;       // the schedule rule: P <= 64 is thin
constexpr int kMaxGrid = 65535;

// ---------------------------------------------------------------- thin X ---

// One block per block row: the ticket orders the block rows, the body is
// common.cuh's flow_block_row on the whole of X (kP = 1, 8 or 64 columns).
template <bool kLower, bool kTrans, int kP>
__global__ void __launch_bounds__(kThreads)
    trsm_thin_kernel(const float* __restrict__ T, int N, int ld, float* __restrict__ X, int P,
                     int* __restrict__ sync) {
  extern __shared__ __align__(16) float smem[];
  const int s = gfs::take_ticket(sync);  // this block's place in the solve order
  gfs::flow_block_row<kLower, kTrans, kP>(T, N, ld, X, X, P, P, sync + 1, s, smem);
}

template <bool kLower, bool kTrans, int kP>
int solve_thin(const float* T, int N, int ld, float* X, int P, int* sync, cudaStream_t s) {
  constexpr int bytes = gfs::FlowShape<kP>::kSmemFloats * static_cast<int>(sizeof(float));
  const auto kernel = trsm_thin_kernel<kLower, kTrans, kP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sync, 0, ((N + kBs - 1) / kBs + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(N + kBs - 1) / kBs, kThreads, bytes, s>>>(T, N, ld, X, P, sync);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- wide X ---

// Solves the group's own g block rows (k, then onwards in solve order) for
// one 64-column strip of X: for each block row j, X_j <- T_jj^-1 (X_j -
// sum of T_jp X_p over the group's block rows p solved before it). The
// solved rows are read back through the cache (this block wrote them; the
// barriers order the accesses). At most one block per SM: ptxas may then
// give the substitution's 64 values their registers (held to 80, the upper
// variants spilled ~870 bytes; H100, nvcc 12.9).
template <bool kLower, bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
    trsm_group_kernel(const float* __restrict__ T, int N, int ld, int k, int g, float* __restrict__ X,
                      int P) {
  __shared__ __align__(16) float a[kBs][kLd4];   // T_jp, then T_jj transposed
  __shared__ __align__(16) float bt[kBs][kLd4];  // X_p transposed, then the right-hand side transposed
  __shared__ float dinv[kBs];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 qa, columns tx + 16 qb
  const int col0 = blockIdx.x * kBs;
  constexpr int kIt = kBs * kBs / kThreads;
  for (int j = 0; j < g; ++j) {
    const int kj = kLower ? k + j : k - j;
    float acc[4][4] = {};
    for (int p = 0; p < j; ++p) {
      const int kp = kLower ? k + p : k - p;
      __syncthreads();  // every thread is done with a and bt; X_kp is written
      gfs::load_tri_tile<kThreads, kTrans, false>(T, N, ld, kj * kBs, kp * kBs, a, false);
      float xv[kIt];
#pragma unroll
      for (int e4 = 0; e4 < kIt; ++e4) {
        const int e = tid + e4 * kThreads;
        const int gr = kp * kBs + e / kBs, gc = col0 + e % kBs;
        xv[e4] = (gr < N && gc < P) ? X[static_cast<size_t>(gr) * P + gc] : 0.0f;
      }
#pragma unroll
      for (int e4 = 0; e4 < kIt; ++e4) {
        const int e = tid + e4 * kThreads;
        bt[e % kBs][e / kBs] = xv[e4];
      }
      __syncthreads();
      gfs::tile_fma(acc, a, bt, tx, ty);
    }
    __syncthreads();
    // T_jj transposed into a, the right-hand side into bt (bt[c][r])
    gfs::load_tri_tile<kThreads, kTrans, true>(T, N, ld, kj * kBs, kj * kBs, a, true);
#pragma unroll
    for (int qa = 0; qa < 4; ++qa) {
      const int rr = ty + 16 * qa, gr = kj * kBs + rr;
#pragma unroll
      for (int qb = 0; qb < 4; ++qb) {
        const int c = tx + 16 * qb, gc = col0 + c;
        bt[c][rr] = (gr < N && gc < P) ? X[static_cast<size_t>(gr) * P + gc] - acc[qa][qb] : 0.0f;
      }
    }
    __syncthreads();
    if (tid < kBs) dinv[tid] = 1.0f / a[tid][tid];
    __syncthreads();
    // one thread per column of the strip substitutes against T_jj
    const int c = tid, gc = col0 + c, rows = min(kBs, N - kj * kBs);
    if (c < kBs && gc < P) {
      float v[kBs];
#pragma unroll
      for (int rr = 0; rr < kBs; ++rr) v[rr] = bt[c][rr];
      gfs::substitute<kLower>(v, a, dinv);
#pragma unroll
      for (int rr = 0; rr < kBs; ++rr) {
        if (rr < rows) X[static_cast<size_t>(kj * kBs + rr) * P + gc] = v[rr];
      }
    }
  }
}

// X[r0 + r][c] -= sum_{t < depth} T[r0 + r][c0 + t] X[c0 + t][c] for the
// rows r < rows: one 128 x 128 output tile per block, the inner dimension
// (the group's columns) streamed through common.cuh's ring.
template <bool kTrans>
__global__ void __launch_bounds__(gfs::kMmThreads, 2)
    trsm_update_kernel(const float* __restrict__ T, int N, int ld, int c0, int depth, int r0, int rows,
                       float* __restrict__ X, int P) {
  __shared__ __align__(16) gfs::MmStage sa[gfs::kMmStages];
  __shared__ __align__(16) gfs::MmStage sb[gfs::kMmStages];
  const int row_base = r0 + blockIdx.y * gfs::kMmTile;
  const int col_base = blockIdx.x * gfs::kMmTile;
  const int inner = min(depth, N - c0);
  gfs::MmOperand A;  // (o, t) = T[row_base + o][c0 + t]
  if (kTrans) {
    A = {T + static_cast<size_t>(c0) * ld + row_base, 1, ld, min(r0 + rows, N) - row_base, inner};
  } else {
    A = {T + static_cast<size_t>(row_base) * ld + c0, ld, 1, min(r0 + rows, N) - row_base, inner};
  }
  const gfs::MmOperand B = {X + static_cast<size_t>(c0) * P + col_base, 1, P, P - col_base, inner};
  float* const tile = X + static_cast<size_t>(row_base) * P + col_base;
  gfs::MmAcc acc;  // the X tile, less the product
  gfs::mm_tile_io<false>(acc, tile, P, A.outer, B.outer, [](int, int) { return true; });
  gfs::mm_run<!kTrans, false>(acc, A, B, inner, sa, sb, [](const gfs::MmStage&, int) {},
                               [](int, int) {});
  gfs::mm_tile_io<true>(acc, tile, P, A.outer, B.outer, [](int, int) { return true; });
}

template <bool kLower, bool kTrans>
int solve_wide(const float* T, int N, int ld, float* X, int P, cudaStream_t s) {
  const int nb = (N + kBs - 1) / kBs;
  const unsigned strips = static_cast<unsigned>((P + kBs - 1) / kBs);
  const unsigned col_tiles = static_cast<unsigned>((P + gfs::kMmTile - 1) / gfs::kMmTile);
  for (int step = 0; step < nb; step += kGroup) {
    const int g = min(kGroup, nb - step);          // block columns in this group
    const int k = kLower ? step : nb - 1 - step;  // its first block column
    trsm_group_kernel<kLower, kTrans><<<strips, kThreads, 0, s>>>(T, N, ld, k, g, X, P);
    // the rows beyond the group, and the group's columns
    const int r0 = kLower ? (k + g) * kBs : 0;
    const int rows = kLower ? N - r0 : (k - g + 1) * kBs;
    const int c0 = kLower ? k * kBs : (k - g + 1) * kBs;
    if (rows > 0) {
      const dim3 grid(col_tiles, static_cast<unsigned>((rows + gfs::kMmTile - 1) / gfs::kMmTile));
      trsm_update_kernel<kTrans><<<grid, gfs::kMmThreads, 0, s>>>(T, N, ld, c0, g * kBs, r0, rows, X, P);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <bool kLower, bool kTrans>
int solve(const float* T, int N, int ld, float* X, int P, int* sync, cudaStream_t s) {
  if (P > kThinMaxP) return solve_wide<kLower, kTrans>(T, N, ld, X, P, s);
  if (P == 1) return solve_thin<kLower, kTrans, 1>(T, N, ld, X, P, sync, s);
  if (P <= 8) return solve_thin<kLower, kTrans, 8>(T, N, ld, X, P, sync, s);
  return solve_thin<kLower, kTrans, kThinMaxP>(T, N, ld, X, P, sync, s);
}

}  // namespace

// Solves T X = B in place in X (N, P), row-major. T is lower (lower != 0)
// or upper triangular; trans != 0 reads it transposed from L (see above).
// sync: for P <= 64, ceil(N / 64) + 1 ints of scratch (the ticket, then one
// ready flag per block row), zeroed here on the stream; unused for P > 64.
extern "C" int gfs_trsm(const float* L, int N, int ld, int trans, int lower, float* X, int P, int* sync,
                        void* stream) {
  if (N < 1 || P < 1 || ld < N || (P <= kThinMaxP && sync == nullptr) ||
      (N + gfs::kMmTile - 1) / gfs::kMmTile > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lower) {
    return trans ? solve<true, true>(L, N, ld, X, P, sync, s) : solve<true, false>(L, N, ld, X, P, sync, s);
  }
  return trans ? solve<false, true>(L, N, ld, X, P, sync, s) : solve<false, false>(L, N, ld, X, P, sync, s);
}
