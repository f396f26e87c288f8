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
// block row; a block takes its block row from an atomic ticket, in solve
// order, so it only ever waits on block rows held by blocks that already
// run and the launch cannot deadlock however the blocks are scheduled.
// Block row i inverts T_ii first (one column per thread, by substitution;
// off the chain), then streams its tiles T_ik for every solved k (register
// prefetch, one tile ahead) and subtracts T_ik x_k as soon as block row k
// has published x_k: a ready flag per block row, released by the producer
// (__threadfence, st.release.gpu) and polled by one consumer thread
// (ld.acquire.gpu), with x_k read through L2 (ld.cg), past a stale L1. All
// 256 threads take part in the products (at P = 1, four threads per row
// split the inner dimension). The diagonal step on the chain is three
// parallel products instead of a 64-step substitution: y = T_ii^-1 b, then
// one step of refinement, x = y + T_ii^-1 (b - T_ii y). The refinement is
// what makes the explicit inverse safe: without it, at the SVGP path's
// conditioning (cond(Kuu) ~1e6), applying inverted diagonal blocks put the
// ELBO's q_mu gradient 0.34 off f64 on the kernel route against the stock
// f32 route's 0.029 (H100, tests/test_torch_cuda.py::
// test_svgp_elbo_kernel_route_matches_f64_plain); with it the solve is as
// close to f64 as the substitution. The ticket and the flags are scratch
// the wrapper zeroes per call. Measured on an H100: ~2.1 us per block row
// (the flag's and x_k's trips through L2, then the three products), against
// ~6 us with the one-thread substitution on the chain.
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

// Columns of X the thin kernel is compiled for (1, 8 or 64), and how its
// 256 threads split the products: thread (r = tid & 63, q = tid >> 6) owns
// row r of the block row; with kP > 1 it owns columns q, q + 4, ..., with
// kP = 1 it owns the inner indices [16 q, 16 q + 16), and the four partial
// sums are added in shared memory.
template <int kP>
struct ThinShape {
  static constexpr int kGroups = kP < 4 ? 1 : 4;  // column groups
  static constexpr int kSplit = 4 / kGroups;      // inner-dimension split
  static constexpr int kCols = kP / kGroups;      // columns per thread
  static constexpr int kInner = kBs / kSplit;     // inner indices per thread
  // dynamic shared floats: T_ii, T_ii^-1, the T_ik tile, xs, ys, red, dinv
  static constexpr int kSmemFloats = 3 * kBs * kLd4 + 2 * kBs * kP + 4 * kBs + kBs;
};

template <int kP>
__device__ __forceinline__ int thin_col(int q, int j) {
  return ThinShape<kP>::kGroups > 1 ? q + ThinShape<kP>::kGroups * j : j;
}

// acc[j] -= (or += with kAdd) sum over this thread's inner indices t of
// a[t][r] * xs[t][col j] (a holds a tile transposed: a[t][r] = tile[r][t]).
template <int kP, bool kAdd = false>
__device__ __forceinline__ void thin_product(float (&acc)[ThinShape<kP>::kCols], const float (*a)[kLd4],
                                             const float (*xs)[kP], int r, int q) {
  using S = ThinShape<kP>;
  const int t0 = S::kSplit > 1 ? q * S::kInner : 0;
#pragma unroll 16
  for (int tt = 0; tt < S::kInner; ++tt) {
    const int t = t0 + tt;
    const float av = kAdd ? a[t][r] : -a[t][r];
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc[j] = fmaf(av, xs[t][thin_col<kP>(q, j)], acc[j]);
  }
}

// Writes this thread's sums acc into out (64 x kP); with the inner split
// the four partial sums meet in red. Every thread calls it; it ends with a
// barrier, so out may be read at once.
template <int kP>
__device__ __forceinline__ void thin_store(const float (&acc)[ThinShape<kP>::kCols], float (*out)[kP],
                                           float* red, int r, int q) {
  if (ThinShape<kP>::kSplit > 1) {
    red[q * kBs + r] = acc[0];
    __syncthreads();
    if (q == 0) out[r][0] = ((red[r] + red[kBs + r]) + red[2 * kBs + r]) + red[3 * kBs + r];
  } else {
#pragma unroll
    for (int j = 0; j < ThinShape<kP>::kCols; ++j) out[r][thin_col<kP>(q, j)] = acc[j];
  }
  __syncthreads();
}

// acc (this thread's entries of out, rows r) = init + or - a * xs over the
// whole inner dimension, written to out by thin_store.
template <int kP, bool kAdd>
__device__ __forceinline__ void thin_matvec(const float (*a)[kLd4], const float (*xs)[kP],
                                            const float (*init)[kP], float (*out)[kP], float* red, int r,
                                            int q) {
  using S = ThinShape<kP>;
  float acc[S::kCols];
#pragma unroll
  for (int j = 0; j < S::kCols; ++j) {
    acc[j] = (init != nullptr && (S::kSplit == 1 || q == 0)) ? init[r][thin_col<kP>(q, j)] : 0.0f;
  }
  thin_product<kP, kAdd>(acc, a, xs, r, q);
  __syncthreads();  // every thread has read xs and init, which out may alias
  thin_store<kP>(acc, out, red, r, q);
}

template <bool kLower, bool kTrans, int kP>
__global__ void __launch_bounds__(kThreads)
    trsm_thin_kernel(const float* __restrict__ T, int N, int ld, float* __restrict__ X, int P,
                     int* __restrict__ sync) {
  using S = ThinShape<kP>;
  extern __shared__ __align__(16) float smem[];
  auto ltd = reinterpret_cast<float (*)[kLd4]>(smem);                 // T_ii transposed
  auto linv = reinterpret_cast<float (*)[kLd4]>(smem + kBs * kLd4);    // T_ii^-1 transposed
  auto lt = reinterpret_cast<float (*)[kLd4]>(smem + 2 * kBs * kLd4);  // each T_ik transposed
  auto xs = reinterpret_cast<float (*)[kP]>(smem + 3 * kBs * kLd4);    // x_k; then right-hand sides
  auto ys = reinterpret_cast<float (*)[kP]>(smem + 3 * kBs * kLd4 + kBs * kP);  // the first solution
  float* red = smem + 3 * kBs * kLd4 + 2 * kBs * kP;                     // partial sums (kP = 1)
  float* dinv = red + 4 * kBs;                                           // 1 / T_ii[j][j]
  __shared__ int ticket;

  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  int* ready = sync + 1;
  const int nb = (N + kBs - 1) / kBs;
  const int s = ticket;  // this block's place in the solve order
  const int i = kLower ? s : nb - 1 - s;
  const int row0 = i * kBs;
  const int rows = min(kBs, N - row0);
  const int r = tid & (kBs - 1), q = tid >> 6;

  // T_ii and its inverse (one column per thread, by substitution), before
  // any wait: off the chain
  gfs::load_tri_tile<kThreads, kTrans, true>(T, N, ld, row0, row0, ltd, true);
  __syncthreads();
  for (int e = tid; e < kBs * kBs; e += kThreads) {  // only the triangle is T's (the products read all)
    const int c = e / kBs, rr = e % kBs;
    if (kLower ? rr < c : rr > c) ltd[c][rr] = 0.0f;
  }
  if (tid < kBs) dinv[tid] = 1.0f / ltd[tid][tid];
  __syncthreads();
  if (tid < kBs) {
    float v[kBs];
#pragma unroll
    for (int rr = 0; rr < kBs; ++rr) v[rr] = rr == tid ? 1.0f : 0.0f;
    gfs::substitute<kLower>(v, ltd, dinv);
#pragma unroll
    for (int rr = 0; rr < kBs; ++rr) linv[tid][rr] = v[rr];  // linv[t][rr] = (T_ii^-1)[rr][t]
  }

  // acc starts at this thread's entries of B_i (with the inner split, only
  // q = 0 carries them) and has T_ik x_k subtracted, one FMA at a time
  float acc[S::kCols];
#pragma unroll
  for (int j = 0; j < S::kCols; ++j) {
    const int c = thin_col<kP>(q, j);
    acc[j] = (r < rows && c < P && (S::kSplit == 1 || q == 0)) ? X[static_cast<size_t>(row0 + r) * P + c]
                                                                : 0.0f;
  }

  // the tiles T_ik, one ahead in registers, as load_tri_tile stages them
  constexpr int kIt = kBs * kBs / kThreads;
  float tv[kIt];
  const auto load_tile = [&](int k) {
#pragma unroll
    for (int e4 = 0; e4 < kIt; ++e4) {
      const int e = tid + e4 * kThreads;
      const int m = e / kBs, n = e % kBs;
      const int gr = row0 + (kTrans ? n : m), gc = k * kBs + (kTrans ? m : n);
      tv[e4] = (gr < N && gc < N)
                   ? (kTrans ? T[static_cast<size_t>(gc) * ld + gr] : T[static_cast<size_t>(gr) * ld + gc])
                   : 0.0f;
    }
  };
  if (s > 0) load_tile(kLower ? 0 : nb - 1);
  for (int u = 0; u < s; ++u) {
    const int k = kLower ? u : nb - 1 - u;
    if (tid == 0) {
      while (gfs::ld_acquire(ready + k) == 0) {
      }
    }
    __syncthreads();  // x_k is published; every thread is done with lt and xs
#pragma unroll
    for (int e4 = 0; e4 < kIt; ++e4) {
      const int e = tid + e4 * kThreads;
      const int m = e / kBs, n = e % kBs;
      lt[kTrans ? m : n][kTrans ? n : m] = tv[e4];  // lt[t][r] = T_ik[r][t]
    }
    for (int e = tid; e < kBs * kP; e += kThreads) {
      const int t = e / kP, c = e % kP;
      const int gr = k * kBs + t;
      xs[t][c] = (c < P && gr < N) ? __ldcg(X + static_cast<size_t>(gr) * P + c) : 0.0f;
    }
    if (u + 1 < s) load_tile(kLower ? u + 1 : nb - 2 - u);  // in flight during this product
    __syncthreads();
    thin_product<kP>(acc, lt, xs, r, q);
  }
  __syncthreads();  // every thread is done with xs

  // the right-hand side b = B_i - sum_k T_ik x_k, into xs
  thin_store<kP>(acc, xs, red, r, q);

  // x_i = T_ii^-1 b with one step of refinement, all parallel products:
  // y = T_ii^-1 b, then x = y + T_ii^-1 (b - T_ii y)
  thin_matvec<kP, true>(linv, xs, nullptr, ys, red, r, q);
  thin_matvec<kP, false>(ltd, ys, xs, xs, red, r, q);
  thin_matvec<kP, true>(linv, xs, ys, xs, red, r, q);
#pragma unroll
  for (int j = 0; j < S::kCols; ++j) {
    const int c = thin_col<kP>(q, j);
    if (r < rows && c < P && (S::kSplit == 1 || q == 0)) X[static_cast<size_t>(row0 + r) * P + c] = xs[r][c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) gfs::st_release(ready + i, 1);
}

template <bool kLower, bool kTrans, int kP>
int solve_thin(const float* T, int N, int ld, float* X, int P, int* sync, cudaStream_t s) {
  constexpr int bytes = ThinShape<kP>::kSmemFloats * static_cast<int>(sizeof(float));
  const auto kernel = trsm_thin_kernel<kLower, kTrans, kP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  gfs::mm_run<!kTrans, false>(acc, A, B, inner, sa, sb, [](const gfs::MmStage&, int) {});
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
// sync: for P <= 64, ceil(N / 64) + 1 ints of scratch the caller zeroes (the
// ticket, then one ready flag per block row); unused for P > 64.
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
