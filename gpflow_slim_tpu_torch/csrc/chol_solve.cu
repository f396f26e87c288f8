// Blocked Cholesky factor in place, K = L L^T, in two modes:
//  * fused (gfs_chol_solve_logdet): with the forward solve alpha = L^-1 D
//    and half_logdet = sum log diag L, for the exact-GPR objective;
//  * factor only (gfs_cholesky): no right-hand side (P = 0, alpha null)
//    and no logdet, for the posterior's factor. The same launches run,
//    with their right-hand-side and logdet work switched off.
//
// Replaces the TPU kernels gpflow_slim_tpu/ops/pallas_cholesky.py
// `_make_chol_kernel(fuse_p=P)` (launched by `_cholesky_solve_pallas`) and
// `_make_chol_kernel(fuse_p=None)` (launched by `_cholesky_pallas`).
//
// Right-looking, with 256-wide outer panels of four 64 x 64 blocks (the
// last panel may be narrower: Np is a multiple of 64 only). An outer panel
// is factored from 64-wide steps, each three launches:
//  1. diag (one block): factor A_bb in f64, write L_bb, store sum log diag
//     L_bb into partials[b], and forward-substitute alpha_b <- L_bb^-1
//     alpha_b (any P, 8 columns at a time);
//  2. panel (one block per row block i > b): L_ib = A_ib L_bb^-T, each row
//     substituted in registers by its own thread, then alpha_i -= L_ib
//     alpha_b for all P columns (only block i writes alpha_i: no race);
//  3. inner update (one block per 64 x 64 lower tile of the panel's later
//     columns): A_ij -= L_ib L_jb^T, so the panel's next step sees them.
// Then the trailing update applies the whole panel (an inner dimension of
// 256) to the lower triangle beyond it in 128 x 128 tiles: in mode "hi" on
// chol_trailing_kernel_hi, persistent blocks with a pipeline of their own
// (below); in the split modes on common.cuh's mm_ring.
// A last one-thread launch sums the partials in order, so the logdet is
// deterministic (no atomics).
//
// What bounds it on an H100, and what the design does about it:
//  * the trailing traffic: each trailing launch reads and rewrites the
//    remaining lower triangle. With 64-wide panels that is about
//    4 N^3 / (3 * 64) bytes, 21 GB at N = 10048 (6.3 ms at 3.35 TB/s, more
//    than the 5.05 ms flop bound); 256-wide panels cut it to ~5 GB (the
//    TPU kernel's x2 schedule halves the same traffic,
//    pallas_cholesky.py:331-336);
//  * the trailing flop, N^3 / 3 FMA-pairs, most of the time, and with it
//    the SM's shared-memory pipe (one 128-byte wavefront a clock): an 8 x 8
//    register tile reads A and B as 16-byte loads, each 2 wavefronts where
//    a quarter-warp reads one address and 4 otherwise, so 12 wavefronts
//    for a warp's 2048 FMAs, 16 clocks at the FMA rate (tools/
//    smem_bench.cu); staging, the transpose and the running tile's flushes
//    add ~45% to that. chol_trailing_kernel_hi runs at ~26-27 TFLOP/s in
//    place and ~31 alone at N = 10048 (the mm_run kernel it replaced: ~22
//    and ~26);
//  * the serial chain of diag, panel and inner-update launches (157 steps
//    at N = 10048). The diag factor is blocked by 16 columns: warp 0
//    factors each 16 x 16 sub-block in registers with shuffles, one row
//    per lane, so the block needs 16 barriers, not 64 steps of two (21 us
//    per block alone on an H100; 64 us with a column per thread in
//    registers and a barrier per step). The panel solve substitutes
//    column by column with reciprocal pivots (one multiply and one FMA per
//    column on the chain). One panel of look-ahead
//    takes the chain off the critical path while the trailing update is
//    long: after panel p is applied to panel p + 1's columns, panel p + 1
//    is factored on a second stream of the highest priority while the rest
//    of panel p's trailing update runs on the caller's stream; the two join
//    through events (created once per device) before the next trailing
//    update and before the entry point returns. The persistent trailing
//    blocks hold every SM for the whole update, so each leaves room beside
//    it for one block of the chain (at most 160 registers a thread and ~161
//    KB of shared memory): at 163-167 registers the panel kernel's blocks
//    no longer fit and ~1.5 ms more of the chain showed at N = 10048; at
//    128, two chain blocks fit but the update ran 11% slower (H100).
//
// Arithmetic (mode "hi", the default): f32 FMA for the panels and the
// trailing products; no tensor cores and no TF32. The split modes of the TPU
// kernel (`syrk` "s3"/"s4", pallas_cholesky.py:320-355, 577-596) run the
// trailing products off the diagonal tiles on the bf16 tensor cores instead:
// each f32 operand split into bf16 hi + lo, 3 or 4 products of the halves
// summed in f32 (trailing_split; with "d", the diagonal tiles keep the f32
// product). The TPU kernel's "x2" suffix, its two-panel schedule, is the
// same arithmetic in another order, whose purpose the 256-wide panels serve:
// it runs as its base mode. Everything else below holds in every mode: the
// panels, the diagonal blocks and the in-panel updates stay f32 (f64 for the
// diagonal blocks), and so do the pivots. The logdet error of an
// f32 factorization is about sum_i (K^-1)_ii dK_ii, so it is set by the
// rounding of the diagonal entries, which a right-looking schedule
// re-rounds once per update. The diagonal is therefore kept in a separate
// f64 array (`dpiv`, updated by the diagonal tiles of every update: sums of
// squares of f32 factor entries, in f64), and each 64 x 64 diagonal block is
// factored in f64. At N = 10000 this takes the half-logdet error from about
// 1.4e-5 to a few 1e-6 relative. The off-diagonal entries stay f32, and
// their updates are sums of 64 products from zero, each added to the entry
// once (the inner updates with tile_fma, the trailing ones 64 inner indices
// at a time, into the tile held in shared memory for the whole panel). Starting from the entry and subtracting one FMA at a time biased
// the logdet on an ill-conditioned K: the late products of a row fall below
// half an ulp of the running entry and are lost, all with one sign for two
// nearly dependent rows, while their f64 pivots lose nothing, so the small
// eigenvalues of every Schur complement shrink. On a 64 x 32 grid's RBF
// Gram + 1e-4 I (Np = 2048, cond 1.1e6) that put the half-logdet 3.99e-4
// off the f64 factor of the same f32 input, 10x cuSOLVER's 4.2e-5; the
// 64-term sums put it 3.5e-5 off (tools/chol_logdet_diag.py). A sum from
// zero loses nothing of its small terms; a 256-term sum added once rounds
// at the magnitude of the whole panel's product, 1e-4 off on the same grid,
// and an f64 copy of the 64 x 64 diagonal blocks keeps 60% of the bias
// (tools/chol_order_emulate.py). Holding the tile in shared memory keeps
// its global traffic at one read and one write a panel: the four 64-term
// flushes read and wrote it in global memory 4x as often, 33% slower at
// N = 10048 (H100). A non-positive pivot gives NaN (sqrt of a negative)
// and never traps, as the TPU and XLA paths do.
//
// Operand contract (ops/gram.py's operand for the fused mode, the padding of
// ops/cholesky.py `cholesky` for the factor-only mode): K is the padded
// operand, Np a multiple of 64, with a unit-diagonal pad extension; only
// its lower triangle is read, and strictly-upper entries outside the
// diagonal 64 x 64 blocks are never touched. Pad rows have zero
// off-diagonal entries and zero right-hand sides, so their alpha rows stay
// exactly 0 and their logdet terms are log 1 = 0.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBs = 64;       // block size
constexpr int kPanel = 4;     // blocks per outer panel (256 columns)
constexpr int kThreads = 256;
constexpr int kPChunk = 8;    // alpha columns held per thread per sweep
constexpr int kLd = kBs + 1;  // padded shared row: column walks hit distinct banks
constexpr int kLd4 = kBs + 4; // padded shared row that keeps 16-byte alignment for float4
constexpr int kSub = 16;      // columns of a sub-panel of the diag factor

__global__ void pivot_init_kernel(const float* __restrict__ K, int Np, double* __restrict__ dpiv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Np) dpiv[i] = K[static_cast<size_t>(i) * Np + i];
}

// The 64 x 64 diagonal block in f64, blocked by 16 columns so that most of
// its 64 dependent steps need no block-wide barrier. For each 16-column
// sub-panel s: (1) warp 0 factors the 16 x 16 diagonal sub-block in
// registers, one row per lane, the pivot and the column broadcast by
// shuffles; (2) one thread per row below substitutes its row against it
// (L_rs = A_rs L_ss^-T, column by column, reciprocal pivots); (3) all
// threads update the lower triangle below and right of it. Four barriers per
// sub-panel, sixteen in all. Then alpha_k <- L_kk^-1 alpha_k in chunks of 8
// columns, blocked the same way, and the logdet partial.
__global__ void __launch_bounds__(kThreads)
    chol_diag_kernel(float* __restrict__ K, int Np, int k, float* __restrict__ alpha, int P,
                     const double* __restrict__ dpiv, double* __restrict__ partials) {
  __shared__ double a[kBs][kLd];         // the block; L_kk when done (lower triangle)
  __shared__ double al[kBs][kPChunk];    // one chunk of alpha_k
  __shared__ double rdiag[kBs];          // 1 / L_jj
  __shared__ double red[kBs];
  const int tid = threadIdx.x;
  float* Akk = K + static_cast<size_t>(k) * kBs * Np + static_cast<size_t>(k) * kBs;
  float* alk = alpha + static_cast<size_t>(k) * kBs * P;

  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, c = e % kBs;
    a[r][c] = (c < r) ? Akk[static_cast<size_t>(r) * Np + c] : (c == r ? dpiv[k * kBs + r] : 0.0);
  }
  __syncthreads();

  for (int s = 0; s < kBs; s += kSub) {
    // (1) the sub-block's factor; lanes 16-31 mirror 0-15 (the shuffles
    // then read defined values everywhere). rsqrt of a negative pivot is
    // NaN, and so is everything after it.
    if (tid < 32) {
      const int l = tid & (kSub - 1);
      double row[kSub];
#pragma unroll
      for (int c = 0; c < kSub; ++c) row[c] = a[s + l][s + c];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const double inv = rsqrt(__shfl_sync(0xffffffffu, row[j], j));
        const double lj = row[j] * inv;  // L_lj for l > j; L_jj = d / sqrt(d) for l == j
        row[j] = lj;
        if (l == j) rdiag[s + j] = inv;
#pragma unroll
        for (int c = j + 1; c < kSub; ++c) {
          const double lcj = __shfl_sync(0xffffffffu, lj, c);
          row[c] = l >= c ? fma(-lj, lcj, row[c]) : row[c];
        }
      }
      if (tid < kSub) {
#pragma unroll
        for (int c = 0; c < kSub; ++c) {
          if (c <= l) a[s + l][s + c] = row[c];
        }
      }
    }
    __syncthreads();
    const int below = kBs - s - kSub;  // rows below the sub-block
    // (2) the rows below: x L_ss^T = a_r, column by column
    if (tid < below) {
      const int r = s + kSub + tid;
      double v[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) v[j] = a[r][s + j];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        v[j] *= rdiag[s + j];
#pragma unroll
        for (int i = j + 1; i < kSub; ++i) v[i] = fma(-v[j], a[s + i][s + j], v[i]);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) a[r][s + j] = v[j];
    }
    __syncthreads();
    // (3) the lower triangle below and right of the sub-block, up to
    // ceil(48^2 / 256) = 9 entries per thread, their sums interleaved
    if (below > 0) {
      constexpr int kMaxQ = ((kBs - kSub) * (kBs - kSub) + kThreads - 1) / kThreads;
      double acc[kMaxQ];
      int rr[kMaxQ], cc[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int e = tid + q * kThreads;
        rr[q] = s + kSub + e / below;
        cc[q] = s + kSub + e % below;
        const bool live = e < below * below && cc[q] <= rr[q];
        if (!live) rr[q] = cc[q] = s + kSub;  // a harmless entry, not written
        acc[q] = live ? a[rr[q]][cc[q]] : 0.0;
        if (!live) cc[q] = -1;
      }
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int c = cc[q] < 0 ? rr[q] : cc[q];
          acc[q] = fma(-a[rr[q]][s + t], a[c][s + t], acc[q]);
        }
      }
      __syncthreads();  // every thread has read the entries it needs
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (cc[q] >= 0) a[rr[q]][cc[q]] = acc[q];
      }
    }
    __syncthreads();
  }

  // L_kk to K (upper entries 0), its logdet partial
  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, c = e % kBs;
    Akk[static_cast<size_t>(r) * Np + c] = c <= r ? static_cast<float>(a[r][c]) : 0.0f;
  }
  if (partials != nullptr) {  // uniform over the block: the barriers are safe
    if (tid < kBs) red[tid] = log(a[tid][tid]);
    __syncthreads();
    for (int h = kBs / 2; h > 0; h >>= 1) {
      if (tid < h) red[tid] += red[tid + h];
      __syncthreads();
    }
    if (tid == 0) partials[k] = red[0];
  }

  // alpha_k <- L_kk^-1 alpha_k, 8 columns at a time: per sub-panel, one
  // thread per column substitutes its 16 rows, then all threads update the
  // rows below
  for (int p0 = 0; p0 < P; p0 += kPChunk) {
    const int pc = min(P - p0, kPChunk);
    for (int e = tid; e < kBs * pc; e += kThreads) al[e / pc][e % pc] = alk[(e / pc) * P + p0 + e % pc];
    __syncthreads();
    for (int s = 0; s < kBs; s += kSub) {
      if (tid < pc) {
        double v[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) v[j] = al[s + j][tid];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          v[j] *= rdiag[s + j];
#pragma unroll
          for (int i = j + 1; i < kSub; ++i) v[i] = fma(-v[j], a[s + i][s + j], v[i]);
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) al[s + j][tid] = v[j];
      }
      __syncthreads();
      const int below = kBs - s - kSub;
      for (int e = tid; e < below * pc; e += kThreads) {
        const int r = s + kSub + e / pc, p = e % pc;
        double v = al[r][p];
#pragma unroll
        for (int t = 0; t < kSub; ++t) v = fma(-a[r][s + t], al[s + t][p], v);
        al[r][p] = v;
      }
      __syncthreads();
    }
    for (int e = tid; e < kBs * pc; e += kThreads) {
      alk[(e / pc) * P + p0 + e % pc] = static_cast<float>(al[e / pc][e % pc]);
    }
    __syncthreads();  // the next chunk's load overwrites al
  }
}

__global__ void __launch_bounds__(kThreads)
    chol_panel_kernel(float* __restrict__ K, int Np, int k, float* __restrict__ alpha, int P) {
  __shared__ __align__(16) float lt[kBs][kLd4];  // L_kk transposed: lt[c][r] = L_kk[r][c]
  __shared__ float x[kBs][kLd];                  // A_ik, overwritten by L_ik
  __shared__ float dinv[kBs];                    // 1 / L_jj
  const int tid = threadIdx.x;
  const int i = k + 1 + blockIdx.x;
  float* Aik = K + static_cast<size_t>(i) * kBs * Np + static_cast<size_t>(k) * kBs;

  gfs::load_tri_tile<kThreads, false, true>(K, Np, Np, k * kBs, k * kBs, lt, false);
  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, c = e % kBs;
    x[r][c] = Aik[static_cast<size_t>(r) * Np + c];
  }
  __syncthreads();
  if (tid < kBs) dinv[tid] = 1.0f / lt[tid][tid];
  __syncthreads();

  // X L_kk^T = A row by row: thread r solves L_kk x_r^T = a_r^T in
  // registers, column by column (gfs::substitute): the dependent chain is
  // one multiply and one FMA per column; every thread reads the same L_kk
  // entries at the same time (a shared-memory broadcast).
  if (tid < kBs) {
    float v[kBs];
#pragma unroll
    for (int j = 0; j < kBs; ++j) v[j] = x[tid][j];
    gfs::substitute<true>(v, lt, dinv);
#pragma unroll
    for (int j = 0; j < kBs; ++j) x[tid][j] = v[j];
  }
  __syncthreads();

  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, cc = e % kBs;
    Aik[static_cast<size_t>(r) * Np + cc] = x[r][cc];
  }
  // alpha_i -= L_ik alpha_k; alpha_k (64 x P) was written by the diag
  // launch and is read through the cache
  const float* alk = alpha + static_cast<size_t>(k) * kBs * P;
  float* ali = alpha + static_cast<size_t>(i) * kBs * P;
  for (int e = tid; e < kBs * P; e += kThreads) {
    const int r = e / P, p = e % P;
    float s = 0.0f;
    for (int t = 0; t < kBs; ++t) s = fmaf(x[r][t], alk[t * P + p], s);
    ali[e] -= s;
  }
}

// Inside an outer panel: A_ij -= L_ik L_jk^T for the blocks j = k + 1 +
// blockIdx.y of the panel's later columns and i = k + 1 + blockIdx.x >= j.
// A diagonal tile also subtracts its rows' f64 pivot terms (one block per
// tile, so no two blocks touch the same entry).
__global__ void __launch_bounds__(kThreads)
    chol_inner_update_kernel(float* __restrict__ K, int Np, int k, double* __restrict__ dpiv) {
  __shared__ __align__(16) float li[kBs][kLd4];  // L_ik
  __shared__ __align__(16) float lj[kBs][kLd4];  // L_jk
  const int i = k + 1 + blockIdx.x;
  const int j = k + 1 + blockIdx.y;
  if (i < j) return;  // uniform over the block
  const int tid = threadIdx.x;
  const float* Lik = K + static_cast<size_t>(i) * kBs * Np + static_cast<size_t>(k) * kBs;
  const float* Ljk = K + static_cast<size_t>(j) * kBs * Np + static_cast<size_t>(k) * kBs;
  float* Aij = K + static_cast<size_t>(i) * kBs * Np + static_cast<size_t>(j) * kBs;

  // 16-byte loads: Np and the block offsets are multiples of 64 floats and
  // the wrapper checks that K is 16-byte aligned
  for (int e = tid; e < kBs * kBs / 4; e += kThreads) {
    const int r = e / (kBs / 4), c4 = 4 * (e % (kBs / 4));
    *reinterpret_cast<float4*>(&li[r][c4]) =
        *reinterpret_cast<const float4*>(Lik + static_cast<size_t>(r) * Np + c4);
    *reinterpret_cast<float4*>(&lj[r][c4]) =
        *reinterpret_cast<const float4*>(Ljk + static_cast<size_t>(r) * Np + c4);
  }
  __syncthreads();

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4] = {};
  gfs::tile_fma(acc, li, lj, tx, ty);
  if (i == j && tid < kBs) {
    double s = 0.0;
    for (int t = 0; t < kBs; ++t) {
      const double v = li[tid][t];
      s = fma(v, v, s);
    }
    dpiv[static_cast<size_t>(i) * kBs + tid] -= s;
  }
#pragma unroll
  for (int qa = 0; qa < 4; ++qa) {
#pragma unroll
    for (int qb = 0; qb < 4; ++qb) {
      const size_t off = static_cast<size_t>(ty + 16 * qa) * Np + tx + 16 * qb;
      Aij[off] -= acc[qa][qb];
    }
  }
}

// The exact f32 trailing product of one 128 x 128 tile (row0, col0): A_IJ -=
// L_IP L_JP^T on mm_run, for the split "d" modes' diagonal tiles (mode "hi"
// runs chol_trailing_kernel_hi). Entries of a strictly-upper 64 x 64 block
// are not written. A diagonal tile subtracts its rows' f64 pivot terms, summed in
// f64 from the A stages as they land.
__device__ __forceinline__ void trailing_fma(float* __restrict__ K, int Np, int p0, int width, int row0, int col0,
                                             bool diag, double* __restrict__ dpiv, gfs::MmStage* sa,
                                             gfs::MmStage* sb, float* ct) {
  double piv = 0.0;  // thread o < 128 of a diagonal tile: sum_t L[row0 + o][p0 + t]^2
  // A_IJ, less the product: entries of a strictly-upper 64 x 64 block are
  // neither read nor written (only a diagonal tile has them). The tile is
  // copied into shared memory while the ring fills; the sum of each 64
  // inner indices starts from zero and is added to it there once (the
  // header says why), and the tile is written back at the end.
  float* const tile = K + static_cast<size_t>(row0) * Np + col0;
  const auto kept = [&](int r, int c) { return !diag || c / kBs <= r / kBs; };
  gfs::mm_tile_to_smem(ct, tile, Np, Np - row0, Np - col0, kept);  // ct: the running A_IJ (common.cuh)
  gfs::cp_async_commit();  // mm_run's first wait covers this group
  const gfs::MmOperand A = {K + static_cast<size_t>(row0) * Np + p0, Np, 1, Np - row0, width};
  const gfs::MmOperand B = {K + static_cast<size_t>(col0) * Np + p0, Np, 1, Np - col0, width};
  gfs::MmAcc acc = {};
  gfs::mm_run<true, true>(
      acc, A, B, width, sa, sb,
      [&](const gfs::MmStage& s, int t0) {
        if (diag && threadIdx.x < gfs::kMmTile) {
          const int n = min(gfs::kMmBk, width - t0);
          for (int t = 0; t < n; ++t) {
            const double v = s[t][threadIdx.x];
            piv = fma(v, v, piv);
          }
        }
      },
      [&](int s, int stages) {
        if (((s + 1) * gfs::kMmBk) % kBs == 0 || s + 1 == stages) gfs::mm_acc_flush(acc, ct);
      });
  if (diag && threadIdx.x < gfs::kMmTile && row0 + static_cast<int>(threadIdx.x) < Np) {
    dpiv[row0 + threadIdx.x] -= piv;
  }
  gfs::mm_tile_from_smem(ct, tile, Np, Np - row0, Np - col0, kept);
}

// -- the exact trailing update (mode "hi"): chol_trailing_kernel_hi ----------
//
// The same arithmetic as trailing_fma, on a pipeline of its own. Persistent
// blocks walk the launch's 128 x 128 lower tiles with a static stride (tile
// blockIdx.x + k gridDim.x, k = 0, 1, ...), and the inner dimension of all
// of a block's tiles runs through one ring of kTrStages stages: while a
// tile's last stages are multiplied, the next tile's first stages fly. The
// running tile lives in shared memory, row-major. When the block's next
// tile starts, each thread writes back its 16-byte chunks of the running
// tile and at once refills them from the next tile (no barrier between: a
// thread's copy into a chunk is issued after its own read of it); the next
// tile is first needed at its first flush, 64 inner indices later. So a
// tile's load and store hide behind the FMAs, not only behind another block.
//
// The panel's rows come in by 16-byte cp.async, four inner indices of one
// row a copy, kTrBk inner indices a stage, into the ring as they lie in
// memory ([row][inner], the 16-byte chunks of each row permuted by
// tr_at). During a stage's FMAs (from its second inner index, so that the
// loads' latency hides behind them) the block transposes the next stage,
// landed, into [inner][row] (a double buffer of MmStages): 4 16-byte loads
// and 16 4-byte stores a thread, conflict-free. The FMAs run
// on mm_run's 8 x 8 register tile and thread map, which reads each inner
// index of A and B as two 16-byte loads apiece: 51 TFLOP/s with its
// operands resident in shared memory on an H100, against 39 for the same
// tile read along [row][inner] (four inner indices of a row a load, 32 more
// live registers), both at 128 registers (tools/smem_bench.cu).
//
// One block an SM: 157 registers a thread (ptxas, sm_90a) and ~161 KB of
// shared memory leave room beside it for a block of the chain (diag, panel
// or inner update: 256 threads, 58-94 registers, 34-38 KB), which the
// look-ahead's high-priority stream runs during the update; one SM is left
// out of the grid (hi_grid).
constexpr int kTrThreads = gfs::kMmThreads;
constexpr int kTrBk = gfs::kMmBk;         // inner indices a stage
constexpr int kTrStages = 4;              // stages in the ring
constexpr int kTrChunks = kTrBk / 4;      // 16-byte chunks of a staged row
constexpr int kTrRowFloats = gfs::kMmTile * kTrBk;     // one operand's staged stage
constexpr int kTrPerTile = kPanel * kBs / kTrBk;       // stages a tile
constexpr int kTrFlush = kBs / kTrBk;                  // stages a flush
constexpr int kTrSmem = static_cast<int>(
    sizeof(float) * (gfs::kMmTile * gfs::kMmTile + 2 * kTrStages * kTrRowFloats) + 4 * sizeof(gfs::MmStage));
static_assert(kTrChunks == 4, "a staged row is 64 bytes");
// the running tile's copies go with the group of the stage kTrStages after
// the tile's first, which has landed by the tile's first flush
static_assert(kTrStages <= kTrFlush, "the running tile lands before its first flush");

// Where chunk c of staged row o lies: the chunks of the two rows that share
// 128 bytes are permuted (TMA's 64-byte swizzle) so that 8 consecutive rows
// at one chunk fall in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int tr_at(int o, int c) { return o * kTrBk + 4 * (c ^ ((o >> 1) & 3)); }

// A block's walk over the lower tiles of a launch: tile columns J0 .. J0 +
// ncols - 1 (every tile column from J0 when ncols is 0) of R tile rows from
// J0, tile t = (ti, tj), I = J0 + ti, J = J0 + tj, row-major over the lower
// triangle when ncols is 0 (tri_index), else column by column; the block
// takes tiles blockIdx.x, + G, + 2 G, ...
struct TrWalk {
  int ti, tj;
  __device__ void start(long long t, int R, int ncols) {
    if (ncols == 0) {
      gfs::tri_index(t, ti, tj);
      return;
    }
    tj = 0;
    while (t >= R - tj) {
      t -= R - tj;
      ++tj;
    }
    ti = tj + static_cast<int>(t);
  }
  __device__ void next(int G, int R, int ncols) {
    if (ncols == 0) {
      for (tj += G; tj > ti; ++ti) tj -= ti + 1;
    } else {
      for (ti += G; ti >= R; ti += tj - R) ++tj;
    }
  }
};

long long tr_tiles(int R, int ncols) {
  if (ncols == 0) return static_cast<long long>(R) * (R + 1) / 2;
  long long n = 0;
  for (int tj = 0; tj < ncols; ++tj) n += R - tj;
  return n;
}

// A_IJ -= L_IP L_JP^T over the panel's 256 columns (p0 ...) for the tiles of
// the launch (TrWalk; ntiles of them), entries of a strictly-upper 64 x 64
// block neither read nor written. Each output's sum of 64 inner indices
// starts from zero, runs in ascending t, and is added to the running tile
// once, in chunk order (the header says why); a diagonal tile subtracts its
// rows' f64 pivot terms, summed from its A stages in ascending t.
__global__ void __launch_bounds__(kTrThreads, 1)
    chol_trailing_kernel_hi(float* __restrict__ K, int Np, int p0, int J0, int ncols, long long ntiles,
                            double* __restrict__ dpiv) {
  extern __shared__ __align__(16) float tr_smem[];
  float* const ct = tr_smem;                                      // the running A_IJ, row-major
  float* const ring = ct + gfs::kMmTile * gfs::kMmTile;           // stage g: A, then B, at slot g % kTrStages
  gfs::MmStage* const ts = reinterpret_cast<gfs::MmStage*>(ring + 2 * kTrStages * kTrRowFloats);  // [A, B] x 2
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int R = (Np + gfs::kMmTile - 1) / gfs::kMmTile - J0;
  const int G = static_cast<int>(gridDim.x);
  if (blockIdx.x >= ntiles) return;  // uniform over the block
  const int total = static_cast<int>((ntiles - blockIdx.x + G - 1) / G) * kTrPerTile;  // stages of the block

  // the copies of stage g of the tile w: 128 rows of kTrBk inner indices of
  // each operand, rows past Np zero
  const auto load_stage = [&](int g, const TrWalk& w) {
    float* const sa = ring + (g % kTrStages) * 2 * kTrRowFloats;
    const int t = p0 + (g % kTrPerTile) * kTrBk;
    const int row0 = (J0 + w.ti) * gfs::kMmTile, col0 = (J0 + w.tj) * gfs::kMmTile;
#pragma unroll
    for (int q = 0; q < gfs::kMmTile * kTrChunks / kTrThreads; ++q) {
      const int e = tid + q * kTrThreads, o = e / kTrChunks, c = e % kTrChunks;
      const bool a_in = row0 + o < Np, b_in = col0 + o < Np;
      gfs::cp_async16(sa + tr_at(o, c), a_in ? K + static_cast<size_t>(row0 + o) * Np + t + 4 * c : K, a_in);
      gfs::cp_async16(sa + kTrRowFloats + tr_at(o, c), b_in ? K + static_cast<size_t>(col0 + o) * Np + t + 4 * c : K,
                      b_in);
    }
  };
  // stage g from the ring into ts[2 (g % 2)] (A) and ts[2 (g % 2) + 1] (B),
  // s[t][o]: a warp takes 32 consecutive rows at one chunk
  const auto transpose = [&](int g) {
    const float* const sa = ring + (g % kTrStages) * 2 * kTrRowFloats;
#pragma unroll
    for (int q = 0; q < 2 * gfs::kMmTile * kTrChunks / kTrThreads; ++q) {
      const int e = tid + q * kTrThreads, op = e / (gfs::kMmTile * kTrChunks);
      const int o = e % gfs::kMmTile, c = (e / gfs::kMmTile) % kTrChunks;
      const float4 v = *reinterpret_cast<const float4*>(sa + op * kTrRowFloats + tr_at(o, c));
      gfs::MmStage& s = ts[2 * (g % 2) + op];
      s[4 * c][o] = v.x;
      s[4 * c + 1][o] = v.y;
      s[4 * c + 2][o] = v.z;
      s[4 * c + 3][o] = v.w;
    }
  };
  // this thread's 16-byte chunks of the running tile (a warp takes one
  // row's 32): written back to the tile `done` (unless null) and refilled
  // from the tile `next` (unless null), each where the tile's entries exist
  // and are not strictly upper (Np and the 64 x 64 blocks are multiples of
  // 4 columns)
  const auto turn = [&](const TrWalk* done, const TrWalk* next) {
#pragma unroll 4
    for (int q = 0; q < gfs::kMmTile * gfs::kMmTile / 4 / kTrThreads; ++q) {
      const int e = tid + q * kTrThreads, r = e / (gfs::kMmTile / 4), c = 4 * (e % (gfs::kMmTile / 4));
      float* const s = ct + r * gfs::kMmTile + c;
      const auto at = [&](const TrWalk& w, bool& in) {
        const int row0 = (J0 + w.ti) * gfs::kMmTile, col0 = (J0 + w.tj) * gfs::kMmTile;
        in = row0 + r < Np && col0 + c < Np && (w.ti != w.tj || c / kBs <= r / kBs);
        return K + static_cast<size_t>(row0 + r) * Np + col0 + c;
      };
      bool in;
      if (done != nullptr) {
        float* const g = at(*done, in);
        if (in) *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(s);
      }
      if (next != nullptr) {
        const float* const g = at(*next, in);
        gfs::cp_async16(s, in ? g : K, in);
      }
    }
  };

  TrWalk cw, iw;  // the tile being multiplied, the tile being loaded
  cw.start(blockIdx.x, R, ncols);
  iw = cw;
  int issue = 0;  // the next stage to load
  const auto issue_next = [&]() {
    if (issue < total) {
      if (issue % kTrPerTile == 0 && issue > 0) iw.next(G, R, ncols);
      load_stage(issue, iw);
    }
    ++issue;
    gfs::cp_async_commit();
  };
  for (int st = 0; st < kTrStages; ++st) issue_next();
  gfs::cp_async_wait<kTrStages - 1>();
  __syncthreads();
  transpose(0);
  gfs::MmAcc acc = {};
  double piv = 0.0;  // thread o < 128 of a diagonal tile: sum_t L[row0 + o][p0 + t]^2
  for (int g = 0; g < total; ++g) {
    const int s = g % kTrPerTile;
    gfs::cp_async_wait<kTrStages - 2>();
    // stage g + 1 has landed and stage g is transposed; every thread is done
    // with the FMAs of stage g - 1 and the transpose of stage g, whose ring
    // slot is refilled below, and with the last tile's last flush
    __syncthreads();
    if (s == 0) {  // the running tile's copies go with the group committed below
      if (g == 0) {
        turn(nullptr, &cw);
      } else {
        const TrWalk done = cw;
        cw.next(G, R, ncols);
        turn(&done, &cw);
      }
    }
    issue_next();

    const gfs::MmStage& a_s = ts[2 * (g % 2)];
    const gfs::MmStage& b_s = ts[2 * (g % 2) + 1];
    const bool diag = cw.ti == cw.tj;
    if (diag && tid < gfs::kMmTile) {
#pragma unroll
      for (int t = 0; t < kTrBk; ++t) {
        const double v = a_s[t][tid];
        piv = fma(v, v, piv);
      }
    }
#pragma unroll
    for (int t = 0; t < kTrBk; ++t) {
      float av[gfs::kMmRows], bv[gfs::kMmCols];
#pragma unroll
      for (int q = 0; q < gfs::kMmRows / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[t][gfs::kMmRowRun * q + 4 * ty]);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < gfs::kMmCols / 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(&b_s[t][gfs::kMmColRun * q + 4 * tx]);
        bv[4 * q] = b.x, bv[4 * q + 1] = b.y, bv[4 * q + 2] = b.z, bv[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < gfs::kMmRows; ++i) {
#pragma unroll
        for (int j = 0; j < gfs::kMmCols; ++j) acc[i][j] = fmaf(-av[i], bv[j], acc[i][j]);
      }
      // the next stage's transpose, its loads' latency behind the FMAs
      if (t == 1 && g + 1 < total) transpose(g + 1);
    }
    if ((s + 1) % kTrFlush == 0) {
      // this thread's outputs: runs of four columns, a 16-byte access each
#pragma unroll
      for (int i = 0; i < gfs::kMmRows; ++i) {
#pragma unroll
        for (int q = 0; q < gfs::kMmCols / 4; ++q) {
          float4* const c = reinterpret_cast<float4*>(ct + gfs::mm_row_index(i, ty) * gfs::kMmTile +
                                                      gfs::mm_col_index(4 * q, tx));
          float4 v = *c;
          v.x += acc[i][4 * q];
          v.y += acc[i][4 * q + 1];
          v.z += acc[i][4 * q + 2];
          v.w += acc[i][4 * q + 3];
          *c = v;
#pragma unroll
          for (int j = 4 * q; j < 4 * q + 4; ++j) acc[i][j] = 0.0f;
        }
      }
    }
    if (s == kTrPerTile - 1 && diag && tid < gfs::kMmTile) {
      const int row = (J0 + cw.ti) * gfs::kMmTile + tid;
      if (row < Np) dpiv[row] -= piv;
      piv = 0.0;
    }
  }
  __syncthreads();  // every thread's last flush
  turn(&cw, nullptr);
}

// The split trailing product: a block takes a 128 x kPart part of a
// 128 x 128 tile (64 columns: two blocks a tile), its 8 warps 4 x 2 of
// 32 x 32 outputs, each 2 x 4 MMA tiles of 16 x 8 (kSplitMt x kSplitNt),
// with two accumulators of 32 f32 a thread (hh apart from the small
// passes); a whole tile would need 128 registers for them alone. Even so
// the split kernel does not fit the 128 registers of two blocks an SM
// without spilling (ptxas for sm_90a: 128-136 bytes a thread, the operand
// splits' temporaries), so it runs one block an SM with ~227 registers.
// What bounds it on an H100 is not the tensor cores: it runs at ~17-18
// TFLOP/s of one-pass work alone, "s3" within 5% of "s4"; not forming the
// lo halves saves 12-14%, and two blocks an SM, spills and all, 17-20%
// (tools/split_diag.py). The suspects are the 2-stage ring of 16-deep
// stages, filled by 4-byte copies, at one block an SM, and the A stage
// that both parts of a tile load (PERF.md): a deeper ring needs dynamic
// shared memory, and `wgmma` fed by TMA would lift both.
constexpr int kSplitMt = 2, kSplitNt = 4;
constexpr int kPart = 2 * 8 * kSplitNt;             // columns of a block's part of the tile
constexpr int kParts = gfs::kMmTile / kPart;         // blocks a tile
constexpr int kSplitOut = kSplitMt * kSplitNt * 4;  // outputs a thread
using SplitAcc = float[kSplitMt][kSplitNt][4];

// Row and column (within the part) of this thread's output e = (mt *
// kSplitNt + nt) * 4 + i: entry i of the C fragment of MMA tile (mt, nt).
__device__ __forceinline__ void split_entry(int e, int& r, int& c) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int mt = e / (kSplitNt * 4), nt = (e / 4) % kSplitNt, i = e % 4;
  r = 32 * (warp & 3) + 16 * mt + g + 8 * (i >> 1);
  c = kPart / 2 * (warp >> 2) + 8 * nt + 2 * q + (i & 1);
}

// The running part of the tile in shared memory, as mm_tile_to_smem keeps a
// whole one: this thread's output e at ct[e * kMmThreads + threadIdx.x].
template <typename Keep>
__device__ __forceinline__ void split_tile_to_smem(float* ct, const float* tile, int ld, int rows, int cols,
                                                   Keep keep) {
#pragma unroll
  for (int e = 0; e < kSplitOut; ++e) {
    int r, c;
    split_entry(e, r, c);
    const bool in = r < rows && c < cols && keep(r, c);
    gfs::cp_async4(&ct[e * gfs::kMmThreads + threadIdx.x], in ? tile + static_cast<size_t>(r) * ld + c : tile, in);
  }
}

template <typename Keep>
__device__ __forceinline__ void split_tile_from_smem(const float* ct, float* tile, int ld, int rows, int cols,
                                                     Keep keep) {
#pragma unroll
  for (int e = 0; e < kSplitOut; ++e) {
    int r, c;
    split_entry(e, r, c);
    if (r < rows && c < cols && keep(r, c)) {
      tile[static_cast<size_t>(r) * ld + c] = ct[e * gfs::kMmThreads + threadIdx.x];
    }
  }
}

// ct -= x + hh (the small passes first, in f32 on the CUDA cores); then
// both are 0.
__device__ __forceinline__ void split_flush(SplitAcc& hh, SplitAcc& x, float* ct) {
#pragma unroll
  for (int mt = 0; mt < kSplitMt; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kSplitNt; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& c = ct[((mt * kSplitNt + nt) * 4 + i) * gfs::kMmThreads + threadIdx.x];
        c -= x[mt][nt][i] + hh[mt][nt][i];
        hh[mt][nt][i] = 0.0f;
        x[mt][nt][i] = 0.0f;
      }
    }
  }
}

// The split trailing product of part h of the tile (row0, col0): A_IJ -=
// hh + hl + lh (+ ll when kPasses is 4) over the panel, each 16 inner
// indices one MMA step of each pass, the operands split as their fragments
// are read from the f32 stages. As in trailing_fma, each 64 inner indices
// are summed from zero and added to the tile in shared memory once; the
// hh pass and the small ones are summed apart, and each MMA step from zero,
// added to its accumulator in f32 rounded to nearest, since the tensor
// core's f32 accumulation may truncate, one way, the small terms that the
// header's f32 FMA chains lost: on fault l's grid (K + 1e-4 I) the "s4"
// half-logdet was 7x further off f64 with the steps chained in the tensor
// core in two accumulators, 15x in one (tools/split_diag.py's "chained"
// and "one_accumulator" variants, H100). The f64 pivots of a diagonal tile (part 0) are summed
// from the f32 stages before any split, so they are exact in every mode.
template <int kPasses>
__device__ __forceinline__ void trailing_split(float* __restrict__ K, int Np, int p0, int width, int row0, int col0,
                                               int h, bool diag, double* __restrict__ dpiv, gfs::MmStage* sa,
                                               gfs::MmStage* sb, float* ct) {
  const int c0 = col0 + kPart * h;
  float* const tile = K + static_cast<size_t>(row0) * Np + c0;
  // the part's columns lie in one 64 x 64 block column of the tile: on a
  // diagonal tile, its rows above that block are strictly upper
  const auto kept = [&](int r, int) { return !diag || kPart * h / kBs <= r / kBs; };
  split_tile_to_smem(ct, tile, Np, Np - row0, Np - c0, kept);
  gfs::cp_async_commit();  // mm_ring's first wait covers this group
  const gfs::MmOperand A = {K + static_cast<size_t>(row0) * Np + p0, Np, 1, Np - row0, width};
  const gfs::MmOperand B = {K + static_cast<size_t>(c0) * Np + p0, Np, 1, min(kPart, Np - c0), width};
  const bool pivots = diag && h == 0;
  const int warp = threadIdx.x >> 5, m0 = 32 * (warp & 3), n0 = kPart / 2 * (warp >> 2);
  double piv = 0.0;
  SplitAcc hh = {}, x = {};
  gfs::mm_ring<true, true>(A, B, width, sa, sb, [&](const gfs::MmStage& as, const gfs::MmStage& bs, int s,
                                                    int stages) {
    if (pivots && threadIdx.x < gfs::kMmTile) {
      const int n = min(gfs::kMmBk, width - s * gfs::kMmBk);
      for (int t = 0; t < n; ++t) {
        const double v = as[t][threadIdx.x];
        piv = fma(v, v, piv);
      }
    }
    uint32_t ah[kSplitMt][4], al[kSplitMt][4];
#pragma unroll
    for (int mt = 0; mt < kSplitMt; ++mt) gfs::frag_a_split(as, m0 + 16 * mt, ah[mt], al[mt]);
#pragma unroll
    for (int nt = 0; nt < kSplitNt; ++nt) {
      uint32_t bh[2], bl[2];
      gfs::frag_b_split(bs, n0 + 8 * nt, bh, bl);
#pragma unroll
      for (int mt = 0; mt < kSplitMt; ++mt) {
        float t[4] = {}, u[4] = {};
        gfs::mma_bf16(t, ah[mt], bh);
        gfs::mma_bf16(u, ah[mt], bl);
        gfs::mma_bf16(u, al[mt], bh);
        if (kPasses == 4) gfs::mma_bf16(u, al[mt], bl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hh[mt][nt][i] += t[i];
          x[mt][nt][i] += u[i];
        }
      }
    }
    if (((s + 1) * gfs::kMmBk) % kBs == 0 || s + 1 == stages) split_flush(hh, x, ct);
  });
  if (pivots && threadIdx.x < gfs::kMmTile && row0 + static_cast<int>(threadIdx.x) < Np) {
    dpiv[row0 + threadIdx.x] -= piv;
  }
  split_tile_from_smem(ct, tile, Np, Np - row0, Np - c0, kept);
}

// The split modes' trailing update after an outer panel (columns [p0, p0 +
// width)): A_IJ -= L_IP L_JP^T over 128 x 128 lower tiles (I >= J, in units
// of 128) of the tile columns J0 .. J0 + ncols - 1 (all when ncols = 0: the
// tiles then enumerate the lower triangle from J0 by blockIdx.x), rows to
// Np: the bf16 split in kPasses = 3 or 4 passes (trailing_split), one block
// an SM, each tile in kParts parts (blockIdx.z), but for the diagonal tiles
// when exact_diag (the "d" modes), which part 0 takes whole on trailing_fma.
template <int kPasses>
__global__ void __launch_bounds__(gfs::kMmThreads, 1)
    chol_trailing_kernel(float* __restrict__ K, int Np, int p0, int width, int J0, int ncols,
                         double* __restrict__ dpiv, bool exact_diag) {
  __shared__ __align__(16) gfs::MmStage sa[gfs::kMmStages];
  __shared__ __align__(16) gfs::MmStage sb[gfs::kMmStages];
  extern __shared__ float ct[];  // the running A_IJ, this thread's entries (common.cuh)
  int ti, tj;
  if (ncols == 0) {
    gfs::tri_index(blockIdx.x, ti, tj);
  } else {
    ti = blockIdx.x;
    tj = blockIdx.y;
    if (ti < tj) return;  // uniform over the block
  }
  const int I = J0 + ti, J = J0 + tj;
  const int row0 = I * gfs::kMmTile, col0 = J * gfs::kMmTile;
  const bool diag = I == J;
  const int h = static_cast<int>(blockIdx.z);
  if (diag && exact_diag) {  // uniform over the block, as every branch here
    if (h == 0) trailing_fma(K, Np, p0, width, row0, col0, diag, dpiv, sa, sb, ct);
  } else if (col0 + kPart * h < Np) {  // a last tile of 64 columns has no parts beyond them
    trailing_split<kPasses>(K, Np, p0, width, row0, col0, h, diag, dpiv, sa, sb, ct);
  }
}

// One warp: C (16 x 8, row-major) = the split product of A (16 x 16,
// A[m][k]) and B (8 x 16, B[n][k]) in `passes` passes (1: hh alone; 3, 4 as
// the trailing update), through the trailing update's stage layout,
// fragment loads and C map, for a card test of the fragment layout.
__global__ void split_mma_check_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                       float* __restrict__ C, int passes) {
  __shared__ __align__(16) gfs::MmStage sa, sb;
  for (int e = threadIdx.x; e < gfs::kMmBk * gfs::kMmTile; e += 32) {
    const int t = e / gfs::kMmTile, o = e % gfs::kMmTile;
    sa[t][o] = o < 16 ? A[o * 16 + t] : 0.0f;
    sb[t][o] = o < 8 ? B[o * 16 + t] : 0.0f;
  }
  __syncwarp();
  uint32_t ah[4], al[4], bh[2], bl[2];
  gfs::frag_a_split(sa, 0, ah, al);
  gfs::frag_b_split(sb, 0, bh, bl);
  float hh[4] = {}, x[4] = {};
  gfs::mma_bf16(hh, ah, bh);
  if (passes >= 3) {
    gfs::mma_bf16(x, ah, bl);
    gfs::mma_bf16(x, al, bh);
  }
  if (passes == 4) gfs::mma_bf16(x, al, bl);
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  for (int i = 0; i < 4; ++i) C[(g + 8 * (i >> 1)) * 8 + 2 * q + (i & 1)] = x[i] + hh[i];
}

__global__ void logdet_sum_kernel(const double* __restrict__ partials, int nb,
                                  float* __restrict__ half_logdet) {
  double s = 0.0;
  for (int k = 0; k < nb; ++k) s += partials[k];
  half_logdet[0] = static_cast<float>(s);
}

// The look-ahead stream, of the highest priority so that its small
// latency-bound launches take SMs ahead of a running update's waiting
// blocks, and two events to hand work between it and the caller's stream;
// created once per device; and chol_trailing_kernel_hi's persistent grid
// (hi_grid).
struct LookAhead {
  cudaStream_t side;
  cudaEvent_t main_done, side_done;
  int hi_blocks;
};

// The trailing kernels' running tiles live in dynamic shared memory beside
// their rings, more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_tile_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// The persistent grid: the blocks of chol_trailing_kernel_hi that fit an SM
// beside nothing else, on every SM but kTrFreeSms. A chain block beside a
// trailing block shares its SM's issue slots and shared-memory pipe (the
// diag kernel, one block on the chain's critical path, took ~35% longer a
// step with every SM holding one); with one SM left out of the grid the
// factor took 14.6 ms at N = 10048 against 15.8 with none (H100; with 2-16
// left out 14.6-15.7, the update slower by the SMs it lacks).
constexpr int kTrFreeSms = 1;
cudaError_t hi_grid(int dev, int& blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_trailing_kernel_hi, kTrThreads,
                                                                  kTrSmem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  blocks = per_sm * (sms > kTrFreeSms ? sms - kTrFreeSms : sms);
  return err == cudaSuccess && blocks < 1 ? cudaErrorInvalidConfiguration : err;
}

int look_ahead(LookAhead*& out) {
  constexpr int kMaxDevices = 64;
  static LookAhead made[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess) {
      err = cudaStreamCreateWithPriority(&made[dev].side, cudaStreamNonBlocking, greatest);
    }
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&made[dev].main_done, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&made[dev].side_done, cudaEventDisableTiming);
    if (err == cudaSuccess) err = allow_tile_smem(chol_trailing_kernel_hi, kTrSmem);
    if (err == cudaSuccess) err = allow_tile_smem(chol_trailing_kernel<3>, gfs::kMmTileSmem);
    if (err == cudaSuccess) err = allow_tile_smem(chol_trailing_kernel<4>, gfs::kMmTileSmem);
    if (err == cudaSuccess) err = hi_grid(dev, made[dev].hi_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  out = &made[dev];
  return static_cast<int>(cudaSuccess);
}

// Factors outer panel `panel` (its columns fully updated) on stream s.
void factor_panel(float* K, int Np, int panel, float* alpha, int P, double* dpiv, double* partials,
                  cudaStream_t s) {
  const int nb = Np / kBs;
  const int first = panel * kPanel;
  const int blocks = min(kPanel, nb - first);
  for (int d = 0; d < blocks; ++d) {
    const int b = first + d;
    chol_diag_kernel<<<1, kThreads, 0, s>>>(K, Np, b, alpha, P, dpiv, partials);
    const int below = nb - b - 1;
    if (below > 0) {
      chol_panel_kernel<<<static_cast<unsigned>(below), kThreads, 0, s>>>(K, Np, b, alpha, P);
      const int later = blocks - d - 1;  // the panel's columns still to factor
      if (later > 0) {
        const dim3 grid(static_cast<unsigned>(below), static_cast<unsigned>(later));
        chol_inner_update_kernel<<<grid, kThreads, 0, s>>>(K, Np, b, dpiv);
      }
    }
  }
}

// The mode argument of the entry points (ops/cholesky.py `_MODE_CODES`):
// the split's passes in the low bits (0: exact f32 products, 3 or 4), plus
// kExactDiag (the "d" modes).
constexpr int kPassBits = 7, kExactDiag = 8;

bool valid_mode(int mode) {
  const int passes = mode & kPassBits;
  if (mode & ~(kPassBits | kExactDiag)) return false;
  return passes == 0 ? mode == 0 : passes == 3 || passes == 4;
}

template <int kPasses>
void launch_split(dim3 grid, cudaStream_t s, float* K, int Np, int p0, int J0, int ncols, double* dpiv,
                  bool exact_diag) {
  grid.z = kParts;  // the tile's 128 x kPart parts
  chol_trailing_kernel<kPasses><<<grid, gfs::kMmThreads, gfs::kMmTileSmem, s>>>(
      K, Np, p0, kPanel * kBs, J0, ncols, dpiv, exact_diag);
}

// The trailing update of the panel at column p0 in `mode` over the lower
// tiles of tile columns J0 .. J0 + ncols - 1 (every tile column from J0 when
// ncols is 0), rows to Np.
void trailing(int mode, const LookAhead& la, cudaStream_t s, float* K, int Np, int p0, int J0, int ncols,
              double* dpiv) {
  const int R = (Np + gfs::kMmTile - 1) / gfs::kMmTile - J0;
  const long long tiles = tr_tiles(R, ncols);
  const bool exact_diag = (mode & kExactDiag) != 0;
  const dim3 grid = ncols == 0 ? dim3(static_cast<unsigned>(tiles)) : dim3(R, ncols);
  switch (mode & kPassBits) {
    case 3:
      return launch_split<3>(grid, s, K, Np, p0, J0, ncols, dpiv, exact_diag);
    case 4:
      return launch_split<4>(grid, s, K, Np, p0, J0, ncols, dpiv, exact_diag);
    default:
      chol_trailing_kernel_hi<<<static_cast<unsigned>(std::min<long long>(tiles, la.hi_blocks)), kTrThreads,
                                kTrSmem, s>>>(K, Np, p0, J0, ncols, tiles, dpiv);
  }
}

// The launches of one factorization on stream s. P = 0 (alpha null) skips
// the solve; partials null skips the logdet.
int factor(float* K, int Np, float* alpha, int P, double* dpiv, double* partials, int mode, cudaStream_t s) {
  LookAhead* la = nullptr;
  int err = look_ahead(la);
  if (err != 0) return err;
  const int panel_cols = kPanel * kBs;
  const int panels = (Np + panel_cols - 1) / panel_cols;
  const int tiles = (Np + gfs::kMmTile - 1) / gfs::kMmTile;  // 128-tiles along a side
  const int tiles_per_panel = panel_cols / gfs::kMmTile;
  pivot_init_kernel<<<(Np + kThreads - 1) / kThreads, kThreads, 0, s>>>(K, Np, dpiv);
  factor_panel(K, Np, 0, alpha, P, dpiv, partials, s);
  for (int p = 0; p + 1 < panels; ++p) {
    const int p0 = p * panel_cols;
    const int J1 = (p + 1) * tiles_per_panel;  // first tile column of panel p + 1
    const int next_cols = min(tiles_per_panel, tiles - J1);
    // panel p applied to panel p + 1's columns, then panel p + 1 factored on
    // the side stream while panel p is applied to the columns beyond
    trailing(mode, *la, s, K, Np, p0, J1, next_cols, dpiv);
    cudaEventRecord(la->main_done, s);
    cudaStreamWaitEvent(la->side, la->main_done, 0);
    factor_panel(K, Np, p + 1, alpha, P, dpiv, partials, la->side);
    cudaEventRecord(la->side_done, la->side);
    if (tiles > J1 + next_cols) trailing(mode, *la, s, K, Np, p0, J1 + next_cols, 0, dpiv);  // the columns beyond
    cudaStreamWaitEvent(s, la->side_done, 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: Np / 64 + Np doubles of scratch (the per-block logdet partials,
// then the f64 pivots). mode: the trailing update's arithmetic (factor()).
extern "C" int gfs_chol_solve_logdet(float* K, int Np, float* alpha, int P, double* work,
                                     float* half_logdet, int mode, void* stream) {
  if (Np <= 0 || Np % kBs != 0 || P < 1 || alpha == nullptr || !valid_mode(mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = Np / kBs;
  const int err = factor(K, Np, alpha, P, work + nb, work, mode, s);
  if (err != 0) return err;
  logdet_sum_kernel<<<1, 1, 0, s>>>(work, nb, half_logdet);
  return static_cast<int>(cudaGetLastError());
}

// Factor only. work: Np doubles of scratch (the f64 pivots).
extern "C" int gfs_cholesky(float* K, int Np, double* work, int mode, void* stream) {
  if (Np <= 0 || Np % kBs != 0 || !valid_mode(mode)) return static_cast<int>(cudaErrorInvalidValue);
  return factor(K, Np, nullptr, 0, work, nullptr, mode, static_cast<cudaStream_t>(stream));
}

// One trailing update alone, for measurement: the panel at column p0 (a
// multiple of 256, with a panel beyond it) applied to every tile column
// beyond it, in `mode`. dpiv: Np doubles.
extern "C" int gfs_chol_trailing_update(float* K, int Np, int p0, double* dpiv, int mode, void* stream) {
  const int panel_cols = kPanel * kBs;
  if (Np <= 0 || Np % kBs != 0 || p0 < 0 || p0 % panel_cols != 0 || p0 + panel_cols >= Np || !valid_mode(mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LookAhead* la = nullptr;
  const int err = look_ahead(la);  // sets the trailing kernels' shared-memory limit
  if (err != 0) return err;
  trailing(mode, *la, static_cast<cudaStream_t>(stream), K, Np, p0, (p0 + panel_cols) / gfs::kMmTile, 0, dpiv);
  return static_cast<int>(cudaGetLastError());
}

// The fragment check: A (16 x 16), B (8 x 16), C (16 x 8), row-major f32
// on the card; passes 1, 3 or 4.
extern "C" int gfs_split_mma_check(const float* A, const float* B, float* C, int passes, void* stream) {
  if (passes != 1 && passes != 3 && passes != 4) return static_cast<int>(cudaErrorInvalidValue);
  split_mma_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, passes);
  return static_cast<int>(cudaGetLastError());
}
