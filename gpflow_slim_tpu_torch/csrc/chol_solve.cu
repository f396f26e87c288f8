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
// Then one trailing launch applies the whole panel (an inner dimension of
// 256) to the lower triangle beyond it, on common.cuh's 128 x 128 product.
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
//  * the trailing flop, N^3 / 3 FMA-pairs, now most of the time: the 8 x 8
//    register tile of common.cuh's product reads 1 byte of shared memory
//    per FMA, the SM's whole shared-memory rate at its FMA rate; measured
//    at ~23 TFLOP/s in place (31 TFLOP/s for the same product alone);
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
//    update and before the entry point returns. The chain's launches still
//    wait for SM slots that trailing blocks hold (two fill an SM's
//    registers), so in place they take 1.5-4x their time alone; capping the
//    trailing kernel at one block per SM (160 registers) shortened the
//    visible chain but slowed the trailing update more (H100).
//
// Arithmetic: f32 FMA for the panels and the trailing products; no tensor
// cores and no TF32. The pivots are the exception. The logdet error of an
// f32 factorization is about sum_i (K^-1)_ii dK_ii, so it is set by the
// rounding of the diagonal entries, which a right-looking schedule
// re-rounds once per update. The diagonal is therefore kept in a separate
// f64 array (`dpiv`, updated by the diagonal tiles of every update: sums of
// squares of f32 factor entries, in f64), and each 64 x 64 diagonal block is
// factored in f64. At N = 10000 this takes the half-logdet error from about
// 1.4e-5 to a few 1e-6 relative. The trailing sums start from the entry
// they update and subtract one FMA at a time (common.cuh), so the wider
// panel does not round at the magnitude of a 256-term dot product (which
// put the half-logdet 1.9e-5 off f64 at N = 10000). A non-positive pivot
// gives NaN (sqrt of a negative) and never traps, as the TPU and XLA paths
// do.
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

// After an outer panel (columns [p0, p0 + width)): A_IJ -= L_IP L_JP^T over
// 128 x 128 lower tiles (I >= J, in units of 128) of the tile columns J0
// .. J0 + ncols - 1 (all when ncols = 0: the tiles then enumerate the lower
// triangle from J0 by blockIdx.x), rows to Np. Entries of a strictly-upper
// 64 x 64 block are not written. A diagonal tile subtracts its rows' f64
// pivot terms, summed in f64 from the A stages as they land.
__global__ void __launch_bounds__(gfs::kMmThreads, 2)
    chol_trailing_kernel(float* __restrict__ K, int Np, int p0, int width, int J0, int ncols,
                         double* __restrict__ dpiv) {
  __shared__ __align__(16) gfs::MmStage sa[gfs::kMmStages];
  __shared__ __align__(16) gfs::MmStage sb[gfs::kMmStages];
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
  const gfs::MmOperand A = {K + static_cast<size_t>(row0) * Np + p0, Np, 1, Np - row0, width};
  const gfs::MmOperand B = {K + static_cast<size_t>(col0) * Np + p0, Np, 1, Np - col0, width};
  const bool diag = I == J;
  double piv = 0.0;  // thread o < 128 of a diagonal tile: sum_t L[row0 + o][p0 + t]^2
  // A_IJ, less the product below: entries of a strictly-upper 64 x 64
  // block are neither read nor written (only a diagonal tile has them)
  float* const tile = K + static_cast<size_t>(row0) * Np + col0;
  const auto kept = [&](int r, int c) { return !diag || c / kBs <= r / kBs; };
  gfs::MmAcc acc;
  gfs::mm_tile_io<false>(acc, tile, Np, Np - row0, Np - col0, kept);
  gfs::mm_run<true, true>(acc, A, B, width, sa, sb, [&](const gfs::MmStage& s, int t0) {
    if (diag && threadIdx.x < gfs::kMmTile) {
      const int n = min(gfs::kMmBk, width - t0);
      for (int t = 0; t < n; ++t) {
        const double v = s[t][threadIdx.x];
        piv = fma(v, v, piv);
      }
    }
  });
  if (diag && threadIdx.x < gfs::kMmTile && row0 + static_cast<int>(threadIdx.x) < Np) {
    dpiv[row0 + threadIdx.x] -= piv;
  }
  gfs::mm_tile_io<true>(acc, tile, Np, Np - row0, Np - col0, kept);
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
// created once per device.
struct LookAhead {
  cudaStream_t side;
  cudaEvent_t main_done, side_done;
};

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

// The launches of one factorization on stream s. P = 0 (alpha null) skips
// the solve; partials null skips the logdet.
int factor(float* K, int Np, float* alpha, int P, double* dpiv, double* partials, cudaStream_t s) {
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
    const dim3 next_grid(static_cast<unsigned>(tiles - J1), static_cast<unsigned>(next_cols));
    chol_trailing_kernel<<<next_grid, gfs::kMmThreads, 0, s>>>(K, Np, p0, panel_cols, J1, next_cols,
                                                                 dpiv);
    cudaEventRecord(la->main_done, s);
    cudaStreamWaitEvent(la->side, la->main_done, 0);
    factor_panel(K, Np, p + 1, alpha, P, dpiv, partials, la->side);
    cudaEventRecord(la->side_done, la->side);
    const long long rest = tiles - J1 - next_cols;  // tile columns beyond panel p + 1
    if (rest > 0) {
      chol_trailing_kernel<<<static_cast<unsigned>(rest * (rest + 1) / 2), gfs::kMmThreads, 0, s>>>(
          K, Np, p0, panel_cols, J1 + next_cols, 0, dpiv);
    }
    cudaStreamWaitEvent(s, la->side_done, 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: Np / 64 + Np doubles of scratch (the per-block logdet partials,
// then the f64 pivots).
extern "C" int gfs_chol_solve_logdet(float* K, int Np, float* alpha, int P, double* work,
                                     float* half_logdet, void* stream) {
  if (Np <= 0 || Np % kBs != 0 || P < 1 || alpha == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = Np / kBs;
  const int err = factor(K, Np, alpha, P, work + nb, work, s);
  if (err != 0) return err;
  logdet_sum_kernel<<<1, 1, 0, s>>>(work, nb, half_logdet);
  return static_cast<int>(cudaGetLastError());
}

// Factor only. work: Np doubles of scratch (the f64 pivots).
extern "C" int gfs_cholesky(float* K, int Np, double* work, void* stream) {
  if (Np <= 0 || Np % kBs != 0) return static_cast<int>(cudaErrorInvalidValue);
  return factor(K, Np, nullptr, 0, work, nullptr, static_cast<cudaStream_t>(stream));
}
