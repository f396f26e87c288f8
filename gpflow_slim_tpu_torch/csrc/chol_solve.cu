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
// Right-looking blocked Cholesky with 64 x 64 blocks (one f32 block is 16 KB
// of shared memory; the TPU's 512 blocks were a VMEM choice). Each panel k
// takes three launches on the caller's stream:
//  1. diag (one block): factor A_kk unblocked in shared memory, in f64,
//     write L_kk, store sum log diag L_kk into partials[k], and
//     forward-substitute alpha_k <- L_kk^-1 alpha_k. The right-hand side
//     may have any number P of columns: the first 8 are substituted in the
//     factor's own sweep, any further ones in 8-column sweeps against the
//     finished L_kk (the same arithmetic, so every column gets the same
//     rounding);
//  2. panel (one block per row block i > k): L_ik = A_ik L_kk^-T, each row
//     forward-substituted in registers by its own thread against L_kk in
//     shared memory (no barriers in the chain), then alpha_i -= L_ik alpha_k
//     for all P columns, alpha_k read from global memory. Only block i
//     writes alpha_i, so there is no race;
//  3. trailing (one block per lower block pair k < j <= i):
//     A_ij -= L_ik L_jk^T, a shared-memory tiled FMA product reading
//     16-byte vectors along the inner dimension.
// A last one-thread launch sums partials in order, so the logdet is
// deterministic (no atomics).
//
// Arithmetic: f32 FMA for the panels and the trailing products; no tensor
// cores and no TF32. The pivots are the exception. The logdet error of an
// f32 factorization is about sum_i (K^-1)_ii dK_ii, so it is set by the
// rounding of the diagonal entries, which a right-looking schedule
// re-rounds once per panel. The diagonal is therefore kept in a separate
// f64 array (`dpiv`, updated by the diagonal tiles of each trailing
// launch), and each 64 x 64 diagonal block is factored in f64. At N = 10000
// this takes the half-logdet error from about 1.4e-5 to a few 1e-6
// relative (a model of the rounding, checked against the kernel, at
// N = 512..4096). A non-positive pivot gives NaN (sqrt of a negative) and
// never traps, as the TPU and XLA paths do.
//
// Operand contract (ops/gram.py's operand for the fused mode, the padding of
// ops/cholesky.py `cholesky` for the factor-only mode): K is the padded
// operand, Np a multiple of 64, with a unit-diagonal pad extension; only
// its lower triangle is read,
// and strictly-upper entries outside the diagonal blocks are never touched.
// Pad rows have zero off-diagonal entries and zero right-hand sides, so
// their alpha rows stay exactly 0 and their logdet terms are log 1 = 0.
//
// What bounds it on an H100: the N^3 / 3 FMAs of the trailing updates, at
// the rate of a simple shared-memory kernel without tensor cores, plus the
// serial chain of 2 x 64 barrier steps in each diag and panel launch.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBs = 64;       // block size
constexpr int kThreads = 256;
constexpr int kPChunk = 8;    // alpha columns held in shared memory per sweep
constexpr int kLd = kBs + 1;  // padded shared row: column walks hit distinct banks
constexpr int kLd4 = kBs + 4; // padded shared row that keeps 16-byte alignment for float4

// Column c and first row of this thread in the 64-column x 4-row-group sweep.
__device__ __forceinline__ int sweep_col() { return threadIdx.x & (kBs - 1); }
__device__ __forceinline__ int sweep_row0() { return threadIdx.x >> 6; }

__global__ void pivot_init_kernel(const float* __restrict__ K, int Np, double* __restrict__ dpiv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Np) dpiv[i] = K[static_cast<size_t>(i) * Np + i];
}

__global__ void chol_diag_kernel(float* __restrict__ K, int Np, int k, float* __restrict__ alpha,
                                 int P, const double* __restrict__ dpiv,
                                 double* __restrict__ partials) {
  __shared__ double a[kBs][kLd];
  __shared__ double al[kPChunk][kBs];  // one chunk of alpha_k, transposed: al[p][r]
  __shared__ double dinv[kBs];         // 1 / L_jj, for the chunks after the first
  __shared__ double red[kBs];
  const int tid = threadIdx.x;
  float* Akk = K + static_cast<size_t>(k) * kBs * Np + static_cast<size_t>(k) * kBs;
  float* alk = alpha + static_cast<size_t>(k) * kBs * P;

  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, c = e % kBs;
    a[r][c] = (c < r) ? Akk[static_cast<size_t>(r) * Np + c] : (c == r ? dpiv[k * kBs + r] : 0.0);
  }
  const int pc0 = min(P, kPChunk);
  for (int e = tid; e < kBs * pc0; e += kThreads) al[e % pc0][e / pc0] = alk[(e / pc0) * P + e % pc0];
  __syncthreads();

  // thread (c, r0): column c of the block, rows r0, r0 + 4, ...; alpha
  // columns p = r0, r0 + 4 of row c
  const int c = sweep_col();
  const int r0 = sweep_row0();
  for (int j = 0; j < kBs; ++j) {
    // phase A: pivot, scale column j below the diagonal, scale alpha row j.
    // rsqrt of a negative pivot is NaN, and so is everything after it.
    const double d = a[j][j];
    const double inv = rsqrt(d);
    if (tid > j && tid < kBs) a[tid][j] *= inv;
    if (tid >= kBs && tid < kBs + pc0) al[tid - kBs][j] *= inv;
    if (tid == 0) dinv[j] = inv;
    __syncthreads();
    // phase B: rank-1 update of the lower trailing triangle and of alpha
    if (tid == 0) a[j][j] = d * inv;
    if (c > j) {
      const double lcj = a[c][j];
#pragma unroll
      for (int q = 0; q < kBs / 4; ++q) {
        const int r = r0 + 4 * q;
        if (r >= c) a[r][c] = fma(-a[r][j], lcj, a[r][c]);
      }
      for (int p = r0; p < pc0; p += 4) al[p][c] = fma(-lcj, al[p][j], al[p][c]);
    }
    __syncthreads();
  }

  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, cc = e % kBs;
    Akk[static_cast<size_t>(r) * Np + cc] = static_cast<float>(a[r][cc]);  // upper entries are 0
  }
  for (int e = tid; e < kBs * pc0; e += kThreads) {
    alk[(e / pc0) * P + e % pc0] = static_cast<float>(al[e % pc0][e / pc0]);
  }
  if (partials != nullptr) {  // uniform over the block: the barriers are safe
    if (tid < kBs) red[tid] = log(a[tid][tid]);
    __syncthreads();
    for (int s = kBs / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) partials[k] = red[0];
  }

  // columns beyond the first chunk: the same substitution, against the
  // finished L_kk (column j of `a` is final once step j is done)
  for (int p0 = kPChunk; p0 < P; p0 += kPChunk) {
    const int pc = min(P - p0, kPChunk);
    for (int e = tid; e < kBs * pc; e += kThreads) al[e % pc][e / pc] = alk[(e / pc) * P + p0 + e % pc];
    __syncthreads();
    for (int j = 0; j < kBs; ++j) {
      if (tid < pc) al[tid][j] *= dinv[j];
      __syncthreads();
      if (c > j) {
        const double lcj = a[c][j];
        for (int p = r0; p < pc; p += 4) al[p][c] = fma(-lcj, al[p][j], al[p][c]);
      }
      __syncthreads();
    }
    for (int e = tid; e < kBs * pc; e += kThreads) {
      alk[(e / pc) * P + p0 + e % pc] = static_cast<float>(al[e % pc][e / pc]);
    }
    __syncthreads();  // the next chunk's load overwrites al
  }
}

__global__ void chol_panel_kernel(float* __restrict__ K, int Np, int k, float* __restrict__ alpha,
                                  int P) {
  __shared__ float l[kBs][kLd4];  // L_kk
  __shared__ float x[kBs][kLd];   // A_ik, overwritten by L_ik
  const int tid = threadIdx.x;
  const int i = k + 1 + blockIdx.x;
  const float* Lkk = K + static_cast<size_t>(k) * kBs * Np + static_cast<size_t>(k) * kBs;
  float* Aik = K + static_cast<size_t>(i) * kBs * Np + static_cast<size_t>(k) * kBs;

  for (int e = tid; e < kBs * kBs; e += kThreads) {
    const int r = e / kBs, c = e % kBs;
    l[r][c] = (c <= r) ? Lkk[static_cast<size_t>(r) * Np + c] : 0.0f;
    x[r][c] = Aik[static_cast<size_t>(r) * Np + c];
  }
  __syncthreads();

  // X L_kk^T = A row by row: x_rj = (a_rj - sum_{t<j} x_rt l_jt) / l_jj.
  // Thread r keeps its row in registers; every thread reads the same l_jt
  // at the same time (a shared-memory broadcast).
  if (tid < kBs) {
    float v[kBs];
#pragma unroll
    for (int j = 0; j < kBs; ++j) v[j] = x[tid][j];
#pragma unroll
    for (int j = 0; j < kBs; ++j) {
      float s = v[j];
#pragma unroll
      for (int t = 0; t < j; ++t) s = fmaf(-v[t], l[j][t], s);
      v[j] = s / l[j][j];
    }
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

__global__ void chol_trailing_kernel(float* __restrict__ K, int Np, int k,
                                     double* __restrict__ dpiv) {
  __shared__ __align__(16) float li[kBs][kLd4];  // L_ik
  __shared__ __align__(16) float lj[kBs][kLd4];  // L_jk
  int ti, tj;
  gfs::tri_index(blockIdx.x, ti, tj);
  const int i = k + 1 + ti;
  const int j = k + 1 + tj;
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

  // 16 x 16 threads, each a 4 x 4 set of outputs: rows ty + 16a, cols tx + 16b;
  // the inner dimension is read four at a time
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4] = {};
  for (int t = 0; t < kBs; t += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = *reinterpret_cast<const float4*>(&li[ty + 16 * q][t]);
      bv[q] = *reinterpret_cast<const float4*>(&lj[tx + 16 * q][t]);
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
  // a diagonal tile also carries its rows' f64 pivots (one block per tile,
  // so no two blocks touch the same entry)
  if (ti == tj && tid < kBs) {
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

__global__ void logdet_sum_kernel(const double* __restrict__ partials, int nb,
                                  float* __restrict__ half_logdet) {
  double s = 0.0;
  for (int k = 0; k < nb; ++k) s += partials[k];
  half_logdet[0] = static_cast<float>(s);
}

// The launches of one factorization on stream s. P = 0 (alpha null) skips
// the solve; partials null skips the logdet.
int factor(float* K, int Np, float* alpha, int P, double* dpiv, double* partials, cudaStream_t s) {
  const int nb = Np / kBs;
  pivot_init_kernel<<<(Np + kThreads - 1) / kThreads, kThreads, 0, s>>>(K, Np, dpiv);
  for (int k = 0; k < nb; ++k) {
    chol_diag_kernel<<<1, kThreads, 0, s>>>(K, Np, k, alpha, P, dpiv, partials);
    const long long m = nb - k - 1;
    if (m > 0) {
      chol_panel_kernel<<<static_cast<unsigned>(m), kThreads, 0, s>>>(K, Np, k, alpha, P);
      chol_trailing_kernel<<<static_cast<unsigned>(m * (m + 1) / 2), kThreads, 0, s>>>(K, Np, k,
                                                                                       dpiv);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// work: Np / 64 + Np doubles of scratch (the per-panel logdet partials,
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
