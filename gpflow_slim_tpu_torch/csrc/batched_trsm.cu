// Batched triangular solve, in place: X[p] <- T[p]^-1 X[p] for p < P, each
// T[p] (M, M) lower or upper triangular, X[p] (M, K) row-major, any M >= 1
// and K >= 1.
//
// Replaces the TPU kernel gpflow_slim_tpu/ops/pallas_trsm.py
// `_make_batched_trsm_kernel` (launched by `_batched_trsm_pallas`), whose
// caller is the unwhitened SVGP's KL divergence: Lp^-1 q_sqrt[p] for every
// output p, with the one Cholesky factor Lp of Kuu broadcast over the batch.
//
// T[p] is read through a batch stride, a leading dimension `ld` and a
// transpose flag: the logical T[p][i][j] is L[p * batch_stride + i * ld + j],
// or L[p * batch_stride + j * ld + i] when transposed. A batch stride of 0
// reads one triangle for every p (the KL's broadcast Lp, no (P, M, M) copy),
// and the transposed read makes the backward's upper solve on L.mT free.
//
// The TPU kernel runs one grid step per p, inverts the whole padded triangle
// in VMEM and applies it as one matrix-unit product. Here every strip of 64
// columns of X[p] is independent of every other, so one launch covers the
// batch with a grid of (column strips, p) and no dependency between blocks.
// Each block walks its strip's 64-row block rows in solve order
// (left-looking): it accumulates T_ik X_k over the block rows k already
// solved, in registers (a shared-memory tiled FMA product, 4 x 4 outputs per
// thread), subtracts that from the right-hand side and solves the diagonal
// block in shared memory, one column per thread against reciprocal pivots
// (as trsm.cu's diag kernel), writing X_i once. The solved rows are read back
// from device memory (L2) for the block rows after them.
//
// The ragged edge is masked in the kernel: entries of T outside M x M read as
// the identity on the diagonal block and as 0 elsewhere, rows of X past M as
// 0, and nothing past M or K is written; the wrapper pads nothing.
//
// Arithmetic: f32 FMA, no tensor cores and no TF32 (the TPU pins its product
// to full f32, pallas_trsm.py:49-53).
//
// What bounds it on an H100: at the SVGP path's shape (P = 1, M = K = 256)
// the work is M^2 K = 1.7e7 flop (0.25 us at 67 TFLOP/s) and ~0.7 MB
// (0.2 us at 3.35 TB/s), so the launch and each block's serial chain of
// M / 64 block rows bound it: ceil(K / 64) * P blocks, 4 at that shape. The
// design spends no launch per block row (the wide TRSM's 2 M / 64 dependent
// launches) and leaves the chain's length to M / 64 diagonal solves of ~64
// dependent steps each.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBs = gfs::kTriBs;  // block size: rows of a block row, columns of a strip
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each; the first 64 solve
constexpr int kLd4 = gfs::kTriLd;
constexpr int kMaxGridY = 65535;

// At most one block per SM: ptxas may then give a thread the registers the
// substitution's 64 values need (without the bound, the upper variants were
// held to 80 registers and spilled ~900 bytes; H100, nvcc 12.9).
template <bool kLower, bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
    batched_trsm_kernel(const float* __restrict__ L, int M, int ld, long long batch_stride,
                        float* __restrict__ X, int K) {
  __shared__ __align__(16) float a[kBs][kLd4];   // T_ik; then T_ii transposed (a[c][r] = T_ii[r][c])
  __shared__ __align__(16) float bt[kBs][kLd4];  // X_k transposed; then block row i's RHS, transposed
  __shared__ float dinv[kBs];                    // 1 / T_ii[j][j]
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 qb of the strip
  const int ty = tid >> 4;  // rows ty + 16 qa of the block row
  const int col0 = blockIdx.x * kBs;
  const float* T = L + static_cast<long long>(blockIdx.y) * batch_stride;
  float* Xp = X + static_cast<size_t>(blockIdx.y) * M * K;
  const int nb = (M + kBs - 1) / kBs;
  constexpr int kIt = kBs * kBs / kThreads;

  for (int s = 0; s < nb; ++s) {
    const int i = kLower ? s : nb - 1 - s;
    // acc = sum of T_ik X_k over the block rows k solved before i
    float acc[4][4] = {};
    for (int u = 0; u < s; ++u) {
      const int k = kLower ? u : nb - 1 - u;
      // every thread is done with the tiles (and, after the diag solve of
      // the previous block row, its writes to X are visible to all)
      __syncthreads();
      gfs::load_tri_tile<kThreads, kTrans, false>(T, M, ld, i * kBs, k * kBs, a, false);
      float xv[kIt];  // all loads in flight before the first store
#pragma unroll
      for (int q = 0; q < kIt; ++q) {
        const int e = tid + q * kThreads;
        const int gr = k * kBs + e / kBs, gc = col0 + e % kBs;
        xv[q] = (gr < M && gc < K) ? Xp[static_cast<size_t>(gr) * K + gc] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kIt; ++q) {
        const int e = tid + q * kThreads;
        bt[e % kBs][e / kBs] = xv[q];
      }
      __syncthreads();
      gfs::tile_fma(acc, a, bt, tx, ty);
    }
    __syncthreads();
    // the right-hand side of block row i less acc, transposed, for the
    // column-per-thread diagonal solve; T_ii transposed beside it
#pragma unroll
    for (int qa = 0; qa < 4; ++qa) {
      const int r = ty + 16 * qa, gr = i * kBs + r;
#pragma unroll
      for (int qb = 0; qb < 4; ++qb) {
        const int c = tx + 16 * qb, gc = col0 + c;
        bt[c][r] = (gr < M && gc < K) ? Xp[static_cast<size_t>(gr) * K + gc] - acc[qa][qb] : 0.0f;
      }
    }
    gfs::load_tri_tile<kThreads, kTrans, true>(T, M, ld, i * kBs, i * kBs, a, true);
    __syncthreads();
    if (tid < kBs) dinv[tid] = 1.0f / a[tid][tid];
    __syncthreads();
    const int gc = col0 + tid;
    if (tid < kBs && gc < K) {
      float v[kBs];
#pragma unroll
      for (int r = 0; r < kBs; r += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&bt[tid][r]);
        v[r] = t.x;
        v[r + 1] = t.y;
        v[r + 2] = t.z;
        v[r + 3] = t.w;
      }
      gfs::substitute<kLower>(v, a, dinv);
      const int rows = min(kBs, M - i * kBs);
#pragma unroll
      for (int r = 0; r < kBs; ++r) {
        if (r < rows) Xp[static_cast<size_t>(i * kBs + r) * K + gc] = v[r];
      }
    }
  }
}

}  // namespace

// Solves T[p] X[p] = B[p] in place in X (P, M, K), row-major, for p < P.
// T[p] is lower (lower != 0) or upper triangular, read from L at
// p * batch_stride (0: one triangle for all p) with leading dimension ld,
// transposed when trans != 0 (see above).
extern "C" int gfs_batched_trsm(const float* L, int P, int M, int ld, long long batch_stride,
                                int trans, int lower, float* X, int K, void* stream) {
  if (P < 1 || M < 1 || K < 1 || ld < M || batch_stride < 0 || P > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((K + kBs - 1) / kBs), static_cast<unsigned>(P));
  if (lower) {
    if (trans) {
      batched_trsm_kernel<true, true><<<grid, kThreads, 0, s>>>(L, M, ld, batch_stride, X, K);
    } else {
      batched_trsm_kernel<true, false><<<grid, kThreads, 0, s>>>(L, M, ld, batch_stride, X, K);
    }
  } else if (trans) {
    batched_trsm_kernel<false, true><<<grid, kThreads, 0, s>>>(L, M, ld, batch_stride, X, K);
  } else {
    batched_trsm_kernel<false, false><<<grid, kThreads, 0, s>>>(L, M, ld, batch_stride, X, K);
  }
  return static_cast<int>(cudaGetLastError());
}
