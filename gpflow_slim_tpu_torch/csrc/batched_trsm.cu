// Batched triangular solve: X[p] = T[p]^-1 B[p] for p < P, each T[p]
// (M, M) lower or upper triangular, B[p] and X[p] (M, K) row-major, any
// M >= 1 and K >= 1.
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
// What bounds it on an H100: not the work. At the SVGP path's shape (P = 1,
// M = K = 256) it is M^2 K = 1.7e7 flop (0.25 us at 67 TFLOP/s) and ~0.7 MB
// (0.2 us at 3.35 TB/s); at (1, 1024, 1024) 1.1e9 flop (16 us). The chain of
// M / 64 dependent block rows and the SMs the launch keeps busy bound it: a
// block per (64-column strip, p) walking its block rows in series, with a
// 64-step one-column-per-thread substitution on the diagonal, kept 4 of 132
// SMs busy at (1, 256, 256) and took 18-33 us a block row.
//
// The design: one launch, one block per work item (p, 32-column strip j,
// block row i). Items are handed out by an atomic ticket in solve order,
// i-major, then p and j, so a block waits only on items with smaller
// tickets and the launch cannot deadlock. Each item runs common.cuh's
// dataflow body (`flow_block_row`, the thin schedule of trsm.cu on one
// strip): T_ii^-1 is formed and the tiles T_ik streamed off the chain, each
// T_ik x_kj subtracted as soon as item (p, j, k) has released its ready
// flag, and on the chain only one tile product and the three products of
// the refined diagonal solve, x = y + T_ii^-1 (b - T_ii y), y = T_ii^-1 b.
// Strips of 32 columns halve the chain's products against 64 and double the
// items that fill the card (32 at (1, 256, 256), 512 at (1, 1024, 1024));
// two blocks fit an SM. The ticket and one ready flag per item are scratch
// from the wrapper (`ops/trsm.py` `batched_trsm_scratch`) that this entry
// zeroes on the stream before the launch. The solve is out of place: B is
// read once per item and X written once, so nothing copies B.
//
// The ragged edge is masked in the kernel: entries of T outside M x M read as
// the identity on the diagonal block and as 0 elsewhere, rows of B past M as
// 0, and nothing past M or K is written; the wrapper pads nothing.
//
// Arithmetic: f32 FMA, no tensor cores and no TF32 (the TPU pins its product
// to full f32, pallas_trsm.py:49-53).

#include <climits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBs = gfs::kTriBs;  // rows of a block row
constexpr int kStrip = 32;        // columns of a strip
constexpr int kThreads = gfs::kFlowThreads;

template <bool kLower, bool kTrans>
__global__ void __launch_bounds__(kThreads, 2)
    batched_trsm_kernel(const float* __restrict__ L, int P, int M, int ld, long long batch_stride,
                        const float* __restrict__ B, float* __restrict__ X, int K, int* __restrict__ sync) {
  extern __shared__ __align__(16) float smem[];
  const int item = gfs::take_ticket(sync);
  const int strips = (K + kStrip - 1) / kStrip;
  const int s = item / (P * strips);  // the block row's place in the solve order
  const int pj = item % (P * strips);  // p * strips + j
  const int p = pj / strips, c0 = (pj % strips) * kStrip;
  const size_t off = static_cast<size_t>(p) * M * K + c0;
  const int nb = (M + kBs - 1) / kBs;
  gfs::flow_block_row<kLower, kTrans, kStrip>(L + p * batch_stride, M, ld, B + off, X + off, K,
                                              min(kStrip, K - c0), sync + 1 + static_cast<size_t>(pj) * nb, s,
                                              smem);
}

template <bool kLower, bool kTrans>
int launch(const float* L, int P, int M, int ld, long long batch_stride, const float* B, float* X, int K,
           int* sync, unsigned items, cudaStream_t s) {
  constexpr int bytes = gfs::FlowShape<kStrip>::kSmemFloats * static_cast<int>(sizeof(float));
  const auto kernel = batched_trsm_kernel<kLower, kTrans>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<items, kThreads, bytes, s>>>(L, P, M, ld, batch_stride, B, X, K, sync);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Solves T[p] X[p] = B[p] for p < P into X (P, M, K), row-major; B is not
// written and must not overlap X. T[p] is lower (lower != 0) or upper
// triangular, read from L at p * batch_stride (0: one triangle for all p)
// with leading dimension ld, transposed when trans != 0 (see above). sync:
// P * ceil(K / 32) * ceil(M / 64) + 1 ints of scratch (the ticket, then one
// ready flag per item), zeroed here on the stream.
extern "C" int gfs_batched_trsm(const float* L, int P, int M, int ld, long long batch_stride, int trans,
                                int lower, const float* B, float* X, int K, int* sync, void* stream) {
  if (P < 1 || M < 1 || K < 1 || ld < M || batch_stride < 0 || sync == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items =
      static_cast<long long>(P) * ((K + kStrip - 1) / kStrip) * ((M + kBs - 1) / kBs);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(items);
  const cudaError_t err = cudaMemsetAsync(sync, 0, (items + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lower) {
    return trans ? launch<true, true>(L, P, M, ld, batch_stride, B, X, K, sync, n, s)
                 : launch<true, false>(L, P, M, ld, batch_stride, B, X, K, sync, n, s);
  }
  return trans ? launch<false, true>(L, P, M, ld, batch_stride, B, X, K, sync, n, s)
               : launch<false, false>(L, P, M, ld, batch_stride, B, X, K, sync, n, s);
}
