// One-pass Cholesky operand of exact GPR: the lower tiles of
// K(Xs, Xs) + noise * I, padded to pad_to with a unit-diagonal extension.
//
// Replaces the TPU kernel gpflow_slim_tpu/ops/pallas_gram.py
// `_gram_chol_operand_kernel` (launched by `_gram_chol_operand_pallas`).
//
// What bounds it on an H100: the writes. Only the lower half of the padded
// matrix is stored, about (pad_to^2 / 2) * 4 bytes (about 200 MB at
// N = 10000); the inputs are N * D floats that stay in L1/L2. The design
// does what it can about that:
//  * the grid enumerates the lower 32 x 32 output tiles only (bi >= bj), so
//    a strictly-upper tile costs no block at all; its content is left
//    unspecified, and the consumer (chol_solve.cu) never reads it;
//  * a warp writes 32 consecutive floats of one row, so every store is a
//    full 128-byte line;
//  * d^2 = sum_d (x_id - x_jd)^2 is formed directly. For D = 1 this is the
//    TPU kernel's own exact branch; for D > 1 it is the same function as the
//    TPU's ||x||^2 - 2 x.y + ||y||^2 expansion, without its cancellation.
// The map by kind is `gfs::apply_map` (common.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowStep = kTile / kRowsPerThread;  // block is kTile x kRowStep

__global__ void gram_chol_operand_kernel(const float* __restrict__ X, int N, int D,
                                         const float* __restrict__ scal, int kind,
                                         int pad_to, float* __restrict__ out) {
  int bi, bj;
  gfs::tri_index(blockIdx.x, bi, bj);
  const float var = scal[0];
  const float noise = scal[1];
  const int col = bj * kTile + threadIdx.x;
  if (col >= pad_to) return;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = bi * kTile + threadIdx.y + q * kRowStep;
    if (row >= pad_to) break;
    float v;
    if (row < N && col < N) {
      const float d2 = gfs::sq_dist(X + static_cast<size_t>(row) * D, X + static_cast<size_t>(col) * D, D);
      v = gfs::apply_map(kind, var, d2);
      if (row == col) v += noise;
    } else {
      v = (row == col) ? 1.0f : 0.0f;
    }
    out[static_cast<size_t>(row) * pad_to + col] = v;
  }
}

}  // namespace

extern "C" int gfs_gram_chol_operand(const float* X, int N, int D, const float* scal, int kind,
                                     int pad_to, float* out, void* stream) {
  if (N < 0 || D < 1 || pad_to < N || kind < gfs::kRbf || kind > gfs::kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nbt = (pad_to + kTile - 1) / kTile;
  const long long nblocks = nbt * (nbt + 1) / 2;
  if (nblocks > 0) {
    const dim3 block(kTile, kRowStep);
    gram_chol_operand_kernel<<<static_cast<unsigned>(nblocks), block, 0,
                               static_cast<cudaStream_t>(stream)>>>(X, N, D, scal, kind, pad_to, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
