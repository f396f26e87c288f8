// One-pass Cholesky operand of exact GPR: the lower triangle of
// K(Xs, Xs) + noise * I, padded to pad_to with a unit-diagonal extension.
//
// Replaces the TPU kernel gpflow_slim_tpu/ops/pallas_gram.py
// `_gram_chol_operand_kernel` (launched by `_gram_chol_operand_pallas`).
//
// What bounds it on an H100: the writes. Only the lower half of the padded
// matrix is stored, about (pad_to^2 / 2) * 4 bytes (about 200 MB at
// N = 10000, 0.060 ms at 3.35 TB/s); the inputs are N * D floats that stay
// in L1/L2, and the map is ~20 instructions an entry. A block per 32 x 32
// tile (49,455 blocks of 4 KB), each thread decoding the tile's place in
// the triangle with an f64 square root, scalar stores and the inputs re-read
// per entry, reached a third of that rate.
//
// The design: row bands of 8 rows, band b paired with band nb - 1 - b so
// that every pair holds about the same (nb + 1) * 8 columns of 8 rows; a
// block writes one sweep of 1024 columns of a pair (grid y: the pair, grid
// x: the sweep across its two bands, one after the other), so the grid is
// ~pad_to^2 / 16384 blocks of 32 KB, their places found in integers with no
// triangle to invert, and the last wave is a small part of the run (one
// block per pair, 628 blocks at N = 10000 at four an SM, is 1.2 waves and
// ran at 1.3 TB/s). A band writes its rows from column 0 to the end
// of its own diagonal 8 x 8 block (rounded up to 4): the lower triangle,
// and a few entries above the diagonal inside that block. The rows are
// written by common.cuh's `gram_band`: four consecutive columns a thread,
// their coordinates in registers for all 8 rows, one 16-byte store a row
// of four, so a warp writes 512 contiguous bytes. A band of pad rows (all
// at or past N) reads no input and forms no map: zeros and its piece of the
// unit diagonal. Entries above the diagonal beyond the bands' diagonal
// blocks are left unwritten, and the consumer (chol_solve.cu) reads only
// the lower triangle.
//
// d^2 = sum_d (x_id - x_jd)^2 is formed directly. For D = 1 this is the TPU
// kernel's own exact branch; for D > 1 it is the same function as the TPU's
// ||x||^2 - 2 x.y + ||y||^2 expansion, without its cancellation. The map by
// kind is `gfs::apply_map` (common.cuh).

#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = gfs::kBandRows;
constexpr int kSweep = 4 * gfs::kBandThreads;  // columns a block writes

// Columns band b writes: to the end of its diagonal block, rounded up to 4.
__device__ __forceinline__ int band_cols(int b, int pad_to) { return (min(pad_to, (b + 1) * kRows) + 3) & ~3; }

__global__ void __launch_bounds__(gfs::kBandThreads)
    gram_chol_operand_kernel(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p,
                             const float* __restrict__ noise_p, int kind, int pad_to, float* __restrict__ out) {
  const int nb = (pad_to + kRows - 1) / kRows;
  const int pair = blockIdx.y;
  const int first = (band_cols(pair, pad_to) + kSweep - 1) / kSweep;  // sweeps of the pair's first band
  int band = pair, sweep = blockIdx.x;
  if (sweep >= first) {  // the pair's second band, unless the count is odd and this is its middle
    band = nb - 1 - pair;
    sweep -= first;
    if (band == pair || sweep * kSweep >= band_cols(band, pad_to)) return;
  }
  const float var = *var_p;
  const float noise = *noise_p;
  const auto value = [&](int r, int c, float d2) {
    const float v = gfs::apply_map(kind, var, d2);
    return r == c ? v + noise : v;
  };
  const auto pad = [](int r, int c) { return r == c ? 1.0f : 0.0f; };
  const int r0 = band * kRows, c0 = sweep * kSweep;
  gfs::gram_band(X, N, X, N, D, r0, min(pad_to, r0 + kRows), c0, min(band_cols(band, pad_to), c0 + kSweep),
                 out, pad_to, value, pad);
}

}  // namespace

// out (pad_to, pad_to): its lower triangle is K(X, X) + noise * I over the
// first N rows and columns and the identity's beyond; var and noise are
// device pointers to the two scalars. pad_to is a multiple of 4 and out
// 16-byte aligned.
extern "C" int gfs_gram_chol_operand(const float* X, int N, int D, const float* var, const float* noise,
                                     int kind, int pad_to, float* out, void* stream) {
  if (N < 0 || D < 1 || pad_to < N || pad_to % 4 != 0 || reinterpret_cast<std::uintptr_t>(out) % 16 != 0 ||
      kind < gfs::kRbf || kind > gfs::kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = (pad_to + kRows - 1) / kRows;
  if (nb > 0) {
    // the most sweeps of a pair: its two bands hold at most pad_to + 8 columns
    const dim3 grid(static_cast<unsigned>((pad_to + kRows + 3) / kSweep + 2), static_cast<unsigned>((nb + 1) / 2));
    gram_chol_operand_kernel<<<grid, gfs::kBandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        X, N, D, var, noise, kind, pad_to, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
