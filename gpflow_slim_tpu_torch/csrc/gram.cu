// Gram matrices of the stationary kernels from pre-scaled inputs:
//  * the cross Gram K(Xs, X2s), (N, M), any D, ragged N and M;
//  * the lower-tile Gram of K(Xs, Xs), (N, N): every 32 x 32 tile on or
//    below the diagonal holds the Gram, every strictly-upper tile is
//    written as zero.
//
// Replaces the TPU kernels gpflow_slim_tpu/ops/pallas_gram.py `_gram_kernel`
// (launched by `_gram_pallas`, and by `gram_interpret_mode` for the CPU
// tests) and `_gram_lower_kernel` (launched by `_gram_lower_pallas`).
//
// What bounds both on an H100: the writes, N * M * 4 bytes (82 MB for the
// (10000, 2048) cross Gram of a prediction request, 0.0245 ms at 3.35 TB/s;
// 400 MB for the lower Gram at N = 10000), at one exp per entry; the inputs
// are N * D and M * D floats that stay in L1/L2.
//
// The cross Gram writes row bands through common.cuh's `gram_band`, the
// writer of the Gram operand: a block writes 8 rows x one sweep of 1024
// columns (32 KB; grid x: the band, so neighbouring blocks share their
// columns' coordinates in L2; grid y: the sweep), each thread holding its
// four columns' coordinates in registers for all 8 rows. At 10000 x 2048
// that is 2,500 blocks of 32 KB where a block per 32 x 32 tile made 20,032
// of 4 KB with 4-byte stores (0.049 ms queued, 50% of the bound). At 64
// registers a thread the card holds four such blocks an SM, 528 in all:
// 4.7 waves, the last one 73% full, and a block writes its 32 KB in a few
// microseconds of the run's ~25. A grid of fewer than two 8-row blocks an
// SM (the SVGP path's 256 x 256 and 256 x 1024: 32 blocks) would leave most
// SMs idle and each thread 32 entries in a row: there the bands are one row
// tall, 256 blocks of four entries a thread, and the time is the launch's.
// Rows 16-byte aligned (M a multiple of 4 and an aligned output, as the
// allocator gives) take the float4 writer, a warp writing 512 contiguous
// bytes a row; any other M takes its scalar-store variant, whose columns
// are 256 apart in a thread, so a warp's store still covers 128 contiguous
// bytes and no row needs an aligned start. No padded output is written and
// copied.
//
// The lower-tile Gram keeps one block per 32 x 32 output tile, 32 x 8
// threads with 4 rows each, so a warp writes 32 consecutive floats of one
// row (a full 128-byte line); it zeroes its strictly-upper tiles without
// reading any input or computing the map there (the TPU kernel's `pl.when`
// does the same), so they cost their writes only.
//
// d^2 is formed directly from the coordinate differences, in `gfs::sq_dist`'s
// order. It is the function the TPU computes with its full-precision
// ||x||^2 - 2 x.y + ||y||^2 expansion (the expansion is what its matrix
// unit needs), without the expansion's f32 cancellation near d = 0: at
// |x|^2 ~ 100 that cancellation leaves ~1e-5 in d^2, and sqrt(d^2 + 1e-12)
// turns it into ~3e-3 in the Matern12 and exponential maps.

#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = gfs::kBandRows;
constexpr int kSweep = 4 * gfs::kBandThreads;  // columns a cross-Gram block writes
constexpr long long kMinTallGrid = 2 * 132;     // 8-row bands need two blocks on each of an H100's SMs
constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowStep = kTile / kRowsPerThread;  // the lower-tile block is kTile x kRowStep
constexpr int kMaxGridY = 65535;

// Block (band, sweep) = (blockIdx.x, blockIdx.y) writes rows [kR band,
// kR band + kR) x columns [1024 sweep, 1024 sweep + 1024) of out, clipped
// to N x M.
template <bool kVec, int kR>
__global__ void __launch_bounds__(gfs::kBandThreads)
    gram_cross_kernel(const float* __restrict__ X, int N, const float* __restrict__ X2, int M, int D,
                      const float* __restrict__ var_p, int kind, float* __restrict__ out) {
  const int r0 = blockIdx.x * kR, c0 = blockIdx.y * kSweep;
  const float var = *var_p;
  const auto value = [&](int, int, float d2) { return gfs::apply_map(kind, var, d2); };
  const auto pad = [](int, int) { return 0.0f; };  // never stored: the band ends at N x M
  gfs::gram_band<kVec, kR>(X, N, X2, M, D, r0, min(N, r0 + kR), c0, min(M, c0 + kSweep), out, M, value, pad);
}

template <bool kVec>
void launch_cross(const float* X, int N, const float* X2, int M, int D, const float* var, int kind, float* out,
                  unsigned sweeps, cudaStream_t s) {
  const long long tall = (N + kRows - 1) / kRows;
  if (tall * sweeps >= kMinTallGrid) {
    gram_cross_kernel<kVec, kRows><<<dim3(static_cast<unsigned>(tall), sweeps), gfs::kBandThreads, 0, s>>>(
        X, N, X2, M, D, var, kind, out);
  } else {
    gram_cross_kernel<kVec, 1><<<dim3(static_cast<unsigned>(N), sweeps), gfs::kBandThreads, 0, s>>>(
        X, N, X2, M, D, var, kind, out);
  }
}

// Block (bi, bj) = (blockIdx.x, blockIdx.y) writes output tile (bi, bj).
__global__ void gram_lower_kernel(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p,
                                  int kind, float* __restrict__ out) {
  const int bi = blockIdx.x;
  const int bj = blockIdx.y;
  const int col = bj * kTile + threadIdx.x;
  if (col >= N) return;
  const bool zero = bi < bj;
  const float var = zero ? 0.0f : var_p[0];
  const float* y = X + static_cast<size_t>(col) * D;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = bi * kTile + threadIdx.y + q * kRowStep;
    if (row >= N) break;
    const float v =
        zero ? 0.0f : gfs::apply_map(kind, var, gfs::sq_dist(X + static_cast<size_t>(row) * D, y, D));
    out[static_cast<size_t>(row) * N + col] = v;
  }
}

bool bad_args(int N, int M, int D, int kind) {
  return N < 0 || M < 0 || D < 1 || kind < gfs::kRbf || kind > gfs::kCosine;
}

}  // namespace

// out (N, M) = K(X, X2); var is a device pointer to the signal variance.
extern "C" int gfs_gram(const float* X, int N, const float* X2, int M, int D, const float* var, int kind,
                        float* out, void* stream) {
  const long long sweeps = (M + kSweep - 1) / kSweep;
  if (bad_args(N, M, D, kind) || sweeps > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && M > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (M % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0) {
      launch_cross<true>(X, N, X2, M, D, var, kind, out, static_cast<unsigned>(sweeps), s);
    } else {
      launch_cross<false>(X, N, X2, M, D, var, kind, out, static_cast<unsigned>(sweeps), s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out (N, N): lower tiles of K(X, X), strictly-upper 32 x 32 tiles zero.
extern "C" int gfs_gram_lower(const float* X, int N, int D, const float* var, int kind, float* out,
                              void* stream) {
  const long long tiles = (N + kTile - 1) / kTile;
  if (bad_args(N, N, D, kind) || tiles > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(tiles));
    const dim3 block(kTile, kRowStep);
    gram_lower_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(X, N, D, var, kind, out);
  }
  return static_cast<int>(cudaGetLastError());
}
