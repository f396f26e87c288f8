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
// The lower-tile Gram writes the same bands through the same writer, on a
// grid (sweep, band) of 1024-column sweeps x 8-row bands (1-row bands where
// that grid has fewer than two blocks an SM: GPMC's N = 1000). A band lies
// inside one 32-row tile row t (8 divides 32), so it forms the Gram in
// columns [0, min(N, 32 (t + 1))), the tiles on and below the diagonal, and
// writes the columns beyond with zero stores alone: they read no input and
// form no map (the TPU kernel's `pl.when(i < j)` does the same), and a
// sweep wholly beyond that edge reads nothing, not even the variance. Every
// row writes N floats, Gram or zero, so the grid is balanced without the
// operand's band pairing. 4 divides 32, so no float4 straddles a tile edge:
// a thread's four columns are all Gram or all zero. N a multiple of 4 and an
// aligned output take the float4 writer; any other N the scalar-store
// variant, as the cross Gram. The sweep varies fastest in the grid, so the
// blocks that run together write whole rows, one contiguous stretch of the
// output: at N = 10000, 0.129 ms alone against 0.139 ms in the cross Gram's
// band-fastest order, and 1.4% above a cudaMemsetAsync of the same 400 MB;
// at N = 2048 (one wave of 512 blocks) the two orders are within 2%, and
// evict-first zero stores gained 0-5% between N = 3072 and 6144 and none at
// 2048 or 10000, so the stores are plain (tools/gram_lower_bench.cu, H100
// 80GB HBM3 at 700 W). At N = 10000 that is 12,500 blocks of 32 KB where a
// block per 32 x 32 tile made 97,969 of 4 KB (48,828 of them zero tiles)
// with 4-byte stores, each re-reading both points' coordinates for every
// entry (0.162 ms alone).
//
// d^2 is formed directly from the coordinate differences (`gram_band`). It
// is the function the TPU computes with its full-precision
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
constexpr int kSweep = 4 * gfs::kBandThreads;  // columns a block writes
constexpr long long kMinTallGrid = 2 * 132;     // 8-row bands need two blocks on each of an H100's SMs
constexpr int kTile = 32;                         // ops.gram.TILE: the lower Gram zeroes whole tiles
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

// Block (sweep, band) = (blockIdx.x, blockIdx.y) writes rows [kR band,
// kR band + kR) x columns [1024 sweep, 1024 sweep + 1024) of out, clipped to
// N x N: the Gram left of its tile row's edge, zeros right of it.
template <bool kVec, int kR>
__global__ void __launch_bounds__(gfs::kBandThreads)
    gram_lower_kernel(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p, int kind,
                      float* __restrict__ out) {
  const int r0 = blockIdx.y * kR, r1 = min(N, r0 + kR);
  const int c0 = blockIdx.x * kSweep, c1 = min(N, c0 + kSweep);
  const int edge = min(N, (r0 / kTile + 1) * kTile);  // the first column of the strictly-upper tiles
  if (c0 < edge) {
    const float var = *var_p;
    const auto value = [&](int, int, float d2) { return gfs::apply_map(kind, var, d2); };
    const auto pad = [](int, int) { return 0.0f; };  // never stored: the band ends at the edge
    // columns at or past the edge count as absent (nc = edge): neither read nor mapped
    gfs::gram_band<kVec, kR>(X, N, X, edge, D, r0, r1, c0, min(c1, edge), out, N, value, pad);
  }
  // the strictly-upper tiles: the same columns a thread, zero stores only
  for (int j = 0; j < (kVec ? 1 : 4); ++j) {
    const int c = c0 + (kVec ? 4 * threadIdx.x : threadIdx.x + j * gfs::kBandThreads);
    if (c < edge || c >= c1) continue;
    for (int r = r0; r < r1; ++r) {
      float* p = out + static_cast<size_t>(r) * N + c;
      if (kVec) {
        *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        *p = 0.0f;
      }
    }
  }
}

// 8-row bands where the grid has two blocks on each SM, else 1-row bands
bool tall_bands(int N, long long sweeps) { return (N + kRows - 1) / kRows * sweeps >= kMinTallGrid; }

template <bool kVec>
void launch_cross(const float* X, int N, const float* X2, int M, int D, const float* var, int kind, float* out,
                  unsigned sweeps, cudaStream_t s) {
  if (tall_bands(N, sweeps)) {
    gram_cross_kernel<kVec, kRows><<<dim3((N + kRows - 1) / kRows, sweeps), gfs::kBandThreads, 0, s>>>(
        X, N, X2, M, D, var, kind, out);
  } else {
    gram_cross_kernel<kVec, 1><<<dim3(N, sweeps), gfs::kBandThreads, 0, s>>>(X, N, X2, M, D, var, kind, out);
  }
}

template <bool kVec>
void launch_lower(const float* X, int N, int D, const float* var, int kind, float* out, unsigned sweeps,
                  cudaStream_t s) {
  if (tall_bands(N, sweeps)) {
    gram_lower_kernel<kVec, kRows><<<dim3(sweeps, (N + kRows - 1) / kRows), gfs::kBandThreads, 0, s>>>(
        X, N, D, var, kind, out);
  } else {
    gram_lower_kernel<kVec, 1><<<dim3(sweeps, N), gfs::kBandThreads, 0, s>>>(X, N, D, var, kind, out);
  }
}

bool aligned(const float* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

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
    if (M % 4 == 0 && aligned(out)) {
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
  const unsigned sweeps = (N + kSweep - 1) / kSweep;
  if (bad_args(N, N, D, kind) || (N + kRows - 1) / kRows > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (N % 4 == 0 && aligned(out)) {
      launch_lower<true>(X, N, D, var, kind, out, sweeps, s);
    } else {
      launch_lower<false>(X, N, D, var, kind, out, sweeps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
