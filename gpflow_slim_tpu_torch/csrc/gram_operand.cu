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
//
// Its VJP (`gram_operand_vjp_kernel`, then `gram_operand_vjp_reduce_kernel`)
// replaces no TPU kernel: `_opnd_bwd` (gpflow_slim_tpu/ops/pallas_gram.py
// :363-372) is XLA ops, and the port's plain version is ops/gram.py's
// `_gram_vjp`, N^2 float64 torch passes. For the cotangent g of the
// operand's [:N, :N] block it forms, per pair i > j, s = g_ij + g_ji,
//
//   gvar += s f(d2),  G = 2 var s f'(d2) cut,  gX_i += G (x_i - x_j),  gX_j -= G (x_i - x_j)
//
// (cut 1, or 1/2 at d2 = 0, the plain path's split of the clamp's tie), and
// per diagonal entry gvar += g_ii f(0), gnoise += g_ii: `_gram_vjp`'s
// closed form 2 (Xs rowsum(G) - G Xs) plus its transpose, written per pair,
// so it holds for any cotangent, symmetric or not, and takes x_i - x_j
// entry by entry rather than as a difference of two sums. All of it in
// float64: d2 by direct differences of the inputs widened to float64, the
// map and slope from common.cuh's `unit_map_slope<double>`.
//
// What bounds it on an H100: at N = 10000, reading the cotangent's N x N
// block once, 0.40 GB of float32 (0.12 ms at 3.35 TB/s), just above the
// arithmetic, ~5e7 lower pairs of ~60 float64 operations (d2, one float64
// exp, the multiply-adds of the sums: ~3e9, 0.09 ms at 33.5 TFLOP/s). The
// plain path wrote and read several N^2 float64 arrays (11.4 ms). Here a
// block takes one 64 x 64 tile of the lower triangle of tiles (I >= J): it
// reads g's (I, J) tile and its (J, I) tile, both along rows, and adds the
// second into the first transposed through shared memory, so the N^2 block
// is read once and no N^2 intermediate is written. Its 256 threads take
// 4 x 4 pairs each; a thread's row sums meet in shuffles across the 16
// threads of its rows, the column sums in shuffles and then shared memory
// across the warps, in a fixed order. The map's kind is a template
// parameter: with no branch on it, the compiler interleaves a thread's 16
// maps, whose float64 exp and sqrt are long dependent chains (a runtime
// kind took 18% longer for the RBF, 45% for Matern52 and the cosine, on an
// H100 at N = 10000). The tile writes float64 partials for its 64 + 64 rows
// (a tile on the diagonal adds the two) and one gvar and trace partial to a
// scratch; the reduce kernel sums each row's partials, one per tile of its
// tile row, in a fixed order, and rounds to float32 once. No atomics: the
// result is the same bits from run to run. The inputs are staged 4
// dimensions at a time, so any D runs. On an H100 (700 W) at N = 10000,
// D = 1, the two launches take 0.35 ms for the RBF (2.9x the read), 0.43-0.52
// ms for the other kinds, whose maps add a float64 sqrt and division.

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

// -- the operand's VJP ------------------------------------------------------

constexpr int kVjpTile = 64;                           // a block's tile of pairs
constexpr int kVjpThreads = 256;                       // 16 x 16 threads, 4 x 4 pairs each
constexpr int kVjpWarps = kVjpThreads / 32;
constexpr int kVjpDims = 4;                            // input dimensions staged at a time
constexpr int kVjpSub = kVjpTile / 16;                 // a thread's rows (and columns)
constexpr int kVjpLoads = kVjpTile * kVjpTile / kVjpThreads;  // cotangent entries a thread loads a tile

struct VjpShared {
  union {
    double s[kVjpTile][kVjpTile + 1];  // g_ij + g_ji over the tile (padded row: conflict-free transposes)
    struct {
      double col[kVjpDims][kVjpWarps][kVjpTile];  // each warp's column sums
      double row[kVjpDims][kVjpTile];             // the row sums
    } red;
  } u;
  double xr[kVjpDims][kVjpTile];  // the tile rows' coordinates, float64
  double xc[kVjpDims][kVjpTile];  // the tile columns'
  double scal[kVjpWarps][2];      // each warp's gvar and trace
};

// Stages dimensions d0 .. d0 + kVjpDims of the tile's row and column
// inputs, widened to float64; 0 past N or D.
__device__ __forceinline__ void vjp_stage(VjpShared& sm, const float* __restrict__ X, int N, int D, int i0,
                                          int j0, int d0) {
  for (int e = threadIdx.x; e < 2 * kVjpDims * kVjpTile; e += kVjpThreads) {
    const int which = e / (kVjpDims * kVjpTile), dd = (e / kVjpTile) % kVjpDims, r = e % kVjpTile;
    const int row = (which ? j0 : i0) + r, d = d0 + dd;
    const double v = row < N && d < D ? static_cast<double>(X[static_cast<size_t>(row) * D + d]) : 0.0;
    (which ? sm.xc : sm.xr)[dd][r] = v;
  }
}

// One tile (I, J), I >= J, of the lower triangle of 64 x 64 tiles, for the
// map kKind (common.cuh's `Kind`). Writes
// part[((I nt + J) D + d) 64 + r] (the row sums of tile row I against tile
// column J), part[((J nt + I) D + d) 64 + r] (the column sums: rows of tile
// row J against I), the two added where I = J, and scal[2 t], scal[2 t + 1]
// (gvar's and the trace's partials) for the tile's index t.
template <int kKind>
__global__ void __launch_bounds__(kVjpThreads, 2)
    gram_operand_vjp_kernel(const float* __restrict__ g, long long ldg, const float* __restrict__ X, int N, int D,
                            const float* __restrict__ var_p, int nt, double* __restrict__ part,
                            double* __restrict__ scal) {
  __shared__ VjpShared sm;
  int bi, bj;
  gfs::tri_index(blockIdx.x, bi, bj);
  const int i0 = bi * kVjpTile, j0 = bj * kVjpTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31, warp = tid >> 5;

  // s = g_ij + g_ji over the tile: both tiles read along rows, the second
  // added transposed; 0 outside the N x N block
  {
    float a[kVjpLoads], b[kVjpLoads];
#pragma unroll
    for (int k = 0; k < kVjpLoads; ++k) {
      const int e = tid + k * kVjpThreads, r = e / kVjpTile, c = e % kVjpTile;
      a[k] = i0 + r < N && j0 + c < N ? g[static_cast<size_t>(i0 + r) * ldg + j0 + c] : 0.0f;
      b[k] = j0 + r < N && i0 + c < N ? g[static_cast<size_t>(j0 + r) * ldg + i0 + c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kVjpLoads; ++k) {
      const int e = tid + k * kVjpThreads;
      sm.u.s[e / kVjpTile][e % kVjpTile] = static_cast<double>(a[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kVjpLoads; ++k) {
      const int e = tid + k * kVjpThreads;
      sm.u.s[e % kVjpTile][e / kVjpTile] += static_cast<double>(b[k]);  // g[j0 + r][i0 + c] is the pair (c, r)
    }
  }

  // d2 of the thread's pairs: rows ty + 16 a, columns tx + 16 b
  double acc[kVjpSub][kVjpSub] = {};
  for (int d0 = 0; d0 < D; d0 += kVjpDims) {
    __syncthreads();
    vjp_stage(sm, X, N, D, i0, j0, d0);
    __syncthreads();
    const int nd = min(kVjpDims, D - d0);
    for (int dd = 0; dd < nd; ++dd) {
      double xc[kVjpSub];
#pragma unroll
      for (int b = 0; b < kVjpSub; ++b) xc[b] = sm.xc[dd][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < kVjpSub; ++a) {
        const double xr = sm.xr[dd][ty + 16 * a];
#pragma unroll
        for (int b = 0; b < kVjpSub; ++b) {
          const double diff = xr - xc[b];
          acc[a][b] = fma(diff, diff, acc[a][b]);
        }
      }
    }
  }

  // the map: gvar's share, and acc becomes G = 2 var s f'(d2) cut
  const double var = static_cast<double>(*var_p);
  double gv = 0.0, tr = 0.0;
#pragma unroll
  for (int a = 0; a < kVjpSub; ++a) {
#pragma unroll
    for (int b = 0; b < kVjpSub; ++b) {
      const int il = ty + 16 * a, jl = tx + 16 * b;
      const double s = i0 + il > j0 + jl ? sm.u.s[il][jl] : 0.0;  // pairs i > j; the pad's s is 0
      double f, slope;
      gfs::unit_map_slope(kKind, acc[a][b], f, slope);
      gv = fma(s, f, gv);
      const double cut = acc[a][b] > 0.0 ? 1.0 : 0.5;
      acc[a][b] = 2.0 * var * s * slope * cut;
    }
  }
  if (bi == bj && tid < kVjpTile && i0 + tid < N) {  // the diagonal: g_ii f(0), and the trace
    double f0, s0;
    gfs::unit_map_slope(kKind, 0.0, f0, s0);
    tr = 0.5 * sm.u.s[tid][tid];
    gv = fma(tr, f0, gv);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gv += __shfl_xor_sync(0xffffffffu, gv, o);
    tr += __shfl_xor_sync(0xffffffffu, tr, o);
  }
  if (lane == 0) {
    sm.scal[warp][0] = gv;
    sm.scal[warp][1] = tr;
  }

  // gX: per dimension, the thread's row and column sums, then the tile's
  const long long t = blockIdx.x;
  const size_t slot = static_cast<size_t>(kVjpTile) * D;
  double* const row_part = part + (static_cast<size_t>(bi) * nt + bj) * slot;
  double* const col_part = part + (static_cast<size_t>(bj) * nt + bi) * slot;
  for (int d0 = 0; d0 < D; d0 += kVjpDims) {
    __syncthreads();  // s, or the last chunk's sums, read
    vjp_stage(sm, X, N, D, i0, j0, d0);
    __syncthreads();
    const int nd = min(kVjpDims, D - d0);
    for (int dd = 0; dd < nd; ++dd) {
      double xc[kVjpSub], rs[kVjpSub] = {}, cs[kVjpSub] = {};
#pragma unroll
      for (int b = 0; b < kVjpSub; ++b) xc[b] = sm.xc[dd][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < kVjpSub; ++a) {
        const double xr = sm.xr[dd][ty + 16 * a];
#pragma unroll
        for (int b = 0; b < kVjpSub; ++b) {
          const double c = acc[a][b] * (xr - xc[b]);
          rs[a] += c;
          cs[b] -= c;
        }
      }
#pragma unroll
      for (int a = 0; a < kVjpSub; ++a) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], o);  // over tx
      }
#pragma unroll
      for (int b = 0; b < kVjpSub; ++b) cs[b] += __shfl_xor_sync(0xffffffffu, cs[b], 16);  // ty = 2 warp, +1
      if (tx == 0) {
#pragma unroll
        for (int a = 0; a < kVjpSub; ++a) sm.u.red.row[dd][ty + 16 * a] = rs[a];
      }
      if (lane < 16) {
#pragma unroll
        for (int b = 0; b < kVjpSub; ++b) sm.u.red.col[dd][warp][tx + 16 * b] = cs[b];
      }
    }
    __syncthreads();
    for (int e = tid; e < nd * kVjpTile; e += kVjpThreads) {
      const int dd = e / kVjpTile, r = e % kVjpTile;
      double c = 0.0;
#pragma unroll
      for (int w = 0; w < kVjpWarps; ++w) c += sm.u.red.col[dd][w][r];
      const double rsum = sm.u.red.row[dd][r];
      const size_t at = static_cast<size_t>(d0 + dd) * kVjpTile + r;
      if (bi == bj) {
        row_part[at] = rsum + c;
      } else {
        row_part[at] = rsum;
        col_part[at] = c;
      }
    }
  }
  if (tid == 0) {
    double a = 0.0, b = 0.0;
#pragma unroll
    for (int w = 0; w < kVjpWarps; ++w) {
      a += sm.scal[w][0];
      b += sm.scal[w][1];
    }
    scal[2 * t] = a;
    scal[2 * t + 1] = b;
  }
}

constexpr int kVjpReduceThreads = 256;
constexpr int kVjpReduceWays = kVjpReduceThreads / kVjpTile;  // a row's partials split four ways

// Block (R, d) for R < nt: gX[64 R + r][d] = sum over tile columns k of
// part[((R nt + k) D + d) 64 + r], k = q, q + 4, ... for each quarter q,
// then the quarters in order; the last block: gvar and gnoise from the
// tiles' partials. Each sum in a fixed order, rounded to float32 once.
__global__ void __launch_bounds__(kVjpReduceThreads)
    gram_operand_vjp_reduce_kernel(const double* __restrict__ part, const double* __restrict__ scal, long long tiles,
                                   int N, int D, int nt, float* __restrict__ gX, float* __restrict__ gvar,
                                   float* __restrict__ gnoise) {
  __shared__ double red[2][kVjpReduceThreads];
  const int tid = threadIdx.x;
  if (blockIdx.x == static_cast<unsigned>(nt) * D) {
    double a = 0.0, b = 0.0;
#pragma unroll 4
    for (long long t = tid; t < tiles; t += kVjpReduceThreads) {
      a += scal[2 * t];
      b += scal[2 * t + 1];
    }
    red[0][tid] = a;
    red[1][tid] = b;
    __syncthreads();
    for (int h = kVjpReduceThreads / 2; h > 0; h >>= 1) {
      if (tid < h) {
        red[0][tid] += red[0][tid + h];
        red[1][tid] += red[1][tid + h];
      }
      __syncthreads();
    }
    if (tid == 0) {
      *gvar = static_cast<float>(red[0][0]);
      *gnoise = static_cast<float>(red[1][0]);
    }
    return;
  }
  const int R = blockIdx.x / D, d = blockIdx.x % D, r = tid % kVjpTile, q = tid / kVjpTile;
  const size_t slot = static_cast<size_t>(kVjpTile) * D;
  const double* p = part + static_cast<size_t>(R) * nt * slot + static_cast<size_t>(d) * kVjpTile + r;
  double s = 0.0;
#pragma unroll 4
  for (int k = q; k < nt; k += kVjpReduceWays) s += p[static_cast<size_t>(k) * slot];
  red[0][tid] = s;
  __syncthreads();
  if (q == 0) {
    for (int w = 1; w < kVjpReduceWays; ++w) s += red[0][w * kVjpTile + r];
    const int row = R * kVjpTile + r;
    if (row < N) gX[static_cast<size_t>(row) * D + d] = static_cast<float>(s);
  }
}

// The float64 scratch of the VJP's partials: nt^2 64 D row sums, then a
// gvar and a trace partial for each of the nt (nt + 1) / 2 tiles.
long long vjp_scratch(int N, int D) {
  const long long nt = (N + kVjpTile - 1) / kVjpTile;
  return nt * nt * kVjpTile * D + nt * (nt + 1);
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

// The number of float64s of scratch gfs_gram_operand_vjp needs for N
// inputs of D dimensions (a count, not an error code; 0 where N < 0 or
// D < 1).
extern "C" long long gfs_gram_operand_vjp_scratch(int N, int D) { return N < 0 || D < 1 ? 0 : vjp_scratch(N, D); }

// The VJP of the operand on the [:N, :N] block of its float32 cotangent g
// (row stride ldg; nothing past the block is read): gX (N, D) float32, and
// gvar and gnoise, one float32 each. X (N, D) float32, var a device scalar.
// partial: gfs_gram_operand_vjp_scratch(N, D) float64s of scratch. Two
// launches (the tiles, then their reduce), no host sync.
extern "C" int gfs_gram_operand_vjp(const float* g, long long ldg, const float* X, int N, int D, const float* var,
                                    int kind, double* partial, long long n_partial, float* gX, float* gvar,
                                    float* gnoise, void* stream) {
  const long long nt = (N + kVjpTile - 1) / kVjpTile;
  if (N < 0 || D < 1 || ldg < N || kind < gfs::kRbf || kind > gfs::kCosine || n_partial != vjp_scratch(N, D) ||
      nt * D + 1 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = nt * (nt + 1) / 2;
  double* const scal = partial + nt * nt * kVjpTile * D;
  if (tiles > 0) {
    using Kernel = void (*)(const float*, long long, const float*, int, int, const float*, int, double*, double*);
    const Kernel by_kind[] = {gram_operand_vjp_kernel<gfs::kRbf>,        gram_operand_vjp_kernel<gfs::kMatern12>,
                              gram_operand_vjp_kernel<gfs::kMatern32>,   gram_operand_vjp_kernel<gfs::kMatern52>,
                              gram_operand_vjp_kernel<gfs::kExponential>, gram_operand_vjp_kernel<gfs::kCosine>};
    by_kind[kind]<<<static_cast<unsigned>(tiles), kVjpThreads, 0, s>>>(g, ldg, X, N, D, var, static_cast<int>(nt),
                                                                      partial, scal);
  }
  gram_operand_vjp_reduce_kernel<<<static_cast<unsigned>(nt * D + 1), kVjpReduceThreads, 0, s>>>(
      partial, scal, tiles, N, D, static_cast<int>(nt), gX, gvar, gnoise);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
