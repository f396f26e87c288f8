// The fused Cholesky's VJP in float64: from the float32 factor L (Np x Np,
// lower, Np a multiple of 64) and alpha = L^-1 D (Np x P),
//
//   W = L^-1,  beta = W^T alpha,  Dbar = 2 gq beta,
//   Kbar = 1/2 ghl W^T W - gq beta beta^T   (full and symmetric, in float32).
//
// Replaces no TPU kernel: the JAX package's `_csl_bwd`
// (gpflow_slim_tpu/ops/pallas_cholesky.py) is plain XLA ops, a triangular
// solve against the identity and a full product. Here it is LAPACK's potri
// (a triangular inverse, then the lower half of W^T W) with the cotangent's
// epilogue fused, every product in float64 on the FP64 tensor cores
// (`mma.sync` .f64; `wgmma` has no f64).
//
// What bounds it on an H100: the products, 2 Np^3 / 3 flop (Np^3 / 3 for
// the inverse, Np^3 / 3 for the lower half of W^T W) at 67 TFLOP/s: 10.1 ms
// at Np = 10048, against the 3 Np^3 of a solve against I and a full GEMM.
// The bytes (L read once as float32, W written once and read by the
// products through L2, Kbar written once as float32) are ~1.6 GB, ~0.5 ms.
// So the design does the least work that yields K^-1 and keeps the tensor
// cores fed: 14.5 ms at Np = 10048 on an H100 (700 W), 47 TFLOP/s, 1.43x
// the bound, against 68 ms for the solve against I and the GEMM.
//
// The design:
// - `kinv_diag_kernel`: each 64 x 64 diagonal block of L, widened to f64
//   on load, is inverted in shared memory, one column a thread, by a
//   column-oriented substitution (independent updates, a chain of 64).
// - the off-diagonal blocks by recursive doubling over 64-row blocks: at
//   level g every pair of adjacent diagonal blocks of g tiles,
//   [[A, 0], [B, C]] with A^-1 and C^-1 known, gets its lower-left block
//   -C^-1 B A^-1 in two batched launches: `kinv_left_kernel` forms
//   T^T = A^-T B^T (B read from L as float32) into the pair's block above
//   the diagonal, which nothing else uses, and `kinv_right_kernel` forms
//   -C^-1 T from it. Each sums over the triangle's nonzero tiles only, so
//   the levels together cost Np^3 / 3; log2(Np / 64) levels, two launches
//   each.
// - `kinv_beta_kernel`, `kinv_beta_sum_kernel`: beta = W^T alpha over the
//   lower tiles of W, each block column's sum split over the caller's
//   `chunks` blocks of ceil(Np / chunks) rows, the partial sums added in a
//   fixed order; and Dbar.
// - `kinv_kbar_kernel`: the tiles i >= j of W^T W, summed over k >= i only,
//   the two scalars and the rank-P term applied in f64 in the epilogue, then
//   rounded to f32 and written to the tile and to its mirror (the caller's
//   VJP reads the full symmetric Kbar).
// The products share one body (`tile_product`): a 64 x 64 output tile per
// block of four warps, each warp a 32 x 32 tile of m16n8k8 f64 MMAs, the inner
// dimension streamed through a two-stage cp.async ring whose stages keep
// each operand in its memory orientation (rows of either index), so every
// copy is 16 bytes of one memory row and the fragments read the stage
// across or along. Blocks are ordered longest sum first.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;         // tile side: the factor's block
constexpr int kBk = 32;        // inner indices a ring stage
constexpr int kStages = 2;
constexpr int kThreads = 128;  // four warps, 2 x 2, each 32 x 32 of the tile
constexpr int kOutLd = kT + 1;

// One operand's stage: the 64 x kBk slice of the tile (o, k), o the output
// row (A) or column (B), kept as memory holds it: s[k][o] when kKMajor (the
// operand's memory rows run along o), else s[o][k]. The row padding puts the
// four k (or o) of a quarter-warp's fragment reads on distinct banks and
// keeps rows 16-byte aligned.
template <typename T, bool kKMajor>
struct Stage {
  static constexpr int kRows = kKMajor ? kBk : kT;
  static constexpr int kRowLen = kKMajor ? kT : kBk;
  static constexpr int kLd = kRowLen + ((sizeof(T) == 4 && kKMajor) ? 8 : 4);
  static constexpr int kElems = kRows * kLd;
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy

  // copies inner indices [k0, k0 + kBk) of the operand at g (element (o, k)
  // at g[k * ld + o] when kKMajor, else g[o * ld + k]) into s
  static __device__ __forceinline__ void load(const T* __restrict__ g, long long ld, int k0, T* s) {
    constexpr int kPerRow = kRowLen / kVec;
    static_assert(kRows * kPerRow % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int q = 0; q < kRows * kPerRow / kThreads; ++q) {
      const int c = threadIdx.x + q * kThreads;
      const int r = c / kPerRow, col = (c % kPerRow) * kVec;
      const T* src = kKMajor ? g + static_cast<long long>(k0 + r) * ld + col : g + r * ld + k0 + col;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s + r * kLd + col));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    }
  }

  static __device__ __forceinline__ double at(const T* s, int o, int k) {
    return static_cast<double>(kKMajor ? s[k * kLd + o] : s[o * kLd + k]);
  }
};

// d += a b, m16n8k8 in f64 (sm_90): A (16 x 8) in 4 registers, B (8 x 8) in
// 2, C (16 x 8) in 4. Of the f64 shapes it ran the three products at 47
// TFLOP/s on an H100 at Np = 10048, as m16n8k16 did (which spilled) and
// m16n8k4 nearly did (46); the sm_80 m8n8k4 ran them at 28.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A warp's 32 x 32 accumulator: 2 x 4 MMAs of 16 x 8, 32 values a thread.
// Fragments (gid = lane / 4, tig = lane % 4): A register r at (gid + 8 (r %
// 2), tig + 4 (r / 2)), B register r at (tig + 4 r, gid), C register r at
// (gid + 8 (r / 2), 2 tig + r % 2).
struct Acc {
  double v[2][4][4] = {};

  // acc += the product of one stage
  template <class SA, class SB, typename TA, typename TB>
  __device__ __forceinline__ void stage(const TA* sa, const TB* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int m0 = (warp >> 1) * 32 + gid, n0 = (warp & 1) * 32 + gid;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[i][r] = SA::at(sa, m0 + 16 * i + 8 * (r % 2), kk + tig + 4 * (r / 2));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) b[j][r] = SB::at(sb, n0 + 8 * j, kk + tig + 4 * r);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f64(v[i][j], a[i], b[j]);
      }
    }
  }

  // out[m][n] = the accumulator
  __device__ __forceinline__ void store(double (*out)[kOutLd]) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m0 = (warp >> 1) * 32 + (lane >> 2), n0 = (warp & 1) * 32 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) out[m0 + 16 * i + 8 * (r / 2)][n0 + 8 * j + r % 2] = v[i][j][r];
      }
    }
  }
};

template <typename TA, bool kAK, typename TB, bool kBK>
constexpr int ring_bytes() {
  return kStages * (Stage<TA, kAK>::kElems * static_cast<int>(sizeof(TA)) +
                    Stage<TB, kBK>::kElems * static_cast<int>(sizeof(TB)));
}

// out[m][n] = sum over k in [k0, k1) of A(m, k) B(n, k), the 64 x 64 tile in
// f64 in shared memory (it reuses the ring). A(m, k) is a[k * lda + m] when
// kAK, else a[m * lda + k]; B likewise with kBK. k0 and k1 are multiples of
// kBk. Every thread of the block calls it; it ends synchronised.
template <typename TA, bool kAK, typename TB, bool kBK>
__device__ __forceinline__ void tile_product(const TA* __restrict__ a, long long lda, const TB* __restrict__ b,
                                             long long ldb, int k0, int k1, unsigned char* smem,
                                             double (*out)[kOutLd]) {
  using SA = Stage<TA, kAK>;
  using SB = Stage<TB, kBK>;
  TA* sa = reinterpret_cast<TA*>(smem);
  TB* sb = reinterpret_cast<TB*>(smem + kStages * SA::kElems * sizeof(TA));
  const int nc = (k1 - k0) / kBk;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nc) {
      SA::load(a, lda, k0 + st * kBk, sa + st * SA::kElems);
      SB::load(b, ldb, k0 + st * kBk, sb + st * SB::kElems);
    }
    gfs::cp_async_commit();
  }
  Acc acc;
  for (int c = 0; c < nc; ++c) {
    const int nx = c + kStages - 1;
    if (nx < nc) {
      SA::load(a, lda, k0 + nx * kBk, sa + (nx % kStages) * SA::kElems);
      SB::load(b, ldb, k0 + nx * kBk, sb + (nx % kStages) * SB::kElems);
    }
    gfs::cp_async_commit();
    gfs::cp_async_wait<kStages - 1>();
    __syncthreads();
    acc.template stage<SA, SB>(sa + (c % kStages) * SA::kElems, sb + (c % kStages) * SB::kElems);
    __syncthreads();
  }
  gfs::cp_async_wait<0>();
  acc.store(out);
  __syncthreads();
}

// Writes s * out (the 64 x 64 tile) to dst, row stride ld, row by row.
__device__ __forceinline__ void store_tile(const double (*out)[kOutLd], double s, double* __restrict__ dst,
                                           long long ld) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int m = e / kT, n = e % kT;
    dst[m * ld + n] = s * out[m][n];
  }
}

// W's diagonal 64 x 64 blocks: the inverse of L's, upper entries 0. One
// block of 64 threads per diagonal block, thread j solving L_bb x = e_j:
// once x_k is final it is eliminated from every row below (the updates are
// independent; L's entries are read by all threads at once, a broadcast).
// Reads only the lower triangle of L's block.
__global__ void __launch_bounds__(kT) kinv_diag_kernel(const float* __restrict__ L, int Np, double* __restrict__ W) {
  __shared__ double l[kT][kT];
  __shared__ double dinv[kT];
  const int j = threadIdx.x;
  const long long o = static_cast<long long>(blockIdx.x) * kT;
  for (int i = 0; i < kT; ++i) l[i][j] = j <= i ? static_cast<double>(L[(o + i) * Np + o + j]) : 0.0;
  __syncthreads();
  dinv[j] = 1.0 / l[j][j];
  __syncthreads();
  double v[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) v[i] = i == j ? 1.0 : 0.0;
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    v[k] *= dinv[k];
#pragma unroll
    for (int i = k + 1; i < kT; ++i) v[i] -= l[i][k] * v[k];
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) W[(o + i) * Np + o + j] = v[i];
}

// A pair of level g: tiles [r0, r0 + g) (A) and [r0 + g, r0 + g + g2) (C),
// r0 = 2 g p, g2 = min(g, nb - r0 - g). Its T^T tile (J, I), J < g, I < g2:
// sum over K in [J, g) of A^-1[K, J]^T B[I, K]^T, stored at W's tile
// (r0 + J, r0 + g + I), above the diagonal. Grid: x = p g + I, y = J (the
// longest sums first).
__global__ void __launch_bounds__(kThreads, 3)
    kinv_left_kernel(const float* __restrict__ L, double* __restrict__ W, int Np, int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = Np / kT;
  const int p = blockIdx.x / g, I = blockIdx.x % g, J = blockIdx.y;
  const int r0 = 2 * g * p, r1 = r0 + g;
  if (I >= nb - r1) return;
  auto out = reinterpret_cast<double(*)[kOutLd]>(smem);
  const long long ld = Np;
  const double* a = W + static_cast<long long>(r0) * kT * ld + (r0 + J) * kT;  // A^-1(k, m) at a[k ld + m]
  const float* b = L + static_cast<long long>(r1 + I) * kT * ld + r0 * kT;     // B(n, k) at b[n ld + k]
  tile_product<double, true, float, false>(a, ld, b, ld, J * kT, g * kT, smem, out);
  store_tile(out, 1.0, W + static_cast<long long>(r0 + J) * kT * ld + (r1 + I) * kT, ld);
}

// The pair's lower-left tile (I, J): -sum over K in [0, I] of C^-1[I, K]
// T[K, J], T[K, J] read from the T^T that kinv_left_kernel stored. Grid:
// x = p g + J, y = g - 1 - I (the longest sums first).
__global__ void __launch_bounds__(kThreads, 3)
    kinv_right_kernel(double* __restrict__ W, int Np, int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = Np / kT;
  const int p = blockIdx.x / g, J = blockIdx.x % g, I = g - 1 - static_cast<int>(blockIdx.y);
  const int r0 = 2 * g * p, r1 = r0 + g;
  if (I >= nb - r1) return;
  auto out = reinterpret_cast<double(*)[kOutLd]>(smem);
  const long long ld = Np;
  const double* a = W + static_cast<long long>(r1 + I) * kT * ld + r1 * kT;  // C^-1(m, k) at a[m ld + k]
  const double* b = W + static_cast<long long>(r0 + J) * kT * ld + r1 * kT;  // T(k, n) at b[n ld + k]
  tile_product<double, false, double, false>(a, ld, b, ld, 0, (I + 1) * kT, smem, out);
  store_tile(out, -1.0, W + static_cast<long long>(r1 + I) * kT * ld + (r0 + J) * kT, ld);
}

constexpr int kBetaThreads = 256;  // 64 columns x 4 row lanes
constexpr int kBetaLanes = kBetaThreads / kT;
constexpr int kBetaP = 4;          // right-hand-side columns a pass, one a row lane in the final sum
static_assert(kBetaP <= kBetaLanes, "a row lane for each column of a pass");

// part[s][c, :] = sum over rows k in chunk s of block column J (`rows` rows
// from J * 64 + s * rows on, below the diagonal block's top; W's upper
// entries inside the diagonal block are 0) of W[k, c] alpha[k, :], for the
// 64 columns c of J; 0 past the last row. Grid: x = J, y = s. Four row
// lanes summed in shared memory in a fixed order.
__global__ void __launch_bounds__(kBetaThreads)
    kinv_beta_kernel(const double* __restrict__ W, const float* __restrict__ alpha, int Np, int P, int rows,
                     double* __restrict__ part) {
  __shared__ double red[kBetaLanes][kBetaP][kT];
  const int c = threadIdx.x % kT, lane = threadIdx.x / kT;
  const long long col = static_cast<long long>(blockIdx.x) * kT + c;
  const long long k0 = static_cast<long long>(blockIdx.x) * kT + static_cast<long long>(blockIdx.y) * rows;
  const long long k1 = min(k0 + rows, static_cast<long long>(Np));
  double* dst = part + static_cast<long long>(blockIdx.y) * Np * P;
  for (int p0 = 0; p0 < P; p0 += kBetaP) {
    double acc[kBetaP] = {};
#pragma unroll 4
    for (long long k = k0 + lane; k < k1; k += kBetaLanes) {
      const double w = W[k * Np + col];
#pragma unroll
      for (int q = 0; q < kBetaP; ++q) {
        if (p0 + q < P) acc[q] += w * static_cast<double>(alpha[k * P + p0 + q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBetaP; ++q) red[lane][q][c] = acc[q];
    __syncthreads();
    if (lane < kBetaP && p0 + lane < P) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < kBetaLanes; ++r) s += red[r][lane][c];
      dst[col * P + p0 + lane] = s;
    }
    __syncthreads();
  }
}

// beta = the chunks' sum, in chunk order; Dbar = 2 gq beta. One thread an
// entry of (Np, P).
__global__ void kinv_beta_sum_kernel(const double* __restrict__ part, int chunks, long long n,
                                     const float* __restrict__ gq, double* __restrict__ beta,
                                     float* __restrict__ dbar) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int c = 0; c < chunks; ++c) s += part[c * n + e];
  beta[e] = s;
  dbar[e] = static_cast<float>(2.0 * static_cast<double>(*gq) * s);
}

// Kbar's tile (I, J), I >= J, from the linear index over the lower
// triangle of tiles (small I first: the longest sums first): the sum over
// K >= I of W[K, I]^T W[K, J], then 1/2 ghl x that - gq beta_I beta_J^T in
// f64, rounded to f32 and written to (I, J) and, off the diagonal, to (J, I).
__global__ void __launch_bounds__(kThreads, 3)
    kinv_kbar_kernel(const double* __restrict__ W, int Np, const double* __restrict__ beta, int P,
                     const float* __restrict__ ghl, const float* __restrict__ gq, float* __restrict__ kbar) {
  extern __shared__ __align__(16) unsigned char smem[];
  int I, J;
  gfs::tri_index(blockIdx.x, I, J);
  auto out = reinterpret_cast<double(*)[kOutLd]>(smem);
  const long long ld = Np;
  tile_product<double, true, double, true>(W + I * kT, ld, W + J * kT, ld, I * kT, Np, smem, out);
  const double hl = 0.5 * static_cast<double>(*ghl), q = static_cast<double>(*gq);
  const double* bi = beta + static_cast<long long>(I) * kT * P;
  const double* bj = beta + static_cast<long long>(J) * kT * P;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int m = e / kT, n = e % kT;
    double s = 0.0;
    for (int r = 0; r < P; ++r) s += bi[m * P + r] * bj[n * P + r];
    const double v = hl * out[m][n] - q * s;
    out[m][n] = v;
    kbar[(static_cast<long long>(I) * kT + m) * ld + J * kT + n] = static_cast<float>(v);
  }
  if (I == J) return;
  __syncthreads();
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int n = e / kT, m = e % kT;
    kbar[(static_cast<long long>(J) * kT + n) * ld + I * kT + m] = static_cast<float>(out[m][n]);
  }
}

constexpr int kLeftSmem = ring_bytes<double, true, float, false>();
constexpr int kRightSmem = ring_bytes<double, false, double, false>();
constexpr int kKbarSmem = ring_bytes<double, true, double, true>();
static_assert(kT * kOutLd * 8 <= kLeftSmem && kT * kOutLd * 8 <= kRightSmem && kT * kOutLd * 8 <= kKbarSmem,
              "the output tile reuses the ring");

}  // namespace

// L (Np, Np) float32, its lower triangle the factor (entries above the
// diagonal blocks are not read); alpha (Np, P) float32; ghl, gq device
// pointers to the two float32 cotangents. Scratch W (Np, Np) float64 and
// beta (chunks + 1, Np, P) float64, chunks >= 1 the blocks each block
// column's sum for beta is split over; outputs kbar (Np, Np) and dbar (Np,
// P) float32. Np a multiple of 64; L and W 16-byte aligned. 4 + 2
// ceil(log2(Np / 64)) launches on the stream, no synchronisation.
extern "C" int gfs_csl_vjp(const float* L, int Np, const float* alpha, int P, const float* ghl, const float* gq,
                           double* W, double* beta, int chunks, float* kbar, float* dbar, void* stream) {
  if (Np <= 0 || Np % kT != 0 || P < 1 || chunks < 1 || reinterpret_cast<std::uintptr_t>(L) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(W) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the rings pass 48 KB: allowed per function, on the current device
  constexpr auto kMaxSmem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(kinv_left_kernel, kMaxSmem, kLeftSmem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kinv_right_kernel, kMaxSmem, kRightSmem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kinv_kbar_kernel, kMaxSmem, kKbarSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = Np / kT;
  kinv_diag_kernel<<<nb, kT, 0, s>>>(L, Np, W);
  for (int g = 1; g < nb; g *= 2) {
    const int pairs = (nb - g + 2 * g - 1) / (2 * g);  // pairs p with a second block: 2 g p + g < nb
    const dim3 grid(static_cast<unsigned>(pairs * g), static_cast<unsigned>(g));
    kinv_left_kernel<<<grid, kThreads, kLeftSmem, s>>>(L, W, Np, g);
    kinv_right_kernel<<<grid, kThreads, kRightSmem, s>>>(W, Np, g);
  }
  const int rows = (Np + chunks - 1) / chunks;  // chunks of this many rows cover every block column
  const long long n = static_cast<long long>(Np) * P;
  double* part = beta + n;
  kinv_beta_kernel<<<dim3(nb, chunks), kBetaThreads, 0, s>>>(W, alpha, Np, P, rows, part);
  kinv_beta_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(part, chunks, n, gq, beta, dbar);
  kinv_kbar_kernel<<<nb * (nb + 1) / 2, kThreads, kKbarSmem, s>>>(W, Np, beta, P, ghl, gq, kbar);
  return static_cast<int>(cudaGetLastError());
}
