// The Cholesky operand of exact GPR under a Neural Kernel Network, and its
// VJP: the lower triangle of K_NKN(X, X) + noise * I padded to pad_to with a
// unit-diagonal extension, and the gradient of <Kbar, K_NKN + noise I> by
// every parameter of the network and by the noise.
//
// The network is the paper's time-series one: 8 primitive kernels, then
// Linear(8 -> 8), Product(step 2), Linear(4 -> 4), Product(step 2),
// Linear(2 -> 1), no biases (ops/nkn.py `NET`; `gfs_nkn_layout` reports
// the kinds and widths below). Its parameters are one float vector `th`
// (ops/nkn.py): for primitive k a slot of S = 1 + 2 D numbers at k * S,
//
//   [var, a_0 .. a_{D-1}, c_0 .. c_{D-1}]
//
// with a_d = 1 / lengthscale_d (the stationary kinds, RationalQuadratic,
// Periodic) or the ARD variance v_d (Linear, whose var is unused), c_d =
// pi / period_d (Periodic) or c_0 = alpha (RationalQuadratic), else 0; then
// the three weight matrices row-major, (out, in) as NKNLinear holds them.
// With delta_d = x_d - y_d and t_d = a_d delta_d:
//
//   stationary:  var f(d2), d2 = sum t_d^2 (f: common.cuh's unit_map_slope)
//   RQ:          var (1 + d2 / (2 alpha))^(-alpha)
//   Linear:      sum v_d x_d y_d
//   Periodic:    var exp(-1/2 sum (a_d sin(c_d delta_d))^2)
//
// The gradient of one entry is a vector over the same slots (the noise's
// last), added into the caller's accumulators; its cotangent is the
// caller's.
//
// No TPU kernel stands behind these: the JAX package builds an NKN's Gram
// from its primitives' Grams, one N x N array a primitive and a layer, and
// the port's composite route does the same (a GPR step at N = 10000 peaks
// at 20.1 GB on an H100, most of it N x N arrays kept for autograd). Here
// every entry is formed in registers, primitives and layers at once
// (`value`, `add_gradient`), and nothing of size N^2 is kept: the backward
// forms each entry again (the same step peaks at 2.0 GB).
//
// Forward (`nkn_operand_kernel`): the schedule of gram_operand.cu, bands of
// 8 rows paired b with nb - 1 - b, a block writing one 1024-column sweep
// of a pair, four consecutive columns a thread and one 16-byte store a row
// of four. A band writes its rows from column 0 to the end of its diagonal
// 8 x 8 block; a band of pad rows (all at or past N) forms no entry. An
// entry is 8 primitives (6 transcendentals for the paper's mix) and 82
// multiply-adds, so arithmetic bounds the forward: 0.86 ms at N = 10000 on
// an H100, against 0.06 ms for its 0.2 GB of stores.
//
// Backward (`nkn_vjp_kernel`, then `nkn_vjp_reduce_kernel`): the cotangent
// Kbar is read once, on and below the diagonal of its leading N x N block,
// and taken as symmetric (the fused Cholesky's VJP gives it so): an entry
// below the diagonal stands for itself and its mirror, weight 2. Bands of
// 32 rows, paired as above, a block taking one 128-column sweep of a pair,
// one column a thread (a warp reads 128 contiguous bytes of a row). A
// thread adds its entries' gradients into float accumulators in registers
// (Layout::kAcc of them, ~110 in use); a warp then sums them in a
// reduce-scatter of five shuffle rounds (each lane ends with kAcc / 32
// of the sums, no lane sums all kAcc), in float64 from there on: across the
// block's warps in shared memory, and across blocks in the reduce kernel,
// each accumulator's partials read in a fixed order. A float32 sum covers at
// most 32 entries a lane and 1024 a warp.
//
// The parameters go to the card's constant memory (a stream-ordered copy
// from the device vector, no host sync), where each multiply-add reads its
// weight as an operand.

#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

// The network, its primitives' kinds past common.cuh's stationary `Kind`s,
// and the layers' widths.
enum PrimKind { kRq = gfs::kCosine + 1, kLinear, kPeriodic };
constexpr int kPrims = 8;         // primitives, into Linear(kPrims -> kH1)
constexpr int kH1 = 8;            // then Product(step 2)
constexpr int kA1 = kH1 / 2;      // into Linear(kA1 -> kH2)
constexpr int kH2 = 4;            // then Product(step 2)
constexpr int kA2 = kH2 / 2;      // into Linear(kA2 -> 1)

template <int kD>
struct Layout {
  static constexpr int kS = 1 + 2 * kD;            // a primitive's slot
  static constexpr int kW1 = kPrims * kS;          // Linear(kPrims -> kH1)
  static constexpr int kW2 = kW1 + kPrims * kH1;   // Linear(kA1 -> kH2)
  static constexpr int kW3 = kW2 + kA1 * kH2;      // Linear(kA2 -> 1)
  static constexpr int kTheta = kW3 + kA2;         // the parameters
  static constexpr int kNoise = kTheta;            // the noise's gradient
  static constexpr int kAcc = (kTheta + 1 + 31) / 32 * 32;  // accumulators, a multiple of a warp
};

struct Kinds {
  int k[kPrims];
};

// Primitive k's value at (x, y); with kGrad, dp[s] = its derivative by slot
// parameter s.
template <int kD, bool kGrad, class Th>
__device__ __forceinline__ float primitive(const Th& th, int k, int kind, const float (&x)[kD],
                                           const float (&y)[kD], float (&dp)[Layout<kD>::kS]) {
  const int b = k * Layout<kD>::kS;
  if (kGrad) {
#pragma unroll
    for (int s = 0; s < Layout<kD>::kS; ++s) dp[s] = 0.0f;
  }
  if (kind == kLinear) {
    float p = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float xy = x[d] * y[d];
      p = fmaf(th[b + 1 + d], xy, p);
      if (kGrad) dp[1 + d] = xy;
    }
    return p;
  }
  const float var = th[b];
  if (kind == kPeriodic) {
    float e = 0.0f, q[kD], sn[kD], cs[kD], del[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      del[d] = x[d] - y[d];
      sincosf(th[b + 1 + kD + d] * del[d], &sn[d], &cs[d]);
      q[d] = sn[d] * th[b + 1 + d];
      e = fmaf(q[d], q[d], e);
    }
    const float f = expf(-0.5f * e);
    const float p = var * f;
    if (kGrad) {
      dp[0] = f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dp[1 + d] = -p * q[d] * sn[d];
        dp[1 + kD + d] = -p * q[d] * th[b + 1 + d] * cs[d] * del[d];
      }
    }
    return p;
  }
  float d2 = 0.0f, t[kD], del[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    del[d] = x[d] - y[d];
    t[d] = th[b + 1 + d] * del[d];
    d2 = fmaf(t[d], t[d], d2);
  }
  float f, slope;
  if (kind == kRq) {
    const float alpha = th[b + 1 + kD];
    const float z = d2 * (0.5f / alpha);
    const float u = 1.0f + z, lu = log1pf(z);
    f = expf(-alpha * lu);
    slope = -0.5f * f / u;
    if (kGrad) dp[1 + kD] = var * f * (z / u - lu);
  } else {
    gfs::unit_map_slope(kind, d2, f, slope);
  }
  if (kGrad) {
    dp[0] = f;
    const float vs = 2.0f * var * slope;
#pragma unroll
    for (int d = 0; d < kD; ++d) dp[1 + d] = vs * t[d] * del[d];
  }
  return var * f;
}

// sum_i th[base + i] in[i]: one output of a Linear layer
template <int kN, class Th>
__device__ __forceinline__ float linear_row(const Th& th, int base, const float (&in)[kN]) {
  float h = 0.0f;
#pragma unroll
  for (int i = 0; i < kN; ++i) h = fmaf(th[base + i], in[i], h);
  return h;
}

// The network's value from the primitives' values a0.
template <int kD, class Th>
__device__ __forceinline__ float network(const Th& th, const float (&a0)[kPrims]) {
  using L = Layout<kD>;
  float a1[kA1], a2[kA2];
#pragma unroll
  for (int g = 0; g < kA1; ++g) {
    a1[g] = linear_row(th, L::kW1 + 2 * kPrims * g, a0) * linear_row(th, L::kW1 + kPrims * (2 * g + 1), a0);
  }
#pragma unroll
  for (int g = 0; g < kA2; ++g) {
    a2[g] = linear_row(th, L::kW2 + 2 * kA1 * g, a1) * linear_row(th, L::kW2 + kA1 * (2 * g + 1), a1);
  }
  return linear_row(th, L::kW3, a2);
}

// The entry's value K(x, y).
template <int kD, class Th>
__device__ __forceinline__ float value(const Th& th, const Kinds& kinds, const float (&x)[kD], const float (&y)[kD]) {
  float a0[kPrims], dp[Layout<kD>::kS];
#pragma unroll
  for (int k = 0; k < kPrims; ++k) a0[k] = primitive<kD, false>(th, k, kinds.k[k], x, y, dp);
  return network<kD>(th, a0);
}

// acc[slot] += gbar * dK(x, y) / dth[slot] for every slot of th: the
// primitives' values and slot derivatives, the network's forward, then its
// backward from the cotangent gbar.
template <int kD, class Th>
__device__ __forceinline__ void add_gradient(const Th& th, const Kinds& kinds, const float (&x)[kD],
                                             const float (&y)[kD], float gbar, float (&acc)[Layout<kD>::kAcc]) {
  using L = Layout<kD>;
  float a0[kPrims], dp[kPrims][L::kS];
#pragma unroll
  for (int k = 0; k < kPrims; ++k) a0[k] = primitive<kD, true>(th, k, kinds.k[k], x, y, dp[k]);
  float h1[kH1], a1[kA1], h2[kH2], a2[kA2];
#pragma unroll
  for (int o = 0; o < kH1; ++o) h1[o] = linear_row(th, L::kW1 + kPrims * o, a0);
#pragma unroll
  for (int g = 0; g < kA1; ++g) a1[g] = h1[2 * g] * h1[2 * g + 1];
#pragma unroll
  for (int o = 0; o < kH2; ++o) h2[o] = linear_row(th, L::kW2 + kA1 * o, a1);
#pragma unroll
  for (int g = 0; g < kA2; ++g) a2[g] = h2[2 * g] * h2[2 * g + 1];
  // Linear(kA2 -> 1), then Product: each factor's cotangent is the other's value
  float hb2[kH2];
#pragma unroll
  for (int g = 0; g < kA2; ++g) {
    acc[L::kW3 + g] = fmaf(gbar, a2[g], acc[L::kW3 + g]);
    const float ab = gbar * th[L::kW3 + g];
    hb2[2 * g] = ab * h2[2 * g + 1];
    hb2[2 * g + 1] = ab * h2[2 * g];
  }
  // Linear(kA1 -> kH2), then Product
  float ab1[kA1] = {};
#pragma unroll
  for (int o = 0; o < kH2; ++o) {
#pragma unroll
    for (int i = 0; i < kA1; ++i) {
      acc[L::kW2 + kA1 * o + i] = fmaf(hb2[o], a1[i], acc[L::kW2 + kA1 * o + i]);
      ab1[i] = fmaf(th[L::kW2 + kA1 * o + i], hb2[o], ab1[i]);
    }
  }
  float hb1[kH1];
#pragma unroll
  for (int g = 0; g < kA1; ++g) {
    hb1[2 * g] = ab1[g] * h1[2 * g + 1];
    hb1[2 * g + 1] = ab1[g] * h1[2 * g];
  }
  // Linear(kPrims -> kH1), then the primitives' slots
  float ab0[kPrims] = {};
#pragma unroll
  for (int o = 0; o < kH1; ++o) {
#pragma unroll
    for (int i = 0; i < kPrims; ++i) {
      acc[L::kW1 + kPrims * o + i] = fmaf(hb1[o], a0[i], acc[L::kW1 + kPrims * o + i]);
      ab0[i] = fmaf(th[L::kW1 + kPrims * o + i], hb1[o], ab0[i]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPrims; ++k) {
#pragma unroll
    for (int s = 0; s < L::kS; ++s) acc[k * L::kS + s] = fmaf(ab0[k], dp[k][s], acc[k * L::kS + s]);
  }
}

constexpr int kMaxTheta = 128;
static_assert(Layout<2>::kTheta <= kMaxTheta, "the parameters outgrow their constant memory");
__constant__ float c_theta[kMaxTheta];

struct ConstTheta {
  __device__ __forceinline__ float operator[](int i) const { return c_theta[i]; }
};

// -- forward ------------------------------------------------------------------

constexpr int kFwdRows = 8;
constexpr int kFwdThreads = 256;
constexpr int kFwdSweep = 4 * kFwdThreads;

__device__ __forceinline__ int fwd_band_cols(int b, int pad_to) {
  return (min(pad_to, (b + 1) * kFwdRows) + 3) & ~3;
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads)
    nkn_operand_kernel(const float* __restrict__ X, int N, Kinds kinds, const float* __restrict__ noise_p,
                       int pad_to, float* __restrict__ out) {
  const int nb = (pad_to + kFwdRows - 1) / kFwdRows;
  const int pair = blockIdx.y;
  const int first = (fwd_band_cols(pair, pad_to) + kFwdSweep - 1) / kFwdSweep;
  int band = pair, sweep = blockIdx.x;
  if (sweep >= first) {
    band = nb - 1 - pair;
    sweep -= first;
    if (band == pair || sweep * kFwdSweep >= fwd_band_cols(band, pad_to)) return;
  }
  const int r0 = band * kFwdRows, r1 = min(pad_to, r0 + kFwdRows);
  const int c = sweep * kFwdSweep + 4 * threadIdx.x;
  if (c >= fwd_band_cols(band, pad_to)) return;
  const float noise = *noise_p;
  const ConstTheta th;
  float xc[4][kD];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int d = 0; d < kD; ++d) xc[j][d] = c + j < N ? X[static_cast<size_t>(c + j) * kD + d] : 0.0f;
  }
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    float v[4];
    if (r < N) {
      float xr[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) xr[d] = X[static_cast<size_t>(r) * kD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // past N: the pad's zeros (above the diagonal, in the diagonal block)
        v[j] = c + j < N ? value<kD>(th, kinds, xr, xc[j]) + (r == c + j ? noise : 0.0f) : 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = r == c + j ? 1.0f : 0.0f;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * pad_to + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// -- backward -----------------------------------------------------------------

constexpr int kBwdRows = 32;
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;

__device__ __forceinline__ int bwd_band_cols(int b, int N) { return min(N, (b + 1) * kBwdRows); }

// The grid of the backward: y the pairs, x at least the most sweeps of a
// pair (its two bands hold at most (nb + 1) * 32 < N + 64 columns, and each
// band's last sweep may be partial).
inline void bwd_grid(int N, int& gx, int& gy) {
  const int nb = (N + kBwdRows - 1) / kBwdRows;
  gy = (nb + 1) / 2;
  gx = (N + 64 + 2 * kBwdThreads) / kBwdThreads + 1;
}

// v[0 .. kN/32) of lane l becomes the warp's sum of v[(kN/32) l ..
// (kN/32) (l + 1)): five rounds, each halving what a lane holds, a lane
// keeping the half its bit selects and sending its partner the other.
template <int kN>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kN]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int o = 16 >> step, n = kN >> (step + 1);
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kBwdThreads)
    nkn_vjp_kernel(const float* __restrict__ X, int N, Kinds kinds, const float* __restrict__ g, long long ldg,
                   double* __restrict__ partial) {
  using L = Layout<kD>;
  __shared__ double red[kBwdWarps][L::kAcc];
  const int nb = (N + kBwdRows - 1) / kBwdRows;
  const int pair = blockIdx.y;
  const int first = (bwd_band_cols(pair, N) + kBwdThreads - 1) / kBwdThreads;
  int band = pair, sweep = blockIdx.x;
  bool work = true;
  if (sweep >= first) {
    band = nb - 1 - pair;
    sweep -= first;
    work = band != pair && sweep * kBwdThreads < bwd_band_cols(band, N);
  }
  float acc[L::kAcc];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0.0f;
  const int c = sweep * kBwdThreads + threadIdx.x;
  const int r0 = band * kBwdRows;
  if (work && c < bwd_band_cols(band, N)) {
    const ConstTheta th;
    float xc[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) xc[d] = X[static_cast<size_t>(c) * kD + d];
    const int r1 = min(N, r0 + kBwdRows);
#pragma unroll 1
    for (int r = max(r0, c); r < r1; ++r) {
      float xr[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) xr[d] = X[static_cast<size_t>(r) * kD + d];
      const float gr = g[static_cast<size_t>(r) * ldg + c];
      if (r == c) acc[L::kNoise] += gr;
      add_gradient<kD>(th, kinds, xr, xc, r == c ? gr : 2.0f * gr, acc);
    }
  }
  warp_reduce_scatter(acc);
  constexpr int kPer = L::kAcc / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPer; ++i) red[warp][kPer * lane + i] = static_cast<double>(acc[i]);
  __syncthreads();
  const long long blocks = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long block = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int a = threadIdx.x; a < L::kAcc; a += kBwdThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[w][a];
    partial[a * blocks + block] = s;
  }
}

constexpr int kReduceThreads = 256;

// out[a] = sum over blocks of partial[a, :], one block an accumulator.
__global__ void __launch_bounds__(kReduceThreads)
    nkn_vjp_reduce_kernel(const double* __restrict__ partial, long long blocks, double* __restrict__ out) {
  __shared__ double red[kReduceThreads];
  const double* row = partial + blockIdx.x * blocks;
  double s = 0.0;
  for (long long i = threadIdx.x; i < blocks; i += kReduceThreads) s += row[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

bool load_kinds(const int* kinds, Kinds& k) {
  for (int i = 0; i < kPrims; ++i) {
    if (kinds[i] < gfs::kRbf || kinds[i] > kPeriodic) return false;
    k.k[i] = kinds[i];
  }
  return true;
}

int theta_size(int D) { return D == 1 ? Layout<1>::kTheta : Layout<2>::kTheta; }

cudaError_t load_theta(const float* theta, int D, cudaStream_t s) {
  return cudaMemcpyToSymbolAsync(c_theta, theta, sizeof(float) * theta_size(D), 0, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

// out (pad_to, pad_to): its lower triangle is K_NKN(X, X) + noise * I over
// the first N rows and columns and the identity's beyond. X (N, D) with D 1
// or 2; theta (device) the network's parameters in `Layout`'s order,
// n_theta of them; kinds (host) the 8 primitives' kinds; noise a device
// scalar. pad_to is a multiple of 4 and out 16-byte aligned.
extern "C" int gfs_nkn_operand(const float* X, int N, int D, const float* theta, int n_theta, const int* kinds,
                               const float* noise, int pad_to, float* out, void* stream) {
  Kinds k;
  if (N < 0 || (D != 1 && D != 2) || n_theta != theta_size(D) || pad_to < N || pad_to % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0 || !load_kinds(kinds, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = load_theta(theta, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (pad_to + kFwdRows - 1) / kFwdRows;
  if (nb > 0) {
    const dim3 grid(static_cast<unsigned>((pad_to + kFwdRows + 3) / kFwdSweep + 2), static_cast<unsigned>((nb + 1) / 2));
    if (D == 1) {
      nkn_operand_kernel<1><<<grid, kFwdThreads, 0, s>>>(X, N, k, noise, pad_to, out);
    } else {
      nkn_operand_kernel<2><<<grid, kFwdThreads, 0, s>>>(X, N, k, noise, pad_to, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of float64 partial sums nkn_vjp needs: accumulators x blocks.
extern "C" int gfs_nkn_vjp_scratch(int N, int D) {
  if (N < 1 || (D != 1 && D != 2)) return 0;
  int gx, gy;
  bwd_grid(N, gx, gy);
  return (D == 1 ? Layout<1>::kAcc : Layout<2>::kAcc) * gx * gy;
}

// out (Layout::kAcc float64): out[i] = sum over the leading N x N block of
// g (row stride ldg, its lower triangle read, taken as symmetric) of
// g_rc dK_rc / dtheta_i for i < n_theta, and the trace of the block at
// n_theta (the noise's gradient); 0 beyond. partial: gfs_nkn_vjp_scratch(N,
// D) float64s of scratch.
extern "C" int gfs_nkn_vjp(const float* X, int N, int D, const float* theta, int n_theta, const int* kinds,
                           const float* g, long long ldg, double* partial, long long n_partial, double* out,
                           void* stream) {
  Kinds k;
  if (N < 1 || (D != 1 && D != 2) || n_theta != theta_size(D) || ldg < N || !load_kinds(kinds, k) ||
      n_partial != gfs_nkn_vjp_scratch(N, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = load_theta(theta, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gx, gy;
  bwd_grid(N, gx, gy);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const long long blocks = static_cast<long long>(gx) * gy;
  if (D == 1) {
    nkn_vjp_kernel<1><<<grid, kBwdThreads, 0, s>>>(X, N, k, g, ldg, partial);
    nkn_vjp_reduce_kernel<<<Layout<1>::kAcc, kReduceThreads, 0, s>>>(partial, blocks, out);
  } else {
    nkn_vjp_kernel<2><<<grid, kBwdThreads, 0, s>>>(X, N, k, g, ldg, partial);
    nkn_vjp_reduce_kernel<<<Layout<2>::kAcc, kReduceThreads, 0, s>>>(partial, blocks, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kinds and widths these kernels are built for, as ops/nkn.py's
// layout(): kPrims, kRq, kLinear, kPeriodic, then each Linear layer's
// (in, out). Writes at most n of them into out; returns how many there are.
extern "C" int gfs_nkn_layout(int* out, int n) {
  const int v[] = {kPrims, kRq, kLinear, kPeriodic, kPrims, kH1, kA1, kH2, kA2, 1};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}
