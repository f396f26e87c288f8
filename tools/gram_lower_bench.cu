// Device time of designs of the lower-tile Gram (csrc/gram.cu
// `gram_lower_kernel`) alone on one NVIDIA Hopper GPU, RBF, at the shapes its
// paths run: N = 2048, D = 2 (the VGP's), N = 10000, D = 1 (serving) and
// N = 1000, D = 1 (GPMC); then the block orders and zero-store hints alone
// at N = 3072, 4096 and 6144 (D = 1), outputs about the L2's 50 MB. The
// designs:
//
//   tiles        one 32 x 8-thread block per 32 x 32 tile, 4-byte stores, the
//                coordinates re-read for every entry (the design before the
//                row bands; its body kept here to be measured);
//   bands        the shipped kernel, through gfs_gram_lower: grid (sweep,
//                band), the sweep varying fastest;
//   bands_bf     its body on the grid (band, sweep), the band varying
//                fastest (the cross Gram's order);
//   bands_stcs   its body with the zero tiles stored evict-first (__stcs), so
//                the lower tiles keep the L2 for the factor that reads them
//                next; bands_bf_stcs: the same on the band-fastest grid;
//   bands_pers   its body on a persistent grid of 4 blocks an SM, each
//                looping over (band, sweep) items, the sweep fastest, so that
//                one item's stores overlap the next one's loads and map;
//   zeros_bands  the bands' grid storing zeros everywhere: the same stores
//                with no input read and no map formed;
//   memset       cudaMemsetAsync of the N x N output: the write floor.
//
// Each design: the median of 11 launches, each queued behind a spin kernel
// so the host's launch work is hidden (the device's time alone), and the
// median of 5 runs of 20 back-to-back launches over 20. Then, for the
// bands, each block's start and end on the device's global timer (one
// extra timed launch): the spread of block starts (the launch's ramp), the
// median block time, and the span from the first start to the last end.
// Each design's output is compared with the shipped kernel's (max abs
// difference, strictly-upper tiles exactly 0).
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a tools/gram_lower_bench.cu -o build/gram_lower_bench
//   build/gram_lower_bench
#include "../gpflow_slim_tpu_torch/csrc/gram.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define CK(x)                                                                            \
  do {                                                                                   \
    cudaError_t e_ = (x);                                                                \
    if (e_ != cudaSuccess) {                                                             \
      std::fprintf(stderr, "%s:%d %s: %s\n", __FILE__, __LINE__, #x, cudaGetErrorString(e_)); \
      std::exit(1);                                                                      \
    }                                                                                    \
  } while (0)

namespace {

constexpr int kPersistentBlocksPerSm = 4;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// the design before the row bands: block (bi, bj) writes tile (bi, bj)
__global__ void tiles_kernel(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p, int kind,
                             float* __restrict__ out) {
  constexpr int kRowsPerThread = 4, kRowStep = kTile / kRowsPerThread;
  const int bi = blockIdx.x, bj = blockIdx.y;
  const int col = bj * kTile + threadIdx.x;
  if (col >= N) return;
  const bool zero = bi < bj;
  const float var = zero ? 0.0f : var_p[0];
  const float* y = X + static_cast<size_t>(col) * D;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = bi * kTile + threadIdx.y + q * kRowStep;
    if (row >= N) break;
    float d2 = 0.0f;
    if (!zero) {
      const float* x = X + static_cast<size_t>(row) * D;
      for (int d = 0; d < D; ++d) {
        const float diff = x[d] - y[d];
        d2 = fmaf(diff, diff, d2);
      }
    }
    out[static_cast<size_t>(row) * N + col] = zero ? 0.0f : gfs::apply_map(kind, var, d2);
  }
}

// the shipped body with the block order and the zero stores' hint chosen
// (kVec: N % 4 == 0 here)
template <int kR, bool kBandFastest, bool kStcs>
__global__ void __launch_bounds__(gfs::kBandThreads)
    order_variant(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p, int kind,
                  float* __restrict__ out) {
  const int band = kBandFastest ? blockIdx.x : blockIdx.y, sweep = kBandFastest ? blockIdx.y : blockIdx.x;
  const int r0 = band * kR, r1 = min(N, r0 + kR);
  const int c0 = sweep * kSweep, c1 = min(N, c0 + kSweep);
  const int edge = min(N, (r0 / kTile + 1) * kTile);
  if (c0 < edge) {
    const float var = *var_p;
    const auto value = [&](int, int, float d2) { return gfs::apply_map(kind, var, d2); };
    const auto pad = [](int, int) { return 0.0f; };
    gfs::gram_band<true, kR>(X, N, X, edge, D, r0, r1, c0, min(c1, edge), out, N, value, pad);
  }
  const int c = c0 + 4 * threadIdx.x;
  if (c < edge || c >= c1) return;
  for (int r = r0; r < r1; ++r) {
    float4* p = reinterpret_cast<float4*>(out + static_cast<size_t>(r) * N + c);
    if (kStcs) {
      __stcs(p, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
      *p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <bool kBandFastest, bool kStcs>
void launch_order(const float* X, int N, int D, const float* var, float* out) {
  const unsigned sweeps = (N + kSweep - 1) / kSweep;
  const unsigned rows = tall_bands(N, sweeps) ? kRows : 1, bands = (N + rows - 1) / rows;
  const dim3 grid = kBandFastest ? dim3(bands, sweeps) : dim3(sweeps, bands);
  if (rows == kRows) {
    order_variant<kRows, kBandFastest, kStcs><<<grid, gfs::kBandThreads>>>(X, N, D, var, gfs::kRbf, out);
  } else {
    order_variant<1, kBandFastest, kStcs><<<grid, gfs::kBandThreads>>>(X, N, D, var, gfs::kRbf, out);
  }
}

// the bands' body over items (band, sweep) = divmod(item, sweeps), the
// grid's blocks striding over them; kZeros: zeros everywhere; stamps: each
// block's start and end (ns)
template <int kR, bool kZeros>
__global__ void __launch_bounds__(gfs::kBandThreads)
    band_variant(const float* __restrict__ X, int N, int D, const float* __restrict__ var_p, int kind,
                 float* __restrict__ out, int sweeps, int items, unsigned long long* stamps) {
  const unsigned long long t0 = stamps ? global_ns() : 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r0 = item / sweeps * kR, r1 = min(N, r0 + kR);
    const int c0 = item % sweeps * kSweep, c1 = min(N, c0 + kSweep);
    const int edge = kZeros ? 0 : min(N, (r0 / kTile + 1) * kTile);
    if (c0 < edge) {
      const float var = *var_p;
      const auto value = [&](int, int, float d2) { return gfs::apply_map(kind, var, d2); };
      const auto pad = [](int, int) { return 0.0f; };
      gfs::gram_band<true, kR>(X, N, X, edge, D, r0, r1, c0, min(c1, edge), out, N, value, pad);
    }
    const int c = c0 + 4 * threadIdx.x;
    if (c >= edge && c < c1) {
      for (int r = r0; r < r1; ++r) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * N + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  if (stamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      stamps[2 * blockIdx.x] = t0;
      stamps[2 * blockIdx.x + 1] = global_ns();
    }
  }
}

struct Shape {
  int N, D;
};

template <int kR, bool kZeros>
void launch_variant(const float* X, int N, int D, const float* var, float* out, int grid_cap,
                    unsigned long long* stamps) {
  const int sweeps = (N + kSweep - 1) / kSweep, items = (N + kR - 1) / kR * sweeps;
  const int grid = grid_cap > 0 ? std::min(items, grid_cap) : items;
  band_variant<kR, kZeros><<<grid, gfs::kBandThreads>>>(X, N, D, var, gfs::kRbf, out, sweeps, items, stamps);
}

template <bool kZeros>
void launch_bands(const float* X, int N, int D, const float* var, float* out, int grid_cap,
                  unsigned long long* stamps = nullptr) {
  const long long sweeps = (N + kSweep - 1) / kSweep;
  if (tall_bands(N, sweeps)) {
    launch_variant<kRows, kZeros>(X, N, D, var, out, grid_cap, stamps);
  } else {
    launch_variant<1, kZeros>(X, N, D, var, out, grid_cap, stamps);
  }
}

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

template <typename F>
void time_design(const char* name, const Shape& s, F launch, long long spin) {
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  launch();
  CK(cudaDeviceSynchronize());
  std::vector<float> queued, runs;
  for (int i = 0; i < 11; ++i) {
    spin_kernel<<<1, 1>>>(spin);
    CK(cudaEventRecord(a));
    launch();
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    float ms;
    CK(cudaEventElapsedTime(&ms, a, b));
    queued.push_back(ms);
  }
  for (int i = 0; i < 5; ++i) {
    CK(cudaEventRecord(a));
    for (int k = 0; k < 20; ++k) launch();
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    float ms;
    CK(cudaEventElapsedTime(&ms, a, b));
    runs.push_back(ms / 20);
  }
  CK(cudaGetLastError());
  const double bound = static_cast<double>(s.N) * s.N * 4 / 3.35e12 * 1e3;
  std::printf("N=%d D=%d %-13s device %.5f ms (%.0f%% of the %.6f ms write bound), runs of 20 %.5f ms\n", s.N,
              s.D, name, median(queued), 100 * bound / median(queued), bound, median(runs));
  CK(cudaEventDestroy(a));
  CK(cudaEventDestroy(b));
}

void compare(const char* name, const Shape& s, const float* got, const float* want) {
  const size_t n = static_cast<size_t>(s.N) * s.N;
  std::vector<float> g(n), w(n);
  CK(cudaMemcpy(g.data(), got, n * 4, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(w.data(), want, n * 4, cudaMemcpyDeviceToHost));
  double worst = 0;
  bool upper_zero = true;
  for (int r = 0; r < s.N; ++r) {
    for (int c = 0; c < s.N; ++c) {
      const size_t i = static_cast<size_t>(r) * s.N + c;
      worst = std::max(worst, static_cast<double>(std::fabs(g[i] - w[i])));
      if (r / kTile < c / kTile && g[i] != 0.0f) upper_zero = false;
    }
  }
  std::printf("N=%d D=%d %-13s max abs difference from the shipped kernel %.3e, strictly-upper tiles 0: %s\n", s.N,
              s.D, name, worst, upper_zero ? "yes" : "NO");
}

void stamps_of(const Shape& s, const float* X, const float* var, float* out, int grid_cap, const char* name) {
  const int sweeps = (s.N + kSweep - 1) / kSweep;
  const int rows = tall_bands(s.N, sweeps) ? kRows : 1;
  const int items = (s.N + rows - 1) / rows * sweeps;
  const int blocks = grid_cap > 0 ? std::min(items, grid_cap) : items;
  unsigned long long* st;
  CK(cudaMalloc(&st, sizeof(unsigned long long) * 2 * blocks));
  launch_bands<false>(X, s.N, s.D, var, out, grid_cap, st);
  CK(cudaDeviceSynchronize());
  std::vector<unsigned long long> h(2 * blocks);
  CK(cudaMemcpy(h.data(), st, h.size() * sizeof(unsigned long long), cudaMemcpyDeviceToHost));
  CK(cudaFree(st));
  unsigned long long first = ~0ull, last_start = 0, last_end = 0;
  std::vector<float> dur;
  for (int i = 0; i < blocks; ++i) {
    first = std::min(first, h[2 * i]);
    last_start = std::max(last_start, h[2 * i]);
    last_end = std::max(last_end, h[2 * i + 1]);
    dur.push_back(static_cast<float>(h[2 * i + 1] - h[2 * i]));
  }
  std::sort(dur.begin(), dur.end());
  std::printf("N=%d D=%d %-13s %d blocks of %d rows: block starts spread over %.2f us, block time median %.2f us "
              "(10%% %.2f, 90%% %.2f), first start to last end %.2f us\n",
              s.N, s.D, name, blocks, rows, (last_start - first) / 1e3, dur[dur.size() / 2] / 1e3,
              dur[dur.size() / 10] / 1e3, dur[dur.size() * 9 / 10] / 1e3, (last_end - first) / 1e3);
}

}  // namespace

int main() {
  int dev = 0;
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, dev));
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int cap = kPersistentBlocksPerSm * prop.multiProcessorCount;
  const long long spin = 20000000;  // ~10 ms at the H100's clock
  // all: every design; else the two orders and the two hints
  struct Case {
    Shape s;
    bool all;
  };
  for (const Case k : {Case{{2048, 2}, true}, Case{{10000, 1}, true}, Case{{1000, 1}, true},
                       Case{{3072, 1}, false}, Case{{4096, 1}, false}, Case{{6144, 1}, false}}) {
    const Shape s = k.s;
    std::vector<float> hx(static_cast<size_t>(s.N) * s.D);
    unsigned seed = 12345;
    for (float& v : hx) {
      seed = seed * 1664525u + 1013904223u;
      v = (seed >> 8) / 16777216.0f / 0.1f;  // uniform on [0, 1) over the lengthscale 0.1
    }
    float *X, *var, *out, *ref;
    const size_t n = static_cast<size_t>(s.N) * s.N;
    CK(cudaMalloc(&X, hx.size() * 4));
    CK(cudaMalloc(&var, 4));
    CK(cudaMalloc(&out, n * 4));
    CK(cudaMalloc(&ref, n * 4));
    CK(cudaMemcpy(X, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
    const float one = 1.0f;
    CK(cudaMemcpy(var, &one, 4, cudaMemcpyHostToDevice));
    CK(static_cast<cudaError_t>(gfs_gram_lower(X, s.N, s.D, var, gfs::kRbf, ref, nullptr)));
    const unsigned tiles = (s.N + kTile - 1) / kTile;
    const auto tiles_launch = [&] {
      tiles_kernel<<<dim3(tiles, tiles), dim3(kTile, kTile / 4)>>>(X, s.N, s.D, var, gfs::kRbf, out);
    };
    const auto shipped = [&] { gfs_gram_lower(X, s.N, s.D, var, gfs::kRbf, out, nullptr); };
    const auto bf = [&] { launch_order<true, false>(X, s.N, s.D, var, out); };
    const auto stcs = [&] { launch_order<false, true>(X, s.N, s.D, var, out); };
    const auto bf_stcs = [&] { launch_order<true, true>(X, s.N, s.D, var, out); };
    const auto pers = [&] { launch_bands<false>(X, s.N, s.D, var, out, cap); };
    const auto zeros = [&] { launch_bands<true>(X, s.N, s.D, var, out, 0); };
    const auto fill = [&] { CK(cudaMemsetAsync(out, 0, n * 4)); };
    if (k.all) {  // tiles, bands, bands, tiles: the two designs in turns
      time_design("tiles", s, tiles_launch, spin);
      compare("tiles", s, out, ref);
      time_design("bands", s, shipped, spin);
      compare("bands", s, out, ref);
      time_design("bands_bf", s, bf, spin);
      compare("bands_bf", s, out, ref);
      time_design("bands_stcs", s, stcs, spin);
      compare("bands_stcs", s, out, ref);
      time_design("bands_bf_stcs", s, bf_stcs, spin);
      compare("bands_bf_stcs", s, out, ref);
      time_design("bands_pers", s, pers, spin);
      compare("bands_pers", s, out, ref);
      time_design("bands", s, shipped, spin);
      time_design("tiles", s, tiles_launch, spin);
      time_design("zeros_bands", s, zeros, spin);
      time_design("memset", s, fill, spin);
      stamps_of(s, X, var, out, 0, "bands");
      stamps_of(s, X, var, out, cap, "bands_pers");
    } else {  // the two orders and the two hints, in turns
      time_design("bands", s, shipped, spin);
      time_design("bands_bf", s, bf, spin);
      time_design("bands_stcs", s, stcs, spin);
      time_design("bands_bf_stcs", s, bf_stcs, spin);
      time_design("bands_bf_stcs", s, bf_stcs, spin);
      time_design("bands_stcs", s, stcs, spin);
      time_design("bands_bf", s, bf, spin);
      time_design("bands", s, shipped, spin);
    }
    CK(cudaFree(X));
    CK(cudaFree(var));
    CK(cudaFree(out));
    CK(cudaFree(ref));
  }
  CK(cudaDeviceSynchronize());
  return 0;
}
