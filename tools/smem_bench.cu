// What shared memory costs the f32 tile products without tensor cores on
// one NVIDIA Hopper GPU (csrc/common.cuh's mm_run, csrc/chol_solve.cu's
// chol_trailing_kernel_hi):
//
//  1. one warp's 16-byte load (ld.shared.v4.f32) by how many distinct
//     16-byte slots its 32 lanes read: 32 (l), 16 (l & 15: the products' B
//     reads), 8 (l & 7), 4 (l >> 3), 2 (l >> 4: their A reads), 1. One block
//     of 16 warps an SM, 4096 loads a warp at three instructions a load
//     (0.75 clocks of the SM's four schedulers): where the SM's
//     shared-memory pipe is the limit, the clocks a block takes (clock64)
//     over its loads are the 128-byte wavefronts a load costs;
//  2. the 8 x 8 register tile of 256 threads with its operands resident in
//     shared memory (no global loads), 16 inner indices a stage and a
//     barrier a stage, read [inner][row] (mm_run: per inner index two
//     16-byte loads of A and two of B) or [row][inner] (four inner indices
//     of one row a 16-byte load, chunks swizzled as chol_solve.cu's tr_at),
//     at 128 registers and unbounded, one and two blocks an SM: TFLOP/s.
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a tools/smem_bench.cu -o build/smem_bench
//   build/smem_bench
//
// Prints the card's SM count and each measurement, the best of 5 launches.
#include <cuda_runtime.h>

#include <cstdio>

constexpr int kLoads = 4096, kLdsWarps = 16, kStages = 512;

__global__ void __launch_bounds__(32 * kLdsWarps, 1) lds_kernel(int pattern, long long* clocks, float* sink) {
  __shared__ __align__(16) float s[8][128];
  for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) s[i / 128][i % 128] = 1e-3f * (i & 15);
  __syncthreads();
  const int l = threadIdx.x & 31;
  const int slot = pattern == 0 ? l : pattern == 1 ? (l & 15) : pattern == 2 ? (l & 7) : pattern == 3 ? (l >> 3)
                                                                                         : pattern == 4 ? (l >> 4) : 0;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(&s[0][4 * slot]));
  float acc[8] = {};
  const long long t0 = clock64();
  for (int it = 0; it < kLoads; it += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float x, y, z, w;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                   : "r"(base + 512u * u));
      acc[u] = fmaf(fmaf(x, y, z), w, acc[u]);  // every component used: the load stays 16 bytes
    }
    __syncwarp();  // a memory barrier: the loads cannot be hoisted out of the loop
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
  float t = 0.0f;
  for (int u = 0; u < 8; ++u) t += acc[u];
  if (t == -1.0f) sink[threadIdx.x] = t;
}

// [inner][row], mm_run's thread map: rows 64 (i / 4) + 4 ty + i % 4, columns
// likewise with tx
template <int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks) core_inner_row(float* sink) {
  __shared__ __align__(16) float sa[16 * 132], sb[16 * 132];
  for (int i = threadIdx.x; i < 16 * 132; i += 256) sa[i] = 1e-3f * (i & 7), sb[i] = 1e-3f * (i & 3);
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8] = {};
  for (int it = 0; it < kStages; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float av[8], bv[8];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&sa[t * 132 + 64 * q + 4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&sb[t * 132 + 64 * q + 4 * tx]);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
        bv[4 * q] = b.x, bv[4 * q + 1] = b.y, bv[4 * q + 2] = b.z, bv[4 * q + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(-av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // as a ring's stage: the loads are redone every stage
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  if (s == -1.0f) sink[threadIdx.x] = s;
}

// [row][inner], 64-byte rows, chunks swizzled: rows ty + 16 i, columns tx +
// 16 j, a warp 4 ty x 8 tx
template <int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks) core_row_inner(float* sink) {
  __shared__ __align__(16) float sa[128 * 16], sb[128 * 16];
  for (int i = threadIdx.x; i < 128 * 16; i += 256) sa[i] = 1e-3f * (i & 7), sb[i] = 1e-3f * (i & 3);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = 8 * (warp & 1) + (lane & 7), ty = 4 * (warp >> 1) + (lane >> 3);
  const float* arow = sa + ty * 16;
  const float* brow = sb + tx * 16;
  const int aswz = (ty >> 1) & 3, bswz = (tx >> 1) & 3;
  float acc[8][8] = {};
  for (int it = 0; it < kStages; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(arow + 256 * i + 4 * (c ^ aswz));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(brow + 256 * j + 4 * (c ^ bswz));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = fmaf(-a[i].x, b.x, acc[i][j]);
          v = fmaf(-a[i].y, b.y, v);
          v = fmaf(-a[i].z, b.z, v);
          acc[i][j] = fmaf(-a[i].w, b.w, v);
        }
      }
    }
    __syncthreads();
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  if (s == -1.0f) sink[threadIdx.x] = s;
}

// best of 5 launches of `blocks` blocks, in ms; per_sm 1 asks for more
// dynamic shared memory than two blocks can have
template <typename Kernel>
float best_ms(Kernel kernel, int blocks, int per_sm, float* sink) {
  const int smem = per_sm == 1 ? 120 * 1024 : 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kernel<<<blocks, 256, smem>>>(sink);
  float best = 1e30f;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    kernel<<<blocks, 256, smem>>>(sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  return best;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  long long* clocks;
  float* sink;
  cudaMalloc(&clocks, sms * sizeof(long long));
  cudaMalloc(&sink, 32 * kLdsWarps * sizeof(float));
  printf("%d SMs\n", sms);
  const char* names[] = {"32 distinct", "16 distinct", "8 distinct", "4 distinct", "2 distinct", "1 slot"};
  for (int p = 0; p < 6; ++p) {
    double best = 1e30;
    for (int rep = 0; rep < 5; ++rep) {
      lds_kernel<<<sms, 32 * kLdsWarps>>>(p, clocks, sink);
      long long host[1024];
      cudaMemcpy(host, clocks, sms * sizeof(long long), cudaMemcpyDeviceToHost);
      double mean = 0;
      for (int b = 0; b < sms; ++b) mean += static_cast<double>(host[b]) / sms;
      best = mean < best ? mean : best;
    }
    printf("16-byte load, %-11s slots a warp: %.3f clocks (%s)\n", names[p], best / (kLdsWarps * kLoads),
           cudaGetErrorString(cudaGetLastError()));
  }
  const double flop = 2.0 * 128 * 128 * 16 * kStages;  // a block
  for (int per_sm : {1, 2}) {
    const int blocks = 4 * per_sm * sms;
    const struct {
      const char* name;
      float ms;
    } rows[] = {{"[inner][row] (mm_run), 128 registers", best_ms(core_inner_row<2>, blocks, per_sm, sink)},
                {"[inner][row] (mm_run), unbounded", best_ms(core_inner_row<1>, blocks, per_sm, sink)},
                {"[row][inner] swizzled, 128 registers", best_ms(core_row_inner<2>, blocks, per_sm, sink)},
                {"[row][inner] swizzled, unbounded", best_ms(core_row_inner<1>, blocks, per_sm, sink)}};
    for (const auto& r : rows) {
      printf("8 x 8 tile, operands in shared memory, %s, %d block(s) an SM: %.1f TFLOP/s (%s)\n", r.name, per_sm,
             flop * blocks / r.ms / 1e9, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
