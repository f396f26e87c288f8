// Rate of variants of the shared f32 tile product (csrc/common.cuh
// `mm_run`) alone on one NVIDIA Hopper GPU, full tiles, no masking:
// C -= A B^T, A and B (8192, K), C (8192, 8192), row-major, both operands
// contiguous along the inner dimension (the Cholesky trailing update's
// shape), K = 256 as the Cholesky's panel and 1024 to show the inner loop's
// own rate. The variants: outputs per thread (RM x RN, 256 threads, the
// tile 16 RM x 16 RN), inner depth per stage, stages in the ring, blocks
// per SM, and whether a thread loads the next inner step's operands before
// the current step's FMAs (double-buffered fragments). Shared layout
// [t][o] with 4-byte cp.async, as common.cuh.
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a tools/mm_bench.cu -o build/mm_bench
//   build/mm_bench
//
// Prints the best of 5 CUDA-event timings of each variant and its TFLOP/s.
#include <cuda_runtime.h>

#include <cstdio>

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void waitg() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int RM, int RN>
struct Frag {
  float a[RM], b[RN];
};

// thread (tx = tid % 16, ty = tid / 16) owns rows run * (i / 4) + 4 ty + i % 4
// and columns likewise: runs of four, tile / (R / 4) apart
template <int RM, int RN, int LDM, int LDN>
__device__ __forceinline__ void load_frag(Frag<RM, RN>& f, const float* a, const float* b, int t, int tx,
                                          int ty) {
  constexpr int TM = 16 * RM, TN = 16 * RN;
#pragma unroll
  for (int q = 0; q < RM / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(&a[t * LDM + (TM / (RM / 4)) * q + 4 * ty]);
    f.a[4 * q] = v.x, f.a[4 * q + 1] = v.y, f.a[4 * q + 2] = v.z, f.a[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < RN / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(&b[t * LDN + (TN / (RN / 4)) * q + 4 * tx]);
    f.b[4 * q] = v.x, f.b[4 * q + 1] = v.y, f.b[4 * q + 2] = v.z, f.b[4 * q + 3] = v.w;
  }
}

template <int RM, int RN, int BK, int ST, int MINB, bool DB>
__global__ void __launch_bounds__(256, MINB) mm(float* C, const float* A, const float* B, int K, int ld) {
  constexpr int TM = 16 * RM, TN = 16 * RN, LDM = TM + 4, LDN = TN + 4;
  constexpr int SA = BK * LDM, SB = BK * LDN;
  extern __shared__ __align__(16) float sm[];
  float* sa = sm;
  float* sb = sm + ST * SA;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const float* Ab = A + static_cast<size_t>(row0) * ld;
  const float* Bb = B + static_cast<size_t>(col0) * ld;
  auto load = [&](int st, int t0) {
    for (int e = tid; e < TM * BK; e += 256) {
      const int tl = e & 7, o = (e >> 3) % TM, th = (e >> 3) / TM;
      cp4(&sa[st * SA + (th * 8 + tl) * LDM + o], Ab + static_cast<size_t>(o) * ld + t0 + th * 8 + tl);
    }
    for (int e = tid; e < TN * BK; e += 256) {
      const int tl = e & 7, o = (e >> 3) % TN, th = (e >> 3) / TN;
      cp4(&sb[st * SB + (th * 8 + tl) * LDN + o], Bb + static_cast<size_t>(o) * ld + t0 + th * 8 + tl);
    }
  };
  auto ri = [&](int i) { return (TM / (RM / 4)) * (i >> 2) + 4 * ty + (i & 3); };
  auto ci = [&](int j) { return (TN / (RN / 4)) * (j >> 2) + 4 * tx + (j & 3); };
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = C[static_cast<size_t>(row0 + ri(i)) * ld + col0 + ci(j)];
  const int stages = K / BK;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < stages) load(s, s * BK);
    commit();
  }
  for (int s = 0; s < stages; ++s) {
    if (s + ST - 1 < stages) load((s + ST - 1) % ST, (s + ST - 1) * BK);
    commit();
    waitg<ST - 1>();
    __syncthreads();
    const float* a = sa + (s % ST) * SA;
    const float* b = sb + (s % ST) * SB;
    Frag<RM, RN> f[2];
    load_frag<RM, RN, LDM, LDN>(f[0], a, b, 0, tx, ty);
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      Frag<RM, RN>& cur = f[DB ? t & 1 : 0];
      if (!DB && t > 0) load_frag<RM, RN, LDM, LDN>(cur, a, b, t, tx, ty);
      if (DB && t + 1 < BK) load_frag<RM, RN, LDM, LDN>(f[(t + 1) & 1], a, b, t + 1, tx, ty);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(-cur.a[i], cur.b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) C[static_cast<size_t>(row0 + ri(i)) * ld + col0 + ci(j)] = acc[i][j];
}

template <int RM, int RN, int BK, int ST, int MINB, bool DB>
void run(const char* name, float* C, const float* A, int M, int K) {
  constexpr int TM = 16 * RM, TN = 16 * RN;
  const int bytes = ST * BK * ((TM + 4) + (TN + 4)) * 4;
  auto k = mm<RM, RN, BK, ST, MINB, DB>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(M / TN, M / TM);
  const int ld = M;
  k<<<grid, 256, bytes>>>(C, A, A, K, ld);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    k<<<grid, 256, bytes>>>(C, A, A, K, ld);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  printf("%-40s K=%4d %8.3f ms %6.1f TFLOP/s %s\n", name, K, best, 2.0 * M * M * K / best / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  const int M = 8192;
  float *A, *C;
  cudaMalloc(&A, static_cast<size_t>(M) * M * 4);
  cudaMalloc(&C, static_cast<size_t>(M) * M * 4);
  cudaMemset(A, 0, static_cast<size_t>(M) * M * 4);
  cudaMemset(C, 0, static_cast<size_t>(M) * M * 4);
  for (int K : {256, 1024}) {
    run<8, 8, 16, 2, 2, false>("8x8 BK16 2st minb2 (common.cuh)", C, A, M, K);
    run<8, 8, 16, 2, 2, true>("8x8 BK16 2st minb2 double-buffered", C, A, M, K);
    run<8, 8, 32, 2, 2, false>("8x8 BK32 2st minb2", C, A, M, K);
    run<8, 8, 32, 2, 2, true>("8x8 BK32 2st minb2 double-buffered", C, A, M, K);
    run<8, 8, 16, 3, 2, true>("8x8 BK16 3st minb2 double-buffered", C, A, M, K);
    run<8, 8, 16, 2, 1, true>("8x8 BK16 2st minb1 double-buffered", C, A, M, K);
    run<8, 16, 16, 2, 1, false>("8x16 BK16 2st minb1", C, A, M, K);
    run<8, 16, 16, 2, 1, true>("8x16 BK16 2st minb1 double-buffered", C, A, M, K);
    run<16, 8, 16, 2, 1, true>("16x8 BK16 2st minb1 double-buffered", C, A, M, K);
    run<4, 8, 16, 2, 2, true>("4x8 BK16 2st minb2 double-buffered", C, A, M, K);
  }
  return 0;
}
