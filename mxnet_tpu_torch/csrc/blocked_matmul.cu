// Blocked matrix product C = A B for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel benchmark/conv_kernel_probe.py
// `_pallas_matmul` (lines 39-74, call at 59): (M, K) x (K, N) with an f32
// accumulator, the output in A's dtype, on a grid (M/bm, N/bn, K/bk) whose K
// axis runs innermost and in order on one core, carrying the sum in VMEM.
// Its path is the im2col form of ResNet-50's batch-32 convolutions.
//
// Semantics kept: A and B of one dtype (f32, bf16 or f16), products and sums
// in f32, one rounding to A's dtype at the end. Unlike the Pallas grid, whose
// floor division leaves the rows and columns past the last whole block
// unwritten, every edge here is masked: any M, N, K >= 1 is computed in full.
//
// Design. Blocks run in parallel in no order, so the K loop lives inside the
// block: each 256-thread block owns one 128x128 tile of C and walks K in steps
// of 32, staging a 128x32 slice of A (transposed, so a thread reads 4
// consecutive rows as one float4) and a 32x128 slice of B in shared memory as
// f32. Thread (ty, tx) of a 16x16 grid keeps an 8x8 block of C in registers:
// rows 4ty..4ty+3 and 64+4ty..64+4ty+3, columns likewise from tx. Per k step
// it reads 2+2 float4s and does 64 FMAs. Loads from device memory are scalar
// and coalesced along each matrix's rows, so any shape and alignment works.
// The products run on the FMA units, not the tensor cores: a first kernel
// that is right and simple.
//
// Bound at the probe's shapes in bf16, e.g. (6656, 2560) x (2560, 256):
// 2*M*N*K = 8.72 GFLOP, 8.8 us at 989 TFLOP/s on the tensor cores and 130 us
// at the 67 TFLOP/s of the FMA units; the bytes (A and B read once, C written
// once: 38.7 MB) take 11.6 us at 3.35 TB/s. So with tensor cores the kernel
// would be bound by bytes; on the FMA units, as written, by operations, and
// with 128x128 tiles the three shapes give only 64 to 104 blocks for 132
// SMs. Tensor cores (mma.sync, then wgmma fed by TMA) are for a later PR.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 128;               // C tile: kTile x kTile
constexpr int kStepK = 32;               // K slice staged per step
constexpr int kThreads = 256;            // 16 x 16 threads, 8 x 8 of C each
constexpr int kStrideA = kTile + 4;      // As row stride: float4-aligned, fewer conflicts

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
blocked_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float sA[kStepK][kStrideA];   // sA[kk][row]
  __shared__ __align__(16) float sB[kStepK][kTile];      // sB[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kStepK) {
    // A slice: 128 rows x 32 k, consecutive threads along k (coalesced)
#pragma unroll
    for (int i = 0; i < kTile * kStepK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kStepK, kk = idx % kStepK;
      const int gr = row0 + r, gk = k0 + kk;
      sA[kk][r] = (gr < m && gk < k) ? to_f32<T>(a[(size_t)gr * k + gk]) : 0.f;
    }
    // B slice: 32 k x 128 columns, consecutive threads along the columns
#pragma unroll
    for (int i = 0; i < kTile * kStepK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kTile, cc = idx % kTile;
      const int gk = k0 + kk, gc = col0 + cc;
      sB[kk][cc] = (gk < k && gc < n) ? to_f32<T>(b[(size_t)gk * n + gc]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kStepK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[kk][64 + 4 * tx]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the slices are read by every thread before the next load
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (gc < n) c[(size_t)gr * n + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  blocked_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// a (m, k), b (k, n), c (m, n): contiguous, row-major, one dtype.
// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t.
extern "C" int mxt_blocked_matmul(const void* a, const void* b, void* c, int m,
                                  int n, int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, b, c, m, n, k, s);
    case 1: return launch<__nv_bfloat16>(a, b, c, m, n, k, s);
    case 2: return launch<__half>(a, b, c, m, n, k, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
