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
// Blocks run in parallel in no order, so the K loop lives inside the block.
//
// Bound at the probe's shapes in bf16, e.g. (6656, 2560) x (2560, 256):
// 2*M*N*K = 8.72 GFLOP, 8.8 us at 989 TFLOP/s on the tensor cores; the bytes
// (A and B read once, C written once: 38.8 MB) take 11.6 us at 3.35 TB/s.
// Of the three probe shapes two are bound by bytes and (2048, 4608) x
// (4608, 512) by operations (9.77 us).
//
// bf16/f16: `blocked_matmul_wgmma_kernel`, on the tensor cores by wgmma fed
// by TMA.
//   - Tiles. A block owns a kBM x kBN = 128 x 64 tile of C: two consumer
//     warpgroups, 64 rows each, run wgmma.mma_async m64n64k16 with the f32
//     accumulator in registers (32 a thread). 128x64 rather than 128x128:
//     the probe's shapes give 208 / 128 / 208 blocks for 132 SMs (128x128
//     gives 104 / 64 / 104, under half the card for the second), and at
//     98 KB of shared memory two blocks fit an SM, so all 208 run at once.
//   - The ring. K advances in 64-element (128-byte) slices through a ring of
//     kStages = 4 stages in dynamic shared memory: A's 128 x 64 and B's
//     64 x 64 slice, 24 KB a stage, each stage 1024-byte aligned as the
//     128-byte swizzle needs. A producer warp (lane 0) issues the TMA loads
//     (cp.async.bulk.tensor) ahead into free stages; each stage has a full
//     mbarrier (the TMA's transaction bytes) and an empty one (one arrival
//     from each of the 256 consumer threads). A consumer releases a stage
//     only after the wgmma group that read it has retired (wait_group 1
//     after committing the next one), so one group stays in flight.
//     Phase parity flips each time the ring wraps.
//   - Layouts. Both tensor maps use the 128-byte swizzle. A is K-major: the
//     wgmma descriptor's rows are 128 bytes, 8-row groups 1024 bytes apart
//     (SBO); a k16 step advances the start address by 32 bytes. B is stored
//     N-major (row-major K x N), so its wgmma takes the transpose-B flag,
//     which the 16-bit types allow: B's 64 columns are one 128-byte swizzle
//     atom, k groups of 8 rows are 1024 bytes apart (SBO, and LBO set alike:
//     with one atom along N there is no other stride), and a k16 step
//     advances by 2048 bytes. No transposing copy.
//   - Edges. TMA fills the box past M, N or K with zeros; the epilogue
//     converts to A's dtype and stores with masks, straight from the
//     accumulator fragments.
//   - Strides. TMA needs 16-byte row strides, so the 16-bit entry reads A's
//     and B's rows ceil8(K) and ceil8(N) elements apart: contiguous when K
//     and N are multiples of 8, else the wrapper's zero-padded copies
//     (`ops/cuda/blocked_matmul.py:tma_operand`). The tensor maps are
//     encoded per call by cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
//     parameters, so a launch can be captured in a CUDA graph.
//
// f32: `blocked_matmul_kernel`, a kernel on the FMA units, kept as
// the f32 route: wgmma takes TF32 only K-major, and B is N-major. Each
// 256-thread block owns one 128x128 tile of C and walks K in steps of 32,
// staging a 128x32 slice of A (transposed, so a thread reads 4 consecutive
// rows as one float4) and a 32x128 slice of B in shared memory as f32.
// Thread (ty, tx) of a 16x16 grid keeps an 8x8 block of C in registers.
// Loads from device memory are scalar and coalesced along each matrix's
// rows, so any shape works. Nothing on the probe path runs it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace {

// --- f32: the FMA kernel ----------------------------------------------------

constexpr int kTile = 128;               // C tile: kTile x kTile
constexpr int kStepK = 32;               // K slice staged per step
constexpr int kThreads = 256;            // 16 x 16 threads, 8 x 8 of C each
constexpr int kStrideA = kTile + 4;      // As row stride: float4-aligned, fewer conflicts

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

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


// --- bf16/f16: wgmma fed by TMA --------------------------------------------

constexpr int kBM = 128;                      // C tile rows: two warpgroups of 64
constexpr int kBN = 64;                       // C tile columns: one 128-byte atom of B
constexpr int kBK = 64;                       // K slice: 128 bytes of A's rows
constexpr int kStages = 4;
constexpr int kConsumerThreads = 256;
constexpr int kWgThreads = kConsumerThreads + 32;  // + the producer warp
constexpr uint32_t kTileA = kBM * kBK * 2;    // 16 KB
constexpr uint32_t kTileB = kBK * kBN * 2;    // 8 KB
constexpr uint32_t kStageBytes = kTileA + kTileB;
constexpr size_t kWgSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + align

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// box (c0 inner, c1 outer) of `map` into shared memory at dst, completing
// its bytes on the mbarrier at bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 64, this thread's 32 values) += A (64 x 16, K-major) B (16 x 64,
// N-major: the transpose-B flag)
#define MXT_WGMMA_M64N64K16(TY)                                                   \
  asm volatile(                                                                   \
      "{\n"                                                                       \
      ".reg .pred p;\n"                                                           \
      "setp.ne.b32 p, %34, 0;\n"                                                  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n"                                     \
      "}\n"                                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    MXT_WGMMA_M64N64K16("bf16");
  } else {
    MXT_WGMMA_M64N64K16("f16");
  }
}
#undef MXT_WGMMA_M64N64K16

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 2)
blocked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b,
                            T* __restrict__ c, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_a = base;                          // [kStages][kBM][kBK]
  const uint32_t s_b = base + kStages * kTileA;       // [kStages][kBK][kBN]
  const uint32_t bar_full = base + kStages * kStageBytes;  // [kStages] u64
  const uint32_t bar_empty = bar_full + 8 * kStages;       // [kStages] u64

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_k = (k + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warp: lane 0 issues the loads
    if (tid == kConsumerThreads) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        // a fresh barrier counts its phase of parity 1 as complete, so the
        // first pass over the ring does not wait
        mbar_wait(bar_empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, kStageBytes);
        tma_load_2d(s_a + s * kTileA, &tm_a, bar_full + 8 * s, kt * kBK, m0);
        tma_load_2d(s_b + s * kTileB, &tm_b, bar_full + 8 * s, n0, kt * kBK);
      }
    }
    return;
  }

  const int wg = tid / 128;  // consumer warpgroup: C rows m0 + 64 wg ..
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(bar_full + 8 * s, (kt / kStages) & 1);
    const uint32_t a_tile = s_a + s * kTileA + wg * 64 * 128;
    const uint32_t b_tile = s_b + s * kTileB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n64k16<T>(d, sw128_desc(a_tile + 32 * kk, 16, 1024),
                         sw128_desc(b_tile + 2048 * kk, 1024, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the group that read the previous stage has retired
    if (kt > 0) mbar_arrive(bar_empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();

  // accumulator fragment: warp w of the warpgroup holds rows 16 w + g and
  // 16 w + 8 + g, columns 8 j + 2 t and + 1 in d[4 j .. 4 j + 3]
  const int lane = tid % 32, w = (tid / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (n % 2) == 0;  // 4-byte stores stay aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 64 * wg + 16 * w + 8 * h + g;
    if (row >= m) continue;
    T* crow = c + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < n) {
        if constexpr (std::is_same<T, __nv_bfloat16>::value)
          *reinterpret_cast<__nv_bfloat162*>(crow + col) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<__half2*>(crow + col) = __floats2half2_rn(v0, v1);
      } else {
        if (col < n) crow[col] = from_f32<T>(v0);
        if (col + 1 < n) crow[col + 1] = from_f32<T>(v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (rows, cols) 16-bit matrix whose rows start `pitch` elements apart, read
// in boxes of box_rows x 64 columns with the 128-byte swizzle; zeros past
// its edges
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int pitch,
            int box_rows, CUtensorMapDataType type) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int ceil8(int x) { return (x + 7) / 8 * 8; }

template <typename T>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                         cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tm_a, tm_b;
  if (!encode(&tm_a, a, m, k, ceil8(k), kBM, type) ||
      !encode(&tm_b, b, k, n, ceil8(n), kBK, type))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(blocked_matmul_wgmma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  blocked_matmul_wgmma_kernel<T><<<grid, kWgThreads, kWgSmem, stream>>>(
      tm_a, tm_b, static_cast<T*>(c), m, n, k);
  return cudaGetLastError();
}

cudaError_t launch_fma(const void* a, const void* b, void* c, int m, int n, int k,
                       cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  blocked_matmul_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c),
      m, n, k);
  return cudaGetLastError();
}

}  // namespace

// a (m, k), b (k, n), c (m, n): row-major, one dtype, c contiguous.
// dtype: 0 float32 (a and b contiguous; the FMA kernel), 1 bfloat16, 2
// float16 (wgmma + TMA: a's rows start ceil8(k) elements apart, b's ceil8(n),
// at 16-byte aligned addresses; contiguous when k and n are multiples of 8).
// Returns a cudaError_t.
extern "C" int mxt_blocked_matmul(const void* a, const void* b, void* c, int m,
                                  int n, int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fma(a, b, c, m, n, k, s);
    case 1: return launch_wgmma<__nv_bfloat16>(a, b, c, m, n, k, s);
    case 2: return launch_wgmma<__half>(a, b, c, m, n, k, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
