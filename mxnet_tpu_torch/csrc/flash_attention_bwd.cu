// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of
// mxnet_tpu/ops/pallas/flash_attention.py:
//   - `_bwd_dq_kernel` (line 181, launched by `_bwd` at line 294):
//       dQ = scale * sum_k dS K,  dS = P o (dP - delta),
//       P = exp(S - LSE), S = Q K^T * scale, dP = dO V^T;
//   - `_bwd_dkv_kernel` (line 229, launched at line 321):
//       dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q.
// delta = rowsum(dO o O) (f32) and LSE (f32, from the forward) are inputs.
//
// Semantics kept from the Pallas kernels:
//   - P is recomputed from the LSE exactly as the forward formed S: the same
//     scale, masked entries at the finite -1e30 (so exp gives 0, never nan);
//   - under `causal`, dQ skips the key tiles wholly above the diagonal
//     (:191-192) and dK/dV the query tiles wholly below it (:240-242);
//   - roundings (bf16/f16 inputs): dS is rounded to K's dtype before the dQ
//     product, P to dO's dtype before the dV product and dS to Q's dtype
//     before the dK product; every product accumulates in f32 and the
//     results are rounded once, to the input dtype. The scale multiplies each
//     accumulator once at the end (the TPU kernel scales each tile's product;
//     in f32 the two differ only in rounding).
//   - ragged edges are masked here, not padded as the TPU wrapper does
//     (:284-290): keys past Tk are masked in dQ; query rows past T load as
//     zero with LSE = delta = 0 in dK/dV, and so contribute P = exp(-1e30) = 0.
//
// Design. The TPU kernels walk a sequential inner grid axis with the
// accumulators in VMEM. Here blocks run in no order, so the two-kernel split
// is kept and each block loops over the other axis itself; no block writes
// another's output, so the result needs no atomics and is the same from run
// to run.
//   dQ:   one block per (bh, 64-row q tile), 128 threads; thread (ty, tx) =
//         (tid / 8, tid % 8) owns q rows 4*ty .. 4*ty+3, takes keys tx, tx+8,
//         .., tx+56 of each 64-key tile for S and dP (4x8 each in
//         registers) and head dims tx, tx+8, .. for the dQ accumulator
//         (4 x D/8 in registers). dS goes through shared memory between the
//         two products.
//   dK/dV: one block per (bh, key tile), 128 threads; thread (ty, tx) owns
//         key rows R*ty .. R*ty+R-1 (R = 4 for 64-key tiles, 2 for the
//         32-key tiles taken at D=128 to keep the two R x D/8 accumulators,
//         S^T and dP^T in registers), q columns tx, tx+8, .. of each 64-row
//         q tile, and head dims tx, tx+8, .. for dK and dV. P^T and dS^T go
//         through shared memory.
// Tiles are widened to f32 on the way into shared memory; rows are padded
// (D+1 floats, 66 for P and dS) so that lanes of a warp hit distinct banks.
// The products run on the FMA units (no mma/wgmma yet), like the forward.
//
// Bound at BERT-base shapes (B=8, H=12, T=Tk=1024, D=64): dQ does
// 6*BH*T*Tk*D = 38.7 GFLOP (S, dP, dQ), 0.58 ms at the H100's 67 TFLOP/s
// f32 rate outside the tensor cores and 0.039 ms at 989 TFLOP/s bf16;
// dK/dV does 8*BH*T*Tk*D = 51.5 GFLOP (S, dP, dV, dK), 0.77 ms f32 and
// 0.052 ms bf16. Each moves about 0.13 GB in f32 (q, k, v, dO read, LSE and
// delta read, outputs written once), 0.04 ms at 3.35 TB/s. Both are bound by
// operations; tensor cores are the way to the bf16 bound, in a later PR.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;   // threads per row group
constexpr int kRowGroups = kThreads / kColGroups;  // 16
constexpr int kTile = 64;       // q rows per dQ block; q rows / keys per inner tile
constexpr int kCols = kTile / kColGroups;           // 8 columns per thread
constexpr int kPStride = kTile + 2;                 // 66
constexpr float kNeg = -1e30f;

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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// rows [r0, r0 + n) of a (rows, D) matrix into shared memory as f32, rows at
// or past `limit` as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n,
                                          int limit) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = r0 + r;
    dst[r * (D + 1) + c] = g < limit ? to_f32<T>(src[(size_t)g * D + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(T / 64))
// ---------------------------------------------------------------------------

template <int D> constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_q, int t_k, float scale, int causal) {
  constexpr int kStride = D + 1;
  constexpr int kDims = D / kColGroups;
  constexpr int kRows = kTile / kRowGroups;  // 4
  extern __shared__ float smem[];
  float* sQ = smem;                       // [64][D+1]
  float* sDO = sQ + kTile * kStride;      // [64][D+1]
  float* sK = sDO + kTile * kStride;      // [64][D+1]
  float* sV = sK + kTile * kStride;       // [64][D+1]
  float* sDS = sV + kTile * kStride;      // [64][66]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const int row0 = ty * kRows;
  const size_t qoff = (size_t)bh * t_q * D;
  const size_t koff = (size_t)bh * t_k * D;

  load_tile<T, D>(sQ, q + qoff, q0, kTile, t_q);
  load_tile<T, D>(sDO, dout + qoff, q0, kTile, t_q);
  float lse_r[kRows], delta_r[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    lse_r[i] = qi < t_q ? lse[(size_t)bh * t_q + qi] : 0.f;
    delta_r[i] = qi < t_q ? delta[(size_t)bh * t_q + qi] : 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[i][dd] = 0.f;
  }

  int n_k = (t_k + kTile - 1) / kTile;
  if (causal) {  // key tiles wholly above the diagonal contribute nothing
    const int last = (q0 + kTile - 1) / kTile + 1;
    n_k = n_k < last ? n_k : last;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<T, D>(sK, k + koff, k0, kTile, t_k);
    load_tile<T, D>(sV, v + koff, k0, kTile, t_k);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sQ[(row0 + i) * kStride + d];
        dov[i] = sDO[(row0 + i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = sK[(tx + kColGroups * j) * kStride + d];
        vv[j] = sV[(tx + kColGroups * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kColGroups * j;
        const bool keep = kj < t_k && (!causal || qi >= kj);
        const float p = expf((keep ? s[i][j] * scale : kNeg) - lse_r[i]);
        sDS[(row0 + i) * kPStride + tx + kColGroups * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();  // every row of dS is in shared memory

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsv[kRows], kv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = sDS[(row0 + i) * kPStride + j];
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) kv[dd] = sK[j * kStride + tx + kColGroups * dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) acc[i][dd] = fmaf(dsv[i], kv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= t_q) continue;
    T* row = dq + qoff + (size_t)qi * D;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd)
      row[tx + kColGroups * dd] = from_f32<T>(acc[i][dd] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK / dV: grid (BH, ceil(Tk / BK)), BK = 64 (32 at D = 128)
// ---------------------------------------------------------------------------

template <int D> struct DkvTile {
  static constexpr int kBK = D >= 128 ? 32 : 64;  // keys per block
};

template <int D> constexpr size_t dkv_smem_bytes() {
  constexpr int bk = DkvTile<D>::kBK;
  return sizeof(float) *
         (size_t)(2 * bk * (D + 1) + 2 * kTile * (D + 1) + 2 * bk * kPStride + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k,
                     float scale, int causal) {
  constexpr int kStride = D + 1;
  constexpr int kDims = D / kColGroups;
  constexpr int kBK = DkvTile<D>::kBK;
  constexpr int kRows = kBK / kRowGroups;  // key rows per thread: 4 or 2
  extern __shared__ float smem[];
  float* sK = smem;                       // [BK][D+1]
  float* sV = sK + kBK * kStride;         // [BK][D+1]
  float* sQ = sV + kBK * kStride;         // [64][D+1]
  float* sDO = sQ + kTile * kStride;      // [64][D+1]
  float* sP = sDO + kTile * kStride;      // [BK][66]   P^T
  float* sDS = sP + kBK * kPStride;       // [BK][66]   dS^T
  float* sL = sDS + kBK * kPStride;       // [64]       LSE of the q tile
  float* sD = sL + kTile;                 // [64]       delta of the q tile

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const int row0 = ty * kRows;
  const size_t qoff = (size_t)bh * t_q * D;
  const size_t koff = (size_t)bh * t_k * D;

  load_tile<T, D>(sK, k + koff, k0, kBK, t_k);
  load_tile<T, D>(sV, v + koff, k0, kBK, t_k);
  float acc_k[kRows][kDims], acc_v[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc_k[i][dd] = acc_v[i][dd] = 0.f;

  const int n_q = (t_q + kTile - 1) / kTile;
  // causal: q tiles wholly below the diagonal (every q_pos < k0) contribute
  // nothing; the first live tile holds row k0
  const int first = causal ? k0 / kTile : 0;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_tile<T, D>(sQ, q + qoff, q0, kTile, t_q);
    load_tile<T, D>(sDO, dout + qoff, q0, kTile, t_q);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int qi = q0 + r;
      sL[r] = qi < t_q ? lse[(size_t)bh * t_q + qi] : 0.f;
      sD[r] = qi < t_q ? delta[(size_t)bh * t_q + qi] : 0.f;
    }
    __syncthreads();

    float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[kCols], dov[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = sK[(row0 + i) * kStride + d];
        vv[i] = sV[(row0 + i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = sQ[(tx + kColGroups * j) * kStride + d];
        dov[j] = sDO[(tx + kColGroups * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kColGroups * j;
        const int qi = q0 + c;
        const bool keep = qi < t_q && (!causal || qi >= kj);
        const float p = expf((keep ? st[i][j] * scale : kNeg) - sL[c]);
        sP[(row0 + i) * kPStride + c] = round_to<T>(p);
        sDS[(row0 + i) * kPStride + c] = round_to<T>(p * (dpt[i][j] - sD[c]));
      }
    }
    __syncthreads();  // every row of P^T and dS^T is in shared memory

#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float pv[kRows], dsv[kRows], dov[kDims], qv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = sP[(row0 + i) * kPStride + j];
        dsv[i] = sDS[(row0 + i) * kPStride + j];
      }
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) {
        dov[dd] = sDO[j * kStride + tx + kColGroups * dd];
        qv[dd] = sQ[j * kStride + tx + kColGroups * dd];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) {
          acc_v[i][dd] = fmaf(pv[i], dov[dd], acc_v[i][dd]);
          acc_k[i][dd] = fmaf(dsv[i], qv[dd], acc_k[i][dd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + row0 + i;
    if (kj >= t_k) continue;
    T* krow = dk + koff + (size_t)kj * D;
    T* vrow = dv + koff + (size_t)kj * D;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      krow[tx + kColGroups * dd] = from_f32<T>(acc_k[i][dd] * scale);
      vrow[tx + kColGroups * dd] = from_f32<T>(acc_v[i][dd]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int t_q,
                      int t_k, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), t_q, t_k, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int t_q, int t_k, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  constexpr int bk = DkvTile<D>::kBK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_k + bk - 1) / bk);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), t_q,
      t_k, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_dim(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int t_q, int t_k,
                   int d, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, causal, scale, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, causal, scale, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_dim(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh,
                    int t_q, int t_k, int d, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, causal, scale, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, causal, scale, s);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, do: (bh, t_q, d); k, v: (bh, t_k, d), all contiguous and of one dtype;
// lse, delta: (bh, t_q) f32; dq like q. dtype: 0 float32, 1 bfloat16,
// 2 float16. Returns a cudaError_t.
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int bh, int t_q,
                                          int t_k, int d, int dtype, int causal,
                                          float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dq_dim<float>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, d, causal, scale, s);
    case 1: return dq_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, d, causal, scale, s);
    case 2: return dq_dim<__half>(q, k, v, dout, lse, delta, dq, bh, t_q, t_k, d, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// as above; dk, dv like k, v.
extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int t_q, int t_k, int d, int dtype, int causal,
                                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dkv_dim<float>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, d, causal, scale, s);
    case 1: return dkv_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, d, causal, scale, s);
    case 2: return dkv_dim<__half>(q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, d, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
