// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (line 86, launched by `_fwd` (line 136) at line 145): blocked
// softmax(Q K^T * scale) V with an online running max and sum in f32,
// returning O in the input dtype and the row log-sum-exp (LSE) in f32.
//
// Semantics kept from the Pallas kernel:
//   - keys at or beyond Tk are masked, and under `causal` so is q_pos < k_pos
//     (absolute positions, also when T != Tk), with the finite value -1e30
//     (an -inf would make exp(-inf - -inf) = nan);
//   - under `causal`, key tiles wholly above the diagonal are skipped;
//   - for bf16/f16 inputs, p is rounded to the input dtype before the PV
//     product (flash_attention.py:124-126) while l sums the unrounded f32 p;
//     scores, statistics and the accumulator stay in f32.
//
// Design. The TPU kernel walks a 3-D grid (BH, q-block, k-block) whose last
// axis runs in order on one core and carries the accumulators in VMEM. Here
// blocks run in parallel in no order, so each block of 128 threads owns one
// (bh, kBM-row q tile) and loops over key tiles itself. Every product runs
// on the tensor cores through warp-level mma.sync, with the helpers that the
// backward kernels use (tensor_core.cuh): bf16/f16 m16n8k16, f32 m16n8k8
// TF32 with the 3xTF32 split (one TF32 product misses the f32 tolerance).
//   - Each warp owns kMS slabs of 16 query rows; their Q fragments (for f32
//     the TF32 hi and lo parts) are loaded once and stay in registers for
//     the whole key loop.
//   - K and V stream through a two-stage cp.async ring, kBN keys a tile,
//     the next tile loading while the current one is in the tensor cores;
//     rows past Tk are zero-filled by the copy's source size.
//   - S = Q K^T (mma_nt_frags) lands in accumulator fragments. The online
//     softmax runs on them: a row lives in the quad of lanes that share
//     lane / 4, so its max and sum reduce by two xor-shuffles. Scores are
//     kept in log2 units (scale * log2 e folded in), so p = exp2(s - m).
//   - P goes from those fragments straight into the A operand of P V
//     (mma_nn_step), never through shared memory: for bf16/f16 the packing
//     is p's rounding; for f32 p is split into hi/lo, and V's k rows are
//     read in the order the m16n8k8 accumulator holds P's columns.
//   - O is rescaled by alpha = exp2(m_old - m_new) at each tile; at the end
//     the kernel writes O / l and LSE = m ln 2 + log(l). In f32 the O
//     accumulator goes to the output every kFlushRows keys (`add_rows`,
//     tensor_core.cuh: one mma accumulator over a long loop drifts); the
//     output holds the unnormalized sum at the running max m_o of that
//     moment, brought to today's max by exp2(m_o - m) at the next addition.
// Head dims 16, 32, 64, 128 and 256 are instantiated (the wrapper zero-pads
// any other D up to 256). At D = 16 Q K^T is one k16 step (bf16) or two k8
// steps (f32), P V two n8 tiles, and a padded row of 48 B (bf16) or 80 B
// (f32) stays 16-byte aligned for cp.async and ldmatrix, with conflict-free
// banks. Tiles (`FwdTiles`): one slab a warp for f32 (Q hi/lo, S and O at
// D=64 are about 130 live registers) and at D>=128, two for bf16/f16 at
// D<=64; 64-key tiles, 32 for f32 at D>=128. Grid (BH, ceil(T / kBM),
// passes): 1536 blocks (f32) / 768 (bf16) at BERT-base for 132 SMs. Row
// starts must be 16-byte aligned (cp.async; the wrapper checks).
// D = 256 does not fit the D<=128 layout: Q's fragments alone would take
// 256 registers a lane in f32 (32 k8 steps x 4 x hi/lo) and O another 128.
// So at D = 256 (`kQRegs` false) Q stays in shared memory and its fragments
// are read and split at each k step (mma_nt), and O is computed in two
// passes of kDV = 128 columns, one a block (blockIdx.z): each pass forms S
// from the full D (so Q K^T runs twice, 1.5x the D<=128 work) and
// accumulates P V[:, pass columns] from a V tile of those columns only. Both
// passes compute the same m and l; pass 0 writes the LSE. Shared memory
// (Q and K at D, V at 128 columns): f32 166,912 B, bf16/f16 136,192 B.
//
// Bound at BERT-base shapes (B=8, H=12, T=Tk=1024, D=64): the work is
// 4*B*H*T*Tk*D = 25.8 GFLOP. In f32 by 3xTF32 that is three TF32 products,
// 0.156 ms at 495 TFLOP/s (0.385 ms at the 67 TFLOP/s rate of the FMA
// units); bf16 0.026 ms at 989 TFLOP/s; the bytes (q, k, v read once, o
// written once: 100.7 MB in f32) take 0.030 ms at 3.35 TB/s. So it is bound
// by operations. Registers, stack and local memory (where spills go) of each
// instantiation are read from the built library by chip_smoke.py.

#include <math.h>

#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D> struct FwdTiles {
  static constexpr int kMS = kIsF32<T> || D >= 128 ? 1 : 2;  // 16-row slabs a warp
  static constexpr int kBM = 16 * kMS * kWarps;                // query rows a block
  static constexpr int kBN = kIsF32<T> && D >= 128 ? 32 : 64;  // keys a tile
  static constexpr int kDV = D > 128 ? 128 : D;  // output columns a block (a pass)
  static constexpr int kPasses = D / kDV;
  static constexpr bool kQRegs = D <= 128;       // Q's fragments held in registers
  static constexpr size_t kBytes =  // Q tile, 2 stages of K, 2 of V's kDV columns
      sizeof(T) * ((size_t)kLd<T, D> * (kBM + 2 * kBN) + (size_t)kLd<T, kDV> * 2 * kBN);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_q, int t_k, float scale,
                 int causal) {
  using Cfg = FwdTiles<T, D>;
  constexpr int ld = kLd<T, D>;
  constexpr int kDV = Cfg::kDV, ldv = kLd<T, kDV>;
  constexpr int kMS = Cfg::kMS, kBM = Cfg::kBM, kBN = Cfg::kBN, kNT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [kBM][ld]
  T* sK = sQ + kBM * ld;                   // [2][kBN][ld]
  T* sV = sK + 2 * kBN * ld;               // [2][kBN][ldv]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBM;
  const int c0 = blockIdx.z * kDV;  // this pass's first output column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * t_q * D;
  const size_t koff = (size_t)bh * t_k * D;
  const float scale2 = scale * kLog2e;  // scores in log2 units

  int n_k = (t_k + kBN - 1) / kBN;
  if (causal) {  // key tiles wholly above the diagonal contribute nothing
    const int last = (q0 + kBM - 1) / kBN + 1;
    n_k = n_k < last ? n_k : last;
  }

  load_rows<T, D, kBM>(sQ, q + qoff, q0, t_q);
  cp_async_commit();
  load_rows<T, D, kBN>(sK, k + koff, 0, t_k);
  load_rows<T, kDV, kBN, D>(sV, v + koff + c0, 0, t_k);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V tile may still be in flight
  __syncthreads();

  const int w0 = warp * 16 * kMS;  // the warp's first row in the block
  constexpr int kQSteps = Cfg::kQRegs ? kKSteps<T, D> : 1;
  uint32_t qh[kQSteps][kMS][4], ql[kQSteps][kMS][4];
  if constexpr (Cfg::kQRegs) load_a_frags<T, D, kMS>(qh, ql, sQ + w0 * ld, lane);

  float acc[kMS][kDV / 8][4];
  float m_i[kMS][2], l_i[kMS][2];  // this lane's rows g and g + 8 of each slab
  float m_o[kMS][2];  // f32: the running max when acc last went to the output
  zero(acc);
  fill(m_o, kNeg);
  bool added = false;  // f32: a partial sum, scaled to exp2(-m_o), is in o
#pragma unroll
  for (int m = 0; m < kMS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_i[m][h] = kNeg;
      l_i[m][h] = 0.f;
    }

  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_k) {  // the next tile into the other stage
      const int nxt = (kt + 1) * kBN;
      load_rows<T, D, kBN>(sK + (stage ^ 1) * kBN * ld, k + koff, nxt, t_k);
      load_rows<T, kDV, kBN, D>(sV + (stage ^ 1) * kBN * ldv, v + koff + c0, nxt, t_k);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the copy just issued have landed
    __syncthreads();
    const T* cK = sK + stage * kBN * ld;
    const T* cV = sV + stage * kBN * ldv;

    float s[kMS][kNT][4];
    zero(s);
    if constexpr (Cfg::kQRegs)
      mma_nt_frags<T, D, kNT, kMS>(s, qh, ql, cK, lane);
    else
      mma_nt<T, D, kNT, kMS>(s, sQ + w0 * ld, cK, lane);

    const int k0 = kt * kBN;
#pragma unroll
    for (int m = 0; m < kMS; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = q0 + w0 + 16 * m + 8 * h + g;  // absolute query row
        float mx = kNeg;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const int kj = k0 + 8 * nt + 2 * t + (e & 1);
            const bool keep = kj < t_k && (!causal || qi >= kj);
            s[m][nt][e] = keep ? s[m][nt][e] * scale2 : kNeg;
            mx = fmaxf(mx, s[m][nt][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[m][h], mx);
        const float alpha = exp2f(m_i[m][h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[m][nt][e] = exp2f(s[m][nt][e] - m_new);  // p, unrounded
            rs += s[m][nt][e];
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_i[m][h] = l_i[m][h] * alpha + rs;
        m_i[m][h] = m_new;
#pragma unroll
        for (int nt = 0; nt < kDV / 8; ++nt) {
          acc[m][nt][2 * h] *= alpha;
          acc[m][nt][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
    for (int j = 0; j < kNNSteps<T, kNT>; ++j)
      mma_nn_step<T, kDV, kNT, kMS>(acc, s, cV, lane, j);
    __syncthreads();  // this stage is refilled at the next iteration
    if constexpr (kIsF32<T>) {
      if ((kt + 1) % (kFlushRows / kBN) == 0 && kt + 1 < n_k) {
        // o = o * exp2(m_o - m_i) + acc: the unnormalized sum at today's max
        float keep[kMS][2], one[kMS][2];
        fill(one, 1.f);
#pragma unroll
        for (int m = 0; m < kMS; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            keep[m][h] = exp2f(m_o[m][h] - m_i[m][h]);
            m_o[m][h] = m_i[m][h];
          }
        add_rows<kDV, kMS, D>(o + qoff + c0, acc, q0 + w0 + g, t_q, added, keep, one, lane);
        added = true;
      }
    }
  }

  float keep[kMS][2], inv_l[kMS][2];
#pragma unroll
  for (int m = 0; m < kMS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + w0 + 16 * m + 8 * h + g;
      const float li = fmaxf(l_i[m][h], 1e-30f);
      inv_l[m][h] = 1.f / li;
      keep[m][h] = exp2f(m_o[m][h] - m_i[m][h]) / li;
      if (qi >= t_q) continue;
      if (t == 0 && c0 == 0) lse[(size_t)bh * t_q + qi] = m_i[m][h] * kLn2 + logf(li);
      if constexpr (!kIsF32<T>) {
        T* orow = o + qoff + (size_t)qi * D + c0;
#pragma unroll
        for (int nt = 0; nt < kDV / 8; ++nt)
          store2<T>(orow + 8 * nt + 2 * t, acc[m][nt][2 * h] / li, acc[m][nt][2 * h + 1] / li);
      }
    }
  if constexpr (kIsF32<T>)
    add_rows<kDV, kMS, D>(o + qoff + c0, acc, q0 + w0 + g, t_q, added, keep, inv_l, lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_q, int t_k, int causal, float scale,
                   cudaStream_t stream) {
  using Cfg = FwdTiles<T, D>;
  constexpr size_t smem = Cfg::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + Cfg::kBM - 1) / Cfg::kBM, Cfg::kPasses);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t_q, t_k, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_q, int t_k, int d, int causal,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T> int smem_bytes(int d) {
  switch (d) {
    case 16: return (int)FwdTiles<T, 16>::kBytes;
    case 32: return (int)FwdTiles<T, 32>::kBytes;
    case 64: return (int)FwdTiles<T, 64>::kBytes;
    case 128: return (int)FwdTiles<T, 128>::kBytes;
    case 256: return (int)FwdTiles<T, 256>::kBytes;
    default: return -1;
  }
}

}  // namespace

// q, k, v: (bh, t_q | t_k, d) contiguous, 16-byte aligned; o like q; lse
// (bh, t_q) f32. dtype: 0 float32, 1 bfloat16, 2 float16. Returns a
// cudaError_t.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int bh, int t_q, int t_k,
                                       int d, int dtype, int causal, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(q, k, v, o, lse, bh, t_q, t_k, d, causal, scale, s);
    case 1: return launch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, t_q, t_k, d, causal, scale, s);
    case 2: return launch_dim<__half>(q, k, v, o, lse, bh, t_q, t_k, d, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory a block takes; -1 for a dtype or head dim the
// kernel does not take
extern "C" int mxt_flash_attention_fwd_smem_bytes(int d, int dtype) {
  switch (dtype) {
    case 0: return smem_bytes<float>(d);
    case 1: return smem_bytes<__nv_bfloat16>(d);
    case 2: return smem_bytes<__half>(d);
    default: return -1;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
