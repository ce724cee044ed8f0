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
//   - under `causal` (absolute positions, q_pos >= k_pos, also when T != Tk),
//     dQ skips the key tiles wholly above the diagonal (:191-192) and dK/dV
//     the query tiles wholly below it (:240-242);
//   - roundings (bf16/f16 inputs): dS is rounded to K's dtype before the dQ
//     product, P to dO's dtype before the dV product and dS to Q's dtype
//     before the dK product, each once, where it is packed into an mma
//     operand; every product accumulates in f32 and the results are rounded
//     once, to the input dtype. The scale multiplies each accumulator once
//     at the end (the TPU kernel scales each tile's product; in f32 the two
//     differ only in rounding);
//   - ragged edges are masked here, not padded as the TPU wrapper does
//     (:284-290): keys past Tk are masked in dQ; query rows past T load as
//     zero with LSE = delta = 0 in dK/dV and are masked, so P = exp(-1e30) = 0.
//
// Design. The TPU kernels walk a sequential inner grid axis with the
// accumulators in VMEM. Here blocks run in no order, so the two-kernel split
// is kept and each block loops over the other axis itself; no block writes
// another's output, so the result needs no atomics and is bit-identical from
// run to run.
//
// Every product runs on the tensor cores through warp-level mma.sync:
//   - bf16/f16: m16n8k16 with f32 accumulators; operands from shared memory
//     by ldmatrix (.trans for a B operand stored k-major);
//   - f32: m16n8k8 TF32 with the 3xTF32 split: a = hi + lo, hi =
//     tf32_rna(a), lo = tf32_rna(a - hi), the bits cvt.rna.tf32.f32 gives,
//     by two integer operations; a*b = lo*hi + hi*lo + hi*hi, the
//     two small terms first, into one f32 accumulator. Operands are split
//     once, as each fragment is loaded from shared memory by per-lane
//     ld.shared in the m16n8k8 layout.
// Two product shapes serve both kernels, each warp owning 16 rows of M:
//   NT: C(16 x N) += A(16 x D) B(N x D)^T, both read row-major along D:
//       S = Q K^T and dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV);
//   NN: C(16 x D) += A(16 x N) B(N x D), A taken in registers straight from
//       the accumulator fragments of the NT product and B read k-major:
//       dQ += dS K; dV += P^T dO and dK += dS^T Q, these two a k step of
//       each in turn, so that each step's P and dS registers are freed.
// The m16n8k16 accumulator layout of two adjacent n8 tiles is the A layout
// of one k16 step. For m16n8k8 the accumulator holds columns 2t, 2t+1 where
// A wants t, t+4; the k index is a sum, so the B rows are read in that same
// order (k = t from row 2t, k = t+4 from row 2t+1) and no value moves. P
// and dS never go through shared memory.
//
// Tiles (`Tiles`). 128 threads, 4 warps; each warp owns two 16-row slabs of
// the block's resident axis (one at D = 128), so a block keeps 128 rows (Q
// and dO rows for dQ, K and V rows for dK/dV) and every B fragment, split
// or read by ldmatrix once, serves two mma. The other axis streams through
// a ring of two stages filled by cp.async.cg (16 B a thread), the next tile
// loading while the current one is in the tensor cores: 32 rows a tile, 16
// for the f32 dK/dV kernel, whose two D-wide accumulators leave the fewest
// registers. LSE and delta of a streamed q tile come by 4-byte cp.async.
// Rows past T or Tk are zero-filled by the copy's source size, with the
// source pointer clamped inside the tensor; row starts must be 16-byte
// aligned (the wrapper checks). Rows are padded by 16 B (f32: D+4 floats,
// so the per-lane fragment loads hit 32 distinct banks; 16-bit: D+8
// elements, so each 8x8 ldmatrix reads 8 distinct 16-byte bank groups).
// Shared memory a block (dynamic) at D=64: f32 105,472 B (dQ) / 87,296 B
// (dK/dV), bf16/f16 56,320 / 55,808 B; two f32 blocks fit an SM. Grid (BH,
// ceil(rows / 128)): 768 blocks at BERT-base for 132 SMs. Registers,
// stack and local memory (where spills go): `cuobjdump -res-usage` of the
// built library, printed by chip_smoke.py with each kernel's HMMA count
// (PERF.md).
//
// Bound at BERT-base shapes (B=8, H=12, T=Tk=1024, D=64): dQ does
// 6*BH*T*Tk*D = 38.7 GFLOP (S, dP, dQ), dK/dV 8*BH*T*Tk*D = 51.5 GFLOP
// (S, dP, dV, dK). In f32 by 3xTF32 that is three TF32 products each:
// 0.234 / 0.312 ms at 495 TFLOP/s (0.577 / 0.769 ms at the 67 TFLOP/s FMA
// rate of the earlier kernels); bf16 0.039 / 0.052 ms at 989 TFLOP/s. Each
// moves about 0.13 GB in f32 (0.04 ms at 3.35 TB/s): bound by operations.
// What still holds them back (read from the SASS and the times, not
// measured apart): the f32 path issues about six other instructions for
// each HMMA, mostly the split of every fragment in every warp that loads
// it, so instruction issue rather than the tensor cores bounds it; the
// 16-bit path runs at about a fifth of the bf16 rate, with mma.sync's small
// tiles, few warps an SM to hide the latency of ldmatrix and exp, and two
// block barriers a tile. A wgmma/TMA 16-bit path is queued in ROADMAP.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

template <typename T> constexpr bool kIsF32 = std::is_same<T, float>::value;

// shared-memory row stride of a (rows, D) tile: rows padded by 16 bytes
template <typename T, int D> constexpr int kLd = kIsF32<T> ? D + 4 : D + 8;

// Tiles of the dQ (kDkv false) or dK/dV (kDkv true) kernel. Each warp owns
// kMS slabs of 16 resident rows (kBM rows a block); the block streams the
// other axis kBN rows at a time. Two slabs a warp make each B fragment,
// split (f32) or read by ldmatrix (16-bit) once, serve two products. At
// D = 128 one slab keeps the D-wide accumulators in registers; the f32
// dK/dV kernel, which holds two of them, streams 16 rows. LSE and delta sit
// in shared memory: the resident rows' for dQ, two stages for dK/dV.
template <typename T, int D, bool kDkv> struct Tiles {
  static constexpr int kMS = D >= 128 ? 1 : 2;
  static constexpr int kBM = 16 * kMS * kWarps;
  static constexpr int kBN = D < 128 && kDkv && kIsF32<T> ? 16 : 32;
  static constexpr size_t kBytes =  // resident 2 x kBM rows, 2 stages x 2 x kBN
      sizeof(T) * (size_t)kLd<T, D> * (2 * kBM + 4 * kBN) +
      sizeof(float) * 2 * (kDkv ? 2 * kBN : kBM);  // LSE and delta
};

// --- asynchronous copies --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + N) of a (rows, D) matrix into shared memory (kLd<T, D>),
// rows at or past `limit` zero-filled
template <typename T, int D, int N>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int limit) {
  constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int kPerRow = D / kChunk;
#pragma unroll
  for (int idx = threadIdx.x; idx < N * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kChunk;
    const bool valid = r0 + r < limit;
    cp_async16(dst + r * kLd<T, D> + c, src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

// --- fragments and mma ----------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), by two integer operations on the bits: the same bits for
// every finite x. ptxas expands cvt.rna.tf32 into a NaN-checking sequence
// (FSETP, SEL, IMAD) that made the split the f32 kernels' bottleneck.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32, the two small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// two f32 values rounded to T (once) and packed, the first in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (kIsF32<T>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
}

// One warp: c[m][NT][4] (16 x 8*NT) += A_m(16 x D) B(8*NT x D)^T for its
// MS slabs m, A_m's 16 rows at sA + 16 m rows, B's rows at sB, both with
// the stride kLd<T, D>. Lane (g, t) = (lane / 4, lane % 4).
template <typename T, int D, int NT, int MS>
__device__ __forceinline__ void mma_nt(float (&c)[MS][NT][4], const T* sA, const T* sB,
                                       int lane) {
  constexpr int ld = kLd<T, D>;
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[MS][4], al[MS][4];
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const float* a = sA + 16 * m * ld + 8 * kk + t;
        split_tf32(a[g * ld], ah[m][0], al[m][0]);
        split_tf32(a[(g + 8) * ld], ah[m][1], al[m][1]);
        split_tf32(a[g * ld + 4], ah[m][2], al[m][2]);
        split_tf32(a[(g + 8) * ld + 4], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        const float* b = sB + (8 * nt + g) * ld + 8 * kk + t;
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[4], bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < MS; ++m) mma_3xtf32(c[m][nt], ah[m], al[m], bh, bl);
      }
    }
  } else {
    static_assert(NT % 2 == 0, "16-bit B fragments come two n8 tiles at a time");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MS][4];
#pragma unroll
      for (int m = 0; m < MS; ++m)
        ldmatrix_x4(a[m], sA + (16 * m + lane % 16) * ld + 16 * kk + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (16 * np + (lane / 16) * 8 + lane % 8) * ld + 16 * kk +
                           ((lane / 8) % 2) * 8);
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          mma16<T>(c[m][2 * np], a[m], b[0], b[1]);
          mma16<T>(c[m][2 * np + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

// k steps of an mma_nn over 8*NT rows: k8 for TF32, k16 for 16-bit types
template <typename T, int NT> constexpr int kNNSteps = kIsF32<T> ? NT : NT / 2;

// One warp, step j of kNNSteps: c[m][D/8][4] (16 x D) += A_m(16 x 8*NT)
// B(8*NT x D) over A's columns of that step, for its MS slabs m; A_m is
// given as the accumulator fragments p[m][NT][4] of an mma_nt (rounded to T
// here for 16-bit types), B's rows (the k index) at sB with the stride
// kLd<T, D>. A caller that runs two products step by step lets each step's
// P or dS registers go as soon as it is done.
template <typename T, int D, int NT, int MS>
__device__ __forceinline__ void mma_nn_step(float (&c)[MS][D / 8][4],
                                            const float (&p)[MS][NT][4], const T* sB,
                                            int lane, int j) {
  constexpr int ld = kLd<T, D>;
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
    // A's k = t is column 2t of the accumulator tile, k = t + 4 column 2t+1
    uint32_t ah[MS][4], al[MS][4];
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      split_tf32(p[m][j][0], ah[m][0], al[m][0]);
      split_tf32(p[m][j][2], ah[m][1], al[m][1]);
      split_tf32(p[m][j][1], ah[m][2], al[m][2]);
      split_tf32(p[m][j][3], ah[m][3], al[m][3]);
    }
    const float* b = sB + (8 * j + 2 * t) * ld + g;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(b[8 * nt], bh[0], bl[0]);
      split_tf32(b[ld + 8 * nt], bh[1], bl[1]);
#pragma unroll
      for (int m = 0; m < MS; ++m) mma_3xtf32(c[m][nt], ah[m], al[m], bh, bl);
    }
  } else {
    uint32_t a[MS][4];
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      a[m][0] = pack2<T>(p[m][2 * j][0], p[m][2 * j][1]);
      a[m][1] = pack2<T>(p[m][2 * j][2], p[m][2 * j][3]);
      a[m][2] = pack2<T>(p[m][2 * j + 1][0], p[m][2 * j + 1][1]);
      a[m][3] = pack2<T>(p[m][2 * j + 1][2], p[m][2 * j + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (16 * j + ((lane / 8) % 2) * 8 + lane % 8) * ld +
                               16 * dp + (lane / 16) * 8);
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        mma16<T>(c[m][2 * dp], a[m], b[0], b[1]);
        mma16<T>(c[m][2 * dp + 1], a[m], b[2], b[3]);
      }
    }
  }
}

template <int MS, int N>
__device__ __forceinline__ void zero(float (&c)[MS][N][4]) {
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
}

// a warp's MS slabs of 16 x D accumulators, times `mul`, into the (rows, D)
// output: this lane's rows r + 16 m and r + 16 m + 8; rows at or past
// `limit` are not written
template <typename T, int D, int MS>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[MS][D / 8][4], int r,
                                           int limit, float mul, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 16 * m + 8 * h;
      if (row >= limit) continue;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        store2<T>(out + (size_t)row * D + 8 * nt + 2 * t, c[m][nt][2 * h] * mul,
                  c[m][nt][2 * h + 1] * mul);
    }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(T / kBM)); a block holds kBM q rows of Q and dO and
// streams K and V in tiles of kBN keys
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_q, int t_k, float scale, int causal) {
  using Cfg = Tiles<T, D, false>;
  constexpr int ld = kLd<T, D>;
  constexpr int kMS = Cfg::kMS, kBM = Cfg::kBM, kBN = Cfg::kBN, kNT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [kBM][ld]
  T* sDO = sQ + kBM * ld;                  // [kBM][ld]
  T* sK = sDO + kBM * ld;                  // [2][kBN][ld]
  T* sV = sK + 2 * kBN * ld;               // [2][kBN][ld]
  float* sL = reinterpret_cast<float*>(sV + 2 * kBN * ld);  // [kBM] LSE
  float* sD = sL + kBM;                                      // [kBM] delta

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * t_q * D;
  const size_t koff = (size_t)bh * t_k * D;

  int n_k = (t_k + kBN - 1) / kBN;
  if (causal) {  // key tiles wholly above the diagonal contribute nothing
    const int last = (q0 + kBM - 1) / kBN + 1;
    n_k = n_k < last ? n_k : last;
  }

  load_rows<T, D, kBM>(sQ, q + qoff, q0, t_q);
  load_rows<T, D, kBM>(sDO, dout + qoff, q0, t_q);
  if (n_k > 0) {
    load_rows<T, D, kBN>(sK, k + koff, 0, t_k);
    load_rows<T, D, kBN>(sV, v + koff, 0, t_k);
  }
  cp_async_commit();

  for (int r = threadIdx.x; r < kBM; r += kThreads) {  // read after the first sync
    const int qi = q0 + r;
    sL[r] = qi < t_q ? lse[(size_t)bh * t_q + qi] : 0.f;
    sD[r] = qi < t_q ? delta[(size_t)bh * t_q + qi] : 0.f;
  }

  const int w0 = warp * 16 * kMS;  // the warp's first row in the block
  const int r0 = q0 + w0 + g;      // this lane's rows r0 + 16 m (+ 8)
  float acc[kMS][D / 8][4];
  zero(acc);

  const T* wQ = sQ + w0 * ld;
  const T* wDO = sDO + w0 * ld;
  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_k) {  // the next tile into the other stage
      const int nxt = (kt + 1) * kBN;
      load_rows<T, D, kBN>(sK + (stage ^ 1) * kBN * ld, k + koff, nxt, t_k);
      load_rows<T, D, kBN>(sV + (stage ^ 1) * kBN * ld, v + koff, nxt, t_k);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the copy just issued have landed
    __syncthreads();
    const T* cK = sK + stage * kBN * ld;
    const T* cV = sV + stage * kBN * ld;

    float s[kMS][kNT][4], dp[kMS][kNT][4];
    zero(s);
    zero(dp);
    mma_nt<T, D, kNT, kMS>(s, wQ, cK, lane);
    mma_nt<T, D, kNT, kMS>(dp, wDO, cV, lane);

    const int k0 = kt * kBN;
#pragma unroll
    for (int m = 0; m < kMS; ++m)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w0 + 16 * m + 8 * (e >> 1) + g;  // row in the block
          const int kj = k0 + 8 * nt + 2 * t + (e & 1);
          const bool keep = kj < t_k && (!causal || q0 + r >= kj);
          const float p = expf((keep ? s[m][nt][e] * scale : kNeg) - sL[r]);
          s[m][nt][e] = p * (dp[m][nt][e] - sD[r]);  // dS
        }
#pragma unroll
    for (int j = 0; j < kNNSteps<T, kNT>; ++j)
      mma_nn_step<T, D, kNT, kMS>(acc, s, cK, lane, j);
    __syncthreads();  // this stage is refilled at the next iteration
  }

  store_rows<T, D, kMS>(dq + qoff, acc, r0, t_q, scale, lane);
}

// ---------------------------------------------------------------------------
// dK / dV: grid (BH, ceil(Tk / kBM)); a block holds kBM key rows of K and V
// and streams Q, dO, LSE and delta in tiles of kBN q rows
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k,
                     float scale, int causal) {
  using Cfg = Tiles<T, D, true>;
  constexpr int ld = kLd<T, D>;
  constexpr int kMS = Cfg::kMS, kBM = Cfg::kBM, kBN = Cfg::kBN, kNT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [kBM][ld]
  T* sV = sK + kBM * ld;                   // [kBM][ld]
  T* sQ = sV + kBM * ld;                   // [2][kBN][ld]
  T* sDO = sQ + 2 * kBN * ld;              // [2][kBN][ld]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kBN * ld);  // [2][kBN] LSE
  float* sD = sL + 2 * kBN;                                   // [2][kBN] delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * t_q * D;
  const size_t koff = (size_t)bh * t_k * D;
  const float* lse_bh = lse + (size_t)bh * t_q;
  const float* delta_bh = delta + (size_t)bh * t_q;

  const int n_q = (t_q + kBN - 1) / kBN;
  // causal: q tiles wholly below the diagonal (every q_pos < k0) contribute
  // nothing; the first live tile holds q row k0
  const int first = causal ? k0 / kBN : 0;

  auto load_q_tile = [&](int qt, int stage) {
    const int q0 = qt * kBN;
    load_rows<T, D, kBN>(sQ + stage * kBN * ld, q + qoff, q0, t_q);
    load_rows<T, D, kBN>(sDO + stage * kBN * ld, dout + qoff, q0, t_q);
    for (int r = threadIdx.x; r < kBN; r += kThreads) {
      const bool valid = q0 + r < t_q;
      const int src = valid ? q0 + r : 0;
      cp_async4(sL + stage * kBN + r, lse_bh + src, valid);
      cp_async4(sD + stage * kBN + r, delta_bh + src, valid);
    }
  };

  load_rows<T, D, kBM>(sK, k + koff, k0, t_k);
  load_rows<T, D, kBM>(sV, v + koff, k0, t_k);
  if (first < n_q) load_q_tile(first, 0);
  cp_async_commit();

  float acc_k[kMS][D / 8][4], acc_v[kMS][D / 8][4];
  zero(acc_k);
  zero(acc_v);

  const int r0 = k0 + warp * 16 * kMS + g;  // this lane's key rows r0 + 16 m (+ 8)
  const T* wK = sK + warp * 16 * kMS * ld;
  const T* wV = sV + warp * 16 * kMS * ld;
  for (int qt = first; qt < n_q; ++qt) {
    const int stage = (qt - first) & 1;
    if (qt + 1 < n_q) load_q_tile(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* cQ = sQ + stage * kBN * ld;
    const T* cDO = sDO + stage * kBN * ld;
    const float* cL = sL + stage * kBN;
    const float* cD = sD + stage * kBN;

    float s[kMS][kNT][4], dp[kMS][kNT][4];  // S^T, dP^T: key rows x q columns
    zero(s);
    zero(dp);
    mma_nt<T, D, kNT, kMS>(s, wK, cQ, lane);
    mma_nt<T, D, kNT, kMS>(dp, wV, cDO, lane);

    const int q0 = qt * kBN;
#pragma unroll
    for (int m = 0; m < kMS; ++m)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = r0 + 16 * m + 8 * (e >> 1);
          const int c = 8 * nt + 2 * t + (e & 1);
          const int qi = q0 + c;
          const bool keep = qi < t_q && (!causal || qi >= kj);
          const float p = expf((keep ? s[m][nt][e] * scale : kNeg) - cL[c]);
          s[m][nt][e] = p;                             // P^T
          dp[m][nt][e] = p * (dp[m][nt][e] - cD[c]);  // dS^T
        }
#pragma unroll
    for (int j = 0; j < kNNSteps<T, kNT>; ++j) {
      mma_nn_step<T, D, kNT, kMS>(acc_v, s, cDO, lane, j);
      mma_nn_step<T, D, kNT, kMS>(acc_k, dp, cQ, lane, j);
    }
    __syncthreads();  // this stage is refilled at the next iteration
  }

  store_rows<T, D, kMS>(dk + koff, acc_k, r0, t_k, scale, lane);
  store_rows<T, D, kMS>(dv + koff, acc_v, r0, t_k, 1.f, lane);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int t_q,
                      int t_k, int causal, float scale, cudaStream_t stream) {
  using Cfg = Tiles<T, D, false>;
  constexpr size_t smem = Cfg::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + Cfg::kBM - 1) / Cfg::kBM);
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
  using Cfg = Tiles<T, D, true>;
  constexpr size_t smem = Cfg::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_k + Cfg::kBM - 1) / Cfg::kBM);
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

template <typename T> int smem_bytes(int dkv, int d) {
  switch (d) {
    case 32: return (int)(dkv ? Tiles<T, 32, true>::kBytes : Tiles<T, 32, false>::kBytes);
    case 64: return (int)(dkv ? Tiles<T, 64, true>::kBytes : Tiles<T, 64, false>::kBytes);
    case 128: return (int)(dkv ? Tiles<T, 128, true>::kBytes : Tiles<T, 128, false>::kBytes);
    default: return -1;
  }
}

}  // namespace

// q, do: (bh, t_q, d); k, v: (bh, t_k, d), all contiguous, of one dtype and
// 16-byte aligned; lse, delta: (bh, t_q) f32; dq like q. dtype: 0 float32,
// 1 bfloat16, 2 float16. Returns a cudaError_t.
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

// dynamic shared memory a block of the dQ (dkv = 0) or dK/dV (dkv = 1)
// kernel takes; -1 for a dtype or head dim the kernels do not take
extern "C" int mxt_flash_attention_bwd_smem_bytes(int dkv, int d, int dtype) {
  switch (dtype) {
    case 0: return smem_bytes<float>(dkv, d);
    case 1: return smem_bytes<__nv_bfloat16>(dkv, d);
    case 2: return smem_bytes<__half>(dkv, d);
    default: return -1;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
