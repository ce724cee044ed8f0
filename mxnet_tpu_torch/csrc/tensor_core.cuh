// Warp-level tensor-core helpers for the flash-attention kernels (sm_90a):
// included by flash_attention_fwd.cu (K1) and flash_attention_bwd.cu (K2,
// K3), each built into its own library.
//
// - cp.async copies of 16 (rows) or 4 bytes (LSE, delta), zero-filled by
//   the source size for rows past the tensor's end (`load_rows`);
// - TF32 rounding and the 3xTF32 split: a = hi + lo, hi = tf32_rna(a), lo =
//   tf32_rna(a - hi); a*b = lo*hi + hi*lo + hi*hi, the two small terms first
//   (`split_tf32`, `mma_3xtf32` on mma.sync m16n8k8);
// - mma.sync m16n8k16 for bf16/f16 (`mma16`), operands by ldmatrix
//   (`.trans` for a B operand stored k-major);
// - the two product shapes of the attention kernels, each warp owning MS
//   slabs of 16 rows: NT, C(16 x N) += A(16 x D) B(N x D)^T, A and B read
//   row-major along D (`mma_nt` from shared memory, `mma_nt_frags` with A's
//   fragments held in registers by `load_a_frags`); NN, C(16 x D) +=
//   A(16 x N) B(N x D), A taken from the accumulator fragments of an NT
//   product and B read k-major (`mma_nn_step`). The m16n8k16 accumulator
//   layout of two adjacent n8 tiles is the A layout of one k16 step; for
//   m16n8k8 the accumulator holds columns 2t, 2t+1 where A wants t, t+4, so
//   B's rows are read in that order (k is a sum) and no value moves;
// - `store_rows`: a warp's accumulators into a (rows, D) output; `add_rows`
//   (f32) adds them into it, so that long sums leave the mma accumulators
//   every kFlushRows rows.
//
// Head dims above 128 (D = 256) run in passes of 128 output columns: the
// products that form S and dP read the full D, the ones that accumulate an
// output read a column block of their B tile (`load_rows`' SrcLd, the Ld of
// `mma_nn_step`) and write a column block of the output (OutLd of
// `store_rows`/`add_rows`), so no accumulator is wider than 128 columns.
//
// Shared-memory tiles are (rows, D) with rows padded by 16 bytes (`kLd`:
// f32 D+4 floats, so per-lane fragment loads hit 32 distinct banks; 16-bit
// D+8 elements, so each 8x8 ldmatrix reads 8 distinct 16-byte bank groups).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
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

// rows [r0, r0 + N) of a matrix whose rows lie SrcLd elements apart, W
// columns a row from `src` on, into shared memory (stride kLd<T, W>); rows
// at or past `limit` zero-filled. W = SrcLd copies whole rows; a narrower W
// takes a column block (the D = 256 passes' 128 columns of V)
template <typename T, int W, int N, int SrcLd = W>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int limit) {
  constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int kPerRow = W / kChunk;
#pragma unroll
  for (int idx = threadIdx.x; idx < N * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kChunk;
    const bool valid = r0 + r < limit;
    cp_async16(dst + r * kLd<T, W> + c, src + (size_t)(valid ? r0 + r : 0) * SrcLd + c, valid);
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

// k steps of a D-deep NT product: k8 for TF32, k16 for 16-bit types
template <typename T, int D> constexpr int kKSteps = kIsF32<T> ? D / 8 : D / 16;

// A fragments of k step kk of a warp's MS slabs of 16 rows at sA (stride
// kLd<T, D>): f32 split into TF32 hi (ah) and lo (al) from per-lane loads
// in the m16n8k8 layout; 16-bit by ldmatrix (al unused)
template <typename T, int D, int MS>
__device__ __forceinline__ void load_a_step(uint32_t (&ah)[MS][4], uint32_t (&al)[MS][4],
                                            const T* sA, int lane, int kk) {
  constexpr int ld = kLd<T, D>;
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    if constexpr (kIsF32<T>) {
      const int g = lane >> 2, t = lane & 3;
      const float* a = sA + 16 * m * ld + 8 * kk + t;
      split_tf32(a[g * ld], ah[m][0], al[m][0]);
      split_tf32(a[(g + 8) * ld], ah[m][1], al[m][1]);
      split_tf32(a[g * ld + 4], ah[m][2], al[m][2]);
      split_tf32(a[(g + 8) * ld + 4], ah[m][3], al[m][3]);
    } else {
      ldmatrix_x4(ah[m], sA + (16 * m + lane % 16) * ld + 16 * kk + (lane / 16) * 8);
    }
  }
}

// k step kk of an NT product: c[m][NT][4] (16 x 8*NT) += A_m B(8*NT x D)^T
// over that step's columns, A_m given as load_a_step's fragments, B's rows
// at sB (stride kLd<T, D>); each B fragment serves all MS slabs
template <typename T, int D, int NT, int MS>
__device__ __forceinline__ void mma_nt_step(float (&c)[MS][NT][4],
                                            const uint32_t (&ah)[MS][4],
                                            const uint32_t (&al)[MS][4], const T* sB,
                                            int lane, int kk) {
  constexpr int ld = kLd<T, D>;
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      const float* b = sB + (8 * nt + g) * ld + 8 * kk + t;
      split_tf32(b[0], bh[0], bl[0]);
      split_tf32(b[4], bh[1], bl[1]);
#pragma unroll
      for (int m = 0; m < MS; ++m) mma_3xtf32(c[m][nt], ah[m], al[m], bh, bl);
    }
  } else {
    static_assert(NT % 2 == 0, "16-bit B fragments come two n8 tiles at a time");
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (16 * np + (lane / 16) * 8 + lane % 8) * ld + 16 * kk +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        mma16<T>(c[m][2 * np], ah[m], b[0], b[1]);
        mma16<T>(c[m][2 * np + 1], ah[m], b[2], b[3]);
      }
    }
  }
}

// One warp: c[m][NT][4] (16 x 8*NT) += A_m(16 x D) B(8*NT x D)^T for its
// MS slabs m, A_m's 16 rows at sA + 16 m rows, B's rows at sB, both with
// the stride kLd<T, D>, A read step by step. Lane (g, t) = (lane / 4, lane % 4).
template <typename T, int D, int NT, int MS>
__device__ __forceinline__ void mma_nt(float (&c)[MS][NT][4], const T* sA, const T* sB,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < kKSteps<T, D>; ++kk) {
    uint32_t ah[MS][4], al[MS][4];
    load_a_step<T, D, MS>(ah, al, sA, lane, kk);
    mma_nt_step<T, D, NT, MS>(c, ah, al, sB, lane, kk);
  }
}

// A fragments of every k step, for mma_nt_frags: loaded once, they serve
// every B tile of a loop
template <typename T, int D, int MS>
__device__ __forceinline__ void load_a_frags(uint32_t (&ah)[kKSteps<T, D>][MS][4],
                                             uint32_t (&al)[kKSteps<T, D>][MS][4],
                                             const T* sA, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKSteps<T, D>; ++kk) load_a_step<T, D, MS>(ah[kk], al[kk], sA, lane, kk);
}

// mma_nt with A given as load_a_frags' fragments: the same products, in the
// same order, without reading or splitting A again
template <typename T, int D, int NT, int MS>
__device__ __forceinline__ void mma_nt_frags(float (&c)[MS][NT][4],
                                             const uint32_t (&ah)[kKSteps<T, D>][MS][4],
                                             const uint32_t (&al)[kKSteps<T, D>][MS][4],
                                             const T* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKSteps<T, D>; ++kk)
    mma_nt_step<T, D, NT, MS>(c, ah[kk], al[kk], sB, lane, kk);
}

// k steps of an mma_nn over 8*NT rows: k8 for TF32, k16 for 16-bit types
template <typename T, int NT> constexpr int kNNSteps = kIsF32<T> ? NT : NT / 2;

// One warp, step j of kNNSteps: c[m][D/8][4] (16 x D) += A_m(16 x 8*NT)
// B(8*NT x D) over A's columns of that step, for its MS slabs m; A_m is
// given as the accumulator fragments p[m][NT][4] of an mma_nt (rounded to T
// here for 16-bit types), B's rows (the k index) at sB with the stride Ld
// (kLd<T, D>, or a wider tile's when B is a column block of it). A caller
// that runs two products step by step lets each step's P or dS registers
// go as soon as it is done.
template <typename T, int D, int NT, int MS, int Ld = kLd<T, D>>
__device__ __forceinline__ void mma_nn_step(float (&c)[MS][D / 8][4],
                                            const float (&p)[MS][NT][4], const T* sB,
                                            int lane, int j) {
  constexpr int ld = Ld;
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

// a warp's MS slabs of 16 x D accumulators, times `mul`, into D columns of
// an output whose rows lie OutLd elements apart (D, or the full head dim
// when `out` points at a pass's column block): this lane's rows r + 16 m
// and r + 16 m + 8; rows at or past `limit` are not written
template <typename T, int D, int MS, int OutLd = D>
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
        store2<T>(out + (size_t)row * OutLd + 8 * nt + 2 * t, c[m][nt][2 * h] * mul,
                  c[m][nt][2 * h + 1] * mul);
    }
}

// f32 accumulators and their long sums. An mma does not round its f32
// accumulator to nearest: fed the same accumulator over thousands of k steps
// (K3 at T = 32768 adds 4,096 k8 steps of 3xTF32 into it), its rounding
// errors add up with one sign, and on an H100 dK/dV drifted 2.5e-4 of their
// max from the exact result (about 6e-8 a step) where a plain f32 sum lies
// 1e-5 from it. So the f32 kernels hand their accumulators to the output
// every kFlushRows streamed rows (`add_rows`): the output, f32 like the
// inputs, holds the running sum, each partial is added to it by an FFMA
// (round to nearest), and the drift stays that of 512 rows (8e-6 of max at
// T = 32768). The 16-bit paths keep one accumulator: their operands'
// rounding lies far above that drift.
constexpr int kFlushRows = 512;

// a warp's MS slabs of 16 x D f32 accumulators into D columns of the f32
// output (rows OutLd elements apart, as store_rows): out = out * keep +
// c * mul per row (out = c * mul when `!add`, so the output is never read
// before it is written), then c = 0. Row r + 16 m + 8 h takes keep[m][h]
// and mul[m][h]; rows at or past `limit` are not written.
template <int D, int MS, int OutLd = D>
__device__ __forceinline__ void add_rows(float* out, float (&c)[MS][D / 8][4], int r,
                                         int limit, bool add, const float (&keep)[MS][2],
                                         const float (&mul)[MS][2], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 16 * m + 8 * h;
      if (row < limit) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          float2* p = reinterpret_cast<float2*>(out + (size_t)row * OutLd + 8 * nt + 2 * t);
          float2 v = make_float2(c[m][nt][2 * h] * mul[m][h], c[m][nt][2 * h + 1] * mul[m][h]);
          if (add) {
            const float2 o = *p;
            v.x = fmaf(o.x, keep[m][h], v.x);
            v.y = fmaf(o.y, keep[m][h], v.y);
          }
          *p = v;
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) c[m][nt][2 * h] = c[m][nt][2 * h + 1] = 0.f;
    }
}

template <int MS> __device__ __forceinline__ void fill(float (&a)[MS][2], float x) {
#pragma unroll
  for (int m = 0; m < MS; ++m) a[m][0] = a[m][1] = x;
}

}  // namespace
