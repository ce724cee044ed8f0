// Fused multi-tensor SGD and Adam updates for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/fused_optimizer.py:
//   - `_sgd_kernel` (line 66, launched by `fused_sgd_apply` at line 90):
//       g = grad + wd*w;  m = momentum*m + g;  w = w - lr*m;
//   - `_adam_kernel` (line 116, launched by `fused_adam_apply` at line 153):
//       g = grad + wd*w;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g;
//       w = w - lr*(m/c1) / (sqrt(v/c2) + eps),  c1 = 1-b1^t, c2 = 1-b2^t.
// and carries the rules of the registered update ops that the reference's
// fused training step applies (mxnet_tpu/parallel/data_parallel.py
// `functional_optimizer` -> `_k_sgd`, `_k_sgd_mom`, `_k_adam`;
// mxnet_tpu/ops/optimizer_ops.py), so that step's update is one launch:
//   - sgd_mom_update: g = clip(rescale*grad) + wd*w;  m = momentum*m - lr*g;
//       w = w + m   (equal to the first rule only while lr is constant);
//   - sgd_update: w = w - lr*(clip(rescale*grad) + wd*w), no state;
//   - adam_update: g = clip(rescale*grad + wd*w), then the Adam rule above
//       with c1 = c2 = 1 and the bias correction folded into lr by the caller.
// clip(x) clamps to [-clip, clip] when clip >= 0 and is off when clip < 0,
// as in the reference (optimizer_ops.py `_clip`). The first two rules take
// rescale = 1 and clip = -1, which leaves their arithmetic as it was.
// The math is f32 inside; each buffer is loaded and stored in its own dtype
// (weights and grads in one, the states m and v in one).
//
// Design. The TPU wrapper concatenates every tensor into one (rows, 128)
// buffer and walks it with a 1-D grid (:46-63), a copy of every operand on
// each call. Here nothing is copied: the wrapper passes a table in device
// memory with one row per tensor (its operand and output pointers, its
// length and the index of its first chunk), and a 1-D grid walks chunks of
// kChunk elements over all the tensors, one launch per call. A block finds
// its tensor by a binary search over the rows' first-chunk indices. Within a
// chunk each thread takes 4 elements at a time with one vector load per
// operand (16 bytes in f32, 8 in bf16/f16) when every pointer of the tensor
// is aligned for it, element by element otherwise, and for the tail.
// lr, momentum, wd, b1, b2, eps, c1, c2, rescale and clip (`struct Hyper`)
// reach the kernel in one of two ways. The by-value entry points
// (mxt_fused_sgd, mxt_fused_adam) pass them as kernel arguments: a CUDA graph
// that captured such a launch would replay the values of the step it was
// captured at. The device entry points (mxt_fused_sgd_hyper,
// mxt_fused_adam_hyper) pass a pointer to the 10 floats in device memory,
// which the caller rewrites before each launch or graph replay: each block
// reads them once into shared memory, so a captured step takes this step's lr
// and bias correction. The per-element arithmetic is the same in both. An
// output may alias its input (in-place update): each element is read and
// then written by the same thread.
//
// The gate. The device forms also take `skip`, a pointer to one float in
// device memory (or null): a block that reads it nonzero returns before it
// loads or stores anything, so every weight and state keeps its value. The
// float16 step writes its overflow flag there on the card (the reference
// gates its update by `jnp.where(finite, new, old)`,
// mxnet_tpu/parallel/data_parallel.py:860-864): the flag never goes to the
// host, and a captured step replays the gate with the flag of each replay.
//
// Bound at BERT-base (133,349,946 f32 parameters in 157 tensors): the update
// is elementwise, about 10 (SGD) or 20 (Adam) f32 operations per parameter,
// so it is bound by bytes. Adam reads w, g, m, v and writes w, m, v: 28 B a
// parameter, 3.73 GB, 1.11 ms at 3.35 TB/s; SGD with momentum reads w, g, m
// and writes w, m: 20 B, 2.67 GB, 0.80 ms; plain SGD reads w, g and writes
// w: 12 B. Wide coalesced loads and one pass over each operand are what
// that bound asks for.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // elements per block
constexpr int kFields = 9;           // w g m v out_w out_m out_v numel first_chunk

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

template <typename T> struct alignas(4 * sizeof(T)) Pack4 { T x[4]; };

template <typename T> __device__ __forceinline__ void load4(const void* base, long long i,
                                                            float out[4]) {
  const Pack4<T> p = *reinterpret_cast<const Pack4<T>*>(static_cast<const T*>(base) + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = to_f32<T>(p.x[j]);
}

template <typename T> __device__ __forceinline__ void store4(void* base, long long i,
                                                             const float in[4]) {
  Pack4<T> p;
#pragma unroll
  for (int j = 0; j < 4; ++j) p.x[j] = from_f32<T>(in[j]);
  *reinterpret_cast<Pack4<T>*>(static_cast<T*>(base) + i) = p;
}

template <typename T> __device__ __forceinline__ float load1(const void* base, long long i) {
  return to_f32<T>(static_cast<const T*>(base)[i]);
}

template <typename T> __device__ __forceinline__ void store1(void* base, long long i, float x) {
  static_cast<T*>(base)[i] = from_f32<T>(x);
}

struct Hyper {
  float lr, momentum, wd, b1, b2, eps, c1, c2, rescale, clip;
};

// The update rules; kSgd keeps no state, kAdam two (m and v), the others one.
enum Rule : int { kSgdPallas = 0, kSgdMom = 1, kSgd = 2, kAdam = 3 };

__device__ __forceinline__ float clip_to(float g, float c) {
  // NaN passes through, as jnp.clip / torch.clamp let it
  return c < 0.f ? g : (g < -c ? -c : (g > c ? c : g));
}

// one element of the update, f32 in and out
template <int kRule>
__device__ __forceinline__ void update(const Hyper& h, float& w, float g, float& m,
                                       float& v) {
  if (kRule == kAdam) {
    g = clip_to(g * h.rescale + h.wd * w, h.clip);
    m = h.b1 * m + (1.f - h.b1) * g;
    v = h.b2 * v + (1.f - h.b2) * g * g;
    w = w - h.lr * (m / h.c1) / (sqrtf(v / h.c2) + h.eps);
  } else if (kRule == kSgdPallas) {
    g = g + h.wd * w;
    m = h.momentum * m + g;
    w = w - h.lr * m;
  } else {
    g = clip_to(g * h.rescale, h.clip) + h.wd * w;
    if (kRule == kSgdMom) {
      m = h.momentum * m - h.lr * g;
      w = w + m;
    } else {
      w = w - h.lr * g;
    }
  }
}

template <typename TW, typename TS, int kRule>
__global__ void __launch_bounds__(kThreads)
multi_tensor_update(const long long* __restrict__ table, int n_tensors, Hyper h,
                    const float* __restrict__ hyper, const float* __restrict__ skip) {
  constexpr bool kHasM = kRule != kSgd, kHasV = kRule == kAdam;
  if (skip != nullptr && __ldg(skip) != 0.f) return;  // the gate: nothing written
  constexpr int kHyper = sizeof(Hyper) / sizeof(float);
  if (hyper != nullptr) {  // the device form: the block reads the 10 floats once
    __shared__ float sh[kHyper];
    if (threadIdx.x < kHyper) sh[threadIdx.x] = hyper[threadIdx.x];
    __syncthreads();
    h = Hyper{sh[0], sh[1], sh[2], sh[3], sh[4], sh[5], sh[6], sh[7], sh[8], sh[9]};
  }
  const long long b = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;  // the last row whose first chunk <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kFields + 8] <= b) lo = mid; else hi = mid - 1;
  }
  const long long* row = table + lo * kFields;
  const void* w_in = reinterpret_cast<const void*>(row[0]);
  const void* g_in = reinterpret_cast<const void*>(row[1]);
  const void* m_in = reinterpret_cast<const void*>(row[2]);
  const void* v_in = reinterpret_cast<const void*>(row[3]);
  void* w_out = reinterpret_cast<void*>(row[4]);
  void* m_out = reinterpret_cast<void*>(row[5]);
  void* v_out = reinterpret_cast<void*>(row[6]);
  const long long n = row[7];
  const long long start = (b - row[8]) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;

  constexpr uintptr_t aw = 4 * sizeof(TW) - 1, as = 4 * sizeof(TS) - 1;
  uintptr_t mis_w = (uintptr_t)w_in | (uintptr_t)g_in | (uintptr_t)w_out;
  uintptr_t mis_s = kHasM ? (uintptr_t)m_in | (uintptr_t)m_out : 0;
  if (kHasV) mis_s |= (uintptr_t)v_in | (uintptr_t)v_out;
  const bool vec = ((mis_w & aw) | (mis_s & as)) == 0;

  long long tail = start;
  if (vec) {
    const long long n4 = start + (end - start) / 4 * 4;
    for (long long i = start + 4 * (long long)threadIdx.x; i < n4; i += 4 * kThreads) {
      float w[4], g[4], m[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
      load4<TW>(w_in, i, w);
      load4<TW>(g_in, i, g);
      if (kHasM) load4<TS>(m_in, i, m);
      if (kHasV) load4<TS>(v_in, i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) update<kRule>(h, w[j], g[j], m[j], v[j]);
      store4<TW>(w_out, i, w);
      if (kHasM) store4<TS>(m_out, i, m);
      if (kHasV) store4<TS>(v_out, i, v);
    }
    tail = n4;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float w = load1<TW>(w_in, i), g = load1<TW>(g_in, i);
    float m = kHasM ? load1<TS>(m_in, i) : 0.f, v = kHasV ? load1<TS>(v_in, i) : 0.f;
    update<kRule>(h, w, g, m, v);
    store1<TW>(w_out, i, w);
    if (kHasM) store1<TS>(m_out, i, m);
    if (kHasV) store1<TS>(v_out, i, v);
  }
}

template <typename TW, typename TS, int kRule>
cudaError_t launch(const long long* table, int n_tensors, long long n_chunks,
                   const Hyper& h, const float* hyper, const float* skip,
                   cudaStream_t stream) {
  multi_tensor_update<TW, TS, kRule><<<(unsigned)n_chunks, kThreads, 0, stream>>>(
      table, n_tensors, h, hyper, skip);
  return cudaGetLastError();
}

template <int kRule, typename TW>
cudaError_t by_state(const long long* table, int n_tensors, long long n_chunks, int sdtype,
                     const Hyper& h, const float* hy, const float* sk, cudaStream_t s) {
  if constexpr (kRule == kSgd) {  // no state: sdtype is not read
    return launch<TW, float, kRule>(table, n_tensors, n_chunks, h, hy, sk, s);
  } else {
    switch (sdtype) {
      case 0: return launch<TW, float, kRule>(table, n_tensors, n_chunks, h, hy, sk, s);
      case 1: return launch<TW, __nv_bfloat16, kRule>(table, n_tensors, n_chunks, h, hy, sk, s);
      case 2: return launch<TW, __half, kRule>(table, n_tensors, n_chunks, h, hy, sk, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <int kRule>
cudaError_t dispatch(const long long* table, int n_tensors, long long n_chunks, int wdtype,
                     int sdtype, const Hyper& h, const float* hy, const float* sk,
                     cudaStream_t s) {
  if (n_tensors <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (wdtype) {
    case 0: return by_state<kRule, float>(table, n_tensors, n_chunks, sdtype, h, hy, sk, s);
    case 1: return by_state<kRule, __nv_bfloat16>(table, n_tensors, n_chunks, sdtype, h, hy, sk, s);
    case 2: return by_state<kRule, __half>(table, n_tensors, n_chunks, sdtype, h, hy, sk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table: device array of n_tensors rows of 9 int64 (w, g, m, v, out_w, out_m,
// out_v pointers, numel, first chunk; v and out_v 0 for SGD, m and out_m 0
// for plain SGD), rows in order of first chunk, chunks of 16384 elements.
// wdtype (weights and grads) and sdtype (states): 0 float32, 1 bfloat16,
// 2 float16. rule: 0 the Pallas kernel's momentum rule, 1 sgd_mom_update's,
// 2 sgd_update's (no state). Returns a cudaError_t.
namespace {
cudaError_t sgd_rule(const long long* table, int n_tensors, long long n_chunks, int wdtype,
                     int sdtype, int rule, const Hyper& h, const float* hy, const float* sk,
                     cudaStream_t s) {
  switch (rule) {
    case kSgdPallas:
      return dispatch<kSgdPallas>(table, n_tensors, n_chunks, wdtype, sdtype, h, hy, sk, s);
    case kSgdMom:
      return dispatch<kSgdMom>(table, n_tensors, n_chunks, wdtype, sdtype, h, hy, sk, s);
    case kSgd: return dispatch<kSgd>(table, n_tensors, n_chunks, wdtype, sdtype, h, hy, sk, s);
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace

extern "C" int mxt_fused_sgd(const long long* table, int n_tensors, long long n_chunks,
                             int wdtype, int sdtype, int rule, float lr, float momentum,
                             float wd, float rescale, float clip, void* stream) {
  const Hyper h{lr, momentum, wd, 0.f, 0.f, 0.f, 1.f, 1.f, rescale, clip};
  return sgd_rule(table, n_tensors, n_chunks, wdtype, sdtype, rule, h, nullptr, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// Adam with the corrections c1, c2 applied inside (c1 = c2 = 1: adam_update's
// rule, the correction folded into lr), rescale and clip as above.
extern "C" int mxt_fused_adam(const long long* table, int n_tensors, long long n_chunks,
                              int wdtype, int sdtype, float lr, float beta1, float beta2,
                              float eps, float wd, float c1, float c2, float rescale,
                              float clip, void* stream) {
  const Hyper h{lr, 0.f, wd, beta1, beta2, eps, c1, c2, rescale, clip};
  return dispatch<kAdam>(table, n_tensors, n_chunks, wdtype, sdtype, h, nullptr, nullptr,
                         static_cast<cudaStream_t>(stream));
}

// The device forms: `hyper` points to the 10 floats of `struct Hyper` (lr,
// momentum, wd, b1, b2, eps, c1, c2, rescale, clip) in device memory, read by
// the kernel when it runs, not when it is launched; `skip` (or null) to the
// gate's float: nonzero, the launch writes nothing.
extern "C" int mxt_fused_sgd_hyper(const long long* table, int n_tensors, long long n_chunks,
                                   int wdtype, int sdtype, int rule, const float* hyper,
                                   const float* skip, void* stream) {
  if (hyper == nullptr) return cudaErrorInvalidValue;
  return sgd_rule(table, n_tensors, n_chunks, wdtype, sdtype, rule, Hyper{}, hyper, skip,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int mxt_fused_adam_hyper(const long long* table, int n_tensors, long long n_chunks,
                                    int wdtype, int sdtype, const float* hyper,
                                    const float* skip, void* stream) {
  if (hyper == nullptr) return cudaErrorInvalidValue;
  return dispatch<kAdam>(table, n_tensors, n_chunks, wdtype, sdtype, Hyper{}, hyper, skip,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int mxt_fused_hyper_floats() { return (int)(sizeof(Hyper) / sizeof(float)); }

extern "C" int mxt_fused_chunk_elems() { return (int)kChunk; }

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
