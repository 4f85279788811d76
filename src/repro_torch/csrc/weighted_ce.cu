// Ignorance-weighted softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/weighted_ce.py::
// weighted_ce_fwd (its body `_fwd_kernel`) and ::weighted_ce_bwd (its body
// `_bwd_kernel`), with the semantics of src/repro/kernels/ref.py:8 and :21:
//
//   forward:  lse[t]  = log(sum_v exp(x[t, v]))        (online, float32)
//             loss[t] = w[t] * (lse[t] - x[t, label[t]])
//   backward: dx[t, v] = (w[t] * g[t]) * (exp(x[t, v] - lse[t]) - [v == label[t]])
//
// Shard mode (the vocab-parallel loss, src/repro_torch/sharding/tp.py): x is
// one rank's columns [v0, v0 + V) of the whole vocab, labels are global.
// `weighted_ce_shard_fwd` writes the shard's lse and gold (0 where the
// label lies outside the shard) for the ranks' combine; the backward takes
// the combined lse and v0 and writes softmax - onehot on the shard's
// columns.  A label outside the shard is never read.
//
// x is [T, V] float32 or bfloat16 (upcast in registers), any T and any V,
// with a row stride and a unit stride on V; labels int32, weights, lse, g
// and the outputs loss / lse float32; dx is written in x's dtype with its
// own row stride.  A label outside [0, V) contributes a gold logit of 0 and
// no one-hot term, as the Pallas kernel's column compare does.
//
// Bound: both functions are streaming passes over the [T, V] logits.  The
// forward reads them once (622 MB at qwen3-0.6b's training step, 2048 rows
// of 151936 bf16: 0.186 ms at the H100's 3.35 TB/s); the backward reads
// them and writes dx (1.245 GB, 0.372 ms).  One expf per element runs on
// the SFUs far below that, so the bytes bound both.
//
// Design.  One block of 256 threads per row, grid (T).  A thread walks its
// share of the row in 16-byte vectors (4 float32 or 8 bf16; four vectors in
// flight per iteration), after a scalar head that brings the row pointer to
// a 16-byte boundary and before a scalar tail, so any V and any row stride
// work.  Forward: each thread keeps a running max m and a sum l rescaled
// whenever m grows (one expf per element, `expf`, not `__expf`); the
// (m, l) pairs are combined by a shuffle tree within each warp and then by
// thread 0 over the warps in order.  No atomics and a fixed order: two runs
// give the same bits.  Thread 0 reads the gold logit with one indexed load.
// Backward: an elementwise pass; w * g is formed once per row in float32.
// This first version is simple; making it fast (several rows a block at
// small V, TMA streams) is later work.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte vector.
template <typename T> struct VecWidth {
  static constexpr int N = 16 / sizeof(T);
};

// Elements before the first 16-byte boundary at or after p (at most V).
template <typename T>
__device__ __forceinline__ int64_t head_of(const T* p, int64_t V) {
  const int64_t head =
      static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
      static_cast<int64_t>(sizeof(T));
  return head < V ? head : V;
}

// Online log-sum-exp state: running max m and sum l of exp(x - m).
struct MaxSum {
  float m;
  float l;
};

__device__ __forceinline__ void push(MaxSum& s, float x) {
  if (x > s.m) {
    s.l = s.l * expf(s.m - x) + 1.0f;  // expf(-inf) = 0 for the first value
    s.m = x;
  } else {
    s.l += expf(x - s.m);
  }
}

// Symmetric combine (the same bits whichever side is a): an empty side
// (m = -inf, l = 0) contributes nothing.
__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  const float la = a.m == -INFINITY ? 0.0f : a.l * expf(a.m - m);
  const float lb = b.m == -INFINITY ? 0.0f : b.l * expf(b.m - m);
  return {m, la + lb};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wce_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
               const float* __restrict__ weights, float* __restrict__ loss,
               float* __restrict__ lse, int64_t V, int64_t row_stride,
               int64_t v0, bool shard) {
  constexpr int N = VecWidth<T>::N;
  const int64_t row = blockIdx.x;
  const T* p = x + row * row_stride;
  const int tid = threadIdx.x;
  MaxSum s{-INFINITY, 0.0f};

  const int64_t head = head_of(p, V);
  if (tid < head) push(s, to_f(p[tid]));
  const T* body = p + head;
  const int64_t nvec = (V - head) / N;
  const uint4* vp = reinterpret_cast<const uint4*>(body);
  int64_t i = tid;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = vp[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int j = 0; j < N; ++j) push(s, to_f(e[j]));
    }
  }
  for (; i < nvec; i += kThreads) {
    const uint4 raw = vp[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) push(s, to_f(e[j]));
  }
  for (int64_t k = head + nvec * N + tid; k < V; k += kThreads)
    push(s, to_f(p[k]));

  // shuffle tree within the warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o{__shfl_down_sync(0xffffffffu, s.m, off),
             __shfl_down_sync(0xffffffffu, s.l, off)};
    s = combine(s, o);
  }
  __shared__ MaxSum warp_sums[kWarps];
  if ((tid & 31) == 0) warp_sums[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    MaxSum total = warp_sums[0];
    for (int w = 1; w < kWarps; ++w) total = combine(total, warp_sums[w]);
    const float out_lse = total.m + logf(total.l);
    const int64_t label = labels[row] - v0;
    const float gold = (label >= 0 && label < V) ? to_f(p[label]) : 0.0f;
    lse[row] = out_lse;
    // shard mode: `loss` receives the shard's gold logit
    loss[row] = shard ? gold : weights[row] * (out_lse - gold);
  }
}

template <typename T>
__device__ __forceinline__ T grad_of(float x, int64_t col, int64_t label,
                                     float wg, float row_lse) {
  const float onehot = col == label ? 1.0f : 0.0f;
  return from_f<T>(wg * (expf(x - row_lse) - onehot));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wce_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
               const float* __restrict__ weights,
               const float* __restrict__ lse, const float* __restrict__ g,
               T* __restrict__ dx, int64_t V, int64_t row_stride,
               int64_t out_stride, int64_t v0) {
  constexpr int N = VecWidth<T>::N;
  const int64_t row = blockIdx.x;
  const T* p = x + row * row_stride;
  T* q = dx + row * out_stride;
  const int tid = threadIdx.x;
  const int64_t label = labels[row] - v0;  // column of the label, if here
  const float wg = weights[row] * g[row];
  const float row_lse = lse[row];

  // vectors only where input and output rows share their 16-byte phase
  const bool vec = ((reinterpret_cast<uintptr_t>(p) ^
                     reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  const int64_t head = vec ? head_of(p, V) : V;
  for (int64_t k = tid; k < head; k += kThreads)
    q[k] = grad_of<T>(to_f(p[k]), k, label, wg, row_lse);
  if (!vec) return;
  const int64_t nvec = (V - head) / N;
  const uint4* vp = reinterpret_cast<const uint4*>(p + head);
  uint4* vq = reinterpret_cast<uint4*>(q + head);
  int64_t i = tid;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = vp[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
      const int64_t col0 = head + (i + u * kThreads) * N;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o[j] = grad_of<T>(to_f(e[j]), col0 + j, label, wg, row_lse);
      vq[i + u * kThreads] = out;
    }
  }
  for (; i < nvec; i += kThreads) {
    const uint4 raw = vp[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
    const int64_t col0 = head + i * N;
#pragma unroll
    for (int j = 0; j < N; ++j)
      o[j] = grad_of<T>(to_f(e[j]), col0 + j, label, wg, row_lse);
    vq[i] = out;
  }
  for (int64_t k = head + nvec * N + tid; k < V; k += kThreads)
    q[k] = grad_of<T>(to_f(p[k]), k, label, wg, row_lse);
}

bool bad_shape(int64_t T, int64_t V) {
  return T <= 0 || V <= 0 || T > 2147483647LL;
}

int fwd(const void* x, int dtype, const int32_t* labels, const float* weights,
        float* out, float* lse, int64_t T, int64_t V, int64_t row_stride,
        int64_t v0, bool shard, cudaStream_t stream) {
  if (bad_shape(T, V) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(T));
  if (dtype == 0)
    wce_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), labels, weights, out, lse, V,
        row_stride, v0, shard);
  else
    wce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), labels, weights, out, lse, V,
        row_stride, v0, shard);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// loss[T], lse[T] of x[T, V] (dtype 0: float32, 1: bfloat16; row stride in
// elements).
int weighted_ce_fwd(const void* x, int dtype, const int32_t* labels,
                    const float* weights, float* loss, float* lse, int64_t T,
                    int64_t V, int64_t row_stride, cudaStream_t stream) {
  return fwd(x, dtype, labels, weights, loss, lse, T, V, row_stride, 0, false,
             stream);
}

// Shard mode: lse[T] and gold[T] of the columns [v0, v0 + V) of a vocab.
int weighted_ce_shard_fwd(const void* x, int dtype, const int32_t* labels,
                          float* gold, float* lse, int64_t T, int64_t V,
                          int64_t row_stride, int64_t v0,
                          cudaStream_t stream) {
  return fwd(x, dtype, labels, nullptr, gold, lse, T, V, row_stride, v0, true,
             stream);
}

// dx[T, V] (x's dtype, row stride out_stride) from x, labels, weights, the
// forward's lse and the upstream gradient g[T]; x holds the columns
// [v0, v0 + V) of the vocab (v0 = 0: the whole vocab).
int weighted_ce_bwd(const void* x, int dtype, const int32_t* labels,
                    const float* weights, const float* lse, const float* g,
                    void* dx, int64_t T, int64_t V, int64_t row_stride,
                    int64_t out_stride, int64_t v0, cudaStream_t stream) {
  if (bad_shape(T, V) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(T));
  if (dtype == 0)
    wce_bwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), labels, weights, lse, g,
        static_cast<float*>(dx), V, row_stride, out_stride, v0);
  else
    wce_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), labels, weights, lse, g,
        static_cast<__nv_bfloat16*>(dx), V, row_stride, out_stride, v0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
