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
// At the whole vocab (a 304 KB row) this streaming forward reaches 1.19x
// its bound.
//
// The shard forward's staged kernel, `wce_shard_fwd_staged`.  A vocab
// shard's row is narrow (qwen3-0.6b's vocab in 16 shards: 9496 bf16, 19 KB)
// and there the streaming kernel paid fixed costs per row that the bytes
// do not cover: 2048 one-row blocks, each about four dependent device-
// memory latencies (its loads, a second serial round for the 163 vectors
// past 1024, labels[row] and then x[label]), two waves of blocks, and a
// branch and an accurate expf per element.  For rows that fit a stage
// (`kernels/weighted_ce.py::shard_fwd_plan`: V * size a multiple of 16 and
// at most 48 KB, a 16-byte aligned base and row stride) the staged kernel
// runs instead:
//   - a persistent grid of 2 blocks an SM walks the rows (block i: rows i,
//     i + grid, ...), each block with a ring of 2-4 stages of a whole row in
//     shared memory (as many as put ~64 KB in flight on an SM: 2 for the
//     19 KB row, the ~40 KB that 3.35 TB/s at ~1 us of latency asks of an
//     SM and more; a deeper ring delays every block's first row);
//   - thread 0 issues each row as one TMA bulk copy (`cp.async.bulk`)
//     completing on the stage's mbarrier, so a row costs one latency, and
//     the next row's copy is in flight while this one is reduced;
//   - the block's 256 threads reduce the staged row in two passes, a max
//     and then sum 2^((x - max) log2 e), so no element branches or
//     rescales; each is a per-thread loop over 16-byte vectors (thread t
//     the vectors t, t + 256, ...) unpacked in registers, a butterfly
//     within each warp and the 8 warps in order: a fixed order, no
//     atomics;
//   - the block loads its rows' labels when it starts (256 at a time) and
//     reads the gold logit from the staged row in shared memory, so no
//     device-memory read depends on another.
//   One block a row, the whole row in one stage: a row of 1187 vectors
//   gives 256 threads 4-5 vectors each a pass, and the block's two
//   barriers a row are shared by 8 warps; a warp a row would need a stage
//   a warp, 8 times the shared memory for the same rows in flight.
//   What bounds it: the SFU's 16 exponentials a clock an SM (~5 us for
//   the 19 M elements of a 2048-row shard; `ex2.approx`, one instruction,
//   where `exp2f`'s denormal handling took the kernel to the streaming
//   kernel's time) under the bytes' 11.6 us, and a launch's ramp and tail
//   (~8 us: on an H100 the kernel's time against rows and width has that
//   intercept beside a slope of ~3.2 TB/s, tools/tp_shard_times.py).
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

// Shared-memory address, mbarrier and bulk copy helpers of the staged
// kernel (as in flash_attention.cu).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the barrier's phase of the given parity has completed; a
// phase that never completes traps after about ten seconds instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

constexpr int kMaxStages = 4;
constexpr int kStagedRing = 96 * 1024;  // a block's stages at most
constexpr float kLog2e = 1.4426950408889634f;

// A 16-byte vector's values as float32 in registers: 4 float32, or 8 bf16
// (each the high half of a float32).
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack(const uint4& x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 2^x by the SFU (`ex2.approx.ftz`, 2 ulp; x <= 0 here, and a result under
// 2^-126 is 0 beside the row's largest term, 1).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The shard forward for rows staged whole: block i takes rows i, i + grid,
// ...; `stages` slots of `stage_bytes` (a multiple of 128, at least the
// row's V * sizeof(T) bytes, a multiple of 16) in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wce_shard_fwd_staged(const T* __restrict__ x,
                     const int32_t* __restrict__ labels,
                     float* __restrict__ gold, float* __restrict__ lse,
                     int rows_total, int64_t V, int64_t row_stride,
                     int64_t v0, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float red_max[kWarps], red_sum[kWarps];
  __shared__ int32_t s_lab[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grid = gridDim.x;
  const int rows = (rows_total - 1 - static_cast<int>(blockIdx.x)) / grid + 1;
  const uint32_t bytes = static_cast<uint32_t>(V * sizeof(T));
  const int nvec = static_cast<int>(bytes / 16);
  auto row_of = [&](int j) {
    return static_cast<int64_t>(blockIdx.x) + static_cast<int64_t>(j) * grid;
  };
  auto issue = [&](int j) {  // thread 0: row j of this block into its slot
    const int s = j % stages;
    mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + s * stage_bytes, x + row_of(j) * row_stride, bytes,
              &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < stages && j < rows; ++j) issue(j);

  for (int j = 0; j < rows; ++j) {
    if (j % kThreads == 0) {  // the next 256 rows' labels
      __syncthreads();        // thread 0 has read the last ones
      s_lab[tid] = j + tid < rows ? labels[row_of(j + tid)] : 0;
      __syncthreads();
    }
    const int s = j % stages;
    mbar_wait(&full[s], (j / stages) & 1);
    const uint4* row = reinterpret_cast<const uint4*>(ring + s * stage_bytes);

    constexpr int N = VecWidth<T>::N;
    float mx = -INFINITY;
#pragma unroll 4
    for (int i = tid; i < nvec; i += kThreads) {
      float f[N];
      unpack(row[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) mx = fmaxf(mx, f[e]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    float big = red_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) big = fmaxf(big, red_max[w]);

    float sum = 0.0f;
#pragma unroll 4
    for (int i = tid; i < nvec; i += kThreads) {
      float f[N];
      unpack(row[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) sum += exp2_sfu((f[e] - big) * kLog2e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();  // every thread is done with slot s
    if (tid == 0) {
      const int64_t col = s_lab[j % kThreads] - v0;
      const T* vals = reinterpret_cast<const T*>(row);
      const float g = (col >= 0 && col < V) ? to_f(vals[col]) : 0.0f;
      if (j + stages < rows) issue(j + stages);  // after the gold's read
      float total = red_sum[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) total += red_sum[w];
      gold[row_of(j)] = g;
      lse[row_of(j)] = big + logf(total);
    }
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

template <typename T>
int launch_staged(const void* x, const int32_t* labels, float* gold,
                  float* lse, int64_t T_rows, int64_t V, int64_t row_stride,
                  int64_t v0, int grid, int stages, int stage_bytes,
                  cudaStream_t stream) {
  // on each launch: the attribute belongs to the current card's context
  const cudaError_t attr = cudaFuncSetAttribute(
      wce_shard_fwd_staged<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStagedRing);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wce_shard_fwd_staged<T><<<grid, kThreads, stages * stage_bytes, stream>>>(
      static_cast<const T*>(x), labels, gold, lse, static_cast<int>(T_rows),
      V, row_stride, v0, stages, stage_bytes);
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

// The shard forward's staged kernel: lse[T] and gold[T] as
// weighted_ce_shard_fwd, on the plan of kernels/weighted_ce.py's
// shard_fwd_plan: `grid` persistent blocks (at most T), `stages` (2-4)
// slots of `stage_bytes` (a multiple of 128, at least V * size, at most
// 96 KB in all).  x's base, V * size and (unless T = 1) its row stride in
// bytes are multiples of 16.
int weighted_ce_shard_fwd_staged(const void* x, int dtype,
                                 const int32_t* labels, float* gold,
                                 float* lse, int64_t T, int64_t V,
                                 int64_t row_stride, int64_t v0, int grid,
                                 int stages, int stage_bytes,
                                 cudaStream_t stream) {
  const int64_t size = dtype == 0 ? 4 : 2;
  if (bad_shape(T, V) || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || V * size % 16 != 0 ||
      (T > 1 && row_stride * size % 16 != 0) || grid < 1 || grid > T ||
      stages < 2 || stages > kMaxStages || stage_bytes % 128 != 0 ||
      stage_bytes < V * size ||
      static_cast<int64_t>(stages) * stage_bytes > kStagedRing)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0
             ? launch_staged<float>(x, labels, gold, lse, T, V, row_stride,
                                    v0, grid, stages, stage_bytes, stream)
             : launch_staged<__nv_bfloat16>(x, labels, gold, lse, T, V,
                                            row_stride, v0, grid, stages,
                                            stage_bytes, stream);
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
