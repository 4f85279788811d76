// Flash-decode: one query row per (batch, head) against a KV cache, with an
// optional sliding window and an optional int8 cache dequantized in
// registers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py::flash_decode (its body `_kernel`),
// with the semantics of src/repro/kernels/ref.py:132:
//
//   q [B, H, D]; k/v [B, KV, S, D] (float32 / bfloat16 like q, or int8 with
//   float32 scales [B, KV, S]: k = float(k_int8) * k_scale, the same for v);
//   KV head = h / (H / KV); position t is valid when t <= pos and, with a
//   window W, t > pos - W; score = (q . k) / sqrt(D);
//   out = softmax over the valid positions of score, times v, in float32,
//   written in q's dtype.
//
// Bound: the function reads the valid rows of the cache once (and the
// scales), q, and writes out: at the model's decode step (B 4, KV 8,
// S 576, D 128, bf16) 9.4 MB for a full cache, 2.8 us at 3.35 TB/s; its
// 4 * D operations per (head, position) are two orders of magnitude below
// the tensor-core rate.  So it is bound by bytes, and this version is bound
// by latency: 64 blocks (one per (b, h)) cannot keep enough loads in
// flight to reach the card's rate.  Splitting the positions over more
// blocks (a second reduction pass) and reading each KV head once for its
// H / KV query heads are the later, fast version.
//
// Design.  One block of 8 warps per (b, h), grid B * H.  Each warp walks
// chunks of 4 consecutive positions (chunk c goes to warp c % 8) inside the
// valid range [max(0, pos - W + 1), min(pos, S - 1)]: the positions the
// Pallas kernel's live tiles keep unmasked.  Positions outside it would
// only add exp(-1e30 - m) = 0 there, so they are not read at all.  Lane l
// holds dimensions l + 32 c of q, of the rows it loads, and of its
// accumulator; a chunk's four dot products are butterfly-reduced across the
// warp together, then the warp's running max, sum and accumulator take the
// chunk with the online-softmax recurrence.  int8 rows are converted and
// scaled in registers (never an f32 copy of the cache).  At the end the 8
// warps' partial (max, sum, accumulator) are merged through shared memory
// and the denominator is clamped at 1e-30, as in the reference.  Any S,
// any strides with a unit stride on D (the model passes its [B, S, KV, D]
// cache and [B, S, KV] scales as permuted views, so the decode loop never
// transposes the cache), D <= 256, pos a host integer.
//
// Plain C interface for ctypes: the function returns the cudaError_t of its
// launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 4;  // positions a warp takes at once
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // null unless the cache is int8
  const float* vs;
  void* o;
  int B, H, KV, S, D, pos, window;  // window <= 0: none
  float scale;
  int64_t sq[2], sk[3], sv[3], sks[3], svs[3], so[2];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// T: q and out; C: the cache (T, or int8_t with scales); DPL: dimensions
// per lane (D <= 32 * DPL).
template <typename T, typename C, int DPL>
__global__ void __launch_bounds__(kWarps * 32) flash_decode_kernel(
    DecodeArgs a) {
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];
  constexpr bool kQuant = sizeof(C) == 1;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D;

  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const C* k = static_cast<const C*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const C* v = static_cast<const C*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  const float* ks = kQuant ? a.ks + b * a.sks[0] + kvh * a.sks[1] : nullptr;
  const float* vs = kQuant ? a.vs + b * a.svs[0] + kvh * a.svs[1] : nullptr;

  float qf[DPL], acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    qf[c] = d < D ? to_f(q[d]) : 0.0f;
    acc[c] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  const int lo = a.window > 0 ? max(0, a.pos - a.window + 1) : 0;
  const int hi = min(a.pos, a.S - 1);  // valid positions [lo, hi]
  for (int t0 = lo + warp * kChunk; t0 <= hi; t0 += kWarps * kChunk) {
    float s[kChunk];
    float kf[kChunk][DPL];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      const bool ok = t <= hi;
      const float sc = kQuant && ok ? ks[t * a.sks[2]] : 1.0f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        kf[u][c] = ok && d < D ? to_f(k[t * a.sk[2] + d]) : 0.0f;
        if (kQuant) kf[u][c] *= sc;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) dot = fmaf(qf[c], kf[u][c], dot);
      s[u] = dot;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mx = m;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      s[u] = t0 + u <= hi ? s[u] * a.scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= corr;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t > hi) break;
      const float p = expf(s[u] - mx);
      l += p;
      const float sc = kQuant ? vs[t * a.svs[2]] : 1.0f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        float vv = d < D ? to_f(v[t * a.sv[2] + d]) : 0.0f;
        if (kQuant) vv *= sc;
        acc[c] = fmaf(p, vv, acc[c]);
      }
    }
    m = mx;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < kMaxD) s_acc[warp][d] = acc[c];
  }
  __syncthreads();
  if (warp != 0) return;
  float big = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_m[w]);
  float den = 0.0f, f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(s_m[w] - big);
    den += s_l[w] * f[w];
  }
  const float inv_den = 1.0f / fmaxf(den, 1e-30f);
  T* o = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d >= D) continue;
    float num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num = fmaf(s_acc[w][d], f[w], num);
    o[d] = from_f<T>(num * inv_den);
  }
}

template <typename T, typename C>
int dispatch_d(const DecodeArgs& a, cudaStream_t stream) {
  const int grid = a.B * a.H, block = kWarps * 32;
  if (a.D <= 64)
    flash_decode_kernel<T, C, 2><<<grid, block, 0, stream>>>(a);
  else if (a.D <= 128)
    flash_decode_kernel<T, C, 4><<<grid, block, 0, stream>>>(a);
  else
    flash_decode_kernel<T, C, 8><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q and out; the cache too unless quant).
// quant: the cache is int8 and ks / vs hold its float32 scales.
// strides: 16 element strides: q (b, h), k (b, kv, s), v (b, kv, s),
// ks (b, kv, s), vs (b, kv, s), out (b, h); the last axis (D) is contiguous
// in q, k, v and out.  window <= 0 means no window.
int flash_decode(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, void* o, int dtype, int quant, int B, int H,
                 int KV, int S, int D, int pos, int window, float scale,
                 const int64_t* strides, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || D <= 0 ||
      D > kMaxD || pos < 0 || (dtype != 0 && dtype != 1) ||
      (quant && (ks == nullptr || vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, k, v, ks, vs, o, B, H, KV, S, D, pos, window, scale,
               {}, {}, {}, {}, {}, {}};
  for (int i = 0; i < 2; ++i) {
    a.sq[i] = strides[i];
    a.so[i] = strides[14 + i];
  }
  for (int i = 0; i < 3; ++i) {
    a.sk[i] = strides[2 + i];
    a.sv[i] = strides[5 + i];
    a.sks[i] = strides[8 + i];
    a.svs[i] = strides[11 + i];
  }
  if (quant)
    return dtype == 0 ? dispatch_d<float, int8_t>(a, stream)
                      : dispatch_d<__nv_bfloat16, int8_t>(a, stream);
  return dtype == 0 ? dispatch_d<float, float>(a, stream)
                    : dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, stream);
}

}  // extern "C"
