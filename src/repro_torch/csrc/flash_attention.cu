// Blocked online-softmax (flash) attention, causal and sliding-window, with
// grouped-query heads, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (its body
// `_attn_kernel`), with the semantics of src/repro/kernels/ref.py:32:
//
//   q [B, H, S, D], k/v [B, KV, T, D], H % KV == 0, KV head = h / (H / KV);
//   queries right-aligned to the keys (query i sits at position i + T - S);
//   score = (q . k) / sqrt(D), masked to NEG_INF = -1e30 outside
//   (col <= row) and, with a window W, (col > row - W);
//   out = softmax(score) v, accumulated online in float32, written in the
//   input dtype.
//
// Bound: the function reads q, k, v and writes out once (25.2 MB at the
// model's prefill: B 4, H 16, KV 8, S = T = 512, D 128, bf16), and does
// 4 * D operations per unmasked (query, key) pair (4.3 GFLOP there, the
// causal half).  On this card the bytes bound it, 7.5 us at 3.35 TB/s,
// with 4.4 us of tensor-core time at 989 TFLOP/s close behind.  This first
// version runs its products on the CUDA cores in float32 (64 us at their
// 67 TFLOP/s) out of shared memory, so it sits well above that bound;
// wgmma on bf16 tiles fed by TMA is the later, fast version.
//
// Design.  One block of 256 threads per (b, h, 64-query tile), grid
// (B * H, ceil(S / 64)).  The block stages its Q tile once and walks the
// live KV tiles of 64 keys through shared memory (all in float32, rows
// padded to an odd length so that the column reads below hit 32 distinct
// banks).  Only tiles that hold a key inside the causal / window band of
// some query of the tile are visited: the same tiles the Pallas kernel's
// `pl.when(live)` computes.  Thread (rg, cg) = (tid / 16, tid % 16) holds
// the scores of rows rg + 16 i and columns cg + 16 j (i, j < 4), the
// running max and sum of its four rows, and the output accumulator of its
// four rows at columns cg + 16 c.  Row reductions are shuffles within the
// 16 lanes that share a row; P goes through shared memory to the PV
// product.  As in the reference, masked scores are -1e30, not -inf: a row
// whose keys in a live tile are all masked takes p = exp(0) = 1 there, and
// the rescale by exp(-1e30 - m) = 0 at its first real key wipes that out
// (with -inf the row would become NaN).  The denominator is clamped at
// 1e-30.  Any S <= T and any T (the ragged last tiles are masked), any
// strides with a unit stride on D (the model passes its [B, S, H, D]
// activations as permuted views), D <= 256.
//
// Plain C interface for ctypes: the function returns the cudaError_t of its
// launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, S, T, D, causal, window;  // window <= 0: none
  float scale;
  int64_t sq[3], sk[3], sv[3], so[3];      // strides of (b, h, row)
};

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

// rows [0, kRows) of a [rows, D] slab at `src` (row stride `rs`) into `dst`
// (row stride ld) as float; rows at or past `valid` are zero.
template <typename T, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t rs,
                                      int valid, int D, int ld) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    dst[r * ld + d] = r < valid ? to_f(src[r * rs + d]) : 0.0f;
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(AttnArgs a) {
  extern __shared__ float sm[];
  const int D = a.D, ld = D | 1;
  float* sQ = sm;
  float* sK = sQ + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * ld;  // [kBQ][kBK + 1]
  constexpr int kPld = kBK + 1;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.y * kBQ;
  const int nrows = min(kBQ, a.S - q0);
  const int offset = a.T - a.S;
  const int q_lo = q0 + offset, q_hi = q0 + nrows - 1 + offset;
  int k_begin = 0, k_end = a.T;  // keys [k_begin, k_end) can be live
  if (a.causal) k_end = min(a.T, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);

  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  T* o = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  stage<T, kBQ>(sQ, q + q0 * a.sq[2], a.sq[2], nrows, D, ld);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = k_begin / kBK; kt * kBK < k_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, kBK>(sK, k + k0 * a.sk[2], a.sk[2], a.T - k0, D, ld);
    stage<T, kBK>(sV, v + k0 * a.sv[2], a.sv[2], a.T - k0, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + rg + 16 * i;  // absolute query position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        bool ok = col < a.T;
        if (a.causal) ok = ok && col <= row;
        if (a.window > 0) ok = ok && col > row - a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(rg + 16 * i) * kPld + cg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(rg + 16 * i) * kPld + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = cg + 16 * cc;
        const float vv = d < D ? sV[c * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r >= nrows) continue;
    const float inv_den = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = o + (q0 + r) * a.so[2];
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = cg + 16 * cc;
      if (d < D) orow[d] = from_f<T>(acc[i][cc] * inv_den);
    }
  }
}

template <typename T, int DC>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const int ld = a.D | 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * ld +
                       kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, DC><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const AttnArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 4>(a, stream);
  if (a.D <= 128) return launch<T, 8>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).  strides: 12
// element strides, (b, h, row) of q, k, v and out in that order; the last
// axis (D) is contiguous in all four.  window <= 0 means no window.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int H, int KV, int S, int T, int D,
                    int causal, int window, float scale,
                    const int64_t* strides, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T < S ||
      D <= 0 || D > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, o, B, H, KV, S, T, D, causal, window, scale, {}, {},
             {}, {}};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return dtype == 0 ? dispatch_d<float>(a, stream)
                    : dispatch_d<__nv_bfloat16>(a, stream);
}

}  // extern "C"
