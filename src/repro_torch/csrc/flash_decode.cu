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
// the tensor-core rate.  So bytes bound it, and the design is about keeping
// enough loads in flight on every SM and reading each byte once.
//
// Design: split-KV, `flash_decode_split`, grid (B * KV * head groups,
// n_split), 128 threads, then a merge.
//
// * A block takes GT query heads that share one KV head (all G = H / KV of
//   them unless G > 8), so each K and V row is read once for those heads,
//   and one contiguous chunk of the valid positions [lo, hi] =
//   [max(0, pos - W + 1), min(pos, S - 1)]: positions outside would only add
//   exp(-1e30 - m) = 0, so they are never read.  The split plan (n_split <=
//   64, chunk) comes from the wrapper, which sizes it for a few blocks per
//   SM; no chunk is empty.
// * L lanes take one row, each lane 16 bytes of it (8 bf16 or 4 float32;
//   int8 rows in 8 bytes, 8 values, as a 120-dim int8 row is only 8-byte
//   aligned), so a warp covers 32 / L rows and the block 4 * 32 / L
//   "slots"; each slot takes 4 rows at a time, their K and V loads issued
//   together.  The L partial dot products of a row (q pre-scaled by
//   log2(e) / sqrt(D)) are butterfly-reduced, so every lane holds the same
//   score, and each slot keeps its own running max m, sum l and accumulator
//   for each head (exp2 domain).  int8 rows are converted and scaled in
//   registers (never a float copy of the cache).
// * The slots are merged in slot order through shared memory and the block
//   writes its partial (m, l, acc[D]) per head in float32 to the wrapper's
//   scratch.
//
// A second launch, `flash_decode_merge`, merges each row's n_split
// partials in a fixed order and writes out in q's dtype.
//
// Shard mode (the length-split cache of tensor parallelism,
// src/repro_torch/sharding/tp.py): the cache is one rank's positions
// [s0, s0 + S) and the wrapper gives the valid range [lo, hi] in the
// shard's own indices.  The merge then writes the output in float32 and
// each head's log-sum-exp of the scores over the shard's valid positions
// (natural log, (M + log2(den)) * ln 2), so the ranks' partials merge in
// float32; a shard with no valid position is not launched (the wrapper
// returns o = 0, lse = -inf).
//
// Every sum runs in a fixed order and no atomics are used: two runs give
// the same bits.  Any S, any strides with a unit stride on D
// (the model passes its [B, S, KV, D] cache and [B, S, KV] scales as
// permuted views, so the decode loop never transposes the cache) as long
// as the cache's base and (b, kv, s) strides are aligned to its vector (16
// bytes, 8 for int8) and D is a multiple of the vector's values; D <= 256;
// pos a host integer.
//
// Plain C interface for ctypes: the function returns the cudaError_t of its
// launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAtOnce = 4;  // rows a slot loads together
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // null unless the cache is int8
  const float* vs;
  void* o;
  float* part_acc;  // [B * H, n_split, D]
  float* part_ml;   // [B * H, n_split, 2]: m, l
  float* lse;       // shard mode: [B, H] log-sum-exp (o float32); else null
  int B, H, KV, S, D, lo, hi, chunk, n_split;
  float scale_log2;  // log2(e) / sqrt(D)
  int64_t sq[2], sk[3], sv[3], sks[3], svs[3], so[2];
};

// One load of a cache row: E values in one vector (`type`).
template <typename C> struct Vec;
template <> struct Vec<float> {
  using type = uint4;
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  using type = uint2;
  static constexpr int E = 8;
  __device__ static void unpack(const uint2& x, float* f) {
    const uint32_t w[2] = {x.x, x.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // sign-extend byte j
        f[4 * i + j] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
  }
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

// T: q and out; C: the cache (T, or int8_t with scales); L: lanes a row;
// VPL: vectors a lane takes of a row; GT: query heads a block.
template <typename T, typename C, int L, int VPL, int GT>
__global__ void __launch_bounds__(kThreads) flash_decode_split(DecodeArgs a) {
  using V = Vec<C>;
  using VT = typename V::type;
  constexpr int E = V::E;
  constexpr int DPL = VPL * E;          // dimensions a lane holds
  constexpr int kDP = L * DPL;          // padded D
  constexpr int kSlots = kWarps * (32 / L);
  constexpr bool kQuant = sizeof(C) == 1;
  __shared__ float s_ml[kSlots][GT][2];
  __shared__ float s_acc[kSlots][GT][kDP];

  const int groups = a.H / a.KV / GT;  // head groups of a KV head
  const int bx = blockIdx.x;
  const int b = bx / (a.KV * groups);
  const int kvh = (bx / groups) % a.KV;
  const int h0 = kvh * (a.H / a.KV) + (bx % groups) * GT;
  const int split = blockIdx.y;
  const int c_lo = a.lo + split * a.chunk;
  const int c_hi = min(a.hi, c_lo + a.chunk - 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lig = lane % L;                    // lane in its row group
  const int slot = warp * (32 / L) + lane / L;
  const int D = a.D;

  const C* k = static_cast<const C*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const C* v = static_cast<const C*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  const float* ks = kQuant ? a.ks + b * a.sks[0] + kvh * a.sks[1] : nullptr;
  const float* vs = kQuant ? a.vs + b * a.svs[0] + kvh * a.svs[1] : nullptr;

  float qf[GT][DPL], acc[GT][DPL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* q =
        static_cast<const T*>(a.q) + b * a.sq[0] + (h0 + g) * a.sq[1];
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (c * L + lig) * E + e;
        qf[g][c * E + e] = d < D ? to_f(q[d]) * a.scale_log2 : 0.0f;
        acc[g][c * E + e] = 0.0f;
      }
    m[g] = kNegInf;
    l[g] = 0.0f;
  }

  for (int base = c_lo; base <= c_hi; base += kSlots * kRowsAtOnce) {
    VT kv[kRowsAtOnce][VPL], vv[kRowsAtOnce][VPL];
    float ksc[kRowsAtOnce], vsc[kRowsAtOnce];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      const int t = base + u * kSlots + slot;
      const bool ok = t <= c_hi;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const int d = (c * L + lig) * E;
        if (ok && d < D) {
          kv[u][c] = *reinterpret_cast<const VT*>(k + t * a.sk[2] + d);
          vv[u][c] = *reinterpret_cast<const VT*>(v + t * a.sv[2] + d);
        } else {
          kv[u][c] = VT{};
          vv[u][c] = VT{};
        }
      }
      ksc[u] = kQuant && ok ? ks[t * a.sks[2]] : 1.0f;
      vsc[u] = kQuant && ok ? vs[t * a.svs[2]] : 1.0f;
    }
    float s[kRowsAtOnce][GT];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g) s[u][g] = 0.0f;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        float kf[E];
        V::unpack(kv[u][c], kf);
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            s[u][g] = fmaf(qf[g][c * E + e], kf[e], s[u][g]);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        s[u][g] *= ksc[u];
        if (base + u * kSlots + slot <= c_hi) mx = fmaxf(mx, s[u][g]);
      }
      const float corr = exp2f(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= corr;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (base + u * kSlots + slot > c_hi) continue;
      float p[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        p[g] = exp2f(s[u][g] - m[g]);
        l[g] += p[g];
      }
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        float vf[E];
        V::unpack(vv[u][c], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = kQuant ? vf[e] * vsc[u] : vf[e];
#pragma unroll
          for (int g = 0; g < GT; ++g)
            acc[g][c * E + e] = fmaf(p[g], x, acc[g][c * E + e]);
        }
      }
    }
  }

  // Merge the slots in slot order, then write the block's partial.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lig == 0) {
      s_ml[slot][g][0] = m[g];
      s_ml[slot][g][1] = l[g];
    }
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e)
        s_acc[slot][g][(c * L + lig) * E + e] = acc[g][c * E + e];
  }
  __syncthreads();
  const int64_t row0 = (static_cast<int64_t>(b) * a.H + h0) * a.n_split;
  for (int idx = threadIdx.x; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float big = kNegInf;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) big = fmaxf(big, s_ml[sl][g][0]);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const float w = exp2f(s_ml[sl][g][0] - big);
      den = fmaf(s_ml[sl][g][1], w, den);
      num = fmaf(s_acc[sl][g][d], w, num);
    }
    const int64_t part = row0 + g * a.n_split + split;
    a.part_acc[part * D + d] = num;
    if (d == 0) {
      a.part_ml[2 * part] = big;
      a.part_ml[2 * part + 1] = den;
    }
  }
}

// `flash_decode_merge`, grid B * H / GT: block x merges the n_split
// partials of grid row x of the split kernel (GT heads): out = sum_s acc_s
// 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), in q's dtype.  One warp
// a head takes M and the denominator by butterflies over the splits (lanes
// s and s + 32), the numerator runs in split order: a fixed order.  An
// empty partial (m = -1e30, l = 0) gets weight 0.
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads) flash_decode_merge(DecodeArgs a) {
  __shared__ float s_w[GT][kMaxSplit];
  __shared__ float s_inv_den[GT];
  const int groups = a.H / a.KV / GT;  // head groups of a KV head
  const int bx = blockIdx.x;
  const int b = bx / (a.KV * groups);
  const int h0 = (bx / groups) % a.KV * (a.H / a.KV) + (bx % groups) * GT;
  const int64_t row0 = (static_cast<int64_t>(b) * a.H + h0) * a.n_split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < GT; g += kWarps) {
    const float* ml = a.part_ml + 2 * (row0 + g * a.n_split);
    float m[2], lsum[2], big = kNegInf;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = lane + 32 * i;
      const bool ok = s < a.n_split;
      m[i] = ok ? ml[2 * s] : kNegInf;
      lsum[i] = ok ? ml[2 * s + 1] : 0.0f;
      big = fmaxf(big, m[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
    float den = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = lane + 32 * i;
      const float w = exp2f(m[i] - big);
      if (s < a.n_split) s_w[g][s] = w;
      den = fmaf(lsum[i], w, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) {
      s_inv_den[g] = 1.0f / fmaxf(den, 1e-30f);
      if (a.lse != nullptr)
        a.lse[b * a.H + h0 + g] = (big + log2f(den)) * 0.6931471805599453f;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * a.D; idx += kThreads) {
    const int g = idx / a.D, d = idx - g * a.D;
    const float* acc = a.part_acc + (row0 + g * a.n_split) * a.D + d;
    float num = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s)
      num = fmaf(acc[s * a.D], s_w[g][s], num);
    const int64_t at = b * a.so[0] + (h0 + g) * a.so[1] + d;
    if (a.lse != nullptr)
      static_cast<float*>(a.o)[at] = num * s_inv_den[g];
    else
      static_cast<T*>(a.o)[at] = from_f<T>(num * s_inv_den[g]);
  }
}

template <typename T, typename C, int L, int VPL, int GT>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H / GT, a.n_split);
  flash_decode_split<T, C, L, VPL, GT><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge<T, GT><<<grid.x, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C, int L, int VPL>
int launch_g(const DecodeArgs& a, int gt, cudaStream_t stream) {
  switch (gt) {
    case 1: return launch<T, C, L, VPL, 1>(a, stream);
    case 2: return launch<T, C, L, VPL, 2>(a, stream);
    case 4: return launch<T, C, L, VPL, 4>(a, stream);
    default: return launch<T, C, L, VPL, 8>(a, stream);
  }
}

// Lanes a row: 16-byte vectors (8-byte for int8) of 8 values (4 float32);
// D <= 128 in 16 lanes (32 for float32), D <= 256 in 32 lanes (two vectors
// a lane for float32).
template <typename T, typename C>
int dispatch(const DecodeArgs& a, int gt, cudaStream_t stream) {
  if constexpr (Vec<C>::E == 4)
    return a.D <= 128 ? launch_g<T, C, 32, 1>(a, gt, stream)
                      : launch_g<T, C, 32, 2>(a, gt, stream);
  else
    return a.D <= 128 ? launch_g<T, C, 16, 1>(a, gt, stream)
                      : launch_g<T, C, 32, 1>(a, gt, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q and out; the cache too unless quant).
// quant: the cache is int8 and ks / vs hold its float32 scales.
// lo, hi: the valid positions; chunk, n_split: the split plan (chunk
// positions a block from lo on, n_split * chunk >= hi - lo + 1, n_split <=
// 64); gt: query heads a block (1, 2, 4 or 8, dividing H / KV).
// part_acc / part_ml: float32 scratch of B * H * n_split * D and
// B * H * n_split * 2.
// strides: 16 element strides: q (b, h), k (b, kv, s), v (b, kv, s),
// ks (b, kv, s), vs (b, kv, s), out (b, h); the last axis (D) is contiguous
// in q, k, v and out.
// lse: null, or shard mode: out is float32 and lse [B, H] float32 receives
// each head's log-sum-exp over the valid positions.
int flash_decode(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, void* o, float* part_acc, float* part_ml,
                 int dtype, int quant, int B, int H, int KV, int S, int D,
                 int lo, int hi, int chunk, int n_split, int gt, float scale,
                 const int64_t* strides, float* lse, cudaStream_t stream) {
  const int vec_values = dtype == 0 && !quant ? 4 : 8;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || D <= 0 ||
      D > kMaxD || D % vec_values != 0 || lo < 0 || hi < lo || hi >= S ||
      chunk <= 0 || n_split <= 0 || n_split > kMaxSplit ||
      static_cast<int64_t>(n_split) * chunk < hi - lo + 1 ||
      (gt != 1 && gt != 2 && gt != 4 && gt != 8) || (H / KV) % gt != 0 ||
      (dtype != 0 && dtype != 1) ||
      (quant && (ks == nullptr || vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, k, v, ks, vs, o, part_acc, part_ml, lse, B, H, KV, S, D,
               lo, hi, chunk, n_split, scale * kLog2e, {}, {}, {}, {}, {},
               {}};
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
    return dtype == 0 ? dispatch<float, int8_t>(a, gt, stream)
                      : dispatch<__nv_bfloat16, int8_t>(a, gt, stream);
  return dtype == 0 ? dispatch<float, float>(a, gt, stream)
                    : dispatch<__nv_bfloat16, __nv_bfloat16>(a, gt, stream);
}

}  // extern "C"
