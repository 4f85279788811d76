// Shared by the two flash-decode kernels, csrc/flash_decode.cu (the split
// kernel and its merge) and csrc/flash_decode_cluster.cu (the cluster
// kernel): their arguments, the cache's vectors, one pass's arithmetic,
// the slot merge, the argument checks and the dispatch over the
// instantiations.  flash_decode.cu's header describes both designs.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAtOnce = 4;  // rows a slot loads together
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 64;
constexpr int kMaxCluster = 8;  // the portable cluster size
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

// One pass of a slot's kRowsAtOnce rows (row u at position first + u *
// step, masked past c_hi): the scores, the online softmax's rescale and the
// PV accumulation, in the exp2 domain.  C: the cache (a float type, or
// int8_t with scales ksc / vsc); L: lanes a row; VPL: vectors a lane takes
// of a row; GT: query heads a block.
template <typename C, int L, int VPL, int GT>
__device__ __forceinline__ void attend(
    const typename Vec<C>::type (&kv)[kRowsAtOnce][VPL],
    const typename Vec<C>::type (&vv)[kRowsAtOnce][VPL],
    const float (&ksc)[kRowsAtOnce], const float (&vsc)[kRowsAtOnce],
    int first, int step, int c_hi, const float (&qf)[GT][VPL * Vec<C>::E],
    float (&acc)[GT][VPL * Vec<C>::E], float (&m)[GT], float (&l)[GT]) {
  using V = Vec<C>;
  constexpr int E = V::E;
  constexpr int DPL = VPL * E;
  constexpr bool kQuant = sizeof(C) == 1;
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
      if (first + u * step <= c_hi) mx = fmaxf(mx, s[u][g]);
    }
    const float corr = exp2f(m[g] - mx);
    l[g] *= corr;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] *= corr;
    m[g] = mx;
  }
#pragma unroll
  for (int u = 0; u < kRowsAtOnce; ++u) {
    if (first + u * step > c_hi) continue;
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

// q's GT heads of the block scaled by log2(e) / sqrt(D) into the lane's
// dims (0 past D), and the empty softmax state.
template <typename T, int L, int DPL, int E, int GT>
__device__ __forceinline__ void init_heads(const DecodeArgs& a, int b, int h0,
                                           int lig, float (&qf)[GT][DPL],
                                           float (&acc)[GT][DPL],
                                           float (&m)[GT], float (&l)[GT]) {
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* q =
        static_cast<const T*>(a.q) + b * a.sq[0] + (h0 + g) * a.sq[1];
#pragma unroll
    for (int c = 0; c < DPL / E; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (c * L + lig) * E + e;
        qf[g][c * E + e] = d < a.D ? to_f(q[d]) * a.scale_log2 : 0.0f;
        acc[g][c * E + e] = 0.0f;
      }
    m[g] = kNegInf;
    l[g] = 0.0f;
  }
}

// A slot's state into shared memory: ml [slots][GT][2] (m, l), sacc
// [slots][GT][kDP].
template <int L, int DPL, int E, int GT>
__device__ __forceinline__ void store_slot(float* ml, float* sacc, int slot,
                                           int lig, const float (&acc)[GT][DPL],
                                           const float (&m)[GT],
                                           const float (&l)[GT]) {
  constexpr int kDP = L * DPL;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lig == 0) {
      ml[(slot * GT + g) * 2] = m[g];
      ml[(slot * GT + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DPL / E; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e)
        sacc[(slot * GT + g) * kDP + (c * L + lig) * E + e] = acc[g][c * E + e];
  }
}

// The block's slots merged in slot order for head g, dim d: the largest m,
// the weighted sum of l and of acc[d] (weights 2^(m - big)).
template <int kSlots, int GT, int kDP>
__device__ __forceinline__ void merge_slots(const float* ml, const float* sacc,
                                            int g, int d, float& big,
                                            float& den, float& num) {
  big = kNegInf;
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) big = fmaxf(big, ml[(sl * GT + g) * 2]);
  num = 0.0f;
  den = 0.0f;
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const float w = exp2f(ml[(sl * GT + g) * 2] - big);
    den = fmaf(ml[(sl * GT + g) * 2 + 1], w, den);
    num = fmaf(sacc[(sl * GT + g) * kDP + d], w, num);
  }
}

// The grid row x: (batch, KV head, first query head) of its GT heads.
__device__ __forceinline__ void grid_row(const DecodeArgs& a, int gt, int x,
                                         int& b, int& kvh, int& h0) {
  const int groups = a.H / a.KV / gt;  // head groups of a KV head
  b = x / (a.KV * groups);
  kvh = (x / groups) % a.KV;
  h0 = kvh * (a.H / a.KV) + (x % groups) * gt;
}


// The checks of both entry points and their arguments: 0, or
// cudaErrorInvalidValue.  cluster: the cluster kernel's plan (n_split <=
// 8, no empty chunk); else the split kernel's.
int make_args(DecodeArgs& a, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, void* o, float* part_acc,
              float* part_ml, int dtype, int quant, int B, int H, int KV,
              int S, int D, int lo, int hi, int chunk, int n_split, int gt,
              float scale, const int64_t* strides, float* lse,
              bool cluster) {
  const int vec_values = dtype == 0 && !quant ? 4 : 8;
  const int64_t n = static_cast<int64_t>(hi) - lo + 1;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || D <= 0 ||
      D > kMaxD || D % vec_values != 0 || lo < 0 || hi < lo || hi >= S ||
      chunk <= 0 || n_split <= 0 ||
      n_split > (cluster ? kMaxCluster : kMaxSplit) ||
      static_cast<int64_t>(n_split) * chunk < n ||
      (cluster && static_cast<int64_t>(n_split - 1) * chunk >= n) ||
      (gt != 1 && gt != 2 && gt != 4 && gt != 8) || (H / KV) % gt != 0 ||
      (dtype != 0 && dtype != 1) ||
      (quant && (ks == nullptr || vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a = DecodeArgs{q,  k,  v,  ks, vs,      o,       part_acc, part_ml,
                 lse, B, H, KV, S, D, lo, hi, chunk, n_split,
                 scale * kLog2e, {}, {}, {}, {}, {}, {}};
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
  return 0;
}

// The launch of Kernel<T, C, L, VPL, GT>::run for the arguments: q's type
// (dtype 0 float32, 1 bfloat16), the cache's (q's, or int8 with quant), the
// lanes a row and the vectors a lane by D (16-byte vectors, 8-byte for
// int8, of 8 values, 4 float32; D <= 128 in 16 lanes, 32 for float32;
// D <= 256 in 32 lanes, two vectors a lane for float32), the heads a block.
template <template <typename, typename, int, int, int> class Kernel,
          typename T, typename C, int L, int VPL>
int dispatch_gt(const DecodeArgs& a, int gt, cudaStream_t stream) {
  switch (gt) {
    case 1: return Kernel<T, C, L, VPL, 1>::run(a, stream);
    case 2: return Kernel<T, C, L, VPL, 2>::run(a, stream);
    case 4: return Kernel<T, C, L, VPL, 4>::run(a, stream);
    default: return Kernel<T, C, L, VPL, 8>::run(a, stream);
  }
}

template <template <typename, typename, int, int, int> class Kernel,
          typename T, typename C>
int dispatch_d(const DecodeArgs& a, int gt, cudaStream_t stream) {
  if constexpr (Vec<C>::E == 4)
    return a.D <= 128 ? dispatch_gt<Kernel, T, C, 32, 1>(a, gt, stream)
                      : dispatch_gt<Kernel, T, C, 32, 2>(a, gt, stream);
  else
    return a.D <= 128 ? dispatch_gt<Kernel, T, C, 16, 1>(a, gt, stream)
                      : dispatch_gt<Kernel, T, C, 32, 1>(a, gt, stream);
}

template <template <typename, typename, int, int, int> class Kernel>
int dispatch(const DecodeArgs& a, int dtype, int quant, int gt,
             cudaStream_t stream) {
  if (quant)
    return dtype == 0
               ? dispatch_d<Kernel, float, int8_t>(a, gt, stream)
               : dispatch_d<Kernel, __nv_bfloat16, int8_t>(a, gt, stream);
  return dtype == 0
             ? dispatch_d<Kernel, float, float>(a, gt, stream)
             : dispatch_d<Kernel, __nv_bfloat16, __nv_bfloat16>(a, gt,
                                                                stream);
}

}  // namespace
