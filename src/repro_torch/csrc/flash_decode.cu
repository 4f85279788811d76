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
// Two kernels share one pass's arithmetic (`attend`):
//
// * A block takes GT query heads that share one KV head (all G = H / KV of
//   them unless G > 8), so each K and V row is read once for those heads,
//   and one contiguous chunk of the valid positions [lo, hi] =
//   [max(0, pos - W + 1), min(pos, S - 1)]: positions outside would only add
//   exp(-1e30 - m) = 0, so they are never read.  No chunk is empty.
// * L lanes take one row, each lane 16 bytes of it (8 bf16 or 4 float32;
//   int8 rows in 8 bytes, 8 values, as a 120-dim int8 row is only 8-byte
//   aligned), so a warp covers 32 / L rows and the block 4 * 32 / L
//   "slots"; each slot takes 4 rows a pass.  The L partial dot products of
//   a row (q pre-scaled by log2(e) / sqrt(D)) are butterfly-reduced, so
//   every lane holds the same score, and each slot keeps its own running
//   max m, sum l and accumulator for each head (exp2 domain).  int8 rows
//   are converted and scaled in registers (never a float copy of the
//   cache).  The slots are merged in slot order through shared memory.
//
// `flash_decode_split` (below), grid (B * KV *
// head groups, n_split), 128 threads: the plan (n_split <= 64 chunks of at
// most one pass each, unless 64 would not cover the range) comes from the
// wrapper, sized for a few blocks per SM; each block loads a pass's rows
// into registers, then writes its partial (m, l, acc[D]) per head in
// float32 to the wrapper's scratch, and a second launch,
// `flash_decode_merge`, merges each row's n_split partials in a fixed
// order.
//
// `flash_decode_cluster` (flash_decode_cluster.cu) is one launch.  At a
// tensor-parallel rank's chunk of a long cache (2048 positions of
// decode_32k: 64 (batch, head-group) rows) the split kernel's one-pass
// blocks and its scratch round trip cost more than the bytes: each of 4096
// blocks read 16 KB, paid the slot merge and a partial write, and a second
// launch of 64 blocks read the 4.3 MB of partials back serially.  Here
// the n_split <= 8 blocks of one row are one thread-block cluster, each
// block walks its chunk in several passes, and the merge runs through
// distributed shared memory:
//   - every thread streams the rows it will consume into its own slice of
//     a ring of 2 passes in shared memory (3 left fewer blocks on an SM
//     and ran 12 % slower) with 16-byte `cp.async` copies (8 bytes for
//     int8, zero-filled past the chunk or past D), a pass's copies one
//     commit group, waiting only for the oldest pass.  So a pass (16 KB
//     for bf16 at D 128) stays in flight while one is consumed, and as no
//     thread reads another's slice the loop needs no barrier;
//   - after the slot merge each block holds its partial (m, l, acc[GT][D])
//     in its own shared memory; after `cluster.sync()` block r takes every
//     n_split-th group of 128 outputs, reads the cluster's partials through
//     `map_shared_rank` and merges them in rank order; a second
//     `cluster.sync()` keeps each block's memory alive until all have read.
//   No scratch, no second launch.  The wrapper (`kernels/flash_decode.py`,
//   `decode_plan`) takes it in both modes where its plan gives a block at
//   most 512 positions (a rank's chunk, the serve step) or a block to half
//   the SMs or more (decode_32k's whole cache); a long range on a small
//   grid (batch 1: 64 blocks of 4096 positions on 132 SMs) keeps the
//   split kernel's up to 64 splits, which keep more loads in flight.  On
//   an H100 (700 W) a 2048-position chunk of decode_32k took 1.42x the
//   bytes' bound (the split kernel 2.3x): what is left is a launch's ramp
//   and tail, as the blocks all start, and merge, at once.
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
// The split kernel is here, the cluster kernel in flash_decode_cluster.cu
// (two sources, so that nvcc builds them side by side), what they share in
// flash_decode_common.cuh.  Plain C interface for ctypes: each function
// returns the cudaError_t of its launches (0 on success).
#include "flash_decode_common.cuh"

namespace {

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
  __shared__ float s_ml[kSlots * GT * 2];
  __shared__ float s_acc[kSlots * GT * kDP];

  int b, kvh, h0;
  grid_row(a, GT, blockIdx.x, b, kvh, h0);
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
  init_heads<T, L, DPL, E, GT>(a, b, h0, lig, qf, acc, m, l);

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
    attend<C, L, VPL, GT>(kv, vv, ksc, vsc, base + slot, kSlots, c_hi, qf,
                          acc, m, l);
  }

  // Merge the slots in slot order, then write the block's partial.
  store_slot<L, DPL, E, GT>(s_ml, s_acc, slot, lig, acc, m, l);
  __syncthreads();
  const int64_t row0 = (static_cast<int64_t>(b) * a.H + h0) * a.n_split;
  for (int idx = threadIdx.x; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float big, den, num;
    merge_slots<kSlots, GT, kDP>(s_ml, s_acc, g, d, big, den, num);
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
  int b, kvh, h0;
  grid_row(a, GT, blockIdx.x, b, kvh, h0);
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
struct SplitKernel {
  static int run(const DecodeArgs& a, cudaStream_t stream) {
    const dim3 grid(a.B * a.H / GT, a.n_split);
    flash_decode_split<T, C, L, VPL, GT><<<grid, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_merge<T, GT><<<grid.x, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

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
  DecodeArgs a;
  const int err = make_args(a, q, k, v, ks, vs, o, part_acc, part_ml, dtype,
                            quant, B, H, KV, S, D, lo, hi, chunk, n_split, gt,
                            scale, strides, lse, false);
  return err != 0 ? err : dispatch<SplitKernel>(a, dtype, quant, gt, stream);
}

}  // extern "C"
