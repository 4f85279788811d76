// Flash-decode's cluster kernel, `flash_decode_cluster`, for Hopper
// (sm_90a): one launch for the valid positions [lo, hi] of a cache, the
// blocks of a (batch, head-group) row one thread-block cluster, their
// partial softmax states merged through distributed shared memory.
//
// Replaces, with csrc/flash_decode.cu's split kernel, the Pallas TPU
// kernel src/repro/kernels/flash_decode.py::flash_decode (its body
// `_kernel`); flash_decode.cu's header gives the semantics, the bound and
// both designs, and kernels/flash_decode.py's `decode_plan` which of the
// two runs.  Plain C interface for ctypes: the function returns the
// cudaError_t of its launch (0 on success).
#include "flash_decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

// An asynchronous copy of N bytes (4, 8 or 16) from global into shared
// memory, zero-filled when !ok (src is then any valid address and is not
// read); a commit group of a thread's copies; a wait until at most N of the
// thread's groups are pending.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Passes in the cluster kernel's ring: one in flight while one is consumed
// (3 left fewer 48 KB blocks on an SM and ran 12 % slower on an H100).
constexpr int kStages = 2;

// Shared memory of the cluster kernel: the ring (kStages passes of every
// thread's K and V vectors, then the int8 cache's scales) during the loop,
// then the slot merge (ml, acc) and the block's partial.
template <typename C, int L, int VPL, int GT>
struct ClusterSmem {
  using VT = typename Vec<C>::type;
  static constexpr int kSlots = kWarps * (32 / L);
  static constexpr int kDP = L * VPL * Vec<C>::E;
  static constexpr int kVecs = kRowsAtOnce * VPL;  // a thread's K vectors
  static constexpr int kScales = sizeof(C) == 1 ? 2 * kRowsAtOnce : 0;
  static constexpr size_t kPassBytes =
      (2 * kVecs * sizeof(VT) + kScales * sizeof(float)) * kThreads;
  static constexpr size_t kMergeBytes =
      (kSlots * GT * (2 + kDP) + GT * (2 + kDP)) * sizeof(float);
  static constexpr size_t kRingBytes = kStages * kPassBytes;
  static constexpr size_t kBytes =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// `flash_decode_cluster`: grid (B * KV * head groups) * n_split, clusters
// of n_split blocks along x, 128 threads; the block of cluster rank j takes
// chunk j of its row.
template <typename T, typename C, int L, int VPL, int GT>
__global__ void __launch_bounds__(kThreads)
    flash_decode_cluster(DecodeArgs a) {
  using V = Vec<C>;
  using VT = typename V::type;
  using Smem = ClusterSmem<C, L, VPL, GT>;
  constexpr int E = V::E;
  constexpr int DPL = VPL * E;
  constexpr int kDP = Smem::kDP;
  constexpr int kSlots = Smem::kSlots;
  constexpr int kPass = kSlots * kRowsAtOnce;  // rows a pass
  constexpr int kVecs = Smem::kVecs;
  constexpr bool kQuant = sizeof(C) == 1;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  int b, kvh, h0;
  grid_row(a, GT, blockIdx.x / a.n_split, b, kvh, h0);
  const int c_lo = a.lo + split * a.chunk;
  const int c_hi = min(a.hi, c_lo + a.chunk - 1);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lig = lane % L;
  const int slot = warp * (32 / L) + lane / L;
  const int D = a.D;

  const C* k = static_cast<const C*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const C* v = static_cast<const C*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  const float* ks = kQuant ? a.ks + b * a.sks[0] + kvh * a.sks[1] : nullptr;
  const float* vs = kQuant ? a.vs + b * a.svs[0] + kvh * a.svs[1] : nullptr;

  // The ring: pass slot st holds this thread's K vectors [kVecs], its V
  // vectors [kVecs], strided by kThreads (neighbouring threads on
  // neighbouring 16 bytes), then its scales.
  VT* ring = reinterpret_cast<VT*>(smem);
  float* ring_sc =
      reinterpret_cast<float*>(ring + kStages * 2 * kVecs * kThreads);
  const int passes = (c_hi - c_lo + kPass) / kPass;
  auto issue = [&](int p) {
    const int st = p % kStages;
    VT* kd = ring + st * 2 * kVecs * kThreads + tid;
    VT* vd = kd + kVecs * kThreads;
    float* sd = ring_sc + st * Smem::kScales * kThreads + tid;
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      const int t = c_lo + p * kPass + u * kSlots + slot;
      const bool ok = t <= c_hi;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const int d = (c * L + lig) * E;
        const bool in = ok && d < D;
        cp_async<sizeof(VT)>(kd + (u * VPL + c) * kThreads,
                             in ? k + t * a.sk[2] + d : k, in);
        cp_async<sizeof(VT)>(vd + (u * VPL + c) * kThreads,
                             in ? v + t * a.sv[2] + d : v, in);
      }
      if constexpr (kQuant) {
        cp_async<4>(sd + u * kThreads, ok ? ks + t * a.sks[2] : ks, ok);
        cp_async<4>(sd + (kRowsAtOnce + u) * kThreads,
                    ok ? vs + t * a.svs[2] : vs, ok);
      }
    }
  };
  for (int p = 0; p < kStages; ++p) {  // one commit group a pass
    if (p < passes) issue(p);
    cp_async_commit();
  }

  float qf[GT][DPL], acc[GT][DPL], m[GT], l[GT];
  init_heads<T, L, DPL, E, GT>(a, b, h0, lig, qf, acc, m, l);

  for (int p = 0; p < passes; ++p) {
    cp_async_wait<kStages - 1>();  // pass p's group done, p + 1's pending
    const int st = p % kStages;
    const VT* kd = ring + st * 2 * kVecs * kThreads + tid;
    const VT* vd = kd + kVecs * kThreads;
    const float* sd = ring_sc + st * Smem::kScales * kThreads + tid;
    VT kv[kRowsAtOnce][VPL], vv[kRowsAtOnce][VPL];
    float ksc[kRowsAtOnce], vsc[kRowsAtOnce];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        kv[u][c] = kd[(u * VPL + c) * kThreads];
        vv[u][c] = vd[(u * VPL + c) * kThreads];
      }
      ksc[u] = kQuant ? sd[u * kThreads] : 1.0f;
      vsc[u] = kQuant ? sd[(kRowsAtOnce + u) * kThreads] : 1.0f;
    }
    attend<C, L, VPL, GT>(kv, vv, ksc, vsc, c_lo + p * kPass + slot, kSlots,
                          c_hi, qf, acc, m, l);
    // Refill the slot just read: every value read above fed the arithmetic
    // before this point, and only the last pass has rows past c_hi (whose
    // slot is never refilled), so no copy overwrites a value not yet read.
    if (p + kStages < passes) issue(p + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The slots merged in slot order into the block's partial, in shared
  // memory where the ring was.
  float* ml = reinterpret_cast<float*>(smem);
  float* sacc = ml + kSlots * GT * 2;
  float* part_ml = sacc + kSlots * GT * kDP;  // [GT][2]
  float* part_acc = part_ml + GT * 2;         // [GT][kDP]
  __syncthreads();
  store_slot<L, DPL, E, GT>(ml, sacc, slot, lig, acc, m, l);
  __syncthreads();
  for (int idx = tid; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float big, den, num;
    merge_slots<kSlots, GT, kDP>(ml, sacc, g, d, big, den, num);
    part_acc[g * kDP + d] = num;
    if (d == 0) {
      part_ml[2 * g] = big;
      part_ml[2 * g + 1] = den;
    }
  }

  // The cluster's partials merged in rank order through distributed shared
  // memory: block j takes the outputs [(j + n * n_split) * 128, + 128).
  cluster.sync();
  for (int idx = split * kThreads + tid; idx < GT * D;
       idx += a.n_split * kThreads) {
    const int g = idx / D, d = idx - g * D;
    // every rank's (m, l, acc[d]) read at once, then merged in rank order
    float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const bool in = r < a.n_split;
      pm[r] = in ? cluster.map_shared_rank(part_ml, r)[2 * g] : kNegInf;
      pl[r] = in ? cluster.map_shared_rank(part_ml, r)[2 * g + 1] : 0.0f;
      pa[r] = in ? cluster.map_shared_rank(part_acc, r)[g * kDP + d] : 0.0f;
    }
    float big = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) big = fmaxf(big, pm[r]);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float w = exp2f(pm[r] - big);
      den = fmaf(pl[r], w, den);
      num = fmaf(pa[r], w, num);
    }
    const float inv_den = 1.0f / fmaxf(den, 1e-30f);
    const int64_t at = b * a.so[0] + (h0 + g) * a.so[1] + d;
    if (a.lse != nullptr) {
      static_cast<float*>(a.o)[at] = num * inv_den;
      if (d == 0)
        a.lse[b * a.H + h0 + g] = (big + log2f(den)) * 0.6931471805599453f;
    } else {
      static_cast<T*>(a.o)[at] = from_f<T>(num * inv_den);
    }
  }
  cluster.sync();  // no block leaves while another may read its memory
}


template <typename T, typename C, int L, int VPL, int GT>
struct ClusterKernel {
  static int run(const DecodeArgs& a, cudaStream_t stream) {
    using Smem = ClusterSmem<C, L, VPL, GT>;
    const auto kernel = flash_decode_cluster<T, C, L, VPL, GT>;
    // on each launch: the attribute belongs to the current card's context
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem::kBytes));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B * a.H / GT * a.n_split);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Smem::kBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[1] = {};
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = a.n_split;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  }
};

}  // namespace

extern "C" {

// The arguments of flash_decode (flash_decode.cu) without the scratch:
// n_split <= 8 blocks a row, each its own nonempty chunk ((n_split - 1) *
// chunk < hi - lo + 1), one cluster a row.
int flash_decode_cluster(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, void* o, int dtype,
                         int quant, int B, int H, int KV, int S, int D,
                         int lo, int hi, int chunk, int n_split, int gt,
                         float scale, const int64_t* strides, float* lse,
                         cudaStream_t stream) {
  DecodeArgs a;
  const int err = make_args(a, q, k, v, ks, vs, o, nullptr, nullptr, dtype,
                            quant, B, H, KV, S, D, lo, hi, chunk, n_split, gt,
                            scale, strides, lse, true);
  return err != 0 ? err
                  : dispatch<ClusterKernel>(a, dtype, quant, gt, stream);
}

}  // extern "C"
