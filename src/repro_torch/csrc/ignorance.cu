// Ignorance-score update (paper eqs. 10/12) for Hopper (sm_90a): one launch
// on a thread-block cluster.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ignorance.py::ignorance_update_unnormalized (its body
// `_kernel`) together with the normalizer of
// src/repro/kernels/ops.py::ignorance_update:
//
//     w_new = w * exp(alpha * (1 - r));   w <- w_new / max(sum(w_new), 1e-12)
//
// What bounds it on this card: the bytes are 12 * n (read w and r, write w
// once), 0.15 us at n = 42000 and the H100's 3.35 TB/s; one double-precision
// exp an element stays below the float64 rate.  At the main path's n (420,
// 10500, 42000) the launch and one round trip to device memory take far
// longer than the bytes, so the design spends one launch a hop and keeps
// every intermediate on chip: no second pass, no global scratch.
//
// ignorance_update (the cluster route, n <= 2^16, every main-path hop):
// one cluster of C <= 16 CTAs of 1024 threads (C <= 8 is portable; 16 only
// where ignorance_max_cluster found that such a cluster fits), CTA b the
// 1024-element tiles [b * T, (b + 1) * T), T <= 8:
//   1. thread t loads element t of each of its CTA's tiles, so that every
//      load is coalesced and the double-precision exps spread over all 32
//      warps of the SM (a first version gave each warp whole tiles, 32 exps
//      a lane on a few warps, and ran at twice the two-pass kernel's device
//      time); it keeps w_new in registers and stages it in shared memory;
//   2. one CTA barrier; warp j sums tile j from the stage in the two-pass
//      kernel's tree order (step s adds element e + s into e, s from 512 to
//      1): lane l holds elements l + 32 m, so levels 512 .. 32 add inside
//      the lane's registers and 16 .. 1 go by shuffles;
//   3. warp j stores tile j's sum into every CTA's shared memory through
//      distributed shared memory (map_shared_rank; a cluster barrier that
//      each CTA arrives at as it starts makes sure the others have
//      started), then cluster.sync();
//   4. warp 0 forms the total from its own CTA's copy of the sums in the
//      order of the two-pass kernel's second pass (lane L of 1024 holds
//      partial L, then the same tree), so every CTA divides by the same
//      bits and no sum uses an atomic; it clamps the total at 1e-12 and
//      hands it over in shared memory (a CTA barrier; a total formed by
//      every warp measured slower), and each thread divides its registers
//      and stores them.  No CTA touches another's memory after the cluster
//      barrier, so each exits freely.
// On the main path r is a 0/1 indicator, so a thread takes one exp (of
// alpha) and looks the rest up; see `scaled`.
// Above 2^16 the large-n route runs two kernels (the unnormalized mode
// below, then ignorance_pass2, which sums the partials in the same order
// and scales in place): the whole card then takes the exps and the bytes,
// and that outweighs the second launch.  The wrapper decides the route on
// n alone (kernels/ignorance.py, LARGE_N).
//
// ignorance_update_unnormalized (the TPU kernel's own API): the same kernel
// in its unnormalized mode, a plain grid of one CTA a tile, storing w_new
// and one partial sum per tile, in one launch.
//
// The arithmetic is the same in every route and mode: the exponential is
// taken in double and rounded to float (no fast-math: a float expf differs
// by an ulp between CUDA's and the CPU's libraries, the rounded double does
// not), the sums in the fixed tree order, a true division.  So a run gives
// the same bits as the plain version in kernels/ignorance.py and as the
// earlier two-pass kernel, every time, which bit-exact checkpoint resume and
// card = CPU sessions rest on.  alpha is read from device memory, so a
// launch needs no host sync.
//
// launch_floor: an empty kernel, the yardstick of a launch's own cost.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launches (0 on success).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 1024;              // elements a partial sums
constexpr int kThreads = 1024;           // a CTA: one element of each tile
constexpr int kLanes = 32;
constexpr int kPerLane = kTile / kLanes;  // a tile's elements in one lane
constexpr int kMaxTilesPerCta = 8;
constexpr int kMaxCluster = 16;
constexpr int kSlots = kMaxTilesPerCta * kMaxCluster / kLanes;
constexpr int kPortableCluster = 8;
constexpr unsigned kAll = 0xffffffffu;

// Sum of 1024 values held by one warp (lane l holds element l + 32 m in
// v[m]) in the tree order: step s adds element e + s into element e for
// e < s, s halving from 512 to 1.  Element e + s lies in the same lane for
// s >= 32 (slot m + s / 32) and in lane l + s below.  Lane 0 gets the sum.
__device__ __forceinline__ float warp_tree(const float (&v)[kPerLane]) {
  float t[kPerLane / 2];
#pragma unroll
  for (int m = 0; m < kPerLane / 2; ++m) t[m] = v[m] + v[m + kPerLane / 2];
#pragma unroll
  for (int h = kPerLane / 4; h > 0; h >>= 1) {
#pragma unroll
    for (int m = 0; m < h; ++m) t[m] += t[m + h];
  }
  float s = t[0];
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_down_sync(kAll, s, o);
  return s;
}

// w * exp(a * (1 - r)), the exponential in double rounded to float.  r is
// a 0/1 indicator on the main path, so exp(a * (1 - 0)) = ea, taken once a
// thread, and exp(a * (1 - 1)) = exp(0) = 1 (for a finite a) are looked up;
// any other r pays its own exp.  The bits are the same either way.
__device__ __forceinline__ float scaled(float w, float r, float a, float ea) {
  if (r == 0.0f) return w * ea;
  if (r == 1.0f && isfinite(a)) return w * 1.0f;
  return w * static_cast<float>(exp(static_cast<double>(a * (1.0f - r))));
}

// The two halves of a cluster barrier.  A CTA arrives as it starts and
// waits before it first writes to another CTA's shared memory, which the
// other CTA must then have started; the wait costs nothing by that time.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// CTA b takes the tiles [b * tiles_per_cta, (b + 1) * tiles_per_cta), its
// thread t element t of each; kTPC is a power of two at least
// tiles_per_cta, the rest masked.  kNormalize: the cluster route (the grid
// is one cluster); otherwise the unnormalized mode (store w_new and the
// partials, no exchange).
template <bool kNormalize, int kTPC>
__global__ void __launch_bounds__(kThreads)
ignorance_fused(const float* __restrict__ w, const float* __restrict__ r,
                const float* __restrict__ alpha, float* __restrict__ out,
                float* __restrict__ partials, int64_t n, int tiles_per_cta) {
  __shared__ float stage[kTPC * kTile];
  __shared__ float sums[kNormalize ? kSlots * kLanes : 1];  // every tile's
  __shared__ float total_sm;
  if constexpr (kNormalize) cluster_arrive();
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int first = blockIdx.x * tiles_per_cta;
  const int here = min(tiles_per_cta, num_tiles - first);
  const int64_t base = static_cast<int64_t>(first) * kTile + threadIdx.x;
  const float a = __ldg(alpha);
  const float ea = static_cast<float>(exp(static_cast<double>(a)));

  float wv[kTPC], rv[kTPC], v[kTPC];
#pragma unroll
  for (int k = 0; k < kTPC; ++k) {
    const int64_t i = base + static_cast<int64_t>(kTile) * k;
    const bool in = k < here && i < n;
    wv[k] = in ? w[i] : 0.0f;
    rv[k] = in ? r[i] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kTPC; ++k) {
    const int64_t i = base + static_cast<int64_t>(kTile) * k;
    v[k] = k < here && i < n ? scaled(wv[k], rv[k], a, ea) : 0.0f;
    stage[k * kTile + threadIdx.x] = v[k];
    if constexpr (!kNormalize) {
      if (k < here && i < n) out[i] = v[k];
    }
  }
  __syncthreads();
  float s = 0.0f;
  if (warp < here) {   // warp j sums tile j in the tree order
    float e[kPerLane];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m)
      e[m] = stage[warp * kTile + lane + kLanes * m];
    s = warp_tree(e);
    if constexpr (!kNormalize) {
      if (lane == 0) partials[first + warp] = s;
    }
  }
  if constexpr (kNormalize) {
    cg::cluster_group cluster = cg::this_cluster();
    const int ctas = static_cast<int>(cluster.num_blocks());
    cluster_wait();
    // Push: lane c of warp j stores tile j's sum into CTA c's `sums`, so
    // that after the barrier every CTA holds every sum in its own memory.
    s = __shfl_sync(kAll, s, 0);
    if (warp < here && lane < ctas)
      *cluster.map_shared_rank(&sums[first + warp], lane) = s;
    cluster.sync();
    // The total in the second pass's order: lane L of 1024 holds partial L,
    // then the tree over the lanes.  A cluster holds at most kSlots * 32
    // tiles, so the other slots are 0.  Warp 0 forms it.
    if (warp == 0) {
      float acc[kPerLane];
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        const int p = lane + kLanes * m;
        acc[m] = 0.0f;
        if (m < kSlots && p < num_tiles) acc[m] += sums[p];
      }
      const float t = warp_tree(acc);
      if (lane == 0) total_sm = fmaxf(t, 1e-12f);
    }
    __syncthreads();
    const float total = total_sm;
#pragma unroll
    for (int k = 0; k < kTPC; ++k) {
      const int64_t i = base + static_cast<int64_t>(kTile) * k;
      if (k < here && i < n) out[i] = v[k] / total;
    }
  }
}

// The large-n route's second kernel: the total of all partials in the fixed
// order (thread t accumulates partials t, t + 1024, ..., then the tree over
// the threads), clamped at 1e-12; each block scales its tile in place.
__global__ void __launch_bounds__(kTile)
ignorance_pass2(float* __restrict__ out, const float* __restrict__ partials,
                int64_t n, int num_tiles) {
  __shared__ float sm[kTile];
  float acc = 0.0f;
  for (int j = threadIdx.x; j < num_tiles; j += kTile) acc += partials[j];
  sm[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll 1
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm[threadIdx.x] += sm[threadIdx.x + s];
    __syncthreads();
  }
  const float total = fmaxf(sm[0], 1e-12f);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i < n) out[i] = out[i] / total;
}

__global__ void empty_kernel() {}

cudaLaunchAttribute cluster_attr(int cluster) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <bool kNormalize, int kTPC>
cudaError_t launch_fused(int ctas, int cluster, const float* w,
                         const float* r, const float* alpha, float* out,
                         float* partials, int64_t n, int tiles_per_cta,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(cluster)};
  cfg.attrs = attr;
  cfg.numAttrs = kNormalize ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, ignorance_fused<kNormalize, kTPC>, w, r,
                            alpha, out, partials, n, tiles_per_cta);
}

cudaError_t update(int cluster, int tiles_per_cta, const float* w,
                   const float* r, const float* alpha, float* out, int64_t n,
                   cudaStream_t stream) {
  switch (tiles_per_cta) {
    case 1:
      return launch_fused<true, 1>(cluster, cluster, w, r, alpha, out,
                                   nullptr, n, 1, stream);
    case 2:
      return launch_fused<true, 2>(cluster, cluster, w, r, alpha, out,
                                   nullptr, n, 2, stream);
    case 3:
    case 4:
      return launch_fused<true, 4>(cluster, cluster, w, r, alpha, out,
                                   nullptr, n, tiles_per_cta, stream);
    default:
      return launch_fused<true, 8>(cluster, cluster, w, r, alpha, out,
                                   nullptr, n, tiles_per_cta, stream);
  }
}

int64_t num_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

cudaError_t unnormalized(const float* w, const float* r, const float* alpha,
                         float* out, float* partials, int64_t n,
                         cudaStream_t stream) {
  const int64_t tiles = num_tiles_of(n);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  return launch_fused<false, 1>(static_cast<int>(tiles), 1, w, r, alpha, out,
                                partials, n, 1, stream);
}

}  // namespace

extern "C" {

// out[n] = w * exp(alpha * (1 - r)) / max(sum, 1e-12) in one launch: one
// cluster of `cluster` CTAs of `tiles_per_cta` tiles each.  The plan
// (kernels/ignorance.py::plan) must cover every tile with no CTA left
// empty.
int ignorance_update(const float* w, const float* r, const float* alpha,
                     float* out, int64_t n, int cluster, int tiles_per_cta,
                     cudaStream_t stream) {
  const int64_t tiles = num_tiles_of(n);
  if (n <= 0 || cluster < 1 || cluster > kMaxCluster || tiles_per_cta < 1 ||
      tiles_per_cta > kMaxTilesPerCta ||
      static_cast<int64_t>(cluster) * tiles_per_cta < tiles ||
      static_cast<int64_t>(cluster - 1) * tiles_per_cta >= tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      update(cluster, tiles_per_cta, w, r, alpha, out, n, stream));
}

// The large-n route: the unnormalized mode into out and partials
// [ceil(n / 1024)], then the second pass scales out in place.
int ignorance_update_large(const float* w, const float* r, const float* alpha,
                           float* out, float* partials, int64_t n,
                           cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = unnormalized(w, r, alpha, out, partials, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = num_tiles_of(n);
  ignorance_pass2<<<static_cast<unsigned>(tiles), kTile, 0, stream>>>(
      out, partials, n, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// out[n] = w * exp(alpha * (1 - r)); partials[ceil(n/1024)] = tile sums.
int ignorance_update_unnormalized(const float* w, const float* r,
                                  const float* alpha, float* out,
                                  float* partials, int64_t n,
                                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(unnormalized(w, r, alpha, out, partials, n, stream));
}

// The largest cluster ignorance_update may take on the current card: 16
// where the non-portable size is allowed and such a cluster of the largest
// CTA fits, else the portable 8.
int ignorance_max_cluster(int* out) {
  *out = kPortableCluster;
  const void* kernels[] = {
      reinterpret_cast<const void*>(ignorance_fused<true, 1>),
      reinterpret_cast<const void*>(ignorance_fused<true, 2>),
      reinterpret_cast<const void*>(ignorance_fused<true, 4>),
      reinterpret_cast<const void*>(ignorance_fused<true, 8>)};
  for (const void* k : kernels) {
    if (cudaFuncSetAttribute(
            k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
        cudaSuccess) {
      cudaGetLastError();
      return 0;  // the portable size stands
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1] = {cluster_attr(kMaxCluster)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, ignorance_fused<true, kMaxTilesPerCta>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (clusters >= 1) *out = kMaxCluster;
  return 0;
}

// An empty kernel on `cluster` CTAs of 32 threads, launched as a cluster of
// that size when it is above 1: the cost of a launch through this route.
int launch_floor(int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > kPortableCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kLanes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(cluster)};
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}

}  // extern "C"
