// Fused quantize-dequant and int4 packing for the wire codecs, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   quantize_dequant_tiles and quantize_dequant_block (one body, `_kernel`),
//   pack_int4 (`_pack_kernel`) and unpack_int4 (`_unpack_kernel`).
//
// quantize_dequant, per tile of `tile` contiguous elements of a flat payload
// (a length-n vector, or an [n, k] row-major block whose tiles are
// rows_for(n, k) * k elements):
//
//     scale = fmaxf(max|x|, 1e-12f) * inv_qmax        (inv_qmax = f32(1/qmax))
//     q     = fminf(fmaxf(floorf(x / scale + u), -qmax), qmax)
//     xhat  = q * scale,  q stored as int8
//
// The reciprocal product and the IEEE division match the reference's
// channel bit for bit (its compiler folds the division by a constant qmax
// into that product; x / scale stays a division).  No fast-math: `/` is the
// correctly rounded division, and no product here can contract into an FMA.
//
// What bounds it on this card: it reads x and u and writes xhat, q and the
// scales once, 13 * n + 4 * tiles bytes (0.16 us at n = 42000 at the H100's
// 3.35 TB/s); its arithmetic is a few float operations an element.  At the
// main path's sizes (10^4 .. 2 * 10^5 elements) a launch and a round trip to
// device memory cost far more than the bytes, so the design spends one
// launch a call and keeps x on chip between the max and the quantize: u is
// read once, xhat and q written once, no scratch.
//
// quantize_dequant (one launch, no atomics): a tile is taken by `cluster`
// CTAs of 512 threads, each CTA a contiguous share of `per_cta` elements,
// thread t elements t + 512 k of its share, kept in registers (512 threads
// measured faster than 1024 at the main path's shapes):
//   * tiles of at most 1024 elements (the 1024-tiles of a vector, the ragged
//     row tiles of 1020 and 1023): one CTA a tile; the CTA's max goes through
//     its shared memory (every warp reduces the warps' maxima);
//   * a larger tile, which is every main-path payload (one global tile of
//     10500, 42000, 9000 or 180000 elements): one cluster of up to 16 CTAs a
//     tile (8 is portable, 16 where quantize_max_cluster found that it
//     fits); each CTA reduces |x| over its share and stores its max into
//     every CTA's shared memory through distributed shared memory
//     (map_shared_rank; a cluster barrier that each CTA arrives at as it
//     starts makes sure the others have started), then cluster.sync(), and
//     each warp takes the max of the maxima in its own CTA's memory.  A max
//     is exact in any order, so every CTA forms the same scale, and no CTA
//     touches another's memory after the barrier.
// x and u are loaded together before the max (one round trip to device
// memory; above 32 elements a thread u waits for the quantize); then each
// thread quantizes its registers and the tile's first CTA writes the scale.
// A thread holds at most 64 elements, so a cluster of 8 covers a tile of
// 2^18.  A larger tile takes the large-n route: two launches
// (quantize_pass1 reduces each 1024-chunk to chunk_max scratch,
// quantize_pass2 takes its tile's max over the chunks and quantizes), which
// spread the bytes over the whole card.  The wrapper decides the route on
// the tile alone (kernels/quantize.py, LARGE_TILE).
//
// pack_int4 / unpack_int4: one thread per wire byte.  Byte i holds element
// 2i in the low nibble and 2i + 1 in the high one; an odd count pads the
// last high nibble with 0.  Unpacking sign-extends each nibble.  Both move
// about 1.5 bytes an element and are launch-bound at every size the path
// gives them.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launches (0 on success).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 1024;  // the large-n route's elements per block
constexpr int kThreads = 512;  // a quantize CTA
constexpr int kLanes = 32;
constexpr int kWarpsQ = kThreads / kLanes;
constexpr int kMaxPerThread = 64;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kPackThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
  return m;
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

// One tile per `cluster` consecutive CTAs (kCluster), or per CTA; rank c of
// a tile's CTAs takes its elements [c * per_cta, min((c + 1) * per_cta,
// tile)), thread t the elements t + 512 k, k < kK, of that share.
template <int kK, bool kCluster>
__global__ void __launch_bounds__(kThreads)
quantize_fused(const float* __restrict__ x, const float* __restrict__ u,
               float* __restrict__ xhat, int8_t* __restrict__ q,
               float* __restrict__ scales, int64_t tile, int64_t per_cta,
               float qmax, float inv_qmax) {
  __shared__ float warp_maxima[kWarpsQ];
  __shared__ float cta_maxima[kCluster ? kMaxCluster : 1];  // by rank
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  int rank = 0, ctas = 1;
  if constexpr (kCluster) {
    cluster_arrive();
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    ctas = static_cast<int>(cluster.num_blocks());
  }
  const int64_t t = blockIdx.x / ctas;
  const int64_t lo = rank * per_cta;
  const int64_t count = min(per_cta, tile - lo);
  const int64_t base = t * tile + lo;

  // x and the draws u, both loaded before the max; above 32 elements a
  // thread the draws wait for the quantize, within the register budget
  constexpr bool kEarlyU = kK <= kMaxPerThread / 2;
  float v[kK], d[kEarlyU ? kK : 1];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int64_t off = threadIdx.x + static_cast<int64_t>(kThreads) * k;
    v[k] = off < count ? x[base + off] : 0.0f;
    if constexpr (kEarlyU) d[k] = off < count ? u[base + off] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) m = fmaxf(m, fabsf(v[k]));
  m = warp_max(m);
  if (lane == 0) warp_maxima[warp] = m;
  __syncthreads();
  m = warp_max(lane < kWarpsQ ? warp_maxima[lane] : 0.0f);   // the CTA's
  float tile_max = m;
  if constexpr (kCluster) {
    // Push: lane c of warp 0 stores this CTA's max into CTA c's
    // cta_maxima[rank], so that after the barrier every CTA holds every
    // CTA's max in its own memory.
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    if (warp == 0 && lane < ctas)
      *cluster.map_shared_rank(&cta_maxima[rank], lane) = m;
    cluster.sync();
    tile_max = warp_max(lane < ctas ? cta_maxima[lane] : 0.0f);
  }
  const float scale = fmaxf(tile_max, 1e-12f) * inv_qmax;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int64_t off = threadIdx.x + static_cast<int64_t>(kThreads) * k;
    if (off < count) {
      const int64_t i = base + off;
      float draw;
      if constexpr (kEarlyU) draw = d[k];
      else draw = u[i];
      const float c = fminf(fmaxf(floorf(v[k] / scale + draw), -qmax), qmax);
      xhat[i] = c * scale;
      q[i] = static_cast<int8_t>(c);
    }
  }
  if (rank == 0 && threadIdx.x == 0) scales[t] = scale;
}

template <int kK, bool kCluster>
cudaError_t launch_fused(int64_t ctas, int cluster, const float* x,
                         const float* u, float* xhat, int8_t* q,
                         float* scales, int64_t tile, int64_t per_cta,
                         float qmax, float inv_qmax, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, quantize_fused<kK, kCluster>, x, u, xhat,
                            q, scales, tile, per_cta, qmax, inv_qmax);
}

template <bool kCluster>
cudaError_t dispatch(int64_t ctas, int cluster, const float* x,
                     const float* u, float* xhat, int8_t* q, float* scales,
                     int64_t tile, int64_t per_cta, float qmax,
                     float inv_qmax, cudaStream_t stream) {
  const int64_t k = (per_cta + kThreads - 1) / kThreads;
#define QUANTIZE_CASE(K)                                                    \
  if (k <= K)                                                               \
    return launch_fused<K, kCluster>(ctas, cluster, x, u, xhat, q, scales,  \
                                     tile, per_cta, qmax, inv_qmax, stream);
  QUANTIZE_CASE(1)
  QUANTIZE_CASE(2)
  QUANTIZE_CASE(4)
  QUANTIZE_CASE(8)
  QUANTIZE_CASE(16)
  QUANTIZE_CASE(32)
  QUANTIZE_CASE(64)
#undef QUANTIZE_CASE
  return cudaErrorInvalidValue;
}

cudaError_t set_nonportable() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(quantize_fused<1, true>),
      reinterpret_cast<const void*>(quantize_fused<2, true>),
      reinterpret_cast<const void*>(quantize_fused<4, true>),
      reinterpret_cast<const void*>(quantize_fused<8, true>),
      reinterpret_cast<const void*>(quantize_fused<16, true>),
      reinterpret_cast<const void*>(quantize_fused<32, true>),
      reinterpret_cast<const void*>(quantize_fused<64, true>)};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// In-place max of sm[0..kChunk) into sm[0].
__device__ __forceinline__ void chunk_tree_max(float* sm) {
#pragma unroll 1
  for (int s = kChunk / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm[threadIdx.x] = fmaxf(sm[threadIdx.x],
                                                 sm[threadIdx.x + s]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kChunk)
quantize_pass1(const float* __restrict__ x, float* __restrict__ chunk_max,
               int64_t tile, int64_t chunks_per_tile) {
  __shared__ float sm[kChunk];
  const int64_t t = blockIdx.x / chunks_per_tile;
  const int64_t c = blockIdx.x % chunks_per_tile;
  const int64_t off = c * kChunk + threadIdx.x;     // offset inside the tile
  float v = 0.0f;
  if (off < tile) v = fabsf(x[t * tile + off]);
  sm[threadIdx.x] = v;
  __syncthreads();
  chunk_tree_max(sm);
  if (threadIdx.x == 0) chunk_max[blockIdx.x] = sm[0];
}

__global__ void __launch_bounds__(kChunk)
quantize_pass2(const float* __restrict__ x, const float* __restrict__ u,
               const float* __restrict__ chunk_max, float* __restrict__ xhat,
               int8_t* __restrict__ q, float* __restrict__ scales,
               int64_t tile, int64_t chunks_per_tile, float qmax,
               float inv_qmax) {
  __shared__ float sm[kChunk];
  const int64_t t = blockIdx.x / chunks_per_tile;
  const int64_t c = blockIdx.x % chunks_per_tile;
  float m = 0.0f;
  for (int64_t j = threadIdx.x; j < chunks_per_tile; j += kChunk)
    m = fmaxf(m, chunk_max[t * chunks_per_tile + j]);
  sm[threadIdx.x] = m;
  __syncthreads();
  chunk_tree_max(sm);
  const float scale = fmaxf(sm[0], 1e-12f) * inv_qmax;
  const int64_t off = c * kChunk + threadIdx.x;
  if (off < tile) {
    const int64_t i = t * tile + off;
    const float v = fminf(fmaxf(floorf(x[i] / scale + u[i]), -qmax), qmax);
    xhat[i] = v * scale;
    q[i] = static_cast<int8_t>(v);
  }
  if (c == 0 && threadIdx.x == 0) scales[t] = scale;
}

__global__ void pack_kernel(const int8_t* __restrict__ q,
                            int8_t* __restrict__ packed, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= (m + 1) / 2) return;
  const unsigned lo = static_cast<uint8_t>(q[2 * i]) & 0x0Fu;
  const unsigned hi =
      2 * i + 1 < m ? static_cast<uint8_t>(q[2 * i + 1]) & 0x0Fu : 0u;
  packed[i] = static_cast<int8_t>(static_cast<uint8_t>(lo | (hi << 4)));
}

__global__ void unpack_kernel(const int8_t* __restrict__ packed,
                              int8_t* __restrict__ q, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= (n + 1) / 2) return;
  const uint8_t b = static_cast<uint8_t>(packed[i]);
  // move the low nibble to the top, then shift back arithmetically
  const int lo = static_cast<int>(static_cast<int8_t>(
                     static_cast<uint8_t>(b << 4))) >> 4;
  const int hi = static_cast<int>(static_cast<int8_t>(b)) >> 4;
  q[2 * i] = static_cast<int8_t>(lo);
  if (2 * i + 1 < n) q[2 * i + 1] = static_cast<int8_t>(hi);
}

unsigned grid_for(int64_t items, int threads) {
  return static_cast<unsigned>((items + threads - 1) / threads);
}

}  // namespace

extern "C" {

// xhat[n], q[n], scales[n / tile] in one launch: each tile taken by
// `cluster` CTAs of `per_cta` elements (kernels/quantize.py::plan), a
// cluster launch when `cluster` is above 1.  n must be a multiple of tile,
// the shares must cover the tile with none empty, at most 64 elements a
// thread.
int quantize_dequant(const float* x, const float* u, float* xhat, int8_t* q,
                     float* scales, int64_t n, int64_t tile, int cluster,
                     int64_t per_cta, float qmax, float inv_qmax,
                     cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0 || cluster < 1 ||
      cluster > kMaxCluster || per_cta < 1 ||
      per_cta > static_cast<int64_t>(kThreads) * kMaxPerThread ||
      cluster * per_cta < tile || (cluster - 1) * per_cta >= tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = (n / tile) * cluster;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cluster > 1
          ? dispatch<true>(ctas, cluster, x, u, xhat, q, scales, tile,
                           per_cta, qmax, inv_qmax, stream)
          : dispatch<false>(ctas, 1, x, u, xhat, q, scales, tile, per_cta,
                            qmax, inv_qmax, stream);
  return static_cast<int>(err);
}

// The large-n route, two launches: xhat[n], q[n], scales[n / tile];
// chunk_max is scratch of (n / tile) * ceil(tile / 1024) floats.
int quantize_dequant_large(const float* x, const float* u, float* xhat,
                           int8_t* q, float* scales, float* chunk_max,
                           int64_t n, int64_t tile, float qmax,
                           float inv_qmax, cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks_per_tile = (tile + kChunk - 1) / kChunk;
  const int64_t blocks = (n / tile) * chunks_per_tile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quantize_pass1<<<static_cast<unsigned>(blocks), kChunk, 0, stream>>>(
      x, chunk_max, tile, chunks_per_tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_pass2<<<static_cast<unsigned>(blocks), kChunk, 0, stream>>>(
      x, u, chunk_max, xhat, q, scales, tile, chunks_per_tile, qmax,
      inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

// The largest cluster quantize_dequant may take on the current card: 16
// where the non-portable size is allowed and such a cluster of the widest
// CTA fits, else the portable 8.
int quantize_max_cluster(int* out) {
  *out = kPortableCluster;
  if (set_nonportable() != cudaSuccess) {
    cudaGetLastError();
    return 0;  // the portable size stands
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters,
                                     quantize_fused<kMaxPerThread, true>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (clusters >= 1) *out = kMaxCluster;
  return 0;
}

// packed[ceil(m / 2)] from q[m].
int pack_int4(const int8_t* q, int8_t* packed, int64_t m,
              cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<grid_for((m + 1) / 2, kPackThreads), kPackThreads, 0,
                stream>>>(q, packed, m);
  return static_cast<int>(cudaGetLastError());
}

// q[n] from packed[ceil(n / 2)].
int unpack_int4(const int8_t* packed, int8_t* q, int64_t n,
                cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  unpack_kernel<<<grid_for((n + 1) / 2, kPackThreads), kPackThreads, 0,
                  stream>>>(packed, q, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
