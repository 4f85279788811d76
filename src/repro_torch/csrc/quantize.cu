// Fused quantize-dequant and the int4 wire for the codecs, for Hopper
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
// The ranges as a device operand (quantize_dequant_qmax and its large-n
// twin): a sweep of sessions at different ranges (core/compiled.py,
// quant_sweep_run) quantizes every session's payload in one launch, each
// row of the flat batch at its own qmax, which no host value can carry
// under vmap.  The kernels above take their range as a Range<kRows>: by
// value (kRows false: qmax and its reciprocal, the plain codec path and
// the int4 encode), or a pointer to one float a row of tiles_per_row tiles
// (kRows true), where tile t reads its row's qmax and forms 1.0f / qmax
// itself, the correctly rounded quotient, which is the float32(1/qmax) the
// host passes by value.  The flag is a template parameter, so the by-value
// instantiations hold no device-range code and launch as before.
//
// The int4 wire.  Byte j holds element 2j in the low nibble and 2j + 1 in
// the high one; an odd count pads the last high nibble with 0; unpacking
// sign-extends each nibble.  pack_pair and unpack_word below are that
// arithmetic, and every kernel that packs or unpacks calls them, so the
// fused and the standalone paths cannot drift apart.
//   * Encode (quantize_pack_int4): the quantize kernels above with a second
//     epilogue, chosen at compile time (kPack), that writes the packed bytes
//     and the scales and nothing else: no xhat, no int8 q.  A share starts
//     on an even element of the payload (a multiple of 32 inside its tile,
//     and the tile starts on an even element when it is even or the
//     payload's only tile).  In quantize_fused a thread takes pairs of
//     elements, 2 (t + 512 j) and 2 (t + 512 j) + 1, read as 8-byte
//     vectors, and stores their byte itself; in the large route's
//     quantize_pass2 (a thread an element) one __shfl_xor_sync hands the
//     odd lane's nibble to the even lane.  8.5 bytes an element (0.107 us
//     at 42000).  A payload of several odd tiles (the [3069, 3] block,
//     tiles of 1023) has pairs that straddle two CTAs, and x or u off an
//     8-byte boundary (an offset view) cannot be read in pairs; either
//     takes the quantize-dequant and then the standalone pack, two
//     launches (no main-path payload is of that kind).
//   * Decode (unpack_dequant_int4): xhat[i] = float(nibble_i) *
//     scales[i / tile], one float32 product, as the reference's decode.
//     Thread g reads the 32-bit word of wire bytes [head + 4 g, head + 4 g +
//     4) (head: the bytes before the wire's first 4-byte boundary); a warp
//     writes its floats as dense float4 runs, each lane half a word that a
//     shuffle brings it; eight more threads take one byte each of the
//     ragged head and tail.  CTAs of 128 threads: 42 CTAs at 42000.
//     The tile of an element is a 32-bit division where it fits.  4.5
//     bytes an element (0.056 us at 42000).
//   * The decode of F payloads of an odd n each (unpack_dequant_int4_rows,
//     a fleet's hop through the vmap rule): each row's wire is ceil(n / 2)
//     bytes, its last high nibble padding, so a row starts on a byte but
//     the flat wire is no longer one payload's.  A thread an element reads
//     its byte at row f's stride, the same product.  (An even n decodes
//     the flat wire with the kernel above.)
//   * The standalone pack_int4 / unpack_int4 (the reference's ops): a thread
//     a wire byte.  1.5 bytes an element.  (A 32-bit word a thread, as the
//     decode reads it, ran 1 % and 5 % slower at 42000 on an H100: the
//     launch sets their time, not the loads.)
// All of them are launch-bound at every size the path gives them: the
// fused forms save the launches, and the bytes, of the separate passes.
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
constexpr int kPackThreads = 256;  // a CTA of the standalone pack/unpack
constexpr int kWireThreads = 128;  // a CTA of the int4 decode
constexpr unsigned kAll = 0xffffffffu;

// ------------------------------------------------ the int4 wire's nibbles
// The wire byte of two int4 values (any int carrier: two's complement
// bits) in the low byte, byte-parallel: byte k of the result packs byte k
// of lo (the low nibble) and of hi.
__device__ __forceinline__ uint32_t pack_pair(uint32_t lo, uint32_t hi) {
  return (lo & 0x0F0F0F0Fu) | ((hi & 0x0F0F0F0Fu) << 4);
}

// The 8 values of a word of wire bytes (element 2b in the low nibble of
// byte b, 2b + 1 in its high one) as sign-extended int8 bytes, elements
// 0..3 in .x and 4..7 in .y, byte-parallel: (v ^ 8) - 8 extends a nibble
// v, then the low and high nibbles interleave.
__device__ __forceinline__ uint2 unpack_word(uint32_t w) {
  const uint32_t even = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u,
                                0x08080808u);
  const uint32_t odd = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                               0x08080808u);
  return make_uint2(__byte_perm(even, odd, 0x5140),
                    __byte_perm(even, odd, 0x7362));
}

// Byte k of a word of int8 values, as an int.
__device__ __forceinline__ int byte_of(uint32_t word, int k) {
  return static_cast<int8_t>(static_cast<uint8_t>(word >> (8 * k)));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
  return m;
}

// The quantized value of one element, an integer-valued float.
__device__ __forceinline__ float quantize_one(float v, float draw,
                                              float scale, float qmax) {
  return fminf(fmaxf(floorf(v / scale + draw), -qmax), qmax);
}

// Offset k of a quantize thread's elements in its CTA's share: t + 512 k,
// or under kPack the pairs 2 (t + 512 j) and 2 (t + 512 j) + 1 (k = 2 j,
// 2 j + 1), so that one thread holds both nibbles of a wire byte.
template <bool kPack>
__device__ __forceinline__ int64_t share_offset(int k) {
  const int64_t t = threadIdx.x;
  if constexpr (kPack)
    return 2 * (t + static_cast<int64_t>(kThreads) * (k / 2)) + k % 2;
  else
    return t + static_cast<int64_t>(kThreads) * k;
}

// Elements off and off + 1 (off even) of a share at p, 8-byte aligned, as
// one vector load; past the share's end 0.  (A predicated vector load
// with a separate fix-up of an odd count's last element ran slower.)
__device__ __forceinline__ float2 load_pair(const float* __restrict__ p,
                                            int64_t off, int64_t count) {
  if (off + 1 < count) return *reinterpret_cast<const float2*>(p + off);
  return make_float2(off < count ? p[off] : 0.0f, 0.0f);
}

// i / tile, in 32-bit arithmetic where both fit: a 64-bit division is a
// long subroutine on the card.
__device__ __forceinline__ int64_t tile_of(int64_t i, int64_t tile) {
  if (i <= 0xffffffffll && tile <= 0xffffffffll)
    return static_cast<uint32_t>(i) / static_cast<uint32_t>(tile);
  return i / tile;
}

// A launch's range: qmax and its reciprocal by value, one for every tile.
template <bool kRows>
struct Range {
  float qmax, inv_qmax;
  __device__ __forceinline__ void of_tile(int64_t, float& qm,
                                          float& inv) const {
    qm = qmax;
    inv = inv_qmax;
  }
  bool fits(int64_t) const { return true; }
};

// The ranges as a device operand: rows[r] is the qmax of the r-th run of
// `tiles_per_row` tiles (a sweep's sessions, one a row).
template <>
struct Range<true> {
  const float* rows;
  int64_t tiles_per_row;
  // A 32-bit division: the launch holds at most 2^31 - 1 CTAs, so t and
  // tiles_per_row fit, and a 64-bit one is a subroutine call.
  __device__ __forceinline__ void of_tile(int64_t t, float& qm,
                                          float& inv) const {
    qm = rows[static_cast<uint32_t>(t) / static_cast<uint32_t>(tiles_per_row)];
    // nvcc's default -prec-div=true makes this the correctly rounded
    // quotient (kernels/_build.py passes no --use_fast_math, which would
    // make it an approximation): the host's float32(1) / float32(qmax) bit
    // for bit (kernels/quantize.py::inv_qmax)
    inv = 1.0f / qm;
  }
  bool fits(int64_t tiles) const {
    return rows != nullptr && tiles_per_row >= 1 &&
           tiles % tiles_per_row == 0;
  }
};

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
// tile)), thread t the elements t + 512 k, k < kK, of that share.  Under
// kPack, q is the packed wire and xhat is not written; thread t takes the
// pairs of elements 2 (t + 512 j) and 2 (t + 512 j) + 1 (share_offset),
// loaded as 8-byte vectors (x and u 8-byte aligned): the share starts on
// an even element of the payload, so a thread packs its own bytes.  (A
// warp shuffle of the odd lane's nibble to the even lane instead, with
// t + 512 k kept, spilled at kK = 32; pairs read by two scalar loads each
// ran slower at [18000, 10] on an H100.)
template <int kK, bool kCluster, bool kPack, bool kRows>
__global__ void __launch_bounds__(kThreads)
quantize_fused(const float* __restrict__ x, const float* __restrict__ u,
               float* __restrict__ xhat, int8_t* __restrict__ q,
               float* __restrict__ scales, int64_t tile, int64_t per_cta,
               Range<kRows> range) {
  static_assert(!(kPack && kRows), "the int4 encode takes its range by value");
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
  float qmax, inv_qmax;
  range.of_tile(t, qmax, inv_qmax);

  // x and the draws u, both loaded before the max; above 32 elements a
  // thread the draws wait for the quantize, within the register budget
  constexpr int kN = kPack ? 2 * ((kK + 1) / 2) : kK;   // elements a thread
  constexpr bool kEarlyU = kN <= kMaxPerThread / 2;
  float v[kN], d[kEarlyU ? kN : 1];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int64_t off = share_offset<kPack>(k);
    if constexpr (kPack) {
      if (k % 2 == 0) {
        const float2 a = load_pair(x + base, off, count);
        v[k] = a.x;
        v[k + 1] = a.y;
        if constexpr (kEarlyU) {
          const float2 b = load_pair(u + base, off, count);
          d[k] = b.x;
          d[k + 1] = b.y;
        }
      }
    } else {
      v[k] = off < count ? x[base + off] : 0.0f;
      if constexpr (kEarlyU) d[k] = off < count ? u[base + off] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) m = fmaxf(m, fabsf(v[k]));
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
  if constexpr (kPack) {
#pragma unroll
    for (int k = 0; k < kN; k += 2) {
      const int64_t off = share_offset<true>(k);
      if (off < count) {
        float2 draw;
        if constexpr (kEarlyU) draw = make_float2(d[k], d[k + 1]);
        else draw = load_pair(u + base, off, count);
        const int lo = static_cast<int>(quantize_one(v[k], draw.x, scale,
                                                     qmax));
        const int hi =   // past the end: an odd count's pad
            off + 1 < count
                ? static_cast<int>(quantize_one(v[k + 1], draw.y, scale,
                                                qmax))
                : 0;
        q[(base + off) >> 1] = static_cast<int8_t>(pack_pair(lo, hi));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int64_t off = share_offset<false>(k);
      if (off < count) {
        const int64_t i = base + off;
        float draw;
        if constexpr (kEarlyU) draw = d[k];
        else draw = u[i];
        const float c = quantize_one(v[k], draw, scale, qmax);
        xhat[i] = c * scale;
        q[i] = static_cast<int8_t>(c);
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) scales[t] = scale;
}

template <int kK, bool kCluster, bool kPack, bool kRows>
cudaError_t launch_fused(int64_t ctas, int cluster, const float* x,
                         const float* u, float* xhat, int8_t* q,
                         float* scales, int64_t tile, int64_t per_cta,
                         Range<kRows> range, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, quantize_fused<kK, kCluster, kPack, kRows>,
                            x, u, xhat, q, scales, tile, per_cta, range);
}

template <bool kCluster, bool kPack, bool kRows>
cudaError_t dispatch(int64_t ctas, int cluster, const float* x,
                     const float* u, float* xhat, int8_t* q, float* scales,
                     int64_t tile, int64_t per_cta, Range<kRows> range,
                     cudaStream_t stream) {
  const int64_t k = (per_cta + kThreads - 1) / kThreads;
#define QUANTIZE_CASE(K)                                                    \
  if (k <= K)                                                               \
    return launch_fused<K, kCluster, kPack, kRows>(                         \
        ctas, cluster, x, u, xhat, q, scales, tile, per_cta, range, stream);
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

template <bool kPack, bool kRows>
cudaError_t set_nonportable_for() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(quantize_fused<1, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<2, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<4, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<8, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<16, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<32, true, kPack, kRows>),
      reinterpret_cast<const void*>(quantize_fused<64, true, kPack, kRows>)};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t set_nonportable() {
  cudaError_t err = set_nonportable_for<false, false>();
  if (err == cudaSuccess) err = set_nonportable_for<true, false>();
  return err != cudaSuccess ? err : set_nonportable_for<false, true>();
}

// quantize_fused over n / tile tiles, after the checks of the plan.
template <bool kPack, bool kRows>
int quantize_launch(const float* x, const float* u, float* xhat, int8_t* q,
                    float* scales, int64_t n, int64_t tile, int cluster,
                    int64_t per_cta, Range<kRows> range,
                    cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0 || cluster < 1 ||
      !range.fits(n / tile) || cluster > kMaxCluster || per_cta < 1 ||
      per_cta > static_cast<int64_t>(kThreads) * kMaxPerThread ||
      cluster * per_cta < tile || (cluster - 1) * per_cta >= tile ||
      (kPack && ((cluster > 1 && per_cta % 2 != 0) ||
                 (tile % 2 != 0 && n != tile))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kPack && (reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
                reinterpret_cast<uintptr_t>(u) % 8 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t ctas = (n / tile) * cluster;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cluster > 1
          ? dispatch<true, kPack, kRows>(ctas, cluster, x, u, xhat, q, scales,
                                         tile, per_cta, range, stream)
          : dispatch<false, kPack, kRows>(ctas, 1, x, u, xhat, q, scales,
                                          tile, per_cta, range, stream);
  return static_cast<int>(err);
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

// Under kPack, q is the packed wire and xhat is not written: element i of
// the chunk sits in lane i % 32 (the tile starts on an even element), so
// one shuffle hands the odd lane's nibble to the even lane, which stores
// the byte.
template <bool kPack, bool kRows>
__global__ void __launch_bounds__(kChunk)
quantize_pass2(const float* __restrict__ x, const float* __restrict__ u,
               const float* __restrict__ chunk_max, float* __restrict__ xhat,
               int8_t* __restrict__ q, float* __restrict__ scales,
               int64_t tile, int64_t chunks_per_tile, Range<kRows> range) {
  static_assert(!(kPack && kRows), "the int4 encode takes its range by value");
  __shared__ float sm[kChunk];
  const int64_t t = blockIdx.x / chunks_per_tile;
  const int64_t c = blockIdx.x % chunks_per_tile;
  float qmax, inv_qmax;
  range.of_tile(t, qmax, inv_qmax);
  float m = 0.0f;
  for (int64_t j = threadIdx.x; j < chunks_per_tile; j += kChunk)
    m = fmaxf(m, chunk_max[t * chunks_per_tile + j]);
  sm[threadIdx.x] = m;
  __syncthreads();
  chunk_tree_max(sm);
  const float scale = fmaxf(sm[0], 1e-12f) * inv_qmax;
  const int64_t off = c * kChunk + threadIdx.x;
  const int64_t i = t * tile + off;
  const bool in = off < tile;
  const float v = in ? quantize_one(x[i], u[i], scale, qmax) : 0.0f;
  if constexpr (kPack) {
    const int odd = __shfl_xor_sync(kAll, static_cast<int>(v), 1);
    if (in && (threadIdx.x & 1) == 0)
      q[i >> 1] = static_cast<int8_t>(pack_pair(static_cast<int>(v), odd));
  } else if (in) {
    xhat[i] = v * scale;
    q[i] = static_cast<int8_t>(v);
  }
  if (c == 0 && threadIdx.x == 0) scales[t] = scale;
}

template <bool kPack, bool kRows>
int quantize_large_launch(const float* x, const float* u, float* xhat,
                          int8_t* q, float* scales, float* chunk_max,
                          int64_t n, int64_t tile, Range<kRows> range,
                          cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0 || !range.fits(n / tile) ||
      (kPack && tile % 2 != 0 && n != tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks_per_tile = (tile + kChunk - 1) / kChunk;
  const int64_t blocks = (n / tile) * chunks_per_tile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quantize_pass1<<<static_cast<unsigned>(blocks), kChunk, 0, stream>>>(
      x, chunk_max, tile, chunks_per_tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_pass2<kPack, kRows><<<static_cast<unsigned>(blocks), kChunk, 0,
                                 stream>>>(x, u, chunk_max, xhat, q, scales,
                                           tile, chunks_per_tile, range);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ the int4 wire's kernels
// Standalone pack: thread j packs wire byte j from q[2 j] and q[2 j + 1],
// the last high nibble of an odd m padded with 0.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ packed,
            int64_t m) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPackThreads +
                    threadIdx.x;
  if (j >= (m + 1) / 2) return;
  const uint32_t even = static_cast<uint8_t>(q[2 * j]);
  const uint32_t odd =
      2 * j + 1 < m ? static_cast<uint8_t>(q[2 * j + 1]) : 0u;
  packed[j] = static_cast<int8_t>(pack_pair(even, odd));
}

// Standalone unpack: thread j unpacks wire byte j into q[2 j] and, below n,
// q[2 j + 1].
__global__ void __launch_bounds__(kPackThreads)
unpack_kernel(const int8_t* __restrict__ packed, int8_t* __restrict__ q,
              int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPackThreads +
                    threadIdx.x;
  if (j >= (n + 1) / 2) return;
  const uint32_t v = unpack_word(static_cast<uint8_t>(packed[j])).x;
  q[2 * j] = static_cast<int8_t>(byte_of(v, 0));
  if (2 * j + 1 < n) q[2 * j + 1] = static_cast<int8_t>(byte_of(v, 1));
}

// The wire byte of edge thread g >= words of unpack_dequant_kernel (the
// head [0, head) for g - words < 4, else the tail [head + 4 words, ceil(n /
// 2))), or -1.
__device__ __forceinline__ int64_t edge_byte(int64_t g, int64_t words,
                                             int64_t head, int64_t n) {
  const int64_t e = g - words;
  const int64_t j =
      e < 0 ? -1 : e < 4 ? (e < head ? e : -1) : head + 4 * words + e - 4;
  return j < (n + 1) / 2 ? j : -1;
}

// Unpack and dequantize: xhat[i] = float(nibble_i) * scales[i / tile].
// Thread g < words reads the word of wire bytes [head + 4 g, head + 4 g +
// 4), elements 2 head + 8 g .. + 8; threads words + e, e < 8, one byte
// each: of the head [0, head) for e < 4, else of the tail [head + 4 words,
// ceil(n / 2)).  A warp stores its words' floats as two dense runs: in run
// s, lane l takes half l % 2 (4 elements) of the word of lane 16 s + l / 2,
// fetched by a shuffle, and stores it as a float4 (head even; else two
// float2), so that lanes write consecutive 16 bytes.  Every load a thread
// makes (its word or byte, and the scales of the elements it stores) is
// issued before any is waited for, one round trip to memory: a payload of
// one tile (kOneTile, every main-path payload) has one scale and no
// division; else a run of 4 elements lies in at most two tiles where tile
// >= 4, whose scales are loaded up front (a tile of 1 to 3 elements, which
// no codec gives, loads each element's as it stores it).
template <bool kOneTile>
__global__ void __launch_bounds__(kWireThreads)
unpack_dequant_kernel(const int8_t* __restrict__ packed,
                      const float* __restrict__ scales,
                      float* __restrict__ xhat, int64_t n, int64_t tile,
                      int64_t head, int64_t words) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWireThreads +
                    threadIdx.x;
  const int64_t j = edge_byte(g, words, head, n);
  const bool edge = j >= 0;
  // every lane of a warp takes the runs' shuffles
  const uint32_t word =
      g < words ? reinterpret_cast<const uint32_t*>(packed + head)[g] : 0u;
  const uint32_t b = edge ? static_cast<uint8_t>(packed[j]) : 0u;
  const int lane = threadIdx.x % kLanes;
  const int half = lane % 2;
  int64_t gs[2], i[2], split[2];
  float lo[2], hi[2], edge_scale[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {         // the runs' words and scales
    gs[s] = g - lane + kLanes / 2 * s + lane / 2;
    i[s] = 2 * head + 8 * gs[s] + 4 * half;
    if constexpr (kOneTile) {
      lo[s] = hi[s] = edge_scale[s] = scales[0];
      split[s] = n;
    } else {
      const int64_t t = tile_of(i[s], tile);
      split[s] = (t + 1) * tile;
      lo[s] = gs[s] < words ? scales[t] : 0.0f;
      hi[s] = gs[s] < words && i[s] + 3 >= split[s] ? scales[t + 1] : lo[s];
      edge_scale[s] = edge && 2 * j + s < n ? scales[tile_of(2 * j + s, tile)]
                                            : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint2 v =
        unpack_word(__shfl_sync(kAll, word, kLanes / 2 * s + lane / 2));
    const uint32_t quad = half ? v.y : v.x;     // elements 4 half .. + 4
    if (gs[s] >= words) continue;
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float scale = kOneTile || tile >= 4
                              ? (i[s] + k < split[s] ? lo[s] : hi[s])
                              : scales[tile_of(i[s] + k, tile)];
      out[k] = static_cast<float>(byte_of(quad, k)) * scale;
    }
    if (head % 2 == 0) {
      *reinterpret_cast<float4*>(xhat + i[s]) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
      float2* dst = reinterpret_cast<float2*>(xhat + i[s]);
      dst[0] = make_float2(out[0], out[1]);
      dst[1] = make_float2(out[2], out[3]);
    }
  }
  if (edge) {
    const uint32_t v = unpack_word(b).x;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (2 * j + h < n)
        xhat[2 * j + h] = static_cast<float>(byte_of(v, h)) * edge_scale[h];
  }
}

// xhat[f, i] = float(nibble) * scales[f, i / tile] for the rows of a
// [rows, ceil(n / 2)] wire: a thread an element.
__global__ void __launch_bounds__(kPackThreads)
unpack_dequant_rows_kernel(const int8_t* __restrict__ packed,
                           const float* __restrict__ scales,
                           float* __restrict__ xhat, int64_t rows, int64_t n,
                           int64_t tile) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kPackThreads +
                    threadIdx.x;
  if (g >= rows * n) return;
  const int64_t f = g / n;
  const int64_t i = g - f * n;
  const uint32_t v =
      unpack_word(static_cast<uint8_t>(packed[f * ((n + 1) / 2) + i / 2])).x;
  xhat[g] = static_cast<float>(byte_of(v, static_cast<int>(i % 2))) *
            scales[f * (n / tile) + tile_of(i, tile)];
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
  return quantize_launch<false, false>(x, u, xhat, q, scales, n, tile,
                                       cluster, per_cta, {qmax, inv_qmax},
                                       stream);
}

// quantize_dequant with the ranges on the device: qmax_rows[n / tile /
// tiles_per_row] floats, the range of each row of tiles_per_row tiles (a
// sweep's sessions, one a row), each reciprocal formed in the kernel.
int quantize_dequant_qmax(const float* x, const float* u, float* xhat,
                          int8_t* q, float* scales, int64_t n, int64_t tile,
                          int cluster, int64_t per_cta,
                          const float* qmax_rows, int64_t tiles_per_row,
                          cudaStream_t stream) {
  return quantize_launch<false, true>(x, u, xhat, q, scales, n, tile,
                                      cluster, per_cta,
                                      {qmax_rows, tiles_per_row}, stream);
}

// The int4 encode in one launch: packed[ceil(n / 2)] and scales[n / tile],
// as quantize_dequant plans it; the tile must be even or the payload's
// only tile.
int quantize_pack_int4(const float* x, const float* u, int8_t* packed,
                       float* scales, int64_t n, int64_t tile, int cluster,
                       int64_t per_cta, float qmax, float inv_qmax,
                       cudaStream_t stream) {
  return quantize_launch<true, false>(x, u, nullptr, packed, scales, n, tile,
                                      cluster, per_cta, {qmax, inv_qmax},
                                      stream);
}

// The large-n route, two launches: xhat[n], q[n], scales[n / tile];
// chunk_max is scratch of (n / tile) * ceil(tile / 1024) floats.
int quantize_dequant_large(const float* x, const float* u, float* xhat,
                           int8_t* q, float* scales, float* chunk_max,
                           int64_t n, int64_t tile, float qmax,
                           float inv_qmax, cudaStream_t stream) {
  return quantize_large_launch<false, false>(x, u, xhat, q, scales,
                                             chunk_max, n, tile,
                                             {qmax, inv_qmax}, stream);
}

// quantize_dequant_large with the ranges on the device, as
// quantize_dequant_qmax takes them.
int quantize_dequant_qmax_large(const float* x, const float* u, float* xhat,
                                int8_t* q, float* scales, float* chunk_max,
                                int64_t n, int64_t tile,
                                const float* qmax_rows, int64_t tiles_per_row,
                                cudaStream_t stream) {
  return quantize_large_launch<false, true>(x, u, xhat, q, scales,
                                            chunk_max, n, tile,
                                            {qmax_rows, tiles_per_row},
                                            stream);
}

// The int4 encode on the large-n route: packed[ceil(n / 2)], scales[n /
// tile], the same scratch; the tile must be even or the only one.
int quantize_pack_int4_large(const float* x, const float* u, int8_t* packed,
                             float* scales, float* chunk_max, int64_t n,
                             int64_t tile, float qmax, float inv_qmax,
                             cudaStream_t stream) {
  return quantize_large_launch<true, false>(x, u, nullptr, packed, scales,
                                            chunk_max, n, tile,
                                            {qmax, inv_qmax}, stream);
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
  if (cudaOccupancyMaxActiveClusters(
          &clusters, quantize_fused<kMaxPerThread, true, false, false>,
          &cfg) !=
      cudaSuccess) {
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

// The int4 decode in one launch: xhat[n] = float(nibble) * scales[i /
// tile] from packed[ceil(n / 2)] and scales[n / tile]; xhat must be
// 16-byte aligned.
int unpack_dequant_int4(const int8_t* packed, const float* scales,
                        float* xhat, int64_t n, int64_t tile,
                        cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a fresh tensor: its float4 stores must be aligned
  if (reinterpret_cast<uintptr_t>(xhat) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t full = n / 2;    // bytes that hold two elements
  const int64_t misaligned = static_cast<int64_t>(
      (4 - reinterpret_cast<uintptr_t>(packed) % 4) % 4);
  const int64_t head = misaligned < full ? misaligned : full;
  const int64_t words = (full - head) / 4;
  const unsigned grid = grid_for(words + 8, kWireThreads);
  if (tile == n)           // a payload of one tile
    unpack_dequant_kernel<true><<<grid, kWireThreads, 0, stream>>>(
        packed, scales, xhat, n, tile, head, words);
  else
    unpack_dequant_kernel<false><<<grid, kWireThreads, 0, stream>>>(
        packed, scales, xhat, n, tile, head, words);
  return static_cast<int>(cudaGetLastError());
}

// The int4 decode of `rows` payloads of n values each: xhat[rows, n] from
// packed[rows, ceil(n / 2)] and scales[rows, n / tile], one launch.
int unpack_dequant_int4_rows(const int8_t* packed, const float* scales,
                             float* xhat, int64_t rows, int64_t n,
                             int64_t tile, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || tile <= 0 || n % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unpack_dequant_rows_kernel<<<grid_for(rows * n, kPackThreads),
                               kPackThreads, 0, stream>>>(
      packed, scales, xhat, rows, n, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
