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
// Bound: it reads x and u and writes xhat, q and the scales once, 13 * n + 4
// * tiles bytes, at the H100's 3.35 TB/s; its arithmetic is a few float
// operations an element.  At the main path's sizes (10^4 .. 2 * 10^5
// elements) that is under a microsecond, so it is launch-bound: the two
// launches and the host call cost more than the bytes.  A simple, exact
// version first; fusing the passes (a last-block-done counter) or a CUDA
// graph around the hop is later work.
//
// Two launches, no atomics:
//   pass 1 (one block per chunk of at most 1024 elements inside one tile):
//     each block reduces |x| over its chunk to chunk_max[chunk];
//   pass 2 (the same grid): each block takes the max over its tile's chunks
//     (max is exact in any order, so the result does not depend on it),
//     forms the scale and writes its chunk of xhat and q; the tile's first
//     block writes the scale.
// Tiles need not be a multiple of 1024: the main path's sizes take one
// global tile (10500, 42000, 9000, 180000 elements), and block tiles are
// (1024 / k) * k elements (1020 for k = 10, 1023 for k = 3).  A chunk's
// lanes past its tile's end are masked.
//
// pack_int4 / unpack_int4: one thread per wire byte.  Byte i holds element
// 2i in the low nibble and 2i + 1 in the high one; an odd count pads the
// last high nibble with 0.  Unpacking sign-extends each nibble.  Both move
// about 1.5 bytes an element and are launch-bound at every size the path
// gives them.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launches (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;  // elements per block, one per thread
constexpr int kPackThreads = 256;

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

// xhat[n], q[n], scales[n / tile]; chunk_max is scratch of
// (n / tile) * ceil(tile / 1024) floats.  n must be a multiple of tile.
int quantize_dequant(const float* x, const float* u, float* xhat, int8_t* q,
                     float* scales, float* chunk_max, int64_t n, int64_t tile,
                     float qmax, float inv_qmax, cudaStream_t stream) {
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
