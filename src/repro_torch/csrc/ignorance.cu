// Ignorance-score update (paper eqs. 10/12) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ignorance.py::ignorance_update_unnormalized (its body
// `_kernel`) and the normalizer of src/repro/kernels/ops.py::ignorance_update:
//
//     w_new = w * exp(alpha * (1 - r));   w <- w_new / max(sum(w_new), 1e-12)
//
// Bound: the function reads w and r and writes w once, 12 * n bytes, at the
// H100's 3.35 TB/s; its arithmetic (one double-precision exp per element)
// stays below the card's float64 rate.  So it is memory- and launch-bound: at
// the main path's sizes (n of 10^4 .. 10^5) the two launches cost more than
// the bytes.
// This first version is simple and deterministic; making it fast (one
// launch, a CUDA graph around the hop) is work for later changes.
//
// Two launches, no atomics, a fixed reduction order:
//   pass 1 (grid ceil(n/1024)): each block computes its tile of w_new,
//     stores it, and reduces the tile in a fixed tree order to partials[tile];
//   pass 2 (same grid): each block sums the partials in the same fixed order
//     (thread t accumulates partials t, t+1024, ... then the tree), clamps the
//     total at 1e-12 and scales its tile in place.
// Every block therefore divides by the same total, and a run gives the same
// bits every time, which bit-exact checkpoint resume rests on.  The ragged
// last tile is masked: lanes past n contribute 0.  alpha is read from device
// memory, so a launch needs no host sync.  The exponential is taken in double
// and rounded to float (no fast-math): a float expf differs by an ulp between
// CUDA's and the CPU's libraries, and the rounded double is the same on both,
// so the card's hop equals the plain version's on the CPU.  The plain PyTorch
// version in kernels/ignorance.py mirrors this arithmetic and order.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launch (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // elements per block, one per thread

// In-place tree sum of sm[0..kTile) into sm[0]: step s adds sm[t + s] into
// sm[t] for t < s, halving s from kTile/2 to 1.
__device__ __forceinline__ void tile_tree_sum(float* sm) {
#pragma unroll 1
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm[threadIdx.x] += sm[threadIdx.x + s];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTile)
ignorance_pass1(const float* __restrict__ w, const float* __restrict__ r,
                const float* __restrict__ alpha, float* __restrict__ out,
                float* __restrict__ partials, int64_t n) {
  __shared__ float sm[kTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const float a = __ldg(alpha);
  float v = 0.0f;
  if (i < n) {
    v = w[i] * static_cast<float>(exp(static_cast<double>(a * (1.0f - r[i]))));
    out[i] = v;
  }
  sm[threadIdx.x] = v;
  __syncthreads();
  tile_tree_sum(sm);
  if (threadIdx.x == 0) partials[blockIdx.x] = sm[0];
}

__global__ void __launch_bounds__(kTile)
ignorance_pass2(float* __restrict__ out, const float* __restrict__ partials,
                int64_t n, int num_tiles) {
  __shared__ float sm[kTile];
  float acc = 0.0f;
  for (int j = threadIdx.x; j < num_tiles; j += kTile) acc += partials[j];
  sm[threadIdx.x] = acc;
  __syncthreads();
  tile_tree_sum(sm);
  const float total = fmaxf(sm[0], 1e-12f);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i < n) out[i] = out[i] / total;
}

int num_tiles_of(int64_t n) { return static_cast<int>((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// out[n] = w * exp(alpha * (1 - r)); partials[ceil(n/1024)] = tile sums.
int ignorance_update_unnormalized(const float* w, const float* r,
                                  const float* alpha, float* out,
                                  float* partials, int64_t n,
                                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ignorance_pass1<<<num_tiles_of(n), kTile, 0, stream>>>(w, r, alpha, out,
                                                         partials, n);
  return static_cast<int>(cudaGetLastError());
}

// out[n] /= max(sum(partials), 1e-12), in place.
int ignorance_normalize(float* out, const float* partials, int64_t n,
                        cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = num_tiles_of(n);
  ignorance_pass2<<<tiles, kTile, 0, stream>>>(out, partials, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
