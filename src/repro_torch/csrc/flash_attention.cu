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
// As in the reference, masked scores are -1e30, not -inf: a row whose keys
// in a live tile are all masked takes p = exp(0) = 1 there, and the rescale
// by exp(-1e30 - m) = 0 at its first real key wipes that out (with -inf the
// row would become NaN).  The denominator is clamped at 1e-30.  Only the KV
// tiles that hold a key inside the causal / window band of some query of
// the block's tile are visited: the tiles the Pallas kernel's `pl.when(live)`
// keeps.  Any S <= T and any T (the ragged last tiles are masked).
//
// Bound: the function reads q, k, v and writes out once (25.2 MB at the
// model's prefill: B 4, H 16, KV 8, S = T = 512, D 128, bf16), and does
// 4 * D operations per unmasked (query, key) pair (4.3 GFLOP there, the
// causal half).  On this card the bytes bound it, 7.5 us at 3.35 TB/s,
// with 4.4 us of tensor-core time at 989 TFLOP/s close behind.
//
// Two kernels, chosen by dtype (never one for the other):
//
// * float32 (`f32` below): the CUDA cores, as the repository's float32 rule
//   (TF32 off) asks.  One block of 256 threads per (b, h, 64-query tile);
//   Q and each KV tile of 64 keys staged in shared memory in float32 (rows
//   padded to an odd length so that the column reads hit 32 distinct
//   banks); thread (rg, cg) = (tid / 16, tid % 16) holds the scores of rows
//   rg + 16 i and columns cg + 16 j (i, j < 4), their running max and sum,
//   and the output of its rows at columns cg + 16 c; P goes through shared
//   memory to the PV product.  Any strides with a unit stride on D, D <= 256.
//
// * bfloat16 (`tc` below): the tensor cores.  One block per (b, h, 64-query
//   tile), grid (B * H, ceil(S / 64)) with the q tiles taken last-first, so
//   the causal blocks with the most live KV tiles start first.  A block is
//   one consumer warpgroup (128 threads) and one producer warp.  The
//   producer's first lane copies the Q tile once and then every live K and V
//   tile of 64 keys through TMA into a two-stage ring in shared memory
//   (128-byte swizzle, boxes of 64 rows x 64 columns; a D of 120 reads a
//   second box whose last 8 columns TMA fills with zeros, as it fills the
//   rows past S or T), with an mbarrier per stage for "full" (the copies'
//   bytes arrived) and one for "empty" (the 128 consumer threads are done
//   with it).  The consumer runs S = Q K^T as wgmma m64n64k16 from shared
//   memory (Q and K both K-major), keeps S in float32 registers, scales it
//   to the log2 domain, masks it (only on the tiles that cross the causal
//   or window edge or the end of the keys), and takes the row max by two
//   shuffles within the 4 lanes that hold a row.  P = exp2(S - m) is summed
//   into l in float32, then rounded to bf16 in registers, where it already
//   sits as wgmma's A fragment for O += P V (m64nDPk16, DP = D padded to
//   64, 128 or 256; V from shared memory as the MN-major B operand).  O
//   stays in float32 registers; the epilogue divides by max(l, 1e-30),
//   stages the bf16 tile in shared memory and stores it 16 bytes a thread.
//   P in bf16 for the PV product is the rounding the reference's own einsum
//   path takes (its probabilities are cast to v's dtype).  Needs D % 8 == 0,
//   D <= 256, and 16-byte aligned bases and (b, h, row) strides (TMA's
//   rule); the wrapper checks and raises.  No atomics: two runs give the
//   same bits.
//
// Plain C interface for ctypes: each function returns the cudaError_t of its
// launch (0 on success).
#include <cuda.h>  // CUtensorMap and its enums (the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace f32 {

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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

}  // namespace f32

namespace tc {

constexpr int kBQ = 64;     // query rows per block: one wgmma M
constexpr int kBK = 64;     // keys per KV tile
constexpr int kChunk = 64;  // D columns per TMA box: 128 bytes, the swizzle
constexpr int kStages = 2;  // K/V ring depth
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr uint32_t kBoxBytes = kBK * kChunk * 2;  // a Q box is the same size
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  __nv_bfloat16* o;
  int64_t so[3];  // strides of out's (b, h, row)
  int H, KV, S, T, D, causal, window;  // window <= 0: none
  float scale_log2;                   // log2(e) / sqrt(D)
};

// DC boxes of 64 columns cover the padded D.  Every box is 8 KB, so with
// the struct 1024-aligned each box starts on a 1024-byte swizzle atom.
template <int DC>
struct Smem {
  __nv_bfloat16 q[DC][kBQ * kChunk];
  __nv_bfloat16 k[kStages][DC][kBK * kChunk];
  __nv_bfloat16 v[kStages][DC][kBK * kChunk];
  __nv_bfloat16 o[kBQ][kChunk * DC + 8];  // output staging, padded rows
  uint64_t full[kStages], empty[kStages], q_full;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  A
// phase that never completes is a fault of the kernel: it traps after about
// ten seconds (2e10 cycles) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// One box of the 4-d tensor (D, rows, heads, B) at (d0, row, head, b) into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int row,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0),
      "r"(row), "r"(head), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] (registers) B[16 x 128], B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 256] += A[64 x 16] (registers) B[16 x 256], B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DC>
__device__ __forceinline__ void wgmma_pv(float (&o)[32 * DC],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DC == 1) wgmma_rs_n64(o, a, db);
  if constexpr (DC == 2) wgmma_rs_n128(o, a, db);
  if constexpr (DC == 4) wgmma_rs_n256(o, a, db);
}

template <int DC>
__global__ void __launch_bounds__(kThreads, DC > 2 ? 1 : 2)
    flash_attention_tc(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const Args a) {
  constexpr int DP = kChunk * DC;  // padded head dim
  extern __shared__ uint8_t smem_raw[];
  Smem<DC>& sm = *reinterpret_cast<Smem<DC>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const int nrows = min(kBQ, a.S - q0);
  const int offset = a.T - a.S;
  const int q_lo = q0 + offset, q_hi = q0 + nrows - 1 + offset;
  int k_begin = 0, k_end = a.T;  // keys [k_begin, k_end) can be live
  if (a.causal) k_end = min(a.T, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);
  const int kt0 = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - kt0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: its first lane copies
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.q_full, DC * kBoxBytes);
      for (int c = 0; c < DC; ++c)
        tma_load(sm.q[c], &q_map, &sm.q_full, c * kChunk, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * DC * kBoxBytes);
        const int k0 = (kt0 + i) * kBK;
        for (int c = 0; c < DC; ++c) {
          tma_load(sm.k[s][c], &k_map, &sm.full[s], c * kChunk, k0, kvh, b);
          tma_load(sm.v[s][c], &v_map, &sm.full[s], c * kChunk, k0, kvh, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  wgmma's m64 fragments: thread (warp w, lane)
  // holds rows r0 = 16 w + lane / 4 and r0 + 8, and in each 8-column group
  // j the columns 8 j + 2 (lane % 4) and the next: registers 4 j + {0, 1}
  // on row r0, 4 j + {2, 3} on row r0 + 8.
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int row0 = q_lo + r0, row1 = row0 + 8;  // absolute query positions

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(&sm.q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = (kt0 + i) * kBK;
    mbar_wait(&sm.full[s], (i / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_ss_n64(sc, desc_sw128(sm.q[c] + 16 * kk, 16, 1024),
                     desc_sw128(sm.k[s][c] + 16 * kk, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    const bool edge = k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > q_lo) ||
                      (a.window > 0 && k0 <= q_hi - a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + cq + (e & 1);
          const int row = e < 2 ? row0 : row1;
          bool ok = col < a.T;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && col > row - a.window;
          if (!ok) x = kNegInf;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // P = exp2(S - m): summed in float32, and rounded to bf16 straight into
    // the A fragments of the four k16 steps (a0/a1 the first 8 keys of the
    // step on rows r0/r0 + 8, a2/a3 the next 8).
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const float p0 = exp2f(sc[4 * j] - m[0]);
        const float p1 = exp2f(sc[4 * j + 1] - m[0]);
        const float p2 = exp2f(sc[4 * j + 2] - m[1]);
        const float p3 = exp2f(sc[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        p[kk][2 * half] = pack_bf16(p0, p1);
        p[kk][2 * half + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pin(o);
    wgmma_fence();
    // V [64 keys, DP] as the MN-major B operand: k16 steps 16 rows (2 KB)
    // apart, 8-row groups 1 KB apart (SBO), 64-column boxes one box apart
    // (LBO).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DC>(o, p[kk],
                   desc_sw128(sm.v[s][0] + 16 * kk * kChunk, kBoxBytes,
                              1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    *reinterpret_cast<__nv_bfloat162*>(&sm.o[r0][col]) =
        __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(&sm.o[r0 + 8][col]) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int vecs = a.D / 8;  // 16-byte vectors a row
  __nv_bfloat16* out = a.o + b * a.so[0] + h * a.so[1];
  for (int idx = tid; idx < nrows * vecs; idx += kConsumers) {
    const int r = idx / vecs, cv = idx - r * vecs;
    *reinterpret_cast<uint4*>(out + (q0 + r) * a.so[2] + 8 * cv) =
        *reinterpret_cast<const uint4*>(&sm.o[r][8 * cv]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reached through the runtime
// so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The [B, heads, rows, D] operand at `base` with element strides st = (b,
// head, row) as the 4-d TMA tensor (D, rows, heads, B), boxes of 64 rows x
// 64 columns, 128-byte swizzle, out-of-bounds elements read as zeros.  A
// dim of size 1 gets a stride that TMA accepts (it is never stepped).
bool make_map(CUtensorMap* map, const void* base, int B, int heads, int rows,
              int D, const int64_t* st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const int64_t elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  cuuint64_t extent = static_cast<cuuint64_t>((D * 2 + 15) / 16 * 16);
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(elems[i]) * 2
                                 : extent;
    extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {kChunk, kBK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DC>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<DC>) + 1024;  // + the alignment slack
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_attention_tc<DC><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// float32 q, k, v and out.  strides: 12 element strides, (b, h, row) of q,
// k, v and out in that order; the last axis (D) is contiguous in all four.
// window <= 0 means no window.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int T, int D, int causal,
                        int window, float scale, const int64_t* strides,
                        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T < S ||
      D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  f32::AttnArgs a{q, k, v, o, B, H, KV, S, T, D, causal, window, scale,
                  {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return f32::dispatch_d<float>(a, stream);
}

// bfloat16 q, k, v and out, the same arguments; also D % 8 == 0 and every
// base and every stride of a dim longer than 1 16-byte aligned.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int S, int T, int D,
                         int causal, int window, float scale,
                         const int64_t* strides, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T < S ||
      D <= 0 || D > 256 || D % 8 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!tc::make_map(&qm, q, B, H, S, D, strides) ||
      !tc::make_map(&km, k, B, KV, T, D, strides + 3) ||
      !tc::make_map(&vm, v, B, KV, T, D, strides + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a{static_cast<__nv_bfloat16*>(o), {strides[9], strides[10],
             strides[11]}, H, KV, S, T, D, causal, window,
             scale * tc::kLog2e};
  if (D <= 64) return tc::launch<1>(qm, km, vm, a, B, stream);
  if (D <= 128) return tc::launch<2>(qm, km, vm, a, B, stream);
  return tc::launch<4>(qm, km, vm, a, B, stream);
}

}  // extern "C"
