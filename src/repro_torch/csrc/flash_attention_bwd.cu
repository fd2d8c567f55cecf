// Flash attention backward (GQA, causal, sliding window, q_offset) for
// Hopper: the gradient of flash_attention.cu's forward with respect to q, k
// and v, for the training path.
//
// Replaces no TPU kernel.  The TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py:41 has no backward: the reference
// trains through its pure-JAX twin `chunked_attention`
// (src/repro/models/layers.py:127), which JAX differentiates by autodiff.
// The port trains through the hand-written forward, and autograd cannot go
// through a ctypes launch, so this kernel computes the gradient that
// autodiff computes there.  With P = softmax(q k^T scale) over the live keys
// and lse the forward's per-row log-sum-exp:
//
//     P_ij  = exp(q_i . k_j scale - lse_i)          (0 where (i, j) is masked)
//     D_i   = sum_d dO_id O_id
//     dS_ij = P_ij (dO_i . v_j - D_i)
//     dV_j  = sum_i P_ij dO_i         dK_j = scale sum_i dS_ij q_i
//     dQ_i  = scale sum_j dS_ij k_j
//
// summed over every query head of k_j's GQA group.  The two-pass form: dK
// and dV in one grid, dQ in another, each recomputing S and dP, so no sum
// crosses blocks by atomics (14 Dh FLOPs per live pair and query head) and
// two launches give the same bits.  Tiles that the causal mask or the
// window leave entirely dead are skipped, as the forward skips them; the
// mask is applied per element only on tiles that cross a boundary.  A row
// that sees no key has lse = -inf and no live (i, j): its P, dS and dQ are
// 0 (a select, never -inf arithmetic), no NaN.
//
// Bound: operations.  10 Dh FLOPs per live (i, j) pair and query head at
// the least (S, dP, dV, dK, dQ); at qwen2-0.5b's training shape (q
// 8x14x512x64, k/v 8x2x512x64, causal) 9.4 GFLOP, 9.5 us at the tensor
// cores' 989 TFLOP/s, beside 10 us of bytes at 3.35 TB/s.
//
// bf16 (the training path): tensor cores, `mma.sync.m16n8k16` with bf16
// operands and f32 accumulators for all five products, operands fed by
// `ldmatrix` from shared-memory rows padded by 16 bytes (conflict-free),
// the streamed tiles by a two-stage ring of 16-byte cp.async copies (tile
// t + 1 in flight while tile t is used).  The fragment layouts are the
// forward's (flash_attention.cu, `flash_prefill_mma_kernel`).  mma.sync
// rather than wgmma with TMA, as in the forward: each warp's 16 rows stay
// self-contained (no warpgroup descriptors, swizzled layouts or mbarrier
// ring), at up to ~2/3 of the wgmma rate.
//   1. `flash_bwd_dot_kernel`: D_i, a row over one lane per 16-byte vector.
//   2. `flash_bwd_dkdv_mma_kernel`: one block of four warps per (query
//      head, b, key tile of 64), the key tiles on the grid's slowest axis so
//      that the heaviest causal tiles (the first keys) start first.  Each
//      warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T (keys
//      as the mma's rows), so the accumulator fragments of P^T and dS^T are
//      already the A operands of dV += P^T dO and dK += dS^T Q: P and dS
//      never leave registers.  K and V stay in shared memory; Q, dO, lse
//      and D stream through the ring, 64 query rows a step (32 at Dh 128,
//      where the dK/dV accumulators take the registers).
//      The GQA sum: with a group of g > 1 query heads per KV head, each
//      block writes its head's partial dK, dV in f32 to scratch; the last
//      of the g blocks of a key tile to arrive (a ticket counter after
//      __threadfence(), one per (b, kv head, key tile)) sums the g
//      partials in head order, whichever block it is, rounds once, and
//      sets its counter back to 0, so the next call needs no memset (the
//      counters are one device buffer the wrapper caches per device:
//      calls on it run one after another, on one stream, as the port's
//      do).  The partials move 2 x 4 B x B Hq Sk Dh each way (29.4 MB at
//      the training shape, mostly within L2).  So a key tile's critical
//      path is its own head's query tiles (at most 8 at the training
//      shape, not the 56 of one block walking all 7 heads), the grid is g
//      times larger, and no second pass runs.  A group of 1 writes dK, dV
//      directly.
//   3. `flash_bwd_dq_mma_kernel`: one block per (query head, b, query tile
//      of 64), the heaviest causal tiles first, walking the live key tiles:
//      S = Q K^T, dP = dO V^T, dQ += dS K, dS from the S fragments as the
//      A operand again.
//   Precision: P and dS enter the tensor cores split as x = x_hi + x_lo,
//   both bf16 (x_lo = bf16(x - x_hi)), both products into one f32
//   accumulator: ~16 bits of P and dS, as the forward keeps of P, where a
//   bf16 P or dS alone would add a 2^-9 relative rounding to every term.
//   The gradients round once to bf16 at the end.  Scores, exponentials,
//   dP - D and every sum are f32.
//
// f32: CUDA cores (TF32 tensor cores would not hold the f32 tolerances),
// the first design of this file: `flash_bwd_dkdv_kernel` one block per (key
// tile of 64, kv head, b) walking the live query tiles of every query head
// of its group in order, `flash_bwd_dq_kernel` one block per (query tile,
// q head, b); each thread of a 256-thread block owns a 4 x 4 micro-tile of
// the 64 x 64 score tile and a 4 x Dh/16 micro-tile of its accumulators.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (D, the GQA partials and their counters live in
// buffers the wrapper allocates), does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;        // rows of a tile (queries or keys)
constexpr int kThreads = 256;  // f32 design: a 16 x 16 grid of threads
constexpr int kPStride = kBT + 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ bool key_live(int key, int q_pos, int sk,
                                         int causal, int window) {
  return key < sk && (!causal || key <= q_pos) &&
         (window < 0 || key > q_pos - window);
}

// ---------------------------------------------------------------------------
// PTX wrappers (as flash_attention.cu's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `valid` false zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// 4-byte asynchronous copy global -> shared; `valid` false zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) . b (16x8, col); bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU alone (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), packed low column first
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// the A operand of k-step kk from the accumulator fragments of n-tiles
// 2 kk and 2 kk + 1 (the m16n8 C layout of two n-tiles is the m16k16 A
// layout), split into its bf16 halves
__device__ __forceinline__ void a_split(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
struct BwdShape {
  static constexpr int kStride = DH + 1;           // floats per staged row
  static constexpr int kTile = kBT * kStride;      // floats per staged tile
  static constexpr int kDC = DH / 16;              // accumulator columns
  // dK/dV: K, V, Q, dO tiles, P and dS, lse and D
  static constexpr int kDkvBytes =
      (4 * kTile + 2 * kBT * kPStride + 2 * kBT) * 4;
  // dQ: Q, dO, K, V tiles, dS, lse and D
  static constexpr int kDqBytes = (4 * kTile + kBT * kPStride + 2 * kBT) * 4;
};

// rows [row0, row0 + 64) of a (rows, DH) matrix into shared memory as f32,
// rows at or past `limit` zero-filled
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ src,
                                           int row0, int limit) {
  for (int idx = threadIdx.x; idx < kBT * DH; idx += kThreads) {
    const int r = idx / DH;
    const int c = idx % DH;
    const int row = row0 + r;
    dst[r * BwdShape<DH>::kStride + c] =
        row < limit ? to_f(src[static_cast<int64_t>(row) * DH + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over two staged tiles
template <int DH>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int kS = BwdShape<DH>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// 16 bytes of a row as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// D_i = dO_i . O_i (both dtypes): a row's 16-byte vectors over Dh / vec
// neighbouring lanes, one load each of O and dO, an xor-shuffle sum
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int64_t rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = DH / kVec;          // lanes a row
  constexpr int kRows = kThreads / kLanes;   // rows a block
  const int l = threadIdx.x % kLanes;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kLanes;
  float a = 0.f;
  if (row < rows) {
    float x[kVec], y[kVec];
    load_vec(o + row * DH + l * kVec, x);
    load_vec(dout + row * DH + l * kVec, y);
#pragma unroll
    for (int e = 0; e < kVec; ++e) a = fmaf(y[e], x[e], a);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    a += __shfl_xor_sync(kFull, a, off);
  if (l == 0 && row < rows) delta[row] = a;
}

// dK, dV: one block per (key tile, kv head, b)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int hq, int hkv, int sq, int sk,
                      int causal, int window, int q_offset, float scale) {
  using Shape = BwdShape<DH>;
  constexpr int kS = Shape::kStride;
  constexpr int kDC = Shape::kDC;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + Shape::kTile;
  float* qs = vs + Shape::kTile;
  float* dos = qs + Shape::kTile;
  float* ps = dos + Shape::kTile;   // [query][key]
  float* dss = ps + kBT * kPStride;  // [query][key]
  float* lse_s = dss + kBT * kPStride;
  float* d_s = lse_s + kBT;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * kBT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int64_t kv_row0 = (static_cast<int64_t>(b) * hkv + hk) * sk;
  stage_rows<T, DH>(ks, k + kv_row0 * DH, k0, sk);
  stage_rows<T, DH>(vs, v + kv_row0 * DH, k0, sk);

  // query rows that see some key of this tile: q_pos >= k0 (causal) and
  // q_pos < k_last + window (window), q_pos = q_offset + row
  const int k_last = min(k0 + kBT, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - q_offset);
  if (window >= 0) q_hi = min(q_hi, k_last + window - q_offset);
  q_lo = (q_lo / kBT) * kBT;

  float dk_acc[4][kDC], dv_acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int64_t q_row0 = (static_cast<int64_t>(b) * hq + hk * group + hh) *
                           sq;
    for (int qt = q_lo; qt < q_hi; qt += kBT) {
      __syncthreads();  // the previous tile is consumed
      stage_rows<T, DH>(qs, q + q_row0 * DH, qt, sq);
      stage_rows<T, DH>(dos, dout + q_row0 * DH, qt, sq);
      if (tid < kBT) {
        const bool ok = qt + tid < sq;
        lse_s[tid] = ok ? lse[q_row0 + qt + tid] : 0.f;
        d_s[tid] = ok ? delta[q_row0 + qt + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<DH>(qs, ks, ty, tx, s);
      tile_dot<DH>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qi = qt + r;
        const int q_pos = q_offset + qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool live =
              qi < sq && key_live(k0 + c, q_pos, sk, causal, window);
          const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ps[r * kPStride + c] = p;
          dss[r * kPStride + c] = p * (dp[i][j] - d_s[r]);
        }
      }
      __syncthreads();

      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK likewise with dS and Q
      const int rows = min(kBT, sq - qt);
      for (int r = 0; r < rows; ++r) {
        float pr[4], dr[4], ov[kDC], qv[kDC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[r * kPStride + ty + 16 * i];
          dr[i] = dss[r * kPStride + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          ov[j] = dos[r * kS + tx + 16 * j];
          qv[j] = qs[r * kS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDC; ++j) {
            dv_acc[i][j] = fmaf(pr[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dr[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    T* dkr = dk + (kv_row0 + key) * DH;
    T* dvr = dv + (kv_row0 + key) * DH;
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      store(dkr + tx + 16 * j, dk_acc[i][j] * scale);
      store(dvr + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

// dQ: one block per (query tile, q head, b)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int hkv, int sq, int sk, int causal, int window,
                    int q_offset, float scale) {
  using Shape = BwdShape<DH>;
  constexpr int kS = Shape::kStride;
  constexpr int kDC = Shape::kDC;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + Shape::kTile;
  float* ks = dos + Shape::kTile;
  float* vs = ks + Shape::kTile;
  float* dss = vs + Shape::kTile;  // [query][key]
  float* lse_s = dss + kBT * kPStride;
  float* d_s = lse_s + kBT;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // the heaviest causal tiles (the last rows) are launched first
  const int qt = (static_cast<int>(gridDim.x) - 1 -
                  static_cast<int>(blockIdx.x)) * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_row0 = (static_cast<int64_t>(b) * hq + h) * sq;
  const int64_t kv_row0 = (static_cast<int64_t>(b) * hkv + hk) * sk;
  stage_rows<T, DH>(qs, q + q_row0 * DH, qt, sq);
  stage_rows<T, DH>(dos, dout + q_row0 * DH, qt, sq);
  if (tid < kBT) {
    const bool ok = qt + tid < sq;
    lse_s[tid] = ok ? lse[q_row0 + qt + tid] : 0.f;
    d_s[tid] = ok ? delta[q_row0 + qt + tid] : 0.f;
  }

  // live key range [k_lo, k_hi) of the whole tile, tile-aligned below
  const int q_first = q_offset + qt;
  const int q_last = q_offset + min(qt + kBT, sq) - 1;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q_first - window + 1);
  k_lo = (k_lo / kBT) * kBT;

  float dq_acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dq_acc[i][j] = 0.f;

  for (int kt = k_lo; kt < k_hi; kt += kBT) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, DH>(ks, k + kv_row0 * DH, kt, sk);
    stage_rows<T, DH>(vs, v + kv_row0 * DH, kt, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DH>(qs, ks, ty, tx, s);
    tile_dot<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt + r;
      const int q_pos = q_offset + qi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qi < sq && key_live(kt + c, q_pos, sk, causal, window);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * kPStride + c] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dQ[row][d] += sum_c dS[row][c] K[c][d]
    const int keys = min(kBT, sk - kt);
    for (int c = 0; c < keys; ++c) {
      float dr[4], kv[kDC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) kv[j] = ks[c * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j)
          dq_acc[i][j] = fmaf(dr[i], kv[j], dq_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt + ty + 16 * i;
    if (row >= sq) continue;
    T* dqr = dq + (q_row0 + row) * DH;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      store(dqr + tx + 16 * j, dq_acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMB = 64;         // keys of a dK/dV block, rows of a dQ block
constexpr int kMThreads = 128;  // four warps of 16 rows

template <int DH>
struct MmaShape {
  static constexpr int kStride = DH + 8;  // bf16 per staged row: 16-byte pad
  static constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  // dK/dV: query rows a step; 32 at Dh 128, where the dK and dV
  // accumulators (2 x 64 floats a thread) take the registers
  static constexpr int kQN = DH <= 64 ? 64 : 32;
  // dK/dV: K and V; the ring of Q and dO (2 stages); lse and D (2 stages)
  static constexpr int kDkvBytes =
      (2 * kMB + 4 * kQN) * kStride * 2 + 4 * kQN * 4;
  // dQ: Q and dO; the ring of K and V (2 stages)
  static constexpr int kDqBytes = 6 * kMB * kStride * 2;
};

// three blocks an SM at Dh <= 64 (at most 168 registers a thread): twelve
// warps to hide the ldmatrix -> mma chains; at Dh 128 the accumulators
// need the registers of one
template <int DH>
__global__ void __launch_bounds__(kMThreads, DH <= 64 ? 3 : 1)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dk_part,
                          float* __restrict__ dv_part,
                          unsigned* __restrict__ counters, int hq, int hkv,
                          int sq, int sk, int causal, int window,
                          int q_offset, float scale, float scale_log2) {
  using Shape = MmaShape<DH>;
  constexpr int kStride = Shape::kStride;
  constexpr int kChunks = Shape::kChunks;
  constexpr int kQN = Shape::kQN;
  constexpr int kKSteps = DH / 16;  // k-steps of S^T over the head dims
  constexpr int kNQ = kQN / 8;      // n-tiles of S^T (query columns)
  constexpr int kND = DH / 8;       // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kMB][kStride]
  bf16* vs = ks + kMB * kStride;                 // [kMB][kStride]
  bf16* qs = vs + kMB * kStride;                 // [2][kQN][kStride]
  bf16* dos = qs + 2 * kQN * kStride;            // [2][kQN][kStride]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kQN * kStride);  // [2][kQN]
  float* d_s = lse_s + 2 * kQN;                                      // [2][kQN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (and row + 8)
  const int tig = lane % 4;  // fragment column pair
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kMB;
  const int group = hq / hkv;
  const int hk = h / group;
  const int64_t q_row0 = (static_cast<int64_t>(b) * hq + h) * sq;
  const int64_t kv_row0 = (static_cast<int64_t>(b) * hkv + hk) * sk;
  const bf16* qp = q + q_row0 * DH;
  const bf16* gp = dout + q_row0 * DH;

  // query rows that see some key of this tile: q_pos >= k0 (causal) and
  // q_pos < k_last + window (window), q_pos = q_offset + row
  const int k_last = min(k0 + kMB, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - q_offset);
  if (window >= 0) q_hi = min(q_hi, k_last + window - q_offset);
  q_lo = (q_lo / kQN) * kQN;
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + kQN - 1) / kQN : 0;

  for (int idx = tid; idx < kMB * kChunks; idx += kMThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = k0 + r < sk;  // keys past Sk are zero-filled
    const int64_t off = (kv_row0 + (ok ? k0 + r : 0)) * DH + c * 8;
    cp_async16(smem_u32(ks + r * kStride + c * 8), k + off, ok);
    cp_async16(smem_u32(vs + r * kStride + c * 8), v + off, ok);
  }
  auto load_q = [&](int q0, int buf) {
    bf16* qd = qs + buf * kQN * kStride;
    bf16* gd = dos + buf * kQN * kStride;
    for (int idx = tid; idx < kQN * kChunks; idx += kMThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = q0 + r < sq;  // rows past Sq are zero-filled
      const int64_t off = static_cast<int64_t>(ok ? q0 + r : 0) * DH + c * 8;
      cp_async16(smem_u32(qd + r * kStride + c * 8), qp + off, ok);
      cp_async16(smem_u32(gd + r * kStride + c * 8), gp + off, ok);
    }
    for (int idx = tid; idx < kQN; idx += kMThreads) {
      const bool ok = q0 + idx < sq;
      const int64_t row = q_row0 + (ok ? q0 + idx : 0);
      cp_async4(smem_u32(lse_s + buf * kQN + idx), lse + row, ok);
      cp_async4(smem_u32(d_s + buf * kQN + idx), delta + row, ok);
    }
  };
  if (n_tiles > 0) load_q(q_lo, 0);
  cp_async_commit();  // group: K, V and the first query tile

  float dk_acc[kND][4], dv_acc[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
  const int key_r = warp * 16;  // this warp's keys: k0 + key_r + [0, 16)

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_lo + t * kQN;
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_q(q0 + kQN, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const bf16* qt = qs + buf * kQN * kStride;
    const bf16* gt = dos + buf * kQN * kStride;
    const float* lt = lse_s + buf * kQN;
    const float* dt = d_s + buf * kQN;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kQN queries per warp
    float st[kNQ][4], pt[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = pt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ka[4], va[4];
      const int r = key_r + (lane % 8) + ((lane / 8) % 2) * 8;
      const int col = kk * 16 + (lane / 16) * 8;
      ldsm_x4(smem_u32(ks + r * kStride + col), ka[0], ka[1], ka[2], ka[3]);
      ldsm_x4(smem_u32(vs + r * kStride + col), va[0], va[1], va[2], va[3]);
#pragma unroll
      for (int np = 0; np < kNQ / 2; ++np) {
        const int qr = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int dim = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(qt + qr * kStride + dim), b0, b1, b2, b3);
        mma_bf16(st[2 * np], ka, b0, b1);
        mma_bf16(st[2 * np + 1], ka, b2, b3);
        ldsm_x4(smem_u32(gt + qr * kStride + dim), b0, b1, b2, b3);
        mma_bf16(pt[2 * np], va, b0, b1);
        mma_bf16(pt[2 * np + 1], va, b2, b3);
      }
    }

    // P^T and dS^T = P^T (dP^T - D) in place; rows are keys, columns
    // queries.  The mask runs only on tiles that cross a boundary (causal
    // diagonal, window edge, the Sk or Sq tail)
    const bool edge = k0 + kMB > sk || q0 + kQN > sq ||
                      (causal && k0 + kMB - 1 > q_offset + q0) ||
                      (window >= 0 && k0 <= q_offset + q0 + kQN - 1 - window);
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const int col = j * 8 + tig * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 dd = *reinterpret_cast<const float2*>(dt + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_e = (e & 1) ? l2.y : l2.x;
        const float d_e = (e & 1) ? dd.y : dd.x;
        float p = ex2(fmaf(st[j][e], scale_log2, -lse_e * kLog2e));
        if (edge) {
          const int qi = q0 + col + (e & 1);
          const int key = k0 + key_r + g + 8 * (e >> 1);
          if (!(qi < sq && key_live(key, q_offset + qi, sk, causal, window)))
            p = 0.f;
        }
        st[j][e] = p;
        pt[j][e] = p * (pt[j][e] - d_e);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from the fragments
    // above, split into bf16 halves; dO and Q as B by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < kQN / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_split(st[2 * kk], st[2 * kk + 1], ph, pl);
      a_split(pt[2 * kk], pt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        const int qr = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dim = nd * 16 + (lane / 16) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(gt + qr * kStride + dim), b0, b1, b2, b3);
        mma_bf16(dv_acc[2 * nd], ph, b0, b1);
        mma_bf16(dv_acc[2 * nd], pl, b0, b1);
        mma_bf16(dv_acc[2 * nd + 1], ph, b2, b3);
        mma_bf16(dv_acc[2 * nd + 1], pl, b2, b3);
        ldsm_x4_t(smem_u32(qt + qr * kStride + dim), b0, b1, b2, b3);
        mma_bf16(dk_acc[2 * nd], sh, b0, b1);
        mma_bf16(dk_acc[2 * nd], sl, b0, b1);
        mma_bf16(dk_acc[2 * nd + 1], sh, b2, b3);
        mma_bf16(dk_acc[2 * nd + 1], sl, b2, b3);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

  // this head's dK, dV rows: final (a group of 1) or f32 partials
  const int64_t part_row0 = (static_cast<int64_t>(b) * hq + h) * sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + key_r + g + 8 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int d = 0; d < kND; ++d) {
      const int col = d * 8 + tig * 2;
      if (dk_part != nullptr) {
        const int64_t off = (part_row0 + key) * DH + col;
        *reinterpret_cast<float2*>(dk_part + off) =
            make_float2(dk_acc[d][2 * i], dk_acc[d][2 * i + 1]);
        *reinterpret_cast<float2*>(dv_part + off) =
            make_float2(dv_acc[d][2 * i], dv_acc[d][2 * i + 1]);
      } else {
        const int64_t off = (kv_row0 + key) * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
            dk_acc[d][2 * i] * scale, dk_acc[d][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(
            dv_acc[d][2 * i], dv_acc[d][2 * i + 1]);
      }
    }
  }
  if (dk_part == nullptr) return;

  // the GQA sum: the last of the group's blocks of this key tile to arrive
  // (a ticket after __threadfence()) sums the group's partials in head
  // order and rounds once; it sets the ticket back to 0 for the next call
  __shared__ unsigned ticket;
  const int64_t tile =
      (static_cast<int64_t>(b) * hkv + hk) * gridDim.z + blockIdx.z;
  __threadfence();  // this head's partial rows, before its ticket
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(counters + tile, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>(group - 1)) return;
  __threadfence();
  const int64_t head = static_cast<int64_t>(sk) * DH;  // floats a head
  const int64_t src0 =
      (static_cast<int64_t>(b) * hq + hk * group) * head +
      static_cast<int64_t>(k0) * DH;
  const float4* dk4 = reinterpret_cast<const float4*>(dk_part + src0);
  const float4* dv4 = reinterpret_cast<const float4*>(dv_part + src0);
  const int n4 = (min(kMB, sk - k0) * DH) / 4;
  const int64_t head4 = head / 4;
  bf16* dkt = dk + (kv_row0 + k0) * DH;
  bf16* dvt = dv + (kv_row0 + k0) * DH;
  for (int i = tid; i < n4; i += kMThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 c = a;
    for (int hh = 0; hh < group; ++hh) {
      const float4 x = __ldcg(dk4 + hh * head4 + i);
      const float4 y = __ldcg(dv4 + hh * head4 + i);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
      c.x += y.x;
      c.y += y.y;
      c.z += y.z;
      c.w += y.w;
    }
    __nv_bfloat162* kq = reinterpret_cast<__nv_bfloat162*>(dkt + 4 * i);
    __nv_bfloat162* vq = reinterpret_cast<__nv_bfloat162*>(dvt + 4 * i);
    kq[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    kq[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    vq[0] = __floats2bfloat162_rn(c.x, c.y);
    vq[1] = __floats2bfloat162_rn(c.z, c.w);
  }
  if (tid == 0) counters[tile] = 0u;
}

template <int DH>
__global__ void __launch_bounds__(kMThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int hq, int hkv, int sq,
                        int sk, int causal, int window, int q_offset,
                        float scale, float scale_log2) {
  using Shape = MmaShape<DH>;
  constexpr int kStride = Shape::kStride;
  constexpr int kChunks = Shape::kChunks;
  constexpr int kTile = kMB * kStride;
  constexpr int kKSteps = DH / 16;  // k-steps of S over the head dims
  constexpr int kNK = kMB / 8;      // n-tiles of S (key columns)
  constexpr int kND = DH / 8;       // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kMB][kStride]
  bf16* dos = qs + kTile;                        // [kMB][kStride]
  bf16* ks = dos + kTile;                        // [2][kMB][kStride]
  bf16* vs = ks + 2 * kTile;                     // [2][kMB][kStride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // the heaviest causal tiles (the last rows) are launched first
  const int qt = (static_cast<int>(gridDim.z) - 1 -
                  static_cast<int>(blockIdx.z)) * kMB;
  const int hk = h / (hq / hkv);
  const int64_t q_row0 = (static_cast<int64_t>(b) * hq + h) * sq;
  const int64_t kv_row0 = (static_cast<int64_t>(b) * hkv + hk) * sk;
  const bf16* kp = k + kv_row0 * DH;
  const bf16* vp = v + kv_row0 * DH;

  // live key range [k_lo, k_hi) of the whole tile, tile-aligned below
  const int q_first = q_offset + qt;
  const int q_last = q_offset + min(qt + kMB, sq) - 1;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q_first - window + 1);
  k_lo = (k_lo / kMB) * kMB;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kMB - 1) / kMB : 0;

  for (int idx = tid; idx < kMB * kChunks; idx += kMThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = qt + r < sq;
    const int64_t off = (q_row0 + (ok ? qt + r : 0)) * DH + c * 8;
    cp_async16(smem_u32(qs + r * kStride + c * 8), q + off, ok);
    cp_async16(smem_u32(dos + r * kStride + c * 8), dout + off, ok);
  }
  auto load_kv = [&](int k0, int buf) {
    bf16* kd = ks + buf * kTile;
    bf16* vd = vs + buf * kTile;
    for (int idx = tid; idx < kMB * kChunks; idx += kMThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = k0 + r < sk;  // keys past Sk are zero-filled
      const int64_t off = static_cast<int64_t>(ok ? k0 + r : 0) * DH + c * 8;
      cp_async16(smem_u32(kd + r * kStride + c * 8), kp + off, ok);
      cp_async16(smem_u32(vd + r * kStride + c * 8), vp + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(k_lo, 0);
  cp_async_commit();  // group: Q, dO and the first key tile

  // this thread's rows, row_a and row_a + 8: their lse (log2 units) and D
  const int row_a = qt + warp * 16 + g;
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const bool ok = row < sq;
    l2[i] = ok ? lse[q_row0 + row] * kLog2e : 0.f;
    dd[i] = ok ? delta[q_row0 + row] : 0.f;
  }
  float dq_acc[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[d][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kMB;
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(k0 + kMB, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const bf16* kt = ks + buf * kTile;
    const bf16* vt = vs + buf * kTile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[kNK][4], dp[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[4], ga[4];
      const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
      const int col = kk * 16 + (lane / 16) * 8;
      ldsm_x4(smem_u32(qs + r * kStride + col), qa[0], qa[1], qa[2], qa[3]);
      ldsm_x4(smem_u32(dos + r * kStride + col), ga[0], ga[1], ga[2], ga[3]);
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int dim = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + key * kStride + dim), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa, b0, b1);
        mma_bf16(s[2 * np + 1], qa, b2, b3);
        ldsm_x4(smem_u32(vt + key * kStride + dim), b0, b1, b2, b3);
        mma_bf16(dp[2 * np], ga, b0, b1);
        mma_bf16(dp[2 * np + 1], ga, b2, b3);
      }
    }

    // dS = P (dP - D) in place of S
    const bool edge = k0 + kMB > sk || qt + kMB > sq ||
                      (causal && k0 + kMB - 1 > q_first) ||
                      (window >= 0 && k0 <= q_first + kMB - 1 - window);
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], scale_log2, -l2[e >> 1]));
        if (edge) {
          const int row = row_a + 8 * (e >> 1);
          const int key = k0 + j * 8 + tig * 2 + (e & 1);
          if (!(row < sq && key_live(key, q_offset + row, sk, causal, window)))
            p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dd[e >> 1]);
      }
    }

    // dQ += dS K: dS's fragments as the A operand, split into bf16
    // halves; K as B by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < kMB / 16; ++kk) {
      uint32_t sh[4], sl[4];
      a_split(s[2 * kk], s[2 * kk + 1], sh, sl);
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dim = nd * 16 + (lane / 16) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(kt + key * kStride + dim), b0, b1, b2, b3);
        mma_bf16(dq_acc[2 * nd], sh, b0, b1);
        mma_bf16(dq_acc[2 * nd], sl, b0, b1);
        mma_bf16(dq_acc[2 * nd + 1], sh, b2, b3);
        mma_bf16(dq_acc[2 * nd + 1], sl, b2, b3);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= sq) continue;
    bf16* dqr = dq + (q_row0 + row) * DH + tig * 2;
#pragma unroll
    for (int d = 0; d < kND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dqr + d * 8) = __floats2bfloat162_rn(
          dq_acc[d][2 * i] * scale, dq_acc[d][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int DH>
int launch_dot(const void* o, const void* dout, float* delta, int64_t rows,
               cudaStream_t stream) {
  constexpr int kRows = kThreads / (DH * static_cast<int>(sizeof(T)) / 16);
  const int64_t blocks = (rows + kRows - 1) / kRows;
  flash_bwd_dot_kernel<T, DH>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int B, int hq, int hkv, int sq, int sk,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using Shape = BwdShape<DH>;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(dout);
  // above 48 KB a block's dynamic shared memory needs the attribute
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<float, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<float, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  int rc = launch_dot<float, DH>(o, dout, delta,
                                 static_cast<int64_t>(B) * hq * sq, stream);
  if (rc != 0) return rc;
  flash_bwd_dkdv_kernel<float, DH>
      <<<dim3((sk + kBT - 1) / kBT, hkv, B), kThreads, Shape::kDkvBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), hq, hkv, sq, sk, causal, window,
                   q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<float, DH>
      <<<dim3((sq + kBT - 1) / kBT, hq, B), kThreads, Shape::kDqBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<float*>(dq), hq,
                   hkv, sq, sk, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, float* dk_part, float* dv_part,
                    unsigned* counters, void* dq, void* dk, void* dv, int B,
                    int hq, int hkv, int sq, int sk, int causal, int window,
                    int q_offset, float scale, cudaStream_t stream) {
  using Shape = MmaShape<DH>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dout);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const bool grouped = hq != hkv;
  if (grouped &&
      (dk_part == nullptr || dv_part == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  int rc = launch_dot<bf16, DH>(o, dout, delta,
                                static_cast<int64_t>(B) * hq * sq, stream);
  if (rc != 0) return rc;
  flash_bwd_dkdv_mma_kernel<DH>
      <<<dim3(hq, B, (sk + kMB - 1) / kMB), kMThreads, Shape::kDkvBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), grouped ? dk_part : nullptr,
                   grouped ? dv_part : nullptr, counters, hq, hkv, sq, sk,
                   causal, window, q_offset, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_mma_kernel<DH>
      <<<dim3(hq, B, (sq + kMB - 1) / kMB), kMThreads, Shape::kDqBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dq), hq,
                   hkv, sq, sk, causal, window, q_offset, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of flash_attention_fwd.  dtype: 0 float32, 1 bfloat16 (q, k,
// v, o, dout, dq, dk, dv).  q, o, dout and dq are (B, hq, sq, dh), k, v, dk
// and dv (B, hkv, sk, dh), all contiguous and 16-byte aligned; lse is the
// forward's (B, hq, sq) float32 log-sum-exp; delta is float32 scratch of
// B * hq * sq elements.  Where dtype is bfloat16 and hq > hkv: dk_part and
// dv_part are float32 scratch of B * hq * sk * dh elements each (the GQA
// partials) and counters holds B * hkv * ceil(sk / 64) unsigned ints, all
// 0 on entry and on return (calls that share them run one after another,
// on one stream); else all three are ignored (may be null).  hq a multiple
// of hkv; dh in {32, 64, 128}; window < 0 means no window; sq > 0 and
// sk > 0.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, float* dk_part,
                                   float* dv_part, unsigned* counters,
                                   void* dq, void* dk, void* dv, int B,
                                   int hq, int hkv, int sq, int sk, int dh,
                                   int causal, int window, int q_offset,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_F32(DH)                                                     \
  return launch_bwd_f32<DH>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, hq, \
                            hkv, sq, sk, causal, window, q_offset, scale, s)
#define FLASH_BWD_BF16(DH)                                                   \
  return launch_bwd_bf16<DH>(q, k, v, o, dout, lse, delta, dk_part,         \
                             dv_part, counters, dq, dk, dv, B, hq, hkv, sq,   \
                             sk, causal, window, q_offset, scale, s)
  if (dtype == 0) {
    if (dh == 32) FLASH_BWD_F32(32);
    if (dh == 64) FLASH_BWD_F32(64);
    if (dh == 128) FLASH_BWD_F32(128);
  } else if (dtype == 1) {
    if (dh == 32) FLASH_BWD_BF16(32);
    if (dh == 64) FLASH_BWD_BF16(64);
    if (dh == 128) FLASH_BWD_BF16(128);
  }
#undef FLASH_BWD_F32
#undef FLASH_BWD_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}
