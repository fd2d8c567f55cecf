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
// summed over every query head of k_j's GQA group.  The classic two-pass
// form, three launches:
//   1. `flash_bwd_dot_kernel`: D_i, one warp per row (f32).
//   2. `flash_bwd_dkdv_kernel`: one block per (key tile of 64, kv head, b).
//      K and V stay in shared memory; the block walks the live query tiles
//      of every query head of its group, in order, recomputes P and dS and
//      accumulates dK and dV in f32 registers.
//   3. `flash_bwd_dq_kernel`: one block per (query tile of 64, q head, b),
//      walking the live key tiles, accumulating dQ in f32 registers.
// No atomics: every sum runs in a fixed order, so two launches give the
// same bits.  Tiles that the causal mask or the window leave entirely dead
// are skipped, as the forward (and the TPU kernel's `pl.when`) skips them;
// the mask is applied per element inside a tile.  A row that sees no key
// has lse = -inf and no live (i, j): its P, dS and dQ are 0, no NaN.
//
// Bound: operations.  10 Dh FLOPs per live (i, j) pair and query head
// (S, dP, dV, dK, dQ); at qwen2-0.5b's training shape (q 8x14x512x64, k/v
// 8x2x512x64, causal) 9.4 GFLOP, 9.5 us at the tensor cores' 989 TFLOP/s.
// This first design computes on the CUDA cores in f32 (bf16 inputs are
// widened when they are staged in shared memory): simple and exact to f32,
// far from that bound.  Each thread of a 256-thread block owns a 4 x 4
// micro-tile of the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j)
// and a 4 x Dh/16 micro-tile of its accumulators; shared-memory rows are
// padded by one float so the column walks read conflict-free.  A
// tensor-core design (mma.sync or wgmma, TMA-fed) is later work.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (D lives in a scratch buffer the wrapper allocates),
// does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;        // rows of a tile (queries or keys)
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPStride = kBT + 1;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// 1. D_i = dO_i . O_i
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int64_t rows) {
  const int lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const T* orow = o + row * DH;
  const T* grow = dout + row * DH;
  float a = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32)
    a = fmaf(to_f(grow[c]), to_f(orow[c]), a);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  if (lane == 0) delta[row] = a;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (key tile, kv head, b)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, q head, b)
// ---------------------------------------------------------------------------

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
// launcher
// ---------------------------------------------------------------------------

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int hq, int hkv, int sq, int sk,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  using Shape = BwdShape<DH>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  // above 48 KB a block's dynamic shared memory needs the attribute
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t rows = static_cast<int64_t>(B) * hq * sq;
  const int64_t dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_dot_kernel<T, DH>
      <<<static_cast<unsigned>(dot_blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(o), gp, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, DH>
      <<<dim3((sk + kBT - 1) / kBT, hkv, B), kThreads, Shape::kDkvBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), hq, hkv, sq, sk, causal, window,
                   q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, DH>
      <<<dim3((sq + kBT - 1) / kBT, hq, B), kThreads, Shape::kDqBytes,
         stream>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), hq, hkv,
                   sq, sk, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of flash_attention_fwd.  dtype: 0 float32, 1 bfloat16 (q, k,
// v, o, dout, dq, dk, dv).  q, o, dout and dq are (B, hq, sq, dh), k, v, dk
// and dv (B, hkv, sk, dh), all contiguous; lse is the forward's (B, hq, sq)
// float32 log-sum-exp; delta is float32 scratch of B * hq * sq elements;
// hq a multiple of hkv; dh in {32, 64, 128}; window < 0 means no window;
// sq > 0 and sk > 0.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int hq, int hkv, int sq, int sk,
                                   int dh, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(T, DH)                                                    \
  return launch_bwd<T, DH>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, hq, \
                           hkv, sq, sk, causal, window, q_offset, scale, s)
  if (dtype == 0) {
    if (dh == 32) FLASH_BWD(float, 32);
    if (dh == 64) FLASH_BWD(float, 64);
    if (dh == 128) FLASH_BWD(float, 128);
  } else if (dtype == 1) {
    if (dh == 32) FLASH_BWD(__nv_bfloat16, 32);
    if (dh == 64) FLASH_BWD(__nv_bfloat16, 64);
    if (dh == 128) FLASH_BWD(__nv_bfloat16, 128);
  }
#undef FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
