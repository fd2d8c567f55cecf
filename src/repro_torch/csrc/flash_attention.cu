// Flash attention forward (online softmax, GQA, causal, sliding window,
// q_offset) on Hopper CUDA cores.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (reached through
// `flash_attention_pallas` and `ops.flash_attention`).  For every batch b,
// query head h, query row i (absolute position q_pos = q_offset + i) it
// computes
//
//     o[b, h, i] = sum_j softmax_j(q[b,h,i] . k[b,h/group,j] / sqrt(Dh)) v[b,h/group,j]
//
// over the keys j < Sk that are live: j <= q_pos if causal, and
// j > q_pos - window if a window is given.  A row with no live key gives 0
// (the TPU kernel's l == 0 -> 1).  Softmax statistics and the accumulator
// are f32; the output is written in q's dtype.
//
// Design (not the TPU kernel carried over block by block).  The TPU grid
// walks (q-tile, k-tile) cells in order and carries m, l and the
// accumulator in VMEM scratch across the sequential k axis.  Here one block
// owns one (b, h, 64-row q tile) and loops over the k tiles itself, so the
// running state lives in registers:
//   * a query row is owned by G = Dh / 32 neighbouring threads; each holds
//     32 of the row's dims (as float4 chunks g, g + G, g + 2G, ... so the G
//     threads read neighbouring 16-byte words of a shared-memory key row and
//     never conflict), q pre-scaled by 1/sqrt(Dh), and the matching 32
//     accumulator dims.  A dot product is 32 FMAs and log2(G) xor-shuffles.
//   * K and V tiles of 32 keys are staged in shared memory as f32, read from
//     KV head h / group (GQA without repeating K/V in memory); keys past Sk
//     are zero-filled so a masked key adds exactly 0.
//   * the block's live key range is computed from its first and last query
//     position (causal upper end, window lower end); tiles outside it are
//     never loaded, which is the TPU kernel's `pl.when(live)` skip.  Inside a
//     tile every element is masked for j < Sk, causal and window.
//   * per tile: 32 scores, one max, one rescale of the accumulator (alpha)
//     and 32 probabilities, then the P.V update; -1e30 stands for -inf as in
//     the TPU kernel.
//
// Bound.  Prefill is bound by operations: 4 Dh Sq Sk FLOPs per (b, h), about
// half of it live under the causal mask (at B=4, Hq=14, S=2048, Dh=64:
// 3.0e10 FLOPs per layer, ~30 us at the card's 989 TFLOP/s bf16 tensor-core
// rate).  This kernel runs f32 FMAs on CUDA cores (67 TFLOP/s peak) with one
// shared-memory load per FMA pair, so it sits one to two orders of magnitude
// above that bound; tensor cores (mma.sync / wgmma), TMA loads and double
// buffering are later work.  Decode (Sq = 1) is bound by the bytes of the
// KV cache, but one 64-row block per (b, h) leaves 63 rows idle and walks
// the whole cache with two threads: it is latency- and occupancy-bound
// (B * Hq blocks on 132 SMs); splitting the KV length across blocks is
// later work.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // query rows per block
constexpr int kBK = 32;    // keys per shared-memory tile
constexpr int kDPT = 32;   // head dims owned by one thread
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ * (DH / kDPT))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int sk, int causal, int window, int q_offset,
                 float scale) {
  constexpr int G = DH / kDPT;       // threads per query row
  constexpr int kChunks = kDPT / 4;  // float4 chunks per thread
  constexpr int kRow4 = DH / 4;      // float4 chunks per key row
  __shared__ float4 ks[kBK][kRow4];
  __shared__ float4 vs[kBK][kRow4];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int q_tile = static_cast<int>(blockIdx.x) * kBQ;
  const int qi = q_tile + tid / G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bool active = qi < sq;
  const int q_pos = q_offset + qi;

  const int64_t q_row = (static_cast<int64_t>(b) * hq + h) * sq + (active ? qi : 0);
  const T* qp = q + q_row * DH;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + hk) * sk * DH;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

  float qr[kDPT];
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (g + G * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] = active ? to_f(qp[d0 + e]) * scale : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // live key range [k_lo, k_hi) of the whole block, tile-aligned below
  const int q_first = q_offset + q_tile;
  const int q_last = q_offset + min(q_tile + kBQ, sq) - 1;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q_first - window + 1);
  k_lo = (k_lo / kBK) * kBK;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * kRow4; idx += blockDim.x) {
      const int j = idx / kRow4;
      const int c = idx % kRow4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (k0 + j < sk) {
        const int64_t off = static_cast<int64_t>(k0 + j) * DH + 4 * c;
        kk = make_float4(to_f(kp[off]), to_f(kp[off + 1]), to_f(kp[off + 2]),
                         to_f(kp[off + 3]));
        vv = make_float4(to_f(vp[off]), to_f(vp[off + 1]), to_f(vp[off + 2]),
                         to_f(vp[off + 3]));
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = ks[j][g + G * i];
        a = fmaf(qr[4 * i], kk.x, a);
        a = fmaf(qr[4 * i + 1], kk.y, a);
        a = fmaf(qr[4 * i + 2], kk.z, a);
        a = fmaf(qr[4 * i + 3], kk.w, a);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        a += __shfl_xor_sync(kFull, a, off);
      s[j] = a;
    }

    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int kpos = k0 + j;
      const bool live = kpos < sk && (!causal || kpos <= q_pos) &&
                        (window < 0 || kpos > q_pos - window);
      s[j] = live ? s[j] : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int kpos = k0 + j;
      const bool live = kpos < sk && (!causal || kpos <= q_pos) &&
                        (window < 0 || kpos > q_pos - window);
      const float p = live ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vs[j][g + G * i];
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (!active) return;
  const float denom = l == 0.f ? 1.f : l;
  T* op = o + q_row * DH;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (g + G * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) store(op + d0 + e, acc[4 * i + e] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int hq, int hkv, int sq, int sk, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, B);
  flash_fwd_kernel<T, DH><<<grid, kBQ * (DH / kDPT), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int B,
                int hq, int hkv, int sq, int sk, int dh, int causal,
                int window, int q_offset, float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, hq, hkv, sq, sk, causal, window,
                           q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, hq, hkv, sq, sk, causal, window,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, hq, hkv, sq, sk, causal, window,
                            q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o all of it).  q and o are
// (B, hq, sq, dh), k and v (B, hkv, sk, dh), all contiguous; hq a multiple
// of hkv; dh in {32, 64, 128}; window < 0 means no window; sq > 0.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int hq,
                                   int hkv, int sq, int sk, int dh, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(q, k, v, o, B, hq, hkv, sq, sk, dh, causal,
                                window, q_offset, scale, s);
    case 1:
      return dispatch_dh<__nv_bfloat16>(q, k, v, o, B, hq, hkv, sq, sk, dh,
                                        causal, window, q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
