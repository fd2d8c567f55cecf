// RMSNorm on Hopper, alone or with the residual add fused in front of it.
//
//   rmsnorm_fwd:      y = x * rsqrt(mean(x^2) + eps) * w
//   add_rmsnorm_fwd:  s = round(x + delta) in x's dtype, then y = rmsnorm(s) * w
//
// Replaces the TPU kernel `_rmsnorm_kernel` of src/repro/kernels/rmsnorm.py
// (reached through `rmsnorm_pallas` and `ops.rmsnorm`); the fused entry point
// also takes in the elementwise add that precedes 48 of a decoder pass's 49
// norms.  The math is f32 whatever x's type; w is f32; outputs are written in
// x's dtype with the products in the TPU kernel's order, (x * scale) * w, and
// the norm of the fused entry point is taken from the ROUNDED sum, exactly
// what a separate add and norm compute.
//
// Bound: bytes.  A row is read once and written once (x and delta read, s and
// y written, for the fused one); three to five flops per element are far
// below the card's rate.  At qwen2-0.5b's prefill, 8,192 rows of 896 bf16,
// the norm moves 29.4 MB (8.8 us at 3.35 TB/s) and the fused add and norm
// 58.7 MB (17.5 us), one 14.7 MB pass less than a separate add and norm.
//
// Design (what it does about the bytes):
// - 16-byte vector loads and stores.  A row of d elements is d / kN vectors
//   (kN = 4 at f32, 8 at bf16); `lanes` lanes of a warp share a row, as many
//   as divide the vectors evenly (d = 896: 16 lanes x 7 vectors at bf16, two
//   rows per warp; 32 x 7 at f32), so no lane idles and each lane's columns
//   are the same for every row.
// - The row stays in registers between the reduction and the write (up to 32
//   vectors a lane, so d <= 8,192 at bf16 and 4,096 at f32; fused, with
//   delta's vectors beside them, 16 and half that d), so x and delta are read
//   from device memory once.
// - w is staged once per block in shared memory, not read once per row.
// - The grid is cut to the warps that stay resident, each walking its rows
//   and issuing the next row's loads before it stores the current one, so
//   one row's stores overlap later rows' loads past the first wave.  (A
//   persistent ring of rows streamed into shared memory by cp.async.bulk
//   was measured too, and was slower: PERF.md, PR 16.)
// - Ragged d, a pointer that is not 16-byte aligned, or a row too long for
//   the registers take a scalar path: one warp a row, 32 elements a load,
//   the first 2,048 of a row kept in registers and the rest read again.
// Sums of squares run lane-local, then over a fixed xor-shuffle tree: no
// atomics, and the order depends only on d, so two launches give bitwise
// equal outputs and a row's result does not depend on how many rows there
// are.
//
// The backward, `rmsnorm_bwd` (both entry points; it replaces no TPU kernel:
// the reference trains through the plain-jnp `norm_apply`,
// src/repro/models/layers.py:71, differentiated by autodiff, while the port
// trains through these forward kernels, which autograd cannot see into):
//
//   ds = ds_in + rstd * (w dy - s_hat * mean(s_hat * w dy)),  s_hat = s rstd
//   dw = sum over rows of dy * s_hat  (f32, as w)
//
// with ds_in the gradient of the fused entry point's own output s (absent for
// the plain norm), rstd recomputed from the saved s.  `rms_bwd_kernel` walks
// rows, one block a row at a time (a thread keeps its columns' s and dy in
// registers between the row sums and the write, d <= 8,192), and sums its
// rows' dy * s_hat in registers into one partial row per block;
// `rms_dw_reduce_kernel` adds the partial rows in block order.  No atomics:
// two launches give the same bits.  Bound: bytes (s, dy and ds_in read once,
// ds written once; at qwen2-0.5b's training rows, 4,096 x 896 bf16, 29.4
// MB for the fused use, 8.8 us at 3.35 TB/s, 22 MB and 6.6 us for the plain
// one; the partial rows add blocks x d x 4 bytes each way).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// vectors a lane keeps of a row: alone, and with delta's beside them
constexpr int kMaxVecs = 32;
constexpr int kMaxVecsFused = 16;
constexpr int kScalarCached = 64;         // elements a lane keeps (scalar)
// the backward: threads a block, columns a thread keeps (d <= 8,192)
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxCols = 32;

// ---- element types: 16-byte vectors and single elements -------------------

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void to_f(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 from_f(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // bf16 -> f32 is exact: the bf16 bits are the top half of the f32's
  __device__ __forceinline__ static void to_f(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // round to nearest even, as torch's cast; element 2i in the low half
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 from_f(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// ---- the vector path --------------------------------------------------------

// One row's vectors for this lane: x (the rounded sum, once added) and delta.
template <int NV, bool kFused>
struct RowRegs {
  uint4 x[NV];
  uint4 dx[kFused ? NV : 1];
};

template <typename T, int NV, bool kFused>
__device__ __forceinline__ void load_row(RowRegs<NV, kFused>& r,
                                         const T* __restrict__ x,
                                         const T* __restrict__ delta,
                                         int64_t row, int64_t rows, int nvec,
                                         int lanes, int l) {
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec;
  const uint4* dr = reinterpret_cast<const uint4*>(delta) + row * nvec;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * lanes + l;
    const bool ok = live && c < nvec;
    r.x[v] = ok ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
    if (kFused) r.dx[v] = ok ? __ldg(dr + c) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int NV, bool kFused>
__device__ __forceinline__ void norm_row(RowRegs<NV, kFused>& r,
                                         const float* __restrict__ ws,
                                         T* __restrict__ s, T* __restrict__ y,
                                         int64_t row, int64_t rows, int nvec,
                                         int lanes, int l, int d, float eps) {
  using P = Pack<T>;
  constexpr int kN = P::kN;
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float f[kN];
    if (kFused) {
      float g[kN];
      P::to_f(r.x[v], f);
      P::to_f(r.dx[v], g);
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = f[i] + g[i];
      r.x[v] = P::from_f(f);  // s, rounded to T: the norm reads it back
    }
    P::to_f(r.x[v], f);
#pragma unroll
    for (int i = 0; i < kN; ++i) ss = fmaf(f[i], f[i], ss);
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kFull, ss, off);
  const float scale = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
  if (row >= rows) return;
  uint4* sr = reinterpret_cast<uint4*>(s) + row * nvec;
  uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * lanes + l;
    if (c >= nvec) continue;
    if (kFused) sr[c] = r.x[v];
    float f[kN];
    P::to_f(r.x[v], f);
    const float4* wv = reinterpret_cast<const float4*>(ws) + c * (kN / 4);
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const float4 w4 = wv[j];
      f[4 * j] = f[4 * j] * scale * w4.x;
      f[4 * j + 1] = f[4 * j + 1] * scale * w4.y;
      f[4 * j + 2] = f[4 * j + 2] * scale * w4.z;
      f[4 * j + 3] = f[4 * j + 3] * scale * w4.w;
    }
    yr[c] = P::from_f(f);
  }
}

// ptxas's register budget: told the block size alone (0), it trims the f32
// two-vector instantiation into a spill; a minimum of one block lets it keep
// its registers.  The main path's instantiations keep the block size alone.
template <typename T, int NV>
constexpr int rows_min_blocks() {
  return sizeof(T) == 4 && NV == 2 ? 1 : 0;
}

// Warp w of the grid owns rows (w + k * warps) * rpw + sub, k = 0, 1, ...,
// with rpw = 32 / lanes rows side by side in the warp (sub = lane / lanes).
template <typename T, int NV, bool kFused>
__global__ void __launch_bounds__(kThreads, (rows_min_blocks<T, NV>()))
rms_rows_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const float* __restrict__ w, T* __restrict__ s,
                T* __restrict__ y, int64_t rows, int d, int lanes_log2,
                float eps) {
  // the next row's loads in flight beside the current row: only while both
  // fit the registers
  constexpr bool kPrefetch = NV * (kFused ? 3 : 2) <= 24;
  extern __shared__ float4 w_smem[];
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int l = lane & (lanes - 1);
  const int rpw = 32 >> lanes_log2;
  const int nvec = d / Pack<T>::kN;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * rpw;
  int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * rpw;
  const int sub = lane >> lanes_log2;

  RowRegs<NV, kFused> cur;
  // the first row's loads go out before w is staged
  load_row<T, NV, kFused>(cur, x, delta, base + sub, rows, nvec, lanes, l);
  for (int i = threadIdx.x; i < d / 4; i += kThreads)
    w_smem[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();
  const float* ws = reinterpret_cast<const float*>(w_smem);
  while (base < rows) {  // warp-uniform
    const int64_t next = base + step;
    RowRegs<NV, kFused> nxt;
    if (kPrefetch && next < rows)
      load_row<T, NV, kFused>(nxt, x, delta, next + sub, rows, nvec, lanes,
                              l);
    norm_row<T, NV, kFused>(cur, ws, s, y, base + sub, rows, nvec, lanes, l,
                            d, eps);
    if (next >= rows) break;
    if (!kPrefetch)
      load_row<T, NV, kFused>(nxt, x, delta, next + sub, rows, nvec, lanes,
                              l);
    cur = nxt;
    base = next;
  }
}

// ---- the scalar path ---------------------------------------------------------

// One warp per row, lane-strided single elements; the first 32 * NS of a row
// stay in registers, the rest are read again (and, fused, added again: the
// same rounding, so the same s).  A minimum of one block: told the block
// size alone, ptxas spills the fused bf16 instantiation of 8.
template <typename T, int NS, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
rms_scalar_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                  const float* __restrict__ w, T* __restrict__ s,
                  T* __restrict__ y, int64_t rows, int d, float eps) {
  using P = Pack<T>;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + row * d;
  const T* dr = delta + row * d;
  T* sr = s + row * d;
  T* yr = y + row * d;
  auto value = [&](int c) {
    float v = P::load(xr + c);
    if (kFused) v = P::round(v + P::load(dr + c));
    return v;
  };

  float vals[NS];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = lane + 32 * i;
    const float v = c < d ? value(c) : 0.f;
    vals[i] = v;
    ss = fmaf(v, v, ss);
  }
  for (int c = lane + 32 * NS; c < d; c += 32) {
    const float v = value(c);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  const float scale = 1.f / sqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = lane + 32 * i;
    if (c >= d) continue;
    if (kFused) P::store(sr + c, vals[i]);
    P::store(yr + c, vals[i] * scale * w[c]);
  }
  for (int c = lane + 32 * NS; c < d; c += 32) {
    const float v = value(c);
    if (kFused) P::store(sr + c, v);
    P::store(yr + c, v * scale * w[c]);
  }
}

// ---- host side ---------------------------------------------------------------

template <typename T, int NV, bool kFused>
int launch_rows(const T* x, const T* delta, const float* w, T* s, T* y,
                int64_t rows, int d, int lanes_log2, float eps,
                cudaStream_t stream) {
  auto kernel = rms_rows_kernel<T, NV, kFused>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  // resident blocks, cached per (device, d): the occupancy query is host work
  // on every decode step otherwise
  static int cached_dev = -1, cached_d = -1, resident = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || d != cached_d) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_dev = dev;
    cached_d = d;
  }
  const int64_t rpb = static_cast<int64_t>(kWarps) * (32 >> lanes_log2);
  const int64_t needed = (rows + rpb - 1) / rpb;
  // past one wave, every warp walks the same number of rows
  const int64_t per = (needed + resident - 1) / resident;
  const int64_t blocks = (needed + per - 1) / per;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, delta, w, s, y, rows, d, lanes_log2, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NS, bool kFused>
int launch_scalar(const T* x, const T* delta, const float* w, T* s, T* y,
                  int64_t rows, int d, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  rms_scalar_kernel<T, NS, kFused>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, delta, w, s, y, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool kFused>
int dispatch(const void* xv, const void* dv, const void* wv, void* sv,
             void* yv, int64_t rows, int d, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* delta = static_cast<const T*>(kFused ? dv : xv);
  const float* w = static_cast<const float*>(wv);
  T* s = static_cast<T*>(kFused ? sv : yv);
  T* y = static_cast<T*>(yv);
  constexpr int kN = Pack<T>::kN;
  // the vector path: whole 16-byte vectors in every row (d * sizeof(T) is the
  // row pitch of these contiguous tensors), every pointer 16-byte aligned
  const int nvec = d / kN;
  bool vec = d % kN == 0 && aligned16(x) && aligned16(y) && aligned16(w);
  if (kFused) vec = vec && aligned16(delta) && aligned16(s);
  if (vec) {
    // as many lanes per row as divide the row's vectors (at most 32), else
    // all 32 with the tail masked
    int lanes_log2 = 5;
    while (lanes_log2 > 0 && nvec % (1 << lanes_log2) != 0) --lanes_log2;
    const int max_vecs = kFused ? kMaxVecsFused : kMaxVecs;
    if (nvec / (1 << lanes_log2) > max_vecs) lanes_log2 = 5;
    const int nv = (nvec + (1 << lanes_log2) - 1) >> lanes_log2;
#define RMS_ROWS(NV)                                                          \
  if (nv <= NV)                                                               \
    return launch_rows<T, NV, kFused>(x, delta, w, s, y, rows, d, lanes_log2, \
                                      eps, stream);
    RMS_ROWS(1)
    RMS_ROWS(2)
    RMS_ROWS(4)
    RMS_ROWS(7)
    RMS_ROWS(8)
    RMS_ROWS(16)
    if constexpr (!kFused) {
      RMS_ROWS(32)
    }
#undef RMS_ROWS
  }
  const int per_lane = (d + 31) / 32;
  if (per_lane <= 2)
    return launch_scalar<T, 2, kFused>(x, delta, w, s, y, rows, d, eps,
                                       stream);
  if (per_lane <= 8)
    return launch_scalar<T, 8, kFused>(x, delta, w, s, y, rows, d, eps,
                                       stream);
  if (per_lane <= 32)
    return launch_scalar<T, 32, kFused>(x, delta, w, s, y, rows, d, eps,
                                        stream);
  return launch_scalar<T, kScalarCached, kFused>(x, delta, w, s, y, rows, d,
                                                 eps, stream);
}

// ---- the backward ----------------------------------------------------------

// One block walks rows blockIdx.x, blockIdx.x + gridDim.x, ...; thread t owns
// columns t + 256 i (i < NC) of every row, keeps the row's s and dy there
// between the two row sums and the write, and sums dw over its rows in
// registers.  The row sums run lane-local, over a fixed xor-shuffle tree,
// then over the 8 warps in order: no atomics.  Two slots of the warp sums
// alternate between rows, so one barrier a row suffices.
template <typename T, int NC, bool kIn>
__global__ void __launch_bounds__(kBwdThreads)
rms_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
               const T* __restrict__ ds_in, const float* __restrict__ w,
               T* __restrict__ ds, float* __restrict__ dw_part, int64_t rows,
               int d, float eps) {
  __shared__ float red[2][kBwdThreads / 32][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float wv[NC], dw_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = tid + kBwdThreads * i;
    wv[i] = c < d ? w[c] : 0.f;
    dw_acc[i] = 0.f;
  }
  int slot = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* sr = s + row * d;
    const T* gr = dy + row * d;
    float sv[NC], gv[NC];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tid + kBwdThreads * i;
      sv[i] = c < d ? Pack<T>::load(sr + c) : 0.f;
      gv[i] = c < d ? Pack<T>::load(gr + c) : 0.f;
      ss = fmaf(sv[i], sv[i], ss);
      sg = fmaf(sv[i], gv[i] * wv[i], sg);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(kFull, ss, off);
      sg += __shfl_xor_sync(kFull, sg, off);
    }
    if (lane == 0) {
      red[slot][warp][0] = ss;
      red[slot][warp][1] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdThreads / 32; ++k) {
      ss += red[slot][k][0];
      sg += red[slot][k][1];
    }
    slot ^= 1;
    const float rstd = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
    // mean(s_hat * w * dy) with s_hat = s * rstd
    const float proj = sg * rstd / static_cast<float>(d);
    T* out = ds + row * d;
    const T* in = kIn ? ds_in + row * d : nullptr;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tid + kBwdThreads * i;
      if (c >= d) continue;
      const float shat = sv[i] * rstd;
      float g = rstd * (gv[i] * wv[i] - shat * proj);
      if (kIn) g += Pack<T>::load(in + c);
      Pack<T>::store(out + c, g);
      dw_acc[i] = fmaf(gv[i], shat, dw_acc[i]);
    }
  }
  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = tid + kBwdThreads * i;
    if (c < d) part[c] = dw_acc[i];
  }
}

// dw[c] = sum over the row pass's blocks, in block order, of their partials
__global__ void __launch_bounds__(kBwdThreads)
rms_dw_reduce_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                     int blocks, int d) {
  const int c = blockIdx.x * kBwdThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b)
    acc += dw_part[static_cast<int64_t>(b) * d + c];
  dw[c] = acc;
}

template <typename T, int NC, bool kIn>
int launch_bwd(const void* s, const void* dy, const void* ds_in,
               const void* w, void* ds, float* dw_part, float* dw,
               int64_t rows, int d, int blocks, float eps,
               cudaStream_t stream) {
  rms_bwd_kernel<T, NC, kIn><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(dy),
      static_cast<const T*>(ds_in), static_cast<const float*>(w),
      static_cast<T*>(ds), dw_part, rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_dw_reduce_kernel<<<(d + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0,
                         stream>>>(dw_part, dw, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kIn>
int dispatch_bwd(const void* s, const void* dy, const void* ds_in,
                 const void* w, void* ds, float* dw_part, float* dw,
                 int64_t rows, int d, int blocks, float eps,
                 cudaStream_t stream) {
#define RMS_BWD(NC)                                                         \
  if (d <= NC * kBwdThreads)                                                \
    return launch_bwd<T, NC, kIn>(s, dy, ds_in, w, ds, dw_part, dw, rows, d, \
                                  blocks, eps, stream);
  RMS_BWD(1)
  RMS_BWD(2)
  RMS_BWD(4)
  RMS_BWD(8)
  RMS_BWD(16)
  RMS_BWD(kBwdMaxCols)
#undef RMS_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, delta, s and y).  x, delta, s and y are
// (rows, d) contiguous, w is (d,) float32; rows > 0.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* y,
                           int64_t rows, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float, false>(x, nullptr, w, nullptr, y, rows, d, eps,
                                    st);
    case 1:
      return dispatch<__nv_bfloat16, false>(x, nullptr, w, nullptr, y, rows,
                                            d, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int add_rmsnorm_fwd(int dtype, const void* x, const void* delta,
                               const void* w, void* s, void* y, int64_t rows,
                               int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float, true>(x, delta, w, s, y, rows, d, eps, st);
    case 1:
      return dispatch<__nv_bfloat16, true>(x, delta, w, s, y, rows, d, eps,
                                           st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of either entry point.  s is what the forward normalised (x,
// or the rounded sum of add_rmsnorm_fwd), dy the gradient of y, ds_in null
// (rmsnorm) or the gradient of the fused entry point's output s; all (rows,
// d) contiguous in dtype, w (d,) float32.  Writes ds = ds_in + rstd (w dy -
// s_hat mean(s_hat w dy)), s_hat = s rstd, in dtype (for add_rmsnorm the
// gradient of both x and delta), and dw = sum over rows of dy s_hat in
// float32 through dw_part, float32 scratch of blocks * d: block b of the row
// pass writes its partial row there and a second pass sums them in order.
// rows > 0, 0 < blocks <= rows, d <= 8,192.
extern "C" int rmsnorm_bwd(int dtype, const void* s, const void* dy,
                           const void* ds_in, const void* w, void* ds,
                           float* dw_part, float* dw, int64_t rows, int d,
                           int blocks, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool in = ds_in != nullptr;
  switch (dtype) {
    case 0:
      return in ? dispatch_bwd<float, true>(s, dy, ds_in, w, ds, dw_part, dw,
                                            rows, d, blocks, eps, st)
                : dispatch_bwd<float, false>(s, dy, ds_in, w, ds, dw_part,
                                             dw, rows, d, blocks, eps, st);
    case 1:
      return in ? dispatch_bwd<__nv_bfloat16, true>(s, dy, ds_in, w, ds,
                                                    dw_part, dw, rows, d,
                                                    blocks, eps, st)
                : dispatch_bwd<__nv_bfloat16, false>(s, dy, ds_in, w, ds,
                                                     dw_part, dw, rows, d,
                                                     blocks, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
