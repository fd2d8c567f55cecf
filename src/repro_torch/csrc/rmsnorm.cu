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
// the plain norm), rstd recomputed from the saved s.  Bound: bytes (s, dy
// and ds_in read once, ds written once; at qwen2-0.5b's training rows, 4,096
// x 896 bf16, 29.4 MB for the fused use, 8.8 us at 3.35 TB/s, 22 MB and 6.6
// us for the plain one).  One launch a call, both uses and both dtypes:
// - `rms_bwd_rows_kernel`, the vector path, is the forward's layout: 16-byte
//   vectors, `lanes` lanes of a warp a row (d = 896 bf16: 16 lanes x 7
//   vectors, two rows a warp), rows walked per warp with no block barrier
//   per row, the next row's loads issued before the current row's stores
//   where the registers hold both (up to 12 vectors of the three arrays).
//   A row's s, dy (and ds_in) stay in registers from the load to the write;
//   each warp adds dy * s_hat into its own dw row in shared memory (its
//   sub-rows in turn), so the registers hold nothing per column across
//   rows, and two 8-warp blocks fit an SM.  At d = 896 bf16 (7 vectors a
//   lane) a row is 14 vectors (21 fused), so the next row is loaded after
//   the current row's stores: the 128 registers two blocks an SM leave a
//   thread hold one row, not two (ptxas: 126 registers and no spill plain,
//   128 and 32 bytes of spill stores fused).  At the training rows (4,096)
//   it does not matter: the grid's 264 x 8 warps x 2 rows cover 4,224
//   rows, so no warp has a next row and each warp's loads go out together.
// - `rms_bwd_kernel`, the wide path (ragged d, pointers off 16 bytes, rows
//   past 8 vectors a lane): one block a row at a time, a thread keeping its
//   columns of s and dy in registers (d <= 8,192) and its dw sums too.
// - dw in the same launch (`dw_finish`): each block reduces its warps' dw
//   rows in warp order and writes one partial row; the last block of each
//   group of ~sqrt(blocks) blocks to arrive (a ticket counter after
//   __threadfence()) sums its group's rows in block order, and the last
//   group's reducer sums the group rows in group order and writes dw.  Two
//   levels keep the rows any one block reads to ~2 sqrt(blocks) (a single
//   reducer would read all blocks x d x 4 bytes through one SM).  Each last
//   block sets its counter back to 0, so no memset launch precedes the
//   next call; the counters are one small device buffer the wrapper
//   caches per device, which serialises calls on it: the port runs them on
//   one stream.  The partial rows move (blocks + groups) x d x 4 bytes each
//   way beyond the bound's, 0.95 MB at 264 x 896, mostly in L2.
// No atomics in any sum: a row's ds depends on d alone (its lane layout),
// never on the grid or the row count, and dw's order on the grid, which the
// wrapper derives from the SM count alone; two launches give the same bits.
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
// the backward: vectors a lane keeps of each of s, dy and ds_in (the
// vector path); columns a thread keeps on the wide path (d <= 8,192)
constexpr int kBwdMaxVecs = 8;
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

// dst[c] = sum over rows [lo, hi) of src[r][c], each column in row order;
// a thread's loads of kB rows go out together (the rows were just written
// by other blocks: read from L2), so a sum of n rows waits n / kB times
template <int kB>
__device__ __forceinline__ void sum_rows(const float* __restrict__ src,
                                         int lo, int hi,
                                         float* __restrict__ dst, int d) {
  if ((d & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int d4 = d >> 2;
    for (int c = threadIdx.x; c < d4; c += blockDim.x) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = lo; r0 < hi; r0 += kB) {
        float4 v[kB];
#pragma unroll
        for (int i = 0; i < kB; ++i)
          v[i] = r0 + i < hi
                     ? __ldcg(s4 + static_cast<int64_t>(r0 + i) * d4 + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kB; ++i) {
          a.x += v[i].x;
          a.y += v[i].y;
          a.z += v[i].z;
          a.w += v[i].w;
        }
      }
      reinterpret_cast<float4*>(dst)[c] = a;
    }
    return;
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.f;
    for (int r0 = lo; r0 < hi; r0 += kB) {
      float v[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i)
        v[i] = r0 + i < hi ? __ldcg(src + static_cast<int64_t>(r0 + i) * d + c)
                           : 0.f;
#pragma unroll
      for (int i = 0; i < kB; ++i) a += v[i];
    }
    dst[c] = a;
  }
}

// dw's sum across the grid, in the same launch.  Block b has written its
// partial row part[b]; blocks are taken in groups of `group` consecutive
// blocks.  The last block of a group to arrive (a ticket after
// __threadfence()) sums the group's rows in block order into
// part[gridDim.x + group index]; the last group to finish sums those rows
// in group order into dw.  Each last block sets its counter back to 0, so
// the next call finds them zero without a memset launch.  The order is
// fixed by the grid alone: two launches give the same bits.
__device__ void dw_finish(float* __restrict__ part, float* __restrict__ dw,
                          unsigned* __restrict__ counters, int d, int group) {
  constexpr int kB = 16;  // rows whose loads go out together
  __shared__ unsigned ticket;
  const int nb = static_cast<int>(gridDim.x);
  const int ngroups = (nb + group - 1) / group;
  const int grp = static_cast<int>(blockIdx.x) / group;
  const int lo = grp * group;
  const int hi = min(lo + group, nb);
  __threadfence();  // this block's partial row, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counters + grp, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>(hi - lo - 1)) return;
  __threadfence();
  sum_rows<kB>(part, lo, hi, part + static_cast<int64_t>(nb + grp) * d, d);
  if (threadIdx.x == 0) counters[grp] = 0u;
  __threadfence();  // the group's row, before the group's ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counters + ngroups, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>(ngroups - 1)) return;
  __threadfence();
  sum_rows<kB>(part + static_cast<int64_t>(nb) * d, 0, ngroups, dw, d);
  if (threadIdx.x == 0) counters[ngroups] = 0u;
}

// The vector path: one row's vectors for this lane, s and dy (and ds_in).
template <int NV, bool kIn>
struct BwdRegs {
  uint4 s[NV];
  uint4 g[NV];
  uint4 in[kIn ? NV : 1];
};

template <typename T, int NV, bool kIn>
__device__ __forceinline__ void load_bwd_row(BwdRegs<NV, kIn>& r,
                                             const T* __restrict__ s,
                                             const T* __restrict__ dy,
                                             const T* __restrict__ ds_in,
                                             int64_t row, int64_t rows,
                                             int nvec, int lanes, int l) {
  const bool live = row < rows;
  const int64_t base = row * nvec;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * lanes + l;
    const bool ok = live && c < nvec;
    r.s[v] = ok ? __ldg(reinterpret_cast<const uint4*>(s) + base + c) : zero;
    r.g[v] = ok ? __ldg(reinterpret_cast<const uint4*>(dy) + base + c) : zero;
    if (kIn)
      r.in[v] =
          ok ? __ldg(reinterpret_cast<const uint4*>(ds_in) + base + c) : zero;
  }
}

// One row: its two sums over the lane group, ds written, dy * s_hat added
// into this warp's dw row `wacc` (the warp's sub-rows share columns, so
// they add in turn)
template <typename T, int NV, bool kIn>
__device__ __forceinline__ void bwd_row(const BwdRegs<NV, kIn>& r,
                                        const float* __restrict__ ws,
                                        float* __restrict__ wacc,
                                        T* __restrict__ ds, int64_t row,
                                        int64_t rows, int nvec, int lanes,
                                        int l, int sub, int rpw, int d,
                                        float eps) {
  using P = Pack<T>;
  constexpr int kN = P::kN;
  float ss = 0.f, sg = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * lanes + l;
    if (c >= nvec) continue;
    float f[kN], g[kN];
    P::to_f(r.s[v], f);
    P::to_f(r.g[v], g);
    const float* wv = ws + c * kN;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      ss = fmaf(f[i], f[i], ss);
      sg = fmaf(f[i], g[i] * wv[i], sg);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(kFull, ss, off);
    sg += __shfl_xor_sync(kFull, sg, off);
  }
  const float rstd = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
  // mean(s_hat * w * dy) with s_hat = s * rstd
  const float proj = sg * rstd / static_cast<float>(d);
  const bool live = row < rows;
  if (live) {
    uint4* out = reinterpret_cast<uint4*>(ds) + row * nvec;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * lanes + l;
      if (c >= nvec) continue;
      float f[kN], g[kN], o[kN];
      P::to_f(r.s[v], f);
      P::to_f(r.g[v], g);
      if (kIn) P::to_f(r.in[v], o);
      const float* wv = ws + c * kN;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float shat = f[i] * rstd;
        const float x = rstd * (g[i] * wv[i] - shat * proj);
        o[i] = kIn ? x + o[i] : x;
      }
      out[c] = P::from_f(o);
    }
  }
  for (int k = 0; k < rpw; ++k) {
    if (live && sub == k) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = v * lanes + l;
        if (c >= nvec) continue;
        float f[kN], g[kN];
        P::to_f(r.s[v], f);
        P::to_f(r.g[v], g);
        float4* a4 = reinterpret_cast<float4*>(wacc + c * kN);
#pragma unroll
        for (int j = 0; j < kN / 4; ++j) {
          float4 a = a4[j];
          a.x = fmaf(g[4 * j], f[4 * j] * rstd, a.x);
          a.y = fmaf(g[4 * j + 1], f[4 * j + 1] * rstd, a.y);
          a.z = fmaf(g[4 * j + 2], f[4 * j + 2] * rstd, a.z);
          a.w = fmaf(g[4 * j + 3], f[4 * j + 3] * rstd, a.w);
          a4[j] = a;
        }
      }
    }
    __syncwarp();
  }
}

// The vector path, the forward's layout: warp w of the grid owns rows
// (w + k * warps) * rpw + sub, `lanes` lanes a row, no block barrier per
// row; the next row's loads go out before the current row's stores where
// the registers hold both.  Two blocks an SM: with the dw sums in shared
// memory, s, dy and ds_in are what the registers hold.  Dynamic shared
// memory: w (d floats), then one dw row per warp (kWarps x d floats).
template <typename T, int NV, bool kIn>
__global__ void __launch_bounds__(kThreads, 2)
rms_bwd_rows_kernel(const T* __restrict__ s, const T* __restrict__ dy,
                    const T* __restrict__ ds_in, const float* __restrict__ w,
                    T* __restrict__ ds, float* __restrict__ part,
                    float* __restrict__ dw, unsigned* __restrict__ counters,
                    int64_t rows, int d, int lanes_log2, float eps,
                    int group) {
  constexpr bool kPrefetch = NV * (kIn ? 3 : 2) <= 12;
  extern __shared__ float4 bwd_smem[];
  float* ws = reinterpret_cast<float*>(bwd_smem);
  float* acc = ws + d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = 1 << lanes_log2;
  const int l = lane & (lanes - 1);
  const int rpw = 32 >> lanes_log2;
  const int sub = lane >> lanes_log2;
  const int nvec = d / Pack<T>::kN;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * rpw;
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * rpw;
  float* wacc = acc + warp * d;

  BwdRegs<NV, kIn> cur;
  // the first row's loads go out before w is staged
  load_bwd_row<T, NV, kIn>(cur, s, dy, ds_in, base + sub, rows, nvec, lanes,
                           l);
  for (int i = threadIdx.x; i < d / 4; i += kThreads)
    bwd_smem[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  for (int i = lane; i < d / 4; i += 32)
    reinterpret_cast<float4*>(wacc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  while (base < rows) {  // warp-uniform
    const int64_t next = base + step;
    BwdRegs<NV, kIn> nxt;
    if (kPrefetch && next < rows)
      load_bwd_row<T, NV, kIn>(nxt, s, dy, ds_in, next + sub, rows, nvec,
                               lanes, l);
    bwd_row<T, NV, kIn>(cur, ws, wacc, ds, base + sub, rows, nvec, lanes, l,
                        sub, rpw, d, eps);
    if (next >= rows) break;
    if (!kPrefetch)
      load_bwd_row<T, NV, kIn>(nxt, s, dy, ds_in, next + sub, rows, nvec,
                               lanes, l);
    cur = nxt;
    base = next;
  }
  __syncthreads();
  // the block's partial row: its warps' rows in warp order
  float* prow = part + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) a += acc[k * d + c];
    prow[c] = a;
  }
  dw_finish(part, dw, counters, d, group);
}

// The wide path (ragged d, a pointer off 16 bytes, or a row past the
// vector path's registers): one block walks rows blockIdx.x, blockIdx.x +
// gridDim.x, ...; thread t owns columns t + 256 i (i < NC) of every row,
// keeps the row's s and dy there between the two row sums and the write,
// and sums dw over its rows in registers, which are then the block's
// partial row.  The row sums run lane-local, over a fixed xor-shuffle
// tree, then over the 8 warps in order.  Two slots of the warp sums
// alternate between rows, so one barrier a row suffices.
template <typename T, int NC, bool kIn>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
               const T* __restrict__ ds_in, const float* __restrict__ w,
               T* __restrict__ ds, float* __restrict__ part,
               float* __restrict__ dw, unsigned* __restrict__ counters,
               int64_t rows, int d, float eps, int group) {
  __shared__ float red[2][kWarps][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float wv[NC], dw_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = tid + kThreads * i;
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
      const int c = tid + kThreads * i;
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
    for (int k = 0; k < kWarps; ++k) {
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
      const int c = tid + kThreads * i;
      if (c >= d) continue;
      const float shat = sv[i] * rstd;
      float g = rstd * (gv[i] * wv[i] - shat * proj);
      if (kIn) g += Pack<T>::load(in + c);
      Pack<T>::store(out + c, g);
      dw_acc[i] = fmaf(gv[i], shat, dw_acc[i]);
    }
  }
  float* prow = part + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = tid + kThreads * i;
    if (c < d) prow[c] = dw_acc[i];
  }
  dw_finish(part, dw, counters, d, group);
}

template <typename T, int NV, bool kIn>
int launch_bwd_rows(const T* s, const T* dy, const T* ds_in, const float* w,
                    T* ds, float* part, float* dw, unsigned* counters,
                    int64_t rows, int d, int lanes_log2, int blocks, int group,
                    float eps, cudaStream_t stream) {
  auto kernel = rms_bwd_rows_kernel<T, NV, kIn>;
  const int smem = (1 + kWarps) * d * static_cast<int>(sizeof(float));
  // above 48 KB a block's dynamic shared memory needs the attribute
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(s, dy, ds_in, w, ds, part, dw,
                                             counters, rows, d, lanes_log2,
                                             eps, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC, bool kIn>
int launch_bwd_wide(const T* s, const T* dy, const T* ds_in, const float* w,
                    T* ds, float* part, float* dw, unsigned* counters,
                    int64_t rows, int d, int blocks, int group, float eps,
                    cudaStream_t stream) {
  rms_bwd_kernel<T, NC, kIn><<<blocks, kThreads, 0, stream>>>(
      s, dy, ds_in, w, ds, part, dw, counters, rows, d, eps, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kIn>
int dispatch_bwd(const void* sv, const void* dyv, const void* inv,
                 const void* wv, void* dsv, float* part, float* dw,
                 unsigned* counters, int64_t rows, int d, int blocks,
                 int group, float eps, cudaStream_t stream) {
  const T* s = static_cast<const T*>(sv);
  const T* dy = static_cast<const T*>(dyv);
  const T* ds_in = static_cast<const T*>(inv);
  const float* w = static_cast<const float*>(wv);
  T* ds = static_cast<T*>(dsv);
  constexpr int kN = Pack<T>::kN;
  // the vector path: whole 16-byte vectors in every row, every pointer
  // 16-byte aligned, at most kBwdMaxVecs vectors a lane
  const int nvec = d / kN;
  bool vec = d % kN == 0 && aligned16(s) && aligned16(dy) && aligned16(ds) &&
             aligned16(w);
  if (kIn) vec = vec && aligned16(ds_in);
  if (vec) {
    // as many lanes per row as divide the row's vectors (at most 32), else
    // all 32 with the tail masked
    int lanes_log2 = 5;
    while (lanes_log2 > 0 && nvec % (1 << lanes_log2) != 0) --lanes_log2;
    if (nvec / (1 << lanes_log2) > kBwdMaxVecs) lanes_log2 = 5;
    const int nv = (nvec + (1 << lanes_log2) - 1) >> lanes_log2;
#define RMS_BWD_ROWS(NV)                                                    \
  if (nv <= NV)                                                             \
    return launch_bwd_rows<T, NV, kIn>(s, dy, ds_in, w, ds, part, dw,       \
                                       counters, rows, d, lanes_log2,       \
                                       blocks, group, eps, stream);
    RMS_BWD_ROWS(1)
    RMS_BWD_ROWS(2)
    RMS_BWD_ROWS(4)
    RMS_BWD_ROWS(7)
    RMS_BWD_ROWS(8)
#undef RMS_BWD_ROWS
  }
#define RMS_BWD_WIDE(NC)                                                     \
  if (d <= NC * kThreads)                                                    \
    return launch_bwd_wide<T, NC, kIn>(s, dy, ds_in, w, ds, part, dw,        \
                                       counters, rows, d, blocks, group, eps, \
                                       stream);
  RMS_BWD_WIDE(1)
  RMS_BWD_WIDE(2)
  RMS_BWD_WIDE(4)
  RMS_BWD_WIDE(8)
  RMS_BWD_WIDE(16)
  RMS_BWD_WIDE(kBwdMaxCols)
#undef RMS_BWD_WIDE
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

// The backward of either entry point, one launch.  s is what the forward
// normalised (x, or the rounded sum of add_rmsnorm_fwd), dy the gradient of
// y, ds_in null (rmsnorm) or the gradient of the fused entry point's output
// s; all (rows, d) contiguous in dtype, w (d,) float32.  Writes ds = ds_in
// + rstd (w dy - s_hat mean(s_hat w dy)), s_hat = s rstd, in dtype (for
// add_rmsnorm the gradient of both x and delta), and dw = sum over rows of
// dy s_hat in float32.  The grid is `blocks` blocks in groups of `group`;
// part is float32 scratch of (blocks + ceil(blocks / group)) * d: each
// block's partial dw row, then each group's.  counters holds
// ceil(blocks / group) + 1 unsigned ints, all 0 on entry and on return:
// calls that share them run one after another (one stream).  rows > 0,
// d <= 8,192.
extern "C" int rmsnorm_bwd(int dtype, const void* s, const void* dy,
                           const void* ds_in, const void* w, void* ds,
                           float* part, float* dw, unsigned* counters,
                           int64_t rows, int d, int blocks, int group,
                           float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool in = ds_in != nullptr;
  if (blocks < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
#define RMS_BWD(T, IN)                                                      \
  return dispatch_bwd<T, IN>(s, dy, ds_in, w, ds, part, dw, counters, rows, \
                             d, blocks, group, eps, st)
  switch (dtype) {
    case 0:
      if (in) RMS_BWD(float, true);
      RMS_BWD(float, false);
    case 1:
      if (in) RMS_BWD(__nv_bfloat16, true);
      RMS_BWD(__nv_bfloat16, false);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RMS_BWD
}
