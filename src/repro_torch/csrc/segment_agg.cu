// Blocked CSR segment mean, forward and backward: the GraphSAGE neighbour
// mean on Hopper.  The forward kernel comes first; the backward kernel
// (`segment_mean_bwd`) and its notes follow it.
//
// Replaces the TPU kernel `_segment_agg_kernel` of
// src/repro/kernels/segment_agg.py (reached through `segment_agg_blocks`,
// `segment_agg_rows` and `_segment_mean_fwd_impl` -> `segment_mean_op`).
// It computes, for every partition p, node block b and local row r,
//
//     out[p, row_base[p] + b*BN + r] = sum_{slots e of block b with
//         local_dst == r} mask[e] * x[p, src[e]]  /  deg[b, r]   (if mean)
//
// for the rows below num_rows; the caller zero-fills the rest.
//
// Design (not the TPU kernel carried over block by block).  The TPU version
// gathers msgs = x[src] for EVERY padded slot in XLA, then reduces each block
// as a one-hot(BN x BEC) @ msgs matmul on the MXU.  At products-s, P=4,
// the stacked blocks are (4, 140, 12032): 6.74 M slots for 0.75 M real
// edges, so that gather alone moves ~3.4 GB per launch at D=128 f32.  Here
// the kernel is a row-owner CSR SpMM with no atomics:
//   * one warp owns one destination row; lanes stride the feature columns,
//     so each neighbour row is read as coalesced 128-byte lines;
//   * the warp walks that row's real slots in block order
//     ([row_ptr[r], row_ptr[r+1]) of its block, built on the host) and
//     gathers x[src] itself, so no msgs array exists and pad slots are never
//     touched;
//   * src and mask are loaded 32 slots at a time, one per lane, and
//     broadcast with __shfl_sync;
//   * the sum is kept in registers, f32 (f64 for f64 inputs), divided by deg
//     and stored once.  No two warps write the same row, so the result is
//     deterministic and a row's sum runs in its edge order.
//   * one launch covers all P partitions (the grid spans P * nb * BN rows).
//
// Bound.  The kernel does 2 flops per real edge and feature, far below the
// card's rate, so it is bound by bytes.  At products-s, D=128, f32 it must
// read x (4 x 17904 x 128 x 4 B = 36.7 MB) and write the output (36.7 MB),
// plus src (int64) and mask (f32) of the 0.75 M real edges (9 MB) and
// row_ptr/deg (0.6 MB): ~83 MB, ~25 us at 3.35 TB/s.  Hub rows with
// thousands of in-edges serialise on one warp; that imbalance, not the
// bytes, is what a later version should attack (split long rows across
// warps, wgmma-free vectorised loads, persistent blocks).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kColsPerLane = 4;  // a column tile is 32 * 4 = 128 features
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_mean_fwd_kernel(const T* __restrict__ x,
                        const int64_t* __restrict__ src,
                        const float* __restrict__ mask,
                        const int32_t* __restrict__ row_ptr,
                        const float* __restrict__ deg,
                        const int64_t* __restrict__ row_base_per_part,
                        int64_t row_base, T* __restrict__ out, int P, int nb,
                        int be, int bn, int64_t n_in, int64_t num_rows, int d,
                        int mean) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<int64_t>(P) * nb * bn) return;  // warp-uniform
  const int r = static_cast<int>(warp % bn);
  const int64_t pb = warp / bn;  // p * nb + b
  const int b = static_cast<int>(pb % nb);
  const int p = static_cast<int>(pb / nb);
  const int64_t base = row_base_per_part ? row_base_per_part[p] : row_base;
  const int64_t orow = base + static_cast<int64_t>(b) * bn + r;
  if (orow < 0 || orow >= num_rows) return;  // warp-uniform

  const int32_t* rp = row_ptr + pb * (bn + 1);
  const int beg = rp[r];
  const int end = rp[r + 1];
  const int64_t slot0 = pb * be;
  const T* xp = x + static_cast<int64_t>(p) * n_in * d;
  T* op = out + (static_cast<int64_t>(p) * num_rows + orow) * d;
  const A dg = static_cast<A>(deg[pb * bn + r]);

  for (int c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
    A acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] = A(0);
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      long long s = 0;
      A w = A(0);
      if (e < end) {
        s = static_cast<long long>(src[slot0 + e]);
        w = static_cast<A>(mask[slot0 + e]);
      }
      const int cnt = min(32, end - e0);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const long long sj = __shfl_sync(kFull, s, j);
        const A wj = __shfl_sync(kFull, w, j);
        const T* xr = xp + sj * d;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = c0 + k * 32 + lane;
          if (c < d) acc[k] += wj * load_acc(xr + c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = c0 + k * 32 + lane;
      if (c < d) store(op + c, mean ? acc[k] / dg : acc[k]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* src, const void* mask,
                   const void* row_ptr, const void* deg,
                   const void* row_base_per_part, int64_t row_base, void* out,
                   int P, int nb, int be, int bn, int64_t n_in,
                   int64_t num_rows, int d, int mean, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(P) * nb * bn;
  if (warps == 0 || d == 0 || num_rows == 0) return cudaSuccess;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_mean_fwd_kernel<T><<<static_cast<unsigned>(blocks),
                               kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(src),
      static_cast<const float*>(mask), static_cast<const int32_t*>(row_ptr),
      static_cast<const float*>(deg),
      static_cast<const int64_t*>(row_base_per_part), row_base,
      static_cast<T*>(out), P, nb, be, bn, n_in, num_rows, d, mean);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the transpose aggregation.
//
// Replaces the backward use of the same TPU kernel: `segment_agg_bwd_blocks`
// of src/repro/kernels/segment_agg.py (reached through `_segment_mean_bwd`),
// which un-places the cotangent g from row_base, divides it by the forward's
// deg in a materialised copy, and runs `_segment_agg_kernel` over the
// CSC-ordered transpose blocks.  Here, for every partition p and source row
// u = bt*BN + r of transpose block bt,
//
//     dx[p, u] = sum_{slots e of block bt with local_dst == r,
//                     row_base[p] + t_src[e] < num_rows}
//                    t_mask[e] * (g[p, row_base[p] + t_src[e]]
//                                 / deg[p, t_src[e] / BN, t_src[e] % BN])
//
// (divided only if mean), written for u < n_in.  t_src[e] is the forward's
// rebased output row j of the edge, so the un-placement and the 1/deg are
// folded into the gather: no gsub array exists.  The division is a division,
// as the reference computes g / deg, not a product with a reciprocal.
//
// Design: the forward kernel's row-owner walk over the CSC mirror.  One warp
// owns one source row u and walks its real slots [t_row_ptr[r],
// t_row_ptr[r+1]) of its transpose block (built on the host); lanes stride
// the features, so each gathered cotangent row is read as coalesced lines;
// slot metadata is loaded 32 at a time and broadcast with __shfl_sync.  The
// sum stays in registers (f32, f64 for f64) and dx is stored once: no
// atomics, deterministic, each row summed in slot order.  One launch covers
// all P partitions.
//
// Bound: like the forward, bytes.  It reads g (P x num_rows x D), writes dx
// (P x n_in x D) and reads t_src (int64) + t_mask (f32) of the real edges,
// t_row_ptr and deg.  Source rows with many out-edges serialise on one warp,
// as hub rows do in the forward.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_mean_bwd_kernel(const T* __restrict__ g,
                        const int64_t* __restrict__ t_src,
                        const float* __restrict__ t_mask,
                        const int32_t* __restrict__ t_row_ptr,
                        const float* __restrict__ deg,
                        const int64_t* __restrict__ row_base_per_part,
                        int64_t row_base, T* __restrict__ dx, int P, int nb_t,
                        int be_t, int bn, int nb, int64_t num_rows,
                        int64_t n_in, int d, int mean) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<int64_t>(P) * nb_t * bn) return;  // warp-uniform
  const int r = static_cast<int>(warp % bn);
  const int64_t pb = warp / bn;  // p * nb_t + bt
  const int bt = static_cast<int>(pb % nb_t);
  const int p = static_cast<int>(pb / nb_t);
  const int64_t u = static_cast<int64_t>(bt) * bn + r;
  if (u >= n_in) return;  // warp-uniform
  const int64_t base = row_base_per_part ? row_base_per_part[p] : row_base;

  const int32_t* rp = t_row_ptr + pb * (bn + 1);
  const int beg = rp[r];
  const int end = rp[r + 1];
  const int64_t slot0 = pb * be_t;
  const T* gp = g + static_cast<int64_t>(p) * num_rows * d;
  const float* dgp = deg + static_cast<int64_t>(p) * nb * bn;
  T* op = dx + (static_cast<int64_t>(p) * n_in + u) * d;

  for (int c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
    A acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] = A(0);
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      long long orow = -1;  // -1: no slot, or an output row sliced off
      A w = A(0);
      A dg = A(1);
      if (e < end) {
        const long long j = static_cast<long long>(t_src[slot0 + e]);
        const long long o = base + j;
        if (o >= 0 && o < num_rows) {
          orow = o;
          w = static_cast<A>(t_mask[slot0 + e]);
          if (mean) dg = static_cast<A>(dgp[j]);  // j = block * bn + row
        }
      }
      const int cnt = min(32, end - e0);
#pragma unroll 4
      for (int jj = 0; jj < cnt; ++jj) {
        const long long oj = __shfl_sync(kFull, orow, jj);
        const A wj = __shfl_sync(kFull, w, jj);
        const A dj = __shfl_sync(kFull, dg, jj);
        if (oj < 0) continue;  // warp-uniform
        const T* gr = gp + oj * d;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = c0 + k * 32 + lane;
          if (c < d) acc[k] += wj * (load_acc(gr + c) / dj);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = c0 + k * 32 + lane;
      if (c < d) store(op + c, acc[k]);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* t_src, const void* t_mask,
                       const void* t_row_ptr, const void* deg,
                       const void* row_base_per_part, int64_t row_base,
                       void* dx, int P, int nb_t, int be_t, int bn, int nb,
                       int64_t num_rows, int64_t n_in, int d, int mean,
                       cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(P) * nb_t * bn;
  if (warps == 0 || d == 0 || n_in == 0) return cudaSuccess;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_mean_bwd_kernel<T><<<static_cast<unsigned>(blocks),
                               kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int64_t*>(t_src),
      static_cast<const float*>(t_mask),
      static_cast<const int32_t*>(t_row_ptr), static_cast<const float*>(deg),
      static_cast<const int64_t*>(row_base_per_part), row_base,
      static_cast<T*>(dx), P, nb_t, be_t, bn, nb, num_rows, n_in, d, mean);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = bfloat16.  row_base_per_part is a
// device (P,) int64 array or NULL, in which case row_base applies to all.
extern "C" int segment_mean_fwd(int dtype, const void* x, const void* src,
                                const void* mask, const void* row_ptr,
                                const void* deg, const void* row_base_per_part,
                                int64_t row_base, void* out, int P, int nb,
                                int be, int bn, int64_t n_in, int64_t num_rows,
                                int d, int mean, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, src, mask, row_ptr, deg, row_base_per_part,
                           row_base, out, P, nb, be, bn, n_in, num_rows, d,
                           mean, s);
    case 1:
      return launch<double>(x, src, mask, row_ptr, deg, row_base_per_part,
                            row_base, out, P, nb, be, bn, n_in, num_rows, d,
                            mean, s);
    case 2:
      return launch<__nv_bfloat16>(x, src, mask, row_ptr, deg,
                                   row_base_per_part, row_base, out, P, nb, be,
                                   bn, n_in, num_rows, d, mean, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  g is (P, num_rows, D), dx (P, n_in, D); t_src/t_mask are
// (P, nb_t, be_t), t_row_ptr (P, nb_t, bn + 1), deg the forward's
// (P, nb, bn).  row_base_per_part as for segment_mean_fwd.
extern "C" int segment_mean_bwd(int dtype, const void* g, const void* t_src,
                                const void* t_mask, const void* t_row_ptr,
                                const void* deg, const void* row_base_per_part,
                                int64_t row_base, void* dx, int P, int nb_t,
                                int be_t, int bn, int nb, int64_t num_rows,
                                int64_t n_in, int d, int mean, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(g, t_src, t_mask, t_row_ptr, deg,
                               row_base_per_part, row_base, dx, P, nb_t, be_t,
                               bn, nb, num_rows, n_in, d, mean, s);
    case 1:
      return launch_bwd<double>(g, t_src, t_mask, t_row_ptr, deg,
                                row_base_per_part, row_base, dx, P, nb_t,
                                be_t, bn, nb, num_rows, n_in, d, mean, s);
    case 2:
      return launch_bwd<__nv_bfloat16>(g, t_src, t_mask, t_row_ptr, deg,
                                       row_base_per_part, row_base, dx, P,
                                       nb_t, be_t, bn, nb, num_rows, n_in, d,
                                       mean, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
