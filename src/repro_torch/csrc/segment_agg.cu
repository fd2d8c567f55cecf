// Blocked CSR segment mean, forward and backward: the GraphSAGE neighbour
// mean on Hopper, as split row gathers driven by a host-built work plan.
//
// Replaces the TPU kernel `_segment_agg_kernel` of
// src/repro/kernels/segment_agg.py, in both of its uses:
//   * forward (`segment_agg_blocks`, `segment_agg_rows`,
//     `_segment_mean_fwd_impl` -> `segment_mean_op`): for every partition p,
//     node block b and local row r,
//
//       out[p, row_base[p] + b*BN + r] = sum_{slots e of block b with
//           local_dst == r} mask[e] * x[p, src[e]]  /  deg[b, r]   (if mean)
//
//     for the rows below num_rows;
//   * backward (`segment_agg_bwd_blocks` via `_segment_mean_bwd`): as the
//     reference spells it, un-place the cotangent g from row_base and divide
//     it by deg once per row (`gsub`, rows the forward cut off at num_rows
//     read 0), then run the same aggregation with mean=False over the
//     CSC-ordered transpose blocks into dx (P, n_in, D).
//
// Design (not the TPU kernel carried over block by block: that one gathers
// x[src] for every padded slot and reduces a block as a one-hot x messages
// matmul on the MXU).  Here one gather body serves both directions:
//   * Work plan.  The host (kernels/segment_agg.py::block_row_work) cuts
//     every row with edges into items of at most K (128) consecutive real
//     slots and lists, in launch order, the items of split rows (`row_part`,
//     one f32/f64 partial row each), then the rows with one item and the
//     runs of empty rows (`row_work`), then the split rows and their partial
//     ranges (`row_split`).  One warp takes one entry, so a hub row of
//     thousands of edges is spread over many warps instead of walked by one,
//     and no warp is launched per empty row (a run of up to 32 empty rows
//     is one entry that stores zeros).
//   * Loads in flight.  A warp loads 32 slots of (src, mask) once, one per
//     lane, broadcasts them with __shfl_sync (src as 32 bits), and issues
//     the gathers of 8 edges into registers before the first add.  Lanes
//     own consecutive features: 16-byte loads where the row allows (float4
//     at f32, double2 at f64, 8 x bf16), one element a lane otherwise.  A
//     row of at most half the 16-byte tile (D <= 64 at f32 and f64, D <= 128
//     at bf16) takes half-width vectors instead (float2, one double2, 4 x
//     bf16), so every lane of the warp has features and the kernel holds
//     half the registers.
//   * Fixed order, no atomics.  An item sums its edges in slot order; a row
//     of one item divides by deg and stores its result; a split row's
//     partials are added in item order by a second small grid
//     (`segment_merge_kernel`), which divides by deg once and stores.  Two
//     launches give the same bits.
//   * The backward divides once per placed row and feature (the pre-pass
//     `segment_unplace_kernel`), not once per edge and feature: the same
//     IEEE quotient g / deg as before, so f64 dyadic inputs stay bitwise.
//
// Bound.  2 flops per real edge and feature, far below the card's rate:
// bytes bound.  At products-s, D=128, f32 the forward must read x (36.7 MB)
// and write the output (36.7 MB) plus src/mask of the 0.75 M real edges:
// ~83 MB, ~25 us at 3.35 TB/s.  The gathers themselves move E*D*4 = 384 MB
// between L2 and the SMs (x fits the 50 MB L2), which is what the split
// gather is paced by.
//
// Where trouble is likely, and what the code does about it:
//   * 16-byte alignment.  The vector path needs D % V == 0 and 16-byte
//     aligned bases of x (hence of x + p*n_in*D and every row), out and the
//     scratch; the launchers check the pointers and D, and take the scalar
//     path otherwise (D=130, a view at an odd offset).
//   * Rows the forward cuts off at num_rows.  Every entry computes its output
//     row from the flat row and row_base and drops rows outside [0,
//     num_rows); the backward's pre-pass writes 0 for them, as the reference
//     un-places them.
//   * A negative or per-partition row_base (`row_base_per_part`, a (P,)
//     int64 device array, or NULL and the scalar row_base).  The flat row
//     of an entry is ((p*nb + b)*BN + r); p comes from it, never from the
//     grid.
//   * Sizing the partial buffer.  It has one row per `row_part` entry, so
//     its size is a shape the host knows without reading the device: the
//     wrapper allocates it (torch.empty) with row_part.shape[0] rows.
//   * Shared memory.  None is used (static shared memory above 48 KiB does
//     not build).
//   * Register budget.  ptxas spills some instantiations when it is told
//     only the block size; gather_min_blocks() sets it per instantiation.
//   * The ctypes interface: every pointer and the stream as c_void_p, the
//     64-bit sizes as c_int64 (kernels/segment_agg.py::_kernel_fn).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 8;  // gathered rows loaded before the first add
constexpr int kChunk = 32;    // slots whose (src, mask) a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float& o, float v) { o = v; }
__device__ __forceinline__ void put(double& o, double v) { o = v; }
__device__ __forceinline__ void put(__nv_bfloat16& o, float v) {
  o = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// V consecutive elements at p, converted to the accumulation type; one load
// of V * sizeof(T) bytes (two where that is above 16).  p is aligned to it.
template <int V, typename T, typename A>
__device__ __forceinline__ void load_vec(const T* p, A* out) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  if constexpr (kBytes > 16) {
    load_vec<V / 2, T, A>(p, out);
    load_vec<V / 2, T, A>(p + V / 2, out + V / 2);
  } else {
    using R = typename Raw<kBytes>::type;
    const R r = __ldg(reinterpret_cast<const R*>(p));
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_acc(t[i]);
  }
}

template <int V, typename T, typename A>
__device__ __forceinline__ void store_vec(T* p, const A* v) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  if constexpr (kBytes > 16) {
    store_vec<V / 2, T, A>(p, v);
    store_vec<V / 2, T, A>(p + V / 2, v + V / 2);
  } else {
    using R = typename Raw<kBytes>::type;
    R r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) put(t[i], v[i]);
    *reinterpret_cast<R*>(p) = r;
  }
}

// Output row of flat row ((p*nb + b)*bn + r), and its partition p.
__device__ __forceinline__ int64_t place(int64_t row, int nb, int bn,
                                         const int64_t* row_base_per_part,
                                         int64_t row_base, int* p) {
  const int64_t pb = row / bn;
  *p = static_cast<int>(pb / nb);
  const int64_t base = row_base_per_part ? row_base_per_part[*p] : row_base;
  return base + (pb % nb) * bn + row % bn;
}

// Blocks of the gather an SM must hold (launch bounds), i.e. ptxas's
// register budget.  Given the block size alone (0 here), ptxas trims some
// instantiations to 48 or 64 registers and spills (32-48-byte stack frames:
// the f32 half-width and one-element paths, f64 and bf16 half-width); at 1
// it takes its own count and spills nowhere, but gives the f32 16-byte tile
// 85 registers, which runs the products-s D=128 gathers ~21% slower than
// the 64 it gets, without a spill, from the block size alone (at 4, a hard
// cap of 64, it spills 8 bytes).  So that tile takes 0, every other
// instantiation 1.
template <typename T, int V>
constexpr int gather_min_blocks() {
  return sizeof(T) == 4 && V == 4 ? 0 : 1;
}

// One warp per plan entry: entries [0, n_part) of row_part (flat row, beg,
// end) write partial sums into partials[w]; entries of row_work (flat row,
// beg, end, rows) write final rows, a run of `rows` empty rows where
// beg == end.  Lane l owns features c0 + k*32*V + l*V + [0, V), k < NV.
template <typename T, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  (gather_min_blocks<T, V>()))
segment_gather_kernel(const T* __restrict__ x,
                      const int64_t* __restrict__ src,
                      const float* __restrict__ mask,
                      const float* __restrict__ deg,
                      const int32_t* __restrict__ row_part, int n_part,
                      const int32_t* __restrict__ row_work, int n_work,
                      const int64_t* __restrict__ row_base_per_part,
                      int64_t row_base, TO* __restrict__ out,
                      typename Acc<T>::type* __restrict__ partials, int nb,
                      int be, int bn, int64_t n_src, int64_t num_rows, int d,
                      int mean) {
  using A = typename Acc<T>::type;
  constexpr int kTile = 32 * V * NV;
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool partial = w < n_part;
  int row, beg, end, nrows = 1;
  if (partial) {
    const int32_t* e = row_part + w * 3;
    row = e[0], beg = e[1], end = e[2];
  } else if (w < static_cast<int64_t>(n_part) + n_work) {
    const int32_t* e = row_work + (w - n_part) * 4;
    row = e[0], beg = e[1], end = e[2], nrows = e[3];
  } else {
    return;  // warp-uniform
  }

  if (beg == end) {  // a run of empty rows: they read 0
    A zero[V];
#pragma unroll
    for (int i = 0; i < V; ++i) zero[i] = A(0);
    for (int i = 0; i < nrows; ++i) {
      int p;
      const int64_t orow =
          place(row + i, nb, bn, row_base_per_part, row_base, &p);
      if (orow < 0 || orow >= num_rows) continue;
      TO* op = out + (static_cast<int64_t>(p) * num_rows + orow) * d;
      for (int c = lane * V; c < d; c += 32 * V) store_vec<V>(op + c, zero);
    }
    return;
  }

  int p;
  const int64_t orow = place(row, nb, bn, row_base_per_part, row_base, &p);
  if (orow < 0 || orow >= num_rows) return;  // cut off: nothing reads it
  const int64_t slot0 = static_cast<int64_t>(row / bn) * be;
  const T* xp = x + static_cast<int64_t>(p) * n_src * d;

  for (int c0 = 0; c0 < d; c0 += kTile) {
    A acc[NV][V];
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = A(0);
    for (int e0 = beg; e0 < end; e0 += kChunk) {
      const int e = e0 + lane;
      int s = 0;
      A wt = A(0);
      if (e < end) {
        s = static_cast<int>(src[slot0 + e]);  // < n_src < 2^31 (wrapper)
        wt = static_cast<A>(mask[slot0 + e]);
      }
      const int cnt = min(kChunk, end - e0);
      for (int j = 0; j < cnt; j += kInFlight) {
        // the gathers of kInFlight edges first, then their adds in order
        A v[kInFlight][NV][V];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int su = __shfl_sync(kFull, s, (j + u) & 31);
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int c = c0 + k * 32 * V + lane * V;
            if (j + u < cnt && c < d) {
              load_vec<V>(xp + static_cast<int64_t>(su) * d + c, v[u][k]);
            } else {
#pragma unroll
              for (int i = 0; i < V; ++i) v[u][k][i] = A(0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const A wu = __shfl_sync(kFull, wt, (j + u) & 31);
          if (j + u < cnt) {  // warp-uniform
#pragma unroll
            for (int k = 0; k < NV; ++k)
#pragma unroll
              for (int i = 0; i < V; ++i) acc[k][i] += wu * v[u][k][i];
          }
        }
      }
    }
    if (partial) {
      A* pp = partials + w * d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = c0 + k * 32 * V + lane * V;
        if (c < d) store_vec<V>(pp + c, acc[k]);
      }
    } else {
      TO* op = out + (static_cast<int64_t>(p) * num_rows + orow) * d;
      const A dg = mean ? static_cast<A>(deg[row]) : A(1);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = c0 + k * 32 * V + lane * V;
        if (c >= d) continue;
        if (mean) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = acc[k][i] / dg;
        }
        store_vec<V>(op + c, acc[k]);
      }
    }
  }
}

// One warp per split row (flat row, first partial, end): adds its partials
// in item order, divides by deg (if mean) and stores the row.
template <typename A, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_merge_kernel(const A* __restrict__ partials,
                     const int32_t* __restrict__ row_split, int n_split,
                     const float* __restrict__ deg,
                     const int64_t* __restrict__ row_base_per_part,
                     int64_t row_base, TO* __restrict__ out, int nb, int bn,
                     int64_t num_rows, int d, int mean) {
  constexpr int kTile = 32 * V * NV;
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_split) return;  // warp-uniform
  const int32_t* e = row_split + w * 3;
  const int row = e[0], q0 = e[1], q1 = e[2];
  int p;
  const int64_t orow = place(row, nb, bn, row_base_per_part, row_base, &p);
  if (orow < 0 || orow >= num_rows) return;
  TO* op = out + (static_cast<int64_t>(p) * num_rows + orow) * d;
  const A dg = mean ? static_cast<A>(deg[row]) : A(1);
  for (int c0 = 0; c0 < d; c0 += kTile) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = c0 + k * 32 * V + lane * V;
      if (c >= d) continue;
      A acc[V];
      load_vec<V>(partials + static_cast<int64_t>(q0) * d + c, acc);
#pragma unroll 4
      for (int q = q0 + 1; q < q1; ++q) {
        A v[V];
        load_vec<V>(partials + static_cast<int64_t>(q) * d + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += v[i];
      }
      if (mean) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = acc[i] / dg;
      }
      store_vec<V>(op + c, acc);
    }
  }
}

// The backward's pre-pass: gsub[p, j] = g[p, row_base[p] + j] / deg[p, j]
// (divided only if mean) for the P*nb*bn forward rows j, 0 where the forward
// cut the row off.  One thread per V features of a row.
template <typename T, int V>
__global__ void segment_unplace_kernel(
    const T* __restrict__ g, const float* __restrict__ deg,
    const int64_t* __restrict__ row_base_per_part, int64_t row_base,
    typename Acc<T>::type* __restrict__ gsub, int nb, int bn,
    int64_t num_rows, int d, int64_t n_vec, int mean) {
  using A = typename Acc<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int dv = d / V;
  const int64_t row = i / dv;  // p * nb * bn + j
  const int c = static_cast<int>(i % dv) * V;
  const int64_t rows_pp = static_cast<int64_t>(nb) * bn;
  const int p = static_cast<int>(row / rows_pp);
  const int64_t base = row_base_per_part ? row_base_per_part[p] : row_base;
  const int64_t orow = base + row % rows_pp;
  A v[V];
  if (orow >= 0 && orow < num_rows) {
    load_vec<V>(g + (static_cast<int64_t>(p) * num_rows + orow) * d + c, v);
    if (mean) {
      const A dg = static_cast<A>(deg[row]);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = v[k] / dg;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = A(0);
  }
  store_vec<V>(gsub + row * d + c, v);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(int64_t warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// The lanes' vectors for rows of element type T: the 16-byte tile (kV
// elements a vector, kNV vectors a lane: 128 features at f32 and f64, 256
// at bf16), and the half-width vector (kVh, one a lane) that rows of at most
// half that tile take.
template <typename T> struct Tile {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  static constexpr int kNV = sizeof(T) == 8 ? 2 : 1;
  static constexpr int kVh = sizeof(T) == 8 ? kV : kV / 2;
};

// 0: one element a lane (D % kV != 0, or a base off 16 bytes); 1: the
// half-width vector; 2: the 16-byte tile.
template <typename T>
int tile_kind(int d, bool aligned) {
  if (d % Tile<T>::kV != 0 || !aligned) return 0;
  return d <= 32 * Tile<T>::kVh ? 1 : 2;
}

// The gather grid over row_part then row_work.
template <typename T, typename TO>
cudaError_t gather(const T* x, const int64_t* src, const float* mask,
                   const float* deg, const int32_t* row_part, int n_part,
                   const int32_t* row_work, int n_work,
                   const int64_t* row_base_per_part, int64_t row_base, TO* out,
                   typename Acc<T>::type* partials, int nb, int be, int bn,
                   int64_t n_src, int64_t num_rows, int d, int mean,
                   cudaStream_t s) {
  using W = Tile<T>;
  const int64_t warps = static_cast<int64_t>(n_part) + n_work;
  if (warps == 0) return cudaSuccess;
  const unsigned grid = blocks_for(warps);
  const int kind =
      tile_kind<T>(d, aligned16(x) && aligned16(out) && aligned16(partials));
  auto k = kind == 2   ? &segment_gather_kernel<T, TO, W::kV, W::kNV>
           : kind == 1 ? &segment_gather_kernel<T, TO, W::kVh, 1>
                       : &segment_gather_kernel<T, TO, 1, 4>;
  k<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      x, src, mask, deg, row_part, n_part, row_work, n_work, row_base_per_part,
      row_base, out, partials, nb, be, bn, n_src, num_rows, d, mean);
  return cudaGetLastError();
}

template <typename A, typename TO>
cudaError_t merge(const A* partials, const int32_t* row_split, int n_split,
                  const float* deg, const int64_t* row_base_per_part,
                  int64_t row_base, TO* out, int nb, int bn, int64_t num_rows,
                  int d, int mean, cudaStream_t s) {
  using W = Tile<A>;
  if (n_split == 0) return cudaSuccess;
  const int kind = tile_kind<A>(d, aligned16(partials) && aligned16(out));
  auto k = kind == 2   ? &segment_merge_kernel<A, TO, W::kV, W::kNV>
           : kind == 1 ? &segment_merge_kernel<A, TO, W::kVh, 1>
                       : &segment_merge_kernel<A, TO, 1, 4>;
  k<<<blocks_for(n_split), kWarpsPerBlock * 32, 0, s>>>(
      partials, row_split, n_split, deg, row_base_per_part, row_base, out, nb,
      bn, num_rows, d, mean);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* src, const void* mask,
                       const void* deg, const void* row_part, int n_part,
                       const void* row_work, int n_work, const void* row_split,
                       int n_split, const void* row_base_per_part,
                       int64_t row_base, void* out, void* partials, int nb,
                       int be, int bn, int64_t n_in, int64_t num_rows, int d,
                       int mean, cudaStream_t s) {
  using A = typename Acc<T>::type;
  if (d == 0 || num_rows == 0) return cudaSuccess;
  const auto* rbp = static_cast<const int64_t*>(row_base_per_part);
  cudaError_t err = gather<T, T>(
      static_cast<const T*>(x), static_cast<const int64_t*>(src),
      static_cast<const float*>(mask), static_cast<const float*>(deg),
      static_cast<const int32_t*>(row_part), n_part,
      static_cast<const int32_t*>(row_work), n_work, rbp, row_base,
      static_cast<T*>(out), static_cast<A*>(partials), nb, be, bn, n_in,
      num_rows, d, mean, s);
  if (err != cudaSuccess) return err;
  return merge<A, T>(static_cast<const A*>(partials),
                     static_cast<const int32_t*>(row_split), n_split,
                     static_cast<const float*>(deg), rbp, row_base,
                     static_cast<T*>(out), nb, bn, num_rows, d, mean, s);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* t_src, const void* t_mask,
                       const void* deg, const void* t_row_part, int n_part,
                       const void* t_row_work, int n_work,
                       const void* t_row_split, int n_split,
                       const void* row_base_per_part, int64_t row_base,
                       void* gsub, void* dx, void* partials, int P, int nb,
                       int nb_t, int be_t, int bn, int64_t num_rows,
                       int64_t n_in, int d, int mean, cudaStream_t s) {
  using A = typename Acc<T>::type;
  if (d == 0 || n_in == 0) return cudaSuccess;
  const int64_t fwd_rows = static_cast<int64_t>(P) * nb * bn;
  if (fwd_rows > 0) {
    constexpr int kV = 16 / static_cast<int>(sizeof(T));
    const bool vec = d % kV == 0 && aligned16(g) && aligned16(gsub);
    const int v = vec ? kV : 1;
    const int64_t n_vec = fwd_rows * (d / v);
    const unsigned grid = static_cast<unsigned>((n_vec + 255) / 256);
    const auto* rbp = static_cast<const int64_t*>(row_base_per_part);
    if (vec) {
      segment_unplace_kernel<T, kV><<<grid, 256, 0, s>>>(
          static_cast<const T*>(g), static_cast<const float*>(deg), rbp,
          row_base, static_cast<A*>(gsub), nb, bn, num_rows, d, n_vec, mean);
    } else {
      segment_unplace_kernel<T, 1><<<grid, 256, 0, s>>>(
          static_cast<const T*>(g), static_cast<const float*>(deg), rbp,
          row_base, static_cast<A*>(gsub), nb, bn, num_rows, d, n_vec, mean);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the transpose aggregation over gsub: output rows u = bt*bn + r < n_in,
  // no row_base, no division (gsub holds it)
  cudaError_t err = gather<A, T>(
      static_cast<const A*>(gsub), static_cast<const int64_t*>(t_src),
      static_cast<const float*>(t_mask), nullptr,
      static_cast<const int32_t*>(t_row_part), n_part,
      static_cast<const int32_t*>(t_row_work), n_work, nullptr, 0,
      static_cast<T*>(dx), static_cast<A*>(partials), nb_t, be_t, bn,
      static_cast<int64_t>(nb) * bn, n_in, d, 0, s);
  if (err != cudaSuccess) return err;
  return merge<A, T>(static_cast<const A*>(partials),
                     static_cast<const int32_t*>(t_row_split), n_split, nullptr,
                     nullptr, 0, static_cast<T*>(dx), nb_t, bn, n_in, d, 0, s);
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = bfloat16.  x (P, n_in, D), out
// (P, num_rows, D); src/mask (P, nb, be), deg (P, nb, bn); the plan's
// row_part (n_part, 3), row_work (n_work, 4), row_split (n_split, 3) int32;
// partials (n_part, D) of the accumulation type (f64 for f64, else f32).
// row_base_per_part is a device (P,) int64 array or NULL, in which case
// row_base applies to all.  Every output row the blocks cover is written;
// the caller zero-fills the rest.
extern "C" int segment_mean_fwd(int dtype, const void* x, const void* src,
                                const void* mask, const void* deg,
                                const void* row_part, int n_part,
                                const void* row_work, int n_work,
                                const void* row_split, int n_split,
                                const void* row_base_per_part,
                                int64_t row_base, void* out, void* partials,
                                int nb, int be, int bn, int64_t n_in,
                                int64_t num_rows, int d, int mean,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(x, src, mask, deg, row_part, n_part, row_work,
                               n_work, row_split, n_split, row_base_per_part,
                               row_base, out, partials, nb, be, bn, n_in,
                               num_rows, d, mean, s);
    case 1:
      return launch_fwd<double>(x, src, mask, deg, row_part, n_part, row_work,
                                n_work, row_split, n_split, row_base_per_part,
                                row_base, out, partials, nb, be, bn, n_in,
                                num_rows, d, mean, s);
    case 2:
      return launch_fwd<__nv_bfloat16>(
          x, src, mask, deg, row_part, n_part, row_work, n_work, row_split,
          n_split, row_base_per_part, row_base, out, partials, nb, be, bn,
          n_in, num_rows, d, mean, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  g (P, num_rows, D), dx (P, n_in, D); deg the forward's
// (P, nb, bn); t_src/t_mask (P, nb_t, be_t) and the transpose plan
// (t_row_part, t_row_work, t_row_split); gsub (P, nb*bn, D) and partials
// (n_part, D) of the accumulation type.  row_base as for segment_mean_fwd.
// Every dx row the transpose blocks cover is written; the caller zero-fills
// the rest.
extern "C" int segment_mean_bwd(int dtype, const void* g, const void* t_src,
                                const void* t_mask, const void* deg,
                                const void* t_row_part, int n_part,
                                const void* t_row_work, int n_work,
                                const void* t_row_split, int n_split,
                                const void* row_base_per_part,
                                int64_t row_base, void* gsub, void* dx,
                                void* partials, int P, int nb, int nb_t,
                                int be_t, int bn, int64_t num_rows,
                                int64_t n_in, int d, int mean, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(g, t_src, t_mask, deg, t_row_part, n_part,
                               t_row_work, n_work, t_row_split, n_split,
                               row_base_per_part, row_base, gsub, dx, partials,
                               P, nb, nb_t, be_t, bn, num_rows, n_in, d, mean,
                               s);
    case 1:
      return launch_bwd<double>(g, t_src, t_mask, deg, t_row_part, n_part,
                                t_row_work, n_work, t_row_split, n_split,
                                row_base_per_part, row_base, gsub, dx,
                                partials, P, nb, nb_t, be_t, bn, num_rows, n_in,
                                d, mean, s);
    case 2:
      return launch_bwd<__nv_bfloat16>(
          g, t_src, t_mask, deg, t_row_part, n_part, t_row_work, n_work,
          t_row_split, n_split, row_base_per_part, row_base, gsub, dx,
          partials, P, nb, nb_t, be_t, bn, num_rows, n_in, d, mean, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
