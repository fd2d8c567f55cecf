// Flash attention forward (online softmax, GQA, causal, sliding window,
// q_offset) for Hopper: tensor cores for prefill, a split over the KV
// length for decode.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py:41 (reached through
// `flash_attention_pallas` and `ops.flash_attention`).  For every batch b,
// query head h, query row i (absolute position q_pos = q_offset + i) it
// computes
//
//     o[b, h, i] = sum_j softmax_j(q[b,h,i] . k[b,h/group,j] / sqrt(Dh)) v[b,h/group,j]
//
// over the keys j < Sk that are live: j <= q_pos if causal, and
// j > q_pos - window if a window is given, unless j < prefix_len: the keys
// of a prefix (paligemma's image patches, the reference's prefix-LM mask,
// `_mask_block` at src/repro/models/layers.py:112) are seen by every query
// through the causal mask and the window alike.  A row with no live key
// gives 0 (the TPU kernel's l == 0 -> 1).  Scores, softmax statistics and the
// accumulator are f32; the output is rounded once to q's dtype.  The TPU
// grid walks (q-tile, k-tile) cells in order and carries m, l and the
// accumulator in VMEM scratch across the sequential k axis; CUDA blocks run
// in no order, so each design below keeps that state in its own registers
// or shared memory and merges across blocks only where it splits a row.
//
// Three designs, picked by the wrapper (kernels/flash_attention.py::plan):
//
// 1. bf16 prefill: tensor cores (`flash_prefill_mma_kernel`).  Bound by
//    operations: 4 Dh Sq Sk FLOPs per (b, h), half of it live under the
//    causal mask (B=4, Hq=14, S=2048, Dh=64: 3.0e10 FLOPs, ~30 us at the
//    card's 989 TFLOP/s bf16 rate).  One block of four warps per
//    (b, h, q tile): 32 rows per warp (two 16-row mma tiles, so every K/V
//    fragment read from shared memory feeds two products) at Dh <= 64,
//    16 at Dh 128 and 256, where the accumulators leave no registers for a
//    second tile.  At Dh 256 one warp's whole O would take 128 registers a
//    thread, and ptxas spilled at 255 with Q's fragments reloaded from
//    shared memory: so eight warps, two per 16-row group, both computing
//    the group's S = Q.K^T (Q reloaded by ldmatrix at each k-step, the
//    scores and softmax statistics the same in both) and each accumulating
//    half of O's 256 dims (165 KB of shared memory, one block an SM); the
//    pair's duplicated S adds a third to a row group's tensor-core work (S
//    once, P_hi.V and P_lo.V twice it).  A call with a prefix runs an
//    instantiation of its own, so one without runs the code it ran before
//    prefixes existed.  The heaviest causal tiles launch first.  The block
//    visits the key tiles of its live range and, with a prefix, the
//    prefix's tiles before them (`tile_walk`: one run of tiles, or two
//    where a window leaves a gap after the prefix).  K/V tiles
//    stream through a two-stage shared-memory ring by cp.async (tile t+1 is
//    in flight while tile t is used); rows are padded by 16 bytes so
//    ldmatrix reads conflict-free.  S = Q.K^T by mma.sync m16n8k16 (bf16
//    in, f32 accumulators in registers); the scale 1/sqrt(Dh) (with log2 e,
//    for the SFU's exp2) multiplies the f32 scores in the exponent's fma.
//    The mask is applied only on tiles
//    that cross a boundary (causal diagonal, window edge, Sk tail); tiles
//    outside the block's live key range are never loaded.  The online
//    softmax runs in f32 on the accumulator fragments, whose layout is the
//    A operand's of the P.V product, so P never leaves registers.  P keeps
//    ~16 bits: P = P_hi + P_lo, both bf16 (P_lo = bf16(P - P_hi)), and both
//    products go into one f32 accumulator (1.5x the tensor-core work of a
//    bf16 P, whose 2^-9 relative rounding would exceed one output ulp on
//    outputs that cancel).  Finally one divide by l (0 -> 1) and one
//    rounding to bf16.  mma.sync rather than wgmma/TMA: it keeps each
//    warp's rows self-contained (no warpgroup-wide descriptors, swizzled
//    layouts or mbarrier ring), at up to ~2/3 of the wgmma rate; wgmma would
//    add the rest of the tensor-core rate and TMA would free the load
//    instructions and registers of the producer side.
//
// 2. f32 prefill: CUDA cores (`flash_fwd_kernel`), because TF32 tensor cores
//    would not hold the f32 tolerances.  One block per (b, h, 64-row q
//    tile; 32 rows at Dh 256, so that 256 threads may each hold 80 floats
//    in registers); a query row is owned by Dh/32 neighbouring threads
//    holding interleaved float4 chunks (conflict-free shared-memory reads,
//    one xor-shuffle per dot product at Dh 64); 32-key f32 K/V tiles in
//    shared memory (16 keys at Dh 256, under the 48 KB of static shared
//    memory), keys past Sk zero-filled, dead tiles skipped (`tile_walk`, as
//    above).
//
// 3. decode (Sq = 1, Hq/Hkv <= 16), bf16 and f32: a split over the KV
//    length (`flash_decode_split_kernel` + `flash_decode_combine_kernel`).
//    Bound by the bytes of the live K/V rows (B=4, Hkv=2, 2,049 live keys,
//    Dh=64, bf16: 4.2 MB, 1.26 us at 3.35 TB/s).  Grid (B*Hkv, n_split):
//    a block takes ONE KV head and all `group` query heads that read it as
//    its rows, so each K/V byte is read once, not `group` times, and one
//    chunk of the live key range, which the wrapper computed on the host
//    (so no key inside it is masked) and cut into n_split chunks that fill
//    about two waves of the SMs.  K and V tiles arrive by 16-byte cp.async,
//    issued before the query rows are read, all in flight together; scores
//    by lanes that split a key row, softmax per row by a warp, P.V by
//    threads that each own a (row, 16-byte segment) pair.  Each block
//    writes partial (m, l, acc[Dh]) in f32; a second small grid (one block
//    per query row) merges the splits by log-sum-exp.  Every sum runs in a
//    fixed order (no atomics), so two calls are bitwise equal.  An empty
//    or fully masked split has m = -1e30, l = 0, acc = 0 and adds nothing;
//    a row with no live key ends with l = 0 and gives 0.  At Dh 256 the
//    K/V tiles shrink to 12 KB each (static shared memory stays under 48
//    KB), a key row's scores are split over 32 lanes of two f32 segments
//    each, and the merge's threads each own Dh / 128 dims over all splits.
//    The decode design takes no prefix: the reference's decode never
//    rescues one (`attention_decode`'s `valid`, layers.py:357).
//
// Training: both prefill designs also write each row's log-sum-exp of its
// scaled live scores, lse = m + log(l) in natural-log units (-inf for a row
// that sees no key), when the caller passes a buffer for it; the backward
// (flash_attention_bwd.cu) recomputes P = exp(s scale - lse) from it.
// Serving passes null, and the output is the same either way: the LSE is
// written after it and changes none of its arithmetic.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the decode partials live in a scratch buffer the
// wrapper allocates), does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // stands for -inf in running maxima
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// kPrefix: the call has a prefix (a kernel instantiation of its own, so
// that a call without one runs the arithmetic and holds the registers it
// did before prefixes existed)
template <bool kPrefix>
__device__ __forceinline__ bool key_live(int key, int q_pos, int sk,
                                         int causal, int window,
                                         int prefix) {
  return key < sk &&
         ((kPrefix && key < prefix) ||
          ((!causal || key <= q_pos) && (window < 0 || key > q_pos - window)));
}

// The key tiles of `tile` keys a block of query positions [q_first, q_last]
// visits, in order: the tiles of the prefix [0, prefix) that every query
// sees, then those of the live range [k_lo, k_hi) of the causal mask and
// the window (the reference's tile skip, "in_prefix" at layers.py:177).
// One run of tiles, or two where the window leaves a gap after the prefix;
// without a prefix, the live range's tiles as before.
struct TileWalk {
  int first, n_first, second, n;
  template <bool kPrefix>
  __device__ __forceinline__ int key0(int t, int tile) const {
    if (!kPrefix) return (first + t) * tile;  // one run of tiles
    return (t < n_first ? first + t : second + (t - n_first)) * tile;
  }
};

__device__ __forceinline__ TileWalk tile_walk(int tile, int q_first,
                                              int q_last, int sk, int causal,
                                              int window, int prefix) {
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window >= 0 ? max(0, q_first - window + 1) : 0;
  const int lo = k_lo / tile;
  const int hi = k_hi > k_lo ? (k_hi + tile - 1) / tile : lo;
  if (prefix <= 0) return {lo, hi - lo, 0, hi - lo};
  const int tp = (min(prefix, sk) + tile - 1) / tile;  // prefix tiles [0, tp)
  if (lo <= tp) {
    const int n = max(hi, tp);
    return {0, n, 0, n};
  }
  return {0, tp, lo, tp + hi - lo};
}

// ---------------------------------------------------------------------------
// PTX wrappers
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

// 2^x by the SFU alone: exp2f adds range handling for results below
// 2^-126, which flush to 0 here (a weight that small adds nothing)
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

// ---------------------------------------------------------------------------
// 1. bf16 prefill on tensor cores
// ---------------------------------------------------------------------------

constexpr int kPK = 64;  // keys per K/V tile

// MT 16-row mma tiles per warp: two where registers allow (Dh <= 64), so
// every K/V fragment read from shared memory feeds two products.  Up to Dh
// 128 four warps each own their rows' whole output and keep Q's fragments
// in registers; at Dh 256 eight: two warps share each 16-row group, both
// compute its scores S = Q.K^T (Q reloaded from shared memory at each
// k-step) and each accumulates half of the output's dims
template <int DH>
struct PrefillShape {
  static constexpr int kMT = DH <= 64 ? 2 : 1;
  static constexpr bool kQRegs = DH <= 128;
  static constexpr int kDS = DH <= 128 ? 1 : 2;    // warps per row group
  static constexpr int kThreads = 128 * kDS;
  static constexpr int kBQ = 4 * 16 * kMT;     // query rows per block
  static constexpr int kStride = DH + 8;       // bf16 per row: 16-byte pad
  static constexpr int kTile = kPK * kStride;   // bf16 per K or V tile
  static constexpr int kBytes = (kBQ * kStride + 4 * kTile) * 2;
};

// one block an SM is enough: without that bound ptxas held the Dh 256
// instantiation to 128 registers a thread and spilled
template <int DH, bool kPrefix>
__global__ void __launch_bounds__(PrefillShape<DH>::kThreads, 1)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int hq, int hkv, int sq,
                         int sk, int causal, int window, int prefix,
                         int q_offset, float scale_log2) {
  using Shape = PrefillShape<DH>;
  constexpr int kMT = Shape::kMT;
  constexpr int kBQ = Shape::kBQ;
  constexpr int kStride = Shape::kStride;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kKSteps = DH / 16;  // k-steps of Q.K^T
  constexpr int kDW = DH / Shape::kDS;  // dims of O a warp owns
  constexpr int kDTiles = kDW / 8;  // its n-tiles of O
  constexpr int kNT = kPK / 8;      // n-tiles of S
  constexpr int kChunks = DH / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;
  __nv_bfloat16* ks = smem + kBQ * kStride;   // [2][kPK][kStride]
  __nv_bfloat16* vs = ks + 2 * Shape::kTile;  // [2][kPK][kStride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // the warp's row group, and its part of the output's dims
  const int rw = Shape::kDS == 1 ? warp : warp % 4;
  const int half = Shape::kDS == 1 ? 0 : warp / 4;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (and row + 8)
  const int tig = lane % 4;  // fragment column pair
  // heaviest causal tiles (the last rows) are launched first
  const int q_tile = (static_cast<int>(gridDim.x) - 1 -
                      static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_base = (static_cast<int64_t>(b) * hq + h) * sq;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + hk) * sk * DH;
  const __nv_bfloat16* kp = k + kv_base;
  const __nv_bfloat16* vp = v + kv_base;

  // the key tiles the whole block visits
  const int q_first = q_offset + q_tile;
  const int q_last = q_offset + min(q_tile + kBQ, sq) - 1;
  const TileWalk walk = tile_walk(kPK, q_first, q_last, sk, causal, window,
                                  kPrefix ? prefix : 0);
  const int n_tiles = walk.n;

  for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = q_tile + r < sq;
    cp_async16(smem_u32(qs + r * kStride + c * 8),
               q + (q_base + (ok ? q_tile + r : 0)) * DH + c * 8, ok);
  }
  auto load_kv = [&](int k0, int buf) {
    __nv_bfloat16* kd = ks + buf * Shape::kTile;
    __nv_bfloat16* vd = vs + buf * Shape::kTile;
    for (int idx = tid; idx < kPK * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = k0 + r < sk;  // keys past Sk are zero-filled
      const int64_t off = static_cast<int64_t>(ok ? k0 + r : 0) * DH + c * 8;
      cp_async16(smem_u32(kd + r * kStride + c * 8), kp + off, ok);
      cp_async16(smem_u32(vd + r * kStride + c * 8), vp + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(walk.key0<kPrefix>(0, kPK), 0);
  cp_async_commit();  // group: Q and the first tile

  // this thread's rows: row0 + 16 mt and row0 + 16 mt + 8
  const int row0 = q_tile + rw * 16 * kMT + g;
  float acc[kMT][kDTiles][4];
  float m[kMT][2], l[kMT][2];  // l: this thread's share of the row sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }
  }
  uint32_t qf[kMT][Shape::kQRegs ? kKSteps : 1][4];
  // Q's fragment row of this lane in 16-row tile mt (ldmatrix x4 over a 16
  // x 16 block)
  auto q_row = [&](int mt) {
    return rw * 16 * kMT + mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = walk.key0<kPrefix>(t, kPK);
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(walk.key0<kPrefix>(t + 1, kPK), buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    if (Shape::kQRegs && t == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = q_row(mt);
#pragma unroll
        for (int kk = 0; kk < (Shape::kQRegs ? kKSteps : 1); ++kk)
          ldsm_x4(smem_u32(qs + r * kStride + kk * 16 + (lane / 16) * 8),
                  qf[mt][kk][0], qf[mt][kk][1], qf[mt][kk][2],
                  qf[mt][kk][3]);
      }
    }
    const __nv_bfloat16* kt = ks + buf * Shape::kTile;
    const __nv_bfloat16* vt = vs + buf * Shape::kTile;

    // S = Q . K^T, 16 kMT rows x kPK keys per warp
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qk[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (Shape::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qk[mt][e] = qf[mt][kk][e];
        } else {
          ldsm_x4(smem_u32(qs + q_row(mt) * kStride + kk * 16 +
                           (lane / 16) * 8),
                  qk[mt][0], qk[mt][1], qk[mt][2], qk[mt][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int dim = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + key * kStride + dim), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], qk[mt], b0, b1);
          mma_bf16(s[mt][2 * np + 1], qk[mt], b2, b3);
        }
      }
    }

    // online softmax in the log2 domain, m the running max of the scaled
    // scores: the max is taken on the raw scores (the scale is positive)
    // and p = 2^(s * scale - m) is one fma; masked scores are -inf, so
    // their p is exactly 0 while m stays finite (-1e30 at worst).  A tile
    // inside the prefix is masked only at the Sk tail; one across its edge
    // takes the mask like any other
    const bool edge = k0 + kPK > sk ||
                      ((!kPrefix || k0 + kPK > prefix) &&
                       ((causal && k0 + kPK - 1 > q_first) ||
                        (window >= 0 && k0 <= q_last - window)));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (edge) {
        const int pos0 = q_offset + row0 + mt * 16;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int key = k0 + j * 8 + tig * 2;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!key_live<kPrefix>(key + (e & 1), pos0 + 8 * (e >> 1), sk,
                                   causal, window, prefix))
              s[mt][j][e] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[mt][i], mx[i] * scale_log2);
        alpha[i] = ex2(m[mt][i] - m_new);
        m[mt][i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][j][e] = ex2(fmaf(s[mt][j][e], scale_log2, -m[mt][e >> 1]));
        rs[0] += s[mt][j][0] + s[mt][j][1];
        rs[1] += s[mt][j][2] + s[mt][j][3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * alpha[i] + rs[i];
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][d][e] *= alpha[e >> 1];
    }

    // O += P_hi . V + P_lo . V; S's fragments are P's A operand
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) {
      uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
        split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
        split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2],
                   pl[mt][2]);
        split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3],
                   pl[mt][3]);
      }
#pragma unroll
      for (int nd = 0; nd < kDW / 16; ++nd) {
        const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dim = half * kDW + nd * 16 + (lane / 16) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vt + key * kStride + dim), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * nd], ph[mt], b0, b1);
          mma_bf16(acc[mt][2 * nd], pl[mt], b0, b1);
          mma_bf16(acc[mt][2 * nd + 1], ph[mt], b2, b3);
          mma_bf16(acc[mt][2 * nd + 1], pl[mt], b2, b3);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float den[2], lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(kFull, li, 1);
      li += __shfl_xor_sync(kFull, li, 2);
      lsum[i] = li;
      den[i] = li == 0.f ? 1.f : li;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + mt * 16 + 8 * i;
      if (row >= sq) continue;
      // the row's natural log-sum-exp of the scaled scores, for the
      // backward: sum_j e^(s_j scale) = 2^m l
      if (lse != nullptr && tig == 0 && half == 0)
        lse[q_base + row] = lsum[i] == 0.f
                                ? -INFINITY
                                : (m[mt][i] + log2f(lsum[i])) * kLn2;
      __nv_bfloat16* orow = o + (q_base + row) * DH + half * kDW + tig * 2;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
            __floats2bfloat162_rn(acc[mt][d][2 * i] / den[i],
                                  acc[mt][d][2 * i + 1] / den[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. f32 prefill on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kDPT = 32;  // head dims owned by one thread

// query rows per block and keys per shared-memory tile: 64 rows and K/V
// tiles of 32 keys; at Dh 256 32 rows (256 threads, so a thread may hold
// the 80 floats of its Q, O and score slices in registers) and 16 keys
// (static shared memory stays under 48 KB)
template <int DH>
struct FwdShape {
  static constexpr int kBQ = DH <= 128 ? 64 : 32;
  static constexpr int kBK = DH <= 128 ? 32 : 16;
  static constexpr int kThreads = kBQ * (DH / kDPT);
};

// one block an SM is enough: without that bound ptxas has held the Dh 256
// instantiation to 128 registers a thread and spilled
template <int DH, bool kPrefix>
__global__ void __launch_bounds__(FwdShape<DH>::kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int causal, int window, int prefix, int q_offset,
                 float scale) {
  constexpr int kBQ = FwdShape<DH>::kBQ;
  constexpr int kBK = FwdShape<DH>::kBK;
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
  const float* qp = q + q_row * DH;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + hk) * sk * DH;
  const float4* kp = reinterpret_cast<const float4*>(k + kv_base);
  const float4* vp = reinterpret_cast<const float4*>(v + kv_base);

  float qr[kDPT];
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (g + G * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] = active ? qp[d0 + e] * scale : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // the key tiles the whole block visits
  const int q_first = q_offset + q_tile;
  const int q_last = q_offset + min(q_tile + kBQ, sq) - 1;
  const TileWalk walk = tile_walk(kBK, q_first, q_last, sk, causal, window,
                                  kPrefix ? prefix : 0);

  for (int t = 0; t < walk.n; ++t) {
    const int k0 = walk.key0<kPrefix>(t, kBK);
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * kRow4; idx += blockDim.x) {
      const int j = idx / kRow4;
      const int c = idx % kRow4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (k0 + j < sk) {
        const int64_t off = static_cast<int64_t>(k0 + j) * kRow4 + c;
        kk = kp[off];
        vv = vp[off];
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
      const bool live =
          key_live<kPrefix>(k0 + j, q_pos, sk, causal, window, prefix);
      s[j] = live ? s[j] : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const bool live =
          key_live<kPrefix>(k0 + j, q_pos, sk, causal, window, prefix);
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
  // the row's natural log-sum-exp of the scaled scores, for the backward
  if (lse != nullptr && g == 0)
    lse[q_row] = l == 0.f ? -INFINITY : m + logf(l);
  const float denom = l == 0.f ? 1.f : l;
  float* op = o + q_row * DH;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (g + G * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) op[d0 + e] = acc[4 * i + e] / denom;
  }
}

// ---------------------------------------------------------------------------
// 3. decode: split over the KV length, then a log-sum-exp merge
// ---------------------------------------------------------------------------

constexpr int kDThreads = 128;
// query heads per KV head (the GQA group) a decode block takes; the
// wrapper's DECODE_MAX_GROUP is the same limit
constexpr int kDMaxRows = 16;
constexpr int kMaxSplit = 1024;  // splits of the KV length per call

template <typename T, int DH>
struct DecodeShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kSegs = DH / kVec;  // 16-byte segments per row
  // lanes that split one key row's scores, each over kSegsPerLane segments
  static constexpr int kLanes = kSegs < 32 ? kSegs : 32;
  static constexpr int kSegsPerLane = kSegs / kLanes;
  // bytes of the K (and of the V) tile: 12 KB at Dh 256, where the query
  // rows take 16 KB, so that static shared memory stays under 48 KB
  static constexpr int kTileBytes = DH <= 128 ? 16384 : 12288;
  static constexpr int kFit = kTileBytes / (DH * static_cast<int>(sizeof(T)));
  static constexpr int kKC = kFit < 64 ? kFit : 64;  // keys per tile
  static constexpr int kSStride = kKC + 1;           // padded score rows
  static constexpr int kPPT =                        // (row, segment) pairs
      (kDMaxRows * kSegs + kDThreads - 1) / kDThreads;  // per thread
};

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

// part_acc: (B*hkv, n_split, rows, DH) unnormalised f32 sums;
// part_ml: (B*hkv, n_split, rows, 2) the running max (log2 domain) and sum
template <typename T, int DH>
__global__ void __launch_bounds__(kDThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int hq, int hkv,
                          int sk, int k_lo, int k_hi, int chunk,
                          float scale_log2) {
  using Shape = DecodeShape<T, DH>;
  constexpr int kVec = Shape::kVec;
  constexpr int kSegs = Shape::kSegs;
  constexpr int kKC = Shape::kKC;
  constexpr int kLanes = Shape::kLanes;
  constexpr int kSPL = Shape::kSegsPerLane;
  constexpr int kKeysPerPass = 32 / kLanes;  // keys a warp scores at once
  __shared__ __align__(16) T kt[kKC * DH];
  __shared__ __align__(16) T vt[kKC * DH];
  __shared__ __align__(16) float qs[kDMaxRows * DH];
  __shared__ float ss[kDMaxRows * Shape::kSStride];
  __shared__ float m_s[kDMaxRows], l_s[kDMaxRows], a_s[kDMaxRows];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bh / hkv;
  const int hk = bh % hkv;
  const int rows = hq / hkv;
  const int64_t kv_base = static_cast<int64_t>(bh) * sk * DH;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;
  const T* qp = q + (static_cast<int64_t>(b) * hq + hk * rows) * DH;

  // K, then V, of keys [c0, c0 + n) into shared memory, one group each
  auto load_tile = [&](int c0, int n) {
    for (int idx = tid; idx < n * kSegs; idx += kDThreads)
      cp_async16(smem_u32(kt + idx * kVec),
                 kp + static_cast<int64_t>(c0) * DH + idx * kVec, true);
    cp_async_commit();
    for (int idx = tid; idx < n * kSegs; idx += kDThreads)
      cp_async16(smem_u32(vt + idx * kVec),
                 vp + static_cast<int64_t>(c0) * DH + idx * kVec, true);
    cp_async_commit();
  };
  const int c_lo = k_lo + split * chunk;
  const int c_hi = min(k_hi, c_lo + chunk);
  if (c_lo < c_hi) load_tile(c_lo, min(kKC, c_hi - c_lo));  // before q

  for (int idx = tid; idx < rows * DH; idx += kDThreads)
    qs[idx] = to_f(qp[idx]);
  if (tid < kDMaxRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // P.V work items: (row, 16-byte segment) pairs
  const int pairs = rows * kSegs;
  float acc[Shape::kPPT][kVec];
#pragma unroll
  for (int i = 0; i < Shape::kPPT; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;

  const int seg = lane % kLanes;
  for (int c0 = c_lo; c0 < c_hi; c0 += kKC) {
    const int n = min(kKC, c_hi - c0);
    cp_async_wait<1>();  // K has landed, V may still be in flight
    __syncthreads();

    // scores: kLanes lanes split one key row (segments seg, seg + kLanes,
    // ...), every row of the group at once
    for (int j0 = warp * kKeysPerPass; j0 < n; j0 += 4 * kKeysPerPass) {
      const int j = j0 + lane / kLanes;
      float kv[kSPL][kVec];
#pragma unroll
      for (int i = 0; i < kSPL; ++i) {
        if (j < n) {
          load_vec(kt + j * DH + (seg + i * kLanes) * kVec, kv[i]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kDMaxRows; ++r) {
        if (r < rows) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kSPL; ++i) {
            const float* qr = qs + r * DH + (seg + i * kLanes) * kVec;
#pragma unroll
            for (int e = 0; e < kVec; ++e) a = fmaf(qr[e], kv[i][e], a);
          }
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            a += __shfl_xor_sync(kFull, a, off);
          if (seg == 0 && j < n) ss[r * Shape::kSStride + j] = a * scale_log2;
        }
      }
    }
    __syncthreads();

    // online softmax per row, one warp per row (every key here is live)
    for (int r = warp; r < rows; r += kDThreads / 32) {
      float* sr = ss + r * Shape::kSStride;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_s[r], mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = exp2f(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_s[r] - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // acc[pair] = alpha acc + sum over the tile's keys of p[row][j] v[j][seg]
#pragma unroll
    for (int i = 0; i < Shape::kPPT; ++i) {
      const int item = tid + i * kDThreads;
      const int r = item / kSegs;
      const int sg = item % kSegs;
      if (item < pairs) {
        const float alpha = a_s[r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] *= alpha;
        const float* pr = ss + r * Shape::kSStride;
        for (int j = 0; j < n; ++j) {
          float vv[kVec];
          load_vec(vt + j * DH + sg * kVec, vv);
          const float p = pr[j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // tiles and scores are consumed before the next tile
    if (c0 + kKC < c_hi) load_tile(c0 + kKC, min(kKC, c_hi - c0 - kKC));
  }

  const int64_t base = (static_cast<int64_t>(bh) * n_split + split) * rows;
#pragma unroll
  for (int i = 0; i < Shape::kPPT; ++i) {
    const int item = tid + i * kDThreads;
    if (item < pairs) {
      const int r = item / kSegs;
      const int sg = item % kSegs;
      float* dst = part_acc + (base + r) * DH + sg * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = acc[i][e];
    }
  }
  if (tid < rows) {
    part_ml[(base + tid) * 2] = m_s[tid];
    part_ml[(base + tid) * 2 + 1] = l_s[tid];
  }
}

// o[b, hk*rows + r] = sum_s acc_s w_s / sum_s l_s w_s, w_s = 2^(m_s - max m):
// one block per (b * hkv + hk, r); warp 0 finds the weights, then the
// block's kDThreads / DH thread groups sum interleaved subsets of the
// splits, in order, and group 0 adds the groups' sums in order; where Dh
// exceeds the block's threads (Dh 256), each thread sums every split, in
// order, for each of its Dh / kDThreads dims
template <typename T, int DH>
__global__ void __launch_bounds__(kDThreads)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            T* __restrict__ o, int hq, int hkv, int n_split) {
  __shared__ float w_s[kMaxSplit];
  __shared__ float num_s[kDThreads];
  __shared__ float den_s;
  const int bh = blockIdx.x;
  const int r = blockIdx.y;
  const int rows = hq / hkv;
  const int b = bh / hkv;
  const int hk = bh % hkv;
  const int tid = threadIdx.x;
  // row of split s in the partials: row0 + s * rows
  const int64_t row0 = static_cast<int64_t>(bh) * n_split * rows + r;
  if (tid < 32) {
    float mx = kNegInf;
    for (int s = tid; s < n_split; s += 32)
      mx = fmaxf(mx, part_ml[(row0 + static_cast<int64_t>(s) * rows) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float den = 0.f;
    for (int s = tid; s < n_split; s += 32) {
      const float* ml = part_ml + (row0 + static_cast<int64_t>(s) * rows) * 2;
      const float w = exp2f(ml[0] - mx);
      w_s[s] = w;
      den = fmaf(ml[1], w, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(kFull, den, off);
    if (tid == 0) den_s = den == 0.f ? 1.f : den;
  }
  __syncthreads();
  T* orow = o + (static_cast<int64_t>(b) * hq + hk * rows + r) * DH;
  if constexpr (DH >= kDThreads) {
    for (int d = tid; d < DH; d += kDThreads) {
      float num = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_split; ++s)
        num = fmaf(part_acc[(row0 + static_cast<int64_t>(s) * rows) * DH + d],
                   w_s[s], num);
      store(orow + d, num / den_s);
    }
  } else {
    constexpr int kGroups = kDThreads / DH;
    const int d = tid % DH;
    float num = 0.f;
#pragma unroll 4
    for (int s = tid / DH; s < n_split; s += kGroups)
      num = fmaf(part_acc[(row0 + static_cast<int64_t>(s) * rows) * DH + d],
                 w_s[s], num);
    num_s[tid] = num;
    __syncthreads();
    if (tid < DH) {
      for (int grp = 1; grp < kGroups; ++grp) num += num_s[grp * DH + tid];
      store(orow + tid, num / den_s);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int DH, bool kPrefix>
int launch_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int hq, int hkv, int sq, int sk,
                        int causal, int window, int prefix, int q_offset,
                        float scale, cudaStream_t stream) {
  using Shape = PrefillShape<DH>;
  constexpr int smem = Shape::kBytes;
  // above 48 KB a block's dynamic shared memory needs the attribute
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_mma_kernel<DH, kPrefix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + Shape::kBQ - 1) / Shape::kBQ, hq, B);
  flash_prefill_mma_kernel<DH, kPrefix>
      <<<grid, Shape::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, hq, hkv, sq, sk, causal, window, prefix, q_offset,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool kPrefix>
int launch_prefill_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int hq, int hkv, int sq, int sk,
                       int causal, int window, int prefix, int q_offset,
                       float scale, cudaStream_t stream) {
  using Shape = FwdShape<DH>;
  const dim3 grid((sq + Shape::kBQ - 1) / Shape::kBQ, hq, B);
  flash_fwd_kernel<DH, kPrefix><<<grid, Shape::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, hq, hkv, sq,
      sk, causal, window, prefix, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  void* part, int B, int hq, int hkv, int sk, int k_lo,
                  int k_hi, int chunk, int n_split, float scale,
                  cudaStream_t stream) {
  const int rows = hq / hkv;
  float* part_acc = static_cast<float*>(part);
  float* part_ml =
      part_acc + static_cast<int64_t>(B) * hkv * n_split * rows * DH;
  flash_decode_split_kernel<T, DH>
      <<<dim3(B * hkv, n_split), kDThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), part_acc, part_ml, hq, hkv, sk, k_lo,
          k_hi, chunk, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T, DH>
      <<<dim3(B * hkv, rows), kDThreads, 0, stream>>>(
          part_acc, part_ml, static_cast<T*>(o), hq, hkv, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Prefill (any Sq).  dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor
// cores); q, k, v and o all of it.  q and o are (B, hq, sq, dh), k and v
// (B, hkv, sk, dh), all contiguous; hq a multiple of hkv; dh in
// {32, 64, 128, 256}; window < 0 means no window; prefix >= 0 keys every
// query sees (0: none); sq > 0.  lse is null (serving) or (B, hq, sq)
// float32: each row's log-sum-exp of its scaled live scores, -inf for a row
// that sees no key (the training forward, for the backward in
// flash_attention_bwd.cu); the output does not depend on it.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int hq, int hkv, int sq, int sk, int dh,
                                   int causal, int window, int prefix,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prefix < 0) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_PREFILL(KIND, DH)                                              \
  return prefix > 0                                                          \
             ? launch_prefill_##KIND<DH, true>(q, k, v, o, lse, B, hq, hkv,  \
                                               sq, sk, causal, window,       \
                                               prefix, q_offset, scale, s)   \
             : launch_prefill_##KIND<DH, false>(q, k, v, o, lse, B, hq, hkv, \
                                                sq, sk, causal, window, 0,   \
                                                q_offset, scale, s)
  if (dtype == 0) {
    if (dh == 32) FLASH_PREFILL(f32, 32);
    if (dh == 64) FLASH_PREFILL(f32, 64);
    if (dh == 128) FLASH_PREFILL(f32, 128);
    if (dh == 256) FLASH_PREFILL(f32, 256);
  } else if (dtype == 1) {
    if (dh == 32) FLASH_PREFILL(bf16, 32);
    if (dh == 64) FLASH_PREFILL(bf16, 64);
    if (dh == 128) FLASH_PREFILL(bf16, 128);
    if (dh == 256) FLASH_PREFILL(bf16, 256);
  }
#undef FLASH_PREFILL
  return static_cast<int>(cudaErrorInvalidValue);
}

// Decode (Sq = 1), split over the live keys [k_lo, k_hi) in n_split chunks
// of `chunk` keys.  dtype and layouts as above; hq / hkv <= 16;
// n_split <= 1024; part is f32
// scratch of B * hkv * n_split * (hq / hkv) * (dh + 2) elements.
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k,
                                const void* v, void* o, void* part, int B,
                                int hq, int hkv, int sk, int dh, int k_lo,
                                int k_hi, int chunk, int n_split, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hq / hkv > kDMaxRows || n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DECODE(T, DH)                                                 \
  return launch_decode<T, DH>(q, k, v, o, part, B, hq, hkv, sk, k_lo, k_hi, \
                              chunk, n_split, scale, s)
  if (dtype == 0) {
    if (dh == 32) FLASH_DECODE(float, 32);
    if (dh == 64) FLASH_DECODE(float, 64);
    if (dh == 128) FLASH_DECODE(float, 128);
    if (dh == 256) FLASH_DECODE(float, 256);
  } else if (dtype == 1) {
    if (dh == 32) FLASH_DECODE(__nv_bfloat16, 32);
    if (dh == 64) FLASH_DECODE(__nv_bfloat16, 64);
    if (dh == 128) FLASH_DECODE(__nv_bfloat16, 128);
    if (dh == 256) FLASH_DECODE(__nv_bfloat16, 256);
  }
#undef FLASH_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
