// The product-and-mix engine of the attention layer's input stage for NVIDIA
// Hopper (sm_90a): RMSNorm → per-node product → node mix, shared by B3a
// (rms_qkv, attention_proj.cu) and B9b (rms_qkv_core, layer_fused.cu).
//
// Over node-major activations [N, B, F] (N = 21 nodes), for one tile of R rows
// and one group of C output columns (an item):
//
//   h[n]   = round(x[n] / sqrt(max(Σ x[n]², 1e-24)) · g_rms)   each row
//   P[n]   = round(h[n]·W[n][:, group])                       fp32 sums
//   Y[n]   = Σ_m G[n, m]·P[m]                                  fp32 sums
//   epilogue(round(Y))                                        store, or B9b's attention
//
// rounding where the Pallas kernels round; only the order of the sums
// differs from the plain PyTorch versions.
//
// Roles.  A block has 8 consumer warps (two warpgroups) and one producer
// thread, and blocks come in clusters of two.  A cluster is persistent: it
// walks the items clusterid, + nclusters, … where an item is a pair of
// adjacent row tiles (block `rank` of the cluster takes tile 2·pair + rank)
// × a column group, the groups of a pair adjacent, so the pairs in flight
// share their x in L2.  For every (item, node) each block's producer fills
// one stage of a ring in shared memory, completed on the stage's `full`
// mbarrier, with cp.async.bulk copies:
//   * node n's R input rows of its own tile, one copy (they are contiguous
//     in device memory; the rows of a ragged last tile are not copied and
//     the consumers write zeros there),
//   * half of node n's weight tile of the group, F × C, multicast into both
//     blocks (so each weight byte read from L2 serves 2·R rows), from a
//     bank packed once by the wrapper (`pack_banks` in
//     ops/kernels/node_mix_sm90.py) into contiguous tiles: for bf16 in the
//     tensor cores' canonical no-swizzle K-major layout (8 × 8 core
//     matrices of 128 bytes, [F/8][C/8]), for fp32 row-major [F][C].
// The consumers wait on `full`, normalise the rows in place (8 lanes a
// row) and write each row's 16-byte chunk j back to chunk j ^ (r & 7)
// (so that ldmatrix reads 8 rows without bank conflicts), multiply, and
// release the stage on their own block's `empty` mbarrier and on the
// peer's (one arrival a consumer warp each): a producer refills a stage
// once both blocks are done with it, since its multicast writes into both.
// No consumer waits on its own global load.  The blocks of a cluster
// synchronise after setting up their barriers and before they leave.
//
// Products (bf16): each weight byte in shared memory serves all R rows of
// the tile.  `mma.sync` m16n8k16 with both operands through ldmatrix, a
// warp per 16 rows × C·R/128 columns, two k-steps a round with the next
// fragments loaded before the current products.  (`wgmma` m64n24k16, A
// from registers, B by descriptor, ran 64 × 48 tiles 1.12× slower: ptxas
// fences each of a node's 12 wgmma.)  fp32 runs FMAs on the same tiles,
// rings and indexing.
//
// Mix (bf16): on the tensor cores, in place in P: for 8 positions (row,
// column) at a time, Yᵀ = G·P with G [32 × 32] (21 × 21 zero-padded, held in
// registers as mma A fragments from its bf16 values, which are exact) and P's
// 21 node values of those positions through one ldmatrix.trans (rows of the
// nodes past 21 point at a zero row).  fp32: FMAs, a thread per position.
//
// P lives in shared memory as [N][R][C] in the element type, each node's
// plane padded by 16 bytes (the mix's ldmatrix rows, one per node, then fall
// in distinct banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "node_mix.cuh"

namespace sm90mix {

using bf16 = __nv_bfloat16;
using nodemix::from_f;
using nodemix::to_f;

constexpr int kNodes = 21;
constexpr int kGStride = 24;          // fp32 G rows padded to whole float4s
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxStages = 4;
constexpr int kCluster = 2;           // blocks a cluster: adjacent row tiles sharing weight tiles
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory a block
constexpr int kPlanePad = 16;         // bytes after each node's plane of P
constexpr int kMaxF = 256;            // the widest input row the kernels normalise
constexpr int kZeroOffset = 2 * kMaxStages * 8;  // a 16-byte zero row after the barriers

__host__ __device__ constexpr size_t up(size_t bytes) { return (bytes + 127) & ~size_t(127); }

template <typename T>
__host__ __device__ constexpr bool is_f32() { return sizeof(T) == 4; }

// Byte offsets of one block's shared memory.  The wrappers' tile plan
// (ops/kernels/node_mix_sm90.py::plan_bytes) computes the same total.
struct Layout {
  size_t gmix, stages, stage_bytes, x_bytes, p, total;
  int plane;  // elements between node planes of P
};

template <typename T>
__host__ __device__ Layout layout(int rows, int cols, int f, int stages) {
  Layout l{};
  size_t off = 128;  // full[kMaxStages], empty[kMaxStages], the zero row
  l.gmix = off;
  off += is_f32<T>() ? up(sizeof(float) * kNodes * kGStride) : 0;
  l.x_bytes = up(sizeof(T) * rows * f);
  l.stage_bytes = l.x_bytes + up(sizeof(T) * f * cols);
  l.stages = off;
  off += stages * l.stage_bytes;
  l.plane = static_cast<int>((sizeof(T) * rows * cols + kPlanePad) / sizeof(T));
  l.p = off;
  off += up(sizeof(T) * kNodes * l.plane);
  l.total = off;
  return l;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A fault in the
// protocol traps (the launch fails) after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000ll) __trap();
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes from device memory into the same offset of both blocks' shared
// memory of the cluster, completing on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(static_cast<uint16_t>((1u << kCluster) - 1u))
      : "memory");
}

// Arrive on the barrier at `bar`'s offset in block `peer` of the cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t peer) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(peer));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (the next bulk copy into the same stage).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumers' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a·b, m16n8k16, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the stages of an item -----------------------------------------------------

// a / b rounded to nearest, as IEEE division gives it, from rcp_b =
// RN(1/b): one correction step of the quotient (Markstein), exact for
// normal operands and quotients; three instructions against the ~20 of a
// division.
__device__ __forceinline__ float quotient(float a, float b, float rcp_b) {
  const float q = a * rcp_b;
  return fmaf(fmaf(-q, b, a), rcp_b, q);
}

// The swizzle of the staged rows: a row's 16-byte chunk j lies at chunk
// j ^ (r & mask); mask 7 when the chunks of a row are a multiple of 8, else 3.
__host__ __device__ __forceinline__ int swizzle_mask(int chunks) { return chunks % 8 ? 3 : 7; }

// Rows r < valid of the staged tile [R][f] ←
// round(x / sqrt(max(Σx², 1e-24)) · g_rms) in place, swizzled; rows ≥ valid
// ← 0.  Eight adjacent lanes a row (a quarter-warp reads 8 consecutive
// chunks of a row: no bank conflicts), a thread's rows r, r + 32, …
// handled together, chunks sub, sub + 8, … of each held in registers between
// the sum of squares and the writes; kVec partial sums a thread, then the
// lanes' sums by shuffles: the same order of sums for every R, so B3a and
// B9b normalise a row alike.  f ≤ kMaxF.
template <typename T>
struct RowGain {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kChunks = kMaxF / (8 * kVec);  // a thread's chunks of a row, at most
  float g[kChunks][kVec];

  // g_rms of chunks lane%8, lane%8 + 8, … (the chunks this lane normalises)
  __device__ __forceinline__ void load(const T* g_rms, int f) {
    const int sub = (threadIdx.x & 31) % 8;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = (sub + 8 * i) * kVec + e;
        g[i][e] = c < f ? to_f(g_rms[c]) : 0.0f;
      }
  }
};

template <typename T, int R>
__device__ __forceinline__ void normalize_tile(unsigned char* xs, const RowGain<T>& gain, int f,
                                               int valid) {
  constexpr int kPer = 8;
  constexpr int kVec = RowGain<T>::kVec;
  constexpr int kChunks = RowGain<T>::kChunks;
  constexpr int kRowsPass = kConsumers / kPer;
  constexpr int kPasses = (R + kRowsPass - 1) / kRowsPass;
  static_assert(R % 4 == 0, "a warp takes 4 rows a pass");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane % kPer;
  const int chunks = f / kVec, mask = swizzle_mask(chunks);
  uint4 u[kPasses][kChunks];
  float norm[kPasses], rcp[kPasses];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int r = pass * kRowsPass + warp * (32 / kPer) + lane / kPer;
    if (r >= R) continue;  // whole warps (R is a multiple of 4)
    const uint4* row = reinterpret_cast<const uint4*>(xs + sizeof(T) * r * f);
    float part[kVec];  // kVec partial sums: short dependency chains
#pragma unroll
    for (int e = 0; e < kVec; ++e) part[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int j = sub + i * kPer;
      u[pass][i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && j < chunks) {
        u[pass][i] = row[j];
        const T* v = reinterpret_cast<const T*>(&u[pass][i]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) part[e] = fmaf(to_f(v[e]), to_f(v[e]), part[e]);
      }
    }
    float sq = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) sq += part[e];
#pragma unroll
    for (int o = kPer / 2; o >= 1; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    norm[pass] = sqrtf(fmaxf(sq, 1e-24f));
    rcp[pass] = __frcp_rn(norm[pass]);
  }
  __syncwarp();  // every chunk of the warp's rows is read before any moves
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int r = pass * kRowsPass + warp * (32 / kPer) + lane / kPer;
    if (r >= R) continue;
    uint4* row = reinterpret_cast<uint4*>(xs + sizeof(T) * r * f);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int j = sub + i * kPer;
      if (j < chunks) {
        if (r < valid) {
          T* v = reinterpret_cast<T*>(&u[pass][i]);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            v[e] = from_f<T>(quotient(to_f(v[e]), norm[pass], rcp[pass]) * gain.g[i][e]);
        }
        row[j ^ (r & mask)] = u[pass][i];
      }
    }
  }
}

// Warp layout of the bf16 products: R/16 row tiles × (8·16/R) column parts,
// each warp 16 rows × kNt n8 tiles.
template <int R, int C>
struct MmaTiles {
  static constexpr int kWm = R / 16;
  static constexpr int kWn = kConsumerWarps / kWm;
  static constexpr int kNt = C / (8 * kWn);
  static_assert(kWm * kWn == kConsumerWarps && kNt * 8 * kWn == C, "bf16 tile");
};

// Where this lane's row of the A fragments lies (16·wm + lane%16 of the
// swizzled tile [R][f]) and its swizzle; k-step ks's address is
// a.row + ((2·ks + lane/16) ^ a.swz)·16.
struct ARow {
  uint32_t row;
  int swz, half;
  __device__ __forceinline__ uint32_t at(int ks) const {
    return row + (((2 * ks + half) ^ swz) << 4);
  }
};

template <typename T>
__device__ __forceinline__ ARow a_row(const unsigned char* xs, int f, int wm) {
  const int lane = threadIdx.x & 31, r = 16 * wm + (lane & 15);
  return ARow{smem_u32(xs) + static_cast<uint32_t>(sizeof(T) * r * f),
              r & swizzle_mask(f * static_cast<int>(sizeof(T)) / 16), lane >> 4};
}

// Rounded sums of one warp's tile → P (row-major [R][C] of one node).
template <int C, int kNt>
__device__ __forceinline__ void store_products(const float (&acc)[kNt][4], bf16* pn, int wm,
                                               int col0) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * wm + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(pn + r * C + c) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(pn + (r + 8) * C + c) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// P[n] = round(h·W) with mma.sync: A and B through ldmatrix from the stage.
// The weight tile is [F/8][C/8] core matrices of 8 columns × 8 k.
template <int R, int C>
__device__ __forceinline__ void product_mma(const unsigned char* xs, const bf16* ws, int f,
                                            bf16* pn) {
  using L = MmaTiles<R, C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % L::kWm, wn = warp / L::kWm;
  float acc[L::kNt][4];
#pragma unroll
  for (int j = 0; j < L::kNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const ARow a0 = a_row<bf16>(xs, f, wm);
  // lanes 0-7: rows of core (2ks, nb); lanes 8-15: of core (2ks + 1, nb)
  const uint32_t b0 = smem_u32(ws) + ((lane >> 3) & 1) * (C / 8) * 128 + (lane & 7) * 16 +
                      wn * L::kNt * 128;
  // two k-steps a round, the fragments of the next loaded before the
  // products of the current (f is a multiple of 32)
  uint32_t a[2][4], b[2][L::kNt][2];
  auto load = [&](int buf, int ks) {
    ldmatrix_x4(a[buf], a0.at(ks));
#pragma unroll
    for (int j = 0; j < L::kNt; ++j) ldmatrix_x2(b[buf][j], b0 + (2 * ks * (C / 8) + j) * 128);
  };
  auto multiply = [&](int buf) {
#pragma unroll
    for (int j = 0; j < L::kNt; ++j) mma_bf16(acc[j], a[buf], b[buf][j][0], b[buf][j][1]);
  };
  const int ksteps = f / 16;
  load(0, 0);
  for (int ks = 0; ks < ksteps; ks += 2) {
    load(1, ks + 1);
    multiply(0);
    if (ks + 2 < ksteps) load(0, ks + 2);
    multiply(1);
  }
  store_products<C, L::kNt>(acc, pn, wm, wn * L::kNt * 8);
}

// P[n] = h·W in fp32 FMAs (weight tile row-major [F][C]), a thread per output.
template <int R, int C>
__device__ __forceinline__ void product_fma(const unsigned char* xs, const float* ws, int f,
                                            float* pn) {
  const int mask = swizzle_mask(f / 4);
  for (int o = threadIdx.x; o < R * C; o += kConsumers) {
    const int r = o / C, c = o % C, swz = r & mask;
    const float* xr = reinterpret_cast<const float*>(xs + sizeof(float) * r * f);
    float acc = 0.0f;
    for (int k = 0; k < f; ++k) acc = fmaf(xr[(((k >> 2) ^ swz) << 2) | (k & 3)], ws[k * C + c], acc);
    pn[r * C + c] = acc;
  }
}

// G [N, N] bf16 → this lane's mma A fragments of Gpad [32 × 32]:
// ga[mt][ks] covers out-nodes 16·mt …, in-nodes 16·ks ….
__device__ __forceinline__ void load_mix_fragments(uint32_t (&ga)[2][2][4], const bf16* g) {
  const int lane = threadIdx.x & 31;
  auto at = [&](int n, int m) {
    return (n < kNodes && m < kNodes) ? g[n * kNodes + m] : __float2bfloat16_rn(0.0f);
  };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 16 * mt + (lane >> 2) + 8 * (i & 1);
        const int m = 16 * ks + 2 * (lane & 3) + 8 * (i >> 1);
        __nv_bfloat162 v;
        v.x = at(n, m);
        v.y = at(n, m + 1);
        ga[mt][ks][i] = *reinterpret_cast<const uint32_t*>(&v);
      }
}

// Y = G·P in place on the tensor cores, 8 positions a step per warp.
template <int R, int C>
__device__ __forceinline__ void mix_mma(bf16* p, int plane, const unsigned char* zero,
                                        const uint32_t (&ga)[2][2][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix.trans row `lane` is node `lane` (nodes past 21: the zero row)
  const uint32_t row = lane < kNodes ? smem_u32(p) + lane * plane * 2 : 0u;
  const uint32_t zrow = smem_u32(zero);
  for (int t = warp; t < R * C / 8; t += kConsumerWarps) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, lane < kNodes ? row + t * 16 : zrow);
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(d0, ga[0][0], b[0], b[1]);
    mma_bf16(d0, ga[0][1], b[2], b[3]);
    mma_bf16(d1, ga[1][0], b[0], b[1]);
    mma_bf16(d1, ga[1][1], b[2], b[3]);
    const int n = lane >> 2;
    bf16* col = p + t * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(col + n * plane) = pack_bf16(d0[0], d0[1]);
    *reinterpret_cast<uint32_t*>(col + (n + 8) * plane) = pack_bf16(d0[2], d0[3]);
    if (16 + n < kNodes) *reinterpret_cast<uint32_t*>(col + (16 + n) * plane) = pack_bf16(d1[0], d1[1]);
  }
}

// Y = G·P in place in fp32 FMAs, a thread per position (G in shared memory,
// rows padded to kGStride).
template <int R, int C>
__device__ __forceinline__ void mix_fma(float* p, int plane, const float* g) {
  for (int pos = threadIdx.x; pos < R * C; pos += kConsumers) {
    float v[kGStride];
#pragma unroll
    for (int m = 0; m < kNodes; ++m) v[m] = p[m * plane + pos];
#pragma unroll
    for (int m = kNodes; m < kGStride; ++m) v[m] = 0.0f;
#pragma unroll 1
    for (int n = 0; n < kNodes; ++n) {
      const float4* gr = reinterpret_cast<const float4*>(g + n * kGStride);
      float y = 0.0f;
#pragma unroll
      for (int q = 0; q < kGStride / 4; ++q) {
        const float4 gq = gr[q];
        y = fmaf(gq.x, v[4 * q], y);
        y = fmaf(gq.y, v[4 * q + 1], y);
        y = fmaf(gq.z, v[4 * q + 2], y);
        y = fmaf(gq.w, v[4 * q + 3], y);
      }
      p[n * plane + pos] = y;
    }
  }
}

// ---- the engine -------------------------------------------------------------------

// The items of a launch: pairs of row tiles (one a block of a cluster) ×
// column groups.
__host__ __device__ inline int items(int rows, int tile_rows, int groups) {
  return ((rows + tile_rows - 1) / tile_rows + kCluster - 1) / kCluster * groups;
}

// What one launch works on: x [N, rows, f], g_rms [f], the packed banks
// w [N, groups, tile], G [N, N]; a row tile × column group per item.
template <typename T>
struct Problem {
  const T* x;
  const T* g_rms;
  const T* w;
  const T* g;
  int rows, f, groups, stages;
};

// Runs every item of this block; epi(p, plane, b0, valid, group) gets each
// item's mixed, rounded tile P [N][R][C] (plane elements between nodes) in
// shared memory, called by all consumer threads together.
template <typename T, int R, int C, typename Epi>
__device__ __forceinline__ void run(const Problem<T>& pb, unsigned char* smem, Epi epi) {
  const Layout l = layout<T>(R, C, pb.f, pb.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* gmix = reinterpret_cast<float*>(smem + l.gmix);
  T* p = reinterpret_cast<T*>(smem + l.p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  // an item: a pair of adjacent row tiles (one a block of the cluster) × a group
  const int n_items = items(pb.rows, R, pb.groups);
  auto rows_of = [&](int item, int& b0, int& valid) {
    b0 = ((item / pb.groups) * kCluster + static_cast<int>(rank)) * R;
    valid = max(0, min(R, pb.rows - b0));
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < pb.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps * kCluster);
    }
    *reinterpret_cast<uint4*>(smem + kZeroOffset) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (is_f32<T>()) {
    for (int i = threadIdx.x; i < kNodes * kGStride; i += kThreads) {
      const int n = i / kGStride, m = i % kGStride;
      gmix[i] = m < kNodes ? to_f(pb.g[n * kNodes + m]) : 0.0f;
    }
  }
  cluster_sync();  // the peer's barriers exist before anything reaches them

  if (warp == kConsumerWarps) {
    if (lane == 0) {  // the producer
      const uint32_t row_bytes = pb.f * sizeof(T);
      const uint32_t w_bytes = static_cast<uint32_t>(sizeof(T) * pb.f * C);
      const uint32_t w_part = w_bytes / kCluster;
      uint32_t q = 0;
      for (int item = cluster_id(); item < n_items; item += cluster_count()) {
        const int grp = item % pb.groups;
        int b0, valid;
        rows_of(item, b0, valid);
        for (int n = 0; n < kNodes; ++n, ++q) {
          const int s = q % pb.stages;
          mbar_wait(&empty[s], ((q / pb.stages) & 1) ^ 1);  // both blocks' consumers are done
          unsigned char* st = smem + l.stages + s * l.stage_bytes;
          mbar_expect_tx(&full[s], valid * row_bytes + w_bytes);
          if (valid > 0)
            bulk_load(st, pb.x + (static_cast<size_t>(n) * pb.rows + b0) * pb.f,
                      valid * row_bytes, &full[s]);
          // this block's part of the weight tile, into both blocks
          const unsigned char* wt = reinterpret_cast<const unsigned char*>(
              pb.w + (static_cast<size_t>(n) * pb.groups + grp) * pb.f * C);
          bulk_load_multicast(st + l.x_bytes + rank * w_part, wt + rank * w_part, w_part,
                              &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    uint32_t ga[2][2][4];
    if (!is_f32<T>()) load_mix_fragments(ga, reinterpret_cast<const bf16*>(pb.g));
    RowGain<T> gain;
    gain.load(pb.g_rms, pb.f);
    uint32_t q = 0;
    for (int item = cluster_id(); item < n_items; item += cluster_count()) {
      const int grp = item % pb.groups;
      int b0, valid;
      rows_of(item, b0, valid);
      for (int n = 0; n < kNodes; ++n, ++q) {
        const int s = q % pb.stages;
        mbar_wait(&full[s], (q / pb.stages) & 1);
        unsigned char* xs = smem + l.stages + s * l.stage_bytes;
        const T* ws = reinterpret_cast<const T*>(xs + l.x_bytes);
        normalize_tile<T, R>(xs, gain, pb.f, valid);
        fence_proxy_async();
        consumer_sync();
        if constexpr (is_f32<T>()) {
          product_fma<R, C>(xs, ws, pb.f, p + n * l.plane);
        } else {
          product_mma<R, C>(xs, ws, pb.f, p + n * l.plane);
        }
        __syncwarp();
        if (lane == 0) {  // the stage may be refilled once both blocks are done with it
          mbar_arrive(&empty[s]);
          mbar_arrive_peer(&empty[s], rank ^ 1u);
        }
      }
      consumer_sync();
      if constexpr (is_f32<T>()) {
        mix_fma<R, C>(p, l.plane, gmix);
      } else {
        mix_mma<R, C>(p, l.plane, smem + kZeroOffset, ga);
      }
      consumer_sync();
      epi(static_cast<const T*>(p), l.plane, b0, valid, grp);
    }
  }
  cluster_sync();  // no block leaves while its peer may still reach its memory
}

// The epilogue of B3a: the item's tile P [N][R][C] → out [N, rows, fo] at
// columns c0 …, 16-byte stores, rows < valid and columns < fo only.
template <typename T, int R, int C>
__device__ __forceinline__ void store_tile(const T* p, int plane, T* out, int rows, int fo,
                                           int b0, int valid, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = C / kVec;
  for (int i = threadIdx.x; i < kNodes * R * kPerRow; i += kConsumers) {
    const int v = i % kPerRow, r = i / kPerRow % R, n = i / (kPerRow * R);
    const int c = c0 + v * kVec;
    if (r < valid && c < fo)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(n) * rows + b0 + r) * fo + c) =
          *reinterpret_cast<const uint4*>(p + n * plane + r * C + v * kVec);
  }
}

// Launch `kernel` on a persistent grid of clusters of `cluster` blocks (as
// many as fit on the card at once, at most one an item) with `smem` bytes of
// dynamic shared memory; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int items, size_t smem, int cluster, void* stream,
                   Args... args) {
  if (smem > static_cast<size_t>(kMaxSmem) || cluster != kCluster || items < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((items < clusters ? items : clusters) * cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sm90mix
