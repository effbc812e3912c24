// The product-and-mix engine of the fused denoiser's kernels for NVIDIA
// Hopper (sm_90a), with two kinds of item:
//
// * a row tile × a group of output columns (`run`): RMSNorm → per-node
//   product → node mix, the attention layer's input stage, B3a (rms_qkv,
//   attention_proj.cu) and B9b (rms_qkv_core, layer_fused.cu);
// * a row tile × every column (`run_blocks`, below `store_tile`): up to
//   three per-node products, each followed by a node mix, with P in shared
//   memory from the first product to the last mix: the attention layer's
//   out-projection, B3b (outproj_res, attention_proj.cu), the ResnetBlock, B1
//   (resnet_block, resnet_block.cu), both, B9c (outproj_block,
//   layer_fused.cu), the stem, B4 (graph_linear_fused, graph_linear_fused.cu),
//   the stem with block 0, B9a (stem_block, layer_fused.cu), and the final
//   block's two halves with the output head, B5a and B5b (final_block_in,
//   final_block_out, resnet_block.cu).
//
// Both share the roles, the ring of bulk copies on mbarriers, the two-block
// clusters with multicast weight tiles, the mma.sync products through
// ldmatrix and the tensor-core node mix described here for the first.
//
// Over node-major activations [N, B, F] (N = nodemix::kNodes, 2 to 51 nodes,
// set per build: 16 for H36M, 17 for FreeMan, 21 for AMASS, 51 for
// AMASS-MANO), for one tile of R rows
// and one group of C output columns (an item of the first kind):
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
// column) at a time, Yᵀ = G·P with G [16·T × 16·T] (N × N zero-padded to T =
// ⌈N/16⌉ m16 tiles, held in registers as mma A fragments from its bf16
// values, which are exact) and P's N node values of those positions through
// one ldmatrix.trans a 32 nodes (rows of the nodes past N point at a zero
// row): T = 1 at N ≤ 16, 2 up to 32, 4 at AMASS-MANO's 51 (two
// ldmatrix.trans, 16 mma a step).  fp32: FMAs, a thread per position.
//
// Tiles past 21 nodes (nodemix::kWide).  P holds all N nodes' products of a
// tile, so its rows shrink with N: at 51 nodes the whole-row kernels take 8
// rows in bf16 (`BlockRows`; 16 would need 356–383 KB), B3a 16 rows × 64
// columns and B9b 8 rows × a head's 96.  An 8-row tile runs the products
// as a half-empty m16 tile: the A rows 8–15 of the ldmatrix read the zero
// row and the accumulators of those rows are dropped.  The fp32 tiles stay
// as they are and do not fit at 51 nodes: their plans refuse (ROADMAP Queue
// B item 10).
//
// P lives in shared memory as [N][R][C] in the element type, each node's
// plane padded by 16 bytes (the mix's ldmatrix rows, one per node, then fall
// in distinct banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "node_mix.cuh"

namespace sm90mix {

using bf16 = __nv_bfloat16;
using nodemix::from_f;
using nodemix::to_f;

constexpr int kNodes = nodemix::kNodes;                // the build's node count
constexpr int kGStride = (kNodes + 3) / 4 * 4;         // fp32 G rows padded to whole float4s
constexpr int kMixTiles = (kNodes + 15) / 16;          // m16 tiles (and k-steps) of a node mix
constexpr int kGaTiles = kMixTiles > 2 ? kMixTiles : 2;  // the A fragments' tiles held
constexpr int kMixLd = (kMixTiles + 1) / 2;            // ldmatrix.x4.trans a step (32 nodes each)
constexpr int kNodeRows = (kNodes + 7) / 8;            // groups of 8 nodes (a fragment's rows)
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxStages = 4;
constexpr int kCluster = 2;           // blocks a cluster: adjacent row tiles sharing weight tiles
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory a block
constexpr int kPlanePad = 16;         // bytes after each node's plane of P
constexpr int kMaxF = 256;            // the widest input row the kernels normalise
constexpr int kZeroOffset = 2 * kMaxStages * 8;  // a 16-byte zero row after the barriers
static_assert(kZeroOffset + 16 <= 128, "the barriers and the zero row fill the first 128 bytes");

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

// bytes from device memory into the same offset of the shared memory of the
// cluster's blocks in `mask` (by default both of a two-block cluster),
// completing on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void bulk_load_multicast(
    void* dst, const void* src, uint32_t bytes, uint64_t* bar,
    uint16_t mask = static_cast<uint16_t>((1u << kCluster) - 1u)) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// 16 bytes from device memory into this block's shared memory by this
// thread (cp.async, cached in L2 only); src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Wait until this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
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

// The largest divisor of n that is at most m.
constexpr int divisor_at_most(int n, int m) {
  int d = m;
  while (n % d) --d;
  return d;
}

// Warp layout of the bf16 products: R/16 row tiles (one at R = 8, rows 8–15
// empty) × column parts, each warp 16 rows × kNt n8 tiles; the warps past
// kWm·kWn (B9b's 8 × 96 tile: 6 of 8 warps) take no products.
template <int R, int C>
struct MmaTiles {
  static constexpr int kWm = R >= 16 ? R / 16 : 1;
  static constexpr int kWn = divisor_at_most(C / 8, kConsumerWarps / kWm);
  static constexpr int kNt = C / (8 * kWn);
  static_assert((R == 8 || R % 16 == 0) && kWm * kWn <= kConsumerWarps && kNt * 8 * kWn == C,
                "bf16 tile");
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

// Rounded sums of one warp's tile → P (row-major [R][C] of one node); at
// R = 8 the m16 tile's rows 8–15 are dropped.
template <int R, int C, int kNt>
__device__ __forceinline__ void store_products(const float (&acc)[kNt][4], bf16* pn, int wm,
                                               int col0) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * wm + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int c = col0 + 8 * j + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(pn + r * C + c) = pack_bf16(acc[j][0], acc[j][1]);
    if constexpr (R > 8)
      *reinterpret_cast<uint32_t*>(pn + (r + 8) * C + c) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// P[n] = round(h·W) with mma.sync: A and B through ldmatrix from the stage.
// The weight tile is [F/8][C/8] core matrices of 8 columns × 8 k.  At R = 8
// the A rows 8–15 read `zero`, a 16-byte zero row.
template <int R, int C>
__device__ __forceinline__ void product_mma(const unsigned char* xs, const bf16* ws, int f,
                                            bf16* pn, const unsigned char* zero) {
  using L = MmaTiles<R, C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (L::kWm * L::kWn < kConsumerWarps) {
    if (warp >= L::kWm * L::kWn) return;
  }
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
    if constexpr (R < 16) {
      ldmatrix_x4(a[buf], (lane & 15) < R ? a0.at(ks) : smem_u32(zero));
    } else {
      ldmatrix_x4(a[buf], a0.at(ks));
    }
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
  store_products<R, C, L::kNt>(acc, pn, wm, wn * L::kNt * 8);
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

// G [N, N] bf16 → this lane's mma A fragments of Gpad [16·kGaTiles]²:
// ga[mt][ks] covers out-nodes 16·mt …, in-nodes 16·ks ….
__device__ __forceinline__ void load_mix_fragments(uint32_t (&ga)[kGaTiles][kGaTiles][4],
                                                   const bf16* g) {
  const int lane = threadIdx.x & 31;
  auto at = [&](int n, int m) {
    return (n < kNodes && m < kNodes) ? g[n * kNodes + m] : __float2bfloat16_rn(0.0f);
  };
#pragma unroll
  for (int mt = 0; mt < kGaTiles; ++mt)
#pragma unroll
    for (int ks = 0; ks < kGaTiles; ++ks)
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

// The node mix's products of one step: d[mt] += G's tile (mt, ks)·b's
// k-step ks, where ldmatrix.x4.trans j gave k-steps 2j and 2j + 1.
__device__ __forceinline__ void mix_step(float (&d)[kGaTiles][4],
                                         const uint32_t (&ga)[kGaTiles][kGaTiles][4],
                                         const uint32_t (&b)[kMixLd][4]) {
#pragma unroll
  for (int mt = 0; mt < kMixTiles; ++mt)
#pragma unroll
    for (int ks = 0; ks < kMixTiles; ++ks)
      mma_bf16(d[mt], ga[mt][ks], b[ks >> 1][2 * (ks & 1)], b[ks >> 1][2 * (ks & 1) + 1]);
}

// Y = G·P in place on the tensor cores, 8 positions a step per warp.
template <int R, int C>
__device__ __forceinline__ void mix_mma(bf16* p, int plane, const unsigned char* zero,
                                        const uint32_t (&ga)[kGaTiles][kGaTiles][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // row `lane` of ldmatrix.trans j is node 32·j + lane (nodes past N: the zero row)
  uint32_t row[kMixLd];
#pragma unroll
  for (int j = 0; j < kMixLd; ++j)
    row[j] = 32 * j + lane < kNodes ? smem_u32(p) + (32 * j + lane) * plane * 2 : 0u;
  const uint32_t zrow = smem_u32(zero);
  for (int t = warp; t < R * C / 8; t += kConsumerWarps) {
    uint32_t b[kMixLd][4];
#pragma unroll
    for (int j = 0; j < kMixLd; ++j)
      ldmatrix_x4_trans(b[j], 32 * j + lane < kNodes ? row[j] + t * 16 : zrow);
    float d[kGaTiles][4] = {};
    mix_step(d, ga, b);
    const int n = lane >> 2;
    bf16* col = p + t * 8 + 2 * (lane & 3);
    // this lane's rows: nodes n + 8·k, k < kNodeRows
#pragma unroll
    for (int k = 0; k < kNodeRows; ++k)
      if (n + 8 * k < kNodes)
        *reinterpret_cast<uint32_t*>(col + (n + 8 * k) * plane) =
            pack_bf16(d[k >> 1][2 * (k & 1)], d[k >> 1][2 * (k & 1) + 1]);
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
// shared memory, called by all consumer threads together; it may overwrite
// P (B9b stages its attention's output there).
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
    uint32_t ga[kGaTiles][kGaTiles][4];
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
          product_mma<R, C>(xs, ws, pb.f, p + n * l.plane, smem + kZeroOffset);
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
      epi(p, l.plane, b0, valid, grp);
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

// ---- whole-row-tile items: the ResnetBlock kernels (B1, B9c) ------------------------

// A ResnetBlock's second product contracts over all F columns of h, for each
// node, so its item is a row tile × every column: P holds all N nodes'
// R × F products and stays in shared memory from the first product to the
// last mix.  An item runs up to kMaxPasses product passes, each followed by
// a node mix with the kernel's epilogue:
//
//   pass i, node n:  P[n] = round(A[n]·W_i[n] (+ b_i[n]))     fp32 sums
//
// where A[n] is node n's R input rows from device memory (x for B1's first
// pass, a for B9c's out-projection, x‖r for both of B5a's, from x and r
// side by side: no k-slice straddles them; the stem input x of B4 and B9a,
// 96 wide, contracted as 128 with zeros past column 96 against a bank whose
// rows 96–127 are zero) or P[n] itself, in place (every later pass).  The
// stem pass also adds u [N, rows, f] after the bias (`product<true>`).  A
// pass with fewer output columns than F (B5b's head) is an F-wide pass whose
// bank and bias are zero past its columns; only its store is narrower.  The
// ring carries, per (pass, node, k-slice of kslice rows of the bank), the
// k-slice of the R input rows (16-byte cp.async copies by the
// producer warp's 32 lanes, each lane's arrival on the stage's `full`
// barrier once its copies land; a bulk copy a row made the loads the
// bottleneck; none for a pass in place) and half of the k-slice of node n's
// bank, multicast into both blocks of the cluster: [kslice][F] from the
// bank packed once by the wrapper (node_mix_sm90.py::pack_banks, one group
// of all F columns: a k-slice is contiguous).  A warp accumulates its
// 16 rows × F/8 columns (fp32: a thread its outputs) over the k-slices in
// registers, so a pass in place overwrites node n's plane only after a
// barrier that every warp reaches once it has read that plane.
//
// Rows of P and of a staged slice are padded by 16 bytes (F = 192: 400-byte
// rows), so the 8 rows of an ldmatrix fall in 8 distinct bank groups with
// no swizzle.

constexpr int kMaxPasses = 3;
constexpr int kMaxNt = kMaxF / 64;  // n8 tiles of a warp's columns (bf16: F = 64·NT)

// Byte offsets of one block's shared memory.  The wrappers' tile plan
// (ops/kernels/node_mix_sm90.py::block_plan_bytes) computes the same total.
struct BlockLayout {
  size_t gmix, film, stages, stage_bytes, a_bytes, p, total;
  int a_stride, p_stride, plane;  // elements between rows of a staged slice, of P; between planes
};

template <typename T>
__host__ __device__ BlockLayout block_layout(int rows, int f, int kslice, int stages, int mixes) {
  constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  BlockLayout l{};
  size_t off = 128;  // full[kMaxStages], empty[kMaxStages], the zero row
  l.gmix = off;
  off += is_f32<T>() ? up(sizeof(float) * kNodes * kGStride * mixes) : 0;
  l.film = off;
  off += up(sizeof(float) * 2 * f);
  l.a_stride = kslice + kPad;
  l.a_bytes = up(sizeof(T) * rows * l.a_stride);
  l.stage_bytes = l.a_bytes + up(sizeof(T) * kslice * f);
  l.stages = off;
  off += stages * l.stage_bytes;
  l.p_stride = f + kPad;
  l.plane = static_cast<int>((sizeof(T) * rows * l.p_stride + kPlanePad) / sizeof(T));
  l.p = off;
  off += up(sizeof(T) * kNodes * l.plane);
  l.total = off;
  return l;
}

// One product pass: A from device memory a [N, rows, k] (nullptr: P in
// place), the packed bank w [N, k·f], the bias [N, f] or nullptr.
template <typename T>
struct BlockPass {
  const T* a;
  const T* w;
  const T* bias;
  int k;
};

// Where a launch's device inputs come from (run_blocks' kInput): each pass's
// a [N, rows, k] whole; split in two (B5a's x‖r: a [N, rows, f] gives the
// columns < f and BlockProblem::a2 [N, rows, f] the others); or narrow (B9a's
// stem: a [N, rows, a_cols], a_cols < k, the columns past a_cols zeros).
enum class Input { kWhole, kSplit, kNarrow };

// What one launch works on: the passes, the influence of each pass's mix
// [N, N], FiLM's scale‖shift [2f] (nullptr for a kernel without FiLM), rows
// and widths, the plan, and a2 (Input::kSplit) or a_cols (Input::kNarrow).
template <typename T>
struct BlockProblem {
  BlockPass<T> pass[kMaxPasses];
  const T* g[kMaxPasses];
  const T* film;
  int passes, rows, f, kslice, stages;
  const T* a2 = nullptr;
  int a_cols = 0;
};

// A position in the ring: the stage and the parity of its current phase.
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
};

// The producer warp: for every item, pass, node and k-slice, one stage.
// Input::kSplit: each k-slice of a pass's input comes wholly from a (columns
// < f) or from pb.a2 (f a multiple of the k-slice); Input::kNarrow: the
// chunks of columns ≥ pb.a_cols (a multiple of 16 bytes) are zero-filled,
// their source never read.
template <typename T, int R, Input kInput>
__device__ __forceinline__ void produce_blocks(const BlockProblem<T>& pb, const BlockLayout& l,
                                               unsigned char* smem, uint64_t* full,
                                               uint64_t* empty, uint32_t rank, int n_items) {
  const int lane = threadIdx.x & 31;
  const int a_chunks = static_cast<int>(sizeof(T)) * pb.kslice / 16;  // of an input row's k-slice
  const uint32_t w_bytes = static_cast<uint32_t>(sizeof(T) * pb.kslice * pb.f);
  const uint32_t w_part = w_bytes / kCluster;
  RingPos q;
  for (int item = cluster_id(); item < n_items; item += cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(rank)) * R;
    const int valid = max(0, min(R, pb.rows - b0));
    for (int i = 0; i < pb.passes; ++i) {
      const BlockPass<T> ps = pb.pass[i];
      const int slices = ps.k / pb.kslice;
      for (int n = 0; n < kNodes; ++n)
        for (int j = 0; j < slices; ++j, q.advance(pb.stages)) {
          const int s = q.s;
          mbar_wait(&empty[s], q.phase ^ 1u);  // both blocks' consumers are done
          unsigned char* st = smem + l.stages + s * l.stage_bytes;
          if (lane == 0) mbar_expect_tx(&full[s], w_bytes);
          __syncwarp();
          if (ps.a != nullptr) {  // the input rows' k-slice, 16 bytes a copy, zeros past the last row
            const T* src = ps.a;
            int lda = ps.k, col = j * pb.kslice;
            if constexpr (kInput == Input::kSplit) {
              lda = pb.f;
              if (col >= pb.f) {
                src = pb.a2;
                col -= pb.f;
              }
            } else if constexpr (kInput == Input::kNarrow) {
              lda = pb.a_cols;
            }
            for (int e = lane; e < R * a_chunks; e += 32) {
              const int r = e / a_chunks, cc = e % a_chunks;
              const int row = min(b0 + r, pb.rows - 1);
              int c = col + cc * (16 / static_cast<int>(sizeof(T)));
              bool read = r < valid;
              if constexpr (kInput == Input::kNarrow) {
                read = read && c < lda;
                c = c < lda ? c : 0;  // a zero-filled chunk's source: the row's start
              }
              cp_async_16(st + sizeof(T) * r * l.a_stride + 16 * cc,
                          src + (static_cast<size_t>(n) * pb.rows + row) * lda + c,
                          read ? 16u : 0u);
            }
          }
          cp_async_arrive(&full[s]);  // every lane, every stage
          if (lane == 0) {  // this block's half of the bank's k-slice, into both blocks
            const unsigned char* wt = reinterpret_cast<const unsigned char*>(
                ps.w + (static_cast<size_t>(n) * ps.k + j * pb.kslice) * pb.f);
            bulk_load_multicast(st + l.a_bytes + rank * w_part, wt + rank * w_part, w_part,
                                &full[s]);
          }
        }
    }
  }
}

// A consumer's view of one item: the ring, P, and the item's rows.  NT:
// the n8 tiles of a warp's columns in bf16 (f = 64·NT), 0 in fp32.
template <typename T, int R, int NT>
struct BlockItem {
  const BlockProblem<T>& pb;
  const BlockLayout& l;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  uint32_t rank;
  RingPos& q;
  int b0, valid;

  // f and P's row stride: compile-time in bf16 (f = 64·NT)
  static constexpr int kF = 64 * NT, kPStride = kF + 16 / static_cast<int>(sizeof(T));
  __device__ __forceinline__ int width() const { return NT ? kF : pb.f; }
  __device__ __forceinline__ int p_stride() const { return NT ? kPStride : l.p_stride; }
  __device__ __forceinline__ T* p() const { return reinterpret_cast<T*>(smem + l.p); }
  // FiLM's scale + 1 (columns 0 … f) and shift (f … 2f), fp32
  __device__ __forceinline__ const float* film() const {
    return reinterpret_cast<const float*>(smem + l.film);
  }

  __device__ __forceinline__ unsigned char* wait_stage() const {
    mbar_wait(&full[q.s], q.phase);
    return smem + l.stages + q.s * l.stage_bytes;
  }
  // the stage may be refilled once both blocks' consumers are done with it
  __device__ __forceinline__ void release_stage() const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive(&empty[q.s]);
      mbar_arrive_peer(&empty[q.s], rank ^ 1u);
    }
    q.advance(pb.stages);
  }

  // P[n] ← round(A[n]·W[n] + bias[n] (+ addend[n])) for every node of pass
  // i, with kAddend the element of addend [N, rows, f] at the same node, row
  // and column added after the bias (B9a's stem adds u: (x·W + b) + u, as
  // the plain version sums); ends with the consumers synchronised.
  template <bool kAddend = false>
  __device__ void product(int i, const T* addend = nullptr) {
    const BlockPass<T> ps = pb.pass[i];
    const bool in_place = ps.a == nullptr;
    for (int n = 0; n < kNodes; ++n) {
      if constexpr (is_f32<T>()) {
        product_node_fma<kAddend>(ps, n, in_place, addend);
      } else {
        product_node_mma<kAddend>(ps, n, in_place, addend);
      }
    }
    consumer_sync();
  }

  // bf16: a warp takes the 16 rows × columns 8·NT·warp … of width 8·NT (at
  // R = 8 a half-empty m16 tile: its A rows 8–15 read the zero row, their
  // sums are dropped).
  // A k-slice's fragments (A through ldmatrix from the stage or from P, B
  // from the stage) go to registers and the stage is released at once; the
  // next k-slice's are loaded before this one's products.  The bias pairs
  // (and the addend's, kAddend) are loaded before the products.
  template <bool kAddend>
  __device__ __forceinline__ void product_node_mma(const BlockPass<T>& ps, int n, bool in_place,
                                                   const T* addend) {
    static_assert((R == 16 || R == 8) && NT >= 1 && NT <= kMaxNt,
                  "a warp's tile: 16 rows (8 of them empty at R = 8) × 8·NT columns");
    constexpr int kMaxKs = 4;  // k-steps of a k-slice (kslice ≤ 64)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int f = kF;
    const int ksteps = pb.kslice / 16, slices = ps.k / pb.kslice;
    T* pn = p() + n * l.plane;
    float acc[NT][4];
    float2 bias[NT];  // this lane's bias pairs, loaded before the products
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const int c = (warp * NT + j) * 8 + 2 * (lane & 3);
      bias[j] = ps.bias != nullptr ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                         ps.bias + n * f + c))
                                   : make_float2(0.0f, 0.0f);
    }
    uint32_t add[NT][2];  // kAddend: this lane's addend pairs of rows lane/4 and lane/4 + 8
    if constexpr (kAddend) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h, c = (warp * NT + j) * 8 + 2 * (lane & 3);
          add[j][h] = r < valid ? *reinterpret_cast<const uint32_t*>(
                                      addend + (static_cast<size_t>(n) * pb.rows + b0 + r) * f + c)
                                : 0u;
        }
    }
    uint32_t a[2][kMaxKs][4], b[2][kMaxKs][NT][2];
    auto load = [&](int buf, int sl) {
      const unsigned char* st = wait_stage();
      // this lane's A row (lane % 16) and k half (lane / 16) of a k-step
      uint32_t arow =
          (in_place ? smem_u32(pn) + sizeof(T) * ((lane & 15) * kPStride + sl * pb.kslice)
                    : smem_u32(st) + sizeof(T) * (lane & 15) * l.a_stride) +
          (lane >> 4) * 16;
      uint32_t astep = 32;  // bytes between the A addresses of two k-steps
      if constexpr (R < 16) {
        if ((lane & 15) >= R) {  // the empty rows of the m16 tile
          arow = smem_u32(smem + kZeroOffset);
          astep = 0;
        }
      }
      // lanes 0-7: rows of core (2ks, nb); lanes 8-15: of core (2ks + 1, nb)
      const uint32_t bw = smem_u32(st + l.a_bytes) + ((lane >> 3) & 1) * (f / 8) * 128 +
                          (lane & 7) * 16 + warp * NT * 128;
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks) {
        if (ks < ksteps) {
          ldmatrix_x4(a[buf][ks], arow + ks * astep);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            ldmatrix_x2(b[buf][ks][j], bw + (2 * ks * (f / 8) + j) * 128);
        }
      }
      release_stage();
    };
    auto multiply = [&](int buf) {
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (ks < ksteps) mma_bf16(acc[j], a[buf][ks], b[buf][ks][j][0], b[buf][ks][j][1]);
    };
    load(0, 0);
    for (int sl = 0; sl < slices; sl += 2) {
      if (sl + 1 < slices) load(1, sl + 1);
      multiply(0);
      if (sl + 2 < slices) load(0, sl + 2);
      if (sl + 1 < slices) multiply(1);
    }
    if (in_place) consumer_sync();  // every warp has read node n's plane
    const int r = lane >> 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = (warp * NT + j) * 8 + 2 * (lane & 3);
      bf16* out = reinterpret_cast<bf16*>(pn) + r * kPStride + c;
      float v[4] = {acc[j][0] + bias[j].x, acc[j][1] + bias[j].y, acc[j][2] + bias[j].x,
                    acc[j][3] + bias[j].y};
      if constexpr (kAddend) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&add[j][h]));
          v[2 * h] += u.x;
          v[2 * h + 1] += u.y;
        }
      }
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(v[0], v[1]);
      if constexpr (R > 8) *reinterpret_cast<uint32_t*>(out + 8 * kPStride) = pack_bf16(v[2], v[3]);
    }
  }

  // fp32: a thread per output (tid + kConsumers·i), FMAs over the k-slices.
  template <bool kAddend>
  __device__ __forceinline__ void product_node_fma(const BlockPass<T>& ps, int n, bool in_place,
                                                   const T* addend) {
    constexpr int kOut = R * kMaxF / kConsumers;
    const int f = pb.f, slices = ps.k / pb.kslice;
    float* pn = reinterpret_cast<float*>(p()) + n * l.plane;
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    for (int sl = 0; sl < slices; ++sl) {
      const unsigned char* st = wait_stage();
      const float* a = in_place ? pn + sl * pb.kslice : reinterpret_cast<const float*>(st);
      const int lda = in_place ? l.p_stride : l.a_stride;
      const float* w = reinterpret_cast<const float*>(st + l.a_bytes);
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int o = threadIdx.x + kConsumers * i;
        if (o < R * f) {
          const float* ar = a + (o / f) * lda;
          const float* wc = w + o % f;
          for (int k = 0; k < pb.kslice; ++k) acc[i] = fmaf(ar[k], wc[k * f], acc[i]);
        }
      }
      release_stage();
    }
    if (in_place) consumer_sync();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = threadIdx.x + kConsumers * i;
      if (o < R * f) {
        const int r = o / f, c = o % f;
        float v = acc[i] + (ps.bias != nullptr ? to_f(ps.bias[n * f + c]) : 0.0f);
        if constexpr (kAddend) {
          if (r < valid) v += to_f(addend[(static_cast<size_t>(n) * pb.rows + b0 + r) * f + c]);
        }
        pn[r * l.p_stride + c] = v;
      }
    }
  }

  // P ← round(epi(c, Y, res)) in place, Y = G_i·P in fp32 (bf16: on the
  // tensor cores, as mix_mma), res the element of res [N, rows, f] at the
  // same node, row and column (0 where res is nullptr or the row is past
  // the last); ends with the consumers synchronised.  kAhead: see mix_tc.
  template <bool kAhead = true, typename Epi>
  __device__ void mix(int i, const T* res, Epi epi) {
    const int f = pb.f;
    if constexpr (is_f32<T>()) {
      const float* g = reinterpret_cast<const float*>(smem + l.gmix) + i * kNodes * kGStride;
      float* pp = reinterpret_cast<float*>(p());
      for (int pos = threadIdx.x; pos < R * f; pos += kConsumers) {
        const int r = pos / f, c = pos % f, e = r * l.p_stride + c;
        float v[kGStride];
#pragma unroll
        for (int m = 0; m < kNodes; ++m) v[m] = pp[m * l.plane + e];
#pragma unroll
        for (int m = kNodes; m < kGStride; ++m) v[m] = 0.0f;
#pragma unroll 1
        for (int n = 0; n < kNodes; ++n) {
          const float4* gr = reinterpret_cast<const float4*>(g + n * kGStride);
          float y = 0.0f;
#pragma unroll
          for (int qq = 0; qq < kGStride / 4; ++qq) {
            const float4 gq = gr[qq];
            y = fmaf(gq.x, v[4 * qq], y);
            y = fmaf(gq.y, v[4 * qq + 1], y);
            y = fmaf(gq.z, v[4 * qq + 2], y);
            y = fmaf(gq.w, v[4 * qq + 3], y);
          }
          const float rv = res != nullptr && r < valid
                               ? res[(static_cast<size_t>(n) * pb.rows + b0 + r) * f + c]
                               : 0.0f;
          pp[n * l.plane + e] = epi(c, y, rv);
        }
      }
    } else {
      mix_tc<kAhead>(i, res, epi);
    }
    consumer_sync();
  }

  // bf16: a warp takes the 16-byte chunks warp, warp + 8, … (NT of them) of
  // every row, a row at a time: for each chunk (8 positions) the node values
  // through ldmatrix.trans (one a 32 nodes; rows of the nodes past N: the
  // zero row), Yᵀ = G·P with G's mma A fragments in registers; this lane's
  // residual pairs of the next row are loaded before the current row's
  // products (kAhead), or of the current row (B5b: there the kernel spilled
  // the pairs held ahead, and each row waited on their round trips to L2).
  // Up to 32 nodes the products of all NT chunks of a row are held before
  // their stores; past 32 (four m16 tiles of sums a chunk) one chunk's.
  template <bool kAhead, typename Epi>
  __device__ __forceinline__ void mix_tc(int i, const T* res, Epi epi) {
    constexpr int kChunksHeld = kMixTiles > 2 ? 1 : NT;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint32_t ga[kGaTiles][kGaTiles][4];
    load_mix_fragments(ga, reinterpret_cast<const bf16*>(pb.g[i]));
    bf16* pp = reinterpret_cast<bf16*>(p());
    // row `lane` of ldmatrix.trans j: node 32·j + lane, or the zero row, which stays put
    uint32_t row[kMixLd], step[kMixLd];
    bool live[kMixLd];
#pragma unroll
    for (int j = 0; j < kMixLd; ++j) {
      live[j] = 32 * j + lane < kNodes;
      row[j] = live[j] ? smem_u32(pp) + (32 * j + lane) * l.plane * 2
                       : smem_u32(smem + kZeroOffset);
      step[j] = live[j] ? 2 * kPStride : 0u;
    }
    const int nl = lane >> 2, cl = 2 * (lane & 3);
    // this lane's residual pairs of row r: chunks warp + 8u, nodes nl + 8k
    auto residual = [&](int r, uint32_t (&v)[NT][kNodeRows]) {
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int k = 0; k < kNodeRows; ++k) {
          const int n = nl + 8 * k;
          v[u][k] = 0u;
          if (res != nullptr && r < valid && n < kNodes)
            v[u][k] = *reinterpret_cast<const uint32_t*>(
                res + (static_cast<size_t>(n) * pb.rows + b0 + r) * kF + (warp + 8 * u) * 8 + cl);
        }
    };
    uint32_t cur[NT][kNodeRows], next[NT][kNodeRows];
    if constexpr (kAhead) residual(0, cur);
    for (int r = 0; r < R; ++r) {
      if constexpr (kAhead) {
        residual(r + 1, next);
      } else {
        residual(r, cur);
      }
#pragma unroll
      for (int u0 = 0; u0 < NT; u0 += kChunksHeld) {
        float d[kChunksHeld][kGaTiles][4];
#pragma unroll
        for (int uu = 0; uu < kChunksHeld; ++uu) {
          const int u = u0 + uu;
          uint32_t bm[kMixLd][4];
#pragma unroll
          for (int j = 0; j < kMixLd; ++j)
            ldmatrix_x4_trans(bm[j], row[j] + r * step[j] + (live[j] ? 16 * (warp + 8 * u) : 0));
#pragma unroll
          for (int mt = 0; mt < kGaTiles; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[uu][mt][e] = 0.0f;
          mix_step(d[uu], ga, bm);
        }
#pragma unroll
        for (int uu = 0; uu < kChunksHeld; ++uu) {
          const int u = u0 + uu;
          const int c = (warp + 8 * u) * 8 + cl;
          bf16* col = pp + r * kPStride + c;
#pragma unroll
          for (int k = 0; k < kNodeRows; ++k) {
            const int n = nl + 8 * k;
            if (n < kNodes) {
              const float2 rv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cur[u][k]));
              // node n's pair: tile k / 2, rows 8·(k % 2) on
              const float y0 = d[uu][k >> 1][2 * (k & 1)], y1 = d[uu][k >> 1][2 * (k & 1) + 1];
              *reinterpret_cast<uint32_t*>(col + n * l.plane) =
                  pack_bf16(epi(c, y0, rv.x), epi(c + 1, y1, rv.y));
            }
          }
          if constexpr (kAhead) {
#pragma unroll
            for (int k = 0; k < kNodeRows; ++k) cur[u][k] = next[u][k];
          }
        }
      }
    }
  }

  // A ResnetBlock's two halves on P (pass i's product before each):
  //   film_half:  h   = round(tanh(FiLM(G_i·P)))
  //   res_half:   out = round(tanh(G_i·P) + res)
  // FiLM(y) = y·(scale + 1) + shift with FiLM's fp32 row, the product and the
  // sum each rounded to fp32, as the plain version computes them.
  __device__ __forceinline__ void film_half(int i) {
    const float* fm = film();
    const int f = width();
    mix(i, nullptr, [fm, f](int c, float y, float) {
      return tanhf(__fadd_rn(__fmul_rn(y, fm[c]), fm[f + c]));
    });
  }
  template <bool kAhead = true>
  __device__ __forceinline__ void res_half(int i, const T* res) {
    mix<kAhead>(i, res, [](int, float y, float r) { return __fadd_rn(tanhf(y), r); });
  }

  // The ResnetBlock on P with passes i and i + 1 (B1's body, and B9c's after
  // its out-projection):
  //   h   = round(tanh(FiLM(G_i·round(A·W_i + b_i))))
  //   out = round(tanh(G_{i+1}·round(h·W_{i+1} + b_{i+1})) + res)   into P
  __device__ void resnet_block(int i, const T* res) {
    product(i);
    film_half(i);
    product(i + 1);
    res_half(i + 1, res);
  }

  // The final block's first half and its residual projection over x‖r on
  // passes 0 and 1 (B5a's body):
  //   h   = round(tanh(FiLM(G_0·round([x‖r]·W_0 + b_0))))   into h_out
  //   res = round(G_1·round([x‖r]·W_1))                      into res_out
  __device__ void final_block_in(T* h_out, T* res_out) {
    product(0);
    film_half(0);
    store(h_out);
    product(1);
    mix(1, nullptr, [](int, float y, float) { return y; });
    store(res_out);
  }

  // The final block's second half and the output head on passes 0 and 1
  // (B5b's body), the head's bank and bias zero past its cols columns:
  //   o   = round(tanh(G_0·round(h·W_0 + b_0)) + res)   in P
  //   out = round(G_1·round(o·W_1 + b_1))               into out [N, rows, cols]
  __device__ void final_block_out(const T* res, T* out, int cols) {
    product(0);
    res_half<false>(0, res);
    product(1);
    mix(1, nullptr, [](int, float y, float) { return y; });
    store_cols(out, cols);
  }

  // The stem on pass 0 (B4's body, and B9a's first stage), u added after
  // the bias with kAddend:
  //   r = round(G_0·round(x·W_0 + b_0 (+ u)))   into P and r_out
  template <bool kAddend = true>
  __device__ void stem(const T* u, T* r_out) {
    product<kAddend>(0, u);
    mix(0, nullptr, [](int, float y, float) { return y; });
    store(r_out);
  }

  // The stem and block 0 on passes 0, 1 and 2 (B9a's body):
  //   r   = stem(x, u)                          into P and r_out
  //   out = ResnetBlock(r) on passes 1 and 2    into out
  // The block's last mix reads its residual r back from r_out, stored
  // before the barriers that end the passes between.
  __device__ void stem_block(const T* u, T* r_out, T* out) {
    stem(u, r_out);
    resnet_block(1, r_out);
    store(out);
  }

  // The attention layer's out-projection with its residual on pass 0 (B3b's
  // body, and B9c's first stage):
  //   out = round(G_0·round(A·W_0) + res)   into P, then into out
  __device__ void outproj_res(const T* res, T* out) {
    product(0);
    mix(0, res, [](int, float y, float r) { return __fadd_rn(y, r); });
    store(out);
  }

  // out [N, rows, f] ← P for the item's valid rows, 16-byte stores; ends
  // with the consumers synchronised.
  __device__ void store(T* out) { store_cols(out, width()); }

  // out [N, rows, cols] ← P's first cols columns, as store.
  __device__ __forceinline__ void store_cols(T* out, int cols) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = cols / kVec, ps = p_stride();
    const T* pp = p();
    for (int e = threadIdx.x; e < kNodes * R * per_row; e += kConsumers) {
      const int v = e % per_row, r = e / per_row % R, n = e / (per_row * R);
      if (r < valid)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(n) * pb.rows + b0 + r) * cols +
                                  v * kVec) =
            *reinterpret_cast<const uint4*>(pp + n * l.plane + r * ps + v * kVec);
    }
    consumer_sync();
  }
};

// Rows of a ResnetBlock item: at 21 nodes P of 21 × 16 × 200 bf16 (fp32: × 8
// × 196) is 135 KB (132 KB); 32 rows would need 270 KB.  Past 21 nodes
// (AMASS-MANO's 51: P of 51 × 8 × 200 bf16 is 164 KB) 8 rows, a half-empty m16
// tile; fp32 keeps 8 rows, which do not fit at 51 nodes (its plans refuse).
template <typename T>
struct BlockRows;
template <>
struct BlockRows<bf16> {
  static constexpr int kRows = nodemix::kWide ? 8 : 16;  // the mma tile's M (half of it)
};
template <>
struct BlockRows<float> {
  static constexpr int kRows = 8;
};

// Whether a launch's widths and tile plan are ones the kernels take: f a
// multiple of 64 up to kMaxF, each pass's contraction width a multiple of
// kslice (64 or 32), the type's rows, 2 to kMaxStages stages, the cluster,
// and the shared memory block_layout computes.
template <typename T>
bool block_plan_ok(int f, const int* ks, int passes, int tile_rows, int kslice, int stages,
                   int cluster, int smem_bytes) {
  if (f <= 0 || f % 64 || f > kMaxF || tile_rows != BlockRows<T>::kRows ||
      (kslice != 64 && kslice != 32) || stages < 2 || stages > kMaxStages || cluster != kCluster)
    return false;
  for (int i = 0; i < passes; ++i)
    if (ks[i] <= 0 || ks[i] % kslice) return false;
  return static_cast<size_t>(smem_bytes) ==
         block_layout<T>(tile_rows, f, kslice, stages, passes).total;
}

// Whether a pass's store of cols columns fits a launch of width f: up to f,
// in whole 16-byte chunks.
template <typename T>
constexpr bool out_cols_ok(int f, int cols) {
  return cols > 0 && cols <= f && cols % (16 / static_cast<int>(sizeof(T))) == 0;
}

// Runs every item of this block: body(item) is called by all consumer
// threads together with each item's BlockItem (product, mix, store).
// kInput: where the passes' device inputs come from (Input).
template <typename T, int R, int NT, Input kInput = Input::kWhole, typename Body>
__device__ __forceinline__ void run_blocks(const BlockProblem<T>& pb, unsigned char* smem,
                                           Body body) {
  const BlockLayout l = block_layout<T>(R, pb.f, pb.kslice, pb.stages, pb.passes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x >> 5;
  const uint32_t rank = cluster_rank();
  const int n_items = items(pb.rows, R, 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < pb.stages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the producer's expect_tx and its lanes' cp.async arrivals
      mbar_init(&empty[s], kConsumerWarps * kCluster);
    }
    *reinterpret_cast<uint4*>(smem + kZeroOffset) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* film = reinterpret_cast<float*>(smem + l.film);
  for (int c = threadIdx.x; pb.film != nullptr && c < pb.f; c += kThreads) {
    film[c] = to_f(pb.film[c]) + 1.0f;
    film[pb.f + c] = to_f(pb.film[pb.f + c]);
  }
  if constexpr (is_f32<T>()) {
    float* gmix = reinterpret_cast<float*>(smem + l.gmix);
    for (int e = threadIdx.x; e < pb.passes * kNodes * kGStride; e += kThreads) {
      const int i = e / (kNodes * kGStride), n = e / kGStride % kNodes, m = e % kGStride;
      gmix[e] = m < kNodes ? to_f(pb.g[i][n * kNodes + m]) : 0.0f;
    }
  }
  cluster_sync();  // the peer's barriers exist before anything reaches them

  if (warp == kConsumerWarps) {
    produce_blocks<T, R, kInput>(pb, l, smem, full, empty, rank, n_items);
  } else {
    RingPos q;
    for (int item = cluster_id(); item < n_items; item += cluster_count()) {
      const int b0 = (item * kCluster + static_cast<int>(rank)) * R;
      BlockItem<T, R, NT> it{pb, l, smem, full, empty, rank, q, b0, max(0, min(R, pb.rows - b0))};
      body(it);
    }
  }
  cluster_sync();  // no block leaves while its peer may still reach its memory
}

// launch(std::integral_constant<int, NT>) with the NT of width f: 0 in fp32,
// f / 64 in bf16 (1 … kMaxNt, as block_plan_ok requires).
template <typename T, typename Launch>
cudaError_t with_nt(int f, Launch launch) {
  if constexpr (is_f32<T>()) {
    return launch(std::integral_constant<int, 0>{});
  } else {
    switch (f / 64) {
      case 1: return launch(std::integral_constant<int, 1>{});
      case 2: return launch(std::integral_constant<int, 2>{});
      case 3: return launch(std::integral_constant<int, 3>{});
      case 4: return launch(std::integral_constant<int, 4>{});
      default: return cudaErrorInvalidValue;
    }
  }
}

// The launch configuration of `kernel` in clusters of `cluster` blocks of
// `Threads` threads with `smem` bytes of dynamic shared memory, and how many
// of those clusters fit on the card at once (in *clusters).
template <int Threads, typename Kernel>
cudaError_t resident_clusters(Kernel kernel, size_t smem, int cluster, cudaLaunchConfig_t& cfg,
                              cudaLaunchAttribute& attr, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.blockDim = dim3(Threads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster);
  *clusters = 0;
  err = cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  return *clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Launch `kernel` on a persistent grid of clusters of `cluster` blocks (as
// many as fit on the card at once, at most one an item) with `smem` bytes of
// dynamic shared memory and `Threads` threads a block; returns the launch's
// error.  The product-and-mix kernels run clusters of kCluster blocks of
// kThreads, the rollout (gru_rollout.cu) clusters of 4 of its own size.
template <int Threads = kThreads, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int items, size_t smem, int cluster, void* stream,
                   Args... args) {
  if (smem > static_cast<size_t>(kMaxSmem) || (cluster != kCluster && cluster != 4) || items < 1)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = resident_clusters<Threads>(kernel, smem, cluster, cfg, attr, &clusters);
  if (err != cudaSuccess) return err;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.gridDim = dim3((items < clusters ? items : clusters) * cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sm90mix
