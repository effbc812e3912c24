// Softmax attention over the skeleton's joints, feature-major, bf16 and fp32,
// for NVIDIA Hopper (sm_90a).  A lab kernel: no predictor path runs it.
//
// Replaces scripts/attn_core_lab.py::core_fm (kernel body _core_fm_kernel),
// the feature-major prototype of the attention core.  For every column b and
// head h of packed q‖k‖v [N, 3·H·dh, B] (the batch contiguous):
//
//   qs      = round(q · round(dh^-1/2))
//   s[n, m] = Σ_c qs[n, c]·k[m, c]                  fp32 sums
//   a[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m a[n, m]·v[m])               [N, H·dh, B], fp32 sums
//
// round() is to the element type.  This is B2's function (joint_attention.cu)
// on the transposed layout, computed by B2's bodies (joint_attention.cuh): in
// bf16 both products on the tensor cores, which sum the products qs·k exact
// where the Pallas kernel in interpret mode rounds each to bf16 (held to it
// at the bf16 bounds, as B2 is); in fp32 a lane a query joint.
//
// What bounds it on the H100: memory.  At N=21, B=12 800, 8 heads × 32 in
// bf16 it reads 413 MB and writes 138 MB (0.164 ms) against ~2.9 G
// multiply-adds (~20 µs of mma.sync).
//
// What the design does about it: persistent blocks, one an SM, each a
// producer warp and 8 consumer warps (16 ran 6% slower) on mbarriers, walk
// items of C batch
// columns (bf16 16, fp32 8) × one head, the column tiles of one head in a row
// (so that the blocks in flight read neighbouring columns of every row of
// q‖k‖v: all heads of few tiles at once made the kernel 1.5× slower).  A
// ring stage holds the item's q, k and v of all 21 joints in the tensor's own
// layout, [q|k|v][joint][32 features][C columns]: three TMA tiled copies (a
// 3-D tensor map over {B, 3·H·dh, 21}, box {C, 32, 21}; columns past B
// zero-filled), so every element crosses device memory once.  The consumers
// transpose the stage into B2's per-row layout in shared memory (bf16 by
// ldmatrix.trans, fp32 by float4 reads): column b's joints at a stride ≡ 16
// bytes mod 128, each q‖k‖v of 96 values, so that an ldmatrix's joints fall
// in distinct banks and the column rows of a transposing store too; release
// the stage to the producer; run one body a column (a warp a column, O
// rounded into the column's q rows); stage O as [joint][feature][column]
// (ldmatrix.trans again) and hand it to one TMA store (columns past B not
// written), which runs while the next item is worked.  A tensor map needs
// B·sizeof(T) to be a multiple of 16 bytes; at any other B the producer warp
// fills the same stages with its own loads and the consumers store O with
// theirs (a slower path, for ragged batches).  Two stages of 64.5 KB, the
// 70 KB transposed tile and O's 21 KB fit in 227 KB.
//
// The node count N is the build's (node_mix.cuh, -DSKD_NODES: 16, 17, 21,
// 51); the figures above are at 21.  The tensor map's box {C, 32, N}, the
// stages, the transposed tile and O's staging follow N.  Past 21 nodes
// (nodemix::kWide) an item takes half the columns (bf16 8, fp32 4: a box
// row of 16 bytes), the transposes take a warp per (part, joint) of 32
// features × 8 columns, and the plan takes the stages that fit (one at 51:
// a stage of 78 336 bytes, the tile 85 760, O 26 112 in bf16).
//
// At the bench shapes on an H100 (scripts/torch_attention_probe.py, PERF.md
// §6) an item takes ~7 800 cycles of the consumers: the transpose ~1 960
// (bound by shared memory: 129 KB through it, the ldmatrix reads 2-way
// conflicted), the bodies ~4 470, O's staging ~1 070; the loads alone take
// 0.17 ms of the 0.22, so the consumers' work binds.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "joint_attention.cuh"

namespace {

using sm90mix::bf16;

constexpr int kN = sm90mix::kNodes;
constexpr int kDimHead = 32;
constexpr int kMaxHeads = 32;
constexpr int kWarps = 8;                  // consumer warps a block
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// The consumers' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// batch columns an item: a row of a stage's tile is 32 bytes in both types up
// to 21 nodes; past 21 (nodemix::kWide) 16 bytes, the least a TMA box row
// may have, so that a stage, the transposed tile and O fit in one block's
// shared memory (at 51 nodes with one stage: 190 336 bytes in bf16)
template <typename T>
struct FmTile;
template <>
struct FmTile<bf16> {
  static constexpr int kCols = nodemix::kWide ? 8 : 16;
};
template <>
struct FmTile<float> {
  static constexpr int kCols = nodemix::kWide ? 4 : 8;
};

// Byte offsets of one block's shared memory (the wrapper's plan,
// ops/kernels/attention_core_fm.py::plan_bytes, computes the same total):
// the barriers and the zero row; the stages, each q, k and v of the item as
// [joint][feature][column] (one TMA box each, `part` bytes); the transposed
// tile [joint][column][q‖k‖v], each column's 96 values followed by 16 bytes
// and each joint's columns by 16 more; O of the item as [joint][feature]
// [column] (`part` bytes: the box of one TMA store).
struct FmLayout {
  size_t part, stage_bytes, t, col_bytes, joint_bytes, o, total;
};

template <typename T>
__host__ __device__ FmLayout fm_layout(int stages) {
  constexpr int C = FmTile<T>::kCols;
  FmLayout l{};
  l.part = sizeof(T) * kN * kDimHead * C;
  l.stage_bytes = 3 * l.part;
  l.col_bytes = sizeof(T) * 3 * kDimHead + 16;
  l.joint_bytes = C * l.col_bytes + 16;
  l.t = 128 + stages * l.stage_bytes;  // full[kMaxStages], empty[kMaxStages], the zero row
  l.o = l.t + sm90mix::up(kN * l.joint_bytes);
  l.total = l.o + l.part;
  return l;
}

// box {c0 …, c1 …, c2 …} of the tensor map into this block's shared memory,
// completing on `bar`; elements past the tensor's bounds are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(sm90mix::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(sm90mix::smem_u32(bar))
      : "memory");
}

// The box {c0 …, c1 …, c2 …} of the tensor map from this block's shared
// memory (bulk async-group); elements past the tensor's bounds are not
// written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90mix::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until this thread's bulk stores have read their shared memory
// (kRead) or completed.
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The producer warp's own fill of a stage (a B whose rows a tensor map
// cannot address): element e of the stage, (part·N + joint)·32 + feature
// rows of C columns, from q‖k‖v, zeros past the last column; 16 loads of a
// lane in flight.
template <typename T, int C>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ qkv, int rows, int hd,
                                           int b0, int h) {
  constexpr int kElems = 3 * kN * kDimHead * C;
  constexpr int kBatch = 16;
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < kElems; e0 += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + 32 * i + lane, col = e % C, row = e / C;
      const int f = row % kDimHead, pj = row / kDimHead, part = pj / kN, j = pj % kN;
      v[i] = nodemix::from_f<T>(0.0f);
      if (e < kElems && b0 + col < rows)
        v[i] = qkv[static_cast<size_t>(j * 3 * hd + part * hd + h * kDimHead + f) * rows + b0 +
                   col];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (e0 + 32 * i + lane < kElems) st[e0 + 32 * i + lane] = v[i];
  }
}

// The stage → the transposed tile tt (column stride cs, joint stride ld, in
// elements), by the consumer warps.  bf16: a warp takes 16 features × 16
// columns of one (part, joint) with one ldmatrix.x4.trans (four 8 × 8
// matrices, features × columns) and writes each lane's two adjacent
// features of one column as 4 bytes.  fp32: a lane a feature, four columns a
// float4.
template <typename T, int C>
__device__ __forceinline__ void transpose_stage(const unsigned char* st, T* tt, int cs, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<T, bf16> && C == 16) {
    const int mi = lane >> 3;  // the matrix whose row this lane addresses
#pragma unroll 4
    for (int u = warp; u < 3 * kN * 2; u += kWarps) {
      const int half = u & 1, pj = u >> 1, part = pj / kN, j = pj % kN;
      const int f = 16 * half + 8 * (mi >> 1) + (lane & 7);
      uint32_t v[4];
      sm90mix::ldmatrix_x4_trans(v, sm90mix::smem_u32(st) +
                                        sizeof(T) * ((pj * kDimHead + f) * C + 8 * (mi & 1)));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int col = 8 * (m & 1) + (lane >> 2);
        const int ff = part * kDimHead + 16 * half + 8 * (m >> 1) + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(tt + j * ld + col * cs + ff) = v[m];
      }
    }
  } else if constexpr (std::is_same_v<T, bf16>) {
    // past 21 nodes: a warp takes the 32 features × 8 columns of one (part,
    // joint), matrix m features 8m …; lane l addresses feature l
    static_assert(C == 8, "a warp's matrices: 32 features × 8 columns");
#pragma unroll 4
    for (int pj = warp; pj < 3 * kN; pj += kWarps) {
      const int part = pj / kN, j = pj % kN;
      uint32_t v[4];
      sm90mix::ldmatrix_x4_trans(v, sm90mix::smem_u32(st) + sizeof(T) * (pj * kDimHead + lane) * C);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ff = part * kDimHead + 8 * m + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(tt + j * ld + (lane >> 2) * cs + ff) = v[m];
      }
    }
  } else {
    const float* sf = reinterpret_cast<const float*>(st);
#pragma unroll 4
    for (int u = warp; u < 3 * kN * (C / 4); u += kWarps) {
      const int quad = u % (C / 4), pj = u / (C / 4), part = pj / kN, j = pj % kN;
      const float4 v =
          *reinterpret_cast<const float4*>(sf + (pj * kDimHead + lane) * C + 4 * quad);
      float* d = tt + j * ld + 4 * quad * cs + part * kDimHead + lane;
      d[0] = v.x;
      d[cs] = v.y;
      d[2 * cs] = v.z;
      d[3 * cs] = v.w;
    }
  }
}

// O of the item (each column's q rows of tt) → os [joint][feature][column],
// the box of a TMA store, by the consumer warps.  bf16: a warp takes 16
// features × 16 columns of one joint with one ldmatrix.x4.trans (four 8 × 8
// matrices, columns × features) and writes each lane's two adjacent columns
// of one feature as 4 bytes.  fp32: a lane a feature, four columns a float4.
template <typename T, int C>
__device__ __forceinline__ void stage_o(const T* tt, T* os, int cs, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<T, bf16> && C == 16) {
    const int mi = lane >> 3;
#pragma unroll 2
    for (int u = warp; u < kN * 2; u += kWarps) {
      const int half = u & 1, j = u >> 1;
      const int col = 8 * (mi & 1) + (lane & 7);
      uint32_t v[4];
      sm90mix::ldmatrix_x4_trans(
          v, sm90mix::smem_u32(tt + j * ld + col * cs + 16 * half + 8 * (mi >> 1)));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int f = 16 * half + 8 * (m >> 1) + (lane >> 2);
        *reinterpret_cast<uint32_t*>(os + (j * kDimHead + f) * C + 8 * (m & 1) + 2 * (lane & 3)) =
            v[m];
      }
    }
  } else if constexpr (std::is_same_v<T, bf16>) {
    // past 21 nodes: a warp a joint, 8 columns × 32 features (matrix m
    // features 8m …); lane l addresses column l % 8 of matrix l / 8
#pragma unroll 2
    for (int j = warp; j < kN; j += kWarps) {
      uint32_t v[4];
      sm90mix::ldmatrix_x4_trans(
          v, sm90mix::smem_u32(tt + j * ld + (lane & 7) * cs + 8 * (lane >> 3)));
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<uint32_t*>(os + (j * kDimHead + 8 * m + (lane >> 2)) * C +
                                     2 * (lane & 3)) = v[m];
    }
  } else {
#pragma unroll 2
    for (int u = warp; u < kN * (C / 4); u += kWarps) {
      const int quad = u % (C / 4), j = u / (C / 4);
      const float* src = tt + j * ld + 4 * quad * cs + lane;
      *reinterpret_cast<float4*>(os + (j * kDimHead + lane) * C + 4 * quad) =
          make_float4(src[0], src[cs], src[2 * cs], src[3 * cs]);
    }
  }
}

// O of the item (each column's q rows of tt) → out [N, hd, rows], columns
// < valid; consecutive threads on consecutive columns of a (joint, feature):
// the store of a batch a tensor map cannot address.
template <typename T, int C>
__device__ __forceinline__ void store_item(const T* tt, T* __restrict__ out, int rows, int hd,
                                           int b0, int h, int valid, int cs, int ld) {
  for (int e = threadIdx.x; e < kN * kDimHead * C; e += kConsumers) {
    const int col = e % C, f = e / C % kDimHead, j = e / (C * kDimHead);
    if (col < valid)
      out[static_cast<size_t>(j * hd + h * kDimHead + f) * rows + b0 + col] =
          tt[j * ld + col * cs + f];
  }
}

// Item `item`'s first column b0 and head h, of n_items = column tiles ×
// heads: the column tiles of one head in a row, so that the blocks in flight
// read neighbouring columns of each row of q‖k‖v.
__device__ __forceinline__ void item_at(int item, int n_items, int heads, int cols, int& b0,
                                        int& h) {
  const int tiles = n_items / heads;
  b0 = item % tiles * cols;
  h = item / tiles;
}

// maps: q‖k‖v and out (used when tma is set: B a multiple of 16 bytes).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attention_core_fm_kernel(__grid_constant__ const CUtensorMap in_map,
                         __grid_constant__ const CUtensorMap out_map, const T* __restrict__ qkv,
                         T* __restrict__ out, int rows, int heads, int stages, int tma,
                         float scale) {
  using namespace sm90mix;
  constexpr int C = FmTile<T>::kCols;
  extern __shared__ __align__(128) unsigned char smem[];
  const FmLayout l = fm_layout<T>(stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = heads * kDimHead;
  const int n_items = (rows + C - 1) / C * heads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);  // the producer's expect_tx, or its lanes' arrivals
      mbar_init(&empty[s], kWarps);
    }
    *reinterpret_cast<uint4*>(smem + kZeroOffset) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    RingPos q;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, q.advance(stages)) {
      int b0, h;
      item_at(item, n_items, heads, C, b0, h);
      unsigned char* st = smem + 128 + static_cast<size_t>(q.s) * l.stage_bytes;
      if (tma) {
        if (lane == 0) {
          mbar_wait(&empty[q.s], q.phase ^ 1u);  // every consumer warp has read the stage
          mbar_expect_tx(&full[q.s], static_cast<uint32_t>(l.stage_bytes));
          for (int part = 0; part < 3; ++part)
            tma_load_3d(st + part * l.part, &in_map, b0, part * hd + h * kDimHead, 0, &full[q.s]);
        }
      } else {
        mbar_wait(&empty[q.s], q.phase ^ 1u);
        load_stage<T, C>(reinterpret_cast<T*>(st), qkv, rows, hd, b0, h);
        mbar_arrive(&full[q.s]);  // this lane's stores before the consumers' reads
      }
    }
    __syncwarp();
  } else {
    T* tt = reinterpret_cast<T*>(smem + l.t);
    T* os = reinterpret_cast<T*>(smem + l.o);
    const int cs = static_cast<int>(l.col_bytes / sizeof(T));    // elements between columns
    const int ld = static_cast<int>(l.joint_bytes / sizeof(T));  // and between joints
    RingPos q;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, q.advance(stages)) {
      int b0, h;
      item_at(item, n_items, heads, C, b0, h);
      const int valid = min(C, rows - b0);
      mbar_wait(&full[q.s], q.phase);
      transpose_stage<T, C>(smem + 128 + static_cast<size_t>(q.s) * l.stage_bytes, tt, cs, ld);
      consumers_sync();
      if (lane == 0) mbar_arrive(&empty[q.s]);  // the stage may be refilled
      for (int col = warp; col < valid; col += kWarps) {
        T* base = tt + col * cs;
        if constexpr (nodemix::kTensorCoreBody<T>) {
          nodemix::head_attention_mma_smem(base, base + kDimHead, base + 2 * kDimHead, ld, scale,
                                           smem + kZeroOffset);
        } else {  // lane n writes O of joint n over its own q row, read by it alone
          nodemix::head_attention<T, kN, kDimHead>(base, base + kDimHead, base + 2 * kDimHead,
                                                   ld, scale, base, ld);
        }
      }
      if (tma) {
        if (threadIdx.x == 0) tma_store_wait<true>();  // the last item's store has read os
        consumers_sync();
        stage_o<T, C>(tt, os, cs, ld);
        fence_proxy_async();  // os's writes before the bulk store reads them
        consumers_sync();
        if (threadIdx.x == 0) tma_store_3d(&out_map, os, b0, h * kDimHead, 0);
      } else {
        consumers_sync();
        store_item<T, C>(tt, out, rows, hd, b0, h, valid, cs, ld);
        consumers_sync();  // tt is read before the next item's transpose
      }
    }
    if (threadIdx.x == 0) tma_store_wait<false>();  // the last store has landed
  }
}

// The tensor map of a feature-major [N, width, rows] tensor for boxes
// {C, 32, N}: the stage's q, k or v, or an item's O.
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const void* base, int rows, int width,
                       CUtensorMapL2promotion promotion) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(kN)};
  const cuuint64_t strides[2] = {sizeof(T) * rows,
                                 sizeof(T) * rows * static_cast<cuuint64_t>(width)};
  const cuuint32_t box[3] = {FmTile<T>::kCols, kDimHead, kN};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res =
      encode(map, std::is_same_v<T, bf16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, promotion,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wrapper's plan (columns an item, stages, shared-memory bytes) must be
// the one instantiated here: the type's columns, 1 to kMaxStages stages and
// the shared memory fm_layout computes.
template <typename T>
int launch(const void* qkv, void* out, int n_nodes, int rows, int heads, int dim_head, int cols,
           int stages, int smem_bytes, void* stream) {
  using namespace sm90mix;
  if (n_nodes != kN || dim_head != kDimHead || rows <= 0 || heads <= 0 || heads > kMaxHeads ||
      cols != FmTile<T>::kCols || stages < 1 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const FmLayout l = fm_layout<T>(stages);
  if (static_cast<size_t>(smem_bytes) != l.total || l.total > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // a tensor map wants its strides in multiples of 16 bytes; the box may not
  // exceed the batch
  const bool tma = (sizeof(T) * rows) % 16 == 0 && rows >= cols &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap in_map{}, out_map{};
  cudaError_t err = cudaSuccess;
  if (tma) {
    err = encode_map<T>(&in_map, qkv, rows, 3 * heads * kDimHead,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    if (err == cudaSuccess)
      err = encode_map<T>(&out_map, out, rows, heads * kDimHead, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = attention_core_fm_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int items = (rows + cols - 1) / cols * heads;
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      in_map, out_map, static_cast<const T*>(qkv), static_cast<T*>(out), rows, heads, stages,
      tma ? 1 : 0,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDimHead))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [n_nodes, 3·heads·dim_head, rows] (q‖k‖v, heads major within each),
// out [n_nodes, heads·dim_head, rows]; contiguous, 16-byte aligned; the plan
// (ops/kernels/attention_core_fm.py::fm_plan).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes and plans not
// instantiated.
extern "C" int attention_core_fm_bf16(const void* qkv, void* out, int n_nodes, int rows,
                                      int heads, int dim_head, int cols, int stages,
                                      int smem_bytes, void* stream) {
  return launch<bf16>(qkv, out, n_nodes, rows, heads, dim_head, cols, stages, smem_bytes, stream);
}
extern "C" int attention_core_fm_f32(const void* qkv, void* out, int n_nodes, int rows,
                                     int heads, int dim_head, int cols, int stages,
                                     int smem_bytes, void* stream) {
  return launch<float>(qkv, out, n_nodes, rows, heads, dim_head, cols, stages, smem_bytes,
                       stream);
}
