// Shared device routines of the fused denoiser's stem kernel B4
// (graph_linear_fused.cu) for NVIDIA Hopper (sm_90a); every other kernel of
// the denoiser runs on node_mix_sm90.cuh, which takes its element
// conversions (to_f, from_f) from here.
//
// B4 computes this pattern on node-major activations [N, B, F] (element
// (n, b, f) at (n·B + b)·F + f):
//
//   P[n]   = round(X[n]·W[n] + bias[n] (+ u[n]))    per-node product, fp32 sums
//   Y[n]   = Σ_m G[n, m]·P[m]                        the N×N influence mix
//   out    = epilogue(Y)                             round(Y) into out
//
// The mix couples the N nodes of one row, never two rows, so a block owns a
// tile of kRows rows for all N nodes and needs nothing from another block.
// P lives in shared memory in the element type T (the Pallas kernels keep it
// in their h_scr scratch in the compute dtype): N × kRows × width elements.
//
// * node_products: for each node, the block stages that node's kRows input
//   rows in shared memory, then each warp computes 16-column tiles of
//   the product, with bf16 tensor cores (nvcuda::wmma 16×16×16, fp32
//   accumulators) for T = bf16 and with fp32 FMAs (8×16 tiles) for T = float.
//   The weight tiles are read straight from device memory (L2-resident).
// * node_mix: one thread per (row, column) of the tile reads the N values of
//   its column, forms all N mixed outputs in fp32 with G from shared memory
//   (rows padded to 24 floats, read as float4 broadcasts) and hands each to
//   the epilogue.  A thread reads its whole column before writing, so an
//   epilogue may write its result back into P in place.
//
// The fp32 instantiation runs the same tiling, staging and indexing as the
// bf16 one; it exists so that the indexing can be checked against the plain
// PyTorch version at a tolerance that bf16 rounding would hide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace nodemix {

using bf16 = __nv_bfloat16;

constexpr int kNodes = 21;           // the AMASS skeleton without its hip
constexpr int kGStride = 24;         // G rows padded to whole float4s
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// Blocks hold 160–215 KB of shared memory, so one block runs on an SM, and
// its 16 warps may take all of the SM's registers (128 a thread).
constexpr int kMinBlocks = 1;
// Nodes staged and multiplied together: fewer barriers, and 4 × 12 column
// tiles of F = 192 keep all 16 warps busy.
constexpr int kGroup = 4;
constexpr int kMaxSmem = 232448;     // 227 KB of dynamic shared memory a block

template <typename T>
struct RowTile;
template <>
struct RowTile<bf16> {
  static constexpr int kRows = 16;   // the wmma tile's M
};
template <>
struct RowTile<float> {
  static constexpr int kRows = 8;    // half the rows: fp32 P takes twice the bytes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and widened back: where the Pallas kernel materialises in
// its compute dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Shared memory of one block, carved in 128-byte aligned pieces:
// p [N][kRows][pw] T, s [kGroup][kRows][kmax] T (the staging buffer),
// scratch [kWarps][kRows·16] float, g [ng][N][kGStride] float, vec [nvec] float.
template <typename T>
struct Smem {
  T* p;
  T* s;
  float* scratch;
  float* g;
  float* vec;

  __host__ __device__ static size_t up(size_t bytes) { return (bytes + 127) & ~size_t(127); }

  __host__ __device__ static size_t bytes(int pw, int kmax, int ng, int nvec) {
    constexpr int R = RowTile<T>::kRows;
    return up(sizeof(T) * kNodes * R * pw) + up(sizeof(T) * kGroup * R * kmax) +
           up(sizeof(float) * kWarps * R * 16) + up(sizeof(float) * ng * kNodes * kGStride) +
           up(sizeof(float) * nvec);
  }

  __device__ static Smem carve(unsigned char* base, int pw, int kmax, int ng) {
    constexpr int R = RowTile<T>::kRows;
    Smem m;
    size_t off = 0;
    m.p = reinterpret_cast<T*>(base + off);
    off += up(sizeof(T) * kNodes * R * pw);
    m.s = reinterpret_cast<T*>(base + off);
    off += up(sizeof(T) * kGroup * R * kmax);
    m.scratch = reinterpret_cast<float*>(base + off);
    off += up(sizeof(float) * kWarps * R * 16);
    m.g = reinterpret_cast<float*>(base + off);
    off += up(sizeof(float) * ng * kNodes * kGStride);
    m.vec = reinterpret_cast<float*>(base + off);
    return m;
  }
};

// G [N, N] in T → g_s [N][kGStride] float, zero padding columns.
template <typename T>
__device__ void load_influence(float* g_s, const T* g) {
  for (int i = threadIdx.x; i < kNodes * kGStride; i += kThreads) {
    const int n = i / kGStride, m = i % kGStride;
    g_s[i] = m < kNodes ? to_f(g[n * kNodes + m]) : 0.0f;
  }
}

// s[r][0 : k] = src[r·k : (r+1)·k] for r < valid, zeros for the ragged
// rows; 16-byte copies by the whole block.  k·sizeof(T) % 16 == 0.
template <typename T>
__device__ void stage_rows(T* s, const T* src, int k, int valid) {
  constexpr int R = RowTile<T>::kRows;
  const int vecs = static_cast<int>(k * sizeof(T) / 16);
  for (int i = threadIdx.x; i < R * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * k) + v);
    reinterpret_cast<uint4*>(s + r * k)[v] = val;
  }
}

// One warp: c[16][16] = a[16][k] · b[k][16], bf16 operands on the tensor
// cores, fp32 sums; k a multiple of 32.  a in shared memory (row stride
// lda, 32-byte aligned, lda a multiple of 16); b in device memory (row
// stride ldb, 16-byte aligned, ldb a multiple of 8).  The weight rows come
// in 32 at a time with coalesced 16-byte loads (two a lane), the next 32
// loaded while the current are multiplied, and pass through the warp's c
// buffer in shared memory: tensor-core fragment loads straight from device
// memory would split into many small scattered loads.
__device__ __forceinline__ void warp_tile_product(const bf16* a, int lda, const bf16* b, int ldb,
                                                  int k, float* c) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
  bf16* bs = reinterpret_cast<bf16*>(c);  // [32][16]: two k-steps of the weight tile
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa0, fa1;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb0, fb1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  // this lane's pieces: rows lane/2 and 16 + lane/2, columns (lane%2)·8 …+8
  const bf16* bl = b + static_cast<size_t>(lane >> 1) * ldb + (lane & 1) * 8;
  uint4 r0 = __ldg(reinterpret_cast<const uint4*>(bl));
  uint4 r1 = __ldg(reinterpret_cast<const uint4*>(bl + static_cast<size_t>(16) * ldb));
  for (int k0 = 0; k0 < k; k0 += 32) {
    reinterpret_cast<uint4*>(bs)[lane] = r0;
    reinterpret_cast<uint4*>(bs)[32 + lane] = r1;
    __syncwarp();
    if (k0 + 32 < k) {
      r0 = __ldg(reinterpret_cast<const uint4*>(bl + static_cast<size_t>(k0 + 32) * ldb));
      r1 = __ldg(reinterpret_cast<const uint4*>(bl + static_cast<size_t>(k0 + 48) * ldb));
    }
    wmma::load_matrix_sync(fb0, bs, 16);
    wmma::load_matrix_sync(fb1, bs + 256, 16);
    wmma::load_matrix_sync(fa0, a + k0, static_cast<unsigned>(lda));
    wmma::load_matrix_sync(fa1, a + k0 + 16, static_cast<unsigned>(lda));
    wmma::mma_sync(acc, fa0, fb0, acc);
    wmma::mma_sync(acc, fa1, fb1, acc);
    __syncwarp();
  }
  wmma::store_matrix_sync(c, acc, 16, wmma::mem_row_major);
}

// One warp: c[8][16] = a[8][k] · b[k][16] in fp32 FMAs; a lane owns one row
// and four adjacent columns.
__device__ __forceinline__ void warp_tile_product(const float* a, int lda, const float* b, int ldb,
                                                  int k, float* c) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c0 = (lane & 3) * 4;
  const float* ar = a + r * lda;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int kk = 0; kk < k; ++kk) {
    const float av = ar[kk];
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + static_cast<size_t>(kk) * ldb + c0));
    acc.x = fmaf(av, bv.x, acc.x);
    acc.y = fmaf(av, bv.y, acc.y);
    acc.z = fmaf(av, bv.z, acc.z);
    acc.w = fmaf(av, bv.w, acc.w);
  }
  *reinterpret_cast<float4*>(c + r * 16 + c0) = acc;
}

// For each group of kGroup nodes: stage(n, buf) fills buf [kRows][k] with
// node n's input rows, for every node of the group into s
// [kGroup][kRows][k]; then the warps compute the fc columns of each node's rows ·
// w[n] (w[n] is [k][ldw], already offset to the first column of this chunk)
// 16 at a time and hand every sum to store(n, row, column, value).  Ends
// with the block synchronised.
template <typename T, typename Stage, typename Store>
__device__ void node_products(Stage stage, T* s, int k, const T* w, int ldw, int fc,
                              float* scratch, Store store) {
  constexpr int R = RowTile<T>::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = fc / 16;
  float* c = scratch + warp * R * 16;
  for (int n0 = 0; n0 < kNodes; n0 += kGroup) {
    const int group = min(kGroup, kNodes - n0);
    for (int j = 0; j < group; ++j) stage(n0 + j, s + j * R * k);
    __syncthreads();
    for (int task = warp; task < group * tiles; task += kWarps) {
      const int j = task / tiles, tile = task % tiles;
      const T* wn = w + static_cast<size_t>(n0 + j) * k * ldw;
      warp_tile_product(s + j * R * k, k, wn + tile * 16, ldw, k, c);
      __syncwarp();
      for (int e = lane; e < R * 16; e += 32) store(n0 + j, e >> 4, tile * 16 + (e & 15), c[e]);
      __syncwarp();
    }
    __syncthreads();
  }
}

// For every (row r, column c < fc) of the tile: y[n] = Σ_m G[n,m]·p[m][r][c]
// in fp32, handed to epi(n, r, c, y).  Ends with the block synchronised.
template <typename T, typename Epi>
__device__ void node_mix(const T* p, int ldp, int fc, const float* g, Epi epi) {
  constexpr int R = RowTile<T>::kRows;
  for (int i = threadIdx.x; i < R * fc; i += kThreads) {
    const int r = i / fc, c = i % fc;
    float v[kGStride];
#pragma unroll
    for (int m = 0; m < kNodes; ++m) v[m] = to_f(p[static_cast<size_t>(m * R + r) * ldp + c]);
#pragma unroll
    for (int m = kNodes; m < kGStride; ++m) v[m] = 0.0f;
    // not unrolled: unrolled, the compiler hoists all 21 rows of G out of
    // the column loop into registers and spills them
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
      epi(n, r, c, y);
    }
  }
  __syncthreads();
}

// Offset of (node n, row b, column c) in a node-major [N, rows, width] tensor.
__device__ __forceinline__ size_t at(int n, int rows, int b, int width, int c) {
  return (static_cast<size_t>(n) * rows + b) * width + c;
}

// Opt a kernel into `bytes` of dynamic shared memory and check the launch
// fits; returns cudaSuccess or the error to report.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int grid_for(int rows) {
  return (rows + RowTile<T>::kRows - 1) / RowTile<T>::kRows;
}

}  // namespace nodemix
