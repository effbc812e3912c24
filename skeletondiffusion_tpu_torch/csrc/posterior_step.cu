// Reverse-diffusion posterior step, x̂₀ in float32 or bf16, for NVIDIA Hopper
// (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/posterior_step.py:93
// (posterior_step_pallas, kernel body _posterior_kernel :39).  Over node-major
// latents [N, B, D], viewed as [N, C] with C = B·D columns, it computes
//
//   out[n, c] = Σ_m M[n, m]·clip(x0[m, c], -1, 1) + M[n, N+m]·xt[m, c]
//                     + M[n, 2N+m]·eps[m, c]
//
// with M = [P1_t | P2_t | U·diag(σ_t)] the [N, 3N] table of one step: one
// contraction out = M·X of width 3N over X = [x_t; ε; clip(x̂₀)].
//
// What bounds it on the H100: memory, once the products leave the CUDA
// cores.  At AMASS-MANO's 51 nodes and B·D = 12 800·96 it moves 1 003 MB
// (877 MB with a bf16 x̂₀), 0.2993 ms (0.2619) at 3.35 TB/s, against 19.2
// GFLOP: 0.2862 ms of the CUDA cores' 67 TFLOP/s, but 0.116 ms of the
// tensor cores' 495 TFLOP/s in TF32 at three products a term.  The design
// it replaces (a thread per 2 or 4 columns, N accumulators each, M read from
// shared memory a weight at a time) issued one shared load per 2 FMAs past
// 32 nodes and took 0.82–0.89 ms there.  Here the 51-node step is bound by
// the warps' issue: a few instructions (the operands' splits, their loads)
// a tensor-core instruction, and 8 warps an SM, as many as fit its stages
// (PERF.md §5).
//
// What the design does about it:
//
// * The products run on the tensor cores: mma.sync m16n8k8 TF32, with X's
//   columns as the A operand (16 columns an m tile) and M as the B operand
//   (8 nodes an n tile), so the output's nodes pad to 8 (51 → 56), not 16.
//   3×TF32 keeps fp32 accuracy: each operand v is split into hi = tf32(v)
//   and lo = tf32(v − hi) (round to nearest, by two integer instructions:
//   ptxas emulates cvt.rna.tf32.f32 in several), and a term sums a_hi·b_lo +
//   a_lo·b_hi into one fp32 sum and a_hi·b_hi into another, added at the
//   end: the tensor cores truncate as they accumulate, and the large sum
//   then takes a third of the truncations.  Single-pass TF32 keeps ~3
//   digits.  A bf16 x̂₀ is exact in TF32: its k-steps take no
//   a_lo·b_hi.  The clip is applied to x̂₀ as its fragment is read.
// * The contraction runs over each input's first 8·⌊N/8⌋ rows in whole
//   k-steps (x_t's, ε's, x̂₀'s: the clip and the bf16 read are decided per
//   k-step at compile time), then over the three inputs' N mod 8 remaining
//   rows packed together (kstep_mixed): K = 160 at 51 nodes, 56 at 17, 64
//   at 21, 48 at 16.
// * Persistent blocks, one an SM, of `warps` warps; warp g of the grid takes
//   the 32-column tiles g, g + G, … (G warps in all) through its own ring of
//   `stages` stages, so no warp waits on another.  A stage holds a tile of
//   x_t, ε and x̂₀: one TMA 2-D copy per input (box {32 columns, N rows};
//   columns past C are zero-filled), each input's rows on a 1 024-byte
//   boundary, 128-byte swizzled for fp32 and 64-byte for bf16, which with
//   the column order below makes every A-fragment read free of bank
//   conflicts.  A warp refills a stage as soon as its products are done,
//   before it stores the tile's output.
// * M is read from device memory and split once a block, into shared
//   memory as the B fragments ([k-step][n tile][lane] uint4: both values'
//   hi, both lo; zeros past N): one 16-byte load a fragment.
// * The 16 rows of an m tile are the tile's columns in the order
//   4·(2·mt + h + 4·(r / 4)) + r % 4 for row 8·h + r: the 8 rows of an A
//   register cover two 16-byte chunks 64 bytes apart, in distinct banks
//   under the swizzle.  The output is stored from the accumulators (4-byte
//   stores, 16-byte runs of a row), masked past N and C.
// * Up to 32 nodes every k-step is unrolled (the loads of the next step
//   overlap the products); at 51 two are (all of them overflow the
//   instruction cache).  The plans (up to 32 nodes 4 warps × 2 stages, past
//   it one stage a warp and as many warps as fit: 7 with an fp32 x̂₀, 8 with
//   a bf16 one) were swept on the card (scripts/torch_posterior_plans.py).
//
// A second design runs the same function on the CUDA cores
// (posterior_step_fma_*: a thread per 4 columns, 2 past 32 nodes, M read as
// float4 over 4 k, one shared load per 8 FMAs past 32 nodes, per 16 below).
// It is built beside the first as the check on what binds the step (PERF.md
// §5): no wrapper launches it.
//
// N is the build's node count (node_mix.cuh, -DSKD_NODES: 16 for H36M, 17
// for FreeMan, 21 for AMASS, 51 for AMASS-MANO); the library refuses every
// other count.  The wrapper's plan (ops/kernels/posterior_step.py::
// posterior_plan) gives the warps, the stages and the shared memory.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "node_mix_sm90.cuh"

namespace {

using nodemix::bf16;
using sm90mix::mbar_expect_tx;
using sm90mix::mbar_init;
using sm90mix::mbar_wait;
using sm90mix::smem_u32;

constexpr int kN = nodemix::kNodes;

// ---- the tensor-core design ------------------------------------------------

constexpr int kNp = (kN + 7) / 8 * 8;  // an input's rows in a stage, the output's padded nodes
constexpr int kNt = kNp / 8;           // n tiles of the output
constexpr int kFull = kN / 8;          // k-steps of an input's first 8·kFull rows
constexpr int kRem = kN % 8;           // an input's rows past them
constexpr int kMix = (3 * kRem + 7) / 8;  // k-steps of the three inputs' remaining rows
constexpr int kKSteps = 3 * kFull + kMix;
constexpr int kFullDiv = kFull > 0 ? kFull : 1, kRemDiv = kRem > 0 ? kRem : 1;  // divisors
constexpr int kCols = 32;              // columns of a tile: a 128-byte fp32 row of a box
constexpr int kRowBytes = 4 * kCols;
constexpr int kUnroll = kN > 32 ? 2 : 8;  // k-steps unrolled: all of them up to 32 nodes
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 4;  // a warp's
constexpr size_t kMBytes = static_cast<size_t>(kKSteps) * kNt * 32 * sizeof(uint4);

// A stage: a tile's x_t rows, ε's, then x̂₀'s (kNp rows each, the copies
// write N), rounded to the 128-byte swizzle's 1 024-byte atom (x̂₀'s rows
// start on one too).
template <typename X0>
__host__ __device__ constexpr uint32_t stage_tx() {
  return 2 * kN * kRowBytes + kN * kCols * static_cast<uint32_t>(sizeof(X0));
}
template <typename X0>
__host__ __device__ constexpr size_t stage_bytes() {
  return (2 * kNp * kRowBytes + kNp * kCols * sizeof(X0) + 1023) / 1024 * 1024;
}

// The shared memory of a block: 1 024 bytes to align the ring, the ring,
// M's fragments, a barrier a stage.
template <typename X0>
__host__ __device__ constexpr size_t smem_total(int warps, int stages) {
  return 1024 + static_cast<size_t>(warps) * stages * stage_bytes<X0>() + kMBytes +
         8 * static_cast<size_t>(warps) * stages;
}

// v rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding, which ptxas emulates with checks for values the step never
// sees): half of the 13 dropped bits' range added to the magnitude, then
// masked off.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float clip1(float v) { return fminf(fmaxf(v, -1.0f), 1.0f); }

// d += a·b, m16n8k8, TF32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Box {c0 …, c1 …} of the tensor map into this block's shared memory,
// completing on `bar`; elements past the tensor's bounds are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One k-step of the tile's two m tiles against every n tile: the A
// fragments `xh`/`xl` (X's hi and lo; kLow false: no lo), M's fragments at
// `mf` (this k-step's, this lane's).  The small terms go to their own sums
// `lo`, the large ones to `hi`.
template <bool kLow>
__device__ __forceinline__ void kstep(const uint32_t (&xh)[2][4], const uint32_t (&xl)[2][4],
                                      const uint4* mf, float (&hi)[2][kNt][4],
                                      float (&lo)[2][kNt][4]) {
  uint32_t bh[kNt][2], bl[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const uint4 v = mf[nt * 32];
    bh[nt][0] = v.x;
    bh[nt][1] = v.y;
    bl[nt][0] = v.z;
    bl[nt][1] = v.w;
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(lo[mt][nt], xh[mt], bl[nt][0], bl[nt][1]);
  if constexpr (kLow) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(lo[mt][nt], xl[mt], bh[nt][0], bh[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(hi[mt][nt], xh[mt], bh[nt][0], bh[nt][1]);
}

// An fp32 k-step: X's 8 rows at `rows` (128-byte swizzled), clipped if kClip.
template <bool kClip>
__device__ __forceinline__ void kstep_f32(const unsigned char* rows, const uint32_t (&off)[2][4],
                                          const uint4* mf, float (&hi)[2][kNt][4],
                                          float (&lo)[2][kNt][4]) {
  uint32_t xh[2][4], xl[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = *reinterpret_cast<const float*>(rows + off[mt][j]);
      if constexpr (kClip) v = clip1(v);
      xh[mt][j] = tf32(v);
      xl[mt][j] = tf32(v - __uint_as_float(xh[mt][j]));
    }
  kstep<true>(xh, xl, mf, hi, lo);
}

// A bf16 x̂₀ k-step (64-byte swizzled rows): clipped bf16 values are TF32.
__device__ __forceinline__ void kstep_bf16(const unsigned char* rows, const uint32_t (&off)[2][4],
                                           const uint4* mf, float (&hi)[2][kNt][4],
                                           float (&lo)[2][kNt][4]) {
  uint32_t xh[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = *reinterpret_cast<const uint16_t*>(rows + off[mt][j]);
      xh[mt][j] = __float_as_uint(clip1(__uint_as_float(u << 16)));
    }
  kstep<false>(xh, xh, mf, hi, lo);
}

// A k-step of the rows past each input's full k-steps: slot ρ = 8·i + k
// (k = q, q + 4) holds row 8·kFull + ρ % kRem of input ρ / kRem (x_t, ε,
// x̂₀), a slot past 3·kRem x_t's row 0 at weight zero.
template <typename X0>
__device__ __forceinline__ void kstep_mixed(const unsigned char* st, int i, int q, int r,
                                            const uint4* mf, float (&hi)[2][kNt][4],
                                            float (&lo)[2][kNt][4]) {
  uint32_t xh[2][4], xl[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int rho = 8 * i + q + 4 * kk;
    const bool real = rho < 3 * kRem;
    const int input = real ? rho / kRemDiv : 0, row = real ? 8 * kFull + rho % kRemDiv : 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int chunk = 2 * mt + h + 4 * (r >> 2);
        float v;
        if (!std::is_same_v<X0, float> && input == 2) {
          const unsigned char* p = st + 2 * kNp * kRowBytes + row * 64 +
                                   (((chunk >> 1) ^ ((row >> 1) & 3)) << 4) + 2 * (4 * h + (r & 3));
          v = __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
        } else {
          v = *reinterpret_cast<const float*>(st + (input * kNp + row) * kRowBytes +
                                              ((chunk ^ (row & 7)) << 4) + 4 * (r & 3));
        }
        if (input == 2) v = clip1(v);
        const int j = h + 2 * kk;
        xh[mt][j] = tf32(v);
        xl[mt][j] = tf32(v - __uint_as_float(xh[mt][j]));
      }
  }
  kstep<true>(xh, xl, mf, hi, lo);
}

// maps: x_t, ε (fp32) and x̂₀ (X0), each [N, cols] with boxes {kCols, N}.
template <typename X0>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
posterior_step_tc(const __grid_constant__ CUtensorMap xt_map,
                  const __grid_constant__ CUtensorMap eps_map,
                  const __grid_constant__ CUtensorMap x0_map, const float* __restrict__ m,
                  float* __restrict__ out, int cols, int stages) {
  constexpr bool kF32 = std::is_same_v<X0, float>;
  constexpr size_t kStage = stage_bytes<X0>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* mf = reinterpret_cast<uint4*>(ring + static_cast<size_t>(warps) * stages * kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(mf) + kMBytes);

  // M's B fragments: k-step ks, n tile nt, lane l holds M[n][·] of the
  // contraction's slots k = l % 4 and l % 4 + 4 for n = 8·nt + l / 4: x_t's,
  // ε's, x̂₀'s full k-steps, then the mixed ones (kstep_mixed); zeros past N
  for (int i = threadIdx.x; i < kKSteps * kNt * 32; i += blockDim.x) {
    const int l = i & 31, nt = (i >> 5) % kNt, ks = (i >> 5) / kNt;
    const int n = 8 * nt + (l >> 2);
    float v[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = (l & 3) + 4 * kk;
      int input = ks / kFullDiv, row = 8 * (ks % kFullDiv) + k;
      bool real = true;
      if (ks >= 3 * kFull) {
        const int rho = 8 * (ks - 3 * kFull) + k;
        real = rho < 3 * kRem;
        input = real ? rho / kRemDiv : 0;
        row = 8 * kFull + rho % kRemDiv;
      }
      const int col = (input == 2 ? 0 : (input + 1) * kN) + row;
      v[kk] = real && n < kN ? m[n * 3 * kN + col] : 0.0f;
    }
    const uint32_t h0 = tf32(v[0]), h1 = tf32(v[1]);
    mf[i] = make_uint4(h0, h1, tf32(v[0] - __uint_as_float(h0)), tf32(v[1] - __uint_as_float(h1)));
  }
  if (threadIdx.x < warps * stages) mbar_init(&bars[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  const int tiles = (cols + kCols - 1) / kCols;
  const int first = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  unsigned char* my = ring + static_cast<size_t>(warp) * stages * kStage;
  uint64_t* bar = bars + warp * stages;
  auto issue = [&](int s, int tile) {  // tile `tile` into stage s
    unsigned char* st = my + s * kStage;
    mbar_expect_tx(&bar[s], stage_tx<X0>());
    tma_load_2d(st, &xt_map, tile * kCols, 0, &bar[s]);
    tma_load_2d(st + kNp * kRowBytes, &eps_map, tile * kCols, 0, &bar[s]);
    tma_load_2d(st + 2 * kNp * kRowBytes, &x0_map, tile * kCols, 0, &bar[s]);
  };
  if (lane == 0)
    for (int s = 0; s < stages && first + s * stride < tiles; ++s) issue(s, first + s * stride);

  // This lane's byte offsets in a k-step's 8 rows, register j = h + 2·kk of m
  // tile mt: row q + 4·kk, column 4·(2·mt + h + 4·(r / 4)) + r % 4.
  const int q = lane & 3, r = lane >> 2;
  uint32_t off32[2][4], off16[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, row = q + 4 * (j >> 1);
      const int chunk = 2 * mt + h + 4 * (r >> 2);  // 16-byte chunk of the fp32 row
      off32[mt][j] = row * kRowBytes + ((chunk ^ row) << 4) + 4 * (r & 3);
      off16[mt][j] = row * 64 + (((chunk >> 1) ^ ((row >> 1) & 3)) << 4) + 2 * (4 * h + (r & 3));
    }

  int s = 0;
  uint32_t phase = 0;
  for (int tile = first; tile < tiles; tile += stride) {
    mbar_wait(&bar[s], phase);
    const unsigned char* st = my + s * kStage;
    float hi[2][kNt][4], lo[2][kNt][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) hi[mt][nt][j] = lo[mt][nt][j] = 0.0f;
#pragma unroll kUnroll
    for (int ks = 0; ks < 2 * kFull; ++ks)  // x_t's, then ε's
      kstep_f32<false>(st + (ks / kFullDiv * kNp + 8 * (ks % kFullDiv)) * kRowBytes, off32,
                       mf + ks * kNt * 32 + lane, hi, lo);
    const unsigned char* x0s = st + 2 * kNp * kRowBytes;
#pragma unroll kUnroll
    for (int ks = 0; ks < kFull; ++ks) {
      const uint4* f = mf + (2 * kFull + ks) * kNt * 32 + lane;
      if constexpr (kF32) {
        kstep_f32<true>(x0s + ks * 8 * kRowBytes, off32, f, hi, lo);
      } else {
        kstep_bf16(x0s + ks * 8 * 64, off16, f, hi, lo);
      }
    }
    if constexpr (kMix > 0) {
#pragma unroll
      for (int i = 0; i < kMix; ++i)
        kstep_mixed<X0>(st, i, q, r, mf + (3 * kFull + i) * kNt * 32 + lane, hi, lo);
    }
    __syncwarp();  // every lane has read the stage
    const int next = tile + stages * stride;
    if (lane == 0 && next < tiles) issue(s, next);

    const int c0 = tile * kCols;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 4 * (2 * mt + h + 4 * (r >> 2)) + (r & 3);
        if (c >= cols) continue;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 8 * nt + 2 * q + j;
            if (n < kN)
              out[static_cast<size_t>(n) * cols + c] = hi[mt][nt][2 * h + j] + lo[mt][nt][2 * h + j];
          }
      }
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// The tensor map of an [N, cols] tensor (fp32, or bf16) for boxes {kCols, N}.
cudaError_t encode_map(CUtensorMap* map, const void* base, bool bf16_elems, int cols) {
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
  const cuuint64_t elem = bf16_elems ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(kN)};
  const cuuint64_t strides[1] = {elem * static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {kCols, kN};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16_elems ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wrapper's plan must be one this source instantiates: 1 to kMaxWarps
// warps, 1 to kMaxStages stages, the shared memory smem_total computes; the
// tensor maps want 16-byte aligned tensors and rows of a multiple of 16 bytes.
template <typename X0>
int launch_tc(const X0* x0, const float* xt, const float* eps, const float* m, float* out,
              int cols, int warps, int stages, int smem_bytes, cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps || stages < 1 || stages > kMaxStages ||
      static_cast<size_t>(smem_bytes) != smem_total<X0>(warps, stages) ||
      smem_bytes > sm90mix::kMaxSmem || cols % (16 / sizeof(X0)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {static_cast<const void*>(x0), static_cast<const void*>(xt),
                        static_cast<const void*>(eps), static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xt_map{}, eps_map{}, x0_map{};
  cudaError_t err = encode_map(&xt_map, xt, false, cols);
  if (err == cudaSuccess) err = encode_map(&eps_map, eps, false, cols);
  if (err == cudaSuccess) err = encode_map(&x0_map, x0, !std::is_same_v<X0, float>, cols);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = posterior_step_tc<X0>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (cols + kCols - 1) / kCols;
  const int blocks = (tiles + warps - 1) / warps;
  kernel<<<blocks < sms ? blocks : sms, 32 * warps, smem_bytes, stream>>>(
      xt_map, eps_map, x0_map, m, out, cols, stages);
  return static_cast<int>(cudaGetLastError());
}

// ---- the CUDA-core design ---------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kCpt = kN > 32 ? 2 : 4;  // columns a thread: N·kCpt accumulators
constexpr int kQuads = (kN + 3) / 4;   // groups of 4 k of an input

// kCpt adjacent values of a row, widened to float.
__device__ __forceinline__ void load_cols(float (&v)[kCpt], const float* p) {
  if constexpr (kCpt == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = u.x, v[1] = u.y;
  }
}

__device__ __forceinline__ void load_cols(float (&v)[kCpt], const bf16* p) {
  if constexpr (kCpt == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    v[0] = f.x, v[1] = f.y;
  }
}

template <typename X0>
__global__ void __launch_bounds__(kFmaThreads)
posterior_step_fma(const X0* __restrict__ x0, const float* __restrict__ xt,
                   const float* __restrict__ eps, const float* __restrict__ m,
                   float* __restrict__ out, int cols) {
  __shared__ float4 ms[kN][3][kQuads];  // M[n][input·N + 4·quad + j], zeros past N
  for (int i = threadIdx.x; i < kN * 3 * kQuads * 4; i += kFmaThreads) {
    const int j = i & 3, quad = (i >> 2) % kQuads, input = (i >> 2) / kQuads % 3;
    const int n = (i >> 2) / kQuads / 3, k = 4 * quad + j;
    reinterpret_cast<float*>(ms)[i] = k < kN ? m[n * 3 * kN + input * kN + k] : 0.0f;
  }
  __syncthreads();
  const int c = (blockIdx.x * kFmaThreads + threadIdx.x) * kCpt;
  if (c >= cols) return;

  float acc[kN][kCpt];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < kCpt; ++i) acc[n][i] = 0.0f;
#pragma unroll 1
  for (int quad = 0; quad < kQuads; ++quad) {
    float a[4][kCpt], b[4][kCpt], e[4][kCpt];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * quad + j;
      if (k < kN) {
        const size_t off = static_cast<size_t>(k) * cols + c;
        load_cols(a[j], x0 + off);
        load_cols(b[j], xt + off);
        load_cols(e[j], eps + off);
#pragma unroll
        for (int i = 0; i < kCpt; ++i) a[j][i] = clip1(a[j][i]);
      } else {
#pragma unroll
        for (int i = 0; i < kCpt; ++i) a[j][i] = b[j][i] = e[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float4 w0 = ms[n][0][quad], w1 = ms[n][1][quad], w2 = ms[n][2][quad];
#pragma unroll
      for (int i = 0; i < kCpt; ++i) {
        float v = acc[n][i];
        v = fmaf(w0.x, a[0][i], v);
        v = fmaf(w0.y, a[1][i], v);
        v = fmaf(w0.z, a[2][i], v);
        v = fmaf(w0.w, a[3][i], v);
        v = fmaf(w1.x, b[0][i], v);
        v = fmaf(w1.y, b[1][i], v);
        v = fmaf(w1.z, b[2][i], v);
        v = fmaf(w1.w, b[3][i], v);
        v = fmaf(w2.x, e[0][i], v);
        v = fmaf(w2.y, e[1][i], v);
        v = fmaf(w2.z, e[2][i], v);
        acc[n][i] = fmaf(w2.w, e[3][i], v);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float* o = out + static_cast<size_t>(n) * cols + c;
    if constexpr (kCpt == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    } else {
      *reinterpret_cast<float2*>(o) = make_float2(acc[n][0], acc[n][1]);
    }
  }
}

template <typename X0>
int launch_fma(const X0* x0, const float* xt, const float* eps, const float* m, float* out,
               int cols, cudaStream_t stream) {
  if (cols % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cols / kCpt;
  posterior_step_fma<X0><<<(threads + kFmaThreads - 1) / kFmaThreads, kFmaThreads, 0, stream>>>(
      x0, xt, eps, m, out, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0 [n_nodes, cols] float32 or bf16, xt, eps, out [n_nodes, cols] float32,
// m [n_nodes, 3·n_nodes]; contiguous, 16-byte aligned, cols a multiple of 4
// (float32 x0) or 8 (bf16); the plan (warps, stages, smem_bytes) of
// ops/kernels/posterior_step.py::posterior_plan.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes and plans not
// instantiated.
extern "C" int posterior_step_f32(const float* x0, const float* xt, const float* eps,
                                  const float* m, float* out, int n_nodes, int cols, int warps,
                                  int stages, int smem_bytes, void* stream) {
  if (n_nodes != kN || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(x0, xt, eps, m, out, cols, warps, stages, smem_bytes,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int posterior_step_x0_bf16(const bf16* x0, const float* xt, const float* eps,
                                      const float* m, float* out, int n_nodes, int cols, int warps,
                                      int stages, int smem_bytes, void* stream) {
  if (n_nodes != kN || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(x0, xt, eps, m, out, cols, warps, stages, smem_bytes,
                   static_cast<cudaStream_t>(stream));
}

// The CUDA-core design (a yardstick, no wrapper launches it): the same
// tensors, cols a multiple of 4, 16-byte (float32 x0) or 8-byte (bf16)
// aligned.
extern "C" int posterior_step_fma_f32(const float* x0, const float* xt, const float* eps,
                                      const float* m, float* out, int n_nodes, int cols,
                                      void* stream) {
  if (n_nodes != kN || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fma(x0, xt, eps, m, out, cols, static_cast<cudaStream_t>(stream));
}

extern "C" int posterior_step_fma_x0_bf16(const bf16* x0, const float* xt, const float* eps,
                                          const float* m, float* out, int n_nodes, int cols,
                                          void* stream) {
  if (n_nodes != kN || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fma(x0, xt, eps, m, out, cols, static_cast<cudaStream_t>(stream));
}
