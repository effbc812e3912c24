// Softmax attention over the skeleton's joints, feature-major, bf16 and fp32,
// for NVIDIA Hopper (sm_90a).  A lab kernel: no predictor path runs it.
//
// Replaces scripts/attn_core_lab.py::core_fm (kernel body _core_fm_kernel),
// the feature-major prototype of the attention core.  For every column b and
// head h of packed q‖k‖v [N, 3·H·dh, B] (the batch contiguous):
//
//   qn[n]   = round(q[n] · round(dh^-1/2))
//   s[n, m] = Σ_c round(k[m, c]·qn[n, c])            fp32 sums
//   a[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m v[m]·a[n, m])                [N, H·dh, B], fp32 sums
//
// round() is to the element type, where the Pallas kernel rounds in interpret
// mode: q·scale and the k·q products are stored in the input dtype, the v·a
// products are not, and the node sum is rounded once.
//
// What bounds it on the H100: memory.  At N=21, B=12 800, 8 heads × 32 in
// bf16 it reads 413 MB and writes 138 MB (0.164 ms) against ~2.9 G
// multiply-adds.
//
// What the design does about it: one thread per batch column, so every load
// and store of a warp covers 32 neighbouring columns of one feature
// (coalesced along B, as the layout asks).  A thread loops over the heads and
// the query joints, and over the dh features one at a time: it keeps only the
// 21 scores (then probabilities) in registers, statically indexed, and reads
// the keys and values of its head again for each query joint (from L1/L2: a
// block's 128 columns of one head are 344 KB in bf16).  No tensor cores: the
// per-column products are 21 × 32 dot products of a single column.

#include <cmath>

#include "node_mix.cuh"

namespace {

constexpr int kColumns = 128;  // batch columns (threads) a block

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const nodemix::bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T, int N, int DH>
__global__ void __launch_bounds__(kColumns)
attention_core_fm_kernel(const T* __restrict__ qkv, T* __restrict__ out, int rows, int heads,
                         float scale) {
  using nodemix::from_f;
  using nodemix::round_to;
  const int b = blockIdx.x * kColumns + threadIdx.x;
  if (b >= rows) return;
  const int hd = heads * DH;
  const size_t node = static_cast<size_t>(3) * hd * rows;  // stride of one joint
  const float sc = round_to<T>(scale);
  for (int h = 0; h < heads; ++h) {
    const T* qh = qkv + static_cast<size_t>(h * DH) * rows + b;
    const T* kh = qkv + static_cast<size_t>(hd + h * DH) * rows + b;
    const T* vh = qkv + static_cast<size_t>(2 * hd + h * DH) * rows + b;
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
      // scores: one feature c of the query at a time against all keys, so that
      // only the N scores live in registers (indexed statically)
      float p[N];
#pragma unroll
      for (int m = 0; m < N; ++m) p[m] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < DH; ++c) {
        const float qc = round_to<T>(load(qh + n * node + c * rows) * sc);
#pragma unroll
        for (int m = 0; m < N; ++m) p[m] += round_to<T>(load(kh + m * node + c * rows) * qc);
      }
      float mx = p[0];
#pragma unroll
      for (int m = 1; m < N; ++m) mx = fmaxf(mx, p[m]);
      float sum = 0.0f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        p[m] = expf(p[m] - mx);
        sum += p[m];
      }
#pragma unroll
      for (int m = 0; m < N; ++m) p[m] = round_to<T>(p[m] / sum);
      T* o = out + (static_cast<size_t>(n) * hd + h * DH) * rows + b;
#pragma unroll 1
      for (int c = 0; c < DH; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < N; ++m) acc = fmaf(load(vh + m * node + c * rows), p[m], acc);
        o[static_cast<size_t>(c) * rows] = from_f<T>(acc);
      }
    }
  }
}

template <typename T>
int launch(const void* qkv, void* out, int n_nodes, int rows, int heads, int dim_head,
           void* stream) {
  constexpr int kN = 21, kDH = 32;
  if (n_nodes != kN || dim_head != kDH || rows <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  attention_core_fm_kernel<T, kN, kDH>
      <<<(rows + kColumns - 1) / kColumns, kColumns, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(qkv), static_cast<T*>(out), rows, heads,
          static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDH))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [n_nodes, 3·heads·dim_head, rows] (q‖k‖v, heads major within each),
// out [n_nodes, heads·dim_head, rows]; contiguous.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// not instantiated.
extern "C" int attention_core_fm_bf16(const void* qkv, void* out, int n_nodes, int rows,
                                      int heads, int dim_head, void* stream) {
  return launch<nodemix::bf16>(qkv, out, n_nodes, rows, heads, dim_head, stream);
}
extern "C" int attention_core_fm_f32(const void* qkv, void* out, int n_nodes, int rows,
                                     int heads, int dim_head, void* stream) {
  return launch<float>(qkv, out, n_nodes, rows, heads, dim_head, stream);
}
