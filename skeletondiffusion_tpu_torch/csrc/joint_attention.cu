// Softmax attention over the skeleton's joints, bf16 and fp32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/joint_attention.py::attention_core_pallas
// (kernel body _attn_core_kernel).  For every row b and head h of packed
// node-major q‖k‖v [N, B, 3·H·dh]:
//
//   qs      = round(q · round(dh^-1/2))
//   s[n, m] = Σ_c round(qs[n, c]·k[m, c])           fp32 sums
//   p[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m p[n, m]·v[m])               [N, B, H·dh], fp32 sums
//
// round() is to the element type, where the Pallas kernel rounds: it scales
// q and multiplies it into k in its compute dtype, then sums over dh with a
// block-indicator matmul (a workaround for the TPU's matrix unit) in fp32.
// Here the sums are plain fp32 loops.
//
// What bounds it on the H100: memory.  At N=21, B=12 800, 8 heads × 32 in
// bf16 it reads 413 MB and writes 138 MB (0.164 ms) against ~2.9 G
// multiply-adds.
//
// What the design does about it: one block per row, one warp per head, one
// lane per query joint (21 of 32 lanes).  The block copies the row's
// 21 × 3·H·dh values into shared memory with 16-byte loads (each value read
// once); a lane keeps its query in registers, reads each key and value of
// its head as a broadcast, holds its 21 scores in registers for the softmax
// and writes its dh outputs with 16-byte stores.  That per-lane body is
// joint_attention.cuh's head_attention, shared with the fused B9b kernel
// (layer_fused.cu).

#include <cmath>

#include "joint_attention.cuh"

namespace {

template <typename T, int N, int DH>
__global__ void __launch_bounds__(1024)
attention_core_kernel(const T* __restrict__ qkv, T* __restrict__ out, int rows, int heads,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int hd = heads * DH, width = 3 * hd;
  const int vecs = static_cast<int>(width * sizeof(T) / 16);
  for (int i = threadIdx.x; i < N * vecs; i += blockDim.x) {
    const int n = i / vecs, v = i % vecs;
    reinterpret_cast<uint4*>(s + n * width)[v] =
        __ldg(reinterpret_cast<const uint4*>(qkv + (static_cast<size_t>(n) * rows + b) * width) + v);
  }
  __syncthreads();

  const int h = threadIdx.x >> 5;
  nodemix::head_attention<T, N, DH>(s + h * DH, s + hd + h * DH, s + 2 * hd + h * DH, width,
                                    scale, out + static_cast<size_t>(b) * hd + h * DH,
                                    static_cast<size_t>(rows) * hd);
}

template <typename T>
int launch(const void* qkv, void* out, int n_nodes, int rows, int heads, int dim_head,
           void* stream) {
  constexpr int kN = 21, kDH = 32;
  if (n_nodes != kN || dim_head != kDH || rows <= 0 || heads <= 0 || heads > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(T) * kN * 3 * heads * kDH;
  auto kernel = attention_core_kernel<T, kN, kDH>;
  cudaError_t err = nodemix::prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, 32 * heads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), rows, heads,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDH))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [n_nodes, rows, 3·heads·dim_head] (q‖k‖v, heads major within each),
// out [n_nodes, rows, heads·dim_head]; contiguous, 16-byte aligned.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// not instantiated.
extern "C" int attention_core_bf16(const void* qkv, void* out, int n_nodes, int rows, int heads,
                                   int dim_head, void* stream) {
  return launch<nodemix::bf16>(qkv, out, n_nodes, rows, heads, dim_head, stream);
}
extern "C" int attention_core_f32(const void* qkv, void* out, int n_nodes, int rows, int heads,
                                  int dim_head, void* stream) {
  return launch<float>(qkv, out, n_nodes, rows, heads, dim_head, stream);
}
