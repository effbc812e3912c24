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
// and writes its dh outputs with 16-byte stores.

#include <cmath>

#include "node_mix.cuh"

namespace {

using nodemix::bf16;
using nodemix::from_f;
using nodemix::round_to;

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

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

  const int h = threadIdx.x >> 5, n = threadIdx.x & 31;
  if (n >= N) return;
  const float sc = round_to<T>(scale);
  float q[DH];
#pragma unroll
  for (int c = 0; c < DH; c += 8) load8(s + n * width + h * DH + c, q + c);
#pragma unroll
  for (int c = 0; c < DH; ++c) q[c] = round_to<T>(q[c] * sc);

  float p[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const T* km = s + m * width + hd + h * DH;
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      float kv[8];
      load8(km + c, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) d += round_to<T>(q[c + j] * kv[j]);
    }
    p[m] = d;
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

  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const T* vm = s + m * width + 2 * hd + h * DH;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      float vv[8];
      load8(vm + c, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c + j] = fmaf(p[m], vv[j], acc[c + j]);
    }
  }
  T* o = out + (static_cast<size_t>(n) * rows + b) * hd + h * DH;
#pragma unroll
  for (int c = 0; c < DH; c += 8) store8(o + c, acc + c);
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
