// Reverse-diffusion posterior step, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/posterior_step.py::posterior_step_pallas
// (kernel body _posterior_kernel).  Over node-major latents [N, B, D], viewed
// as [N, C] with C = B·D columns, it computes
//
//   out[n, c] = sum_m M[n, m]·clip(x0[m, c], -1, 1) + M[n, N+m]·xt[m, c]
//                     + M[n, 2N+m]·eps[m, c]
//
// with M = [P1_t | P2_t | U·diag(sigma_t)] the [N, 3N] table of one step.
//
// What bounds it on the H100: memory.  Each step reads three [N, C] tensors
// and writes one (413 MB at N=21, B=12800, D=96) against 2·N·3N·C flops
// (3.3 GFLOP), about 8 flops a byte where the card balances at ~20 in fp32.
//
// What the design does about it: one thread owns 4 adjacent columns, so every
// input element is read once and every output element written once, with
// 16-byte loads and stores that are coalesced across the warp.  The N×4
// accumulators stay in registers; the matrix sits in shared memory and is
// read as warp-wide broadcasts.  No intermediate touches device memory.
// The TPU version padded D to 128 lanes; here D stays at its real width.
//
// A second entry reads x̂₀ in bf16, as the fused bf16 denoiser emits it (the
// Pallas kernel reads it in its own dtype and widens it, `:53`); x_t, the
// noise and the output stay float32.  It moves 5/6 of the bytes of the
// float32 entry.
//
// Past 32 nodes (AMASS-MANO's 51) N float4 accumulators would take 4·N
// registers a thread (204 at 51) and spill: there a thread owns 2 adjacent
// columns (posterior_step_kernel2, float2 loads and stores, still coalesced
// and each element read once), 2·N accumulators (102 at 51).
//
// N is the build's node count (node_mix.cuh, -DSKD_NODES: 16 for H36M, 17
// for FreeMan, 21 for AMASS, 51 for AMASS-MANO); the library refuses every
// other count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "node_mix.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clip1(float v) { return fminf(fmaxf(v, -1.0f), 1.0f); }

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// Four adjacent x̂₀ values, the i4-th group, widened to float.
__device__ __forceinline__ float4 load4(const float* x0, size_t i4) {
  return __ldg(reinterpret_cast<const float4*>(x0) + i4);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x0, size_t i4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(x0) + i4);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int N, typename X0>
__global__ void __launch_bounds__(kThreads)
posterior_step_kernel(const X0* __restrict__ x0, const float4* __restrict__ xt,
                      const float4* __restrict__ eps, const float* __restrict__ m,
                      float4* __restrict__ out, int cols4) {
  __shared__ float ms[N * 3 * N];
  for (int i = threadIdx.x; i < N * 3 * N; i += kThreads) ms[i] = m[i];
  __syncthreads();

  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols4) return;

  float4 acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

#pragma unroll 3
  for (int k = 0; k < N; ++k) {
    const size_t off = static_cast<size_t>(k) * cols4 + c;
    float4 a = load4(x0, off);
    const float4 b = __ldg(xt + off);
    const float4 e = __ldg(eps + off);
    a.x = clip1(a.x);
    a.y = clip1(a.y);
    a.z = clip1(a.z);
    a.w = clip1(a.w);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float* row = ms + n * 3 * N;
      fma4(acc[n], row[k], a);
      fma4(acc[n], row[N + k], b);
      fma4(acc[n], row[2 * N + k], e);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) out[static_cast<size_t>(n) * cols4 + c] = acc[n];
}

// Two adjacent x̂₀ values, the i2-th pair, widened to float.
__device__ __forceinline__ float2 load2(const float* x0, size_t i2) {
  return __ldg(reinterpret_cast<const float2*>(x0) + i2);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* x0, size_t i2) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(x0) + i2);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void fma2(float2& acc, float w, const float2& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
}

// posterior_step_kernel with a thread per 2 columns (more than 32 nodes).
template <int N, typename X0>
__global__ void __launch_bounds__(kThreads)
posterior_step_kernel2(const X0* __restrict__ x0, const float2* __restrict__ xt,
                       const float2* __restrict__ eps, const float* __restrict__ m,
                       float2* __restrict__ out, int cols2) {
  __shared__ float ms[N * 3 * N];
  for (int i = threadIdx.x; i < N * 3 * N; i += kThreads) ms[i] = m[i];
  __syncthreads();

  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols2) return;

  float2 acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = make_float2(0.0f, 0.0f);

#pragma unroll 3
  for (int k = 0; k < N; ++k) {
    const size_t off = static_cast<size_t>(k) * cols2 + c;
    float2 a = load2(x0, off);
    const float2 b = __ldg(xt + off);
    const float2 e = __ldg(eps + off);
    a.x = clip1(a.x);
    a.y = clip1(a.y);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float* row = ms + n * 3 * N;
      fma2(acc[n], row[k], a);
      fma2(acc[n], row[N + k], b);
      fma2(acc[n], row[2 * N + k], e);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) out[static_cast<size_t>(n) * cols2 + c] = acc[n];
}

template <typename X0>
int launch(const X0* x0, const float* xt, const float* eps, const float* m, float* out,
           int n_nodes, int cols, void* stream) {
  if (cols <= 0 || cols % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes != nodemix::kNodes) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (nodemix::kNodes > 32) {
    const int cols2 = cols / 2;
    const dim3 grid((cols2 + kThreads - 1) / kThreads);
    posterior_step_kernel2<nodemix::kNodes><<<grid, kThreads, 0, s>>>(
        x0, reinterpret_cast<const float2*>(xt), reinterpret_cast<const float2*>(eps), m,
        reinterpret_cast<float2*>(out), cols2);
  } else {
    const int cols4 = cols / 4;
    const dim3 grid((cols4 + kThreads - 1) / kThreads);
    const float4* b = reinterpret_cast<const float4*>(xt);
    const float4* e = reinterpret_cast<const float4*>(eps);
    float4* o = reinterpret_cast<float4*>(out);
    posterior_step_kernel<nodemix::kNodes><<<grid, kThreads, 0, s>>>(x0, b, e, m, o, cols4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0, xt, eps, out: [n_nodes, cols] float32, cols % 4 == 0, 16-byte aligned;
// m: [n_nodes, 3·n_nodes].  Returns cudaGetLastError() after the launch.
extern "C" int posterior_step_f32(const float* x0, const float* xt, const float* eps,
                                  const float* m, float* out, int n_nodes, int cols,
                                  void* stream) {
  return launch(x0, xt, eps, m, out, n_nodes, cols, stream);
}

// As posterior_step_f32 with x0 in bf16 (8-byte aligned).
extern "C" int posterior_step_x0_bf16(const __nv_bfloat16* x0, const float* xt, const float* eps,
                                      const float* m, float* out, int n_nodes, int cols,
                                      void* stream) {
  return launch(x0, xt, eps, m, out, n_nodes, cols, stream);
}
