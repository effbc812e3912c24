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

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clip1(float v) { return fminf(fmaxf(v, -1.0f), 1.0f); }

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
posterior_step_kernel(const float4* __restrict__ x0, const float4* __restrict__ xt,
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
    float4 a = __ldg(x0 + off);
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

}  // namespace

// x0, xt, eps, out: [n_nodes, cols] float32, cols % 4 == 0, 16-byte aligned;
// m: [n_nodes, 3·n_nodes].  Returns cudaGetLastError() after the launch.
extern "C" int posterior_step_f32(const float* x0, const float* xt, const float* eps,
                                  const float* m, float* out, int n_nodes, int cols,
                                  void* stream) {
  if (cols <= 0 || cols % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cols4 = cols / 4;
  const dim3 grid((cols4 + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a = reinterpret_cast<const float4*>(x0);
  const float4* b = reinterpret_cast<const float4*>(xt);
  const float4* e = reinterpret_cast<const float4*>(eps);
  float4* o = reinterpret_cast<float4*>(out);
  switch (n_nodes) {
    case 21:
      posterior_step_kernel<21><<<grid, kThreads, 0, s>>>(a, b, e, m, o, cols4);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
