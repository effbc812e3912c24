// What the port's kernels for NVIDIA Hopper (sm_90a) share below their
// engines: the element types, the skeleton's node count, the conversions
// between an element and fp32, and the offset of an element of a node-major
// activation [N, B, F] (element (n, b, f) at (n·B + b)·F + f).
//
// The node count is the one constant of it every kernel sizes its tiles,
// shared memory and loops by.  It is a build parameter: ops/kernels/build.py
// compiles each source once for each node count a run asks for, with
// -DSKD_NODES=<N> (16 for H36M, 17 for FreeMan, 21 for AMASS and 3DPW
// without the hip, 51 for AMASS-MANO); a library refuses every other count at
// its C entries.  Up to kNarrowNodes the kernels keep the tiles they were
// designed with at 21 nodes; past it (kWide) they take the tiles of 51 nodes,
// chosen at compile time from kNodes.
//
// The product-and-mix engine of the fused denoiser's kernels is
// node_mix_sm90.cuh; the attention bodies are joint_attention.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace nodemix {

using bf16 = __nv_bfloat16;

#ifndef SKD_NODES
#define SKD_NODES 21  // the AMASS skeleton without its hip
#endif

constexpr int kNodes = SKD_NODES;
// the node mixes cover the nodes with up to four m16 tiles, attention gives
// each lane up to two query joints
static_assert(kNodes >= 2 && kNodes <= 51, "the kernels take 2 to 51 nodes");
// the largest node count of the 21-node tiles (ops/kernels/build.py's
// NARROW_NODES); past it the kernels take AMASS-MANO's
constexpr int kNarrowNodes = 21;
constexpr bool kWide = kNodes > kNarrowNodes;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and widened back: where the Pallas kernels materialise in
// their compute dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Offset of (node n, row b, column c) in a node-major [N, rows, width] tensor.
__device__ __forceinline__ size_t at(int n, int rows, int b, int width, int c) {
  return (static_cast<size_t>(n) * rows + b) * width + c;
}

}  // namespace nodemix
