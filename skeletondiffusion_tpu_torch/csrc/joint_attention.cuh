// Softmax attention of one head over the skeleton's joints, for one query
// joint per lane: the body shared by the attention kernel (B2,
// joint_attention.cu) and the fused RMSNorm → qkv → attention kernel (B9b,
// layer_fused.cu), so that both round at the same points:
//
//   qs      = round(q · round(dh^-1/2))
//   s[n, m] = Σ_c round(qs[n, c]·k[m, c])           fp32 sums
//   p[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m p[n, m]·v[m])               fp32 sums
//
// round() is to the element type, where the Pallas kernels round: they scale
// q and multiply it into k in their compute dtype, then sum over dh with a
// block-indicator matmul (a workaround for the TPU's matrix unit) in fp32.

#pragma once

#include <type_traits>

#include "node_mix.cuh"

namespace nodemix {

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

// Lane n < N of the calling warp computes query joint n of one (row, head):
// joint m's q, k and v (DH values each, 16-byte aligned) start at q + m·ld,
// k + m·ld and v + m·ld (shared memory, read as broadcasts); the DH outputs
// go to o + n·ldo with 16-byte stores.  Lanes n ≥ N return at once.
//
// In bf16, q·round(scale) and the q·k products are bf16x2 instructions:
// each gives the product rounded to bf16, as round_to<bf16> of the fp32
// product does (the fp32 product of two bf16 values is exact), and the
// products are summed in the same order, so both forms give the same bits.
template <typename T, int N, int DH>
__device__ __forceinline__ void head_attention(const T* q_base, const T* k_base, const T* v_base,
                                               int ld, float scale, T* o_base, size_t ldo) {
  const int n = threadIdx.x & 31;
  if (n >= N) return;
  float p[N];
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 sc = __float2bfloat162_rn(scale);
    __nv_bfloat162 q[DH / 2];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(q_base + n * ld + 8 * c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) q[4 * c + i] = __hmul2(h[i], sc);
    }
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const uint4* km = reinterpret_cast<const uint4*>(k_base + m * ld);
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const uint4 u = km[c];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 prod = __hmul2(q[4 * c + i], h[i]);
          d += __low2float(prod);
          d += __high2float(prod);
        }
      }
      p[m] = d;
    }
  } else {
    const float sc = round_to<T>(scale);
    float q[DH];
#pragma unroll
    for (int c = 0; c < DH; c += 8) load8(q_base + n * ld + c, q + c);
#pragma unroll
    for (int c = 0; c < DH; ++c) q[c] = round_to<T>(q[c] * sc);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const T* km = k_base + m * ld;
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
    const T* vm = v_base + m * ld;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      float vv[8];
      load8(vm + c, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c + j] = fmaf(p[m], vv[j], acc[c + j]);
    }
  }
  T* o = o_base + static_cast<size_t>(n) * ldo;
#pragma unroll
  for (int c = 0; c < DH; c += 8) store8(o + c, acc + c);
}

}  // namespace nodemix
