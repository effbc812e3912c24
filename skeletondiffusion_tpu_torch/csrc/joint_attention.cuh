// Softmax attention of one head over the skeleton's joints: the bodies
// shared by the attention kernel (B2, joint_attention.cu), the fused
// RMSNorm → qkv → attention kernel (B9b, layer_fused.cu) and the
// feature-major attention core (L1, attention_core_fm.cu), so that all three
// round at the same points:
//
//   qs      = round(q · round(dh^-1/2))
//   s[n, m] = Σ_c qs[n, c]·k[m, c]                  fp32 sums
//   p[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m p[n, m]·v[m])               fp32 sums
//
// round() is to the element type.  The Pallas kernels scale q and multiply
// it into k in their compute dtype, then sum over dh with a block-indicator
// matmul (a workaround for the TPU's matrix unit) in fp32: in bf16 they
// round each product qs·k too.  Two bodies:
//
// * head_attention_mma, the kernels' bf16 body: a warp per (row, head), both
//   products on the tensor cores, which sum the products qs·k exact: the one
//   rounding point where it differs from the Pallas kernel and the plain
//   version (held to them at the bf16 bounds; PERF.md §6).
// * head_attention, their fp32 body: a lane per query joint on the CUDA
//   cores (past 32 joints a lane takes joints lane and lane + 32 in turn).  Its bf16 branch rounds every product as the Pallas kernel does
//   (bit-exact to the plain version); the kernels run it in bf16 only when
//   kTensorCoreBody is switched off (scripts/torch_head_attention_ab.py).

#pragma once

#include <cmath>
#include <type_traits>

#include "node_mix.cuh"
#include "node_mix_sm90.cuh"

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

// Query joint n of one (row, head): joint m's q, k and v (DH values each,
// 16-byte aligned) start at q + m·ld, k + m·ld and v + m·ld (shared memory,
// read as broadcasts); the DH outputs go to o + n·ldo with 16-byte stores.
//
// In bf16, q·round(scale) and the q·k products are bf16x2 instructions:
// each gives the product rounded to bf16, as round_to<bf16> of the fp32
// product does (the fp32 product of two bf16 values is exact), and the
// products are summed in the same order, so both forms give the same bits.
template <typename T, int N, int DH>
__device__ __forceinline__ void head_attention_joint(int n, const T* q_base, const T* k_base,
                                                     const T* v_base, int ld, float scale,
                                                     T* o_base, size_t ldo) {
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

// The calling warp computes every query joint of one (row, head): lane n the
// joints n, n + 32, … below N (one joint a lane up to 32 joints; lanes n ≥ N
// return at once).
template <typename T, int N, int DH>
__device__ __forceinline__ void head_attention(const T* q_base, const T* k_base, const T* v_base,
                                               int ld, float scale, T* o_base, size_t ldo) {
#pragma unroll 1
  for (int n = threadIdx.x & 31; n < N; n += 32)
    head_attention_joint<T, N, DH>(n, q_base, k_base, v_base, ld, scale, o_base, ldo);
}

// The body the kernels run for element type T (see the head of this file).
template <typename T>
constexpr bool kTensorCoreBody = std::is_same_v<T, bf16>;

// The attention of one (row, head) by the whole calling warp, bf16, on the
// tensor cores (mma.sync m16n8k16, fp32 sums):
//
//   S = qs·kᵀ   queries N → 16·MT (MT = ⌈N/16⌉ m16 tiles) × keys N → 8·KT
//               (KT = ⌈N/8⌉ n8 tiles) × dh 32 (two k-steps): at N = 21 two
//               × three tiles, 12 mma, q and k through ldmatrix, q scaled in
//               its fragments (qs = round(q·round(scale)))
//   p = round(softmax(S)) in the accumulators: keys ≥ N masked to −∞, each
//               row's max and sum over its quad of lanes by shuffles
//   O = p·v     p reused from registers as the A operand (keys N → 16·MT,
//               MT k-steps) × dh 32 (four n8 tiles): 16 mma at N = 21, v
//               through ldmatrix.trans
//
// Up to 32 joints S holds every query tile at once; past 32 (AMASS-MANO's
// 51: MT = 4, KT = 7) the body takes the query m16 tiles one at a time, each
// with its own S (7 × 4 fp32 a lane), softmax, p·v and store of O, so that S
// is live for one tile (all four would be 112 registers a lane).
//
// N is the build's node count (16 for H36M, 17 for FreeMan, 21 for AMASS, 51
// for AMASS-MANO).  Joint m's q, k and v (32 values each, 16-byte aligned) lie at
// q + m·ld, k + m·ld and v + m·ld in shared memory; the ldmatrix rows of
// joints ≥ N read `zero`, a 16-byte zero row.  O, rounded, overwrites q's rows (read by
// this warp alone, and no more): head_attention_mma_smem ends there (the
// feature-major core, attention_core_fm.cu, stores O itself);
// head_attention_mma then sends it to o + n·ldo with 16-byte stores (64
// contiguous bytes a joint).  With ld ≡ 16 bytes mod 128 the eight rows of
// each ldmatrix and of each fragment store fall in distinct banks.
__device__ __forceinline__ void head_attention_mma_smem(bf16* q, const bf16* k, const bf16* v,
                                                        int ld, float scale, const void* zero) {
  using sm90mix::ldmatrix_x4;
  using sm90mix::ldmatrix_x4_trans;
  using sm90mix::mma_bf16;
  using sm90mix::pack_bf16;
  using sm90mix::smem_u32;
  constexpr int N = sm90mix::kNodes;
  constexpr int MT = (N + 15) / 16;  // query m16 tiles, and p·v's k-steps
  constexpr int KT = (N + 7) / 8;    // key n8 tiles of S
  constexpr int MG = MT > 2 ? 1 : MT;  // query tiles a pass
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t zrow = smem_u32(zero);
  auto row = [&](const bf16* base, int joint, int col) {
    return joint < N ? smem_u32(base + joint * ld + col) : zrow;
  };

  // k: B fragments of n-tile nt, dh 0-7, 8-15, 16-23, 24-31 (keys 8·nt + lane%8)
  uint32_t kb[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) ldmatrix_x4(kb[nt], row(k, 8 * nt + (lane & 7), 8 * (lane >> 3)));
  const __nv_bfloat162 sc = __float2bfloat162_rn(scale);
  // the query tiles m0 … m0 + MG − 1 of a pass
#pragma unroll 1
  for (int m0 = 0; m0 < MT; m0 += MG) {
    // qs: A fragments [m-tile][k-step], this lane's row 16·mt + lane%16, k half lane/16
    uint32_t qa[MG][2][4];
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldmatrix_x4(qa[mt][ks], row(q, 16 * (m0 + mt) + (lane & 15), 16 * ks + 8 * (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 qs = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&qa[mt][ks][i]), sc);
          qa[mt][ks][i] = *reinterpret_cast<const uint32_t*>(&qs);
        }
      }
    float s[MG][KT][4];
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
        mma_bf16(s[mt][nt], qa[mt][0], kb[nt][0], kb[nt][1]);
        mma_bf16(s[mt][nt], qa[mt][1], kb[nt][2], kb[nt][3]);
      }

    // softmax of this lane's rows 16·mt + g (elements 0, 1) and + 8 (2, 3),
    // columns 8·nt + 2t + e, over the quad that holds the row
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < KT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            if (8 * nt + 2 * t + e >= N) x = -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < KT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            x = expf(x - mx);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float rcp = __frcp_rn(sum);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            x = sm90mix::quotient(x, sum, rcp);  // x / sum, rounded as IEEE division
          }
      }

    // p, rounded, as A fragments [m-tile][k-step]: k-step kk's keys 16·kk …
    // from n-tiles 2·kk and 2·kk + 1, zero past the last n-tile (keys ≥ 8·KT)
    uint32_t pa[MG][MT][4];
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        if (2 * kk + 1 < KT) {
          pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        } else {
          pa[mt][kk][2] = pa[mt][kk][3] = 0u;
        }
      }
    float acc[MG][4][4];
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      // v: B fragments of dh n-tiles j, j + 1 from one ldmatrix.trans (keys
      // 16·kk + lane%8 (+ 8 for lanes 8-15 and 24-31), dh 8·j (+ 8 for lanes ≥ 16))
      uint32_t vb[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, row(v, 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                 16 * jp + 8 * (lane >> 4)));
        vb[2 * jp][0] = r[0];
        vb[2 * jp][1] = r[1];
        vb[2 * jp + 1][0] = r[2];
        vb[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MG; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], pa[mt][kk], vb[j][0], vb[j][1]);
    }

    // O into the pass's q rows (every lane's ldmatrix of them is long done;
    // no later pass reads them)
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MG; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int joint = 16 * (m0 + mt) + 8 * hf + g;
        if (joint < N) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(q + joint * ld + 8 * j + 2 * t) =
                pack_bf16(acc[mt][j][2 * hf], acc[mt][j][2 * hf + 1]);
        }
      }
  }
}

__device__ __forceinline__ void head_attention_mma(bf16* q, const bf16* k, const bf16* v, int ld,
                                                   float scale, bf16* o, size_t ldo,
                                                   const void* zero) {
  head_attention_mma_smem(q, k, v, ld, scale, zero);
  __syncwarp();
  constexpr int N = sm90mix::kNodes;
  for (int c = threadIdx.x & 31; c < 4 * N; c += 32) {
    const int joint = c >> 2, part = c & 3;
    *reinterpret_cast<uint4*>(o + joint * ldo + 8 * part) =
        *reinterpret_cast<const uint4*>(q + joint * ld + 8 * part);
  }
}

}  // namespace nodemix
