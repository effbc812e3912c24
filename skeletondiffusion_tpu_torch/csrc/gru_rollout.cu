// Graph-GRU decode rollout, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/gru_rollout.py::gru_rollout_pallas
// (fp32 kernel body _rollout_kernel), reached through decode_rollout.  For
// every batch row it runs all ph steps of
//
//   gates_h = G_t·(h·W_hh + b_hh),  gates_x = G_t·cx      (per gate r, z, n)
//   r, z = sigmoid(x + h),  n = tanh(x_n + r·h_n),  h' = n - n·z + z·h
//   y_t = tanh(G_fc·(h'·W_fc + b_fc)),  G_{t+1} = l1norm_rows(G_t + G_add)
//
// with per-node weight banks W_hh [N][H][3H], W_fc [N][H][F] and the N×N
// influence matrices G mixing the nodes.  cx [N][B][3H] are the hoisted
// input gates; out is [ph][N][B][F].
//
// What bounds it on the H100: operations.  At N=21, H=96, B=12800, ph=120 the
// rollout does ~2.3 TFLOP of fp32 multiply-adds (the per-node h·W_hh products
// are 77% of them) against ~0.8 GB of compulsory traffic, so it sits far
// above the fp32 balance point of ~20 flops a byte.  The per-node products
// are small (8 rows × 96 × 96 per node and gate per block), and every step
// depends on the previous one.
//
// What the design does about it:
// * The G mix couples the nodes of a row but the rows are independent, so one
//   block owns 8 batch rows for all N nodes and runs the whole ph-step loop
//   itself: no grid-wide synchronisation, and the hidden state, the current
//   gate, the r gate and the evolving G never leave shared memory (197 KB of
//   the 227 KB a block may use).  G_t is the same for every row; each block
//   keeps its own copy.
// * The h·W_hh product is register-tiled: a warp owns one node, a lane 3
//   hidden columns × 8 rows, so each weight element is loaded once per block
//   and step (coalesced, from L2: the 2.3 MB of W_hh stay cached) and used
//   for 8 rows, and h is read as float4 shared-memory broadcasts.
// * The gates are processed one at a time in the order r, n, z, so one gate
//   buffer and one r/n buffer suffice; for r and z the mix is taken once over
//   (cx + h·W_hh + b_hh), for n separately over cx and over h·W_hh + b_hh.
// * cx is read from device memory once per step and gate (it is too large to
//   keep on chip at 8 rows × 21 nodes × 288 gates per block).
// The TPU kernel padded H to 128 lanes; here H stays at its real width.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 8;    // batch rows per block
constexpr int kWarps = 7;   // 21 nodes = 3 rounds of 7 warps in the weight product
constexpr int kThreads = 32 * kWarps;

template <int N, int H, int F>
struct Layout {
  static constexpr int NP = (N + 3) / 4 * 4;    // padded row stride of the N×N matrices
  static constexpr int kState = N * kRows * H;  // floats of one [N][kRows][H] buffer
  static constexpr int kFloats = 3 * kState + 3 * N * NP + N * kRows * F;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// p_s[m][r][j] = b_hh[m][gate·H + j] + sum_k h_s[m][r][k] · W_hh[m][k][gate·H + j]
template <int N, int H>
__device__ __forceinline__ void gate_product(const float* __restrict__ w_hh,
                                             const float* __restrict__ b_hh, int gate,
                                             const float* h_s, float* p_s) {
  constexpr int Q = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < N; m += kWarps) {
    const float* w = w_hh + static_cast<size_t>(m) * H * 3 * H + gate * H + lane;
    const float* hm = h_s + m * kRows * H;
    float acc[kRows][Q];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[r][q] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      float wv[4][Q];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < Q; ++q) wv[kk][q] = __ldg(w + (k + kk) * 3 * H + 32 * q);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hm + r * H + k);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          acc[r][q] = fmaf(hv.x, wv[0][q], acc[r][q]);
          acc[r][q] = fmaf(hv.y, wv[1][q], acc[r][q]);
          acc[r][q] = fmaf(hv.z, wv[2][q], acc[r][q]);
          acc[r][q] = fmaf(hv.w, wv[3][q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float b = __ldg(b_hh + m * 3 * H + gate * H + lane + 32 * q);
#pragma unroll
      for (int r = 0; r < kRows; ++r) p_s[(m * kRows + r) * H + lane + 32 * q] = acc[r][q] + b;
    }
  }
}

// Mix gate GATE (0 = r, 1 = z, 2 = n) over the nodes and apply its update:
//   r:  r_s = sigmoid(G·(cx_r + p))
//   n:  r_s = tanh(G·cx_n + r_s · G·p)          (r_s holds r on entry)
//   z:  h_s = n - n·z + z·h_s with z = sigmoid(G·(cx_z + p)), n = r_s
template <int N, int H, int GATE>
__device__ __forceinline__ void gate_mix(const float* __restrict__ cx, int batch, int row0,
                                         const float* g_s, const float* p_s, float* r_s,
                                         float* h_s) {
  constexpr int NP = (N + 3) / 4 * 4;
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int r = i / H, j = i % H, row = row0 + r;
    float p[NP], c[NP];
#pragma unroll
    for (int m = 0; m < NP; ++m) {
      p[m] = m < N ? p_s[m * kRows * H + i] : 0.0f;
      c[m] = (m < N && row < batch)
                 ? __ldg(cx + (static_cast<size_t>(m) * batch + row) * 3 * H + GATE * H + j)
                 : 0.0f;
      if (GATE != 2) p[m] += c[m];
    }
    for (int n = 0; n < N; ++n) {
      const float4* gr = reinterpret_cast<const float4*>(g_s + n * NP);
      float hs = 0.0f, xs = 0.0f;
#pragma unroll
      for (int m4 = 0; m4 < NP / 4; ++m4) {
        const float4 g = gr[m4];
        hs = fmaf(g.x, p[4 * m4], hs);
        hs = fmaf(g.y, p[4 * m4 + 1], hs);
        hs = fmaf(g.z, p[4 * m4 + 2], hs);
        hs = fmaf(g.w, p[4 * m4 + 3], hs);
        if (GATE == 2) {
          xs = fmaf(g.x, c[4 * m4], xs);
          xs = fmaf(g.y, c[4 * m4 + 1], xs);
          xs = fmaf(g.z, c[4 * m4 + 2], xs);
          xs = fmaf(g.w, c[4 * m4 + 3], xs);
        }
      }
      const int e = n * kRows * H + i;
      if (GATE == 0) {
        r_s[e] = sigmoid(hs);
      } else if (GATE == 2) {
        r_s[e] = tanhf(xs + r_s[e] * hs);
      } else {
        const float z = sigmoid(hs), cand = r_s[e];
        h_s[e] = cand - cand * z + z * h_s[e];
      }
    }
  }
}

template <int N, int H, int F>
__global__ void __launch_bounds__(kThreads, 1)
gru_rollout_kernel(const float* __restrict__ cx, const float* __restrict__ h0,
                   const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                   const float* __restrict__ g0, const float* __restrict__ g_add,
                   const float* __restrict__ w_fc, const float* __restrict__ b_fc,
                   const float* __restrict__ g_fc, float* __restrict__ out, int batch, int ph) {
  static_assert(H % 32 == 0, "the weight product gives each lane H/32 columns");
  using L = Layout<N, H, F>;
  constexpr int NP = L::NP;
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [N][kRows][H] hidden state
  float* p_s = h_s + L::kState;                  // [N][kRows][H] current gate's h·W_hh + b_hh
  float* r_s = p_s + L::kState;                  // [N][kRows][H] r gate, then the candidate n
  float* g_s = r_s + L::kState;                  // [N][NP] influence G_t
  float* gadd_s = g_s + N * NP;                  // [N][NP] G_add
  float* gfc_s = gadd_s + N * NP;                // [N][NP] G_fc
  float* q_s = gfc_s + N * NP;                   // [N][kRows][F] output head before its mix

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  for (int i = tid; i < L::kState; i += kThreads) {
    const int m = i / (kRows * H), r = (i / H) % kRows, k = i % H, row = row0 + r;
    h_s[i] = row < batch ? h0[(static_cast<size_t>(m) * batch + row) * H + k] : 0.0f;
  }
  for (int i = tid; i < N * NP; i += kThreads) {
    const int n = i / NP, m = i % NP;
    g_s[i] = m < N ? g0[n * N + m] : 0.0f;
    gadd_s[i] = m < N ? g_add[n * N + m] : 0.0f;
    gfc_s[i] = m < N ? g_fc[n * N + m] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < ph; ++t) {
    gate_product<N, H>(w_hh, b_hh, 0, h_s, p_s);
    __syncthreads();
    gate_mix<N, H, 0>(cx, batch, row0, g_s, p_s, r_s, h_s);
    __syncthreads();
    gate_product<N, H>(w_hh, b_hh, 2, h_s, p_s);
    __syncthreads();
    gate_mix<N, H, 2>(cx, batch, row0, g_s, p_s, r_s, h_s);
    __syncthreads();
    gate_product<N, H>(w_hh, b_hh, 1, h_s, p_s);
    __syncthreads();
    gate_mix<N, H, 1>(cx, batch, row0, g_s, p_s, r_s, h_s);  // h_s now holds h'
    __syncthreads();

    // output head before its mix: q_s[m][r][f] = b_fc[m][f] + h'[m][r]·W_fc[m][:, f]
    for (int i = tid; i < N * kRows * F; i += kThreads) {
      const int m = i / (kRows * F), r = (i / F) % kRows, f = i % F;
      const float* hm = h_s + (m * kRows + r) * H;
      const float* w = w_fc + static_cast<size_t>(m) * H * F + f;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(hm[k], __ldg(w + k * F), acc);
      q_s[i] = acc + __ldg(b_fc + m * F + f);
    }
    // G_{t+1} = l1norm_rows(G_t + G_add), the row norm clipped at 1e-12
    for (int n = tid; n < N; n += kThreads) {
      float* g = g_s + n * NP;
      const float* ga = gadd_s + n * NP;
      float s = 0.0f;
      for (int m = 0; m < N; ++m) s += fabsf(g[m] + ga[m]);
      const float norm = fmaxf(s, 1e-12f);
      for (int m = 0; m < N; ++m) g[m] = (g[m] + ga[m]) / norm;
    }
    __syncthreads();

    // y_t = tanh(G_fc · q)
    for (int i = tid; i < N * kRows * F; i += kThreads) {
      const int n = i / (kRows * F), r = (i / F) % kRows, f = i % F, row = row0 + r;
      float acc = 0.0f;
      for (int m = 0; m < N; ++m) acc = fmaf(gfc_s[n * NP + m], q_s[(m * kRows + r) * F + f], acc);
      if (row < batch) out[((static_cast<size_t>(t) * N + n) * batch + row) * F + f] = tanhf(acc);
    }
    // the next writes of q_s and g_s come after the next step's barriers
  }
}

template <int N, int H, int F>
cudaError_t launch(const float* cx, const float* h0, const float* w_hh, const float* b_hh,
                   const float* g0, const float* g_add, const float* w_fc, const float* b_fc,
                   const float* g_fc, float* out, int batch, int ph, cudaStream_t stream) {
  constexpr size_t bytes = Layout<N, H, F>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(gru_rollout_kernel<N, H, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kRows - 1) / kRows);
  gru_rollout_kernel<N, H, F><<<grid, kThreads, bytes, stream>>>(
      cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, out, batch, ph);
  return cudaGetLastError();
}

}  // namespace

// Shapes as in the header comment, all float32 and contiguous.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// library does not instantiate).
extern "C" int gru_rollout_f32(const float* cx, const float* h0, const float* w_hh,
                               const float* b_hh, const float* g0, const float* g_add,
                               const float* w_fc, const float* b_fc, const float* g_fc,
                               float* out, int n_nodes, int batch, int hidden, int f_out, int ph,
                               void* stream) {
  if (batch <= 0 || ph <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes == 21 && hidden == 96 && f_out == 3) {
    return static_cast<int>(
        launch<21, 96, 3>(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, out, batch, ph, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
