// Graph-GRU decode rollout with bf16 operands (the merged-gate rollout), for
// NVIDIA Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/gru_rollout.py::gru_rollout_pallas
// with compute_dtype='bfloat16' (kernel body _rollout_kernel_merged), reached
// through decode_rollout(compute_dtype='bfloat16').  For every batch row it
// runs all ph steps of
//
//   gc   = bf16(G_t)
//   hw3  = bf16(bf16(h)·W_hh + b_hh)                       [3H], fp32 sums
//   r, z = bf16(sigmoid(gc·cx + gc·hw3))                   (per gate)
//   n    = tanh(gc·cx_n + r·(gc·hw3_n)),  h' = n - n·z + z·h      (fp32)
//   y_t  = tanh(G_fc·(bf16(h')·W_fc + b_fc))               (G_fc, y fp32)
//   G_{t+1} = l1norm_rows(G_t + G_add)                     (fp32)
//
// with per-node banks W_hh [N][H][3H] and W_fc [N][H][F] in bf16, cx
// [N][B][3H] the hoisted input gates in bf16, h0 [N][B][H] and the N×N
// influences in fp32; out is [ph][N][B][F] fp32.  It rounds where the Pallas
// kernel rounds (its bf16 scratch buffers), so it differs from the plain
// version (ops/kernels/gru_rollout.py::gru_rollout_merged_plain) only in the
// order of fp32 sums.
//
// What bounds it on the H100: operations.  At N=21, H=96, B=12800, ph=120
// the rollout does ~2.3 TFLOP (with the r and z gates mixed once over
// cx + hw3), 77% of it the per-node h·W_hh products, against ~0.65 GB of
// compulsory traffic (cx, h0 and the 387 MB of output).
//
// What the design does about it:
// * As in the fp32 rollout (gru_rollout.cu) a block owns 8 batch rows for all
//   N nodes and runs the whole ph-step loop: the fp32 hidden state, its bf16
//   copy, the three gates' hw3 and G_t stay in shared memory (207 KB).
// * The h·W_hh products run on the bf16 tensor cores (nvcuda::wmma m8n32k16,
//   fp32 accumulators): a warp takes one node and 32 of the 3H columns, its
//   A tile the node's 8 bf16 hidden rows in shared memory, its B tiles the
//   weight bank straight from device memory (2.3 MB of W_hh, L2-resident).
// * The node mixes and the gate update run in fp32 FMAs over the bf16 values
//   (a product of two bf16 values is exact in fp32, so this is the tensor
//   cores' function): one thread per (row, hidden column) reads the column
//   of all nodes of the three gates once (cx from device memory, coalesced
//   along the columns; hw3 from shared memory), mixes the r and z gates over
//   cx + hw3 and the n gate over each, and writes h' for every node.  The
//   gates are never stored.
// * The output head writes 8 rows × F contiguous floats per node and step.
// The TPU kernel padded H to 128 lanes and F to 8 rows; here both stay real.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;    // batch rows per block (the wmma tile's M)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <int N, int H, int F>
struct Layout {
  static constexpr int NP = (N + 3) / 4 * 4;  // padded row stride of the N×N matrices
  static constexpr size_t kH = sizeof(float) * N * kRows * H;        // h, fp32
  static constexpr size_t kHb = sizeof(bf16) * N * kRows * H;        // bf16(h)
  static constexpr size_t kHw = sizeof(bf16) * N * kRows * 3 * H;    // hw3
  static constexpr size_t kScratch = sizeof(float) * kWarps * kRows * 32;
  static constexpr size_t kG = sizeof(float) * 4 * N * NP;           // G, bf16(G), G_add, G_fc
  static constexpr size_t kQ = sizeof(float) * N * kRows * F;        // head before its mix
  static constexpr size_t kBytes = kH + kHb + kHw + kScratch + kG + kQ;
  static_assert(kH % 128 == 0 && kHb % 128 == 0 && kHw % 128 == 0 && kScratch % 128 == 0 &&
                    kG % 16 == 0,
                "every buffer starts 128-byte aligned (wmma needs 32)");
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float load_bf16(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// hw_s[m][r][c] = bf16(b_hh[m][c] + sum_k hb_s[m][r][k] · W_hh[m][k][c]) for
// every node m, row r and column c < 3H, on the tensor cores.
template <int N, int H>
__device__ __forceinline__ void hidden_product(const bf16* __restrict__ w_hh,
                                               const float* __restrict__ b_hh, const bf16* hb_s,
                                               bf16* hw_s, float* scratch) {
  using namespace nvcuda;
  constexpr int kTiles = 3 * H / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* c = scratch + warp * kRows * 32;
  for (int task = warp; task < N * kTiles; task += kWarps) {
    const int m = task / kTiles, col0 = (task % kTiles) * 32;
    wmma::fragment<wmma::matrix_a, kRows, 32, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, kRows, 32, 16, bf16, wmma::row_major> fb;
    wmma::fragment<wmma::accumulator, kRows, 32, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    const bf16* a = hb_s + m * kRows * H;
    const bf16* b = w_hh + static_cast<size_t>(m) * H * 3 * H + col0;
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 16) {
      wmma::load_matrix_sync(fa, a + k0, H);
      wmma::load_matrix_sync(fb, b + static_cast<size_t>(k0) * 3 * H, 3 * H);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c, acc, 32, wmma::mem_row_major);
    __syncwarp();
    const float bias = __ldg(b_hh + m * 3 * H + col0 + lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      hw_s[(m * kRows + r) * 3 * H + col0 + lane] = __float2bfloat16_rn(c[r * 32 + lane] + bias);
    __syncwarp();
  }
}

// The three gates' node mixes and h' for every (row, hidden column): h_s and
// hb_s hold h' on return.  gc_s is bf16(G_t) widened to fp32.
template <int N, int H>
__device__ __forceinline__ void gate_update(const bf16* __restrict__ cx, int batch, int row0,
                                            const float* gc_s, const bf16* hw_s, float* h_s,
                                            bf16* hb_s) {
  constexpr int NP = (N + 3) / 4 * 4;
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int r = i / H, j = i % H, row = row0 + r;
    float pr[NP], pz[NP], xn[NP], hn[NP];
#pragma unroll
    for (int m = 0; m < NP; ++m) {
      pr[m] = pz[m] = xn[m] = hn[m] = 0.0f;
      if (m < N) {
        const bf16* w = hw_s + (m * kRows + r) * 3 * H + j;
        pr[m] = __bfloat162float(w[0]);
        pz[m] = __bfloat162float(w[H]);
        hn[m] = __bfloat162float(w[2 * H]);
        if (row < batch) {
          const bf16* c = cx + (static_cast<size_t>(m) * batch + row) * 3 * H + j;
          pr[m] += load_bf16(c);
          pz[m] += load_bf16(c + H);
          xn[m] = load_bf16(c + 2 * H);
        }
      }
    }
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
      const float4* gr = reinterpret_cast<const float4*>(gc_s + n * NP);
      float sr = 0.0f, sz = 0.0f, sx = 0.0f, sh = 0.0f;
#pragma unroll
      for (int q = 0; q < NP / 4; ++q) {
        const float4 g = gr[q];
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sr = fmaf(gv[e], pr[4 * q + e], sr);
          sz = fmaf(gv[e], pz[4 * q + e], sz);
          sx = fmaf(gv[e], xn[4 * q + e], sx);
          sh = fmaf(gv[e], hn[4 * q + e], sh);
        }
      }
      const float rg = bf16_round(sigmoid(sr)), zg = bf16_round(sigmoid(sz));
      const float cand = tanhf(sx + rg * sh);
      const int e = (n * kRows + r) * H + j;
      const float h_new = cand - cand * zg + zg * h_s[e];
      h_s[e] = h_new;
      hb_s[e] = __float2bfloat16_rn(h_new);
    }
  }
}

template <int N, int H, int F>
__global__ void __launch_bounds__(kThreads, 1)
gru_rollout_merged_kernel(const bf16* __restrict__ cx, const float* __restrict__ h0,
                          const bf16* __restrict__ w_hh, const float* __restrict__ b_hh,
                          const float* __restrict__ g0, const float* __restrict__ g_add,
                          const bf16* __restrict__ w_fc, const float* __restrict__ b_fc,
                          const float* __restrict__ g_fc, float* __restrict__ out, int batch,
                          int ph) {
  static_assert(H % 32 == 0, "the hidden product takes 32 columns a warp and 16 a k-step");
  using L = Layout<N, H, F>;
  constexpr int NP = L::NP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);                         // [N][kRows][H]
  bf16* hb_s = reinterpret_cast<bf16*>(smem + L::kH);                  // [N][kRows][H]
  bf16* hw_s = reinterpret_cast<bf16*>(smem + L::kH + L::kHb);         // [N][kRows][3H]
  float* scratch = reinterpret_cast<float*>(smem + L::kH + L::kHb + L::kHw);
  float* g_s = reinterpret_cast<float*>(smem + L::kH + L::kHb + L::kHw + L::kScratch);
  float* gc_s = g_s + N * NP;                                          // bf16(G_t)
  float* gadd_s = gc_s + N * NP;
  float* gfc_s = gadd_s + N * NP;
  float* q_s = gfc_s + N * NP;                                         // [N][kRows][F]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  for (int i = tid; i < N * kRows * H; i += kThreads) {
    const int m = i / (kRows * H), r = (i / H) % kRows, k = i % H, row = row0 + r;
    const float v = row < batch ? h0[(static_cast<size_t>(m) * batch + row) * H + k] : 0.0f;
    h_s[i] = v;
    hb_s[i] = __float2bfloat16_rn(v);
  }
  for (int i = tid; i < N * NP; i += kThreads) {
    const int n = i / NP, m = i % NP;
    const bool in = m < N;
    g_s[i] = in ? g0[n * N + m] : 0.0f;
    gc_s[i] = bf16_round(g_s[i]);
    gadd_s[i] = in ? g_add[n * N + m] : 0.0f;
    gfc_s[i] = in ? g_fc[n * N + m] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < ph; ++t) {
    hidden_product<N, H>(w_hh, b_hh, hb_s, hw_s, scratch);
    __syncthreads();
    gate_update<N, H>(cx, batch, row0, gc_s, hw_s, h_s, hb_s);
    __syncthreads();

    // output head before its mix: q[m][r][f] = b_fc[m][f] + bf16(h')[m][r]·W_fc[m][:, f]
    for (int i = tid; i < N * kRows * F; i += kThreads) {
      const int m = i / (kRows * F), r = (i / F) % kRows, f = i % F;
      const bf16* hm = hb_s + (m * kRows + r) * H;
      const bf16* w = w_fc + static_cast<size_t>(m) * H * F + f;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(__bfloat162float(hm[k]), load_bf16(w + k * F), acc);
      q_s[i] = acc + __ldg(b_fc + m * F + f);
    }
    // G_{t+1} = l1norm_rows(G_t + G_add), the row norm clipped at 1e-12
    for (int n = tid; n < N; n += kThreads) {
      float* g = g_s + n * NP;
      const float* ga = gadd_s + n * NP;
      float s = 0.0f;
      for (int m = 0; m < N; ++m) s += fabsf(g[m] + ga[m]);
      const float norm = fmaxf(s, 1e-12f);
      for (int m = 0; m < N; ++m) {
        g[m] = (g[m] + ga[m]) / norm;
        gc_s[n * NP + m] = bf16_round(g[m]);
      }
    }
    __syncthreads();

    // y_t = tanh(G_fc · q): each node's 8 rows × F outputs are contiguous
    for (int i = tid; i < N * kRows * F; i += kThreads) {
      const int n = i / (kRows * F), r = (i / F) % kRows, f = i % F, row = row0 + r;
      float acc = 0.0f;
      for (int m = 0; m < N; ++m) acc = fmaf(gfc_s[n * NP + m], q_s[(m * kRows + r) * F + f], acc);
      if (row < batch) out[((static_cast<size_t>(t) * N + n) * batch + row) * F + f] = tanhf(acc);
    }
    // the next writes of q_s, g_s and gc_s come after the next step's barriers
  }
}

template <int N, int H, int F>
cudaError_t launch(const bf16* cx, const float* h0, const bf16* w_hh, const float* b_hh,
                   const float* g0, const float* g_add, const bf16* w_fc, const float* b_fc,
                   const float* g_fc, float* out, int batch, int ph, cudaStream_t stream) {
  constexpr size_t bytes = Layout<N, H, F>::kBytes;
  static_assert(bytes <= 232448, "227 KB of dynamic shared memory a block");
  cudaError_t err = cudaFuncSetAttribute(gru_rollout_merged_kernel<N, H, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kRows - 1) / kRows);
  gru_rollout_merged_kernel<N, H, F><<<grid, kThreads, bytes, stream>>>(
      cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, out, batch, ph);
  return cudaGetLastError();
}

}  // namespace

// Shapes as in the header comment; cx, w_hh and w_fc bfloat16, the rest
// float32, all contiguous.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the library does not instantiate).
extern "C" int gru_rollout_bf16(const void* cx, const float* h0, const void* w_hh,
                                const float* b_hh, const float* g0, const float* g_add,
                                const void* w_fc, const float* b_fc, const float* g_fc,
                                float* out, int n_nodes, int batch, int hidden, int f_out, int ph,
                                void* stream) {
  if (batch <= 0 || ph <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes == 21 && hidden == 96 && f_out == 3) {
    return static_cast<int>(launch<21, 96, 3>(
        static_cast<const bf16*>(cx), h0, static_cast<const bf16*>(w_hh), b_hh, g0, g_add,
        static_cast<const bf16*>(w_fc), b_fc, g_fc, out, batch, ph, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
