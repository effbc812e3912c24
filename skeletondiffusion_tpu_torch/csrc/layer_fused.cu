// The denoiser's per-layer kernels, bf16 and fp32, for NVIDIA Hopper
// (sm_90a): each composes the bodies of two or three single-stage kernels,
// so that what passes between them stays in shared memory.
//
// Replaces skeletondiffusion_tpu/ops/pallas/layer_fused.py:
//   stem_block_pallas    (_stem_block_kernel)     → stem_block_*      (B9a)
//   rms_qkv_core_pallas  (_rms_qkv_core_kernel)   → rms_qkv_core_*    (B9b)
//   outproj_block_pallas (_outproj_block_kernel)  → outproj_block_*   (B9c)
//
// Over node-major activations, rounding where the Pallas kernels do (they
// round where the single-stage kernels round):
//
//   B9a: r   = round(Gs·round(x·Ws + bs + u))                  (B4)
//        out = ResnetBlock(r)                                   (B1)
//   B9b: h   = round(x / sqrt(max(Σ x², 1e-24)) · g_rms)       (B3a)
//        qkv = round(G_qkv·round(h·W_qkv))
//        out = attention of each head over the joints           (B2)
//   B9c: o   = round(G_out·round(a·W_out) + x)                 (B3b)
//        out = ResnetBlock(o)                                   (B1)
//
// with ResnetBlock(o) = round(tanh(G2·round(h·W2 + b2)) + o),
// h = round(tanh(FiLM(G1·round(o·W1 + b1)))), FiLM(y) = y·(scale+1) + shift.
//
// What bounds them on the H100: memory.  At N=21, B=12 800, D=96, F=192,
// 8 heads × 32 in bf16: B9a moves ~361 MB (0.108 ms) against ~56 GFLOP of
// products and mixes (0.057 ms on the tensor cores), B9b ~241 MB (0.072 ms)
// against ~94 GFLOP (0.095 ms: the products bind), B9c ~344 MB (0.103 ms)
// against ~73 GFLOP (0.074 ms).
//
// What the design does about it: as in node_mix.cuh, a block owns 16 rows
// (8 in fp32) of all 21 nodes, so every input crosses device memory once and
// every output is written once; the intermediates (r's second use, o, h,
// the 768-wide qkv) stay in the block.
//
// * B9a and B9c run the stem or the out-projection into the product tile P
//   (21 × 16 × 192 bf16, 129 KB), mix it in place, then B1's body on P.  B1
//   reads its residual back from device memory after its last mix; so do
//   these.  B9a's residual is r, which it writes as an output anyway.  B9c's
//   residual o is not an output, and o and P do not both fit in 227 KB
//   (258 KB): B9c writes o into its output buffer, and the last epilogue
//   reads each element there before it overwrites it.  The two mixes map a
//   (row, column) to the same thread, so the thread that reads an element is
//   the one that wrote it.  Chosen over 8-row tiles, which would halve the
//   rows of every tensor-core tile; the cost is 16 KB of extra writes and
//   reads per block through L2.
// * B9b normalises the tile's input once and keeps it in shared memory (129
//   KB); the full qkv of the tile (516 KB) cannot stay.  The node mix is per
//   column and the attention per head, so it works one head at a time: the
//   head's 3 × 32 q, k, v columns for all 21 nodes (64.5 KB), mixed in
//   place, then the head's attention with a warp per row and a lane per
//   query joint (joint_attention.cuh, B2's body), 32 output columns.  The
//   head's columns are read from w_qkv [N, F, 3·hd] where they lie (q at
//   h·dh, k at hd + h·dh, v at 2·hd + h·dh), so no reordered copy is needed.

#include <cmath>

#include "joint_attention.cuh"
#include "node_mix.cuh"

namespace {

using namespace nodemix;

constexpr int kDimHead = 32;
constexpr int kHeadCols = 3 * kDimHead;  // a head's q‖k‖v columns

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_block_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ film,
                  const T* __restrict__ ws, const T* __restrict__ bs, const T* __restrict__ gs,
                  const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ g1,
                  const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ g2,
                  T* r_out, T* __restrict__ out, int rows, int d, int f) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm = Smem<T>::carve(smem_raw, f, max(d, f), 3);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  float* gss = sm.g;
  float* g1s = sm.g + kNodes * kGStride;
  float* g2s = sm.g + 2 * kNodes * kGStride;
  load_influence(gss, gs);
  load_influence(g1s, g1);
  load_influence(g2s, g2);
  load_film(sm.vec, film, f);

  T* p = sm.p;
  node_products(
      [&](int n, T* buf) { stage_rows(buf, d, 0, x + at(n, rows, b0, d, 0), d, valid); },
      AsStaged{}, sm.s, d, ws, f, f, sm.scratch,
      [&](int n, int r, int c, float acc) {
        float h = acc + to_f(bs[n * f + c]);
        if (r < valid) h += to_f(u[at(n, rows, b0 + r, f, c)]);
        p[(n * R + r) * f + c] = from_f<T>(h);
      });
  node_mix(p, f, f, gss, [&](int n, int r, int c, float y) {
    const T v = from_f<T>(y);
    p[(n * R + r) * f + c] = v;
    if (r < valid) r_out[at(n, rows, b0 + r, f, c)] = v;
  });
  resnet_block_body(sm, [&](int n, T* buf) { stage_from_p(buf, p, f, n, f); }, g1s, g2s, w1,
                    b1, w2, b2, r_out, out, rows, b0, valid, f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
outproj_block_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     const T* __restrict__ film, const T* __restrict__ wo,
                     const T* __restrict__ go, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ g1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const T* __restrict__ g2, T* out, int rows, int hd, int f) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm = Smem<T>::carve(smem_raw, f, max(hd, f), 3);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  float* gos = sm.g;
  float* g1s = sm.g + kNodes * kGStride;
  float* g2s = sm.g + 2 * kNodes * kGStride;
  load_influence(gos, go);
  load_influence(g1s, g1);
  load_influence(g2s, g2);
  load_film(sm.vec, film, f);

  T* p = sm.p;
  node_products(
      [&](int n, T* buf) { stage_rows(buf, hd, 0, a + at(n, rows, b0, hd, 0), hd, valid); },
      AsStaged{}, sm.s, hd, wo, f, f, sm.scratch,
      [&](int n, int r, int c, float acc) { p[(n * R + r) * f + c] = from_f<T>(acc); });
  // o = round(G_out·P + x): into P as the block's input and, for the valid
  // rows, into out as its residual
  node_mix(p, f, f, gos, [&](int n, int r, int c, float y) {
    const size_t i = at(n, rows, b0 + r, f, c);
    const T o = from_f<T>(y + (r < valid ? to_f(x[i]) : 0.0f));
    p[(n * R + r) * f + c] = o;
    if (r < valid) out[i] = o;
  });
  resnet_block_body(sm, [&](int n, T* buf) { stage_from_p(buf, p, f, n, f); }, g1s, g2s, w1,
                    b1, w2, b2, out, out, rows, b0, valid, f);
}

// Shared memory of the B9b block: xn [N][kRows][f] T (the normalised input),
// qkv [N][kRows][kHeadCols] T (one head's mixed q‖k‖v), scratch
// [kWarps][kRows·16] float, g [N][kGStride] float.
template <typename T>
struct CoreSmem {
  T* xn;
  T* qkv;
  float* scratch;
  float* g;

  __host__ __device__ static size_t up(size_t bytes) { return (bytes + 127) & ~size_t(127); }

  __host__ __device__ static size_t bytes(int f) {
    constexpr int R = RowTile<T>::kRows;
    return up(sizeof(T) * kNodes * R * f) + up(sizeof(T) * kNodes * R * kHeadCols) +
           up(sizeof(float) * kWarps * R * 16) + up(sizeof(float) * kNodes * kGStride);
  }

  __device__ static CoreSmem carve(unsigned char* base, int f) {
    constexpr int R = RowTile<T>::kRows;
    CoreSmem m;
    size_t off = 0;
    m.xn = reinterpret_cast<T*>(base + off);
    off += up(sizeof(T) * kNodes * R * f);
    m.qkv = reinterpret_cast<T*>(base + off);
    off += up(sizeof(T) * kNodes * R * kHeadCols);
    m.scratch = reinterpret_cast<float*>(base + off);
    off += up(sizeof(float) * kWarps * R * 16);
    m.g = reinterpret_cast<float*>(base + off);
    return m;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rms_qkv_core_kernel(const T* __restrict__ x, const T* __restrict__ g_rms,
                    const T* __restrict__ w, const T* __restrict__ g, T* __restrict__ out,
                    int rows, int f, int heads, float scale) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const CoreSmem<T> sm = CoreSmem<T>::carve(smem_raw, f);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = heads * kDimHead, fo = 3 * hd;
  load_influence(sm.g, g);
  for (int n = 0; n < kNodes; ++n)
    stage_rows(sm.xn + n * R * f, f, 0, x + at(n, rows, b0, f, 0), f, valid);
  __syncthreads();
  normalize_rows(sm.xn, g_rms, f, kNodes * R);

  constexpr int kTiles = kHeadCols / 16;  // 16-column tiles of a head's q‖k‖v
  float* c = sm.scratch + warp * R * 16;
  for (int h = 0; h < heads; ++h) {
    // the head's products: tile t is columns (t%2)·16 … of part t/2 (q, k, v)
    for (int task = warp; task < kNodes * kTiles; task += kWarps) {
      const int n = task / kTiles, t = task % kTiles;
      const int col = (t >> 1) * hd + h * kDimHead + (t & 1) * 16;
      warp_tile_product(sm.xn + n * R * f, f, w + static_cast<size_t>(n) * f * fo + col, fo, f, c);
      __syncwarp();
      for (int e = lane; e < R * 16; e += 32)
        sm.qkv[(n * R + (e >> 4)) * kHeadCols + t * 16 + (e & 15)] = from_f<T>(c[e]);
      __syncwarp();
    }
    __syncthreads();
    node_mix(sm.qkv, kHeadCols, kHeadCols, sm.g, [&](int n, int r, int col, float y) {
      sm.qkv[(n * R + r) * kHeadCols + col] = from_f<T>(y);
    });
    // the head's attention: warp r takes row r, lane n query joint n
    if (warp < valid) {
      const T* row = sm.qkv + warp * kHeadCols;
      head_attention<T, kNodes, kDimHead>(row, row + kDimHead, row + 2 * kDimHead,
                                          R * kHeadCols, scale,
                                          out + at(0, rows, b0 + warp, hd, h * kDimHead),
                                          static_cast<size_t>(rows) * hd);
    }
    __syncthreads();
  }
}

bool bad_block_shape(int n_nodes, int rows, int k, int f) {
  return n_nodes != kNodes || rows <= 0 || k <= 0 || k % 32 || f <= 0 || f % 32;
}

template <typename T>
int launch_stem_block(const void* x, const void* u, const void* film, const void* ws,
                      const void* bs, const void* gs, const void* w1, const void* b1,
                      const void* g1, const void* w2, const void* b2, const void* g2, void* r_out,
                      void* out, int n_nodes, int rows, int d, int f, void* stream) {
  if (bad_block_shape(n_nodes, rows, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem<T>::bytes(f, d > f ? d : f, 3, 2 * f);
  cudaError_t err = prepare(stem_block_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_block_kernel<T><<<grid_for<T>(rows), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<const T*>(film),
      static_cast<const T*>(ws), static_cast<const T*>(bs), static_cast<const T*>(gs),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(g1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(g2),
      static_cast<T*>(r_out), static_cast<T*>(out), rows, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rms_qkv_core(const void* x, const void* g_rms, const void* w, const void* g, void* out,
                        int n_nodes, int rows, int f, int heads, int dim_head, void* stream) {
  if (n_nodes != kNodes || rows <= 0 || f <= 0 || f % 32 || heads <= 0 || dim_head != kDimHead)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = CoreSmem<T>::bytes(f);
  cudaError_t err = prepare(rms_qkv_core_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_qkv_core_kernel<T><<<grid_for<T>(rows), kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_rms), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(out), rows, f, heads,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDimHead))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_outproj_block(const void* a, const void* x, const void* film, const void* wo,
                         const void* go, const void* w1, const void* b1, const void* g1,
                         const void* w2, const void* b2, const void* g2, void* out, int n_nodes,
                         int rows, int hd, int f, void* stream) {
  if (bad_block_shape(n_nodes, rows, hd, f)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem<T>::bytes(f, hd > f ? hd : f, 3, 2 * f);
  cudaError_t err = prepare(outproj_block_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  outproj_block_kernel<T><<<grid_for<T>(rows), kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const T*>(film),
      static_cast<const T*>(wo), static_cast<const T*>(go), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(g1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(g2), static_cast<T*>(out), rows, hd, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors of one element type, contiguous, 32-byte aligned; activations
// node-major [n_nodes, rows, ·], banks [n_nodes, in, out], biases
// [n_nodes, out], influences [n_nodes, n_nodes], film [2f].  Each entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// shapes not instantiated.

// x [·, rows, d], u, r_out, out [·, rows, f]; ws [·, d, f]; w1, w2 [·, f, f].
extern "C" int stem_block_bf16(const void* x, const void* u, const void* film, const void* ws,
                               const void* bs, const void* gs, const void* w1, const void* b1,
                               const void* g1, const void* w2, const void* b2, const void* g2,
                               void* r_out, void* out, int n_nodes, int rows, int d, int f,
                               void* stream) {
  return launch_stem_block<nodemix::bf16>(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2, r_out,
                                          out, n_nodes, rows, d, f, stream);
}
extern "C" int stem_block_f32(const void* x, const void* u, const void* film, const void* ws,
                              const void* bs, const void* gs, const void* w1, const void* b1,
                              const void* g1, const void* w2, const void* b2, const void* g2,
                              void* r_out, void* out, int n_nodes, int rows, int d, int f,
                              void* stream) {
  return launch_stem_block<float>(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2, r_out, out,
                                  n_nodes, rows, d, f, stream);
}

// x [·, rows, f], g_rms [f], w [·, f, 3·heads·dim_head] (q‖k‖v), out
// [·, rows, heads·dim_head].
extern "C" int rms_qkv_core_bf16(const void* x, const void* g_rms, const void* w, const void* g,
                                 void* out, int n_nodes, int rows, int f, int heads, int dim_head,
                                 void* stream) {
  return launch_rms_qkv_core<nodemix::bf16>(x, g_rms, w, g, out, n_nodes, rows, f, heads,
                                            dim_head, stream);
}
extern "C" int rms_qkv_core_f32(const void* x, const void* g_rms, const void* w, const void* g,
                                void* out, int n_nodes, int rows, int f, int heads, int dim_head,
                                void* stream) {
  return launch_rms_qkv_core<float>(x, g_rms, w, g, out, n_nodes, rows, f, heads, dim_head,
                                    stream);
}

// a [·, rows, hd], x and out [·, rows, f], w_out [·, hd, f]; w1, w2 [·, f, f].
extern "C" int outproj_block_bf16(const void* a, const void* x, const void* film,
                                  const void* w_out, const void* g_out, const void* w1,
                                  const void* b1, const void* g1, const void* w2, const void* b2,
                                  const void* g2, void* out, int n_nodes, int rows, int hd, int f,
                                  void* stream) {
  return launch_outproj_block<nodemix::bf16>(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2,
                                             out, n_nodes, rows, hd, f, stream);
}
extern "C" int outproj_block_f32(const void* a, const void* x, const void* film,
                                 const void* w_out, const void* g_out, const void* w1,
                                 const void* b1, const void* g1, const void* w2, const void* b2,
                                 const void* g2, void* out, int n_nodes, int rows, int hd, int f,
                                 void* stream) {
  return launch_outproj_block<float>(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2, out,
                                     n_nodes, rows, hd, f, stream);
}
