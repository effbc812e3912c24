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
// What the design does about it: a block owns a tile of rows of all 21
// nodes, so every input crosses device memory once and every output is
// written once; the intermediates (h, o, the 768-wide qkv) stay in the
// block.
//
// * B9a runs on node_mix_sm90.cuh's engine (`run_blocks`), as B9c does:
//   three product passes through the k-slice ring, the stem from x's rows,
//   then B1's two in place in P, each followed by a tensor-core mix.  The
//   stem's contraction of 96 runs as two k-slices of 64: the producer
//   zero-fills x's columns 96–127 (Input::kNarrow, never reading past x's
//   last column) against a bank packed with rows 96–127 zero, so the plan
//   is B9c's.  The stem pass adds u after the bias (`product<true>`), as
//   the plain version sums; after its plain mix P (r) goes to r_out, which
//   the block's last mix reads back as its residual, as B9c reads o.  That
//   first stage is B4's body (BlockItem::stem, graph_linear_fused.cu), so r
//   is B4's output bit for bit.  Each weight byte from L2 serves the
//   cluster's 32 rows.
// * B9c runs on node_mix_sm90.cuh's engine (`run_blocks`), as B1 does
//   (resnet_block.cu): items of 16 rows (fp32: 8) × all 192 columns, three
//   product passes through the k-slice ring (the out-projection from a's
//   rows, then B1's two in place in P), each followed by a tensor-core mix.
//   o and P do not both fit in 227 KB (P alone is 135 KB), so after the
//   first mix o goes from P into out as the residual; the last mix reads
//   each element of o there before the barrier that ends it, and the store
//   after that barrier overwrites it.  Shared memory (bf16) as B1's,
//   217 088 B; the out-projection's 256-wide rows run as four k-slices.
//   Each weight byte from L2 serves 32 rows: 2.06 GB of weights a call,
//   4.1 GB before.  A block's item takes ~340 000 cycles: the products 58%
//   (a fifth of it waiting on the ring), the three mixes 35%, the two
//   stores 4% (PERF.md §6).
// * B9b runs on node_mix_sm90.cuh's engine, as B3a (attention_proj.cu)
//   does: items of 32 rows × one head's 96 q‖k‖v columns (fp32: 8 rows),
//   the two blocks of a cluster on adjacent row tiles, each weight tile
//   multicast to both; per item the 21 × 32 × 96 products are mixed in
//   place, then the head's attention runs with a warp per row on the tensor
//   cores (B2's body, joint_attention.cuh's head_attention_mma; fp32: a lane
//   per query joint), 32 output columns, staged in the row's q columns of P.
//   The head's columns are packed into one tile by the wrapper.  Shared memory (bf16, F = 192):
//   227 840 B; a 64-row tile would need 258 KB for P alone.  Each weight
//   byte from L2 serves 64 rows (16 before): L2 → shared memory traffic a
//   call is 1.24 GB of weights plus 8 heads × 103 MB of rows, 2.07 GB
//   against ~5.0 GB.  With the CUDA-core body (head_attention) a block spent
//   41% of its time in the attention, 24% normalising, 23% in the products
//   (PERF.md §6).  It computes the same bits as B3a followed by B2.

#include <cmath>

#include "joint_attention.cuh"
#include "node_mix_sm90.cuh"

namespace {

using namespace nodemix;

constexpr int kDimHead = 32;
constexpr int kHeadCols = 3 * kDimHead;  // a head's q‖k‖v columns

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
stem_block_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ film,
                  const T* __restrict__ ws, const T* __restrict__ bs, const T* __restrict__ gs,
                  const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ g1,
                  const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ g2,
                  T* r_out, T* __restrict__ out, int rows, int d, int kd, int f, int kslice,
                  int stages) {
  constexpr int R = sm90mix::BlockRows<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  sm90mix::BlockProblem<T> pb{
      {{x, ws, bs, kd}, {nullptr, w1, b1, f}, {nullptr, w2, b2, f}}, {gs, g1, g2}, film, 3,
      rows, f, kslice, stages};
  pb.a_cols = d;
  sm90mix::run_blocks<T, R, NT, sm90mix::Input::kNarrow>(
      pb, smem_raw, [&](auto& it) { it.stem_block(u, r_out, out); });
}

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
outproj_block_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     const T* __restrict__ film, const T* __restrict__ wo,
                     const T* __restrict__ go, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ g1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const T* __restrict__ g2, T* out, int rows, int hd, int f, int kslice,
                     int stages) {
  constexpr int R = sm90mix::BlockRows<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::BlockProblem<T> pb{
      {{a, wo, nullptr, hd}, {nullptr, w1, b1, f}, {nullptr, w2, b2, f}}, {go, g1, g2}, film, 3,
      rows, f, kslice, stages};
  sm90mix::run_blocks<T, R, NT>(pb, smem_raw, [&](auto& it) {
    // o = round(G_out·round(a·W_out) + x) (B3b's body): in P, the block's
    // input, and in out, its residual
    it.outproj_res(x, out);
    // each element of o in out is read before the barrier that ends the
    // block's last mix, and overwritten after it
    it.resnet_block(1, out);
    it.store(out);
  });
}

// B9b's rows an item (the columns are a head's q‖k‖v).  Past 21 nodes
// (AMASS-MANO's 51) 8 rows, a half-empty m16 tile of the products: P of 51 ×
// 8 × 96 bf16 is 79 KB (16 rows need 244 KB with two stages).
template <typename T>
struct CoreTile;
template <>
struct CoreTile<bf16> {
  static constexpr int kRows = kWide ? 8 : 32;
};
template <>
struct CoreTile<float> {
  static constexpr int kRows = 8;  // an fp32 weight tile takes 73.7 KB a stage
};

template <typename T>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
rms_qkv_core_kernel(const T* __restrict__ x, const T* __restrict__ g_rms,
                    const T* __restrict__ w, const T* __restrict__ g, T* __restrict__ out,
                    int rows, int f, int heads, int stages, float scale) {
  constexpr int R = CoreTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::Problem<T> pb{x, g_rms, w, g, rows, f, heads, stages};
  const int hd = heads * kDimHead;
  sm90mix::run<T, R, kHeadCols>(
      pb, smem_raw, [&](T* p, int plane, int b0, int valid, int h) {
        // warp r takes rows r, r + 8, …
        for (int r = threadIdx.x >> 5; r < valid; r += sm90mix::kConsumerWarps) {
          T* row = p + r * kHeadCols;
          T* o = out + at(0, rows, b0 + r, hd, h * kDimHead);
          if constexpr (kTensorCoreBody<T>) {
            head_attention_mma(row, row + kDimHead, row + 2 * kDimHead, plane, scale, o,
                               static_cast<size_t>(rows) * hd, smem_raw + sm90mix::kZeroOffset);
          } else {
            head_attention<T, kNodes, kDimHead>(row, row + kDimHead, row + 2 * kDimHead, plane,
                                                scale, o, static_cast<size_t>(rows) * hd);
          }
        }
      });
}

// The wrapper's tile plan (rows, k-slice, stages, cluster, shared-memory
// bytes) must be the one instantiated here, with the stem's contraction d
// (a multiple of 8) padded to kd, the next multiple of 64; bf16 is
// instantiated for each f = 64·NT the plan takes.
template <typename T>
int launch_stem_block(const void* x, const void* u, const void* film, const void* ws,
                      const void* bs, const void* gs, const void* w1, const void* b1,
                      const void* g1, const void* w2, const void* b2, const void* g2, void* r_out,
                      void* out, int n_nodes, int rows, int d, int f, int tile_rows, int kslice,
                      int stages, int cluster, int smem_bytes, void* stream) {
  const int kd = (d + 63) / 64 * 64;
  const int ks[3] = {kd, f, f};
  if (n_nodes != kNodes || rows <= 0 || d <= 0 || d % 8 ||
      !sm90mix::block_plan_ok<T>(f, ks, 3, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(
        stem_block_kernel<T, decltype(nt)::value>, sm90mix::items(rows, tile_rows, 1),
        smem_bytes, cluster, stream, static_cast<const T*>(x), static_cast<const T*>(u),
        static_cast<const T*>(film), static_cast<const T*>(ws), static_cast<const T*>(bs),
        static_cast<const T*>(gs), static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(g1), static_cast<const T*>(w2), static_cast<const T*>(b2),
        static_cast<const T*>(g2), static_cast<T*>(r_out), static_cast<T*>(out), rows, d, kd, f,
        kslice, stages);
  }));
}

// The wrapper's tile plan (rows, columns, stages, cluster, shared-memory
// bytes) must be the one instantiated here.
template <typename T>
int launch_rms_qkv_core(const void* x, const void* g_rms, const void* w, const void* g, void* out,
                        int n_nodes, int rows, int f, int heads, int dim_head, int tile_rows,
                        int tile_cols, int stages, int cluster, int smem_bytes, void* stream) {
  constexpr int R = CoreTile<T>::kRows;
  if (n_nodes != kNodes || rows <= 0 || f <= 0 || f % 32 ||
      f > sm90mix::kMaxF || heads <= 0 ||
      dim_head != kDimHead ||
      tile_rows != R || tile_cols != kHeadCols || stages < 2 || stages > sm90mix::kMaxStages ||
      cluster != sm90mix::kCluster ||
      static_cast<size_t>(smem_bytes) != sm90mix::layout<T>(R, kHeadCols, f, stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::launch(
      rms_qkv_core_kernel<T>, sm90mix::items(rows, R, heads), smem_bytes, cluster, stream,
      static_cast<const T*>(x), static_cast<const T*>(g_rms), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(out), rows, f, heads, stages,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDimHead)))));
}

// The wrapper's tile plan (rows, k-slice, stages, cluster, shared-memory
// bytes) must be the one instantiated here; bf16 is instantiated for each
// f = 64·NT the plan takes.
template <typename T>
int launch_outproj_block(const void* a, const void* x, const void* film, const void* wo,
                         const void* go, const void* w1, const void* b1, const void* g1,
                         const void* w2, const void* b2, const void* g2, void* out, int n_nodes,
                         int rows, int hd, int f, int tile_rows, int kslice, int stages,
                         int cluster, int smem_bytes, void* stream) {
  const int ks[3] = {hd, f, f};
  if (n_nodes != kNodes || rows <= 0 ||
      !sm90mix::block_plan_ok<T>(f, ks, 3, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(
        outproj_block_kernel<T, decltype(nt)::value>, sm90mix::items(rows, tile_rows, 1),
        smem_bytes, cluster, stream, static_cast<const T*>(a), static_cast<const T*>(x),
        static_cast<const T*>(film), static_cast<const T*>(wo), static_cast<const T*>(go),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(g1),
        static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(g2),
        static_cast<T*>(out), rows, hd, f, kslice, stages);
  }));
}

}  // namespace

// All tensors of one element type, contiguous, 32-byte aligned; activations
// node-major [n_nodes, rows, ·], banks [n_nodes, in, out], biases
// [n_nodes, out], influences [n_nodes, n_nodes], film [2f].  Each entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// shapes not instantiated.

// x [·, rows, d], u, r_out, out [·, rows, f]; ws [·, d, f] zero-padded to
// [·, kd, f] (kd: d rounded up to 64) and w1, w2 [·, f, f] packed into one
// tile of all f columns each, [·, 1, kd·f] and [·, 1, f·f]
// (ops/kernels/node_mix_sm90.py); the tile plan
// (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int stem_block_bf16(const void* x, const void* u, const void* film, const void* ws,
                               const void* bs, const void* gs, const void* w1, const void* b1,
                               const void* g1, const void* w2, const void* b2, const void* g2,
                               void* r_out, void* out, int n_nodes, int rows, int d, int f,
                               int tile_rows, int kslice, int stages, int cluster, int smem_bytes,
                               void* stream) {
  return launch_stem_block<nodemix::bf16>(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2, r_out,
                                          out, n_nodes, rows, d, f, tile_rows, kslice, stages,
                                          cluster, smem_bytes, stream);
}
extern "C" int stem_block_f32(const void* x, const void* u, const void* film, const void* ws,
                              const void* bs, const void* gs, const void* w1, const void* b1,
                              const void* g1, const void* w2, const void* b2, const void* g2,
                              void* r_out, void* out, int n_nodes, int rows, int d, int f,
                              int tile_rows, int kslice, int stages, int cluster, int smem_bytes,
                              void* stream) {
  return launch_stem_block<float>(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2, r_out, out,
                                  n_nodes, rows, d, f, tile_rows, kslice, stages, cluster,
                                  smem_bytes, stream);
}

// x [·, rows, f], g_rms [f], g [·, ·], out [·, rows, heads·dim_head]; w is
// W_qkv [·, f, 3·heads·dim_head] (q‖k‖v) packed into one tile of a head's
// q, k and v columns each, [·, heads, f·3·dim_head] (ops/kernels/node_mix_sm90.py).
extern "C" int rms_qkv_core_bf16(const void* x, const void* g_rms, const void* w, const void* g,
                                 void* out, int n_nodes, int rows, int f, int heads, int dim_head,
                                 int tile_rows, int tile_cols, int stages, int cluster,
                                 int smem_bytes, void* stream) {
  return launch_rms_qkv_core<nodemix::bf16>(x, g_rms, w, g, out, n_nodes, rows, f, heads,
                                            dim_head, tile_rows, tile_cols, stages, cluster,
                                            smem_bytes, stream);
}
extern "C" int rms_qkv_core_f32(const void* x, const void* g_rms, const void* w, const void* g,
                                void* out, int n_nodes, int rows, int f, int heads, int dim_head,
                                int tile_rows, int tile_cols, int stages, int cluster,
                                int smem_bytes, void* stream) {
  return launch_rms_qkv_core<float>(x, g_rms, w, g, out, n_nodes, rows, f, heads, dim_head,
                                    tile_rows, tile_cols, stages, cluster, smem_bytes, stream);
}

// a [·, rows, hd], x and out [·, rows, f]; w_out [·, hd, f] and w1, w2
// [·, f, f] packed into one tile of all f columns each, [·, 1, hd·f] and
// [·, 1, f·f] (ops/kernels/node_mix_sm90.py); the tile plan
// (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int outproj_block_bf16(const void* a, const void* x, const void* film,
                                  const void* w_out, const void* g_out, const void* w1,
                                  const void* b1, const void* g1, const void* w2, const void* b2,
                                  const void* g2, void* out, int n_nodes, int rows, int hd, int f,
                                  int tile_rows, int kslice, int stages, int cluster,
                                  int smem_bytes, void* stream) {
  return launch_outproj_block<nodemix::bf16>(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2,
                                             out, n_nodes, rows, hd, f, tile_rows, kslice, stages,
                                             cluster, smem_bytes, stream);
}
extern "C" int outproj_block_f32(const void* a, const void* x, const void* film,
                                 const void* w_out, const void* g_out, const void* w1,
                                 const void* b1, const void* g1, const void* w2, const void* b2,
                                 const void* g2, void* out, int n_nodes, int rows, int hd, int f,
                                 int tile_rows, int kslice, int stages, int cluster,
                                 int smem_bytes, void* stream) {
  return launch_outproj_block<float>(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2, out,
                                     n_nodes, rows, hd, f, tile_rows, kslice, stages, cluster,
                                     smem_bytes, stream);
}
