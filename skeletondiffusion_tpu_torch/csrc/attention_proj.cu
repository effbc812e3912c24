// The attention layer's two projection stages, bf16 and fp32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/attention_proj.py:
//   rms_qkv_pallas     (_rms_qkv_kernel)      → rms_qkv_*
//   outproj_res_pallas (_outproj_res_kernel)  → outproj_res_*
//
// Over node-major activations, rounding where the Pallas kernels do:
//
//   B3a: h   = round(x / sqrt(max(Σ x², 1e-24)) · g_rms)     (g_rms holds √F)
//        qkv = round(G_qkv·round(h·W_qkv))                   [N,B,F] → [N,B,3·hd]
//   B3b: out = round(G_out·round(a·W_out) + x)              [N,B,hd] → [N,B,F]
//
// What bounds them on the H100: memory.  At N=21, B=12 800, F=192, hd=256 in
// bf16, B3a moves ~516 MB against ~88 GFLOP (0.154 ms against 0.089 ms on
// the tensor cores) and B3b ~344 MB against ~55 GFLOP (0.103 ms against
// 0.056 ms).
//
// B3a runs on node_mix_sm90.cuh's engine, as B9b (layer_fused.cu) does:
// items of 32 rows × 96 of the 768 output columns (8 column groups; fp32:
// 8 rows), the two blocks of a cluster on adjacent row tiles; per item and
// node one bulk copy of the 32 input rows and half of the packed 192 × 96
// weight tile each block, multicast to both; normalisation in place,
// mma.sync products and the tensor-core mix from shared memory, 16-byte
// stores.  Shared memory (bf16, F = 192): P 21 × (32·96·2 + 16) B =
// 129.4 KB, two stages of 12.3 KB rows + 36.9 KB weights and the barriers:
// 227 840 B of the 232 448 a block may have; one block an SM.  Each weight
// byte from L2 serves 64 rows (16 in the first design, whose 16-row blocks
// read their weight tiles straight from L2), each input row 96
// columns (256): L2 → shared memory traffic a call is 200 row pairs ×
// 6.19 MB of weights (1.24 GB) plus 8 column groups × 103 MB of rows
// (0.83 GB), 2.07 GB against ~5.3 GB.  The card then spends a block's time
// normalising (39%: each row tile once per column group) and in the
// products (36%), not waiting on loads (7%); 1.07 ms, 6.9× the bound
// (PERF.md §6).
//
// B3b runs on the engine's whole-row items (`run_blocks`) with B9c's first
// stage as its body (BlockItem::outproj_res): items of 16 rows (fp32: 8) ×
// all 192 columns, the two blocks of a cluster on adjacent row tiles; per
// node and k-slice of 64 bank rows (fp32: 32) a ring stage holds the k-slice
// of the 16 rows of a (cp.async) and half of W_out's k-slice from each block,
// multicast to both; mma.sync products into P, the tensor-core mix with the
// residual x added in registers, 16-byte stores.  Shared memory (bf16): as
// B1's, 217 088 B.  Each weight byte from L2 serves the cluster's 32 rows:
// 0.83 GB of weights a call where the first design, with each 16-row block
// staging the whole W_out (2.06 MB) for itself, read 1.65 GB.

#include "node_mix_sm90.cuh"

namespace {

using namespace nodemix;

// B3a's tiles: rows an item, output columns a group.  Past 21 nodes
// (AMASS-MANO's 51) 16 rows × 64 columns: P of 51 × 16 × 64 bf16 is 105 KB
// (32 × 96 would be 313 KB, 16 × 96 needs 244 KB with two stages).
template <typename T>
struct QkvTile;
template <>
struct QkvTile<bf16> {
  static constexpr int kRows = kWide ? 16 : 32, kCols = kWide ? 64 : 96;
};
template <>
struct QkvTile<float> {
  static constexpr int kRows = 8, kCols = 96;  // an fp32 weight tile takes 73.7 KB a stage
};

template <typename T>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
rms_qkv_kernel(const T* __restrict__ x, const T* __restrict__ g_rms, const T* __restrict__ w,
               const T* __restrict__ g, T* __restrict__ out, int rows, int f, int fo, int groups,
               int stages) {
  constexpr int R = QkvTile<T>::kRows, C = QkvTile<T>::kCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::Problem<T> pb{x, g_rms, w, g, rows, f, groups, stages};
  sm90mix::run<T, R, C>(
      pb, smem_raw, [&](const T* p, int plane, int b0, int valid, int grp) {
        sm90mix::store_tile<T, R, C>(p, plane, out, rows, fo, b0, valid, grp * C);
      });
}

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
outproj_res_kernel(const T* __restrict__ a, const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ g, T* __restrict__ out, int rows, int hd, int f,
                   int kslice, int stages) {
  constexpr int R = sm90mix::BlockRows<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::BlockProblem<T> pb{{{a, w, nullptr, hd}, {}, {}}, {g, nullptr, nullptr},
                                    nullptr, 1, rows, f, kslice, stages};
  sm90mix::run_blocks<T, R, NT>(pb, smem_raw, [&](auto& it) { it.outproj_res(x, out); });
}

// The wrapper's tile plan (rows, columns, stages, cluster, shared-memory
// bytes) must be the one instantiated here.
template <typename T>
int launch_rms_qkv(const void* x, const void* g_rms, const void* w, const void* g, void* out,
                   int n_nodes, int rows, int f, int fo, int tile_rows, int tile_cols, int stages,
                   int cluster, int smem_bytes, void* stream) {
  constexpr int R = QkvTile<T>::kRows, C = QkvTile<T>::kCols;
  if (n_nodes != kNodes || rows <= 0 || f <= 0 || f % 32 ||
      f > sm90mix::kMaxF ||
      fo <= 0 || fo % 8 || tile_rows != R || tile_cols != C || stages < 2 ||
      stages > sm90mix::kMaxStages || cluster != sm90mix::kCluster ||
      static_cast<size_t>(smem_bytes) != sm90mix::layout<T>(R, C, f, stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (fo + C - 1) / C;
  return static_cast<int>(sm90mix::launch(
      rms_qkv_kernel<T>, sm90mix::items(rows, R, groups), smem_bytes, cluster, stream,
      static_cast<const T*>(x), static_cast<const T*>(g_rms), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(out), rows, f, fo, groups, stages));
}

// The wrapper's tile plan (rows, k-slice, stages, cluster, shared-memory
// bytes) must be the one instantiated here; bf16 is instantiated for each
// f = 64·NT the plan takes.
template <typename T>
int launch_outproj_res(const void* a, const void* x, const void* w, const void* g, void* out,
                       int n_nodes, int rows, int hd, int f, int tile_rows, int kslice,
                       int stages, int cluster, int smem_bytes, void* stream) {
  const int ks[1] = {hd};
  if (n_nodes != kNodes || rows <= 0 ||
      !sm90mix::block_plan_ok<T>(f, ks, 1, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(outproj_res_kernel<T, decltype(nt)::value>,
                           sm90mix::items(rows, tile_rows, 1), smem_bytes, cluster, stream,
                           static_cast<const T*>(a), static_cast<const T*>(x),
                           static_cast<const T*>(w), static_cast<const T*>(g),
                           static_cast<T*>(out), rows, hd, f, kslice, stages);
  }));
}

}  // namespace

// All tensors of one element type, contiguous, 32-byte aligned.  Each entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// shapes not instantiated.

// x [n_nodes, rows, f], g_rms [f], g [n_nodes, n_nodes], out [n_nodes, rows,
// fo] (fo = 3·hd, q‖k‖v); w is W_qkv [n_nodes, f, fo] packed into tiles
// [n_nodes, ⌈fo/tile_cols⌉, f·tile_cols] (ops/kernels/node_mix_sm90.py).
extern "C" int rms_qkv_bf16(const void* x, const void* g_rms, const void* w, const void* g,
                            void* out, int n_nodes, int rows, int f, int fo, int tile_rows,
                            int tile_cols, int stages, int cluster, int smem_bytes, void* stream) {
  return launch_rms_qkv<nodemix::bf16>(x, g_rms, w, g, out, n_nodes, rows, f, fo, tile_rows,
                                       tile_cols, stages, cluster, smem_bytes, stream);
}
extern "C" int rms_qkv_f32(const void* x, const void* g_rms, const void* w, const void* g,
                           void* out, int n_nodes, int rows, int f, int fo, int tile_rows,
                           int tile_cols, int stages, int cluster, int smem_bytes, void* stream) {
  return launch_rms_qkv<float>(x, g_rms, w, g, out, n_nodes, rows, f, fo, tile_rows, tile_cols,
                               stages, cluster, smem_bytes, stream);
}

// a [n_nodes, rows, hd], x and out [n_nodes, rows, f]; w is W_out [n_nodes,
// hd, f] packed into one tile of all f columns, [n_nodes, 1, hd·f]
// (ops/kernels/node_mix_sm90.py); the tile plan
// (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int outproj_res_bf16(const void* a, const void* x, const void* w, const void* g,
                                void* out, int n_nodes, int rows, int hd, int f, int tile_rows,
                                int kslice, int stages, int cluster, int smem_bytes,
                                void* stream) {
  return launch_outproj_res<nodemix::bf16>(a, x, w, g, out, n_nodes, rows, hd, f, tile_rows,
                                           kslice, stages, cluster, smem_bytes, stream);
}
extern "C" int outproj_res_f32(const void* a, const void* x, const void* w, const void* g,
                               void* out, int n_nodes, int rows, int hd, int f, int tile_rows,
                               int kslice, int stages, int cluster, int smem_bytes,
                               void* stream) {
  return launch_outproj_res<float>(a, x, w, g, out, n_nodes, rows, hd, f, tile_rows, kslice,
                                   stages, cluster, smem_bytes, stream);
}
