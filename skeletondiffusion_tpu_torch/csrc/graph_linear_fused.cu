// One-pass graph-structural linear (the fused denoiser's stem), bf16 and
// fp32, for NVIDIA Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/graph_linear_fused.py::graph_linear_pallas
// (kernel body _glin_kernel).  Over node-major [N, B, ·] activations:
//
//   h[n]   = round(x[n]·W[n] + b[n] + u[n])     u: the hoisted conditioning
//   out[n] = round(Σ_m G[n,m]·h[m])
//
// What bounds it on the H100: memory.  At N=21, B=12 800, x [·,96] and u, out
// [·,192] in bf16 it moves ~258 MB (0.077 ms) against ~10 GFLOP of products
// and mix (~0.01 ms on the tensor cores).
//
// What the design does about it: the stem pass of B9a (layer_fused.cu) alone,
// on node_mix_sm90.cuh's engine (`run_blocks`, BlockItem::stem): persistent
// two-block clusters walk items of 16 rows (fp32: 8) × all F columns, so x,
// u and out cross device memory once each and h never leaves shared memory.
// The contraction of D = 96 runs as two k-slices of 64 (fp32: four of 32):
// the producer warp's cp.async copies bring each slice of x's rows and
// zero-fill its columns 96–127 (Input::kNarrow) against a bank packed with
// rows 96–127 zero, half of each bank slice multicast into both blocks, so
// each weight byte from L2 serves the cluster's 32 rows.  mma.sync products
// with u added after the bias, then the tensor-core node mix and 16-byte
// stores.  The same pass, k-slice and mix as B9a's first stage: the output is
// B9a's r bit for bit.  On an H100 at the bench shapes: 0.25 ms, 3.2× the
// bound; its F = 192 build with u holds 166 registers, no spill (PERF.md §6).

#include "node_mix_sm90.cuh"

namespace {

using sm90mix::bf16;

template <typename T, int NT, bool kAddend>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
graph_linear_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out,
                    int rows, int d, int kd, int f, int kslice, int stages) {
  constexpr int R = sm90mix::BlockRows<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  sm90mix::BlockProblem<T> pb{{{x, w, b, kd}}, {g}, nullptr, 1, rows, f, kslice, stages};
  pb.a_cols = d;
  sm90mix::run_blocks<T, R, NT, sm90mix::Input::kNarrow>(
      pb, smem_raw, [&](auto& it) { it.template stem<kAddend>(u, out); });
}

// The wrapper's tile plan (rows, k-slice, stages, cluster, shared-memory
// bytes) must be the one instantiated here, with the contraction d (a
// multiple of 8) padded to kd, the next multiple of 64; bf16 is instantiated
// for each f = 64·NT the plan takes, with and without u.
template <typename T>
int launch(const void* x, const void* w, const void* b, const void* g, const void* u, void* out,
           int n_nodes, int rows, int d, int f, int tile_rows, int kslice, int stages,
           int cluster, int smem_bytes, void* stream) {
  const int kd = (d + 63) / 64 * 64;
  const int ks[1] = {kd};
  if (n_nodes != sm90mix::kNodes || rows <= 0 || d <= 0 || d % 8 ||
      !sm90mix::block_plan_ok<T>(f, ks, 1, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = u != nullptr ? graph_linear_kernel<T, NT, true>
                               : graph_linear_kernel<T, NT, false>;
    return sm90mix::launch(kernel, sm90mix::items(rows, tile_rows, 1), smem_bytes, cluster,
                           stream, static_cast<const T*>(x), static_cast<const T*>(w),
                           static_cast<const T*>(b), static_cast<const T*>(g),
                           static_cast<const T*>(u), static_cast<T*>(out), rows, d, kd, f, kslice,
                           stages);
  }));
}

}  // namespace

// x [n_nodes, rows, d], u and out [n_nodes, rows, f] (u may be null), w
// [n_nodes, d, f] zero-padded to [·, kd, f] (kd: d rounded up to 64) and
// packed into one tile of all f columns, [·, 1, kd·f]
// (ops/kernels/node_mix_sm90.py), b [n_nodes, f], g [n_nodes, n_nodes]; all
// of one element type, contiguous, 32-byte aligned; the tile plan
// (ops/kernels/node_mix_sm90.py::block_plan).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes and plans not
// instantiated.
extern "C" int graph_linear_fused_bf16(const void* x, const void* w, const void* b, const void* g,
                                       const void* u, void* out, int n_nodes, int rows, int d,
                                       int f, int tile_rows, int kslice, int stages, int cluster,
                                       int smem_bytes, void* stream) {
  return launch<bf16>(x, w, b, g, u, out, n_nodes, rows, d, f, tile_rows, kslice, stages, cluster,
                      smem_bytes, stream);
}

extern "C" int graph_linear_fused_f32(const void* x, const void* w, const void* b, const void* g,
                                      const void* u, void* out, int n_nodes, int rows, int d,
                                      int f, int tile_rows, int kslice, int stages, int cluster,
                                      int smem_bytes, void* stream) {
  return launch<float>(x, w, b, g, u, out, n_nodes, rows, d, f, tile_rows, kslice, stages,
                       cluster, smem_bytes, stream);
}
