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
// [·,192] in bf16 it moves ~258 MB against ~10 GFLOP of products, far below
// the ~295 flops a byte where the bf16 tensor cores would bind.
//
// What the design does about it: a block owns 16 rows (8 in fp32) for all
// 21 nodes, so x, u and out cross device memory once each and h never
// leaves shared memory; the products run on the tensor cores and the mix in
// fp32 from shared memory (node_mix.cuh).  The TPU version padded the
// features to 128 lanes and the batch to a tile multiple; here they keep
// their widths and the last tile is masked.

#include "node_mix.cuh"

namespace {

using namespace nodemix;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
graph_linear_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out,
                    int rows, int fi, int fo) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm = Smem<T>::carve(smem_raw, fo, fi, 1);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  load_influence(sm.g, g);

  node_products(
      [&](int n, T* buf) { stage_rows(buf, x + at(n, rows, b0, fi, 0), fi, valid); },
      sm.s, fi, w, fo, fo, sm.scratch,
      [&](int n, int r, int c, float acc) {
        float h = acc + to_f(b[n * fo + c]);
        if (u != nullptr && r < valid) h += to_f(u[at(n, rows, b0 + r, fo, c)]);
        sm.p[(n * R + r) * fo + c] = from_f<T>(h);
      });
  node_mix(sm.p, fo, fo, sm.g, [&](int n, int r, int c, float y) {
    if (r < valid) out[at(n, rows, b0 + r, fo, c)] = from_f<T>(y);
  });
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* g, const void* u, void* out,
           int n_nodes, int rows, int fi, int fo, void* stream) {
  if (n_nodes != kNodes || rows <= 0 || fi % 32 || fo % 16 || fi <= 0 || fo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem<T>::bytes(fo, fi, 1, 0);
  cudaError_t err = prepare(graph_linear_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  graph_linear_kernel<T><<<grid_for<T>(rows), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(out), rows, fi, fo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n_nodes, rows, fi], w [n_nodes, fi, fo], b [n_nodes, fo], g [n_nodes,
// n_nodes], u [n_nodes, rows, fo] or null, out [n_nodes, rows, fo]; all of one
// element type, contiguous, 32-byte aligned.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes not instantiated.
extern "C" int graph_linear_fused_bf16(const void* x, const void* w, const void* b, const void* g,
                                       const void* u, void* out, int n_nodes, int rows, int fi,
                                       int fo, void* stream) {
  return launch<nodemix::bf16>(x, w, b, g, u, out, n_nodes, rows, fi, fo, stream);
}

extern "C" int graph_linear_fused_f32(const void* x, const void* w, const void* b, const void* g,
                                      const void* u, void* out, int n_nodes, int rows, int fi,
                                      int fo, void* stream) {
  return launch<float>(x, w, b, g, u, out, n_nodes, rows, fi, fo, stream);
}
