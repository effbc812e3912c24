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
// the tensor cores) and B3b ~344 MB.
//
// What the design does about it: as in node_mix.cuh, a block owns 16 rows
// (8 in fp32) of all 21 nodes and every activation crosses device memory
// once per pass.  B3a's 768 output columns are produced in chunks of at most
// 256 (the mix is per column, so a chunk is mixed as soon as its products
// are done), which keeps the tile of products at 172 KB of shared memory in
// bf16; each chunk restages and renormalises the rows, which costs reads of
// x from L2, not a second pass over device memory.

#include "node_mix.cuh"

namespace {

using namespace nodemix;

constexpr int kChunk = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rms_qkv_kernel(const T* __restrict__ x, const T* __restrict__ g_rms, const T* __restrict__ w,
               const T* __restrict__ g, T* __restrict__ out, int rows, int f, int fo) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm = Smem<T>::carve(smem_raw, kChunk, f, 1);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  load_influence(sm.g, g);

  T* p = sm.p;
  for (int c0 = 0; c0 < fo; c0 += kChunk) {
    const int fc = min(kChunk, fo - c0);
    node_products(
        [&](int n, T* buf) { stage_rows(buf, f, 0, x + at(n, rows, b0, f, 0), f, valid); },
        [&](T* buf, int n_rows) { normalize_rows(buf, g_rms, f, n_rows); },
        sm.s, f, w + c0, fo, fc, sm.scratch,
        [&](int n, int r, int c, float acc) { p[(n * R + r) * kChunk + c] = from_f<T>(acc); });
    node_mix(p, kChunk, fc, sm.g, [&](int n, int r, int c, float y) {
      if (r < valid) out[at(n, rows, b0 + r, fo, c0 + c)] = from_f<T>(y);
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
outproj_res_kernel(const T* __restrict__ a, const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ g, T* __restrict__ out, int rows, int hd, int f) {
  constexpr int R = RowTile<T>::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm = Smem<T>::carve(smem_raw, f, hd, 1);
  const int b0 = blockIdx.x * R;
  const int valid = min(R, rows - b0);
  load_influence(sm.g, g);

  T* p = sm.p;
  node_products(
      [&](int n, T* buf) { stage_rows(buf, hd, 0, a + at(n, rows, b0, hd, 0), hd, valid); },
      AsStaged{}, sm.s, hd, w, f, f, sm.scratch,
      [&](int n, int r, int c, float acc) { p[(n * R + r) * f + c] = from_f<T>(acc); });
  node_mix(p, f, f, sm.g, [&](int n, int r, int c, float y) {
    if (r < valid) {
      const size_t i = at(n, rows, b0 + r, f, c);
      out[i] = from_f<T>(y + to_f(x[i]));
    }
  });
}

template <typename T>
int launch_rms_qkv(const void* x, const void* g_rms, const void* w, const void* g, void* out,
                   int n_nodes, int rows, int f, int fo, void* stream) {
  if (n_nodes != kNodes || rows <= 0 || f <= 0 || f % 32 || fo <= 0 || fo % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem<T>::bytes(kChunk, f, 1, 0);
  cudaError_t err = prepare(rms_qkv_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_qkv_kernel<T><<<grid_for<T>(rows), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_rms), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(out), rows, f, fo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_outproj_res(const void* a, const void* x, const void* w, const void* g, void* out,
                       int n_nodes, int rows, int hd, int f, void* stream) {
  if (n_nodes != kNodes || rows <= 0 || hd <= 0 || hd % 32 || f <= 0 || f % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem<T>::bytes(f, hd, 1, 0);
  cudaError_t err = prepare(outproj_res_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  outproj_res_kernel<T><<<grid_for<T>(rows), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(out), rows, hd, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors of one element type, contiguous, 32-byte aligned.  Each entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// shapes not instantiated.

// x [n_nodes, rows, f], g_rms [f], w [n_nodes, f, fo], g [n_nodes, n_nodes],
// out [n_nodes, rows, fo] (fo = 3·hd, q‖k‖v).
extern "C" int rms_qkv_bf16(const void* x, const void* g_rms, const void* w, const void* g,
                            void* out, int n_nodes, int rows, int f, int fo, void* stream) {
  return launch_rms_qkv<nodemix::bf16>(x, g_rms, w, g, out, n_nodes, rows, f, fo, stream);
}
extern "C" int rms_qkv_f32(const void* x, const void* g_rms, const void* w, const void* g,
                           void* out, int n_nodes, int rows, int f, int fo, void* stream) {
  return launch_rms_qkv<float>(x, g_rms, w, g, out, n_nodes, rows, f, fo, stream);
}

// a [n_nodes, rows, hd], x and out [n_nodes, rows, f], w [n_nodes, hd, f].
extern "C" int outproj_res_bf16(const void* a, const void* x, const void* w, const void* g,
                                void* out, int n_nodes, int rows, int hd, int f, void* stream) {
  return launch_outproj_res<nodemix::bf16>(a, x, w, g, out, n_nodes, rows, hd, f, stream);
}
extern "C" int outproj_res_f32(const void* a, const void* x, const void* w, const void* g,
                               void* out, int n_nodes, int rows, int hd, int f, void* stream) {
  return launch_outproj_res<float>(a, x, w, g, out, n_nodes, rows, hd, f, stream);
}
