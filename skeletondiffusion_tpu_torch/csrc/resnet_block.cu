// The fused denoiser's ResnetBlocks, bf16 and fp32, for NVIDIA Hopper
// (sm_90a): the square block (B1) and the two passes of the rectangular
// 2F→F final block with the output head (B5a, B5b).
//
// Replaces skeletondiffusion_tpu/ops/pallas/resnet_block.py:
//   resnet_block_pallas_padded      (_resnet_kernel)          → resnet_block_*
//   final_block_head_pallas_padded  (_rect_in_kernel)         → final_block_in_*
//                                   (_rect_out_head_kernel)   → final_block_out_*
//
// Over node-major [N, B, F] activations, with round() to the element type
// where the Pallas kernels materialise in their compute dtype:
//
//   B1:  h   = round(tanh(FiLM(G1·round(x·W1 + b1))))
//        out = round(tanh(G2·round(h·W2 + b2)) + x)
//   B5a: h   = round(tanh(FiLM(G1·round([x‖r]·W1 + b1))))
//        res = round(Gr·round([x‖r]·Wr))
//   B5b: o   = round(tanh(G2·round(h·W2 + b2)) + res)
//        out = round(Gh·round(o·Wh + bh))
//
// FiLM(y) = y·(scale + 1) + shift in fp32 from the block's scalar-time row
// scale‖shift [2F] in the element type.
//
// What bounds them on the H100: memory.  At N=21, B=12 800, F=192 in bf16,
// B1 moves ~210 MB against ~44 GFLOP on the tensor cores (0.063 ms against
// 0.045 ms); B5a ~413 MB against ~84 GFLOP (0.125 ms); B5b ~258 MB against
// ~31 GFLOP (0.078 ms).
//
// All three run on node_mix_sm90.cuh's engine (`run_blocks`, whose ResnetBlock
// body B1 shares with B9c in layer_fused.cu): items of 16 rows (fp32: 8) ×
// all 192 columns, the two blocks of a cluster on adjacent row tiles; per
// node and k-slice of 64 bank rows (fp32: 32) a ring stage holds the k-slice
// of the 16 input rows (cp.async) and of the bank (a bulk copy, half from
// each block, multicast to both); mma.sync products from shared memory (a
// product in place in P reads its A straight from P), the node mixes on the
// tensor cores with their epilogues in registers, 16-byte stores.  Shared
// memory (bf16): P 21 × (16 × 400 + 16) B = 134 784, three stages of 2 304 +
// 24 576 B, FiLM's 1 536 B and the barriers: 217 088 of 232 448 B; one block
// an SM.  Each weight byte from L2 serves the cluster's 32 rows.
//
// B1: a block's item takes ~210 000 cycles: the products 60% (a tenth of it
// waiting on the ring; the mma.sync rate binds them), the two mixes 35%
// (tanhf near half of it), the store 3% (PERF.md §6).
//
// B5a: both passes contract over x‖r (k = 2F) against the unsplit [2F, F]
// banks: the ring takes k-slices 0 … F/kslice − 1 from x and the rest from
// r, so x‖r is never written out; after the first pass's FiLM/tanh mix the
// item stores h and the second pass reads x‖r again.  An item takes
// ~324 000 cycles: the products 82% (~1 070 a ring stage, as B1's first
// pass), the FiLM/tanh mix 11%, the plain mix 2%, the stores 4%.
//
// B5b: the block's second half with its residual, read at the row it is
// added to (held a row ahead, as the other kernels' mixes hold it, it
// spilled), then the head in place on P as an F-wide pass: its [F, fo] bank
// and its bias zero-padded to F columns (a pass's products take the same
// time whatever its width: the ring's stages bind them), the head's mix over
// all F columns and its store over the first fo.  An item takes ~191 000
// cycles: the products 63%, the residual mix 31%, the head's mix and the
// store 6% (PERF.md §6).

#include "node_mix_sm90.cuh"

namespace {

using sm90mix::bf16;

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
resnet_block_kernel(const T* __restrict__ x, const T* __restrict__ film,
                    const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ g1,
                    const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ g2,
                    T* __restrict__ out, int rows, int f, int kslice, int stages) {
  constexpr int R = sm90mix::block_rows<T>(64 * NT);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::BlockProblem<T> pb{{{x, w1, b1, f}, {nullptr, w2, b2, f}, {}},
                                    {g1, g2, nullptr}, film, 2, rows, f, kslice, stages};
  sm90mix::run_blocks<T, R, NT>(pb, smem_raw, [&](auto& it) {
    it.resnet_block(0, x);
    it.store(out);
  });
}

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
final_block_in_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ film, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ g1,
                      const T* __restrict__ wr, const T* __restrict__ gr, T* __restrict__ h_out,
                      T* __restrict__ res_out, int rows, int f, int kslice, int stages) {
  constexpr int R = sm90mix::block_rows<T>(64 * NT);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::BlockProblem<T> pb{{{x, w1, b1, 2 * f}, {x, wr, nullptr, 2 * f}, {}},
                                    {g1, gr, nullptr}, film, 2, rows, f, kslice, stages, r};
  sm90mix::run_blocks<T, R, NT, sm90mix::Input::kSplit>(
      pb, smem_raw, [&](auto& it) { it.final_block_in(h_out, res_out); });
}

template <typename T, int NT>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
final_block_out_kernel(const T* __restrict__ h, const T* __restrict__ res,
                       const T* __restrict__ w2, const T* __restrict__ b2,
                       const T* __restrict__ g2, const T* __restrict__ wh,
                       const T* __restrict__ bh, const T* __restrict__ gh, T* __restrict__ out,
                       int rows, int f, int fo, int kslice, int stages) {
  constexpr int R = sm90mix::block_rows<T>(64 * NT);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const sm90mix::BlockProblem<T> pb{{{h, w2, b2, f}, {nullptr, wh, bh, f}, {}},
                                    {g2, gh, nullptr}, nullptr, 2, rows, f, kslice, stages};
  sm90mix::run_blocks<T, R, NT>(pb, smem_raw, [&](auto& it) { it.final_block_out(res, out, fo); });
}

// The wrapper's tile plan (rows, k-slice, stages, cluster, shared-memory
// bytes) must be the one instantiated here; bf16 is instantiated for each
// f = 64·NT the plan takes.
template <typename T>
int launch_block(const void* x, const void* film, const void* w1, const void* b1, const void* g1,
                 const void* w2, const void* b2, const void* g2, void* out, int n_nodes, int rows,
                 int f, int tile_rows, int kslice, int stages, int cluster, int smem_bytes,
                 void* stream) {
  const int ks[2] = {f, f};
  if (n_nodes != sm90mix::kNodes || rows <= 0 ||
      !sm90mix::block_plan_ok<T>(f, ks, 2, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(
        resnet_block_kernel<T, decltype(nt)::value>, sm90mix::items(rows, tile_rows, 1),
        smem_bytes, cluster, stream, static_cast<const T*>(x), static_cast<const T*>(film),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(g1),
        static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(g2),
        static_cast<T*>(out), rows, f, kslice, stages);
  }));
}

template <typename T>
int launch_in(const void* x, const void* r, const void* film, const void* w1, const void* b1,
              const void* g1, const void* wr, const void* gr, void* h_out, void* res_out,
              int n_nodes, int rows, int f, int tile_rows, int kslice, int stages, int cluster,
              int smem_bytes, void* stream) {
  const int ks[2] = {2 * f, 2 * f};
  if (n_nodes != sm90mix::kNodes || rows <= 0 ||
      !sm90mix::block_plan_ok<T>(f, ks, 2, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(
        final_block_in_kernel<T, decltype(nt)::value>, sm90mix::items(rows, tile_rows, 1),
        smem_bytes, cluster, stream, static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(film), static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(g1), static_cast<const T*>(wr), static_cast<const T*>(gr),
        static_cast<T*>(h_out), static_cast<T*>(res_out), rows, f, kslice, stages);
  }));
}

template <typename T>
int launch_out(const void* h, const void* res, const void* w2, const void* b2, const void* g2,
               const void* wh, const void* bh, const void* gh, void* out, int n_nodes, int rows,
               int f, int fo, int tile_rows, int kslice, int stages, int cluster, int smem_bytes,
               void* stream) {
  const int ks[2] = {f, f};
  if (n_nodes != sm90mix::kNodes || rows <= 0 || !sm90mix::out_cols_ok<T>(f, fo) ||
      !sm90mix::block_plan_ok<T>(f, ks, 2, tile_rows, kslice, stages, cluster, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90mix::with_nt<T>(f, [&](auto nt) {
    return sm90mix::launch(
        final_block_out_kernel<T, decltype(nt)::value>, sm90mix::items(rows, tile_rows, 1),
        smem_bytes, cluster, stream, static_cast<const T*>(h), static_cast<const T*>(res),
        static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(g2),
        static_cast<const T*>(wh), static_cast<const T*>(bh), static_cast<const T*>(gh),
        static_cast<T*>(out), rows, f, fo, kslice, stages);
  }));
}

}  // namespace

// All tensors of one element type, contiguous, 32-byte aligned; activations
// node-major [n_nodes, rows, ·], banks [n_nodes, in, out], biases
// [n_nodes, out], influences [n_nodes, n_nodes], film [2f].  Each entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// shapes not instantiated.

// x, out [·, rows, f]; w1, w2 [·, f, f] packed into one tile of all f
// columns each, [·, 1, f·f] (ops/kernels/node_mix_sm90.py); the tile plan
// (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int resnet_block_bf16(const void* x, const void* film, const void* w1, const void* b1,
                                 const void* g1, const void* w2, const void* b2, const void* g2,
                                 void* out, int n_nodes, int rows, int f, int tile_rows,
                                 int kslice, int stages, int cluster, int smem_bytes,
                                 void* stream) {
  return launch_block<bf16>(x, film, w1, b1, g1, w2, b2, g2, out, n_nodes, rows, f, tile_rows,
                            kslice, stages, cluster, smem_bytes, stream);
}
extern "C" int resnet_block_f32(const void* x, const void* film, const void* w1, const void* b1,
                                const void* g1, const void* w2, const void* b2, const void* g2,
                                void* out, int n_nodes, int rows, int f, int tile_rows, int kslice,
                                int stages, int cluster, int smem_bytes, void* stream) {
  return launch_block<float>(x, film, w1, b1, g1, w2, b2, g2, out, n_nodes, rows, f, tile_rows,
                             kslice, stages, cluster, smem_bytes, stream);
}

// x, r, h_out, res_out [·, rows, f]; w1, wr [·, 2f, f] (rows 0:f act on x,
// f:2f on r) packed into one tile of all f columns each, [·, 1, 2f·f]; the
// tile plan (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int final_block_in_bf16(const void* x, const void* r, const void* film, const void* w1,
                                   const void* b1, const void* g1, const void* wr, const void* gr,
                                   void* h_out, void* res_out, int n_nodes, int rows, int f,
                                   int tile_rows, int kslice, int stages, int cluster,
                                   int smem_bytes, void* stream) {
  return launch_in<bf16>(x, r, film, w1, b1, g1, wr, gr, h_out, res_out, n_nodes, rows, f,
                         tile_rows, kslice, stages, cluster, smem_bytes, stream);
}
extern "C" int final_block_in_f32(const void* x, const void* r, const void* film, const void* w1,
                                  const void* b1, const void* g1, const void* wr, const void* gr,
                                  void* h_out, void* res_out, int n_nodes, int rows, int f,
                                  int tile_rows, int kslice, int stages, int cluster,
                                  int smem_bytes, void* stream) {
  return launch_in<float>(x, r, film, w1, b1, g1, wr, gr, h_out, res_out, n_nodes, rows, f,
                          tile_rows, kslice, stages, cluster, smem_bytes, stream);
}

// h, res [·, rows, f]; w2 [·, f, f] and wh [·, f, fo] packed into one tile
// of all f columns each (wh's columns past fo zero), [·, 1, f·f], and bh
// zero-padded to [·, f]; out [·, rows, fo];
// the tile plan (ops/kernels/node_mix_sm90.py::block_plan).
extern "C" int final_block_out_bf16(const void* h, const void* res, const void* w2, const void* b2,
                                    const void* g2, const void* wh, const void* bh, const void* gh,
                                    void* out, int n_nodes, int rows, int f, int fo,
                                    int tile_rows, int kslice, int stages, int cluster,
                                    int smem_bytes, void* stream) {
  return launch_out<bf16>(h, res, w2, b2, g2, wh, bh, gh, out, n_nodes, rows, f, fo, tile_rows,
                          kslice, stages, cluster, smem_bytes, stream);
}
extern "C" int final_block_out_f32(const void* h, const void* res, const void* w2, const void* b2,
                                   const void* g2, const void* wh, const void* bh, const void* gh,
                                   void* out, int n_nodes, int rows, int f, int fo,
                                   int tile_rows, int kslice, int stages, int cluster,
                                   int smem_bytes, void* stream) {
  return launch_out<float>(h, res, w2, b2, g2, wh, bh, gh, out, n_nodes, rows, f, fo, tile_rows,
                           kslice, stages, cluster, smem_bytes, stream);
}
