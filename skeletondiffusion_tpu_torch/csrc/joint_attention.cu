// Softmax attention over the skeleton's joints, bf16 and fp32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces skeletondiffusion_tpu/ops/pallas/joint_attention.py::attention_core_pallas
// (kernel body _attn_core_kernel).  For every row b and head h of packed
// node-major q‖k‖v [N, B, 3·H·dh]:
//
//   qs      = round(q · round(dh^-1/2))
//   s[n, m] = Σ_c qs[n, c]·k[m, c]                  fp32 sums
//   p[n, m] = round(softmax_m(s[n, ·]))
//   out[n]  = round(Σ_m p[n, m]·v[m])               [N, B, H·dh], fp32 sums
//
// round() is to the element type; the Pallas kernel also rounds each
// product qs·k in bf16, which the tensor cores do not (joint_attention.cuh).
//
// What bounds it on the H100: memory.  At N=21, B=12 800, 8 heads × 32 in
// bf16 it reads 413 MB and writes 138 MB (0.164 ms) against ~2.9 G
// multiply-adds (~20 µs of mma.sync).
//
// What the design does about it: persistent blocks, one an SM, each a
// producer warp and 8 consumer warps, walk items of R rows × a group of G
// heads (bench, bf16: 2 rows × all 8 heads; fp32: 1 row).  The producer
// fills a ring of stages (mbarriers, node_mix_sm90.cuh) with one
// cp.async.bulk copy a node: node n's R rows of the item are contiguous in
// device memory (3 copies a node, q, k and v of the group, when G < H).  In
// a stage each node's rows are followed by 16 bytes, so the joints of an
// ldmatrix fall in distinct banks.  A consumer warp takes the item's (row,
// head) pairs warp, warp + 8, …: in bf16 joint_attention.cuh's
// head_attention_mma, both products on the tensor cores, O staged in q's
// rows and stored with 16-byte stores; in fp32 head_attention, a lane a query
// joint.  The stages in flight (bench: three of 63 KB) overlap each item's
// loads with the items before it; no consumer waits on its own global load.
//
// N is the build's node count (node_mix.cuh, -DSKD_NODES): a stage holds the
// item's rows of all N joints, one bulk copy a joint (16 for H36M, 17 for
// FreeMan, 21 for AMASS, 51 for AMASS-MANO).  At 51 joints two rows of all 8
// heads (315 264 B a two-stage ring) do not fit: the plan takes one row of
// all heads, two stages of 79 232 B (bf16), and the bodies take the query
// joints in turns (joint_attention.cuh).

#include <cmath>

#include "joint_attention.cuh"

namespace {

using sm90mix::bf16;

constexpr int kDimHead = 32;
constexpr int kMaxHeads = 32;

// Byte offsets of one block's shared memory (the wrapper's plan,
// ops/kernels/joint_attention.py::plan_bytes, computes the same total):
// the barriers and the zero row, then the stages, each node's rows of the
// item followed by 16 bytes.
struct AttentionLayout {
  size_t stages, stage_bytes, node_bytes, total;
};

template <typename T>
AttentionLayout attention_layout(int tile_rows, int group_heads, int stages) {
  AttentionLayout l{};
  l.node_bytes = sizeof(T) * tile_rows * 3 * group_heads * kDimHead + 16;
  l.stage_bytes = sm90mix::up(sm90mix::kNodes * l.node_bytes);
  l.stages = 128;  // full[kMaxStages], empty[kMaxStages], the zero row
  l.total = l.stages + stages * l.stage_bytes;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(sm90mix::kThreads, 1)
attention_core_kernel(const T* __restrict__ qkv, T* __restrict__ out, int rows, int heads,
                      int tile_rows, int group_heads, int stages, int node_bytes,
                      int stage_bytes, float scale) {
  using namespace sm90mix;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = heads / group_heads, hd = heads * kDimHead;
  const int gw = group_heads * kDimHead;  // a group's q (k, v) columns of a row
  const int n_items = (rows + tile_rows - 1) / tile_rows * groups;
  auto item_rows = [&](int item, int& b0, int& valid) {
    b0 = item / groups * tile_rows;
    valid = min(tile_rows, rows - b0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    *reinterpret_cast<uint4*>(smem + kZeroOffset) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {  // the producer
      const uint32_t part = static_cast<uint32_t>(sizeof(T) * gw);
      RingPos q;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, q.advance(stages)) {
        int b0, valid;
        item_rows(item, b0, valid);
        const int grp = item % groups;
        mbar_wait(&empty[q.s], q.phase ^ 1u);  // every consumer warp is done with the stage
        unsigned char* st = smem + 128 + static_cast<size_t>(q.s) * stage_bytes;
        mbar_expect_tx(&full[q.s], kNodes * valid * 3 * part);
        for (int n = 0; n < kNodes; ++n) {
          const T* src = qkv + (static_cast<size_t>(n) * rows + b0) * 3 * hd;
          unsigned char* dst = st + n * node_bytes;
          if (groups == 1) {  // the item's rows of node n, whole
            bulk_load(dst, src, valid * 3 * part, &full[q.s]);
          } else {  // one row: the group's q, k and v
            for (int i = 0; i < 3; ++i)
              bulk_load(dst + i * part, src + i * hd + grp * gw, part, &full[q.s]);
          }
        }
      }
    }
    __syncwarp();
  } else {
    const int ld = node_bytes / static_cast<int>(sizeof(T));  // elements between joints
    const size_t ldo = static_cast<size_t>(rows) * hd;
    RingPos q;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, q.advance(stages)) {
      int b0, valid;
      item_rows(item, b0, valid);
      const int h0 = item % groups * group_heads;
      mbar_wait(&full[q.s], q.phase);
      T* st = reinterpret_cast<T*>(smem + 128 + static_cast<size_t>(q.s) * stage_bytes);
      for (int task = warp; task < valid * group_heads; task += kConsumerWarps) {
        const int r = task / group_heads, hh = task % group_heads;
        T* base = st + r * 3 * gw + hh * kDimHead;
        T* o = out + static_cast<size_t>(b0 + r) * hd + (h0 + hh) * kDimHead;
        if constexpr (nodemix::kTensorCoreBody<T>) {
          nodemix::head_attention_mma(base, base + gw, base + 2 * gw, ld, scale, o, ldo,
                                      smem + kZeroOffset);
        } else {
          nodemix::head_attention<T, kNodes, kDimHead>(base, base + gw, base + 2 * gw, ld, scale,
                                                       o, ldo);
        }
      }
      fence_proxy_async();  // the stage's writes (O in q's rows) before its next bulk copy
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q.s]);
    }
  }
}

// The wrapper's plan (rows an item, heads an item, stages, shared-memory
// bytes) must be one this kernel takes: 1 or 2 rows, whole rows of all heads
// when 2, the group dividing the heads, 2 to kMaxStages stages, and the
// shared memory attention_layout computes.
template <typename T>
int launch(const void* qkv, void* out, int n_nodes, int rows, int heads, int dim_head,
           int tile_rows, int group_heads, int stages, int smem_bytes, void* stream) {
  using namespace sm90mix;
  if (n_nodes != kNodes || dim_head != kDimHead || rows <= 0 || heads <= 0 ||
      heads > kMaxHeads || tile_rows < 1 || tile_rows > 2 || group_heads < 1 ||
      heads % group_heads || (tile_rows > 1 && group_heads != heads) || stages < 2 ||
      stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttentionLayout l = attention_layout<T>(tile_rows, group_heads, stages);
  if (static_cast<size_t>(smem_bytes) != l.total || l.total > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_core_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int items = (rows + tile_rows - 1) / tile_rows * (heads / group_heads);
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), rows, heads, tile_rows, group_heads,
      stages, static_cast<int>(l.node_bytes), static_cast<int>(l.stage_bytes),
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDimHead))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [n_nodes, rows, 3·heads·dim_head] (q‖k‖v, heads major within each),
// out [n_nodes, rows, heads·dim_head]; contiguous, 16-byte aligned; the plan
// (ops/kernels/joint_attention.py::attention_plan).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// and plans not instantiated.
extern "C" int attention_core_bf16(const void* qkv, void* out, int n_nodes, int rows, int heads,
                                   int dim_head, int tile_rows, int group_heads, int stages,
                                   int smem_bytes, void* stream) {
  return launch<bf16>(qkv, out, n_nodes, rows, heads, dim_head, tile_rows, group_heads, stages,
                      smem_bytes, stream);
}
extern "C" int attention_core_f32(const void* qkv, void* out, int n_nodes, int rows, int heads,
                                  int dim_head, int tile_rows, int group_heads, int stages,
                                  int smem_bytes, void* stream) {
  return launch<float>(qkv, out, n_nodes, rows, heads, dim_head, tile_rows, group_heads, stages,
                       smem_bytes, stream);
}
