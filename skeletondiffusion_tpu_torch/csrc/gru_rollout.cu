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
// are 77% of them, the four node mixes 22%) against ~0.8 GB of compulsory
// traffic: 34.7 ms at 67 TFLOP/s.  Every step depends on the one before, and
// fp32 state for more than 8 rows does not fit a block's shared memory
// (h alone is 129 KB at 16 rows), so each block streams the whole W_hh bank
// (2.32 MB) through its SM every step, and each weight element it holds
// serves only 8 rows: the product reads a weight from shared memory per 8
// FMAs, and the ring writes it there once, so the products are held near
// both the FP32 pipes' and shared memory's rates at once.  The old design
// (7 warps an SM, each loading its nodes' W_hh from L2 itself, cx loaded
// inside the mixes) spent a block and step on: products 115 400 cycles
// (44 600 of them waiting on those loads), mixes 82 200 (12 400 waiting on
// cx), the output head 16 300 (PERF.md §6, PR 10).
//
// Design:
// * A block owns 8 batch rows and runs all ph steps; blocks come in clusters
//   of 4 on adjacent row tiles, persistent over the tiles.  A block has three
//   warpgroups: 8 consumer warps (232 registers a thread by setmaxnreg), a
//   producer warp, a cx loader warp and two idle warps (40 registers).
// * W_hh and W_fc reach shared memory through a ring of two 32 256-byte
//   stages on mbarriers, filled by the producer: each block copies its
//   quarter of a stage (cp.async.bulk) and multicasts it into all four
//   blocks, so each weight byte read from L2 serves the cluster's 32 rows (8
//   before).  A stage is 4 bank rows × 21 nodes × the 96 gate columns of a
//   slice, from W_hh packed once by the wrapper
//   (gru_rollout.py::pack_rollout_bank: [slice][k][node][r|z|n columns], the
//   16-byte chunks of odd nodes swapped in halves so that the consumers'
//   loads hit distinct banks), or W_fc as it is.  A stage costs ~550 cycles
//   however large it is (up to 32 KB), so the stages are large and few.  No
//   consumer loads a weight from device memory.
// * A step runs the 96 hidden columns in 3 slices of 32.  For each slice 252
//   consumer threads (12 a node, 8 rows × 8 gate columns each) sum h·W_hh
//   over the ring in registers, a stage's weights loaded and the stage
//   released before its FMAs; meanwhile the loader warp copies the slice's
//   cx into P, the slice's gate buffer [node][r | z | n_h | n_x][8 rows][32]
//   (cp.async, completing on an mbarrier), as soon as the previous mix has
//   let go of P.  The products add b_hh (and the cx for r and z) into P.
// * The mix takes a thread per (row, column) and all 21 nodes: the four
//   areas' 21-term sums for every output node at once, input node by input
//   node (G_t transposed in shared memory, each of its values for four
//   sums), then the gate update with branch-free activations.  The new
//   hidden state of the first two slices stays in the thread's registers
//   until the last slice's products, which still read the old h, are done.
// * The output head reads W_fc from the ring (a thread per (node, row)), its
//   mix and the G update (a warp a row) close the step.
// * The slice loop and the mix's node loop stay rolled: fully unrolled, a
//   step was ~15 000 SASS instructions, too large for the instruction cache,
//   and the kernel took 128.4 ms against 96.2 rolled (~4 200).
//
// Shared memory (bytes): barriers 128; ring 2 × 32 256; h [21][8][96 + 4]
// fp32, 4 floats after each plane (rows and planes one bank quad on) 67 536; P
// 21 × 4 × 8 × 32 fp32 86 016; G_tᵀ, G_add, G_fc rows padded to 24: 6 048;
// total 224 240 of the 232 448 a block may have, one block an SM.
//
// Filling the card: 12 800 rows are 1 600 tiles, 400 items of 4 tiles; 30
// clusters of 4 fit on the 132 SMs at this shared memory (120 blocks, as
// cudaOccupancyMaxActiveClusters reports), so the items run in 14 rounds, the
// last with 10 of 30 clusters busy (13.3 rounds' worth).  In clusters of 2
// all 132 SMs would work (13 rounds) at 16 rows a weight byte from L2; a
// round's step took the same time (PERF.md §6, PR 10).
// The TPU kernel padded H to 128 lanes; here H stays at its real width.
//
// The node count N is the build's (node_mix.cuh, -DSKD_NODES: 16 for H36M,
// 17 for FreeMan, 21 for AMASS, 51 for AMASS-MANO); the figures above are at
// 21.  The product threads (12 a node), the ring stages (4 bank rows × N
// nodes × 96 columns), W_fc's stage, the cx copies, h, P and the G rows
// (padded to whole float4s) follow N.  The product threads and the head's
// two items a thread fit the 256 consumers up to 21 nodes.
//
// Past 21 nodes (nodemix::kWide; AMASS-MANO's 51) the same roles, ring,
// multicast and slices run a second design, chosen at compile time:
// * 2 rows a block (8 would need h 164 KB and P 209 KB at 51 nodes) and 2
//   bank rows a stage (39 168 B at 51): ring 78 336 + h 41 616 + P 52 224 +
//   G 31 824 + barriers = 204 128 B.  Each weight byte from L2 serves the
//   cluster's 8 rows, each in shared memory 2 rows: the products are bound
//   by shared memory, not by the FP32 pipes.
// * The products run in passes: 12 product tasks a node (8 gate columns × 2
//   rows), 612 at 51 nodes, thread tid takes tasks tid, tid + 256, tid + 512.
// * The mix takes 4 threads a (row, column) of the slice (64 positions),
//   each a quarter of the output nodes (13 at 51), all N input nodes: 52
//   sums a thread where one thread's 4·N would be 204.
// * W_fc (58 752 B at 51) comes in stages of up to kFcNodes nodes (two at
//   51); the head's product is a thread per (node, row) as before, in the
//   stage that holds its node; the G update takes two entries a lane.

#include "node_mix_sm90.cuh"

namespace {

using sm90mix::RingPos;

constexpr int kN = nodemix::kNodes, kH = 96, kF = 3;
constexpr bool kWide = nodemix::kWide;          // the design past 21 nodes
constexpr int kRows = kWide ? 2 : 8;            // batch rows a block
constexpr int kCluster = 4;                     // blocks a cluster, one multicast a stage
constexpr int kSlice = 32;                      // hidden columns a slice
constexpr int kSlices = kH / kSlice;            // 3
constexpr int kGateCols = 3 * kSlice;           // a node's r|z|n columns of a slice
constexpr int kKRows = kWide ? 2 : 4;           // bank rows a stage
constexpr int kStageFloats = kKRows * kN * kGateCols;  // 8 064 at 21 nodes
constexpr int kStageBytes = 4 * kStageFloats;          // 32 256
constexpr int kFcNodeBytes = 4 * kH * kF;              // a node's W_fc
constexpr int kFcNodes = kStageBytes / kFcNodeBytes < kN ? kStageBytes / kFcNodeBytes : kN;
constexpr int kFcStages = (kN + kFcNodes - 1) / kFcNodes;  // W_fc's stages: 1 up to 21 nodes
constexpr int kFcBytes = kFcNodes * kFcNodeBytes;      // 24 192 at 21: W_fc in one stage
constexpr int kKSteps = kH / kKRows;                   // stages a slice
constexpr int kMaxRing = 6;                     // full/empty pairs before the cx barriers
constexpr int kGRow = (kN + 3) / 4 * 4;         // G rows padded to whole float4s (24 at 21)
constexpr int kHRow = kH + 4;                   // floats between rows of h: one bank quad on
constexpr int kHPlane = kRows * kHRow + 4;      // floats between node planes of h
constexpr int kArea = kRows * kSlice;           // 256: one gate area of a node's P
constexpr int kPPlane = 4 * kArea;              // r, z, n_h, n_x
constexpr int kNodeThreads = 12;                // product threads (kWide: tasks) a node
constexpr int kProdThreads = kN * kNodeThreads;  // 252 at 21 nodes
constexpr int kConsumers = sm90mix::kConsumers;  // 256: 8 warps, two warpgroups
constexpr int kThreads = kConsumers + 128;      // and a third warpgroup: producer, cx loader
constexpr int kProducerWarp = 8, kLoaderWarp = 9;
constexpr int kConsumerRegs = 232, kOtherRegs = 40;  // setmaxnreg: 256·232 + 128·40 = 384·168
constexpr int kCxChunks = kN * 3 * kRows * (kSlice / 4);  // 16-byte chunks of a slice's cx
// kWide: product tasks a thread, threads a mix position, output nodes a mix thread
constexpr int kTaskPasses = (kProdThreads + kConsumers - 1) / kConsumers;  // 3 at 51 nodes
constexpr int kMixSplit = kConsumers / (kRows * kSlice);                   // 4 when kWide
constexpr int kMixNodes = (kN + kMixSplit - 1) / kMixSplit;                // 13 at 51 nodes
static_assert(kWide || kConsumers == kRows * kSlice, "the mix takes a thread per (row, column)");
static_assert(kWide || kProdThreads <= kConsumers,
              "a product thread a node's 8 gate columns: N ≤ 21");
static_assert(!kWide || (kMixSplit * kRows * kSlice == kConsumers && kMixSplit * kMixNodes <= kGRow),
              "kWide: the mix's threads split the output nodes of a position, G's zero padding "
              "past N covering the last split");
static_assert(kN <= 64, "the G update takes two entries a lane");
static_assert(kN * kRows * kF <= 2 * kConsumers, "the head's mix takes two items a thread");
static_assert(kN * kRows <= kConsumers, "the head's products take a thread per (node, row)");
static_assert(kGateCols == kNodeThreads * 8, "a product thread takes 8 gate columns");
static_assert(kStageBytes % (16 * kCluster) == 0 && kFcNodeBytes % (16 * kCluster) == 0,
              "a block's quarter of a stage is whole 16-byte chunks");
static_assert(kFcBytes <= kStageBytes, "a W_fc stage fits a ring stage");
static_assert(kConsumerRegs * kConsumers + kOtherRegs * 128 <= 168 * kThreads,
              "the register split fits the launch's allocation");

// Byte offsets of one block's shared memory; the wrapper's plan
// (gru_rollout.py::rollout_plan) computes the same total.
struct Layout {
  size_t ring, h, p, g, total;
};

__host__ __device__ constexpr Layout layout(int stages) {
  Layout l{};
  l.ring = 128;  // full[kMaxRing], empty[kMaxRing], cx_full, p_free
  l.h = l.ring + static_cast<size_t>(stages) * kStageBytes;
  l.p = l.h + sizeof(float) * kN * kHPlane;
  l.g = l.p + sizeof(float) * kN * kPPlane;
  l.total = l.g + sizeof(float) * 3 * kN * kGRow;
  return l;
}

// The gates' activations without branches (the library's division and
// tanhf branch to slow paths, which keeps the compiler from interleaving the
// 21 nodes' activations): 1/(1 + e^−x) and 1 − 2/(e^{2x} + 1), expf to
// ~1 ulp, the quotients to ~2 ulp; both saturate at ±∞.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + expf(-x)); }
__device__ __forceinline__ float tanh_gate(float x) {
  return 1.0f - __fdividef(2.0f, expf(2.0f * x) + 1.0f);
}

// The 16-byte chunk where the packed bank keeps chunk c of node m's row of a
// stage (gru_rollout.py::pack_rollout_bank swaps the halves of odd nodes).
__device__ __forceinline__ int chunk_at(int m, int c) { return c ^ ((m & 1) << 2); }

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// mbar_wait for the producer and the cx loader, which wait most of the time
// and share their SMs' schedulers with the consumers: they sleep between
// polls.  A fault in the protocol traps after ~10 s instead of hanging.
__device__ __forceinline__ void wait_idle(uint64_t* bar, uint32_t parity) {
  for (long long i = 0; !sm90mix::mbar_try_wait(bar, parity); ++i) {
    if (i > 150000000ll) __trap();
    __nanosleep(64);
  }
}

struct Block {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  uint32_t rank;
  int stages;
  RingPos q;

  __device__ __forceinline__ const float* wait_stage() {
    sm90mix::mbar_wait(&full[q.s], q.phase);
    return reinterpret_cast<const float*>(smem + 128 + static_cast<size_t>(q.s) * kStageBytes);
  }
  // the stage may be refilled once every block of the cluster is done with it
  __device__ __forceinline__ void release_stage() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      sm90mix::mbar_arrive(&empty[q.s]);
#pragma unroll
      for (uint32_t p = 1; p < kCluster; ++p)
        sm90mix::mbar_arrive_peer(&empty[q.s], (rank + p) % kCluster);
    }
    q.advance(stages);
  }
};

// The producer: for every item, step and slice the 24 stages of W_hh (kWide:
// 48), then W_fc's kFcStages; this block's quarter of each, multicast into
// the whole cluster.
__device__ __forceinline__ void produce(Block& b, const float* w_hh, const float* w_fc, int items,
                                        int ph) {
  constexpr uint16_t kAll = (1u << kCluster) - 1u;
  constexpr uint32_t kPart = kStageBytes / kCluster;
  constexpr int kHhStages = kSlices * kKSteps;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w_hh);
  const unsigned char* fb = reinterpret_cast<const unsigned char*>(w_fc);
  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count())
    for (int t = 0; t < ph; ++t)
      for (int i = 0; i < kHhStages + kFcStages; ++i, b.q.advance(b.stages)) {
        const int fc = i - kHhStages;  // W_fc's stage, or negative
        wait_idle(&b.empty[b.q.s], b.q.phase ^ 1u);  // every block is done with it
        unsigned char* st = b.smem + 128 + static_cast<size_t>(b.q.s) * kStageBytes;
        const int fc_nodes = fc >= 0 && kN - fc * kFcNodes < kFcNodes ? kN - fc * kFcNodes : kFcNodes;
        const uint32_t part = fc >= 0 ? fc_nodes * kFcNodeBytes / kCluster : kPart;
        sm90mix::mbar_expect_tx(&b.full[b.q.s], part * kCluster);
        const unsigned char* src = fc >= 0 ? fb + static_cast<size_t>(fc) * kFcBytes
                                           : wb + static_cast<size_t>(i) * kStageBytes;
        sm90mix::bulk_load_multicast(st + b.rank * part, src + b.rank * part, part,
                                     &b.full[b.q.s], kAll);
      }
}

// The cx loader warp: once P is free (p_free), each slice's cx of the tile
// into P's r, z and n_x areas (zeros past the last row), 16-byte cp.async
// copies, each lane's arrival on cx_full once its copies land.
__device__ __forceinline__ void load_cx(const float* cx, float* p_s, uint64_t* cx_full,
                                        uint64_t* p_free, int batch, int items, int ph,
                                        uint32_t rank) {
  const int lane = threadIdx.x & 31;
  uint32_t free_parity = 0;  // of p_free, which completes once a slice
  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(rank)) * kRows;
    const int valid = max(0, min(kRows, batch - b0));
    for (int t = 0; t < ph; ++t)
      for (int J = 0; J < kSlices; ++J) {
        wait_idle(p_free, free_parity);
        free_parity ^= 1u;
        for (int i = lane; i < kCxChunks; i += 32) {
          const int c = i % (kSlice / 4), r = i / (kSlice / 4) % kRows;
          const int a = i / (kSlice / 4 * kRows) % 3, m = i / (kSlice / 4 * kRows * 3);
          const int row = min(b0 + r, batch - 1);
          sm90mix::cp_async_16(
              p_s + m * kPPlane + (a == 2 ? 3 : a) * kArea + r * kSlice + 4 * c,
              cx + (static_cast<size_t>(m) * batch + row) * 3 * kH + a * kH + J * kSlice + 4 * c,
              r < valid ? 16u : 0u);
        }
        sm90mix::cp_async_arrive(cx_full);
      }
  }
}

// The consumers' views of shared memory: h, the gate buffer P, G_tᵀ, G_add,
// G_fc, and the cx loader's barriers.
struct Shared {
  float* h;
  float* p;
  float* g;
  const float* gadd;
  const float* gfc;
  uint64_t* cx_full;
  uint64_t* p_free;
};

// The consumers of the design up to 21 nodes (see the head of this
// file); KR is kKRows, a template parameter so that only the design of the
// build is instantiated.
template <int KR>
__device__ __forceinline__ void consume_narrow(Block& b, const Shared& sh, const float* __restrict__ h0,
                                               const float* __restrict__ b_hh,
                                               const float* __restrict__ g0,
                                               const float* __restrict__ b_fc,
                                               float* __restrict__ out, int batch, int ph,
                                               int items) {
  float* h_s = sh.h;
  float* p_s = sh.p;
  float* g_s = sh.g;
  const float* gfc_s = sh.gfc;
  const float* gadd_s = sh.gadd;
  uint64_t* cx_full = sh.cx_full;
  uint64_t* p_free = sh.p_free;
  static_assert(KR == 4, "a stage holds four bank rows (float4 loads of h)");
  const int tid = threadIdx.x, warp = tid >> 5;
  // product threads: node pm, gate columns of chunks ps and ps + 12 of the slice
  const int pm = tid / kNodeThreads, ps = tid % kNodeThreads;
  const bool prod = tid < kProdThreads;
  const float* hm = h_s + pm * kHPlane;
  // mix threads: row mr, column mj of the slice
  const int mr = warp, mj = tid & 31;
  // head threads: node hm_, row hr of the output head (all F outputs)
  const int hn_node = tid / kRows, hr = tid % kRows;
  const bool head = tid < kN * kRows;
  float bfc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) bfc[f] = head ? b_fc[hn_node * kF + f] : 0.0f;
  uint32_t cx_parity = 0;  // of cx_full, which completes once a slice

  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(b.rank)) * kRows;
    const int valid = max(0, min(kRows, batch - b0));
    for (int i = tid; i < kN * kRows * kH; i += kConsumers) {
      const int m = i / (kRows * kH), r = i / kH % kRows, k = i % kH;
      h_s[m * kHPlane + r * kHRow + k] =
          r < valid ? h0[(static_cast<size_t>(m) * batch + b0 + r) * kH + k] : 0.0f;
    }
    for (int i = tid; i < kN * kGRow; i += kConsumers) {
      const int m = i / kGRow, n = i % kGRow;
      g_s[i] = n < kN ? g0[n * kN + m] : 0.0f;
    }
    sm90mix::consumer_sync();
    if (tid == 0) sm90mix::mbar_arrive(p_free);  // the first slice's cx may come

    for (int t = 0; t < ph; ++t) {
      // h' of (row mr, column 32J + mj) of the two earlier slices, older
      // and newer; the slice loop stays rolled (the code of an unrolled
      // step outgrew the instruction cache)
      float h_old[kN], h_new[kN];
      static_assert(kSlices == 3, "two earlier slices are held");
#pragma unroll 1
      for (int J = 0; J < kSlices; ++J) {
        // P[pm] = h·W_hh for this thread's 8 rows × 8 columns; a stage's
        // weights go to registers and the stage is released before the FMAs
        float acc[kRows][8];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
#pragma unroll 1
        for (int ks = 0; ks < kKSteps; ++ks) {
          const float* st = b.wait_stage();
          float4 w[KR][2];
#pragma unroll
          for (int kk = 0; kk < KR; ++kk)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              w[kk][u] = prod ? *reinterpret_cast<const float4*>(
                                    st + kk * kN * kGateCols + pm * kGateCols +
                                    4 * chunk_at(pm, ps + 12 * u))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          b.release_stage();
          if (prod) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 hv = *reinterpret_cast<const float4*>(hm + r * kHRow + ks * KR);
              const float hk[KR] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int kk = 0; kk < KR; ++kk)
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  acc[r][4 * u] = fmaf(hk[kk], w[kk][u].x, acc[r][4 * u]);
                  acc[r][4 * u + 1] = fmaf(hk[kk], w[kk][u].y, acc[r][4 * u + 1]);
                  acc[r][4 * u + 2] = fmaf(hk[kk], w[kk][u].z, acc[r][4 * u + 2]);
                  acc[r][4 * u + 3] = fmaf(hk[kk], w[kk][u].w, acc[r][4 * u + 3]);
                }
            }
          }
        }
        sm90mix::mbar_wait(cx_full, cx_parity);  // the slice's cx is in P
        cx_parity ^= 1u;
        if (prod) {  // P += b_hh (+ the cx there for r and z)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = 4 * (ps + 12 * u), a = col / kSlice;
            const float4 bias = *reinterpret_cast<const float4*>(
                b_hh + pm * 3 * kH + a * kH + J * kSlice + col % kSlice);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float4* d = reinterpret_cast<float4*>(p_s + pm * kPPlane + a * kArea + r * kSlice +
                                                    col % kSlice);
              float4 v = make_float4(acc[r][4 * u] + bias.x, acc[r][4 * u + 1] + bias.y,
                                     acc[r][4 * u + 2] + bias.z, acc[r][4 * u + 3] + bias.w);
              if (a < 2) {  // r and z: mixed once over cx + h·W_hh + b_hh
                const float4 c = *d;
                v = make_float4(v.x + c.x, v.y + c.y, v.z + c.z, v.w + c.w);
              }
              *d = v;  // n: its h part into the n_h area
            }
          }
        }
        sm90mix::consumer_sync();
        // The mix of (row mr, column mj) over the nodes: all 21 output nodes
        // of the four areas at once, input node by input node (G's column m
        // from G_tᵀ in shared memory, each value for four sums): 84
        // independent sums, each in node order; then the gate update.
        {
          float y[4][kN];
#pragma unroll
          for (int n = 0; n < kN; ++n) y[0][n] = y[1][n] = y[2][n] = y[3][n] = 0.0f;
#pragma unroll 7
          for (int m = 0; m < kN; ++m) {
            float v[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) v[a] = p_s[m * kPPlane + a * kArea + tid];
            const float4* gc = reinterpret_cast<const float4*>(g_s + m * kGRow);
#pragma unroll
            for (int q4 = 0; q4 < kGRow / 4; ++q4) {
              const float4 g4 = gc[q4];
              const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = 4 * q4 + e;
                if (n < kN) {
#pragma unroll
                  for (int a = 0; a < 4; ++a) y[a][n] = fmaf(gv[e], v[a], y[a][n]);
                }
              }
            }
          }
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            const float rg = sigmoid(y[0][n]), zg = sigmoid(y[1][n]);
            const float ng = tanh_gate(y[3][n] + rg * y[2][n]);
            float* hp = h_s + n * kHPlane + mr * kHRow + J * kSlice + mj;
            const float hnew = ng - ng * zg + zg * *hp;
            // the last slice's products are done: its h' goes to h at once
            if (J == kSlices - 1) {
              *hp = hnew;
            } else {
              h_old[n] = h_new[n];
              h_new[n] = hnew;
            }
          }
        }
        sm90mix::consumer_sync();
        // P is free for the next slice's cx (after the last slice, once the
        // output head is done with it)
        if (J < kSlices - 1 && tid == 0) sm90mix::mbar_arrive(p_free);
      }
      // every product of the step has read h: h ← h'
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h_s[n * kHPlane + mr * kHRow + mj] = h_old[n];
        h_s[n * kHPlane + mr * kHRow + kSlice + mj] = h_new[n];
      }
      sm90mix::consumer_sync();

      // the output head before its mix, q[m][r][:] = b_fc + h'[m][r]·W_fc[m]
      // (W_fc [m][k][f] from the ring), a thread per (node, row)
      const float* wf = b.wait_stage();
      float* q_s = p_s;  // [N][rows][F]; P is free until the next slice's cx
      if (head) {
        // four bank rows at a time: h's float4 and W_fc's 12 values as 3 float4
        const float* hrow = h_s + hn_node * kHPlane + hr * kHRow;
        const float4* w4 = reinterpret_cast<const float4*>(wf + hn_node * kH * kF);
        float qa[kF] = {bfc[0], bfc[1], bfc[2]};
        float qb[kF] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int k4 = 0; k4 < kH / 4; ++k4) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + 4 * k4);
          const float4 a = w4[3 * k4], c = w4[3 * k4 + 1], e = w4[3 * k4 + 2];
          // [k][f] flattened: a = (k0f0 k0f1 k0f2 k1f0), c = (k1f1 k1f2 k2f0 k2f1),
          // e = (k2f2 k3f0 k3f1 k3f2)
          qa[0] = fmaf(hv.x, a.x, qa[0]);
          qa[1] = fmaf(hv.x, a.y, qa[1]);
          qa[2] = fmaf(hv.x, a.z, qa[2]);
          qb[0] = fmaf(hv.y, a.w, qb[0]);
          qb[1] = fmaf(hv.y, c.x, qb[1]);
          qb[2] = fmaf(hv.y, c.y, qb[2]);
          qa[0] = fmaf(hv.z, c.z, qa[0]);
          qa[1] = fmaf(hv.z, c.w, qa[1]);
          qa[2] = fmaf(hv.z, e.x, qa[2]);
          qb[0] = fmaf(hv.w, e.y, qb[0]);
          qb[1] = fmaf(hv.w, e.z, qb[1]);
          qb[2] = fmaf(hv.w, e.w, qb[2]);
        }
#pragma unroll
        for (int f = 0; f < kF; ++f) q_s[(hn_node * kRows + hr) * kF + f] = qa[f] + qb[f];
      }
      b.release_stage();
      sm90mix::consumer_sync();
      // y_t = tanh(G_fc·q), two items (node, row, output) a thread
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + kConsumers * u;
        if (e < kN * kRows * kF) {
          const int n = e / (kRows * kF), r = e / kF % kRows, f = e % kF;
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < kN; ++m)
            acc = fmaf(gfc_s[n * kGRow + m], q_s[(m * kRows + r) * kF + f], acc);
          if (r < valid)
            out[((static_cast<size_t>(t) * kN + n) * batch + b0 + r) * kF + f] = tanhf(acc);
        }
      }
      // G_{t+1} = l1norm_rows(G_t + G_add), the row norm clipped at 1e-12:
      // a warp a row n, a lane an entry m (G_t transposed in g_s)
      for (int n = warp; n < kN; n += sm90mix::kConsumerWarps) {
        const int m = tid & 31;
        const float v = m < kN ? g_s[m * kGRow + n] + gadd_s[n * kGRow + m] : 0.0f;
        float s = fabsf(v);
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (m < kN) g_s[m * kGRow + n] = v / fmaxf(s, 1e-12f);
      }
      sm90mix::consumer_sync();  // q and G_t are read before P and G change
      if (t + 1 < ph && tid == 0) sm90mix::mbar_arrive(p_free);
    }
  }
}

// The consumers of the design past 21 nodes (kWide, see the head of this
// file): the same steps as consume_narrow with product tasks in passes, four
// mix threads a position, W_fc in kFcStages stages and two G entries a lane.
template <int KR>
__device__ __forceinline__ void consume_wide(Block& b, const Shared& sh, const float* __restrict__ h0,
                                             const float* __restrict__ b_hh,
                                             const float* __restrict__ g0,
                                             const float* __restrict__ b_fc,
                                             float* __restrict__ out, int batch, int ph,
                                             int items) {
  static_assert(KR == 2, "a stage holds two bank rows (float2 loads of h)");
  float* h_s = sh.h;
  float* p_s = sh.p;
  float* g_s = sh.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // mix threads: position (row mr, column mj) of the slice, output nodes n0 …
  // n0 + kMixNodes − 1 (one split a warp; G_tᵀ's rows are zero past N)
  const int pos = tid % (kRows * kSlice), mr = pos / kSlice, mj = pos % kSlice;
  const int n0 = tid / (kRows * kSlice) * kMixNodes;
  // head threads: node hn, row hr of the output head (all F outputs)
  const int hn = tid / kRows, hr = tid % kRows;
  const bool head = tid < kN * kRows;
  float bfc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) bfc[f] = head ? b_fc[hn * kF + f] : 0.0f;
  uint32_t cx_parity = 0;  // of cx_full, which completes once a slice

  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(b.rank)) * kRows;
    const int valid = max(0, min(kRows, batch - b0));
    for (int i = tid; i < kN * kRows * kH; i += kConsumers) {
      const int m = i / (kRows * kH), r = i / kH % kRows, k = i % kH;
      h_s[m * kHPlane + r * kHRow + k] =
          r < valid ? h0[(static_cast<size_t>(m) * batch + b0 + r) * kH + k] : 0.0f;
    }
    for (int i = tid; i < kN * kGRow; i += kConsumers) {
      const int m = i / kGRow, n = i % kGRow;
      g_s[i] = n < kN ? g0[n * kN + m] : 0.0f;
    }
    sm90mix::consumer_sync();
    if (tid == 0) sm90mix::mbar_arrive(sh.p_free);  // the first slice's cx may come

    for (int t = 0; t < ph; ++t) {
      // h' of (row mr, column 32J + mj) of this thread's nodes for the two
      // earlier slices, older and newer
      float h_old[kMixNodes], h_new[kMixNodes];
      static_assert(kSlices == 3, "two earlier slices are held");
#pragma unroll 1
      for (int J = 0; J < kSlices; ++J) {
        // P[node] = h·W_hh for each of this thread's tasks (node, 8 gate
        // columns × kRows rows); a stage's weights go to registers and the
        // stage is released before the FMAs
        float acc[kTaskPasses][kRows][8];
#pragma unroll
        for (int i = 0; i < kTaskPasses; ++i)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][r][c] = 0.0f;
#pragma unroll 1
        for (int ks = 0; ks < kKSteps; ++ks) {
          const float* st = b.wait_stage();
          float4 w[kTaskPasses][KR][2];
#pragma unroll
          for (int i = 0; i < kTaskPasses; ++i) {
            const int task = tid + kConsumers * i, pm = task / kNodeThreads,
                      ps = task % kNodeThreads;
#pragma unroll
            for (int kk = 0; kk < KR; ++kk)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                w[i][kk][u] = task < kProdThreads
                                  ? *reinterpret_cast<const float4*>(
                                        st + kk * kN * kGateCols + pm * kGateCols +
                                        4 * chunk_at(pm, ps + 12 * u))
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
          b.release_stage();
#pragma unroll
          for (int i = 0; i < kTaskPasses; ++i) {
            const int task = tid + kConsumers * i;
            if (task >= kProdThreads) continue;
            const float* hm = h_s + task / kNodeThreads * kHPlane;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float2 hv = *reinterpret_cast<const float2*>(hm + r * kHRow + ks * KR);
              const float hk[KR] = {hv.x, hv.y};
#pragma unroll
              for (int kk = 0; kk < KR; ++kk)
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  acc[i][r][4 * u] = fmaf(hk[kk], w[i][kk][u].x, acc[i][r][4 * u]);
                  acc[i][r][4 * u + 1] = fmaf(hk[kk], w[i][kk][u].y, acc[i][r][4 * u + 1]);
                  acc[i][r][4 * u + 2] = fmaf(hk[kk], w[i][kk][u].z, acc[i][r][4 * u + 2]);
                  acc[i][r][4 * u + 3] = fmaf(hk[kk], w[i][kk][u].w, acc[i][r][4 * u + 3]);
                }
            }
          }
        }
        sm90mix::mbar_wait(sh.cx_full, cx_parity);  // the slice's cx is in P
        cx_parity ^= 1u;
#pragma unroll
        for (int i = 0; i < kTaskPasses; ++i) {  // P += b_hh (+ the cx there for r and z)
          const int task = tid + kConsumers * i, pm = task / kNodeThreads,
                    ps = task % kNodeThreads;
          if (task >= kProdThreads) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = 4 * (ps + 12 * u), a = col / kSlice;
            const float4 bias = *reinterpret_cast<const float4*>(
                b_hh + pm * 3 * kH + a * kH + J * kSlice + col % kSlice);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float4* d = reinterpret_cast<float4*>(p_s + pm * kPPlane + a * kArea + r * kSlice +
                                                    col % kSlice);
              float4 v = make_float4(acc[i][r][4 * u] + bias.x, acc[i][r][4 * u + 1] + bias.y,
                                     acc[i][r][4 * u + 2] + bias.z,
                                     acc[i][r][4 * u + 3] + bias.w);
              if (a < 2) {  // r and z: mixed once over cx + h·W_hh + b_hh
                const float4 c = *d;
                v = make_float4(v.x + c.x, v.y + c.y, v.z + c.z, v.w + c.w);
              }
              *d = v;  // n: its h part into the n_h area
            }
          }
        }
        sm90mix::consumer_sync();
        // The mix of position (mr, mj) for this thread's output nodes: the
        // four areas' sums, input node by input node (G_tᵀ's row m), each in
        // node order; then the gate update.
        {
          float y[4][kMixNodes];
#pragma unroll
          for (int e = 0; e < kMixNodes; ++e) y[0][e] = y[1][e] = y[2][e] = y[3][e] = 0.0f;
#pragma unroll 3
          for (int m = 0; m < kN; ++m) {
            float v[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) v[a] = p_s[m * kPPlane + a * kArea + pos];
            const float* gc = g_s + m * kGRow + n0;
#pragma unroll
            for (int e = 0; e < kMixNodes; ++e) {
              const float gv = gc[e];
#pragma unroll
              for (int a = 0; a < 4; ++a) y[a][e] = fmaf(gv, v[a], y[a][e]);
            }
          }
#pragma unroll
          for (int e = 0; e < kMixNodes; ++e) {
            const int n = n0 + e;
            if (n >= kN) continue;
            const float rg = sigmoid(y[0][e]), zg = sigmoid(y[1][e]);
            const float ng = tanh_gate(y[3][e] + rg * y[2][e]);
            float* hp = h_s + n * kHPlane + mr * kHRow + J * kSlice + mj;
            const float hnew = ng - ng * zg + zg * *hp;
            // the last slice's products are done: its h' goes to h at once
            if (J == kSlices - 1) {
              *hp = hnew;
            } else {
              h_old[e] = h_new[e];
              h_new[e] = hnew;
            }
          }
        }
        sm90mix::consumer_sync();
        // P is free for the next slice's cx (after the last slice, once the
        // output head is done with it)
        if (J < kSlices - 1 && tid == 0) sm90mix::mbar_arrive(sh.p_free);
      }
      // every product of the step has read h: h ← h'
#pragma unroll
      for (int e = 0; e < kMixNodes; ++e) {
        const int n = n0 + e;
        if (n >= kN) continue;
        h_s[n * kHPlane + mr * kHRow + mj] = h_old[e];
        h_s[n * kHPlane + mr * kHRow + kSlice + mj] = h_new[e];
      }
      sm90mix::consumer_sync();

      // the output head before its mix, q[m][r][:] = b_fc + h'[m][r]·W_fc[m],
      // a thread per (node, row), in the W_fc stage that holds its node
      float* q_s = p_s;  // [N][rows][F]; P is free until the next slice's cx
#pragma unroll 1
      for (int fs = 0; fs < kFcStages; ++fs) {
        const float* wf = b.wait_stage();
        if (head && hn / kFcNodes == fs) {
          const float* hrow = h_s + hn * kHPlane + hr * kHRow;
          const float4* w4 = reinterpret_cast<const float4*>(wf + (hn - fs * kFcNodes) * kH * kF);
          float qa[kF] = {bfc[0], bfc[1], bfc[2]};
          float qb[kF] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
          for (int k4 = 0; k4 < kH / 4; ++k4) {
            const float4 hv = *reinterpret_cast<const float4*>(hrow + 4 * k4);
            const float4 a = w4[3 * k4], c = w4[3 * k4 + 1], e = w4[3 * k4 + 2];
            qa[0] = fmaf(hv.x, a.x, qa[0]);
            qa[1] = fmaf(hv.x, a.y, qa[1]);
            qa[2] = fmaf(hv.x, a.z, qa[2]);
            qb[0] = fmaf(hv.y, a.w, qb[0]);
            qb[1] = fmaf(hv.y, c.x, qb[1]);
            qb[2] = fmaf(hv.y, c.y, qb[2]);
            qa[0] = fmaf(hv.z, c.z, qa[0]);
            qa[1] = fmaf(hv.z, c.w, qa[1]);
            qa[2] = fmaf(hv.z, e.x, qa[2]);
            qb[0] = fmaf(hv.w, e.y, qb[0]);
            qb[1] = fmaf(hv.w, e.z, qb[1]);
            qb[2] = fmaf(hv.w, e.w, qb[2]);
          }
#pragma unroll
          for (int f = 0; f < kF; ++f) q_s[(hn * kRows + hr) * kF + f] = qa[f] + qb[f];
        }
        b.release_stage();
      }
      sm90mix::consumer_sync();
      // y_t = tanh(G_fc·q), two items (node, row, output) a thread
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + kConsumers * u;
        if (e < kN * kRows * kF) {
          const int n = e / (kRows * kF), r = e / kF % kRows, f = e % kF;
          float acc = 0.0f;
#pragma unroll 3
          for (int m = 0; m < kN; ++m)
            acc = fmaf(sh.gfc[n * kGRow + m], q_s[(m * kRows + r) * kF + f], acc);
          if (r < valid)
            out[((static_cast<size_t>(t) * kN + n) * batch + b0 + r) * kF + f] = tanhf(acc);
        }
      }
      // G_{t+1} = l1norm_rows(G_t + G_add), the row norm clipped at 1e-12:
      // a warp a row n, a lane the entries m = lane and lane + 32
      for (int n = warp; n < kN; n += sm90mix::kConsumerWarps) {
        float v[2];
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = lane + 32 * j;
          v[j] = m < kN ? g_s[m * kGRow + n] + sh.gadd[n * kGRow + m] : 0.0f;
          s += fabsf(v[j]);
        }
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = lane + 32 * j;
          if (m < kN) g_s[m * kGRow + n] = v[j] / fmaxf(s, 1e-12f);
        }
      }
      sm90mix::consumer_sync();  // q and G_t are read before P and G change
      if (t + 1 < ph && tid == 0) sm90mix::mbar_arrive(sh.p_free);
    }
  }
}

// W: the design past 21 nodes (kWide), a template parameter so that only
// the build's design is instantiated.
template <bool W>
__global__ void __launch_bounds__(kThreads, 1)
gru_rollout_kernel(const float* __restrict__ cx, const float* __restrict__ h0,
                   const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                   const float* __restrict__ g0, const float* __restrict__ g_add,
                   const float* __restrict__ w_fc, const float* __restrict__ b_fc,
                   const float* __restrict__ g_fc, float* __restrict__ out, int batch, int ph,
                   int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(stages);
  float* h_s = reinterpret_cast<float*>(smem + l.h);
  float* p_s = reinterpret_cast<float*>(smem + l.p);
  float* g_s = reinterpret_cast<float*>(smem + l.g);  // G_tᵀ: [m][n]
  float* gadd_s = g_s + kN * kGRow;
  float* gfc_s = gadd_s + kN * kGRow;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* cx_full = bars + 2 * kMaxRing;
  uint64_t* p_free = cx_full + 1;
  const Shared sh{h_s, p_s, g_s, gadd_s, gfc_s, cx_full, p_free};
  const int tid = threadIdx.x, warp = tid >> 5;
  Block b{smem, bars, bars + kMaxRing, sm90mix::cluster_rank(), stages, RingPos{}};
  const int tiles = (batch + kRows - 1) / kRows;
  const int items = (tiles + kCluster - 1) / kCluster;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90mix::mbar_init(&b.full[s], 1);
      sm90mix::mbar_init(&b.empty[s], sm90mix::kConsumerWarps * kCluster);
    }
    sm90mix::mbar_init(cx_full, 32);  // the loader lanes' cp.async arrivals
    sm90mix::mbar_init(p_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kN * kGRow; i += kThreads) {
    const int n = i / kGRow, m = i % kGRow;
    gadd_s[i] = m < kN ? g_add[n * kN + m] : 0.0f;
    gfc_s[i] = m < kN ? g_fc[n * kN + m] : 0.0f;
  }
  sm90mix::cluster_sync();  // the peers' barriers exist before any copy reaches them

  if (warp >= sm90mix::kConsumerWarps) {
    regs_dec<kOtherRegs>();
    if (warp == kProducerWarp && (tid & 31) == 0) produce(b, w_hh, w_fc, items, ph);
    if (warp == kLoaderWarp) load_cx(cx, p_s, cx_full, p_free, batch, items, ph, b.rank);
    __syncwarp();
  } else {
    regs_inc<kConsumerRegs>();
    if constexpr (W) {
      consume_wide<kKRows>(b, sh, h0, b_hh, g0, b_fc, out, batch, ph, items);
    } else {
      consume_narrow<kKRows>(b, sh, h0, b_hh, g0, b_fc, out, batch, ph, items);
    }
  }
  sm90mix::cluster_sync();  // no block leaves while its peers may still reach its memory
}

}  // namespace

// cx [N, batch, 3H], h0 [N, batch, H], b_hh [N, 3H], g0, g_add, g_fc [N, N],
// w_fc [N, H, F], b_fc [N, F], out [ph, N, batch, F], all float32 and
// contiguous, the banks 16-byte aligned; w_hh is W_hh [N, H, 3H] packed by
// gru_rollout.py::pack_rollout_bank, and tile_rows, slice, stages, cluster and
// smem_bytes the plan of gru_rollout.py::rollout_plan.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// and plans the library does not instantiate.
extern "C" int gru_rollout_f32(const float* cx, const float* h0, const float* w_hh,
                               const float* b_hh, const float* g0, const float* g_add,
                               const float* w_fc, const float* b_fc, const float* g_fc,
                               float* out, int n_nodes, int batch, int hidden, int f_out, int ph,
                               int tile_rows, int slice, int stages, int cluster, int smem_bytes,
                               void* stream) {
  if (n_nodes != kN || hidden != kH || f_out != kF || batch <= 0 || ph <= 0 ||
      tile_rows != kRows || slice != kSlice || cluster != kCluster || stages < 2 ||
      stages > kMaxRing || static_cast<size_t>(smem_bytes) != layout(stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = ((batch + kRows - 1) / kRows + kCluster - 1) / kCluster;
  return static_cast<int>(sm90mix::launch<kThreads>(gru_rollout_kernel<kWide>, items, smem_bytes,
                                                    kCluster, stream, cx, h0, w_hh, b_hh, g0,
                                                    g_add, w_fc, b_fc, g_fc, out, batch, ph,
                                                    stages));
}

// The clusters of the kernel that fit on the card at once under the plan of
// gru_rollout.py::rollout_plan (stages, smem_bytes), into *clusters; returns
// the query's cudaError (the stream is not used).
extern "C" int gru_rollout_f32_clusters(int* clusters, int stages, int smem_bytes, void*) {
  if (stages < 2 || stages > kMaxRing || static_cast<size_t>(smem_bytes) != layout(stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return static_cast<int>(sm90mix::resident_clusters<kThreads>(gru_rollout_kernel<kWide>, smem_bytes,
                                                               kCluster, cfg, attr, clusters));
}
