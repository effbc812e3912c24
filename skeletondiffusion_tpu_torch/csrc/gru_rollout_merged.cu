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
// the rollout does ~2.3 TFLOP of bf16 products and mixes (77% of them the
// per-node h·W_hh products), 2.4 ms at the H100's 989 TFLOP/s, against
// ~0.65 GB of compulsory traffic.  Every step depends on the one before, and the state
// of 8 rows (h in fp32, its bf16 copy, a slice's gates) fills a block's
// shared memory, so each block streams the whole bf16 W_hh bank (1.16 MB)
// through its SM every step and each weight element it holds serves 8 rows.
// The first port (a wmma m8n32k16 product with the bank read from L2 by
// every block, the node mixes as fp32 FMAs with cx loaded inside them, a
// serial output head) took 120.96 ms on an NVIDIA H100 80GB HBM3 at
// 700.00 W, 1.26× the fp32 rollout (PERF.md §6).
//
// Design (the fp32 rollout's, gru_rollout.cu, on the tensor cores):
// * A block owns 8 batch rows and runs all ph steps; blocks come in clusters
//   of 2 on adjacent row tiles, persistent over the tiles.  A block has three
//   warpgroups: 8 consumer warps (232 registers a thread by setmaxnreg), a
//   producer warp, a cx loader warp and two idle warps (40 registers).
// * W_hh reaches shared memory through a ring of two 32 256-byte stages on
//   mbarriers, filled by the producer: each block copies its half of a stage
//   (cp.async.bulk) and multicasts it into both blocks, so each weight byte
//   read from L2 serves the cluster's 16 rows.  A stage is 16 bank rows × 21
//   nodes × the 48 gate columns of a slice (r | z | n of 16 hidden columns),
//   from W_hh packed once by the wrapper (gru_rollout.py::
//   pack_rollout_bank_bf16: [slice][k-step][node][k][48], the 16-byte chunks
//   of rows k with bit 2 set swapped in pairs, so that an ldmatrix of 8 bank
//   rows hits distinct banks).  No consumer loads a weight from device
//   memory.  In clusters of 4 (32 rows a weight byte) 120 of the 132 SMs
//   hold whole clusters, and the rollout took 1.10× as long (PERF.md §6).
// * Products on mma.sync m16n8k16 with no wasted tile rows: W_hhᵀ is the
//   16-row A operand (ldmatrix.trans from the stage), the block's 8 rows of
//   bf16(h) the n8 B operand, held in registers for the whole step (a warp
//   owns nodes w, w + 8, w + 16 and loads their bf16(h) once a step), so
//   the step's new h may be written while later slices still multiply the
//   old.  The accumulators start at b_hh; after a slice's six stages each
//   warp stores its nodes' hw3 (bf16) into the slice's gate buffer
//   [node][row][gate column], transposed by stmatrix.
// * The node mixes on mma.sync too, a warp a row and a slice's 16 hidden
//   columns (16 positions × 24 output nodes): A = the 16 positions' values
//   over the input nodes (ldmatrix.trans across the node planes of the gate
//   buffers), B = bf16(G_t) in registers for the step.  r and z are mixed as
//   [gc | gc]·[cx ; hw3] over K = 2N (rows 42–47 read a zero row), which is
//   the Pallas kernel's mix(cx) + mix(hw3): a product of bf16 values is exact
//   in fp32.  n's two parts are mixed apart (k16 + k8 over 21 nodes).  The
//   sums stay fp32 in the accumulators and go straight to the gate update,
//   whose fp32 h lives in shared memory in the accumulators' order (each
//   thread reads and writes only its own), and which stores bf16(h') by
//   stmatrix too.
// * The mixes and gate updates of slice J - 1 run between the ring stages of
//   slice J's products (the mixes after stage 0, a tile of the gate update
//   after each of stages 1–3), so the ring refills while the warps work on
//   the activations; the last slice's are done alone.
// * cx is prefetched: the loader warp copies the next slice's cx of the tile
//   into the slice's cx buffer (cp.async, completing on an mbarrier) while
//   the products run, as soon as every warp's mix has let go of it.
// * The output head on the tensor cores: W_fcᵀ (3 of 16 rows) as A fragments
//   gathered once into shared memory, the next step's bf16(h) fragments as B.
//   G_{t+1} takes a warp a row (shuffle sums) in the same phase; the head's
//   node mix and the stores close the step.
//
// Shared memory (bytes): barriers, a zero row and a junk row 128; ring 2 ×
// 32 256; h fp32 in accumulator order 6 slices × 8 warps × 1 536 = 73 728;
// bf16(h) [21][8][104] with 16 bytes after each plane 35 280; the slice's
// hw3 and cx [21][8][56] with 16 bytes after each plane, 19 152 each; W_fcᵀ
// fragments 12 096; G_t, G_add, G_fc rows padded to 24: 6 048; the head's
// outputs 2 016; total 232 112 of the 232 448 a block may have, one block
// an SM.
// The TPU kernel padded H to 128 lanes and F to 8 rows; here both stay real.
//
// The node count N is the build's (node_mix.cuh, -DSKD_NODES: 16 for H36M,
// 17 for FreeMan, 21 for AMASS, 51 for AMASS-MANO); the figures above are at
// 21.  Up to 21 nodes the tiles follow N: a warp's product nodes, the mixes'
// output tiles and the r/z mix's k16 tiles over 2N number ⌈N/8⌉ (3 at 21 and
// 17, 2 at 16), n's mix is a k16 and a k8 tile as N needs them, the gate
// update takes a tile a ring stage, and the stages, cx, bf16(h), the gate
// buffers, W_fcᵀ and G follow N (the zero and junk rows stand in for nodes
// past N).  Past 21 nodes (nodemix::kWide) a second design runs, chosen at
// compile time: see its section below.

#include "node_mix_sm90.cuh"

// Probe points: scripts/torch_rollout_probe.py redefines this to read
// clock64() at each of them; here it is nothing.
#define ROLLOUT_STAMP(k)

namespace {

using bf16 = __nv_bfloat16;
using sm90mix::RingPos;

constexpr int kN = nodemix::kNodes, kH = 96, kF = 3;
static_assert(nodemix::kWide == (SKD_NODES > 21), "the #if below picks the design of kWide");

// The gates' activations: 1/(1 + e^−x) without branches, e^−x as
// ex2.approx of −x·log2 e (__expf), the quotient to ~2 ulp (r and z are
// rounded to bf16 after it; expf moved B8's mean deviation from the plain
// version by 0.5%); tanh as the library's tanhf, to ~2 ulp everywhere.  The
// fp32 rollout's branch-free 1 − 2/(e^{2x} + 1) loses the relative
// precision of small results to the cancellation, which moves bf16(h') off
// the plain version's often enough to raise B8's mean deviation from it by
// ~40% (PERF.md §6).
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_gate(float x) {
  return tanhf(x);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

#if SKD_NODES <= 21
// ---- the design up to 21 nodes ---------------------------------------------
// Node tiles of 8: a warp's product nodes (w, w + 8, …), the mixes' output
// tiles and the r/z mix's k16 tiles over 2N all number kNT; n's mix is a k16
// tile (nodes 0–15, past 8 nodes) and a k8 tile (the nodes past 16, or all
// of up to 8).
constexpr int kNT = (kN + 7) / 8;               // 3 at 21 nodes, 2 at 16, 3 at 17
constexpr bool kNk16 = kN > 8;                  // n's mix has a k16 tile
constexpr bool kNk8 = kN > 16 || kN <= 8;       // and a k8 tile
constexpr int kK8Base = kNk16 ? 16 : 0;         // the k8 tile's first node
constexpr int kRows = 8;                        // batch rows a block (the products' n8)
constexpr int kCluster = 2;                     // blocks a cluster, one multicast a stage
constexpr int kSlice = 16;                      // hidden columns a slice
constexpr int kSlices = kH / kSlice;            // 6
constexpr int kGateCols = 3 * kSlice;           // 48: a node's r|z|n columns of a slice
constexpr int kKRows = 16;                      // bank rows a stage (one mma k-step)
constexpr int kKSteps = kH / kKRows;            // 6 stages a slice
constexpr int kStages = 2;                      // ring stages
constexpr int kStageNode = kKRows * kGateCols * 2;  // 1 536 bytes of a node in a stage
constexpr int kStageBytes = kN * kStageNode;        // 32 256
constexpr int kGRow = 8 * kNT;                  // G rows padded to whole node tiles (24 at 21)
constexpr int kPRow = 112;                      // bytes between rows of a gate buffer's plane
constexpr int kPPlane = kRows * kPRow + 16;     // 912: bytes between its node planes
constexpr int kHbRow = 208;                     // bytes between rows of bf16(h) (104 values)
constexpr int kHbPlane = kRows * kHbRow + 16;   // 1 680
constexpr int kHFrag = kNT * 32 * 4;            // fp32 h of one warp and slice: kNT n8 tiles
constexpr int kConsumers = sm90mix::kConsumers;  // 256: 8 warps, two warpgroups
constexpr int kWarps = sm90mix::kConsumerWarps;
constexpr int kThreads = kConsumers + 128;      // and a third warpgroup: producer, cx loader
constexpr int kProducerWarp = 8, kLoaderWarp = 9;
constexpr int kConsumerRegs = 232, kOtherRegs = 40;  // setmaxnreg: 256·232 + 128·40 = 384·168
constexpr int kCxChunks = kN * kRows * 6;       // 16-byte chunks of a slice's cx (r, z, n × 2)
constexpr int kFcFrags = kN * kKSteps * 12;     // W_fcᵀ A fragments: lanes 0–11 hold rows 0–2
constexpr int kZero = 48;                       // a zero row: the mix's rows past the nodes
constexpr int kJunk = 64;                       // a row the stores of nodes past kN go to
constexpr int kGateStages = kNT;                // ring stages the gate update's tiles spread over
static_assert(kGateStages + 1 <= kKSteps, "a tile of the gate update a ring stage");
static_assert(kN * kRows * kF <= 2 * kConsumers && kN <= 32,
              "the head's mix takes two items a thread, the G update an entry a lane");
static_assert(kWarps == kRows, "the mix takes a warp a row");
static_assert(kStages <= kKSteps - 2,
              "a warp mixes slice J - 1 before it releases stage 1 of slice J, so no warp "
              "reaches stage kKSteps - 1 of slice J and writes its hw3 before every warp of the "
              "cluster has read slice J - 1's");
static_assert((kStageBytes / kCluster) % 16 == 0, "a block's part of a stage is whole chunks");
static_assert(kConsumerRegs * kConsumers + kOtherRegs * 128 <= 168 * kThreads,
              "the register split fits the launch's allocation");

// Byte offsets of one block's shared memory; the wrapper's plan
// (gru_rollout.py::rollout_bf16_plan) computes the same total.
struct Layout {
  static constexpr size_t ring = 128;  // full[2], empty[2], cx_full, cx_free; zero, junk rows
  static constexpr size_t h32 = ring + kStages * kStageBytes;
  static constexpr size_t hb = h32 + sizeof(float) * kSlices * kWarps * kHFrag;
  static constexpr size_t hw3 = hb + kN * kHbPlane;
  static constexpr size_t cx = hw3 + kN * kPPlane;
  static constexpr size_t fc = cx + kN * kPPlane;
  static constexpr size_t g = fc + 8 * kFcFrags;
  static constexpr size_t q = g + sizeof(float) * 3 * kN * kGRow;
  static constexpr size_t total = q + sizeof(float) * kN * kRows * kF;
};
static_assert(Layout::total <= sm90mix::kMaxSmem, "one block an SM");
static_assert(Layout::h32 % 16 == 0 && Layout::hb % 16 == 0 && Layout::hw3 % 16 == 0 &&
                  Layout::cx % 16 == 0 && Layout::fc % 16 == 0 && Layout::g % 16 == 0,
              "16-byte aligned buffers (ldmatrix rows, cp.async, float4)");

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Fragments of 8×8 bf16 matrices stored transposed: register i of each lane
// holds matrix i's (row lane/4, columns 2·(lane%4), +1), which go to memory
// row 2·(lane%4) (+1) of matrix i, column lane/4; lane l gives the address of
// memory row l%8 of matrix l/8.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
                   "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a·b, m16n8k8, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
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

struct Ring {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  uint32_t rank;
  RingPos q;

  __device__ __forceinline__ uint32_t wait_stage() {
    sm90mix::mbar_wait(&full[q.s], q.phase);
    return sm90mix::smem_u32(smem + Layout::ring + static_cast<size_t>(q.s) * kStageBytes);
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
    q.advance(kStages);
  }
};

// The producer: for every item, step, slice and k-step one stage of the
// packed W_hh, this block's part of it multicast into the whole cluster.
__device__ __forceinline__ void produce(Ring& b, const bf16* w_hh, int items, int ph) {
  constexpr uint16_t kAll = (1u << kCluster) - 1u;
  constexpr uint32_t kPart = kStageBytes / kCluster;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w_hh);
  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count())
    for (int t = 0; t < ph; ++t)
      for (int i = 0; i < kSlices * kKSteps; ++i, b.q.advance(kStages)) {
        wait_idle(&b.empty[b.q.s], b.q.phase ^ 1u);  // every block is done with it
        unsigned char* st = b.smem + Layout::ring + static_cast<size_t>(b.q.s) * kStageBytes;
        sm90mix::mbar_expect_tx(&b.full[b.q.s], kStageBytes);
        sm90mix::bulk_load_multicast(st + b.rank * kPart,
                                     wb + static_cast<size_t>(i) * kStageBytes + b.rank * kPart,
                                     kPart, &b.full[b.q.s], kAll);
      }
}

// The cx loader warp: once every consumer warp has let go of the cx buffer
// (cx_free), each slice's cx of the tile into it, [node][row][r | z | n
// columns] (zeros past the last row), 16-byte cp.async copies, each lane's
// arrival on cx_full once its copies land.
__device__ __forceinline__ void load_cx(const bf16* cx, unsigned char* cx_s, uint64_t* cx_full,
                                        uint64_t* cx_free, int batch, int items, int ph,
                                        uint32_t rank) {
  const int lane = threadIdx.x & 31;
  uint32_t free_parity = 0;  // of cx_free, which completes once a slice
  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(rank)) * kRows;
    const int valid = max(0, min(kRows, batch - b0));
    for (int t = 0; t < ph; ++t)
      for (int J = 0; J < kSlices; ++J) {
        wait_idle(cx_free, free_parity);
        free_parity ^= 1u;
        for (int i = lane; i < kCxChunks; i += 32) {
          const int half = i & 1, a = (i >> 1) % 3, r = (i / 6) % kRows, m = i / (6 * kRows);
          const int row = min(b0 + r, batch - 1);
          sm90mix::cp_async_16(
              cx_s + m * kPPlane + r * kPRow + a * 32 + half * 16,
              cx + (static_cast<size_t>(m) * batch + row) * 3 * kH + a * kH + J * kSlice + 8 * half,
              r < valid ? 16u : 0u);
        }
        sm90mix::cp_async_arrive(cx_full);
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gru_rollout_merged_kernel(const bf16* __restrict__ cx, const float* __restrict__ h0,
                          const bf16* __restrict__ w_hh, const float* __restrict__ b_hh,
                          const float* __restrict__ g0, const float* __restrict__ g_add,
                          const bf16* __restrict__ w_fc, const float* __restrict__ b_fc,
                          const float* __restrict__ g_fc, float* __restrict__ out, int batch,
                          int ph) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* h32 = reinterpret_cast<float*>(smem + Layout::h32);
  unsigned char* hb_s = smem + Layout::hb;
  unsigned char* hw3_s = smem + Layout::hw3;
  unsigned char* cx_s = smem + Layout::cx;
  uint2* fc_s = reinterpret_cast<uint2*>(smem + Layout::fc);
  float* g_s = reinterpret_cast<float*>(smem + Layout::g);  // G_t [n][m]
  float* gadd_s = g_s + kN * kGRow;
  float* gfc_s = gadd_s + kN * kGRow;
  float* q_s = reinterpret_cast<float*>(smem + Layout::q);  // [N][rows][F]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* cx_full = bars + 2 * kStages;
  uint64_t* cx_free = cx_full + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring{smem, bars, bars + kStages, sm90mix::cluster_rank(), RingPos{}};
  const int tiles = (batch + kRows - 1) / kRows;
  const int items = (tiles + kCluster - 1) / kCluster;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90mix::mbar_init(&ring.full[s], 1);
      sm90mix::mbar_init(&ring.empty[s], kWarps * kCluster);
    }
    sm90mix::mbar_init(cx_full, 32);  // the loader lanes' cp.async arrivals
    sm90mix::mbar_init(cx_free, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(smem + kZero)[tid] = 0u;
  for (int i = tid; i < kN * kGRow; i += kThreads) {
    const int n = i / kGRow, m = i % kGRow;
    gadd_s[i] = m < kN ? g_add[n * kN + m] : 0.0f;
    gfc_s[i] = m < kN ? g_fc[n * kN + m] : 0.0f;
  }
  // W_fcᵀ as the head's A fragments: rows f < 3 of lanes 0–11, k-step ks
  for (int i = tid; i < kFcFrags; i += kThreads) {
    const int m = i / (kKSteps * 12), ks = i / 12 % kKSteps, l = i % 12;
    const int f = l >> 2, k = kKRows * ks + 2 * (l & 3);
    const bf16* w = w_fc + static_cast<size_t>(m) * kH * kF + f;
    __nv_bfloat162 lo, hi;
    lo.x = w[k * kF];
    lo.y = w[(k + 1) * kF];
    hi.x = w[(k + 8) * kF];
    hi.y = w[(k + 9) * kF];
    fc_s[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
  }
  sm90mix::cluster_sync();  // the peers' barriers exist before any copy reaches them

  if (warp >= kWarps) {
    regs_dec<kOtherRegs>();
    if (warp == kProducerWarp && lane == 0) produce(ring, w_hh, items, ph);
    if (warp == kLoaderWarp) load_cx(cx, cx_s, cx_full, cx_free, batch, items, ph, ring.rank);
    __syncwarp();
  } else {
    regs_inc<kConsumerRegs>();
    const int g = lane >> 2, tq = lane & 3;
    // the products' nodes of this warp: w, w + 8, … (< kN)
    const int nodes = warp < kN ? (kN - warp + 7) / 8 : 0;
    // ldmatrix.trans of W_hhᵀ from a stage: lane → bank row k of matrix
    // lane/8, its chunk of 8 columns (pairs swapped where bit 2 of k is set)
    const int wk = (lane & 7) + 8 * (lane >> 4);
    const uint32_t w_lane = wk * (kGateCols * 2) + ((((lane >> 3) & 1) ^ ((wk >> 2) & 1)) << 4);
    // ldmatrix of bf16(h): lane → row lane%8, k-chunk lane/8
    const uint32_t hb_lane = sm90mix::smem_u32(hb_s) + (lane & 7) * kHbRow + (lane >> 3) * 16;
    // the mix's ldmatrix.trans: lane → input node (lane%8 + 8·(lane/16)) of
    // a k-step, positions 8·((lane/8)%2) …
    const int mk = (lane & 7) + 8 * (lane >> 4);
    const uint32_t zero = sm90mix::smem_u32(smem + kZero);
    const uint32_t row_off = warp * kPRow + ((lane >> 3) & 1) * 16;
    auto plane = [&](int k) {  // the node plane of virtual input k of [cx ; hw3]
      return k < kN ? sm90mix::smem_u32(cx_s) + k * kPPlane + row_off
                    : k < 2 * kN ? sm90mix::smem_u32(hw3_s) + (k - kN) * kPPlane + row_off : 0u;
    };
    uint32_t a_rz[kNT], a_x16, a_h16, a_x8, a_h8;  // 0 reads the zero row
#pragma unroll
    for (int s = 0; s < kNT; ++s) a_rz[s] = plane(16 * s + mk);
    a_x16 = mk < kN ? sm90mix::smem_u32(cx_s) + mk * kPPlane + row_off : 0u;
    a_h16 = mk < kN ? sm90mix::smem_u32(hw3_s) + mk * kPPlane + row_off : 0u;
    {
      const int k8 = kK8Base + (lane & 7);  // lanes 0–15 of the x2
      a_x8 = k8 < kN ? sm90mix::smem_u32(cx_s) + k8 * kPPlane + row_off : 0u;
      a_h8 = k8 < kN ? sm90mix::smem_u32(hw3_s) + k8 * kPPlane + row_off : 0u;
    }
    auto at = [&](uint32_t a, uint32_t gate) { return a ? a + gate : zero; };
    float bfc[kNT];
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int m = warp + 8 * i;
      bfc[i] = (i < nodes && g < kF) ? b_fc[m * kF + g] : 0.0f;
    }
    uint32_t bh[kNT][kKSteps][2];  // bf16(h) of this warp's nodes, the products' B
    uint32_t grz[kNT][kNT][2], gx16[kNT][2], gx8[kNT];  // bf16(G_t), the mixes' B
    uint32_t cx_parity = 0;  // of cx_full, which completes once a slice

    // the B fragments of bf16(h) of this warp's nodes (after a barrier that
    // follows the last write of bf16(h))
    auto load_h = [&]() {
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (i < nodes) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            uint32_t r[4];
            sm90mix::ldmatrix_x4(r, hb_lane + (warp + 8 * i) * kHbPlane + c * 64);
            bh[i][2 * c][0] = r[0];
            bh[i][2 * c][1] = r[1];
            bh[i][2 * c + 1][0] = r[2];
            bh[i][2 * c + 1][1] = r[3];
          }
        }
      }
    };
    // bf16(G_t) as the mixes' B fragments: [gc | gc] over 16·kNT rows for r
    // and z, gc over the k16 and k8 tiles for n's parts (after a barrier that
    // follows G_t's last write)
    auto load_g = [&]() {
      auto gc = [&](int n, int m) {  // rows past the nodes are zero
        return n < kN && m < kN ? g_s[n * kGRow + m] : 0.0f;
      };
      auto gv = [&](int n, int k) { return gc(n, k < kN ? k : k < 2 * kN ? k - kN : kN); };
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = 8 * nt + g;
#pragma unroll
        for (int s = 0; s < kNT; ++s) {
          const int k = 16 * s + 2 * tq;
          grz[s][nt][0] = sm90mix::pack_bf16(gv(n, k), gv(n, k + 1));
          grz[s][nt][1] = sm90mix::pack_bf16(gv(n, k + 8), gv(n, k + 9));
        }
        gx16[nt][0] = sm90mix::pack_bf16(gc(n, 2 * tq), gc(n, 2 * tq + 1));
        gx16[nt][1] = sm90mix::pack_bf16(gc(n, 2 * tq + 8), gc(n, 2 * tq + 9));
        gx8[nt] = sm90mix::pack_bf16(gc(n, kK8Base + 2 * tq), gc(n, kK8Base + 1 + 2 * tq));
      }
    };

    for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
      const int b0 = (item * kCluster + static_cast<int>(ring.rank)) * kRows;
      const int valid = max(0, min(kRows, batch - b0));
      sm90mix::consumer_sync();  // the last item's reads are done
      // h0 into h (fp32, accumulator order) and bf16(h); G_t ← G0
#pragma unroll 1
      for (int J = 0; J < kSlices; ++J) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 8 * nt + 2 * tq + (e & 1), j = J * kSlice + g + 8 * (e >> 1);
            v[e] = n < kN && warp < valid
                       ? h0[(static_cast<size_t>(n) * batch + b0 + warp) * kH + j]
                       : 0.0f;
            if (n < kN)
              *reinterpret_cast<bf16*>(hb_s + n * kHbPlane + warp * kHbRow + 2 * j) =
                  __float2bfloat16_rn(v[e]);
          }
          *reinterpret_cast<float4*>(h32 + ((J * kWarps + warp) * kNT + nt) * 128 + 4 * lane) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      for (int i = tid; i < kN * kGRow; i += kConsumers) {
        const int n = i / kGRow, m = i % kGRow;
        g_s[i] = m < kN ? g0[n * kN + m] : 0.0f;
      }
      if (lane == 0) sm90mix::mbar_arrive(cx_free);  // the first slice's cx may come
      sm90mix::consumer_sync();
      load_h();
      load_g();

      for (int t = 0; t < ph; ++t) {
        ROLLOUT_STAMP(0);
        // Pass J multiplies slice J (its six ring stages) and, between the
        // stages, mixes slice J - 1 and updates its gates; pass kSlices only
        // mixes and updates the last slice.  A warp's mix of slice J - 1
        // comes before its release of stage 1 of slice J, so with two ring
        // stages no warp can reach stage 3, let alone write slice J's hw3,
        // before every warp of the cluster has read slice J - 1's.
#pragma unroll 1
        for (int J = 0; J <= kSlices; ++J) {
          const bool multiply = J < kSlices, update = J > 0;
          const int Jm = J - 1;
          // ---- hw3 of this warp's nodes for slice J's 48 gate columns, the
          // sums started at b_hh
          float acc[kNT][3][4];
          if (multiply) {
#pragma unroll
            for (int i = 0; i < kNT; ++i)
#pragma unroll
              for (int a = 0; a < 3; ++a) {
                const float* b = b_hh + (warp + 8 * i) * 3 * kH + a * kH + J * kSlice + g;
                const float lo = i < nodes ? __ldg(b) : 0.0f;
                const float hi = i < nodes ? __ldg(b + 8) : 0.0f;
                acc[i][a][0] = acc[i][a][1] = lo;
                acc[i][a][2] = acc[i][a][3] = hi;
              }
          }
          float yr[kNT][4], yz[kNT][4], yx[kNT][4], yh[kNT][4];
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            if (multiply) {
              ROLLOUT_STAMP(1);
              const uint32_t st = ring.wait_stage() + w_lane;
              ROLLOUT_STAMP(2);
#pragma unroll
              for (int i = 0; i < kNT; ++i) {
                if (i < nodes) {
#pragma unroll
                  for (int a = 0; a < 3; ++a) {
                    uint32_t wa[4];
                    sm90mix::ldmatrix_x4_trans(wa, st + (warp + 8 * i) * kStageNode + a * 32);
                    sm90mix::mma_bf16(acc[i][a], wa, bh[i][ks][0], bh[i][ks][1]);
                  }
                }
              }
              ring.release_stage();
              ROLLOUT_STAMP(3);
            }
            if (update && ks == 0) {
              // ---- the mixes of row `warp`, slice J - 1's 16 hidden columns
              sm90mix::mbar_wait(cx_full, cx_parity);  // its cx has landed
              cx_parity ^= 1u;
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) yr[nt][e] = yz[nt][e] = yx[nt][e] = yh[nt][e] = 0.0f;
#pragma unroll
              for (int s = 0; s < kNT; ++s) {
                uint32_t ar[4], az[4];
                sm90mix::ldmatrix_x4_trans(ar, at(a_rz[s], 0));
                sm90mix::ldmatrix_x4_trans(az, at(a_rz[s], 32));
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                  sm90mix::mma_bf16(yr[nt], ar, grz[s][nt][0], grz[s][nt][1]);
                  sm90mix::mma_bf16(yz[nt], az, grz[s][nt][0], grz[s][nt][1]);
                }
              }
              if constexpr (kNk16) {
                uint32_t ax[4], ah[4];
                sm90mix::ldmatrix_x4_trans(ax, at(a_x16, 64));
                sm90mix::ldmatrix_x4_trans(ah, at(a_h16, 64));
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                  sm90mix::mma_bf16(yx[nt], ax, gx16[nt][0], gx16[nt][1]);
                  sm90mix::mma_bf16(yh[nt], ah, gx16[nt][0], gx16[nt][1]);
                }
              }
              if constexpr (kNk8) {
                uint32_t ax8[2], ah8[2];
                ldmatrix_x2_trans(ax8, at(a_x8, 64));
                ldmatrix_x2_trans(ah8, at(a_h8, 64));
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                  mma_bf16_k8(yx[nt], ax8, gx8[nt]);
                  mma_bf16_k8(yh[nt], ah8, gx8[nt]);
                }
              }
              // this warp is done with the slice's cx (the last slice of an
              // item lets go of it at the next item's start)
              __syncwarp();
              if (lane == 0 && (t + 1 < ph || J < kSlices)) sm90mix::mbar_arrive(cx_free);
              ROLLOUT_STAMP(4);
            }
            if (update && ks >= 1 && ks <= kGateStages) {
              // ---- the gate update of tiles nt: element e is output node
              // 8nt + 2tq + e%2, hidden column 16(J - 1) + g + 8(e/2)
              {
                const int nt = ks - 1;
                float4* hp =
                    reinterpret_cast<float4*>(h32 + ((Jm * kWarps + warp) * kNT + nt) * 128) + lane;
                const float4 hv = *hp;
                const float h_old[4] = {hv.x, hv.y, hv.z, hv.w};
                float h_new[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float rg = bf16_round(sigmoid(yr[nt][e]));
                  const float zg = bf16_round(sigmoid(yz[nt][e]));
                  const float ng = tanh_gate(yx[nt][e] + rg * yh[nt][e]);
                  h_new[e] = ng - ng * zg + zg * h_old[e];
                }
                *hp = make_float4(h_new[0], h_new[1], h_new[2], h_new[3]);
                // bf16(h') of 8 nodes × 16 columns: memory row = node (nodes
                // past kN to the junk row), 8 columns a matrix
                const int n = 8 * nt + (lane & 7);
                stmatrix_x2_trans(n < kN ? sm90mix::smem_u32(hb_s) + n * kHbPlane + warp * kHbRow +
                                               2 * (Jm * kSlice) + ((lane >> 3) & 1) * 16
                                         : sm90mix::smem_u32(smem + kJunk),
                                  sm90mix::pack_bf16(h_new[0], h_new[1]),
                                  sm90mix::pack_bf16(h_new[2], h_new[3]));
              }
              ROLLOUT_STAMP(5);
            }
          }
          if (multiply) {
            // D[gate column 16a + g (+8)][row 2tq (+1)] → slice J's hw3
            // [node][row][gate column], transposed by stmatrix: lane l gives
            // row l%8 of matrix l/8 (gate a = l/16, columns 8·((l/8)%2) …)
#pragma unroll
            for (int i = 0; i < kNT; ++i) {
              if (i < nodes) {
                const uint32_t p = sm90mix::smem_u32(hw3_s) + (warp + 8 * i) * kPPlane +
                                   (lane & 7) * kPRow + (lane >> 3) * 16;
                auto pk = [&](int a, int e) {
                  return sm90mix::pack_bf16(acc[i][a][e], acc[i][a][e + 1]);
                };
                stmatrix_x4_trans(p, pk(0, 0), pk(0, 2), pk(1, 0), pk(1, 2));
                stmatrix_x2_trans(p + 64, pk(2, 0), pk(2, 2));
              }
            }
          }
          ROLLOUT_STAMP(6);
          // slice J's hw3 is written; after the last pass, bf16(h') is complete
          sm90mix::consumer_sync();
          ROLLOUT_STAMP(7);
        }
        // ---- the next step's B fragments; the output head before its mix,
        // q[m][r][f] = b_fc + bf16(h')[m][r]·W_fc[m][:, f] on the tensor cores
        load_h();
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (i < nodes) {
            const int m = warp + 8 * i;
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int ks = 0; ks < kKSteps; ++ks) {
              const uint2 f = lane < 12 ? fc_s[(m * kKSteps + ks) * 12 + lane] : make_uint2(0u, 0u);
              const uint32_t a[4] = {f.x, 0u, f.y, 0u};
              sm90mix::mma_bf16(d, a, bh[i][ks][0], bh[i][ks][1]);
            }
            if (g < kF) {  // D[f = g][rows 2tq, 2tq + 1]
              q_s[(m * kRows + 2 * tq) * kF + g] = d[0] + bfc[i];
              q_s[(m * kRows + 2 * tq + 1) * kF + g] = d[1] + bfc[i];
            }
          }
        }
        // G_{t+1} = l1norm_rows(G_t + G_add), the row norm clipped at 1e-12:
        // a warp a row n, a lane an entry m
        for (int n = warp; n < kN; n += kWarps) {
          const float v = lane < kN ? g_s[n * kGRow + lane] + gadd_s[n * kGRow + lane] : 0.0f;
          float s = fabsf(v);
#pragma unroll
          for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane < kN) g_s[n * kGRow + lane] = v / fmaxf(s, 1e-12f);
        }
        sm90mix::consumer_sync();  // q and G_{t+1} are written
        ROLLOUT_STAMP(8);
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
        if (t + 1 < ph) load_g();
        ROLLOUT_STAMP(9);
        // the next writes of q and G_t come after the next step's barriers
      }
    }
  }
  sm90mix::cluster_sync();  // no block leaves while its peers may still reach its memory
}

#else
// ---- the design past 21 nodes (nodemix::kWide; AMASS-MANO's 51) ------------
// At 51 nodes the 21-node layout does not fit: at 8 rows a block the fp32 h
// alone is 156 672 bytes and a ring stage 78 336.  This design is the plain
// version's step, a phase at a time, on the CUDA cores (bf16 operands
// widened to fp32, whose products are exact, fp32 sums): a block owns 4
// batch rows, and its state lives in shared memory: h in fp32 [N][4][H]
// 78 336 B, the step's hw3 [N][4][3H] bf16 117 504 B, G_t and bf16(G_t)
// [N][kGRow] fp32 10 608 B each, the head's outputs 2 448 B; 219 504 B in
// all.  W_hh [N][H][3H] (as it is, not packed), cx, W_fc and G_fc are read
// from device memory (L2) as the phases need them, so each weight byte
// fetched serves the block's 4 rows.  Per step:
// * products: hw3 = bf16(bf16(h)·W_hh + b_hh), a thread per (node, pair of
//   gate columns) for the 4 rows, consecutive threads on consecutive
//   columns of W_hh's rows;
// * mixes and gate update: a thread per (row, hidden column, quarter of the
//   output nodes), all N input nodes: r and z over [gc | gc]·[cx ; hw3] as
//   one sum, n's two parts apart, then h' in place (the products are done);
// * the output head q = bf16(h')·W_fc + b_fc a thread per (node, row,
//   output) while a warp a row takes G_{t+1}; then y = tanh(G_fc·q) and
//   bf16(G_{t+1}).
// Blocks come in clusters of 2 (the launch's) on adjacent row tiles,
// persistent over the tiles; they share nothing.  A simple design that is
// right; its time is in PERF.md §6 (ROADMAP Queue B: the cluster split).
constexpr int kRows = 4;                        // batch rows a block
constexpr int kCluster = 2;                     // blocks a cluster (the launch's; nothing shared)
constexpr int kSlice = 0, kStages = 0;          // no slices and no ring: W_hh read as it is
constexpr int kThreads = sm90mix::kConsumers;   // 256: 8 warps
constexpr int kGRow = (kN + 3) / 4 * 4;         // G rows padded to whole float4s (52 at 51)
constexpr int kPairs = 3 * kH / 2;              // gate-column pairs of a node's hw3
constexpr int kMixSplit = 4;                    // threads a mix position, each a quarter
constexpr int kMixNodes = (kN + kMixSplit - 1) / kMixSplit;  // output nodes a mix thread
static_assert(kN <= 64, "the G update takes two entries a lane");
static_assert(kThreads % 32 == 0 && kH % 2 == 0, "whole warps, column pairs");

struct Layout {
  static constexpr size_t h32 = 0;  // h [N][rows][H] fp32
  static constexpr size_t hw3 = h32 + sizeof(float) * kN * kRows * kH;   // [N][rows][3H] bf16
  static constexpr size_t g = hw3 + sizeof(bf16) * kN * kRows * 3 * kH;  // G_t [N][kGRow]
  static constexpr size_t gc = g + sizeof(float) * kN * kGRow;          // bf16(G_t), fp32
  static constexpr size_t q = gc + sizeof(float) * kN * kGRow;          // [N][rows][F]
  static constexpr size_t total = q + sizeof(float) * kN * kRows * kF;
};
static_assert(Layout::total <= sm90mix::kMaxSmem, "one block an SM");
static_assert(Layout::hw3 % 16 == 0 && Layout::g % 16 == 0 && Layout::q % 16 == 0,
              "16-byte aligned buffers");

__global__ void __launch_bounds__(kThreads, 1)
gru_rollout_merged_kernel(const bf16* __restrict__ cx, const float* __restrict__ h0,
                          const bf16* __restrict__ w_hh, const float* __restrict__ b_hh,
                          const float* __restrict__ g0, const float* __restrict__ g_add,
                          const bf16* __restrict__ w_fc, const float* __restrict__ b_fc,
                          const float* __restrict__ g_fc, float* __restrict__ out, int batch,
                          int ph) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* h32 = reinterpret_cast<float*>(smem + Layout::h32);
  bf16* hw3 = reinterpret_cast<bf16*>(smem + Layout::hw3);
  float* g_s = reinterpret_cast<float*>(smem + Layout::g);
  float* gc_s = reinterpret_cast<float*>(smem + Layout::gc);
  float* q_s = reinterpret_cast<float*>(smem + Layout::q);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (batch + kRows - 1) / kRows;
  const int items = (tiles + kCluster - 1) / kCluster;
  const uint32_t rank = sm90mix::cluster_rank();

  for (int item = sm90mix::cluster_id(); item < items; item += sm90mix::cluster_count()) {
    const int b0 = (item * kCluster + static_cast<int>(rank)) * kRows;
    const int valid = max(0, min(kRows, batch - b0));
    __syncthreads();  // the last item's reads are done
    for (int i = tid; i < kN * kRows * kH; i += kThreads) {
      const int n = i / (kRows * kH), r = i / kH % kRows, j = i % kH;
      h32[i] = r < valid ? h0[(static_cast<size_t>(n) * batch + b0 + r) * kH + j] : 0.0f;
    }
    for (int i = tid; i < kN * kGRow; i += kThreads) {
      const int n = i / kGRow, m = i % kGRow;
      const float v = m < kN ? g0[n * kN + m] : 0.0f;
      g_s[i] = v;
      gc_s[i] = bf16_round(v);
    }
    __syncthreads();

    for (int t = 0; t < ph; ++t) {
      // ---- hw3 = bf16(bf16(h)·W_hh + b_hh): (node, column pair) a thread, all rows
      for (int task = tid; task < kN * kPairs; task += kThreads) {
        const int n = task / kPairs, c = 2 * (task % kPairs);
        const float2 b = *reinterpret_cast<const float2*>(b_hh + n * 3 * kH + c);
        float acc[kRows][2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = b.x;
          acc[r][1] = b.y;
        }
        const __nv_bfloat162* w =
            reinterpret_cast<const __nv_bfloat162*>(w_hh + static_cast<size_t>(n) * kH * 3 * kH + c);
        const float* hn = h32 + n * kRows * kH;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) {
          const float2 wk = __bfloat1622float2(w[k * kPairs]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hk = bf16_round(hn[r * kH + k]);
            acc[r][0] = fmaf(hk, wk.x, acc[r][0]);
            acc[r][1] = fmaf(hk, wk.y, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          *reinterpret_cast<__nv_bfloat162*>(hw3 + (n * kRows + r) * 3 * kH + c) =
              __floats2bfloat162_rn(acc[r][0], acc[r][1]);
      }
      __syncthreads();  // hw3 is written; h is read

      // ---- the mixes and the gate update: (row, hidden column, quarter of
      // the output nodes) a thread, all N input nodes
      for (int task = tid; task < kRows * kH * kMixSplit; task += kThreads) {
        const int j = task % kH, r = task / kH % kRows, part = task / (kH * kRows);
        const int n0 = part * kMixNodes;
        float yr[kMixNodes], yz[kMixNodes], yx[kMixNodes], yh[kMixNodes];
#pragma unroll
        for (int i = 0; i < kMixNodes; ++i) yr[i] = yz[i] = yx[i] = yh[i] = 0.0f;
        const int row = min(b0 + r, batch - 1);
#pragma unroll 1
        for (int m = 0; m < kN; ++m) {
          const bf16* xm = cx + (static_cast<size_t>(m) * batch + row) * 3 * kH + j;
          const bf16* hm = hw3 + (m * kRows + r) * 3 * kH + j;
          const float xr = __bfloat162float(xm[0]), xz = __bfloat162float(xm[kH]);
          const float xn = __bfloat162float(xm[2 * kH]);
          const float hr = __bfloat162float(hm[0]), hz = __bfloat162float(hm[kH]);
          const float hn = __bfloat162float(hm[2 * kH]);
#pragma unroll
          for (int i = 0; i < kMixNodes; ++i) {
            const float gv = gc_s[min(n0 + i, kN - 1) * kGRow + m];
            yr[i] = fmaf(gv, hr, fmaf(gv, xr, yr[i]));
            yz[i] = fmaf(gv, hz, fmaf(gv, xz, yz[i]));
            yx[i] = fmaf(gv, xn, yx[i]);
            yh[i] = fmaf(gv, hn, yh[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kMixNodes; ++i) {
          const int n = n0 + i;
          if (n < kN) {
            float* hp = h32 + (n * kRows + r) * kH + j;
            const float rg = bf16_round(sigmoid(yr[i]));
            const float zg = bf16_round(sigmoid(yz[i]));
            const float ng = tanh_gate(yx[i] + rg * yh[i]);
            *hp = ng - ng * zg + zg * *hp;
          }
        }
      }
      __syncthreads();  // h' is written; bf16(G_t) is read

      // ---- the output head q = b_fc + bf16(h')·W_fc; G_{t+1} = l1norm_rows(G_t + G_add)
      for (int task = tid; task < kN * kRows * kF; task += kThreads) {
        const int n = task / (kRows * kF), r = task / kF % kRows, f = task % kF;
        const float* hn = h32 + (n * kRows + r) * kH;
        const bf16* w = w_fc + static_cast<size_t>(n) * kH * kF + f;
        float acc = b_fc[n * kF + f];
#pragma unroll 8
        for (int k = 0; k < kH; ++k) acc = fmaf(bf16_round(hn[k]), __bfloat162float(w[k * kF]), acc);
        q_s[task] = acc;
      }
      for (int n = warp; n < kN; n += kThreads / 32) {
        float v[2], s = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = lane + 32 * e;
          v[e] = m < kN ? g_s[n * kGRow + m] + g_add[n * kN + m] : 0.0f;
          s += fabsf(v[e]);
        }
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = lane + 32 * e;
          if (m < kN) g_s[n * kGRow + m] = v[e] / fmaxf(s, 1e-12f);
        }
      }
      __syncthreads();  // q and G_{t+1} are written

      // ---- y_t = tanh(G_fc·q); bf16(G_{t+1}) for the next step's mixes
      for (int task = tid; task < kN * kRows * kF; task += kThreads) {
        const int n = task / (kRows * kF), r = task / kF % kRows, f = task % kF;
        float acc = 0.0f;
#pragma unroll 4
        for (int m = 0; m < kN; ++m) acc = fmaf(__ldg(g_fc + n * kN + m), q_s[(m * kRows + r) * kF + f], acc);
        if (r < valid)
          out[((static_cast<size_t>(t) * kN + n) * batch + b0 + r) * kF + f] = tanhf(acc);
      }
      for (int i = tid; i < kN * kGRow; i += kThreads) gc_s[i] = bf16_round(g_s[i]);
      __syncthreads();  // the next step's products read h' and its mixes bf16(G_{t+1})
    }
  }
}
#endif

}  // namespace

// cx [N, batch, 3H], w_fc [N, H, F] bfloat16; h0 [N, batch, H], b_hh [N, 3H],
// g0, g_add, g_fc [N, N], b_fc [N, F], out [ph, N, batch, F] float32; all
// contiguous, cx 16-byte aligned; w_hh is W_hh [N, H, 3H] (bfloat16) packed
// by gru_rollout.py::pack_rollout_bank_bf16, and tile_rows, slice, stages,
// cluster and smem_bytes the plan of gru_rollout.py::rollout_bf16_plan.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes and plans the library does not instantiate.
extern "C" int gru_rollout_bf16(const void* cx, const float* h0, const void* w_hh,
                                const float* b_hh, const float* g0, const float* g_add,
                                const void* w_fc, const float* b_fc, const float* g_fc,
                                float* out, int n_nodes, int batch, int hidden, int f_out, int ph,
                                int tile_rows, int slice, int stages, int cluster, int smem_bytes,
                                void* stream) {
  if (n_nodes != kN || hidden != kH || f_out != kF || batch <= 0 || ph <= 0 ||
      tile_rows != kRows || slice != kSlice || stages != kStages || cluster != kCluster ||
      static_cast<size_t>(smem_bytes) != Layout::total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = ((batch + kRows - 1) / kRows + kCluster - 1) / kCluster;
  return static_cast<int>(sm90mix::launch<kThreads>(
      gru_rollout_merged_kernel, items, smem_bytes, kCluster, stream,
      static_cast<const bf16*>(cx), h0, static_cast<const bf16*>(w_hh), b_hh, g0, g_add,
      static_cast<const bf16*>(w_fc), b_fc, g_fc, out, batch, ph));
}
