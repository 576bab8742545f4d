// K1's inverse on Hopper's warpgroup tensor-core products (`wgmma`) at the
// padded hidden widths Hp <= 544 (TN <= 17; the flagship's 526 pads to 544),
// built twice: in 3xTF32 (the default mode) and, with BCNF_TF32_PASSES=1, in
// one TF32 pass (the reduced mode: the JAX kernel's "default" mode, which
// serves the "default", "bfloat16" and "BF16_BF16_F32_X3" precisions). Each
// build has a kernel of its own, designed for its arithmetic. Wider models
// take the row-tile inverse of flow_kernel.cu.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow with inverse=True (the
// Pallas TPU kernel `_flow_kernel`), and the inverse of
// bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4), which the port
// runs as this kernel at one step. Host side and plain PyTorch versions:
// bcnf_tpu_torch/ops/flow_kernel.py (`fused_flow`, `prepare_weights`,
// `wgmma_grid`, `fused_flow_reference`).
//
// What it computes, for every row r (conditioned on h_proj[k, r % N]): step
// S-1 (the final coupling alone), then for k = S-2 .. 0: x <- x Q_k^T,
// coupling^-1, ActNorm^-1; the coupling on x = [x_a | x_b] being
// a = gelu(x_a W1y + b1 + h_proj), a = gelu(a Wm_l + bm_l) for each hidden
// layer, [t | s'] = a Wout + bout, s = tanh(s'), x_b <- (x_b - t) exp(-s).
//
// What bounds it on an H100: the square hidden products, 4 x 2 x 526^2 FLOP
// a row and step, ~99% of the work, on the tensor cores (3xTF32: three
// products a product, a third of the 494.7 TFLOP/s dense TF32 rate; one
// pass: one product, the full rate), and the weights' traffic from L2: every
// 64-row tile reads each step's hidden weights once (hi and lo in 3xTF32,
// 2.37 MB a layer at Hp 544, ~308 GB a call for 80,000 rows; hi alone in one
// pass, half of that), which at L2's rate of a few TB/s takes about as long
// as the 3xTF32 products and longer than the one-pass products.
//
// Both builds.
// - Tile: 64 rows (one `wgmma` M) for all S steps; their activations stay in
//   shared memory as float32 (64 x (Hp + 4)), the rows' state, the mix's
//   output and [t | s'] beside them.
// - Warps: two consumer warpgroups and a producer warpgroup that streams the
//   hidden weights (one of its threads issues the copies). The block's 384
//   threads start with 168 registers each, the count ptxas reports;
//   `setmaxnreg` takes the producers down to 40 and gives the consumers 232
//   from what they release, and ptxas allocates the consumers' code within
//   those 232 (PERF.md: their SASS names registers up to R217 at TN 16-17).
// - A operand: from registers. Each consumer loads its m64 x k8 fragment of
//   the float32 tile and rounds it in registers to hi = tf32(a) (3xTF32 also
//   keeps lo = a - hi, truncated by the tensor cores): four values a thread
//   and k-step.
// - B operand: the hidden weights prepared once per call on the card
//   (`prepare_weights`): transposed to K-major, split into hi and lo (the same
//   bits as the split of mma_tf32.cuh; one pass keeps hi alone), and laid out
//   stage by stage, 8 input rows a stage, in the core-matrix order the
//   descriptor reads, so one 1-D bulk copy (`cp.async.bulk`, no tensor map)
//   moves what a block reads of a stage: 8 Hp floats in either build (one
//   pass: hi of all Hp columns; 3xTF32: hi and lo of a block's Hp / 2).
// - The narrow products (W1y: d_a inputs; Wout: 2 d_b outputs; ~2% of the
//   work) and the mixes stay float32 FMA and read their weights from global
//   memory through L1 and L2, as does the ActNorm.
//
// 3xTF32 (flow_inverse_fold): a_lo b_hi + a_hi b_lo + a_hi b_hi a product.
// The tensor cores truncate as they accumulate; over a 544-long dot product
// (68 k-stages of three passes) that bias took the rank batch of phase 12 in
// chip_smoke.py to 91-95% of its 1e-4 bar from float64 (PERF.md), so each
// k-stage's three passes go into a fresh accumulator and are folded into the
// running sums by float32 adds. The fresh accumulator and the running sums
// together take the 136 registers the sums took alone before, because:
// - two blocks form a cluster on the same 64 rows, block `rank` computing
//   columns [rank Hp/2, (rank + 1) Hp/2) of each hidden layer; a consumer
//   warpgroup one m64 x n(8 TN) product (n136 at Hp 544): 68 running sums and
//   a 68-float fresh accumulator a thread (scale-d 0 on a k-stage's first
//   pass, so nothing is zeroed). Each k-stage is waited for (`wgmma_wait<0>`),
//   its slot released (one arrival a warp) and folded: a second fresh
//   accumulator, to keep a group in flight, would not fit in 232 registers,
//   and splitting the fresh one by columns into two halves that take turns
//   (one group in flight) makes ptxas serialize the groups (PERF.md);
// - each block streams only its half of every k-stage (hi then lo, 17,408
//   bytes at Hp 544), so the 70 KB that held 2 k-stages hold 4: 2 stages of
//   2 k-stages, one bulk copy each (34,816 bytes), the producer a stage
//   ahead, across layers and steps (2-k-stage stages measured 3.5% faster
//   than 4 one-k-stage ones: PERF.md);
// - after each hidden layer a block writes its half of h_{l+1}, through the
//   GELU, into its own tile and into its peer's (distributed shared memory);
//   two point-to-point barriers take the place of a cluster barrier: "peer
//   free" (the peer's 256 consumers are done reading what this block writes
//   next) and "landed" (the peer's half is written), arrived on remotely with
//   release and waited on with acquire at cluster scope. The ring's barriers
//   keep CTA scope (cluster-scope ones cost ~28 ms on the one-pass ring);
// - the input layer is split by columns too (input_layer_by_columns' order,
//   each block its half of h_0), and the output layer's 2 d_b columns: rank 0
//   computes t, rank 1 s' (a thread one column of 4 rows, the sum in the
//   order of the inputs), exchanged the same way;
// - the mix, the coupling update and ActNorm^-1 (size-19 work a row) run in
//   both blocks on the same data, so their states stay equal to the bit; rank
//   0 stores y. Rows past B run on zeros and are not stored.
// 140 KB of tile, 68 KB of ring and the rows' state (~14 KB at the flagship's
// size 19) come to ~224 KB of the 227 KB.
// What bounds it (PERF.md, tools/k1_3xtf32_fold.py): a block does half a
// k-stage's products for the same fixed costs a k-stage (the fragment's load,
// the ring's hand-off, the groups' waits), on twice as many blocks; with the
// exchanges that costs ~26 ms at the flagship's 80,000 sampling rows over the
// one-block design this replaces (~73 ms), and the fold ~15 ms more.
//
// One pass (flow_inverse_wgmma, redesigned for its own arithmetic): one
// `wgmma` a product on operands rounded once to TF32. Its two products a
// k-step are too short to hide a k-step's fixed costs (the fragment's load,
// the barrier's hand-off, the group's wait), and its stream, no longer hidden
// behind three times the products, bounds it. So:
// - one `wgmma` group is kept in flight: a k-step issues its products, then
//   waits for the previous k-step's group (`wgmma_wait<1>`), releases that
//   stage, and loads and rounds the next fragment into the other of two A
//   registers sets while its own group runs;
// - the ring holds 4 hi-only stages (kWgRingTf32), so two stages are in use
//   while two are in flight; a warpgroup owns half the columns, as two
//   m64n(8 TN)k8 products;
// - two blocks, each on its own 64 rows, form a cluster (kWgClusterTf32) and
//   share every stage: the blocks issue the ring's slots in turn (slot st by
//   rank st % 2), each stage one bulk copy multicast to both blocks' rings,
//   which halves the weights' reads from L2; a slot's `empty` barrier in its
//   issuing block counts one arrival from each consumer warpgroup of both
//   blocks (remote arrivals through `mapa`), and its issuing producer
//   announces the bytes on both blocks' `full` barriers. The grid is rounded
//   up to whole clusters (a block past the last row runs on masked rows), the
//   blocks meet at a cluster barrier after initialising their barriers and
//   before leaving, and a launch the card refuses returns its error. The
//   barriers keep their default (CTA-scope) semantics, as CUTLASS's cluster
//   pipelines do: cluster-scope ones measured ~28 ms slower (PERF.md);
// - the input layer, which the tensor cores wait for, puts each thread on
//   fixed columns (W1y's column pair loaded once, all its inputs at once,
//   for 4 rows) and keeps each sum in input_layer's order.
// What bounds it now (PERF.md, tools/wgmma_tf32_parts.py): the stream and
// the FMA layers, neither overlapped with the other. A k-step's two
// products take ~270 cycles of the SM's tensor cores and need a 17 KB
// stage, ~64 bytes a cycle an SM; the multicast, which halves L2's reads
// but not what each SM takes in, did not pay (clusters of 1 measured
// faster), so the ring's hand-offs and each SM's intake hold the stream,
// not L2. The FMA layers and the epilogues' GELU run while the tensor
// cores idle: one block an SM has no second tile to overlap them with, and
// shared memory has no room for one.

#include "flow_rows.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kWgRows = 64;                    // one wgmma M
constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
// The weight ring's stages and the blocks of a cluster, by arithmetic
// (ops/flow_kernel.py: `wgmma_ring` reads these four): in 3xTF32 a cluster's
// blocks own the same rows, each half of every hidden layer's columns; in one
// pass each owns its rows and they share each stage
constexpr int kWgRing3xTf32 = 2;
constexpr int kWgCluster3xTf32 = 2;
// 3xTF32: the k-steps (8 input rows each) a ring stage holds, one bulk copy
constexpr int kWgStageK = 2;
static_assert(kWgRing3xTf32 * kWgStageK == 4, "the 3xTF32 ring holds 4 k-steps");
constexpr int kWgRingTf32 = 4;
constexpr int kWgClusterTf32 = 2;
constexpr int kWgStages = kPasses == 3 ? kWgRing3xTf32 : kWgRingTf32;  // the weight ring
constexpr int kWgCluster = kPasses == 3 ? kWgCluster3xTf32 : kWgClusterTf32;  // blocks of a cluster
static_assert(kPasses == 3 || kWgStages % kWgCluster == 0, "each ring slot has one issuing block");
// 3xTF32: the cluster's two hand-off barriers ("peer free", "landed")
constexpr int kWgXchBarriers = 2;
// The parts a launch runs: all, or some left out to time the rest (the
// exchange between a 3xTF32 cluster's blocks; one pass has none)
constexpr int kWgProducts = 1, kWgCopies = 2;
[[maybe_unused]] constexpr int kWgExchange = 4;
// Registers a thread: a block of 12 warps starts with 168 (65,536 / 384); the
// producer warpgroup gives up all but 40 to the block's pool, from which the
// consumers take 232 each: 128 x 40 + 256 x 232 = 384 x 168. ptxas reports
// the 168 and allocates the consumers' code within the 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int TN>
struct WgShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int ldA = Hp + 4;  // the activation tile (conflict-free fragment loads)
  static constexpr int NP = 8 * TN;   // columns of one product (one pass: two a warpgroup; 3xTF32: one)
  static constexpr int R = NP / 2;    // its accumulator floats a thread
  // floats of a ring stage, 8 input rows of W^T: one pass hi of all Hp
  // columns; 3xTF32 hi, then lo, of a block's Hp / 2
  static constexpr int stage = 8 * Hp;
  static constexpr int n_stages = Hp / 8;  // stages a layer (3xTF32: k-steps, kWgStageK a stage)
};

// The kernel's dynamic shared memory (bcnf_tpu_torch/ops/flow_kernel.py:
// kernel_smem mirrors this sum): tile, ring, x, x Q^T, [t | s'], 2 barriers a
// stage and, in 3xTF32, the cluster's hand-off barriers.
size_t wg_smem(int Hp, int size, int d_a) {
  const size_t stage = 8 * static_cast<size_t>(Hp) * (kPasses == 3 ? kWgStageK : 1);
  return sizeof(float) * (static_cast<size_t>(kWgRows) * (Hp + 4) + static_cast<size_t>(kWgStages) * stage +
                          static_cast<size_t>(kWgRows) * (2 * size + 2 * (size - d_a))) +
         (2 * kWgStages + (kPasses == 3 ? kWgXchBarriers : 0)) * sizeof(uint64_t);
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory"); }

// The next slot of the weight ring, and its phase's parity.
__device__ __forceinline__ void next_slot(int& st, uint32_t& ph) {
  if (++st == kWgStages) {
    st = 0;
    ph ^= 1;
  }
}

// The one-pass pipeline's pieces (kPasses == 1).
// A warp's m64 x k8 fragment of the tile at k-step s (rows 16 w4 + g (+8),
// columns 8 s + q (+4)), rounded to TF32: the hi half of split_tf32.
template <int ldA>
__device__ __forceinline__ void load_a_tf32(const float* act, int w4, int g, int q, int s, uint32_t (&a)[4]) {
  const float* a0 = act + (16 * w4 + g) * ldA + 8 * s + q;
  a[0] = tf32_rna(a0[0]);
  a[1] = tf32_rna(a0[8 * ldA]);
  a[2] = tf32_rna(a0[4]);
  a[3] = tf32_rna(a0[8 * ldA + 4]);
}

// A consumer warpgroup is done with ring slot `slot`: one arrival (its first
// thread's) on the slot's `empty` barrier in the block that issues the slot.
[[maybe_unused]] __device__ __forceinline__ void release_slot(uint64_t* empty, int slot, bool signals) {
  if (signals) mbar_arrive_cluster(&empty[slot], static_cast<uint32_t>(slot % kWgCluster));
}

// One k-step of a hidden layer with one `wgmma` group kept in flight: wait
// for the stage, issue its two products on `cur`, wait for the previous
// k-step's group (which frees its stage and `nxt`), release that stage, and
// load and round the next k-step's fragment into `nxt` while this group runs.
template <int TN>
__device__ __forceinline__ void one_pass_kstep(float (&acc)[2][WgShape<TN>::R], const uint32_t (&cur)[4],
                                               uint32_t (&nxt)[4], int s, const float* act, const float* ring,
                                               uint64_t* full, uint64_t* empty, int& st, uint32_t& ph, int wg,
                                               int w4, int g, int q, bool signals) {
  using W = WgShape<TN>;
  mbar_wait(&full[st], ph);
  const float* hi0 = ring + st * W::stage + (wg * 2 * TN) * 64;
  const uint64_t b0 = smem_desc(hi0, 128, 256), b1 = smem_desc(hi0 + TN * 64, 128, 256);
  wgmma_fence();
  WgmmaTf32<W::NP>::mma(acc[0], cur, b0);
  WgmmaTf32<W::NP>::mma(acc[1], cur, b1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
  if (s > 0) release_slot(empty, (st + kWgStages - 1) % kWgStages, signals);
  if (s + 1 < W::n_stages) load_a_tf32<W::ldA>(act, w4, g, q, s + 1, nxt);
  next_slot(st, ph);
}

// The input layer's W1y values a thread loads at once, up to this many inputs.
constexpr int kHoistDa = 16;

// One pass: the input layer h_0 = gelu(x_a W1y + b1 + h_proj) with each
// thread on fixed columns (16 row groups x 16 column lanes): a column pair's
// W1y values are loaded once for the thread's 4 rows (rg + 16 r), all
// issued together up to kHoistDa inputs, and its projections' loads too;
// each sum in input_layer's order.
template <int TN>
__device__ __forceinline__ void input_layer_by_columns(float* act, const float* xs, const float* w1, const float* b1k,
                                                       const float* h_proj_k, int row0, int B, int N, int size,
                                                       int d_a, int tid) {
  using W = WgShape<TN>;
  const int rg = tid >> 4, cl = tid & 15;
  const float* hp[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + rg + 16 * r;
    hp[r] = row < B ? h_proj_k + static_cast<size_t>(row % N) * W::Hp : nullptr;
  }
#pragma unroll 1
  for (int j = 0; j < TN; ++j) {
    const int col = 2 * (cl + 16 * j);
    const float2 bias = *reinterpret_cast<const float2*>(b1k + col);
    float2 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 h = hp[r] != nullptr ? *reinterpret_cast<const float2*>(hp[r] + col) : make_float2(0.0f, 0.0f);
      a[r] = make_float2(bias.x + h.x, bias.y + h.y);
    }
    if (d_a <= kHoistDa) {
      float2 w[kHoistDa];
#pragma unroll
      for (int i = 0; i < kHoistDa; ++i)
        if (i < d_a) w[i] = *reinterpret_cast<const float2*>(w1 + i * W::Hp + col);
#pragma unroll
      for (int i = 0; i < kHoistDa; ++i) {
        if (i < d_a) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xi = xs[(rg + 16 * r) * size + i];
            a[r].x = fmaf(xi, w[i].x, a[r].x);
            a[r].y = fmaf(xi, w[i].y, a[r].y);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < d_a; ++i) {
        const float2 w = *reinterpret_cast<const float2*>(w1 + i * W::Hp + col);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xi = xs[(rg + 16 * r) * size + i];
          a[r].x = fmaf(xi, w.x, a[r].x);
          a[r].y = fmaf(xi, w.y, a[r].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float2*>(act + (rg + 16 * r) * W::ldA + col) =
          make_float2(gelu_tanh(a[r].x), gelu_tanh(a[r].y));
  }
}

// 3xTF32: the input layer's half of a cluster's block, columns c0 .. c0 +
// Hp/2, as input_layer_by_columns computes them (each sum in input_layer's
// order) with 32 row groups x 8 column lanes (2 rows a thread), each value
// also written into the cluster peer's tile where `peer`. A function of its
// own: one shared with the one-pass build changed that build's SASS.
template <int TN>
__device__ __forceinline__ void input_layer_half(float* act, uint32_t act_peer, const float* xs, const float* w1,
                                                 const float* b1k, const float* h_proj_k, int row0, int B, int N,
                                                 int size, int d_a, int c0, int tid, bool peer) {
  using W = WgShape<TN>;
  const int rg = tid >> 3, cl = tid & 7;
  const float* hp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rg + 32 * r;
    hp[r] = row < B ? h_proj_k + static_cast<size_t>(row % N) * W::Hp : nullptr;
  }
#pragma unroll 1
  for (int j = 0; j < TN; ++j) {
    const int col = c0 + 2 * (cl + 8 * j);
    const float2 bias = *reinterpret_cast<const float2*>(b1k + col);
    float2 a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 h = hp[r] != nullptr ? *reinterpret_cast<const float2*>(hp[r] + col) : make_float2(0.0f, 0.0f);
      a[r] = make_float2(bias.x + h.x, bias.y + h.y);
    }
    if (d_a <= kHoistDa) {
      float2 w[kHoistDa];
#pragma unroll
      for (int i = 0; i < kHoistDa; ++i)
        if (i < d_a) w[i] = *reinterpret_cast<const float2*>(w1 + i * W::Hp + col);
#pragma unroll
      for (int i = 0; i < kHoistDa; ++i) {
        if (i < d_a) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float xi = xs[(rg + 32 * r) * size + i];
            a[r].x = fmaf(xi, w[i].x, a[r].x);
            a[r].y = fmaf(xi, w[i].y, a[r].y);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < d_a; ++i) {
        const float2 w = *reinterpret_cast<const float2*>(w1 + i * W::Hp + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float xi = xs[(rg + 32 * r) * size + i];
          a[r].x = fmaf(xi, w.x, a[r].x);
          a[r].y = fmaf(xi, w.y, a[r].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (rg + 32 * r) * W::ldA + col;
      const float h0 = gelu_tanh(a[r].x), h1 = gelu_tanh(a[r].y);
      *reinterpret_cast<float2*>(act + at) = make_float2(h0, h1);
      if (peer) st_peer2(act_peer + 4u * static_cast<uint32_t>(at), h0, h1);
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(kWgThreads, 1)
flow_inverse_wgmma(const float* __restrict__ x, const float* __restrict__ h_proj,
                   const float* __restrict__ an_s, const float* __restrict__ an_b,
                   const float* __restrict__ ortho, const float* __restrict__ w1y,
                   const float* __restrict__ b1, const float* __restrict__ wstages,
                   const float* __restrict__ bm, const float* __restrict__ wout,
                   const float* __restrict__ bout, float* __restrict__ y, int B, int N, int S, int size,
                   int d_a, int nh, int parts) {
  using W = WgShape<TN>;
  constexpr int Hp = W::Hp, ldA = W::ldA;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // 64 x Hp (ld ldA)
  float* ring = act + kWgRows * ldA;             // kWgStages weight stages
  float* xs = ring + kWgStages * W::stage;       // 64 x size: the rows' state
  float* xt = xs + kWgRows * size;               // 64 x size: the mix's output
  float* outs = xt + kWgRows * size;             // 64 x n_out: [t | s']
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kWgRows * n_out);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kWgRows;
  for (int p = tid; p < kWgRows * size; p += kWgThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      // an arrival from each consumer warpgroup of each block of the cluster
      mbar_init(&empty[i], 2 * kWgCluster);
    }
    mbar_init_fence();
  }
  if constexpr (kWgCluster > 1) {
    cluster_sync();  // every block's barriers are initialised before any block reaches them
  } else {
    __syncthreads();
  }

  if (tid >= kWgConsumers) {
    // ---- the producer warpgroup: one thread issues every hidden weight's
    // stages, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the cluster's blocks issue the ring's slots in turn (slot st
    // by rank st % kWgCluster), each stage one copy multicast to every block
    // once every block's consumers have released the slot
    if (tid == kWgConsumers) {
      const uint32_t rank = cluster_rank();
      constexpr uint32_t bytes = W::stage * sizeof(float);
      int st = 0;
      uint32_t ph = 0;
      for (int it = 0; it < S; ++it) {
        const int k = S - 1 - it;
        for (int l = 0; l < nh; ++l) {
          const float* src = wstages + (static_cast<size_t>(k) * nh + l) * W::n_stages * W::stage;
          for (int s = 0; s < W::n_stages; ++s) {
            if (static_cast<uint32_t>(st % kWgCluster) == rank) {
              mbar_wait(&empty[st], ph ^ 1);
              for (int c = 0; c < kWgCluster; ++c) {
                if (parts & kWgCopies) {
                  mbar_arrive_expect_tx_cluster(&full[st], c, bytes);
                } else {
                  mbar_arrive_cluster(&full[st], c);  // timing the products alone: the stage as it is
                }
              }
              if (parts & kWgCopies) {
                if constexpr (kWgCluster > 1) {
                  bulk_copy_g2s_multicast(ring + st * W::stage, src + static_cast<size_t>(s) * W::stage, bytes,
                                          &full[st], static_cast<uint16_t>((1u << kWgCluster) - 1));
                } else {
                  bulk_copy_g2s(ring + st * W::stage, src + static_cast<size_t>(s) * W::stage, bytes, &full[st]);
                }
              }
            }
            next_slot(st, ph);
          }
        }
      }
    }
    if constexpr (kWgCluster > 1) cluster_sync();  // no block leaves while another may reach its memory
    return;
  }

  // ---- the consumers: 256 threads, two warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  int st = 0;
  uint32_t ph = 0;

  for (int it = 0; it < S; ++it) {
    const int k = S - 1 - it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;

    if (inner) {  // ---- x <- x Q_k^T (FMA)
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) {
        const int r = p / size, j = p % size;
        float acc = 0.0f;
        for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
        xt[p] = acc;
      }
      float* t = xs;
      xs = xt;
      xt = t;
      consumer_sync();
    }

    // ---- h_0 = gelu(x_a W1y + b1 + h_proj[k, row % N]) (FMA) into the tile
    {
      const float* w1 = w1y + static_cast<size_t>(k) * d_a * Hp;
      const float* b1k = b1 + static_cast<size_t>(k) * Hp;
      input_layer_by_columns<TN>(act, xs, w1, b1k, h_proj + static_cast<size_t>(k) * N * Hp, row0, B, N, size, d_a,
                                 tid);
    }
    consumer_sync();

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma, one pass
    for (int l = 0; l < nh; ++l) {
      float acc[2][W::R];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < W::R; ++e) acc[p][e] = 0.0f;
      const bool signals = (tid & 127) == 0;
      if (!(parts & kWgProducts)) {  // timing the weights' stream alone
        for (int s = 0; s < W::n_stages; ++s) {
          mbar_wait(&full[st], ph);
          release_slot(empty, st, signals);
          next_slot(st, ph);
        }
      } else {
        uint32_t a0[4], a1[4];  // the fragments of two k-steps: one read by the group in flight
        load_a_tf32<ldA>(act, w4, g, q, 0, a0);
#pragma unroll 1
        for (int s = 0; s < W::n_stages; s += 2) {  // W::n_stages = 4 TN is even
          one_pass_kstep<TN>(acc, a0, a1, s, act, ring, full, empty, st, ph, wg, w4, g, q, signals);
          one_pass_kstep<TN>(acc, a1, a0, s + 1, act, ring, full, empty, st, ph, wg, w4, g, q, signals);
        }
        wgmma_wait<0>();
        fence_operands(acc[0]);
        fence_operands(acc[1]);
        release_slot(empty, (st + kWgStages - 1) % kWgStages, signals);
      }
      consumer_sync();  // every warp is done reading the tile
      const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * w4 + g + 8 * h, col = wg * 16 * TN + p * 8 * TN + 8 * j + 2 * q;
            *reinterpret_cast<float2*>(act + row * ldA + col) =
                make_float2(gelu_tanh(acc[p][4 * j + 2 * h] + bias[col]),
                            gelu_tanh(acc[p][4 * j + 2 * h + 1] + bias[col + 1]));
          }
      consumer_sync();
    }

    // ---- output layer: [t | s'] = h_nh Wout + bout (FMA; Wout from L1/L2),
    // a thread one column and 8 rows, the sum in the order of the inputs
    {
      const float* wo = wout + static_cast<size_t>(k) * Hp * n_out;
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      for (int item = tid; item < (kWgRows / 8) * n_out; item += kWgConsumers) {
        const int c = item % n_out, r0 = (item / n_out) * 8;
        float acc[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
        for (int kk = 0; kk < Hp; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(act + (r0 + r) * ldA + kk);
            acc[r] = fmaf(v.x, w0, acc[r]);
            acc[r] = fmaf(v.y, w1, acc[r]);
            acc[r] = fmaf(v.z, w2, acc[r]);
            acc[r] = fmaf(v.w, w3, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) outs[(r0 + r) * n_out + c] = acc[r] + bo[c];
      }
    }
    consumer_sync();

    // ---- x_b <- (x_b - t) exp(-s) (one thread a row)
    if (tid < kWgRows) {
      float* xr = xs + tid * size;
      const float* o = outs + tid * n_out;
      for (int j = 0; j < d_b; ++j) xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-tanhf(o[d_b + j]));
    }
    consumer_sync();

    if (inner) {  // ---- ActNorm^-1
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      consumer_sync();
    }
  }

  for (int p = tid; p < kWgRows * size; p += kWgConsumers) {
    if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
  }
  if constexpr (kWgCluster > 1) cluster_sync();  // the producers' counterpart
}

// The 3xTF32 pipeline's pieces (kPasses == 3).
// A warp's m64 x k8 fragment of the tile at k-step s (rows 16 w4 + g (+8),
// columns 8 s + q (+4)), split into hi = tf32(a) and lo = a - hi.
template <int ldA>
__device__ __forceinline__ void load_a_split(const float* act, int w4, int g, int q, int s, uint32_t (&ahi)[4],
                                             uint32_t (&alo)[4]) {
  const float* a0 = act + (16 * w4 + g) * ldA + 8 * s + q;
  const float v[4] = {a0[0], a0[8 * ldA], a0[4], a0[8 * ldA + 4]};
  split_tf32(v, ahi, alo);
}

// One k-step's three passes on G n-groups of B (`hi`; lo 4 Hp floats on),
// the two small terms first, into the fresh accumulator `p` (scale-d 0 on
// the first pass: nothing to zero), committed as a `wgmma` group of its own.
template <int G>
__device__ __forceinline__ void three_passes(float (&p)[4 * G], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                             const float* hi, int Hp) {
  const uint64_t bh = smem_desc(hi, 128, 256), bl = smem_desc(hi + 4 * Hp, 128, 256);
  wgmma_fence();
  WgmmaTf32<8 * G>::mma(p, alo, bh, 0);
  WgmmaTf32<8 * G>::mma(p, ahi, bl);
  WgmmaTf32<8 * G>::mma(p, ahi, bh);
  wgmma_commit();
}

// A completed fresh sum folded into the running sums by float32 adds.
template <int R>
__device__ __forceinline__ void fold(float (&acc)[R], float (&p)[R]) {
  fence_operands(p);
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] += p[e];
}

// acc = the warpgroup's m64 x n(8 TN) share of (tile x the layer's hidden
// weight) in 3xTF32: each k-step's three passes into a fresh accumulator,
// waited for, its stage released once its last k-step is done, then folded
// into the running sums (a second fresh accumulator, to keep a group in
// flight, does not fit: PERF.md).
template <int TN>
__device__ __forceinline__ void fold_product(float (&acc)[4 * TN], const float* act, const float* ring, uint64_t* full,
                                             uint64_t* empty, int& st, uint32_t& ph, int wg, int w4, int g, int q,
                                             int lane) {
  using W = WgShape<TN>;
  float part[4 * TN];
#pragma unroll
  for (int e = 0; e < 4 * TN; ++e) acc[e] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < W::n_stages; s += kWgStageK) {
#pragma unroll
    for (int u = 0; u < kWgStageK; ++u) {
      uint32_t ahi[4], alo[4];
      load_a_split<W::ldA>(act, w4, g, q, s + u, ahi, alo);
      if (u == 0) mbar_wait(&full[st], ph);
      // the warpgroup's n-groups wg TN .. of the block's half of the stage's k-step u
      three_passes<TN>(part, ahi, alo, ring + (st * kWgStageK + u) * W::stage + wg * TN * 64, W::Hp);
      wgmma_wait<0>();
      if (u == kWgStageK - 1 && lane == 0) mbar_arrive(&empty[st]);
      fold(acc, part);
    }
    next_slot(st, ph);
  }
}

// 3xTF32: a cluster of two blocks on the same 64 rows, block `rank` on
// columns [rank Hp/2, (rank + 1) Hp/2) of every hidden layer; each k-stage's
// three passes into a fresh accumulator, folded into the running sums.
template <int TN>
__global__ void __launch_bounds__(kWgThreads, 1)
flow_inverse_fold(const float* __restrict__ x, const float* __restrict__ h_proj,
                  const float* __restrict__ an_s, const float* __restrict__ an_b,
                  const float* __restrict__ ortho, const float* __restrict__ w1y,
                  const float* __restrict__ b1, const float* __restrict__ wstages,
                  const float* __restrict__ bm, const float* __restrict__ wout,
                  const float* __restrict__ bout, float* __restrict__ y, int B, int N, int S, int size,
                  int d_a, int nh, int parts) {
  using W = WgShape<TN>;
  constexpr int Hp = W::Hp, ldA = W::ldA, NB = Hp / 2;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // 64 x Hp (ld ldA): all columns, in both blocks
  float* ring = act + kWgRows * ldA;             // kWgStages stages of kWgStageK k-steps' halves
  float* xs = ring + kWgStages * kWgStageK * W::stage;  // 64 x size: the rows' state
  float* xt = xs + kWgRows * size;               // 64 x size: the mix's output
  float* outs = xt + kWgRows * size;             // 64 x n_out: [t | s']
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kWgRows * n_out);
  uint64_t* empty = full + kWgStages;
  uint64_t* peer_free = empty + kWgStages;  // the peer's consumers are done reading what this block writes next
  uint64_t* landed = peer_free + 1;         // the peer's half of the tile (or of [t | s']) is in this block's

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const int row0 = static_cast<int>(blockIdx.x / kWgCluster) * kWgRows;
  for (int p = tid; p < kWgRows * size; p += kWgThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgConsumers / 32);  // an arrival from each consumer warp
    }
    mbar_init(peer_free, kWgConsumers);  // an arrival from each consumer thread of the peer
    mbar_init(landed, kWgConsumers);
    mbar_init_fence();
  }
  cluster_sync();  // both blocks' barriers are initialised before either reaches the other's

  if (tid >= kWgConsumers) {
    // ---- the producer warpgroup: one thread issues the block's half of every
    // hidden weight's stages, in the consumers' order, up to kWgStages ahead
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kWgConsumers) {
      constexpr int slot = kWgStageK * W::stage;  // floats of a stage: kWgStageK k-steps of the block's half
      constexpr uint32_t bytes = slot * sizeof(float);
      int st = 0;
      uint32_t ph = 0;
      for (int it = 0; it < S; ++it) {
        const int k = S - 1 - it;
        for (int l = 0; l < nh; ++l) {
          // stage j of the layer, rank r's part at (j kWgCluster + r) stages
          const float* src = wstages + (static_cast<size_t>(k) * nh + l) * W::n_stages * kWgCluster * W::stage +
                             static_cast<size_t>(rank) * slot;
          for (int j = 0; j < W::n_stages / kWgStageK; ++j) {
            mbar_wait(&empty[st], ph ^ 1);
            if (parts & kWgCopies) {
              mbar_arrive_expect_tx(&full[st], bytes);
              bulk_copy_g2s(ring + st * slot, src + static_cast<size_t>(j) * kWgCluster * slot, bytes, &full[st]);
            } else {
              mbar_arrive(&full[st]);  // timing the products alone: the stage as it is
            }
            next_slot(st, ph);
          }
        }
      }
    }
    cluster_sync();  // no block leaves while its peer may still reach its memory
    return;
  }

  // ---- the consumers: 256 threads, two warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = static_cast<int>(rank) * NB;  // the block's columns
  const bool exchange = parts & kWgExchange;   // without it (timing the rest) each block keeps its own half
  const uint32_t act_peer = map_peer(act, peer), outs_peer = map_peer(outs, peer);
  int st = 0;
  uint32_t ph = 0, xph = 0;  // the ring's slot and parity; the hand-off barriers' parity

  // This thread is done reading what the peer writes next (this block's tile,
  // or its [t | s']).
  auto done_reading = [&]() {
    if (exchange) mbar_arrive_release_cluster(peer_free, peer);
  };
  // Once both blocks are done reading it, `write` puts this thread's part of
  // the block's half into both blocks; then both halves are whole in both.
  auto hand_off = [&](auto&& write) {
    consumer_sync();
    if (exchange) mbar_wait_acquire_cluster(peer_free, xph);
    write();
    if (exchange) mbar_arrive_release_cluster(landed, peer);
    consumer_sync();
    if (exchange) mbar_wait_acquire_cluster(landed, xph);
    xph ^= 1;
  };

  done_reading();  // nothing read yet
  for (int it = 0; it < S; ++it) {
    const int k = S - 1 - it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;

    if (inner) {  // ---- x <- x Q_k^T (FMA)
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) {
        const int r = p / size, j = p % size;
        float acc = 0.0f;
        for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
        xt[p] = acc;
      }
      float* t = xs;
      xs = xt;
      xt = t;
      consumer_sync();
    }

    // ---- h_0 = gelu(x_a W1y + b1 + h_proj[k, row % N]) (FMA), the block's half, into both tiles
    hand_off([&] {
      input_layer_half<TN>(act, act_peer, xs, w1y + static_cast<size_t>(k) * d_a * Hp, b1 + static_cast<size_t>(k) * Hp,
                           h_proj + static_cast<size_t>(k) * N * Hp, row0, B, N, size, d_a, c0, tid, exchange);
    });

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma in 3xTF32,
    // each k-step's passes into fresh accumulators folded into the running sums
    for (int l = 0; l < nh; ++l) {
      float acc[W::R];
      if (!(parts & kWgProducts)) {  // timing the weights' stream alone
#pragma unroll
        for (int e = 0; e < W::R; ++e) acc[e] = 0.0f;
        for (int s = 0; s < W::n_stages; s += kWgStageK) {
          mbar_wait(&full[st], ph);
          if (lane == 0) mbar_arrive(&empty[st]);
          next_slot(st, ph);
        }
      } else {
        fold_product<TN>(acc, act, ring, full, empty, st, ph, wg, w4, g, q, lane);
      }
      done_reading();
      const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp;
      hand_off([&] {
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * w4 + g + 8 * h, col = c0 + wg * 8 * TN + 8 * j + 2 * q;
            const float h0 = gelu_tanh(acc[4 * j + 2 * h] + bias[col]);
            const float h1 = gelu_tanh(acc[4 * j + 2 * h + 1] + bias[col + 1]);
            *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(h0, h1);
            if (exchange) st_peer2(act_peer + 4u * static_cast<uint32_t>(row * ldA + col), h0, h1);
          }
      });
    }

    // ---- output layer: [t | s'] = h_nh Wout + bout (FMA; Wout from L1/L2):
    // rank 0 t, rank 1 s', a thread one column of 4 rows, the sum in the
    // order of the inputs, into both blocks
    done_reading();  // [t | s']: its last readers (the previous step's update) are past a block barrier
    hand_off([&] {
      const float* wo = wout + static_cast<size_t>(k) * Hp * n_out;
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      for (int item = tid; item < (kWgRows / 4) * d_b; item += kWgConsumers) {
        const int c = static_cast<int>(rank) * d_b + item % d_b, r0 = (item / d_b) * 4;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kk = 0; kk < Hp; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(act + (r0 + r) * ldA + kk);
            acc[r] = fmaf(v.x, w0, acc[r]);
            acc[r] = fmaf(v.y, w1, acc[r]);
            acc[r] = fmaf(v.z, w2, acc[r]);
            acc[r] = fmaf(v.w, w3, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int at = (r0 + r) * n_out + c;
          outs[at] = acc[r] + bo[c];
          if (exchange) st_peer(outs_peer + 4u * static_cast<uint32_t>(at), outs[at]);
        }
      }
    });

    // ---- x_b <- (x_b - t) exp(-s) (one thread a row, the same in both blocks)
    if (tid < kWgRows) {
      float* xr = xs + tid * size;
      const float* o = outs + tid * n_out;
      for (int j = 0; j < d_b; ++j) xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-tanhf(o[d_b + j]));
    }
    consumer_sync();
    done_reading();  // the tile: its last readers (the output layer) are past a block barrier

    if (inner) {  // ---- ActNorm^-1
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      consumer_sync();
    }
  }

  if (rank == 0) {
    for (int p = tid; p < kWgRows * size; p += kWgConsumers)
      if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
  }
  cluster_sync();  // the producers' counterpart
}

// The build's inverse kernel: 3xTF32 or one pass.
template <int TN>
auto inverse_kernel() {
  if constexpr (kPasses == 3) {
    return flow_inverse_fold<TN>;
  } else {
    return flow_inverse_wgmma<TN>;
  }
}

template <int TN>
cudaError_t launch(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                   const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                   const float* bout, float* y, int B, int N, int S, int size, int d_a, int nh, int parts,
                   cudaStream_t stream) {
  const auto kernel = inverse_kernel<TN>();
  const size_t smem = wg_smem(32 * TN, size, d_a);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (B + kWgRows - 1) / kWgRows;
  if constexpr (kWgCluster == 1) {
    kernel<<<tiles, kWgThreads, smem, stream>>>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B,
                                                N, S, size, d_a, nh, parts);
  } else {
    // whole clusters: 3xTF32 a cluster a 64-row tile; one pass the tiles
    // rounded up to whole clusters, a block past the last row running the
    // protocol on masked rows (ops/flow_kernel.py: `wgmma_grid` mirrors this).
    // A refused launch returns its error (no launch without the cluster
    // stands in for it)
    const int clusters = kPasses == 3 ? tiles : (tiles + kWgCluster - 1) / kWgCluster;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kWgCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * kWgCluster));
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S,
                             size, d_a, nh, parts);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Clusters of the wgmma inverse resident on the whole card at once at this
// shape (kWgCluster blocks each; as the occupancy calculator gives it), or
// minus a cudaError_t.
template <int TN>
int resident_clusters(int size, int d_a) {
  const auto kernel = inverse_kernel<TN>();
  const size_t smem = wg_smem(32 * TN, size, d_a);
  if (smem > kSmemLimit) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWgCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kWgCluster));
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

template <int TN>
int occupancy(int size, int d_a) {
  const auto kernel = inverse_kernel<TN>();
  const size_t smem = wg_smem(32 * TN, size, d_a);
  if (smem > kSmemLimit) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWgThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

#define BCNF_WG_CASES(Hp, CASE) \
  switch ((Hp) / 32) {          \
    CASE(1)                     \
    CASE(2)                     \
    CASE(4)                     \
    CASE(8)                     \
    CASE(12)                    \
    CASE(16)                    \
    CASE(17)                    \
    default:                    \
      break;                    \
  }

// C entry points, loaded with ctypes.

// K1's inverse: y (B, size) from x (B, size); `wstages` is the hidden weights
// as `prepare_weights` lays them out, (S, nh, Hp/8/kWgStageK, 2,
// kWgStageK, 2, Hp/16, 2, 8, 4) floats (each stage by cluster rank, its
// k-steps, hi and lo; in the one-pass library (S,
// nh, Hp/8, 1, Hp/8, 2, 8, 4), hi alone), 16-byte aligned. Hp must be 32*TN
// for TN in 1, 2, 4, 8, 12, 16, 17; a `size` past the shared memory returns
// cudaErrorInvalidValue. `parts` is kWgProducts | kWgCopies | kWgExchange for
// the inverse; fewer times the rest (y not the inverse).
extern "C" int bcnf_flow_inverse_wgmma(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                       const float* ortho, const float* w1y, const float* b1, const float* wstages,
                                       const float* bm, const float* wout, const float* bout, float* y, int B, int N,
                                       int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 ||
      (nh > 0 && (reinterpret_cast<size_t>(wstages) & 15) != 0) ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(h_proj)) & 7) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                              \
  case TN:                                                                                                         \
    return launch<TN>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S, size, d_a, nh, \
                      parts, st);
  BCNF_WG_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

// Blocks of the wgmma inverse resident on one SM at this shape (as the
// occupancy calculator gives it), or minus a cudaError_t.
extern "C" int bcnf_flow_wgmma_occupancy(int Hp, int size, int d_a) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size) return -static_cast<int>(cudaErrorInvalidValue);
#define BCNF_CASE(TN) \
  case TN:            \
    return occupancy<TN>(size, d_a);
  BCNF_WG_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of the wgmma inverse the card holds at once at this shape, or
// minus a cudaError_t.
extern "C" int bcnf_flow_wgmma_clusters(int Hp, int size, int d_a) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size) return -static_cast<int>(cudaErrorInvalidValue);
#define BCNF_CASE(TN) \
  case TN:            \
    return resident_clusters<TN>(size, d_a);
  BCNF_WG_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
