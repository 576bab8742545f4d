// The whole-flow forward on Hopper's warpgroup tensor-core products
// (`wgmma`): K1's forward and the training forward K2a at the padded hidden
// widths Hp <= 544 (the flagship's 526 pads to 544), all S steps in one
// launch, built twice (bcnf_tpu_torch/ops/_build.py):
// - as it is (library `flow_fwd_wgmma`), 3xTF32, the default mode (the JAX
//   kernel's "x3" mode, which serves the "highest"/"float32" contract): every
//   hidden product three `wgmma`s a k-step, a_lo b_hi + a_hi b_lo + a_hi
//   b_hi, A split as it is loaded, B's hi and lo prepared once a step
//   (`prepare_train_weights(wm, passes=3)`); the passes go straight into the
//   running accumulator (unlike K2b's, no fold: K2a's distance from float64
//   sits at the row tiles' it replaces, PERF.md); K2a takes it, and K1's
//   forward and K4's, which the card's row sweeps found faster on it at every
//   row count measured (PERF.md);
// - with BCNF_TF32_PASSES=1 (library `flow_fwd_wgmma_tf32`), the reduced
//   mode (one TF32 pass a product: the JAX kernel's "default" mode, which
//   serves the "default", "bfloat16" and "BF16_BF16_F32_X3" precisions).
// The inverse keeps its kernel (flow_wgmma.cu); wider models run both ways
// in 3xTF32 on flow_wide_wgmma.cu and in one pass on flow_kernel.cu's row
// tiles; the strict mode is flow_fma.cu.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `fused_flow` with inverse=False (the
// Pallas TPU kernel `_flow_kernel`), `fwd_call` of `_make_fused_flow_train`
// (`_flow_fwd_train_kernel`, which also stores each step's input rows), and
// the forward of bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4,
// which the port runs as K1 at one step). Host side and plain PyTorch
// versions (`flow_route`, `fused_flow`, `fused_flow_train_fwd`,
// `fused_flow_reference` and `fused_flow_train_reference` with
// `mm=ops/tf32.py::matmul_3xtf32` or `matmul_tf32`): bcnf_tpu_torch/ops/flow_kernel.py. What it
// computes is flow_kernel.cu's forward, step by step: row r takes its
// condition h_proj[k, r % N] (N = B for K2a); with `bound` (K2a) each step's
// input rows go to bound[k].
//
// What bounds it on an H100: the square hidden products, 239 GFLOP at the
// flagship's 4096 rows, 0.48 ms at the dense TF32 rate (494.7 TFLOP/s) in one
// pass, 1.45 ms in 3xTF32 (twice the weights' bytes, three products). A
// 64-row tile uses each weight element it streams for 64 rows only, so the
// products need ~64 bytes of weights a cycle an SM to run at that rate, and an
// SM takes in ~40 GB/s (22 bytes a cycle) from L2 when every SM streams
// (PERF.md): each block streams its half of every hidden weight, 61.6 MB over
// the walk at the flagship's shape, ~1.5 ms at that intake. The FMA layers
// (the d_a inputs, the n_out outputs), the GELUs, the mixes and the cluster
// barriers between the layers add to it unless the stream runs beside them.
//
// Design (K2b's rows machinery, csrc/flow_train_wgmma.cu, without the
// backward's state):
// - A cluster of 2 blocks owns 64 rows (one `wgmma` M); each block owns half
//   of the Hp hidden columns, so 4096 rows fill 128 SMs. A block's 256
//   threads are two warpgroups, each one m64n(8 TN)k8 product a k-step (n136
//   at Hp 544), A from registers (the float32 activation tile, 64 x Hp, in
//   shared memory, rounded to TF32 or split into hi and lo as loaded), B from
//   the weight ring (in 3xTF32 a hidden stage is one k-step's hi and lo, the
//   floats of two one-pass k-steps, feeding three products). After
//   each hidden layer a block writes its columns of the next activation into
//   its own tile and its partner's (distributed shared memory) between two
//   cluster barriers (both blocks done reading, both tiles whole); the last
//   hidden layer feeds only the block's own share of the output layer.
// - The weights: the hidden ones as `prepare_train_weights` lays them out
//   (direction 0, the B operand of h Wm, rounded to TF32 and split by
//   column between the two ranks; K2b reads the same tensor), W1y's d_a rows
//   and Wout's rows of the block's columns as they are stored. One ring of
//   16-weight-row stages carries them all in the order the walk reads them,
//   step after step: W1y, the nh layers' Hp/16 stages each, Wout in as many
//   stages as its rows need. So the ring runs ahead across the layers and the
//   steps: while a block computes the input layer, a GELU epilogue, the output
//   layer, the affine update or the mix, the next stages are in flight. The
//   ring has as many stages as shared memory leaves beside the tile and the
//   rows' state (4 at the flagship's shape, K2b's has 3), one bulk copy
//   (`cp.async.bulk`) a stage on a CTA-scope mbarrier.
// - Who issues the copies: thread 0, right after a barrier every thread of the
//   block passes (the one after each hidden stage, after the input layer's
//   epilogue and after the output layer), into the slots that barrier freed,
//   up to `ring` stages past the last stage every thread is done with. A
//   thread only ever waits on a stage that thread 0 issued before the latest
//   of those barriers (a stage is issued ring - 1 >= 1 stages ahead of its
//   use, and thread 0 issues before it waits on anything), so no copy is ever
//   owed by a thread parked at a barrier (the deadlock flow_fma.cu's notes
//   record for copies issued by the warps that consume them).
// - The narrow products stay float32 FMA, as in every one-pass kernel of the
//   port: the input layer (each block its columns), the output layer (each
//   block its columns' share, a thread one output of 8 rows; the two halves
//   exchanged and added rank 0's first in both blocks), the ActNorm, the
//   affine update and the mixes (both blocks, all 64 rows, the same values).
//   Rows past B in the last cluster run on zeros and are not stored. Every
//   sum has one order: a call gives the same bits every time.
// - nh = 0 (K4 of a coupling with one hidden layer) runs: the ring then
//   carries W1y and Wout alone.

#include "flow_rows.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kFwRows = 64;       // rows a cluster: one wgmma M
constexpr int kFwCluster = 2;     // blocks of a cluster: prepare_train_weights splits each layer for two ranks
constexpr int kFwThreads = 256;   // two warpgroups
constexpr int kFwStageK = 16;     // weight rows (k) a one-pass hidden ring stage: two k-steps; every stage is kFwStageK x NB floats
constexpr int kFwParts = kPasses == 3 ? 2 : 1;  // a hidden weight's prepared parts: hi (and lo in 3xTF32)
constexpr int kFwSteps = kFwStageK / 8 / kFwParts;  // k-steps a hidden stage: two of hi, or one of hi and lo
constexpr int kFwRingMin = 2;     // the ring's stages: at least 2 (a stage is issued ring - 1 ahead of its use)
constexpr int kFwRingMax = 8;     // ... and at most 8
constexpr int kFwBarrierFloats = 16;  // the ring's 8-byte barriers at the start of shared memory
static_assert(kFwBarrierFloats >= 2 * kFwRingMax, "a barrier for every stage the ring may have");

template <int TN>
struct FwShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int ldA = Hp + 4;             // the activation tile (conflict-free fragment loads)
  static constexpr int NB = 16 * TN;             // a block's columns
  static constexpr int NW = 8 * TN;              // a warpgroup's: one m64nNk8 product
  static constexpr int R = 4 * TN;               // its accumulator floats a thread
  static constexpr int stage = kFwStageK * NB;   // floats of a ring stage
  static constexpr int stage_k = 8 * kFwSteps;   // weight rows (k) a hidden stage
  static constexpr int n_stages = Hp / stage_k;  // stages a hidden layer (2 TN, or 4 TN in 3xTF32: even)
  static constexpr int layer = Hp * NB * kFwParts;  // a rank's part of a layer's prepared weight
};

// Rows of Wout (n_out floats each) a ring stage of a block of NB columns
// carries: a multiple of 4 (each stage one 16-byte-aligned bulk copy), at
// most NB; 0 where a stage holds fewer than 4.
__host__ __device__ inline int wout_rows(int NB, int n_out) {
  const int rows = (kFwStageK * NB / n_out) & ~3;
  return rows < NB ? rows : NB;
}

// The kernel's dynamic shared memory with a ring of `ring` stages
// (bcnf_tpu_torch/ops/flow_kernel.py: fwd_wgmma_smem mirrors this sum): the
// ring's barriers, the tile, the ring, and the rows' state: x and the mix's
// output (size each), each rank's half of the output layer (2 n_out), logdet.
size_t fw_smem(int Hp, int size, int d_a, int ring) {
  const int n_out = 2 * (size - d_a);
  return sizeof(float) * (kFwBarrierFloats + static_cast<size_t>(kFwRows) * (Hp + 4) +
                          static_cast<size_t>(ring) * kFwStageK * (Hp / 2) +
                          static_cast<size_t>(kFwRows) * (2 * size + 2 * n_out + 1));
}

// The ring's stages at this shape: as many as fit, up to kFwRingMax, and at
// least kFwRingMin and Wout's stages (the output layer reads them all at
// once); 0 where the kernel refuses the shape: W1y's d_a rows past one stage,
// Wout's rows past what the ring holds, or no ring beside the tile and the
// rows' state (bcnf_tpu_torch/ops/flow_kernel.py: fwd_wgmma_ring mirrors this).
int fw_ring(int Hp, int size, int d_a) {
  const int NB = Hp / 2, rows = wout_rows(NB, 2 * (size - d_a));
  if (d_a > kFwStageK || rows < 4) return 0;
  const int stages = (NB + rows - 1) / rows, least = stages > kFwRingMin ? stages : kFwRingMin;
  for (int ring = kFwRingMax; ring >= least; --ring)
    if (fw_smem(Hp, size, d_a, ring) <= kSmemLimit) return ring;
  return 0;
}

template <int TN, bool kBound>
__global__ void __launch_bounds__(kFwThreads, 1)
fwd_rows_wgmma(const float* __restrict__ x, const float* __restrict__ h_proj, const float* __restrict__ an_s,
               const float* __restrict__ an_b, const float* __restrict__ ortho, const float* __restrict__ w1y,
               const float* __restrict__ b1, const float* __restrict__ wstages, const float* __restrict__ bm,
               const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ y,
               float* __restrict__ ld_out, float* __restrict__ bound, int B, int N, int S, int size, int d_a,
               int nh, int ring) {
  using W = FwShape<TN>;
  constexpr int Hp = W::Hp, ldA = W::ldA, NB = W::NB, NW = W::NW, R = W::R;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const int wo_rows = wout_rows(NB, n_out), wo_stages = (NB + wo_rows - 1) / wo_rows;
  const int P = 1 + nh * W::n_stages + wo_stages;  // ring stages a step: W1y, the hidden layers', Wout's
  const int T = S * P;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float* act = reinterpret_cast<float*>(smem4) + kFwBarrierFloats;  // 64 x Hp (ld ldA)
  float* ringp = act + kFwRows * ldA;                                // `ring` stages
  float* xs = ringp + ring * W::stage;                               // 64 x size: the rows' state
  float* xt = xs + kFwRows * size;                                   // 64 x size: the mix's output
  float* xch = xt + kFwRows * size;                                  // 2 x 64 x n_out: each rank's half of [t | s']
  float* lds = xch + 2 * kFwRows * n_out;                            // 64: logdet

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / kFwCluster) * kFwRows;
  const int c0 = static_cast<int>(rank) * NB;  // the block's columns
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int cw = c0 + wg * NW;  // the warpgroup's
  const uint32_t act_peer = map_peer(act, rank ^ 1u);
  const uint32_t xch_peer = map_peer(xch, rank ^ 1u);

  // ---- the ring (thread 0 issues): stage u of the walk is stage p = u % P of
  // step u / P, into slot u % ring
  int issued = 0, i_slot = 0, i_step = 0, i_p = 0;
  auto issue = [&]() {
    float* dst = ringp + i_slot * W::stage;
    uint64_t* bar = &full[i_slot];
    if (i_p == 0) {  // W1y's d_a rows of the block's columns
      mbar_arrive_expect_tx(bar, d_a * NB * sizeof(float));
      const float* src = w1y + static_cast<size_t>(i_step) * d_a * Hp + c0;
      for (int i = 0; i < d_a; ++i) bulk_copy_g2s(dst + i * NB, src + static_cast<size_t>(i) * Hp, NB * sizeof(float), bar);
    } else if (i_p <= nh * W::n_stages) {  // stage j of hidden layer l, this rank's part of direction 0
      const int l = (i_p - 1) / W::n_stages, j = (i_p - 1) % W::n_stages;
      const float* src = wstages + ((static_cast<size_t>(i_step) * nh + l) * 4 + rank) * W::layer +
                         static_cast<size_t>(j) * W::stage;
      mbar_arrive_expect_tx(bar, W::stage * sizeof(float));
      bulk_copy_g2s(dst, src, W::stage * sizeof(float), bar);
    } else {  // Wout's rows r0 .. of the block's columns
      const int r0 = (i_p - 1 - nh * W::n_stages) * wo_rows;
      const uint32_t bytes = (NB - r0 < wo_rows ? NB - r0 : wo_rows) * n_out * sizeof(float);
      mbar_arrive_expect_tx(bar, bytes);
      bulk_copy_g2s(dst, wout + (static_cast<size_t>(i_step) * Hp + c0 + r0) * n_out, bytes, bar);
    }
    ++issued;
    if (++i_slot == ring) i_slot = 0;
    if (++i_p == P) i_p = 0, ++i_step;
  };
  // Every thread is done with the stages before `done` (the caller has just
  // passed a barrier of the block): thread 0 refills their slots.
  auto release = [&](int done) {
    if (tid == 0)
      while (issued < T && issued < done + ring) issue();
  };
  int t = 0, slot = 0;  // the next stage to read and its slot (every thread keeps them)
  uint32_t phase = 0;   // ... and the parity of its barrier's phase
  auto next = [&](int n) {
    t += n;
    for (slot += n; slot >= ring; slot -= ring) phase ^= 1u;
  };
  // Stage t + a (a < ring) has landed; returns its slot's floats.
  auto wait_ahead = [&](int a) -> const float* {
    int s = slot + a;
    uint32_t p = phase;
    if (s >= ring) s -= ring, p ^= 1u;
    mbar_wait(&full[s], p);
    return ringp + s * W::stage;
  };

  if (tid == 0) {
    for (int i = 0; i < ring; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  release(0);
  for (int p = tid; p < kFwRows * size; p += kFwThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid < kFwRows) lds[tid] = 0.0f;
  cluster_sync();  // both blocks' shared memory is live (and the barriers initialised) before either reaches it

  // The thread's accumulator pairs, elements e, e + 1 at (row, col), (row,
  // col + 1) (wgmma_tf32.cuh's D layout; col global), kChunk column pairs at
  // a time: load(e, row, col) for every pair of a chunk first, then f(e, row,
  // col, loaded), so that a chunk's loads are in flight together.
  constexpr int kChunk = 4;
  auto each_loaded = [&](auto&& load, auto&& f) {
#pragma unroll
    for (int j0 = 0; j0 < TN; j0 += kChunk) {
      float2 v[kChunk][2];
#pragma unroll
      for (int j = j0; j < j0 + kChunk && j < TN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[j - j0][h] = load(4 * j + 2 * h, 16 * w4 + g + 8 * h, cw + 8 * j + 2 * q);
#pragma unroll
      for (int j = j0; j < j0 + kChunk && j < TN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) f(4 * j + 2 * h, 16 * w4 + g + 8 * h, cw + 8 * j + 2 * q, v[j - j0][h]);
    }
  };
  float acc[R];

  // A fragments of a stage's k-steps from column kcol of the tile: in one
  // pass k-steps kcol and kcol + 8, rounded to TF32; in 3xTF32 k-step kcol's
  // hi (a[0]) and lo (a[1]).
  auto load_a = [&](int kcol, uint32_t(&a)[2][4]) {
    if constexpr (kPasses == 1) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* p = act + (16 * w4 + g) * ldA + kcol + 8 * kk + q;
        a[kk][0] = tf32_rna(p[0]);
        a[kk][1] = tf32_rna(p[8 * ldA]);
        a[kk][2] = tf32_rna(p[4]);
        a[kk][3] = tf32_rna(p[8 * ldA + 4]);
      }
    } else {
      split_a_frag(act + (16 * w4 + g) * ldA + kcol + q, ldA, a[0], a[1]);
    }
  };
  // One stage: its products on `cur` (two k-steps in one pass; one k-step's
  // three passes in 3xTF32, B's hi then lo in the stage), the next stage's
  // fragments into `nxt` while they run, then the previous stage's slot freed
  // and refilled.
  auto stage = [&](const uint32_t(&cur)[2][4], uint32_t(&nxt)[2][4], int next_kcol) {
    const float* st = wait_ahead(0) + wg * TN * 64;
    wgmma_fence();
    if constexpr (kPasses == 1) {
      WgmmaTf32<NW>::mma(acc, cur[0], smem_desc(st, 128, 256));
      WgmmaTf32<NW>::mma(acc, cur[1], smem_desc(st + 2 * TN * 64, 128, 256));
    } else {
      wgmma_3xtf32<NW>(acc, cur[0], cur[1], smem_desc(st, 128, 256), smem_desc(st + 2 * TN * 64, 128, 256));
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage t - 1's group is done
    fence_operands(acc);
    if (next_kcol < Hp) load_a(next_kcol, nxt);
    __syncthreads();  // every warpgroup is done with stage t - 1
    release(t);
    next(1);
  };
  // acc = tile (64 x Hp) @ the hidden layer's stages (this warpgroup's columns)
  auto product = [&]() {
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    uint32_t fa[2][4], fb[2][4];
    load_a(0, fa);
#pragma unroll 1
    for (int j = 0; j < W::n_stages; j += 2) {
      stage(fa, fb, W::stage_k * (j + 1));
      stage(fb, fa, W::stage_k * (j + 2));
    }
    wgmma_wait<0>();
    fence_operands(acc);
  };
  // h = gelu(acc + bias) into the block's columns of the tile, and of the
  // partner's tile when `exchange`; `bias` null adds nothing
  auto hidden_out = [&](const float* bias, bool exchange) {
    auto load = [&](int, int, int col) {
      return bias != nullptr ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.0f, 0.0f);
    };
    each_loaded(load, [&](int e, int row, int col, float2 b) {
      const float h0 = gelu_tanh(acc[e] + b.x), h1 = gelu_tanh(acc[e + 1] + b.y);
      *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(h0, h1);
      if (exchange) st_peer2(act_peer + 4u * static_cast<uint32_t>(row * ldA + col), h0, h1);
    });
  };

  for (int k = 0; k < S; ++k) {
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;

    // ---- the step's input rows to bound[k] (K2a; rank 0), then the ActNorm
    for (int p = tid; p < kFwRows * size; p += kFwThreads) {
      if (kBound && rank == 0 && row0 + p / size < B) bound[(static_cast<size_t>(k) * B + row0) * size + p] = xs[p];
      if (inner) xs[p] = xs[p] * sc[p % size] + bi[p % size];
    }
    if (inner && tid < kFwRows) {
      float l = 0.0f;
      for (int i = 0; i < size; ++i) l += logf(fabsf(sc[i]));
      lds[tid] += l;
    }
    __syncthreads();

    // ---- a_0 = x1_a W1y + b1 + h_proj[k, row % N] (FMA, the block's columns;
    // W1y from the ring; each sum in input_layer's order: b1 + h_proj, then
    // the inputs in order, all of the thread's accumulators an input at a
    // time); h_0 = gelu(a_0) into both tiles
    {
      const float* b1k = b1 + static_cast<size_t>(k) * Hp;
      auto load = [&](int, int row, int col) {
        const float* hp = h_proj + (static_cast<size_t>(k) * N + (row0 + row) % N) * Hp + col;
        return row0 + row < B ? *reinterpret_cast<const float2*>(hp) : make_float2(0.0f, 0.0f);
      };
      each_loaded(load, [&](int e, int, int col, float2 hp) {
        const float2 bb = *reinterpret_cast<const float2*>(b1k + col);
        acc[e] = bb.x + hp.x;
        acc[e + 1] = bb.y + hp.y;
      });
      const float* xa = xs + (16 * w4 + g) * size;  // the thread's rows: 16 w4 + g and 8 on
      const float* wq = wait_ahead(0) + cw - c0 + 2 * q;
#pragma unroll 1
      for (int i = 0; i < d_a; ++i) {
        const float xa0 = xa[i], xa1 = xa[8 * size + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(wq + i * NB + 8 * j);
          acc[4 * j] = fmaf(xa0, w.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xa0, w.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xa1, w.x, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xa1, w.y, acc[4 * j + 3]);
        }
      }
    }
    hidden_out(nullptr, true);
    cluster_sync();  // both tiles hold h_0 (and both blocks are past the last step's readers of the halves)
    release(t + 1);
    next(1);

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma
    for (int l = 0; l < nh; ++l) {
      product();
      const bool last = l + 1 == nh;  // h_nh: the output layer reads only the block's own columns
      if (!last) cluster_sync(); else __syncthreads();  // the tiles' readers are done
      release(t);
      hidden_out(bm + (static_cast<size_t>(k) * nh + l) * Hp, !last);
      if (!last) cluster_sync(); else __syncthreads();  // both tiles whole (the block's own columns)
    }

    // ---- output layer: [t | s'] = h_nh Wout + bout (FMA): each block its
    // columns' half (a thread one output and 8 rows; Wout from the ring, its
    // rows in order), exchanged, added rank 0's first
    for (int item = tid; item < (kFwRows / 8) * n_out; item += kFwThreads) {
      const int c = item % n_out, r0 = (item / n_out) * 8;
      float s[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) s[r] = 0.0f;
      for (int ws = 0; ws < wo_stages; ++ws) {
        const float* wos = wait_ahead(ws) + c;
        const int kk0 = ws * wo_rows, kk1 = kk0 + wo_rows < NB ? kk0 + wo_rows : NB;
#pragma unroll 2
        for (int kk = kk0; kk < kk1; kk += 4) {
          const float* w = wos + (kk - kk0) * n_out;
          const float w0 = w[0], w1 = w[n_out], w2 = w[2 * n_out], w3 = w[3 * n_out];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(act + (r0 + r) * ldA + c0 + kk);
            s[r] = fmaf(v.x, w0, s[r]);
            s[r] = fmaf(v.y, w1, s[r]);
            s[r] = fmaf(v.z, w2, s[r]);
            s[r] = fmaf(v.w, w3, s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int o = static_cast<int>(rank) * kFwRows * n_out + (r0 + r) * n_out + c;
        xch[o] = s[r];
        st_peer(xch_peer + 4u * static_cast<uint32_t>(o), s[r]);
      }
    }
    cluster_sync();  // both halves in both blocks
    release(t + wo_stages);
    next(wo_stages);

    // ---- affine update of x_b, and the logdet (both blocks, one thread a row)
    if (tid < kFwRows) {
      float* xr = xs + tid * size;
      const float* o0 = xch + tid * n_out;
      const float* o1 = o0 + kFwRows * n_out;
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      float l = 0.0f;
      for (int j = 0; j < d_b; ++j) {
        const float s = tanhf(o0[d_b + j] + o1[d_b + j] + bo[d_b + j]);
        xr[d_a + j] = expf(s) * xr[d_a + j] + (o0[j] + o1[j] + bo[j]);
        l += s;
      }
      lds[tid] += l;
    }
    __syncthreads();

    if (inner) {  // ---- x <- x Q_k (FMA)
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      for (int p = tid; p < kFwRows * size; p += kFwThreads) {
        const int r = p / size, j = p % size;
        float a = 0.0f;
        for (int i = 0; i < size; ++i) a = fmaf(xs[r * size + i], Q[i * size + j], a);
        xt[p] = a;
      }
      float* tmp = xs;
      xs = xt;
      xt = tmp;
      __syncthreads();
    }
  }

  if (rank == 0) {
    for (int p = tid; p < kFwRows * size; p += kFwThreads)
      if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
    if (tid < kFwRows && row0 + tid < B) ld_out[row0 + tid] = lds[tid];
  }
}

cudaLaunchConfig_t fwd_config(int clusters, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFwCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kFwCluster));
  cfg.blockDim = dim3(kFwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int TN, bool kBound>
cudaError_t launch_fwd(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                       const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                       const float* bout, float* y, float* ld, float* bound, int B, int N, int S, int size, int d_a,
                       int nh, cudaStream_t stream) {
  const int ring = fw_ring(32 * TN, size, d_a);
  if (ring == 0) return cudaErrorInvalidValue;
  const size_t smem = fw_smem(32 * TN, size, d_a, ring);
  cudaError_t err = cudaFuncSetAttribute(fwd_rows_wgmma<TN, kBound>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_config((B + kFwRows - 1) / kFwRows, smem, stream, attr);
  if ((err = cudaLaunchKernelEx(&cfg, fwd_rows_wgmma<TN, kBound>, x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm,
                                wout, bout, y, ld, bound, B, N, S, size, d_a, nh, ring)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// [ring stages, bytes of shared memory, blocks, clusters resident at once on the card]
template <int TN>
cudaError_t layout(int size, int d_a, int B, int* out) {
  const int ring = fw_ring(32 * TN, size, d_a);
  if (ring == 0) return cudaErrorInvalidValue;
  const size_t smem = fw_smem(32 * TN, size, d_a, ring);
  cudaError_t err = cudaFuncSetAttribute(fwd_rows_wgmma<TN, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_config(1, smem, nullptr, attr);
  out[0] = ring;
  out[1] = static_cast<int>(smem);
  out[2] = (B + kFwRows - 1) / kFwRows * kFwCluster;
  return cudaOccupancyMaxActiveClusters(&out[3], fwd_rows_wgmma<TN, false>, &cfg);
}

}  // namespace

#define BCNF_FW_CASES(Hp, CASE) \
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

// K1's forward (bound null; y = z, ld = logdet) or K2a (bound non-null: every
// step's input rows, (S, B, size); call it with N = B, h_proj (S, B, Hp)) on
// this route. Row r takes h_proj[k, r % N]. `wstages` is the hidden weights
// as `prepare_train_weights` lays them out ((S, nh, 2, 2, Hp/8, Hp/16, 2, 8,
// 4) floats in TF32, in 3xTF32 (S, nh, 2, 2, Hp/8, 2, Hp/16, 2, 8, 4); unread
// when nh is 0); it, h_proj, w1y and wout must be
// 16-byte aligned. Hp must be 32*TN for TN in 1, 2, 4, 8, 12, 16, 17; a shape
// `fw_ring` refuses returns cudaErrorInvalidValue. Returns the launch's
// cudaError_t.
extern "C" int bcnf_flow_fwd_wgmma(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                   const float* ortho, const float* w1y, const float* b1, const float* wstages,
                                   const float* bm, const float* wout, const float* bout, float* y, float* ld,
                                   float* bound, int B, int N, int S, int size, int d_a, int nh, int Hp,
                                   void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 || ld == nullptr ||
      ((reinterpret_cast<size_t>(wstages) | reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(w1y) |
        reinterpret_cast<size_t>(wout)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                            \
  case TN:                                                                                                       \
    return bound != nullptr                                                                                      \
               ? launch_fwd<TN, true>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, ld,     \
                                      bound, B, N, S, size, d_a, nh, st)                                         \
               : launch_fwd<TN, false>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, ld,    \
                                       bound, B, N, S, size, d_a, nh, st);
  BCNF_FW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

// The route's layout at this shape (see `layout`) into out[0..3]; returns a
// cudaError_t.
extern "C" int bcnf_flow_fwd_wgmma_layout(int Hp, int size, int d_a, int B, int* out) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size || B <= 0) return cudaErrorInvalidValue;
#define BCNF_CASE(TN) \
  case TN:            \
    return layout<TN>(size, d_a, B, out);
  BCNF_FW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
