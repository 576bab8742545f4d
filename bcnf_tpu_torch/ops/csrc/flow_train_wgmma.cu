// K2b on Hopper's warpgroup tensor-core products (`wgmma`): the training
// backward of the whole flow at the padded hidden widths Hp <= 544 (the
// flagship's 526 pads to 544), built twice (bcnf_tpu_torch/ops/_build.py):
// - as it is (library `flow_train_wgmma`), 3xTF32, the default mode (the
//   JAX kernel's "x3" mode, which serves the "highest"/"float32" contract):
//   every square product is three `wgmma`s a k-step, a_lo b_hi + a_hi b_lo +
//   a_hi b_hi, A split as it is loaded (hi = tf32_rna(x), lo = x - hi), B's hi
//   and lo prepared once a step (`prepare_train_weights(wm, passes=3)`);
// - with BCNF_TF32_PASSES=1 (library `flow_train_wgmma_tf32`), the reduced
//   mode (one TF32 pass a product: the JAX kernel's "default" mode, which
//   serves the "default", "bfloat16" and "BF16_BF16_F32_X3" precisions).
// Wider models take flow_wide_train_wgmma.cu in 3xTF32 (Hp 768 and 1024)
// and the row tiles of flow_train_kernel.cu in one pass; the strict mode is
// flow_train_fma.cu.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `bwd_call` of
// `_make_fused_flow_train` (the Pallas TPU kernel `_flow_bwd_train_kernel`).
// Host side and plain PyTorch version (`fused_flow_train_bwd`,
// `train_bwd_route`, `prepare_train_weights`,
// `fused_flow_train_backward_reference` with `mm=ops/tf32.py::matmul_3xtf32`
// or `matmul_tf32`): bcnf_tpu_torch/ops/flow_kernel.py. What it computes is
// flow_train_kernel.cu's header, step by step: for k = S-1 .. 0 the step's MLP
// recomputed from the step inputs K2a stored, its backward, and every weight
// grad summed over the B rows.
//
// What bounds it on an H100: the square products, three equal thirds (the
// recompute h_l Wm_l, the backward da_{l+1} Wm_l^T, the weight grads
// h_l^T da_{l+1}), 717 GFLOP at the flagship's 4096 rows: 1.45 ms at the
// dense TF32 rate in one pass, 4.35 ms in 3xTF32 (three products a product). A
// 64-row tile uses each weight element it streams for 64 rows only, so the
// recompute and backward products need ~64 bytes of weights a cycle an SM to
// run at the one-pass rate, and an SM takes in ~40 GB/s (22 bytes a cycle)
// from L2 when every SM streams (PERF.md): the weights' stream, not the
// tensor cores, holds the one-pass products; in 3xTF32 each streamed stage
// (one k-step's hi and lo, the same bytes as two one-pass k-steps) feeds
// three products while it is resident. The FMA layers, the epilogues and the
// scratch they write add to it, since one block an SM has no second tile to
// overlap them with. The design keeps what is not a product short.
//
// Design, per step (two launches a step and one a call, on the caller's
// stream; `parts` runs each kind alone):
// 1. `bwd_rows_wgmma` (BWD_ROWS): a cluster of 2 blocks owns 64 rows (one
//    `wgmma` M); each block owns half of the Hp hidden columns, so 4096 rows
//    fill 128 SMs. A block's 256 threads are two warpgroups, each one
//    m64n(8 TN)k8 product a k-step and pass (n136 at Hp 544), A from
//    registers (the float32 activation tile in shared memory, rounded to TF32
//    as loaded, tf32_rna, or split into hi and lo), B from a 3-stage ring of
//    kTwStageK x Hp/2 floats a stage (two k-steps of hi, or one k-step of hi
//    and lo), one bulk copy a stage (`cp.async.bulk`, issued by thread 0 once a
//    block-wide barrier has freed the slot; in one pass one `wgmma` group in
//    flight across the refill; in 3xTF32 each stage's three passes go into a
//    fresh accumulator kFoldGroups n-groups at a time, each waited for and
//    added to float32 running sums, `fold_groups`: the tensor cores'
//    accumulator truncates, and summed straight through 204 passes K2b drifted
//    further from float64 than the row tiles; a fresh accumulator of all 17
//    n-groups, or of half of them, spilled beside the running sums). The
//    weights are prepared once a call or step (`prepare_kernel`): rounded to
//    TF32 (and their lo beside) and laid out stage by stage for each block's
//    columns, Wm^T for the recompute and Wm as stored for the backward. After
//    each layer a block writes its columns of the next activation (or
//    cotangent) into its own tile and its partner's (distributed shared
//    memory), between two cluster barriers (both blocks done reading, both
//    tiles whole). gelu'(a_l) goes to a block-private scratch in the threads'
//    own fragment order (coalesced, read back by the same threads, each
//    chunk's loads issued together); h_l (rounded to TF32, and in 3xTF32 its
//    lo = h_l - hi in a plane of its own: the weight-grad pass's B) and
//    da_{l+1} go out from the registers in the weight-grad pass's stage
//    layouts (below), rows past B as zeros. The narrow products (the d_a
//    inputs W1y, the n_out outputs Wout, dh = dout Wout^T, dx_a = da_0 W1y^T)
//    and the mixes stay float32 FMA, their weights staged through the ring
//    while it holds no stage (W1y in its third slot before the first product,
//    Wout after the recompute, W1y after the backward; each within a stage's
//    floats, tw_takes); a block takes its columns' share, and the two halves
//    of the output layer and of dx_a are added in one order (rank 0's then
//    rank 1's) in both blocks. dWout and dW1y (in one pass on operands
//    rounded to TF32, as the plain one-pass version's products; in 3xTF32 on
//    the float32 operands, float32 FMA: no further from the exact product
//    than 3xTF32), the bias column sums of dout and da_0 and the ActNorm sums
//    (float32) are taken over the cluster's 64 rows into a partial per step
//    and cluster: no scratch plane for them. The rows kernel needs 250
//    registers a thread at Hp 544 in one pass, 251 in 3xTF32 with its fold;
//    an array more live spills, and the spills cost ~1 ms a call (PERF.md).
// 2. `dwm_wgmma` (BWD_WEIGHT_GRADS): dWm_l^T = da_{l+1}^T h_l over the rows,
//    a block a 64 x (8 TN) tile of one layer (nh x ceil(Hp/64) x 4 blocks a
//    step, two an SM), one warpgroup: A = da_{l+1} from registers, rounded to
//    TF32 (or split into hi and lo) as loaded (32-row blocks of 64 features,
//    XOR-swizzled so the fragment loads are conflict-free), B = h_l as the
//    rows kernel rounded it (and its lo) (32 rows x 8 TN features in the
//    core-matrix order the descriptor reads); a stage is kGwRows rows, one
//    bulk copy of each a 32-row block. Each stage's product goes into a fresh
//    accumulator that is then added to a float32 running sum (the tensor
//    cores' accumulator truncates), rows in one order, no atomics. The bias
//    grads dbm_l are float32 sums of A's raw values, taken as they are
//    loaded (in 3xTF32 a stage's part first, then added to the sum). Held by
//    each SM's intake: a stage's A is read by 4 blocks, its B by ceil(Hp/64).
// 3. `tw_reduce` (BWD_ACTNORM, once after the last step): the partials summed
//    over the clusters in cluster order into dWout, dbout, dW1y, db1 and the
//    ActNorm grads (zero at the final step).
// Deterministic: every sum has one order; a run gives the same bits.

#include "flow_rows.cuh"
#include "train_partials.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kTwRows = 64;       // rows a cluster: one wgmma M
constexpr int kTwCluster = 2;     // blocks of a cluster, each owning half of the hidden columns
constexpr int kTwThreads = 256;   // two warpgroups
constexpr int kTwStageK = 16;     // weight rows (k) a one-pass ring stage: two k-steps; every stage is kTwStageK x NB floats
constexpr int kTwRing = 3;        // stages of the rows kernel's weight ring
constexpr int kTwBarrierFloats = 16;  // the ring's barriers at the start of shared memory
constexpr int kTwParts = kPasses == 3 ? 2 : 1;  // a weight's prepared parts: hi (and lo in 3xTF32)
constexpr int kTwSteps = kTwStageK / 8 / kTwParts;  // k-steps a stage: two of hi, or one of hi and lo
constexpr int kGwRows = kPasses == 3 ? 32 : 64;  // rows (k) a stage of the weight-grad pass (two blocks an SM)
constexpr int kFoldGroups = 6;    // 3xTF32: n-groups (8 columns) a fresh accumulator of the rows kernel folds at once
constexpr int kGwRing = 2;        // its stages
constexpr int kGwThreads = 128;   // one warpgroup
constexpr int kGwTile = 64;       // A features (dWm columns) a block: one wgmma M

template <int TN>
struct TwShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int ldA = Hp + 4;             // the activation tile (conflict-free fragment loads)
  static constexpr int NB = 16 * TN;             // a block's columns
  static constexpr int NW = 8 * TN;              // a warpgroup's: one m64nNk8 product
  static constexpr int R = 4 * TN;               // its accumulator floats a thread
  static constexpr int stage = kTwStageK * NB;   // floats of a ring stage
  static constexpr int stage_k = 8 * kTwSteps;   // weight rows (k) a stage
  static constexpr int n_stages = Hp / stage_k;  // stages a layer (2 TN, or 4 TN in 3xTF32: even)
  static constexpr int layer = Hp * NB * kTwParts;  // a block's part of a layer's prepared weight
  static constexpr int MT = (Hp + kGwTile - 1) / kGwTile;  // the weight-grad pass's A tiles
};

// Floats of the rows kernel's per-row state: x1, dx2 (then dx1) (size each),
// [t | s'] (then dout) and dout in TF32 (n_out each), x1_a in TF32 (d_a), the
// halves of the narrow products exchanged between the blocks (2 x max(n_out,
// d_a)), dld.
size_t tw_state_floats(int size, int d_a) {
  const int n_out = 2 * (size - d_a);
  const int xw = n_out > d_a ? n_out : d_a;
  return static_cast<size_t>(kTwRows) * (2 * size + 2 * n_out + d_a + 2 * xw + 1);
}

// The rows kernel's dynamic shared memory (bcnf_tpu_torch/ops/flow_kernel.py:
// kernel_smem mirrors this sum): barriers, tile, ring, rows' state.
size_t tw_smem(int Hp, int size, int d_a) {
  return sizeof(float) * (kTwBarrierFloats + static_cast<size_t>(kTwRows) * (Hp + 4) +
                          static_cast<size_t>(kTwRing) * kTwStageK * (Hp / 2) + tw_state_floats(size, d_a));
}

// Whether the rows kernel takes this shape beside its shared memory: the
// narrow products' weights pass through the ring (Wout's NB x n_out floats
// through all of it, W1y's d_a x NB through one stage), reckoned in a stage's
// floats (kTwStageK x NB, in either mode), so n_out <= kTwRing kTwStageK and
// d_a <= kTwStageK (bcnf_tpu_torch/ops/flow_kernel.py: train_bwd_route
// mirrors this).
bool tw_takes(int Hp, int size, int d_a) {
  return 2 * (size - d_a) <= kTwRing * kTwStageK && d_a <= kTwStageK && tw_smem(Hp, size, d_a) <= kSmemLimit;
}

// The weight-grad pass's: barriers and kGwRing stages of A (kGwRows x 64) and
// B (kGwRows x Hp/4, and its lo in 3xTF32).
size_t gw_smem(int Hp) {
  return sizeof(float) * (kTwBarrierFloats + static_cast<size_t>(kGwRing) * kGwRows * (kGwTile + kTwParts * Hp / 4));
}
static_assert(kGwRows % 32 == 0, "a weight-grad stage is whole 32-row blocks of the stage layouts");

struct TwScratch {
  float* gs;    // gelu'(a_l), l <= nh: each block's in its threads' fragment order
  float* hT;    // h_l, l < nh, in the B stage layout (plane l; in 3xTF32 hi, and its lo in plane nh + l)
  float* daA;   // da_{l+1}, l < nh, in the A stage layout (plane l)
  float* part;  // a Partial per step and cluster
};

// 3xTF32's fold: the warpgroup's n-groups G0 .. G0 + G of a stage (G at most
// kFoldGroups), the stage's k-step in three passes into the fresh accumulator
// `part` (B's n-group j 64 floats on from `st`, its lo 2 TN x 64 floats on),
// waited for and added to the float32 running sums acc[4 G0 ..]; then the next
// n-groups. The tensor cores' accumulator truncates: summed straight into
// `acc`, the 204 passes of a 544-long product left K2b further from float64
// than the row tiles on trained weights; a fresh accumulator of every n-group
// (68 floats at TN 17) or of half of them spilled at 255 registers (PERF.md).
template <int TN, int G0>
__device__ __forceinline__ void fold_groups(float (&acc)[4 * TN], float (&part)[4 * (TN < kFoldGroups ? TN : kFoldGroups)],
                                            const uint32_t (&ahi)[4], const uint32_t (&alo)[4], const float* st) {
  constexpr int G = TN - G0 < kFoldGroups ? TN - G0 : kFoldGroups;
  float(&p)[4 * G] = *reinterpret_cast<float(*)[4 * G]>(part);
  wgmma_fence();
  wgmma_3xtf32<8 * G>(p, ahi, alo, smem_desc(st + G0 * 64, 128, 256), smem_desc(st + 2 * TN * 64 + G0 * 64, 128, 256),
                      true);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(p);
#pragma unroll
  for (int e = 0; e < 4 * G; ++e) acc[4 * G0 + e] += p[e];
  if constexpr (G0 + G < TN) fold_groups<TN, G0 + G>(acc, part, ahi, alo, st);
}

template <int TN>
__global__ void __launch_bounds__(kTwThreads, 1)
bwd_rows_wgmma(const float* __restrict__ bound, const float* __restrict__ h_proj, const float* __restrict__ dld,
               const float* __restrict__ an_s, const float* __restrict__ an_b, const float* __restrict__ ortho,
               const float* __restrict__ w1y, const float* __restrict__ b1, const float* __restrict__ wstages,
               const float* __restrict__ bm, const float* __restrict__ wout, const float* __restrict__ bout,
               float* __restrict__ dxy, float* __restrict__ dhp, TwScratch sc, int B, int S, int k, int size,
               int d_a, int nh) {
  using W = TwShape<TN>;
  constexpr int Hp = W::Hp, ldA = W::ldA, NB = W::NB, NW = W::NW, R = W::R;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const int xw = n_out > d_a ? n_out : d_a;
  const bool inner = k < S - 1;
  const int clusters = gridDim.x / kTwCluster;
  const Partial pt(Hp, size, d_a);

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float* act = reinterpret_cast<float*>(smem4) + kTwBarrierFloats;  // 64 x Hp (ld ldA)
  float* ring = act + kTwRows * ldA;                                 // kTwRing weight stages
  float* x1s = ring + kTwRing * W::stage;                            // 64 x size: x1, after the ActNorm
  float* dx2s = x1s + kTwRows * size;                                // 64 x size: dy Q^T, then dx1
  float* outs = dx2s + kTwRows * size;                               // 64 x n_out: [t | s'], then dout
  float* doutr = outs + kTwRows * n_out;                             // 64 x n_out: dout in TF32
  float* x1r = doutr + kTwRows * n_out;                              // 64 x d_a: x1_a in TF32
  float* xch = x1r + kTwRows * d_a;                                  // 2 x 64 x xw: each rank's half
  float* dlds = xch + 2 * kTwRows * xw;                              // 64

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kTwCluster;
  const int row0 = cluster * kTwRows;
  const int c0 = static_cast<int>(rank) * NB;  // the block's columns
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int cw = c0 + wg * NW;  // the warpgroup's
  const uint32_t act_peer = map_peer(act, rank ^ 1u);
  const uint32_t xch_peer = map_peer(xch, rank ^ 1u);
  const size_t rows_c = static_cast<size_t>(clusters) * kTwRows;
  float* gblk = sc.gs + static_cast<size_t>(blockIdx.x) * kTwThreads * R;  // + l * rows_c * Hp
  float* pk = sc.part + (static_cast<size_t>(k) * clusters + cluster) * pt.floats;

  // The ring: stage t of the launch's 2 nh layers (the recompute's Wm^T for
  // l = 0 .. nh-1, then the backward's Wm for l = nh-1 .. 0), issued up to
  // `limit`: the backward's stages wait until the narrow products between
  // the two halves have read their weights from the ring.
  const int T = 2 * nh * W::n_stages, half = nh * W::n_stages;
  int limit = half;
  const float* wk = wstages + (static_cast<size_t>(k) * nh * 4 + rank) * W::layer;  // step k's, this rank's
  auto issue = [&](int t) {
    if (t >= limit) return;
    const int L = t / W::n_stages, j = t % W::n_stages;
    const int dl = L < nh ? 2 * L : 2 * (2 * nh - 1 - L) + 1;  // 2 l + direction
    const float* src = wk + static_cast<size_t>(2 * dl) * W::layer + static_cast<size_t>(j) * W::stage;
    const int slot = t % kTwRing;
    mbar_arrive_expect_tx(&full[slot], W::stage * sizeof(float));
    bulk_copy_g2s(ring + slot * W::stage, src, W::stage * sizeof(float), &full[slot]);
  };
  // The narrow products' weights through the ring, on their own barrier
  // (`wbar`, three uses a launch): W1y's block columns (d_a x NB) into `dst`.
  uint64_t* wbar = full + kTwRing;
  const float* w1k = w1y + static_cast<size_t>(k) * d_a * Hp + c0;
  auto stage_w1y = [&](float* dst) {
    mbar_arrive_expect_tx(wbar, d_a * NB * sizeof(float));
    for (int i = 0; i < d_a; ++i)
      bulk_copy_g2s(dst + i * NB, w1k + static_cast<size_t>(i) * Hp, NB * sizeof(float), wbar);
  };
  float* w1s = ring + (kTwRing - 1) * W::stage;  // W1y for the input layer: the third stage's slot, free until then
  if (tid == 0) {
    for (int i = 0; i <= kTwRing; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    stage_w1y(w1s);
    for (int t = 0; t < kTwRing - 1; ++t) issue(t);
  }

  // ---- the rows' inputs: x1 = x_k s_k + b_k (identity at the final step), dld
  const float* sck = an_s + static_cast<size_t>(k) * size;
  const float* bik = an_b + static_cast<size_t>(k) * size;
  for (int p = tid; p < kTwRows * size; p += kTwThreads) {
    const int r = p / size, i = p % size;
    const float x = row0 + r < B ? bound[(static_cast<size_t>(k) * B + row0) * size + p] : 0.0f;
    const float v = inner ? x * sck[i] + bik[i] : x;
    x1s[p] = v;
    if (i < d_a) x1r[r * d_a + i] = kPasses == 1 ? rna(v) : v;
  }
  if (tid < kTwRows) dlds[tid] = row0 + tid < B ? dld[row0 + tid] : 0.0f;
  cluster_sync();  // both blocks' shared memory is live (and the barriers initialised) before either reaches it

  // The thread's accumulator pairs, elements e, e + 1 at (row, col), (row,
  // col + 1) (wgmma_tf32.cuh's D layout; col global), kChunk column pairs at
  // a time: load(e, row, col) for every pair of a chunk first, then f(e, row,
  // col, loaded): the loads of a chunk are in flight together (the stores of
  // `f` would otherwise hold each next load back, the compiler not knowing
  // that they do not alias).
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
  // 3xTF32: a stage's three passes go into this fresh accumulator
  // (`fold_groups`, kFoldGroups n-groups at a time)
  [[maybe_unused]] float part[kPasses == 3 ? 4 * (TN < kFoldGroups ? TN : kFoldGroups) : 1];

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
  int t = 0;  // the next ring stage to consume (every thread keeps the count)
  // One stage: its products on `cur` (two k-steps in one pass; one k-step's
  // three passes in 3xTF32, B's hi then lo in the stage), the next stage's
  // fragments into `nxt` while they run, then the previous stage's slot freed
  // and refilled. One pass keeps a group in flight across the refill; 3xTF32
  // waits for the stage's group and folds it.
  auto stage = [&](const uint32_t(&cur)[2][4], uint32_t(&nxt)[2][4], int next_kcol) {
    const int slot = t % kTwRing;
    mbar_wait(&full[slot], static_cast<uint32_t>(t / kTwRing) & 1u);
    const float* st = ring + slot * W::stage + wg * TN * 64;
    wgmma_fence();
    if constexpr (kPasses == 1) {
      WgmmaTf32<NW>::mma(acc, cur[0], smem_desc(st, 128, 256));
      WgmmaTf32<NW>::mma(acc, cur[1], smem_desc(st + 2 * TN * 64, 128, 256));
      wgmma_commit();
      wgmma_wait<1>();  // stage t - 1's group, which read `nxt`, is done
      fence_operands(acc);
      if (next_kcol < Hp) load_a(next_kcol, nxt);
    } else {
      fold_groups<TN, 0>(acc, part, cur[0], cur[1], st);
      if (next_kcol < Hp) load_a(next_kcol, nxt);  // once `cur` is free
    }
    __syncthreads();  // every warpgroup is done with stage t - 1
    if (tid == 0) issue(t + kTwRing - 1);
    ++t;
  };
  // acc = tile (64 x Hp) @ the next layer's stages (this warpgroup's columns)
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
  // h = gelu(acc + bias) into the tile (and the partner's when `exchange`),
  // gelu' to layer L's scratch, h in TF32 to `h_out` (the weight-grad pass's
  // B layout; rows past B as zeros; in 3xTF32 its lo = h - hi nh planes on)
  // unless null
  auto forward_out = [&](int L, const float* bias, bool exchange, float* h_out) {
    float* gl = gblk + static_cast<size_t>(L) * rows_c * Hp;
    auto load = [&](int, int, int col) {
      return bias != nullptr ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.0f, 0.0f);
    };
    each_loaded(load, [&](int e, int row, int col, float2 b) {
      float h0, h1, d0, d1;
      gelu_and_grad(acc[e] + b.x, h0, d0);
      gelu_and_grad(acc[e + 1] + b.y, h1, d1);
      *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(h0, h1);
      if (exchange) st_peer2(act_peer + 4u * static_cast<uint32_t>(row * ldA + col), h0, h1);
      *reinterpret_cast<float2*>(gl + (e / 2 * kTwThreads + tid) * 2) = make_float2(d0, d1);
      if (h_out != nullptr) {  // in TF32: the weight-grad pass's B goes to the tensor cores as stored
        const bool valid = row0 + row < B;
        float* o = h_out + hT_index(row0 + row, col, Hp);  // col + 1 is 4 floats on
        o[0] = valid ? rna(h0) : 0.0f;
        o[4] = valid ? rna(h1) : 0.0f;
        if constexpr (kPasses == 3) {
          float* lo = o + static_cast<size_t>(nh) * rows_c * Hp;
          lo[0] = valid ? h0 - rna(h0) : 0.0f;
          lo[4] = valid ? h1 - rna(h1) : 0.0f;
        }
      }
    });
  };
  // da = gelu'(a_L) dh into the tile (and the partner's when `exchange`),
  // to `da_out` (the weight-grad pass's A layout; rows past B as zeros)
  // unless null, and to `rows_out` (row-major, rows < B) unless null; dh(e,
  // row, col) gives the pair's dh (the accumulator's after a product)
  auto backward_out = [&](int L, bool exchange, float* da_out, float* rows_out, auto&& dh) {
    const float* gl = gblk + static_cast<size_t>(L) * rows_c * Hp;
    auto load = [&](int e, int, int) { return *reinterpret_cast<const float2*>(gl + (e / 2 * kTwThreads + tid) * 2); };
    each_loaded(load, [&](int e, int row, int col, float2 gp) {
      const float2 d = dh(e, row, col);
      const float da0 = d.x * gp.x, da1 = d.y * gp.y;
      const bool valid = row0 + row < B;
      *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(da0, da1);
      if (exchange) st_peer2(act_peer + 4u * static_cast<uint32_t>(row * ldA + col), da0, da1);
      if (da_out != nullptr)  // col and col + 1 stay side by side under the swizzle
        *reinterpret_cast<float2*>(da_out + daA_index(row0 + row, col, W::MT)) =
            valid ? make_float2(da0, da1) : make_float2(0.0f, 0.0f);
      if (rows_out != nullptr && valid)
        *reinterpret_cast<float2*>(rows_out + static_cast<size_t>(row0 + row) * Hp + col) = make_float2(da0, da1);
    });
  };
  // The block's columns of the tile in TF32, in place.
  auto round_tile = [&]() {
    for (int it = tid; it < kTwRows * (NB / 4); it += kTwThreads) {
      float4* p = reinterpret_cast<float4*>(act + (it / (NB / 4)) * ldA + c0 + (it % (NB / 4)) * 4);
      const float4 v = *p;
      *p = make_float4(rna(v.x), rna(v.y), rna(v.z), rna(v.w));
    }
  };
  float* hT = sc.hT;
  float* daA = sc.daA;
  const size_t hT_plane = rows_c * Hp, daA_plane = rows_c * W::MT * kGwTile;

  // ---- recompute: a_0 = x1_a W1y + b1 + h_proj[k, row] (FMA, the block's
  // columns; W1y from the ring; each sum in input_layer's order)
  {
    const float* b1k = b1 + static_cast<size_t>(k) * Hp;
    mbar_wait(wbar, 0);
    auto load = [&](int, int row, int col) {
      const float* hp = h_proj + (static_cast<size_t>(k) * B + row0 + row) * Hp + col;
      return row0 + row < B ? *reinterpret_cast<const float2*>(hp) : make_float2(0.0f, 0.0f);
    };
    each_loaded(load, [&](int e, int row, int col, float2 hp) {
      const float2 bb = *reinterpret_cast<const float2*>(b1k + col);
      float a0 = bb.x + hp.x, a1 = bb.y + hp.y;
      const float* xr = x1s + row * size;
      for (int i = 0; i < d_a; ++i) {
        const float2 w = *reinterpret_cast<const float2*>(w1s + i * NB + col - c0);
        a0 = fmaf(xr[i], w.x, a0);
        a1 = fmaf(xr[i], w.y, a1);
      }
      acc[e] = a0;
      acc[e + 1] = a1;
    });
  }
  forward_out(0, nullptr, true, hT);
  cluster_sync();  // both tiles hold h_0

  // ---- hidden layers: a_{l+1} = h_l Wm_l + bm_l on wgmma
  for (int l = 0; l < nh; ++l) {
    product();
    const bool last = l + 1 == nh;  // h_nh: the narrow products read only the block's own columns
    if (!last) cluster_sync(); else __syncthreads();  // the tiles' readers are done
    forward_out(l + 1, bm + (static_cast<size_t>(k) * nh + l) * Hp, !last, last ? nullptr : hT + (l + 1) * hT_plane);
    if (!last) cluster_sync();
  }
  // the ring is free: Wout's rows of the block's columns (NB x n_out) into it
  float* wos = ring;
  if (tid == 0) {
    mbar_arrive_expect_tx(wbar, NB * n_out * sizeof(float));
    bulk_copy_g2s(wos, wout + (static_cast<size_t>(k) * Hp + c0) * n_out, NB * n_out * sizeof(float), wbar);
  }
  __syncthreads();
  mbar_wait(wbar, 1);

  // ---- output layer: [t | s'] = h_nh Wout + bout (FMA): each block its
  // columns' half (a thread one output and 8 rows), exchanged, added rank 0's first
  for (int item = tid; item < (kTwRows / 8) * n_out; item += kTwThreads) {
    const int c = item % n_out, r0 = (item / n_out) * 8;
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < NB; kk += 4) {
      const float w0 = wos[kk * n_out + c], w1 = wos[(kk + 1) * n_out + c];
      const float w2 = wos[(kk + 2) * n_out + c], w3 = wos[(kk + 3) * n_out + c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(act + (r0 + r) * ldA + c0 + kk);
        s[r] = fmaf(v.x, w0, s[r]);
        s[r] = fmaf(v.y, w1, s[r]);
        s[r] = fmaf(v.z, w2, s[r]);
        s[r] = fmaf(v.w, w3, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int o = static_cast<int>(rank) * kTwRows * xw + (r0 + r) * xw + c;
      xch[o] = s[r];
      st_peer(xch_peer + 4u * static_cast<uint32_t>(o), s[r]);
    }
  }
  cluster_sync();  // both halves in both blocks; both blocks are past their last forward product
  const float* bok = bout + static_cast<size_t>(k) * n_out;
  for (int p = tid; p < kTwRows * n_out; p += kTwThreads) {
    const int r = p / n_out, c = p % n_out;
    outs[p] = xch[r * xw + c] + xch[kTwRows * xw + r * xw + c] + bok[c];
  }

  // ---- backward through the mix and the affine update (both blocks, all rows)
  const float* Q = ortho + static_cast<size_t>(k) * size * size;
  for (int p = tid; p < kTwRows * size; p += kTwThreads) {
    const int r = p / size, i = p % size;
    float v = 0.0f;
    if (row0 + r < B) {
      const float* dy = dxy + static_cast<size_t>(row0 + r) * size;
      if (inner) {  // dx2 = dy Q^T
        for (int j = 0; j < size; ++j) v = fmaf(dy[j], Q[i * size + j], v);
      } else {
        v = dy[i];
      }
    }
    dx2s[p] = v;
  }
  __syncthreads();
  for (int p = tid; p < kTwRows * d_b; p += kTwThreads) {
    const int r = p / d_b, j = p % d_b;
    const float s = tanhf(outs[r * n_out + d_b + j]);
    const float es = expf(s);
    const float dzb = dx2s[r * size + d_a + j];
    const float ds = dzb * es * x1s[r * size + d_a + j] + dlds[r];
    const float dsp = ds * (1.0f - s * s);
    outs[r * n_out + j] = dzb;  // dt
    outs[r * n_out + d_b + j] = dsp;
    doutr[r * n_out + j] = kPasses == 1 ? rna(dzb) : dzb;
    doutr[r * n_out + d_b + j] = kPasses == 1 ? rna(dsp) : dsp;
    dx2s[r * size + d_a + j] = dzb * es;  // dx1's x_b part
  }
  __syncthreads();

  // the block's columns of h_nh in TF32 (the output layer has read them; in
  // 3xTF32 dWout takes them as they are)
  if constexpr (kPasses == 1) round_tile();
  __syncthreads();
  // ---- the cluster's partials: dWout = h_nh^T dout (the block's rows of it,
  // operands in TF32, or float32 in 3xTF32; a thread 4 outputs of a row),
  // dbout = sum dout (rank 0)
  {
    const int groups = (n_out + 3) / 4;
    for (int item = tid; item < NB * groups; item += kTwThreads) {
      const int i = c0 + item / groups, c = 4 * (item % groups);
      const bool four = c + 4 <= n_out;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
      for (int r = 0; r < kTwRows; ++r) {
        const float h = act[r * ldA + i];
        const float2 d0 = *reinterpret_cast<const float2*>(doutr + r * n_out + c);
        const float2 d1 = four ? *reinterpret_cast<const float2*>(doutr + r * n_out + c + 2) : make_float2(0.0f, 0.0f);
        s0 = fmaf(h, d0.x, s0);
        s1 = fmaf(h, d0.y, s1);
        s2 = fmaf(h, d1.x, s2);
        s3 = fmaf(h, d1.y, s3);
      }
      float* o = pk + pt.out + static_cast<size_t>(i) * n_out + c;
      *reinterpret_cast<float2*>(o) = make_float2(s0, s1);
      if (four) *reinterpret_cast<float2*>(o + 2) = make_float2(s2, s3);
    }
  }
  if (rank == 0 && tid < n_out) {
    float s = 0.0f;
    for (int r = 0; r < kTwRows; ++r) s += outs[r * n_out + tid];
    pk[pt.bout + tid] = s;
  }
  // ---- dh = dout Wout^T (FMA, the warpgroup's columns; Wout from the ring;
  // each sum in the order of the outputs) into the accumulator
  {
    const float* oa = outs + (16 * w4 + g) * n_out;
    const float* ob = oa + 8 * n_out;
    const float* wq = wos + (cw - c0 + 2 * q) * n_out;
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < n_out; ++c) {
      const float da = oa[c], db = ob[c];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float w0 = wq[(8 * j) * n_out + c], w1 = wq[(8 * j + 1) * n_out + c];
        acc[4 * j] = fmaf(da, w0, acc[4 * j]);
        acc[4 * j + 1] = fmaf(da, w1, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(db, w0, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(db, w1, acc[4 * j + 3]);
      }
    }
  }
  __syncthreads();  // the block's readers of its h_nh columns are done
  // the partner reads only its own columns since its last product
  backward_out(nh, true, daA + (nh - 1) * daA_plane, nullptr,
               [&](int e, int, int) { return make_float2(acc[e], acc[e + 1]); });
  __syncthreads();  // Wout's readers are done
  if (tid == 0) {  // the backward's first stages, now that Wout is read
    limit = T;
    for (int s = half; s < half + kTwRing - 1; ++s) issue(s);
  }
  limit = T;
  cluster_sync();

  // ---- hidden layers backward: dh = da_{l+1} Wm_l^T on wgmma; da_l = gelu'(a_l) dh
  for (int l = nh - 1; l >= 0; --l) {
    product();
    if (l > 0) cluster_sync(); else __syncthreads();
    backward_out(l, l > 0, l > 0 ? daA + (l - 1) * daA_plane : nullptr,
                 l > 0 ? nullptr : dhp + static_cast<size_t>(k) * B * Hp,
                 [&](int e, int, int) { return make_float2(acc[e], acc[e + 1]); });
    if (l > 0) cluster_sync();
  }
  // the ring is free: W1y's block columns for dx_a
  if (tid == 0) stage_w1y(ring);
  __syncthreads();
  mbar_wait(wbar, 0);

  // ---- dx_a = da_0 W1y^T (FMA): each block its columns' half (a thread one
  // row and the inputs i = set, set + 4, ..), exchanged
  {
    const int r = tid & (kTwRows - 1), set = tid / kTwRows;
    for (int i0 = set; i0 < d_a; i0 += 16) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = ring + (i0 + 4 * u < d_a ? i0 + 4 * u : i0) * NB;
#pragma unroll 2
      for (int c = 0; c < NB; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(act + r * ldA + c0 + c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(w[u] + c);
          s[u] = fmaf(v.x, x.x, s[u]);
          s[u] = fmaf(v.y, x.y, s[u]);
          s[u] = fmaf(v.z, x.z, s[u]);
          s[u] = fmaf(v.w, x.w, s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + 4 * u < d_a) {
          const int o = static_cast<int>(rank) * kTwRows * xw + r * xw + i0 + 4 * u;
          xch[o] = s[u];
          st_peer(xch_peer + 4u * static_cast<uint32_t>(o), s[u]);
        }
      }
    }
  }
  // db1 = sum da_0 (the block's columns; raw float32)
  for (int c = c0 + tid; c < c0 + NB; c += kTwThreads) {
    float s = 0.0f;
    for (int r = 0; r < kTwRows; ++r) s += act[r * ldA + c];
    pk[pt.b1 + c] = s;
  }
  cluster_sync();  // both halves of dx_a in both blocks; no block touches the other's memory after this

  // ---- dx1 = [dx2_a + dx_a | dz_b e^s]; the carried dx = dx1 s_k (rank 0
  // writes it); the ActNorm sums (rank 0)
  for (int p = tid; p < kTwRows * size; p += kTwThreads) {
    const int r = p / size, i = p % size;
    const float d = i < d_a ? dx2s[p] + (xch[r * xw + i] + xch[kTwRows * xw + r * xw + i]) : dx2s[p];
    dx2s[p] = d;
    if (rank == 0 && row0 + r < B) dxy[static_cast<size_t>(row0) * size + p] = inner ? d * sck[i] : d;
  }
  if constexpr (kPasses == 1) round_tile();  // da_0 in TF32 (dx_a and db1 have read it)
  __syncthreads();
  if (rank == 0 && tid <= 2 * size) {
    float s = 0.0f;
    if (tid < size) {  // sum dx1 x_k
      for (int r = 0; r < kTwRows; ++r) {
        const float x = row0 + r < B ? bound[(static_cast<size_t>(k) * B + row0 + r) * size + tid] : 0.0f;
        s = fmaf(dx2s[r * size + tid], x, s);
      }
    } else if (tid < 2 * size) {  // sum dx1
      for (int r = 0; r < kTwRows; ++r) s += dx2s[r * size + tid - size];
    } else {  // sum dld
      for (int r = 0; r < kTwRows; ++r) s += dlds[r];
    }
    pk[pt.an + tid] = s;
  }
  // dW1y = x1_a^T da_0 (operands in TF32, or float32 in 3xTF32; the block's
  // columns; a thread one column and 4 inputs)
  {
    const int groups = (d_a + 3) / 4;
    for (int item = tid; item < NB * groups; item += kTwThreads) {
      const int c = c0 + item % NB, i0 = 4 * (item / NB);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int r = 0; r < kTwRows; ++r) {
        const float h = act[r * ldA + c];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u < d_a) s[u] = fmaf(x1r[r * d_a + i0 + u], h, s[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < d_a) pk[pt.w1y + static_cast<size_t>(i0 + u) * Hp + c] = s[u];
    }
  }
}

// dWm_l^T = da_{l+1}^T h_l and dbm_l = sum da_{l+1} over the rows, for every
// layer of step k: block (l, mt, nt) takes dWm_l's columns mt*64 .. (A's
// features) and rows nt*8TN .. (B's).
template <int TN>
__global__ void __launch_bounds__(kGwThreads, 1)
dwm_wgmma(const float* __restrict__ daA, const float* __restrict__ hT, float* __restrict__ dwm,
          float* __restrict__ dbm, int rows, int k, int nh) {
  using W = TwShape<TN>;
  constexpr int Hp = W::Hp, NW = W::NW, R = W::R, MT = W::MT;
  // a stage: kGwRows / 32 row blocks of 32, each A (32 x 64) then B (32 x NW; then its lo in 3xTF32), as the
  // stage layouts hold them
  constexpr int a_floats = 32 * kGwTile, sub = a_floats + kTwParts * 32 * NW, subs = kGwRows / 32,
                stage = subs * sub;
  const int l = blockIdx.x / (MT * 4), mt = (blockIdx.x / 4) % MT, nt = blockIdx.x % 4;
  const int n_rs = rows / kGwRows;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(smem4) + kTwBarrierFloats;
  const int tid = threadIdx.x, w4 = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const float* a_src = daA + static_cast<size_t>(l) * rows * MT * kGwTile + mt * a_floats;
  const float* b_src = hT + static_cast<size_t>(l) * rows * Hp + nt * TN * 256;
  [[maybe_unused]] const float* b_lo = b_src + static_cast<size_t>(nh) * rows * Hp;  // h_l's lo (3xTF32)

  auto issue = [&](int s) {
    if (s >= n_rs) return;
    const int slot = s % kGwRing;
    float* dst = ring + slot * stage;
    mbar_arrive_expect_tx(&full[slot], stage * sizeof(float));
    for (int u = 0; u < subs; ++u) {
      const size_t rs = static_cast<size_t>(s) * subs + u;  // the 32-row block
      bulk_copy_g2s(dst + u * sub, a_src + rs * MT * a_floats, a_floats * sizeof(float), &full[slot]);
      bulk_copy_g2s(dst + u * sub + a_floats, b_src + rs * (Hp / 8) * 256, 32 * NW * sizeof(float), &full[slot]);
      if constexpr (kPasses == 3)
        bulk_copy_g2s(dst + u * sub + a_floats + 32 * NW, b_lo + rs * (Hp / 8) * 256, 32 * NW * sizeof(float),
                      &full[slot]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kGwRing; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int s = 0; s < kGwRing; ++s) issue(s);
  }
  __syncthreads();

  float sum[R], acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) sum[e] = 0.0f;
  float sa0 = 0.0f, sa1 = 0.0f;  // A's raw column sums: features m0 and m0 + 8
  const int m0 = 16 * w4 + g, sw = q << 3;
#pragma unroll 1
  for (int s = 0; s < n_rs; ++s) {
    const int slot = s % kGwRing;
    mbar_wait(&full[slot], static_cast<uint32_t>(s / kGwRing) & 1u);
    const float* st = ring + slot * stage;
    uint32_t a[kGwRows / 8][4];
    [[maybe_unused]] uint32_t alo[kPasses == 3 ? kGwRows / 8 : 1][4];  // A's lo (3xTF32)
    // 3xTF32: the stage's part of the column sums, added to them once a
    // stage (a sum of the rows in one long chain drifts past the float32
    // plain version's; blocked by stage it does not)
    [[maybe_unused]] float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kGwRows / 8; ++kk) {
      const float* r0 = st + (kk / 4) * sub + (8 * (kk % 4) + q) * kGwTile;
      const float* r1 = r0 + 4 * kGwTile;
      const float v0 = r0[m0 ^ sw], v1 = r0[(m0 + 8) ^ sw], v2 = r1[m0 ^ sw], v3 = r1[(m0 + 8) ^ sw];
      if constexpr (kPasses == 1) {
        sa0 += v0;
        sa0 += v2;
        sa1 += v1;
        sa1 += v3;
        a[kk][0] = tf32_rna(v0);
        a[kk][1] = tf32_rna(v1);
        a[kk][2] = tf32_rna(v2);
        a[kk][3] = tf32_rna(v3);
      } else {
        ps0 += v0;
        ps0 += v2;
        ps1 += v1;
        ps1 += v3;
        const float v[4] = {v0, v1, v2, v3};
        split_tf32(v, a[kk], alo[kk]);
      }
    }
    if constexpr (kPasses == 3) {
      sa0 += ps0;
      sa1 += ps1;
    }
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGwRows / 8; ++kk) {
      const float* b = st + (kk / 4) * sub + a_floats + 2 * (kk % 4) * 32;
      if constexpr (kPasses == 1)
        WgmmaTf32<NW>::mma(acc, a[kk], smem_desc(b, 128, 1024));
      else  // B's lo 32 NW floats on
        wgmma_3xtf32<NW>(acc, a[kk], alo[kk], smem_desc(b, 128, 1024), smem_desc(b + 32 * NW, 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int e = 0; e < R; ++e) sum[e] += acc[e];
    __syncthreads();  // the slot's readers are done
    if (tid == 0) issue(s + kGwRing);
  }

  float* out = dwm + (static_cast<size_t>(k) * nh + l) * Hp * Hp;
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mt * kGwTile + m0 + 8 * h, n = nt * NW + 8 * j + 2 * q + e;
        if (m < Hp) out[static_cast<size_t>(n) * Hp + m] = sum[4 * j + 2 * h + e];
      }
  sa0 += __shfl_xor_sync(0xffffffffu, sa0, 1);
  sa0 += __shfl_xor_sync(0xffffffffu, sa0, 2);
  sa1 += __shfl_xor_sync(0xffffffffu, sa1, 1);
  sa1 += __shfl_xor_sync(0xffffffffu, sa1, 2);
  if (nt == 0 && q == 0) {
    float* bias = dbm + (static_cast<size_t>(k) * nh + l) * Hp + mt * kGwTile;
    if (mt * kGwTile + m0 < Hp) bias[m0] = sa0;
    if (mt * kGwTile + m0 + 8 < Hp) bias[m0 + 8] = sa1;
  }
}

// The hidden weights as the rows kernel reads them (`prepare_train_weights`,
// whose plain version is `prepare_train_weights_reference`): thread (layer,
// input quad k, output n) rounds Wm[k..k+3][n] (the recompute's B(k, n), from
// Wm^T) and Wm[n][k..k+3] (the backward's) to TF32 and stores each as the 4
// inputs of a core matrix's row, at [direction][rank][k / 8][(n % Hp/2) / 8]
// [(k % 8) / 4][n % 8][k % 4]; in 3xTF32 at [direction][rank][k / 8][hi, lo]
// [(n % Hp/2) / 8][(k % 8) / 4][n % 8][k % 4], lo = w - hi beside hi. Bound by
// bytes: Wm read, both layouts written.
__global__ void prepare_kernel(const float* __restrict__ wm, float* __restrict__ out, int layers, int Hp) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int n = static_cast<int>(idx % Hp), kq = static_cast<int>((idx / Hp) % (Hp / 4));
  const long long layer = idx / (static_cast<long long>(Hp) * (Hp / 4));
  if (layer >= layers) return;
  const int k = 4 * kq, half = Hp / 2;
  const float* w = wm + layer * Hp * Hp;
  if constexpr (kPasses == 3) {
    const size_t group = (static_cast<size_t>(n / half) * (Hp / 8) + k / 8) * 2;  // [rank][k / 8][hi]
    const size_t off = (((group * (half / 8) + (n % half) / 8) * 2 + (k % 8) / 4) * 8 + n % 8) * 4;
    const size_t lo = static_cast<size_t>(half) * 8, dir = 2 * static_cast<size_t>(Hp) * Hp;
    float* o = out + layer * 2 * dir;
    const float4 a = make_float4(w[static_cast<size_t>(k) * Hp + n], w[static_cast<size_t>(k + 1) * Hp + n],
                                 w[static_cast<size_t>(k + 2) * Hp + n], w[static_cast<size_t>(k + 3) * Hp + n]);
    const float4 b = *reinterpret_cast<const float4*>(w + static_cast<size_t>(n) * Hp + k);
    const float4 ah = make_float4(rna(a.x), rna(a.y), rna(a.z), rna(a.w));
    const float4 bh = make_float4(rna(b.x), rna(b.y), rna(b.z), rna(b.w));
    *reinterpret_cast<float4*>(o + off) = ah;
    *reinterpret_cast<float4*>(o + off + lo) = make_float4(a.x - ah.x, a.y - ah.y, a.z - ah.z, a.w - ah.w);
    *reinterpret_cast<float4*>(o + dir + off) = bh;
    *reinterpret_cast<float4*>(o + dir + off + lo) = make_float4(b.x - bh.x, b.y - bh.y, b.z - bh.z, b.w - bh.w);
    return;
  }
  const size_t off =
      ((((static_cast<size_t>(n / half) * (Hp / 8) + k / 8) * (half / 8) + (n % half) / 8) * 2 + (k % 8) / 4) * 8 +
       n % 8) * 4;
  float* o = out + layer * 2 * Hp * Hp;
  *reinterpret_cast<float4*>(o + off) = make_float4(rna(w[static_cast<size_t>(k) * Hp + n]),
                                                    rna(w[static_cast<size_t>(k + 1) * Hp + n]),
                                                    rna(w[static_cast<size_t>(k + 2) * Hp + n]),
                                                    rna(w[static_cast<size_t>(k + 3) * Hp + n]));
  const float4 b = *reinterpret_cast<const float4*>(w + static_cast<size_t>(n) * Hp + k);
  *reinterpret_cast<float4*>(o + static_cast<size_t>(Hp) * Hp + off) =
      make_float4(rna(b.x), rna(b.y), rna(b.z), rna(b.w));
}

cudaLaunchConfig_t rows_config(int clusters, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kTwCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kTwCluster));
  cfg.blockDim = dim3(kTwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int TN>
cudaError_t launch_step(const float* bound, const float* h_proj, const float* dld, const float* an_s,
                        const float* an_b, const float* ortho, const float* w1y, const float* b1,
                        const float* wstages, const float* bm, const float* wout, const float* bout, float* dx,
                        float* dhp, float* dwm, float* dbm, TwScratch sc, int B, int S, int k, int size, int d_a,
                        int nh, int parts, cudaStream_t stream) {
  using W = TwShape<TN>;
  const int clusters = (B + kTwRows - 1) / kTwRows;
  cudaError_t err;
  if (parts & 1) {
    const size_t smem = tw_smem(W::Hp, size, d_a);
    if (!tw_takes(W::Hp, size, d_a)) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(bwd_rows_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = rows_config(clusters, smem, stream, attr);
    if ((err = cudaLaunchKernelEx(&cfg, bwd_rows_wgmma<TN>, bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wstages,
                                  bm, wout, bout, dx, dhp, sc, B, S, k, size, d_a, nh)) != cudaSuccess)
      return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    const size_t smem = gw_smem(W::Hp);
    if ((err = cudaFuncSetAttribute(dwm_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    dwm_wgmma<TN><<<nh * W::MT * 4, kGwThreads, smem, stream>>>(sc.daA, sc.hT, dwm, dbm, clusters * kTwRows, k, nh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// [rows kernel blocks, its clusters resident at once on the card, weight-grad
// blocks a step, weight-grad blocks resident on an SM]
template <int TN>
cudaError_t layout(int size, int d_a, int nh, int B, int* out) {
  using W = TwShape<TN>;
  const size_t smem = tw_smem(W::Hp, size, d_a);
  if (!tw_takes(W::Hp, size, d_a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int clusters = (B + kTwRows - 1) / kTwRows;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = rows_config(1, smem, nullptr, attr);
  if ((err = cudaOccupancyMaxActiveClusters(&out[1], bwd_rows_wgmma<TN>, &cfg)) != cudaSuccess) return err;
  out[0] = clusters * kTwCluster;
  out[2] = nh * W::MT * 4;
  const size_t gsmem = gw_smem(W::Hp);
  if ((err = cudaFuncSetAttribute(dwm_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(gsmem))) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], dwm_wgmma<TN>, kGwThreads, gsmem);
}

size_t scratch_floats(int B, int S, int size, int d_a, int nh, int Hp) {
  const size_t clusters = (B + kTwRows - 1) / kTwRows;
  const size_t rows = clusters * kTwRows;
  const size_t mp = static_cast<size_t>((Hp + kGwTile - 1) / kGwTile) * kGwTile;
  return (static_cast<size_t>(nh) + 1) * rows * Hp  // gelu'(a_l)
         + static_cast<size_t>(kTwParts) * nh * rows * Hp  // h_l, B layout (hi, and lo in 3xTF32)
         + static_cast<size_t>(nh) * rows * mp       // da_{l+1}, A layout
         + static_cast<size_t>(S) * clusters * Partial(Hp, size, d_a).floats;
}

}  // namespace

#define BCNF_TW_CASES(Hp, CASE) \
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

// Floats of scratch `bcnf_flow_train_bwd_wgmma` needs (the wrapper allocates it).
extern "C" long long bcnf_flow_train_wgmma_scratch(int B, int S, int size, int d_a, int nh, int Hp) {
  return static_cast<long long>(scratch_floats(B, S, size, d_a, nh, Hp));
}

// K2b on this route: arguments as flow_train_kernel.cu's `bcnf_flow_train_bwd`,
// with `wstages` (the hidden weights as `prepare_train_weights` lays them
// out: (S, nh, 2 [Wm^T, Wm], 2 ranks, Hp/8, Hp/16, 2, 8, 4) floats in TF32,
// in 3xTF32 (S, nh, 2, 2 ranks, Hp/8, 2 [hi, lo], Hp/16, 2, 8, 4); 16-byte
// aligned) in place of wm. Hp must be 32*TN for TN in 1, 2, 4, 8,
// 12, 16, 17; a shape `tw_takes` refuses (the rows kernel's shared memory,
// n_out > 48, d_a > 16) returns cudaErrorInvalidValue. `parts` (bits) runs the rows kernels (1, with the
// copy of dz that starts them), the weight-grad passes (2) and the final
// reduction (4: dWout, dbout, dW1y, db1, the ActNorm grads); the wrapper
// passes 7. Returns the first failing launch's cudaError_t.
extern "C" int bcnf_flow_train_bwd_wgmma(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wstages,
    const float* bm, const float* wout, const float* bout, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || Hp % 32 != 0 ||
      ((reinterpret_cast<size_t>(wstages) | reinterpret_cast<size_t>(scratch) | reinterpret_cast<size_t>(w1y) |
        reinterpret_cast<size_t>(wout) | reinterpret_cast<size_t>(dhp) | reinterpret_cast<size_t>(h_proj)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int clusters = (B + kTwRows - 1) / kTwRows;
  const size_t rows = static_cast<size_t>(clusters) * kTwRows;
  const size_t mp = static_cast<size_t>((Hp + kGwTile - 1) / kGwTile) * kGwTile;
  TwScratch sc;
  sc.gs = scratch;
  sc.hT = sc.gs + (nh + 1) * rows * Hp;
  sc.daA = sc.hT + static_cast<size_t>(kTwParts) * nh * rows * Hp;
  sc.part = sc.daA + nh * rows * mp;

  cudaError_t err;
  if ((parts & 1) &&
      (err = cudaMemcpyAsync(dx, dz, sizeof(float) * B * size, cudaMemcpyDeviceToDevice, st)) != cudaSuccess)
    return err;
  for (int k = S - 1; k >= 0; --k) {
    err = cudaErrorInvalidValue;
#define BCNF_CASE(TN)                                                                                              \
  case TN:                                                                                                         \
    err = launch_step<TN>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, dx, dhp, dwm, \
                          dbm, sc, B, S, k, size, d_a, nh, parts, st);                                            \
    break;
    BCNF_TW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
    if (err != cudaSuccess) return err;
  }
  if (parts & 4) {
    const long long n = static_cast<long long>(S) * (Partial(Hp, size, d_a).an + 2 * size);
    tw_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(sc.part, an_s, dwout, dw1y, dbout, db1, dan_s,
                                                                     dan_b, S, clusters, Hp, size, d_a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// `prepare_kernel` over `layers` (S nh) stacked Hp x Hp weights `wm` into
// `out` ((S, nh, 2, 2, Hp/8, Hp/16, 2, 8, 4) floats, in 3xTF32 (S, nh, 2, 2,
// Hp/8, 2, Hp/16, 2, 8, 4)); both 16-byte aligned.
extern "C" int bcnf_prepare_train_weights(const float* wm, float* out, int layers, int Hp, void* stream) {
  if (layers <= 0 || Hp <= 0 || Hp % 32 != 0 ||
      ((reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(out)) & 15) != 0)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(layers) * Hp * (Hp / 4);
  prepare_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(wm, out, layers,
                                                                                                      Hp);
  return cudaGetLastError();
}

// The route's layout at this shape (see `layout`), into out[0..3]; returns a
// cudaError_t.
extern "C" int bcnf_flow_train_wgmma_layout(int Hp, int size, int d_a, int nh, int B, int* out) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size || nh < 1 || B <= 0) return cudaErrorInvalidValue;
#define BCNF_CASE(TN) \
  case TN:            \
    return layout<TN>(size, d_a, nh, B, out);
  BCNF_TW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
