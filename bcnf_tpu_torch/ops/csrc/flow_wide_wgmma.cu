// K1 in 3xTF32 on Hopper's warpgroup tensor-core products (`wgmma`) at the
// wide padded hidden widths Hp 768 and 1024 (TN 24 and 32), both ways: the
// inverse (`flow_inverse_wide`), and the forward (`flow_forward_wide`: K1's
// forward, and with the step-input store the training forward K2a), where
// the 64-row float32 tile of flow_wgmma.cu no longer fits a block (263 KB
// at Hp 1024) and its fold no longer fits the registers. One body
// (`wide_flow`) serves both, templated on direction and on the store. Built
// twice (bcnf_tpu_torch/ops/_build.py): as it is (library `flow_wide_wgmma`,
// 3xTF32, the default mode) and with BCNF_TF32_PASSES=1 (library
// `flow_wide_wgmma_tf32`, one TF32 pass a product, the reduced mode: JAX's
// "default" `_dot`); every one-pass branch sits under `kPasses == 1`, so
// the 3xTF32 build is the code it was.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow (the Pallas TPU kernel
// `_flow_kernel`) both ways at those widths in the default mode; `fwd_call`
// of `_make_fused_flow_train` (`_flow_fwd_train_kernel`, which also stores
// each step's input rows: `bound_ref[0] = x`); and both directions of
// bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4), which the port
// runs as this kernel at one step. Host side and plain PyTorch versions:
// bcnf_tpu_torch/ops/flow_kernel.py (`fused_flow`, `fused_flow_train_fwd`,
// `flow_route`, `prepare_wide_weights`, `wide_grid`, `wide_fwd_rows`,
// `fused_flow_reference`, `fused_flow_train_reference`).
//
// What it computes, for every row r (conditioned on h_proj[k, r % N]; N = B
// for K2a), the coupling on x = [x_a | x_b] being a = gelu(x_a W1y + b1 +
// h_proj), a = gelu(a Wm_l + bm_l) for each hidden layer, [t | s'] = a Wout
// + bout, s = tanh(s'):
// - inverse: step S-1 (the final coupling alone), then for k = S-2 .. 0:
//   x <- x Q_k^T, x_b <- (x_b - t) exp(-s), ActNorm^-1;
// - forward: for k = 0 .. S-1: (K2a: bound[k] <- x), ActNorm on the inner
//   steps (the identity on the final one), x_b <- exp(s) x_b + t, then x <-
//   x Q_k on the inner steps; logdet = sum log|s_an| + sum s.
//
// What bounds it on an H100: the square hidden products, 2 nh Hp^2 FLOP a
// row and step, on the tensor cores at a third of the dense TF32 rate
// (3xTF32: three products a product), and the hidden weights' traffic from
// L2: every tile of rows reads each hidden weight once, in float32 (4 MB a
// layer at Hp 1024; 272 GB a call of 80,000 rows in 128-row tiles, 26 steps
// of 4 layers), which at L2's few TB/s takes about as long as the products.
// The inverse as built (PERF.md, tools/k1_wide_parts.py; an H100 at Hp 1024,
// 80,000 rows of 26 steps): 374 ms against a 101.6 ms bound, 27%, and not
// bound by the tensor cores. The products alone (stale stages, each block's
// own tile) take 272 ms, 217 with a third of their passes, 209 without the
// fold's adds; the stream and the split alone take 209 ms, of which the
// rings' barriers, the FMA layers and the hand-offs alone take 116; the
// whole call overlaps the two only in part. Reading the fragments from the
// owners' tiles adds ~47 ms; the FMA layers, the mixes and the hand-offs
// with no hidden layer take 48. Measured and not kept: a second fresh
// accumulator in flight, a fold every 2 k-steps, hi truncated, a 4-stage
// hi ring, clusters starting a layer at different stages.
// The forward runs on 16-300x fewer rows (4096 a training or validation
// call, 256 a validation batch of the run configs), where a tile's serial
// chain of k-steps, not the card's throughput, sets the time: 32 tiles of
// 128 rows fill the 15 clusters an H100 holds in 3 waves, 256 rows 2 or 4
// clusters. As built (PERF.md, tools/k1_wide_parts.py; an H100 at Hp 1024,
// the wide config's 32 steps of 4 layers): 4096 rows 23.3-24.5 ms against
// a 6.71 ms bound and the plain version's 29-30; a tile's products alone
// sit at the tensor cores' rate (~3.3 ms of ~8), the rest is the FMA
// layers, the hand-offs and the rings' barriers (~3.5 ms), the fragments'
// remote reads and the stream, which share the SM's shared-memory
// bandwidth with the products' B reads and do not hide behind them.
// Measured and not kept for it: the passes into the running sums unfolded
// (1.05-1.24x the row tiles' distance from float64: over the bar), a group
// of a stage's six products a commit (slower), one arrival a warp on the
// hand-offs, waiting for each owner's part of h_l just before its first
// read, a lo ring of 5 and a hi ring of 10 stages (each within 2%).
//
// Design.
// - A cluster of C = Hp / 128 blocks (6 at Hp 768, 8 at 1024) owns RW rows
//   for all S steps; block `rank` owns columns [128 rank, 128 rank + 128)
//   of every hidden layer. At RW = 128 (the inverse, and the forward's
//   larger tile) consumer warpgroup w owns rows [64 w, 64 w + 64): one
//   m64n128 product a k-step; at RW = 64 (the forward's smaller tile, up to
//   `WIDE_FWD_HALF_MAX_ROWS` rows: one wave) both own the 64 rows,
//   warpgroup w columns [64 w, 64 w + 64) of the block's: one m64n64
//   product a k-step. The inverse sends each k-step's three passes into a
//   fresh accumulator (scale-d 0), waited for and folded into the running
//   sums by float32 adds (the fold of flow_wgmma.cu, which keeps a
//   1024-long dot product's 128 truncating k-stages out of the sums' bits);
//   the forward sends kWwFwdFold k-steps' passes into one fresh sum, each
//   group waited for only after the next is issued (its A registers held
//   until then), and folds that: within the float32 plain version's
//   distance from float64 (the row tiles, summing in the tensor cores, are
//   5-8x it). A weight stage thus serves RW rows: each weight is read from
//   L2 once a tile.
// - A distributed tile: each block keeps only its own 128 columns of h_l
//   for the RW rows, the inverse's RW x 132 floats, the forward's
//   fragment-major (`ww_frag_index`). The A fragment of k-step s lies in
//   the tile of block s / 16; each consumer thread reads its four values
//   there through distributed shared memory (`ld.shared::cluster`; the
//   forward's in one 16-byte load, issued once the k-step before is in
//   flight: four 4-byte loads cost it ~1.8 ms of a tile's ~10, one ~0.2) a
//   k-step ahead, and
//   splits them into hi = tf32(a) and lo = a - hi in registers. Block r
//   takes the k-steps in turn from its own (16 r, 16 r + 1, .. mod Hp/8),
//   and its weight stages in the same order, so that at each k-step every
//   block's tile is read by one block: read all from one owner, the eight
//   blocks' fragments took three times the products' time.
// - Hand-offs between the blocks, per-source barriers: after a layer's
//   products each consumer thread arrives on free[rank] of every block (it
//   has read the tiles of h_l), and a block writes its part of h_{l+1} once
//   every free[c] of its own is complete; then each thread arrives on
//   landed[rank] of every block, and the next layer starts once every
//   landed[c] is. Arrivals are released, and waited for with acquire, at
//   cluster scope; a thread arrives on its own block last, so that a
//   block's arrivals for one hand-off precede its next ones on every
//   barrier and no phase takes another hand-off's arrivals. The landed
//   hand-offs, some of which follow each other with no other between, take
//   two sets of barriers in turn: a block can then complete a barrier's next
//   phase only after every block has passed the hand-off before, so no
//   waiter finds a barrier two phases on (which its parity would not tell
//   from the phase it waits for). The forward's 64-row tiles keep two
//   tiles in turn and need no `free` hand-off (7.08 -> 6.32 ms at 256 rows;
//   at 128 rows a second tile does not fit).
// - Each weight read once a tile from L2, in float32: the hidden weights are
//   laid out once a call (`prepare_wide_weights`: float32, transposed to
//   K-major core-matrix order, kWwStageK k-steps of a block's 128 columns
//   contiguous, 8 KB; both directions read the same layout), and one
//   producer thread bulk-copies (`cp.async.bulk`) each such stage into a
//   ring of kWwHiStages slots, up to kWwHiStages ahead across layers and
//   steps. Three producer warps split each stage: the inverse's in place,
//   hi = tf32_rna(w) over the copy; the forward's hi is the copy, which the
//   tensor cores read truncated (a third less shared-memory traffic); lo =
//   w - hi into a ring of kWwLoStages slots, fenced for the async proxy that
//   `wgmma` reads through; the consumers take the stage once its lo is
//   written, and release both slots after its last k-step's products are
//   done.
// - The rings' barriers keep CTA scope (cluster-scope ones cost ~28 ms on
//   flow_wgmma.cu's one-pass ring): the producers and consumers of a block
//   meet only each other.
// - The input layer splits by columns: each block computes its own 128
//   columns of h_0 (each sum in input_layer's order) into its own tile. The
//   output layer's 2 d_b columns take inputs from all Hp units, so it splits
//   by inputs: each block sums over its 128 units (a thread one column of 4
//   rows) and sends each row's partial sums to the row's reducer, block r %
//   C; after a hand-off the reducer adds the C partials in the order of the
//   ranks, then the bias, and stores [t | s'] of its rows into every block;
//   after another, the coupling update, the logdet, the ActNorm and the
//   mixes, which run in every block on the same data, keep their states
//   equal to the bit. Rank 0 stores y (and the logdet, and K2a's step
//   inputs). Rows past B run on zeros and are not stored.
// - The forward's narrow weights come from shared memory: a second thread of
//   the producer's first warp bulk-copies each step's W1y, b1 and Wout of
//   the block's columns
//   (`ww_narrow_floats`) once the consumers are done with the last step's;
//   the consumers stage the step's Q and ActNorm (`small`) and each layer's
//   bias, and read the rows' conditions all at once before the input
//   layer's sums (read from global memory in place, they cost ~0.6 ms of
//   a tile's ~10).
// One pass (kPasses == 1) keeps the clusters, the distributed tile (in both
// directions fragment-major, the forward's), the hand-offs, the tiles' rows,
// the stream of one bulk copy a stage and the step-input store, and drops
// what only 3xTF32 needs:
// - the hidden weights are rounded to TF32 once a call on the host
//   (`prepare_wide_weights(wm, passes=1)`: the same layout, each entry
//   tf32_rna'd), so a copied stage is the B operand as it lands: no lo ring,
//   no splitting warps; the consumers wait on the stage's bulk copy alone,
//   and the 24 KB of the lo ring go to a deeper hi ring (kWwHiStagesTf32);
// - each activation that feeds a hidden product (h_0 .. h_{nh-1}) is rounded
//   to TF32 once, where it is written into the tile (`tile_value`), so a
//   consumer hands the fragment it reads to the tensor cores as it is; h_nh,
//   which the output layer reads, stays float32, as do the narrow products;
// - one `wgmma` a k-step, straight into the running sums (no fresh
//   accumulator, no fold), one group in flight behind the next; the
//   fragments' remote reads are what the one-pass walk waits on (without
//   the exchange, each block reading its own tile, the wide config's
//   inverse took half the time), so each is read kWwASets - 1 k-steps
//   ahead, straight into the A register set that the group before has just
//   released (read into other registers and copied two ahead, the outputs
//   differed from run to run at some shapes; copied one ahead, ptxas
//   serialized the products).
// What it computes is `tf32.matmul_tf32` on the hidden products: both
// operands rounded once, the products summed in the tensor cores' float32.
// What bounds it: the hidden products at the dense TF32 rate, 43.7 ms at the
// wide config's 80,000 rows (32 steps of 4 layers at Hp 1024). As built
// (PERF.md, tools/k1_wide_parts.py --passes 1): ~237 ms; its products
// alone ~197, the stream alone ~193, neither (the FMA layers, the mixes,
// the hand-offs and the rings' barriers) ~139, each block reading its own
// tile in place of the owners' ~222.
// At RW = 128: 66 KB of tile, 64 KB of hi ring, 24 KB of lo ring, the rows'
// state (19 KB at size 19) and the output layer's buffers (18 KB) come to
// ~192 KB of the 227 KB; the forward adds ~17 KB of step weights, logdet
// and bias and drops the tile's padding, which sets its widest size 7 below
// the inverse's (23 against 30 at d_a 10; the row tiles take the wider).

#include "flow_rows.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kWwRows = 128;                   // rows of a cluster: two wgmma M, one a consumer warpgroup
constexpr int kWwHalfRows = 64;                // the forward's smaller tile: one wgmma M, the warpgroups split the columns
constexpr int kWwCols = 128;                   // the hidden columns a block owns
constexpr int kWwConsumers = 256;              // two warpgroups
constexpr int kWwThreads = kWwConsumers + 128;  // and the producer warpgroup
// The rings (ops/flow_kernel.py: `kernel_smem` and `prepare_wide_weights`
// read these): a stage is kWwStageK k-steps (8 input rows each) of the
// block's columns; the hi ring holds kWwHiStages bulk-copied stages, the lo
// ring kWwLoStages stages of lo
constexpr int kWwStageK = 2;
constexpr int kWwHiStages = 8;
constexpr int kWwLoStages = 3;
// One pass: the hi ring alone, in the room of both 3xTF32 rings
constexpr int kWwHiStagesTf32 = 11;
constexpr int kWwHi = kPasses == 3 ? kWwHiStages : kWwHiStagesTf32;  // this build's rings
constexpr int kWwLo = kPasses == 3 ? kWwLoStages : 0;
constexpr int kWwLoSlot = kWwLo > 0 ? kWwLo : 1;  // the lo ring's slots in its index arithmetic (3xTF32 code only)
// One pass: a consumer's A register sets, k-step s's fragment in set s %
// kWwASets, read kWwASets - 1 k-steps ahead into the set that the group
// before has just released; the products walk kWwASets / kWwStageK stages
// an iteration, so that the sets are indexed at compile time (the wide
// config's inverse at 80,000 rows: 279, 249 and 237 ms with 2, 4 and 8 sets)
constexpr int kWwASets = 8;
static_assert(kWwASets % kWwStageK == 0 && kWwASets >= 2, "whole stages a pass over the sets");
constexpr int kWwLd = kWwCols + 4;  // the tile's row stride (conflict-free fragment loads)
constexpr int kWwKStep = 8 * kWwCols;  // floats of a k-step of a block's columns
constexpr int kWwStage = kWwStageK * kWwKStep;  // floats of a stage
// The parts a launch runs: all, or some left out to time the rest
// (tools/k1_wide_parts.py): the products, the stages' copies, the
// fragments' reads from the owners' tiles (without it each block reads its
// own), the producers' split
constexpr int kWwProducts = 1, kWwCopies = 2, kWwExchange = 4, kWwSplit = 8;
// The forward's k-steps a fold: each kWwFwdFold k-steps' passes go into a
// fresh sum in the tensor cores, added into the running float32 sums once
// done (0: the passes go into the running sums, unfolded). It divides Hp/8.
constexpr int kWwFwdFold = 16;
static_assert(kWwFwdFold == 0 || (96 % kWwFwdFold == 0 && 128 % kWwFwdFold == 0), "a fold divides a layer's k-steps");
// Registers a thread: a block of 12 warps starts with 168 (65,536 / 384); the
// producer warpgroup, which splits the stages, keeps 56, and the consumers
// take 224 each from what it gives up: 128 x 56 + 256 x 224 = 384 x 168. In
// one pass the producers split nothing and keep 24, the consumers 240 (at
// 224 and at 232 the one-pass K2b's 128-row rows kernel at Hp 768 spilled
// 4 bytes): 128 x 24 + 256 x 240 <= 65,536
constexpr int kProducerRegs = kPasses == 3 ? 56 : 24;
constexpr int kConsumerRegs = kPasses == 3 ? 224 : 240;

// Rows a block reduces in the output layer: rows r with r % C == rank.
__host__ __device__ constexpr int ww_reduce_rows(int C, int rows = kWwRows) { return (rows + C - 1) / C; }

// The forward's step weights of a block in shared memory (one bulk copy a
// row): W1y's d_a rows and b1 of its kWwCols columns, and Wout's kWwCols rows.
__host__ __device__ constexpr int ww_narrow_floats(int d_a, int n_out) { return (d_a + 1 + n_out) * kWwCols; }
// ... and the step's Q, ActNorm scale and bias, to an even count.
__host__ __device__ constexpr int ww_small_floats(int size) { return (size * size + 2 * size + 1) & ~1; }

// The kernel's dynamic shared memory (ops/flow_kernel.py: `wide_smem`
// mirrors this sum): the tile (fragment-major and unpadded but for the
// 3xTF32 inverse's), the hi and lo rings, x and the mix's output,
// the partial [t | s'] of the block's reduced rows from each of the C
// blocks and [t | s'] of every row, two barriers a ring stage and three
// hand-off barriers a block of the cluster (free, and two sets of landed);
// the forward adds its step weights, its logdet, the step's Q and ActNorm,
// a layer's bias, the step weights' two barriers and at 64 rows a second
// tile.
size_t ww_smem(int Hp, int size, int d_a, int rows = kWwRows, bool forward = false) {
  const int C = Hp / kWwCols, n_out = 2 * (size - d_a);
  const size_t fwd = forward ? ww_narrow_floats(d_a, n_out) + rows + ww_small_floats(size) + kWwCols +
                                    (rows == kWwHalfRows ? static_cast<size_t>(rows) * kWwCols : 0)
                              : 0;
  return sizeof(float) * (static_cast<size_t>(rows) * (forward || kPasses == 1 ? kWwCols : kWwLd) +
                          static_cast<size_t>(kWwHi + kWwLo) * kWwStage +
                          static_cast<size_t>(rows) * 2 * size +
                          (static_cast<size_t>(C) * ww_reduce_rows(C, rows) + rows) * n_out + fwd) +
         sizeof(uint64_t) * (2 * (kWwHi + kWwLo) + 3 * static_cast<size_t>(C) + (forward ? 2 : 0));
}

bool ww_takes(int Hp, int size, int d_a, int rows = kWwRows, bool forward = false) {
  return ww_smem(Hp, size, d_a, rows, forward) <= kSmemLimit;
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kWwConsumers) : "memory"); }

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Keeps an A fragment's registers from reuse up to here: `wgmma` reads them
// after its instruction has issued, which the compiler does not see.
__device__ __forceinline__ void hold_fragment(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// float32 to TF32 by truncation (the low 13 bits cleared): what the tensor
// cores read of a float32 operand.
__device__ __forceinline__ float trunc_tf32(float x) { return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u); }

// An activation as it is written into a tile: in one pass, where it is a
// hidden product's A operand (`operand`), rounded to TF32 (tf32_rna) once
// there, so that the consumers hand it to the tensor cores as they read it;
// else as it is.
__device__ __forceinline__ float tile_value(float v, bool operand) {
  if constexpr (kPasses == 1) {
    return operand ? rna(v) : v;
  } else {
    return v;
  }
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (`wgmma`'s operand reads).
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The forward's tile is fragment-major: element (row, col) of a block's RW x
// kWwCols at ww_frag_index, each k-step's m64 x k8 fragment of a warp's 16
// rows 32 lanes x 4 values in register order, so that a thread reads its
// four with one 16-byte load (`ld_cluster4`) and a warp 512 contiguous bytes.
__device__ __forceinline__ int ww_frag_index(int row, int col) {
  return (((row >> 4) * (kWwCols / 8) + (col >> 3)) * 32 + (row & 7) * 4 + (col & 3)) * 4 + ((row >> 3) & 1) +
         2 * ((col >> 2) & 1);
}

__device__ __forceinline__ void ld_cluster4(uint32_t addr, float (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

// A thread's four values of its m64 x k8 fragment (rows g (+8) of its warp's
// 16, columns q (+4) of the k-step's 8) at shared::cluster address `at` of
// the first, in a tile of row stride kWwLd (the inverse's).
__device__ __forceinline__ void load_frag(uint32_t at, float (&v)[4]) {
  v[0] = ld_cluster(at);
  v[1] = ld_cluster(at + 4u * 8 * kWwLd);
  v[2] = ld_cluster(at + 4u * 4);
  v[3] = ld_cluster(at + 4u * (8 * kWwLd + 4));
}

// The walk of one cluster over its RW rows, either way (kInverse), the
// forward with K2a's step-input store (kBound; bound (S, B, size), N = B)
// and its logdet (ld_out); the kernels below run it.
template <int TN, int RW, bool kInverse, bool kBound>
__device__ __forceinline__ void wide_flow(const float* __restrict__ x, const float* __restrict__ h_proj,
                                          const float* __restrict__ an_s, const float* __restrict__ an_b,
                                          const float* __restrict__ ortho, const float* __restrict__ w1y,
                                          const float* __restrict__ b1, const float* __restrict__ wstages,
                                          const float* __restrict__ bm, const float* __restrict__ wout,
                                          const float* __restrict__ bout, float* __restrict__ y,
                                          float* __restrict__ ld_out, float* __restrict__ bound, int B, int N,
                                          int S, int size, int d_a, int nh, int parts) {
  static_assert(RW == kWwRows || (RW == kWwHalfRows && !kInverse), "the inverse walks 128-row tiles");
  static_assert(!(kBound && kInverse), "the step inputs are stored by the training forward only");
  static_assert(kWwStageK % 2 == 0, "the forward's two A register sets alternate within a stage");
  constexpr int Hp = 32 * TN, C = Hp / kWwCols, KS = Hp / 8;  // blocks a cluster, k-steps a layer
  constexpr int NJ = KS / kWwStageK;                            // stages a layer
  constexpr int KB = kWwCols / 8;                               // k-steps a block's columns hold
  constexpr int RR = ww_reduce_rows(C, RW);                     // rows a block reduces
  constexpr bool kSplitCols = RW == kWwHalfRows;                // the warpgroups split the block's columns
  constexpr int NW = kSplitCols ? kWwCols / 2 : kWwCols;        // a warpgroup's columns: one m64nNW product
  constexpr int R = NW / 2;                                     // its accumulators a thread
  constexpr int RPT = RW * 4 / kWwConsumers;                    // rows a thread of the input layer
  // Each k-step's three passes into a fresh sum folded into the running sums
  // (the inverse), or every kWwFwdFold k-steps' (the forward)
  constexpr bool kFold = kInverse;
  // The tile fragment-major (one 16-byte remote read a k-step): the
  // forward's, and in one pass the inverse's too (four 4-byte remote reads a
  // k-step of a row-major tile took half the one-pass inverse's time); the
  // 3xTF32 inverse keeps its row-major tile of row stride kWwLd
  constexpr bool kFragTile = !kInverse || kPasses == 1;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const int nw_floats = kInverse ? 0 : ww_narrow_floats(d_a, n_out);   // the forward's step weights
  const int small_floats = kInverse ? 0 : ww_small_floats(size);       // and its Q, ActNorm scale and bias

  extern __shared__ float4 smem4[];
  constexpr int kTileLd = kFragTile ? kWwCols : kWwLd;  // a fragment-major tile is unpadded
  // The forward's 64-row tiles keep two tiles in turn, h_l in tile l % 2: a
  // block writes h_{l+1} into the other, which every block was done reading
  // (h_{l-1}) before the landed hand-off of h_l, so no `free` hand-off
  constexpr bool kTwoTiles = !kInverse && RW == kWwHalfRows;
  float* tile = reinterpret_cast<float*>(smem4);  // RW x kTileLd: the block's columns of h_l
  float* hi_ring = tile + (kTwoTiles ? 2 : 1) * RW * kTileLd;  // kWwHi stages, bulk-copied (3xTF32: then rounded to hi)
  float* lo_ring = hi_ring + kWwHi * kWwStage;     // kWwLo stages of lo (3xTF32)
  float* nw = lo_ring + kWwLo * kWwStage;          // the forward: the step's W1y (d_a x 128), b1, Wout (128 x n_out)
  float* xs = nw + nw_floats;                      // RW x size: the rows' state
  float* xt = xs + RW * size;                      // RW x size: the mix's output
  float* gather = xt + RW * size;                  // C x RR x n_out: the partials of the rows this block reduces
  float* outs = gather + C * RR * n_out;           // RW x n_out: [t | s'] of every row
  float* lds = outs + RW * n_out;                  // RW: the forward's logdet
  float* small = lds + (kInverse ? 0 : RW);        // the forward: the step's Q (size x size), ActNorm scale, bias
  float* bms = small + small_floats;               // the forward: the layer's bm of the block's columns
  uint64_t* hi_full = reinterpret_cast<uint64_t*>(bms + (kInverse ? 0 : kWwCols));
  uint64_t* hi_empty = hi_full + kWwHi;
  uint64_t* lo_full = hi_empty + kWwHi;  // the stage is split: hi and lo ready (3xTF32)
  uint64_t* lo_empty = lo_full + kWwLo;
  uint64_t* free_ = lo_empty + kWwLo;  // free[c]: block c is done reading the tiles of h_l
  uint64_t* landed = free_ + C;  // landed[set C + c]: block c's part of a hand-off is written (2 sets in turn)
  uint64_t* nw_full = landed + 2 * C;  // the forward: the step's weights in nw
  uint64_t* nw_empty = nw_full + 1;    // ... and every consumer warp is done with the last step's

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * RW;
  const int c0 = static_cast<int>(rank) * kWwCols;  // the block's columns
  for (int p = tid; p < RW * size; p += kWwThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (!kInverse && tid < RW) lds[tid] = 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWwHi; ++i) {
      mbar_init(&hi_full[i], 1);
      mbar_init(&hi_empty[i], kWwConsumers / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < kWwLo; ++i) {
      mbar_init(&lo_full[i], 3);                   // one arrival a splitting warp
      mbar_init(&lo_empty[i], kWwConsumers / 32);  // one arrival a consumer warp
    }
    for (int c = 0; c < C; ++c) {
      mbar_init(&free_[c], kWwConsumers);  // every consumer thread of block c
      mbar_init(&landed[c], kWwConsumers);
      mbar_init(&landed[C + c], kWwConsumers);
    }
    if (!kInverse) {
      mbar_init(nw_full, 1);
      mbar_init(nw_empty, kWwConsumers / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are initialised before any block reaches them

  const int total = S * nh * NJ;  // stages of the whole call
  if (tid >= kWwConsumers) {
    // ---- the producer warpgroup: warp 0's first thread issues the stages,
    // warps 1-3 split them (3xTF32), in the consumers' order across layers and steps;
    // in the forward warp 0's second thread copies each step's W1y, b1 and
    // Wout of the block's columns once the consumers are done with the last
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kWwConsumers;
    [[maybe_unused]] const int lane = tid & 31;  // the splitting warps' (3xTF32)
    if (p == 0) {
      constexpr uint32_t bytes = kWwStage * sizeof(float);
      for (int m = 0; m < total; ++m) {
        const int slot = m % kWwHi;
        mbar_wait(&hi_empty[slot], ((m / kWwHi) & 1) ^ 1);
        if (parts & kWwCopies) {
          // stage m % NJ of layer (step, l), rank's part: at ((layer NJ + j) C + rank) stages
          const int j = (m % NJ + static_cast<int>(rank) * (KB / kWwStageK)) % NJ;  // in the block's turn
          const int layer = m / NJ, l = layer % nh, k = kInverse ? S - 1 - layer / nh : layer / nh;
          const float* src = wstages + ((((static_cast<size_t>(k) * nh + l) * NJ + j) * C + rank) * kWwStage);
          mbar_arrive_expect_tx(&hi_full[slot], bytes);
          bulk_copy_g2s(hi_ring + slot * kWwStage, src, bytes, &hi_full[slot]);
        } else {
          mbar_arrive(&hi_full[slot]);  // timing the rest: the stage as it is
        }
      }
    } else if (!kInverse && p == 1) {
      constexpr uint32_t row = kWwCols * sizeof(float);
      for (int k = 0; k < S; ++k) {
        if (k > 0) mbar_wait(nw_empty, (k - 1) & 1);
        mbar_arrive_expect_tx(nw_full, static_cast<uint32_t>(nw_floats) * sizeof(float));
        for (int i = 0; i < d_a; ++i)
          bulk_copy_g2s(nw + i * kWwCols, w1y + (static_cast<size_t>(k) * d_a + i) * Hp + c0, row, nw_full);
        bulk_copy_g2s(nw + d_a * kWwCols, b1 + static_cast<size_t>(k) * Hp + c0, row, nw_full);
        bulk_copy_g2s(nw + (d_a + 1) * kWwCols, wout + (static_cast<size_t>(k) * Hp + c0) * n_out, n_out * row,
                      nw_full);
      }
    } else if constexpr (kPasses == 3) {
      if (p >= 32) {
        const int t = p - 32;  // 96 splitting threads
        for (int m = 0; m < total; ++m) {
          const int hs = m % kWwHi, ls = m % kWwLoSlot;
          mbar_wait(&hi_full[hs], (m / kWwHi) & 1);
          mbar_wait(&lo_empty[ls], ((m / kWwLoSlot) & 1) ^ 1);
          if (parts & kWwSplit) {
            float4* h4 = reinterpret_cast<float4*>(hi_ring + hs * kWwStage);
            float4* l4 = reinterpret_cast<float4*>(lo_ring + ls * kWwStage);
#pragma unroll 2
            for (int i = t; i < kWwStage / 4; i += 96) {
              const float4 w = h4[i];
              if (kInverse) {
                const float4 h = make_float4(rna(w.x), rna(w.y), rna(w.z), rna(w.w));
                h4[i] = h;
                l4[i] = make_float4(w.x - h.x, w.y - h.y, w.z - h.z, w.w - h.w);
              } else {  // the forward's hi is the stage as copied, which the tensor cores truncate
                const float4 h = make_float4(trunc_tf32(w.x), trunc_tf32(w.y), trunc_tf32(w.z), trunc_tf32(w.w));
                l4[i] = make_float4(w.x - h.x, w.y - h.y, w.z - h.z, w.w - h.w);
              }
            }
            fence_async_shared();
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&lo_full[ls]);
        }
      }
    }
    cluster_sync();  // no block leaves while another may reach its memory
    return;
  }

  // ---- the consumers: 256 threads, two warpgroups: at RW = 128 warpgroup wg
  // rows 64 wg .., at RW = 64 the 64 rows and columns NW wg .. of the block's
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr0 = kSplitCols ? 0 : 64 * wg, wc0 = kSplitCols ? NW * wg : 0;  // the warpgroup's rows, columns
  const bool exchange = parts & kWwExchange;
  // this thread's first fragment value's offset in a tile, in bytes, and a
  // k-step's bytes there
  const uint32_t frag_off = !kFragTile ? 4u * static_cast<uint32_t>((wr0 + 16 * w4 + g) * kWwLd + q)
                                       : 16u * static_cast<uint32_t>(((wr0 / 16 + w4) * KB) * 32 + lane);
  constexpr uint32_t kStepBytes = !kFragTile ? 32u : 512u;
  // the address of this thread's A fragment of the layer's s-th k-step in the
  // block's turn, k-step (s + KB rank) % KS, in its owner's tile (without the
  // exchange: in this block's), shared::cluster
  const int turn = KB * static_cast<int>(rank);
  auto layer_tile = [&](int l) { return kTwoTiles && (l & 1) ? tile + RW * kTileLd : tile; };  // h_l's tile
  float* cur = tile;  // the tile the layer's products read
  auto frag_at = [&](int s) {
    const int ks = (s + turn) % KS;
    return map_peer(cur, exchange ? static_cast<uint32_t>(ks / KB) : rank) + frag_off + kStepBytes * (ks % KB);
  };
  int m = 0;                  // the rings' stage
  uint32_t fph = 0, lnum = 0;  // free's parity; the landed hand-offs so far

  // This thread's part of a hand-off is done: arrive on bar[rank] of every
  // block (its own last), then wait until every block's part is.
  auto hand_off = [&](uint64_t* bar, uint32_t ph) {
#pragma unroll
    for (int i = 1; i <= C; ++i) mbar_arrive_release_cluster(&bar[rank], (rank + i) % C);
#pragma unroll
    for (int c = 0; c < C; ++c) mbar_wait_acquire_cluster(&bar[(rank + C - c) % C], ph);
  };
  auto hand_off_free = [&]() {
    hand_off(free_, fph);
    fph ^= 1;
  };
  auto hand_off_landed = [&]() {  // the two sets in turn
    hand_off(landed + (lnum & 1) * C, (lnum >> 1) & 1);
    ++lnum;
  };

  for (int it = 0; it < S; ++it) {
    const int k = kInverse ? S - 1 - it : it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;
    const float* Q = ortho + static_cast<size_t>(k) * size * size;

    if (kInverse) {
      if (inner) {  // ---- x <- x Q_k^T (FMA)
        for (int p = tid; p < RW * size; p += kWwConsumers) {
          const int r = p / size, j = p % size;
          float acc = 0.0f;
          for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
          xt[p] = acc;
        }
        float* t = xs;
        xs = xt;
        xt = t;
      }
    } else {
      // ---- the step's Q, ActNorm scale and bias into `small`; then the step's
      // input rows to bound[k] (K2a; rank 0), the ActNorm and its logdet
      for (int p = tid; p < size * size + 2 * size; p += kWwConsumers)
        small[p] = p < size * size ? Q[p] : p < size * (size + 1) ? sc[p - size * size] : bi[p - size * (size + 1)];
      consumer_sync();
      const float* sct = small + size * size;
      const float* bit = sct + size;
      for (int p = tid; p < RW * size; p += kWwConsumers) {
        if (kBound && rank == 0 && row0 + p / size < B) bound[(static_cast<size_t>(k) * B + row0) * size + p] = xs[p];
        if (inner) xs[p] = xs[p] * sct[p % size] + bit[p % size];
      }
      if (inner && tid < RW) {
        float l = 0.0f;
        for (int i = 0; i < size; ++i) l += logf(fabsf(sct[i]));
        lds[tid] += l;
      }
    }
    consumer_sync();  // the step's x written; the previous output layer is done reading the tile

    // ---- h_0 = gelu(x_a W1y + b1 + h_proj[k, row % N]) (FMA): the block's
    // columns into its tile, 64 row groups x 4 column lanes, RPT rows a
    // thread, W1y's column pair loaded once for them, each sum in
    // input_layer's order; the forward reads W1y and b1 from `nw` and its
    // rows' conditions first, all at once
    if (kInverse) {
      const float* w1 = w1y + static_cast<size_t>(k) * d_a * Hp;
      const float* b1k = b1 + static_cast<size_t>(k) * Hp;
      const int rg = tid >> 2, cl = tid & 3;
      const float* hp[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = row0 + rg + 64 * r;
        hp[r] = row < B ? h_proj + (static_cast<size_t>(k) * N + row % N) * Hp : nullptr;
      }
#pragma unroll 2
      for (int j = 0; j < kWwCols / 8; ++j) {
        const int lc = 2 * (cl + 4 * j), col = c0 + lc;
        const float2 bias = *reinterpret_cast<const float2*>(b1k + col);
        float2 a[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float2 h = hp[r] != nullptr ? *reinterpret_cast<const float2*>(hp[r] + col) : make_float2(0.0f, 0.0f);
          a[r] = make_float2(bias.x + h.x, bias.y + h.y);
        }
#pragma unroll 4
        for (int i = 0; i < d_a; ++i) {
          const float2 w = *reinterpret_cast<const float2*>(w1 + i * Hp + col);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float xi = xs[(rg + 64 * r) * size + i];
            a[r].x = fmaf(xi, w.x, a[r].x);
            a[r].y = fmaf(xi, w.y, a[r].y);
          }
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if constexpr (kFragTile) {
            tile[ww_frag_index(rg + 64 * r, lc)] = tile_value(gelu_tanh(a[r].x), nh > 0);
            tile[ww_frag_index(rg + 64 * r, lc + 1)] = tile_value(gelu_tanh(a[r].y), nh > 0);
          } else {
            *reinterpret_cast<float2*>(tile + (rg + 64 * r) * kWwLd + lc) =
                make_float2(tile_value(gelu_tanh(a[r].x), nh > 0), tile_value(gelu_tanh(a[r].y), nh > 0));
          }
        }
      }
    } else {
      const int rg = tid >> 2, cl = tid & 3;
      float2 hv[kWwCols / 8][RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = row0 + rg + 64 * r;
        const float* hp = h_proj + (static_cast<size_t>(k) * N + row % N) * Hp + c0;
#pragma unroll
        for (int j = 0; j < kWwCols / 8; ++j)
          hv[j][r] = row < B ? *reinterpret_cast<const float2*>(hp + 2 * (cl + 4 * j)) : make_float2(0.0f, 0.0f);
      }
      mbar_wait(nw_full, it & 1);  // the step's W1y, b1 and Wout
      const float* b1k = nw + d_a * kWwCols;
#pragma unroll
      for (int j = 0; j < kWwCols / 8; ++j) {
        const int lc = 2 * (cl + 4 * j);
        const float2 bias = *reinterpret_cast<const float2*>(b1k + lc);
        float2 a[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) a[r] = make_float2(bias.x + hv[j][r].x, bias.y + hv[j][r].y);
#pragma unroll 4
        for (int i = 0; i < d_a; ++i) {
          const float2 w = *reinterpret_cast<const float2*>(nw + i * kWwCols + lc);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float xi = xs[(rg + 64 * r) * size + i];
            a[r].x = fmaf(xi, w.x, a[r].x);
            a[r].y = fmaf(xi, w.y, a[r].y);
          }
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          tile[ww_frag_index(rg + 64 * r, lc)] = tile_value(gelu_tanh(a[r].x), nh > 0);
          tile[ww_frag_index(rg + 64 * r, lc + 1)] = tile_value(gelu_tanh(a[r].y), nh > 0);
        }
      }
    }
    hand_off_landed();

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma (3xTF32, or one pass)
    for (int l = 0; l < nh; ++l) {
      cur = layer_tile(l);
      float acc[R];
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = 0.0f;
      if (!kInverse && tid < kWwCols / 4)  // the forward: the layer's bias of the block's columns, for the epilogue
        reinterpret_cast<float4*>(bms)[tid] =
            reinterpret_cast<const float4*>(bm + (static_cast<size_t>(k) * nh + l) * Hp + c0)[tid];
      if (!(parts & kWwProducts)) {  // timing the rest: the stages as they come
        for (int j = 0; j < NJ; ++j, ++m) {
          if constexpr (kPasses == 1) {
            mbar_wait(&hi_full[m % kWwHi], (m / kWwHi) & 1);
            if (lane == 0) mbar_arrive(&hi_empty[m % kWwHi]);
          } else {
            mbar_wait(&lo_full[m % kWwLoSlot], (m / kWwLoSlot) & 1);
            if (lane == 0) {
              mbar_arrive(&hi_empty[m % kWwHi]);
              mbar_arrive(&lo_empty[m % kWwLoSlot]);
            }
          }
        }
      } else if constexpr (kPasses == 1) {  // one wgmma a k-step into the running sums, a group in flight
        // k-step s's fragment, as the tile holds it (TF32 already), in set s %
        // kWwASets
        uint32_t a[kWwASets][4];
        auto load = [&](int s, uint32_t(&v)[4]) {  // the tile fragment-major in one pass
          float f[4];
          ld_cluster4(frag_at(s), f);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = __float_as_uint(f[i]);
        };
#pragma unroll
        for (int s = 0; s < kWwASets - 1; ++s) load(s, a[s]);
        static_assert(NJ % (kWwASets / kWwStageK) == 0, "a layer's stages fill whole passes over the sets");
#pragma unroll 1
        for (int j0 = 0; j0 < NJ; j0 += kWwASets / kWwStageK) {
#pragma unroll
          for (int jj = 0; jj < kWwASets / kWwStageK; ++jj, ++m) {
            const int j = j0 + jj, hs = m % kWwHi;
            mbar_wait(&hi_full[hs], (m / kWwHi) & 1);
#pragma unroll
            for (int u = 0; u < kWwStageK; ++u) {
              const int s = kWwStageK * j + u, b = kWwStageK * jj + u;  // b = s % kWwASets
              wgmma_fence();
              WgmmaTf32<NW>::mma(acc, a[b], smem_desc(hi_ring + hs * kWwStage + u * kWwKStep + 8 * wc0, 128, 256));
              wgmma_commit();
              wgmma_wait<1>();  // k-step s - 1's group is done: its A registers and, at a stage's first, its stage
              hold_fragment(a[(b + kWwASets - 1) % kWwASets]);
              if (s + kWwASets - 1 < KS) load(s + kWwASets - 1, a[(b + kWwASets - 1) % kWwASets]);  // read ahead
              if (u == 0 && j > 0 && lane == 0) mbar_arrive(&hi_empty[(m - 1) % kWwHi]);
            }
          }
        }
        wgmma_wait<0>();
        hold_fragment(a[(KS - 1) % kWwASets]);
        if (lane == 0) mbar_arrive(&hi_empty[(m - 1) % kWwHi]);  // the layer's last stage
        fence_operands(acc);
      } else if (kFold) {  // each k-step's passes into a fresh sum, folded into the running sums
        float part[R], nxt[4];
        load_frag(frag_at(0), nxt);
#pragma unroll 1
        for (int j = 0; j < NJ; ++j, ++m) {
          const int hs = m % kWwHi, ls = m % kWwLoSlot;
          mbar_wait(&lo_full[ls], (m / kWwLoSlot) & 1);
#pragma unroll
          for (int u = 0; u < kWwStageK; ++u) {
            const int s = kWwStageK * j + u;
            uint32_t ahi[4], alo[4];
            const float cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
            if (s + 1 < KS) load_frag(frag_at(s + 1), nxt);
            split_tf32(cur, ahi, alo);
            const uint64_t bh = smem_desc(hi_ring + hs * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
            const uint64_t bl = smem_desc(lo_ring + ls * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
            wgmma_fence();
            WgmmaTf32<NW>::mma(part, alo, bh, 0);
            WgmmaTf32<NW>::mma(part, ahi, bl);
            WgmmaTf32<NW>::mma(part, ahi, bh);
            wgmma_commit();
            wgmma_wait<0>();
            hold_fragment(ahi);
            hold_fragment(alo);
            if (u == kWwStageK - 1 && lane == 0) {
              mbar_arrive(&hi_empty[hs]);
              mbar_arrive(&lo_empty[ls]);
            }
            fence_operands(part);
#pragma unroll
            for (int e = 0; e < R; ++e) acc[e] += part[e];
          }
        }
      } else {  // one group in flight behind the next, folded every kWwFwdFold k-steps (or never)
        float part[R], nxt[4];
        float(&sum)[R] = kWwFwdFold > 0 ? part : acc;  // the tensor cores' sum: a fold's, or the running one
        uint32_t a[2][2][4] = {};  // [k-step parity][hi, lo]: the group in flight reads the other set
        uint32_t keep = kWwFwdFold > 0 ? 0u : 1u;  // the next group's scale-d: 0 starts a fold afresh
        ld_cluster4(frag_at(0), nxt);
#pragma unroll 1
        for (int j = 0; j < NJ; ++j, ++m) {
          const int hs = m % kWwHi, ls = m % kWwLoSlot;
          mbar_wait(&lo_full[ls], (m / kWwLoSlot) & 1);
#pragma unroll
          for (int u = 0; u < kWwStageK; ++u) {
            const int s = kWwStageK * j + u, b = u & 1;
            const float cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
            split_tf32(cur, a[b][0], a[b][1]);
            const uint64_t bh = smem_desc(hi_ring + hs * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
            const uint64_t bl = smem_desc(lo_ring + ls * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
            wgmma_fence();
            WgmmaTf32<NW>::mma(sum, a[b][1], bh, keep);
            WgmmaTf32<NW>::mma(sum, a[b][0], bl);
            WgmmaTf32<NW>::mma(sum, a[b][0], bh);
            wgmma_commit();
            if (s + 1 < KS) ld_cluster4(frag_at(s + 1), nxt);  // read while the group runs
            wgmma_wait<1>();  // k-step s - 1's group is done: its A registers and, at a stage's first, its stage
            hold_fragment(a[b ^ 1][0]);
            hold_fragment(a[b ^ 1][1]);
            keep = 1u;
            if (u == 0 && j > 0 && lane == 0) {
              mbar_arrive(&hi_empty[(m - 1) % kWwHi]);
              mbar_arrive(&lo_empty[(m - 1) % kWwLoSlot]);
            }
            if (kWwFwdFold > 0 && (s + 1) % (kWwFwdFold > 0 ? kWwFwdFold : 1) == 0) {  // the fold
              wgmma_wait<0>();
              hold_fragment(a[b][0]);
              hold_fragment(a[b][1]);
              fence_operands(part);
#pragma unroll
              for (int e = 0; e < R; ++e) acc[e] += part[e];
              keep = 0u;
            }
          }
        }
        wgmma_wait<0>();
        hold_fragment(a[(KS - 1) & 1][0]);
        hold_fragment(a[(KS - 1) & 1][1]);
        if (lane == 0) {  // the layer's last stage
          mbar_arrive(&hi_empty[(m - 1) % kWwHi]);
          mbar_arrive(&lo_empty[(m - 1) % kWwLoSlot]);
        }
        fence_operands(acc);
      }
      if (!kTwoTiles) hand_off_free();  // every block is done reading the tiles of h_l
      const float* bias = kInverse ? bm + (static_cast<size_t>(k) * nh + l) * Hp + c0 : bms;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr0 + 16 * w4 + g + 8 * h, col = wc0 + 8 * j + 2 * q;
          if (!kFragTile) {
            *reinterpret_cast<float2*>(tile + row * kWwLd + col) =
                make_float2(tile_value(gelu_tanh(acc[4 * j + 2 * h] + bias[col]), l + 1 < nh),
                            tile_value(gelu_tanh(acc[4 * j + 2 * h + 1] + bias[col + 1]), l + 1 < nh));
          } else {
            float* next = layer_tile(l + 1);
            next[ww_frag_index(row, col)] = tile_value(gelu_tanh(acc[4 * j + 2 * h] + bias[col]), l + 1 < nh);
            next[ww_frag_index(row, col + 1)] = tile_value(gelu_tanh(acc[4 * j + 2 * h + 1] + bias[col + 1]), l + 1 < nh);
          }
        }
      hand_off_landed();
    }

    // ---- output layer: the block's partial [t | s'] over its 128 units (FMA;
    // Wout from L1/L2, the forward's from `nw`), a thread one column of 4
    // rows, the sum in the order of the units; each row's partial into slot
    // `rank` of its reducer's gather buffer (row r: block r % C, its row r /
    // C)
    {
      const float* wo = kInverse ? wout + (static_cast<size_t>(k) * Hp + c0) * n_out : nw + (d_a + 1) * kWwCols;
      for (int item = tid; item < (RW / 4) * n_out; item += kWwConsumers) {
        const int c = item % n_out, r0 = (item / n_out) * 4;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int kk = 0; kk < kWwCols; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* tv = layer_tile(nh) + ww_frag_index(r0 + r, kk);  // fragment-major: 4 columns 4 floats apart
            const float4 v = !kFragTile ? *reinterpret_cast<const float4*>(tile + (r0 + r) * kWwLd + kk)
                                        : make_float4(tv[0], tv[4], tv[8], tv[12]);
            acc[r] = fmaf(v.x, w0, acc[r]);
            acc[r] = fmaf(v.y, w1, acc[r]);
            acc[r] = fmaf(v.z, w2, acc[r]);
            acc[r] = fmaf(v.w, w3, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + r;
          st_peer(map_peer(gather + (rank * RR + row / C) * n_out + c, static_cast<uint32_t>(row % C)), acc[r]);
        }
      }
      if (!kInverse) {  // this warp is done with the step's weights in `nw`
        __syncwarp();
        if (lane == 0) mbar_arrive(nw_empty);
      }
    }
    hand_off_landed();

    // ---- [t | s'] of this block's rows: the C partials summed in rank
    // order, then the bias, stored into every block
    {
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      for (int item = tid; item < RR * n_out; item += kWwConsumers) {
        const int i = item / n_out, c = item % n_out, row = static_cast<int>(rank) + C * i;
        if (row < RW) {
          float v = gather[i * n_out + c];
#pragma unroll
          for (int cb = 1; cb < C; ++cb) v += gather[(cb * RR + i) * n_out + c];
          v += bo[c];
#pragma unroll
          for (int cb = 0; cb < C; ++cb) st_peer(map_peer(outs + row * n_out + c, static_cast<uint32_t>(cb)), v);
        }
      }
    }
    hand_off_landed();

    // ---- the coupling update of x_b (one thread a row, the same in every
    // block): (x_b - t) exp(-s), or exp(s) x_b + t and the logdet's sum s
    if (tid < RW) {
      const float* o = outs + tid * n_out;
      float* xr = xs + tid * size;
      if (kInverse) {
        for (int j = 0; j < d_b; ++j) xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-tanhf(o[d_b + j]));
      } else {
        float l = 0.0f;
        for (int j = 0; j < d_b; ++j) {
          const float s = tanhf(o[d_b + j]);
          xr[d_a + j] = expf(s) * xr[d_a + j] + o[j];
          l += s;
        }
        lds[tid] += l;
      }
    }
    consumer_sync();

    if (inner) {
      if (kInverse) {  // ---- ActNorm^-1
        for (int p = tid; p < RW * size; p += kWwConsumers) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      } else {  // ---- x <- x Q_k (FMA), Q from `small`
        for (int p = tid; p < RW * size; p += kWwConsumers) {
          const int r = p / size, j = p % size;
          float acc = 0.0f;
          for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], small[i * size + j], acc);
          xt[p] = acc;
        }
        float* t = xs;
        xs = xt;
        xt = t;
      }
      consumer_sync();
    }
  }

  if (rank == 0) {
    for (int p = tid; p < RW * size; p += kWwConsumers)
      if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
    if (!kInverse && tid < RW && row0 + tid < B) ld_out[row0 + tid] = lds[tid];
  }
  cluster_sync();  // the producers' counterpart
}

template <int TN>
__global__ void __launch_bounds__(kWwThreads, 1)
flow_inverse_wide(const float* __restrict__ x, const float* __restrict__ h_proj,
                  const float* __restrict__ an_s, const float* __restrict__ an_b,
                  const float* __restrict__ ortho, const float* __restrict__ w1y,
                  const float* __restrict__ b1, const float* __restrict__ wstages,
                  const float* __restrict__ bm, const float* __restrict__ wout,
                  const float* __restrict__ bout, float* __restrict__ y, int B, int N, int S, int size,
                  int d_a, int nh, int parts) {
  wide_flow<TN, kWwRows, true, false>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, nullptr,
                                      nullptr, B, N, S, size, d_a, nh, parts);
}

template <int TN, int RW, bool kBound>
__global__ void __launch_bounds__(kWwThreads, 1)
flow_forward_wide(const float* __restrict__ x, const float* __restrict__ h_proj,
                  const float* __restrict__ an_s, const float* __restrict__ an_b,
                  const float* __restrict__ ortho, const float* __restrict__ w1y,
                  const float* __restrict__ b1, const float* __restrict__ wstages,
                  const float* __restrict__ bm, const float* __restrict__ wout,
                  const float* __restrict__ bout, float* __restrict__ y, float* __restrict__ ld,
                  float* __restrict__ bound, int B, int N, int S, int size, int d_a, int nh, int parts) {
  wide_flow<TN, RW, false, kBound>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, ld, bound, B,
                                   N, S, size, d_a, nh, parts);
}

template <int TN>
cudaLaunchConfig_t ww_config(cudaLaunchAttribute* attr, size_t smem, int clusters, cudaStream_t stream) {
  constexpr int C = 32 * TN / kWwCols;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * C));
  cfg.blockDim = dim3(kWwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `kernel`, a cluster a tile of `rows` rows (ops/flow_kernel.py:
// `wide_grid` mirrors this), with `smem` bytes of shared memory; a refused
// launch returns its error (nothing stands in for it).
template <int TN, typename Kernel, typename... Args>
cudaError_t ww_launch(Kernel kernel, size_t smem, int B, int rows, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ww_config<TN>(attr, smem, (B + rows - 1) / rows, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                   const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                   const float* bout, float* y, int B, int N, int S, int size, int d_a, int nh, int parts,
                   cudaStream_t stream) {
  constexpr int Hp = 32 * TN;
  if (!ww_takes(Hp, size, d_a)) return cudaErrorInvalidValue;
  return ww_launch<TN>(flow_inverse_wide<TN>, ww_smem(Hp, size, d_a), B, kWwRows, stream, x, h_proj, an_s, an_b,
                       ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S, size, d_a, nh, parts);
}

template <int TN, int RW>
cudaError_t launch_fwd(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                       const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                       const float* bout, float* y, float* ld, float* bound, int B, int N, int S, int size, int d_a,
                       int nh, int parts, cudaStream_t stream) {
  constexpr int Hp = 32 * TN;
  if (!ww_takes(Hp, size, d_a, RW, true)) return cudaErrorInvalidValue;
  const size_t smem = ww_smem(Hp, size, d_a, RW, true);
  if (bound != nullptr)
    return ww_launch<TN>(flow_forward_wide<TN, RW, true>, smem, B, RW, stream, x, h_proj, an_s, an_b, ortho, w1y, b1,
                         wstages, bm, wout, bout, y, ld, bound, B, N, S, size, d_a, nh, parts);
  return ww_launch<TN>(flow_forward_wide<TN, RW, false>, smem, B, RW, stream, x, h_proj, an_s, an_b, ortho, w1y, b1,
                       wstages, bm, wout, bout, y, ld, bound, B, N, S, size, d_a, nh, parts);
}

// Clusters of `kernel` resident on the whole card at once with `smem` bytes
// of shared memory a block (as the occupancy calculator gives it), or minus
// a cudaError_t.
template <int TN, typename Kernel>
int resident_clusters(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ww_config<TN>(attr, smem, 1, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// [bytes of shared memory a block, clusters resident at once] of the inverse
// (forward false) or the forward on tiles of `rows` rows at this shape.
template <int TN>
cudaError_t layout(int size, int d_a, int rows, bool forward, int* out) {
  constexpr int Hp = 32 * TN;
  if ((!forward && rows != kWwRows) || !ww_takes(Hp, size, d_a, rows, forward)) return cudaErrorInvalidValue;
  const size_t smem = ww_smem(Hp, size, d_a, rows, forward);
  out[0] = static_cast<int>(smem);
  out[1] = !forward              ? resident_clusters<TN>(flow_inverse_wide<TN>, smem)
           : rows == kWwRows     ? resident_clusters<TN>(flow_forward_wide<TN, kWwRows, false>, smem)
                                 : resident_clusters<TN>(flow_forward_wide<TN, kWwHalfRows, false>, smem);
  return out[1] > 0 ? cudaSuccess : out[1] < 0 ? static_cast<cudaError_t>(-out[1]) : cudaErrorInvalidConfiguration;
}

}  // namespace

// flow_wide_train_wgmma.cu takes the device parts above with
// BCNF_WW_DEVICE_ONLY defined, and leaves out this library's entry points.
#ifndef BCNF_WW_DEVICE_ONLY

#define BCNF_WW_CASES(Hp, CASE) \
  switch ((Hp) / 32) {          \
    CASE(24)                    \
    CASE(32)                    \
    default:                    \
      break;                    \
  }

// C entry points, loaded with ctypes.

// K1's inverse at Hp 768 or 1024 in 3xTF32: y (B, size) from x (B, size);
// `wstages` the hidden weights as `prepare_wide_weights` lays them out, (S,
// nh, Hp/8/kWwStageK, Hp/kWwCols, kWwStageK, kWwCols/8, 2, 8, 4) floats,
// 16-byte aligned. A shape past the shared memory returns
// cudaErrorInvalidValue. `parts` is kWwProducts | kWwCopies | kWwExchange |
// kWwSplit for the inverse; fewer times the rest (y not the inverse).
extern "C" int bcnf_flow_inverse_wide(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                      const float* ortho, const float* w1y, const float* b1, const float* wstages,
                                      const float* bm, const float* wout, const float* bout, float* y, int B, int N,
                                      int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 ||
      (nh > 0 && (reinterpret_cast<size_t>(wstages) & 15) != 0) ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(b1)) & 7) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                               \
  case TN:                                                                                                          \
    return launch<TN>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S, size, d_a, nh, \
                      parts, st);
  BCNF_WW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

// K1's forward (bound null: z = y and logdet = ld) or K2a (bound non-null:
// every step's input rows too, (S, B, size); call it with N = B, h_proj (S,
// B, Hp)) at Hp 768 or 1024 in 3xTF32, on tiles of `rows` rows (kWwRows or
// kWwHalfRows), the weights laid out as for the inverse; w1y, b1, bm and
// wout 16-byte aligned (bulk copies and float4 reads). A shape past the
// shared memory returns cudaErrorInvalidValue; `parts` as the inverse's.
extern "C" int bcnf_flow_forward_wide(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                      const float* ortho, const float* w1y, const float* b1, const float* wstages,
                                      const float* bm, const float* wout, const float* bout, float* y, float* ld,
                                      float* bound, int B, int N, int S, int size, int d_a, int nh, int Hp, int rows,
                                      int parts, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 || ld == nullptr ||
      (rows != kWwRows && rows != kWwHalfRows) || (nh > 0 && (reinterpret_cast<size_t>(wstages) & 15) != 0) ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(b1) | reinterpret_cast<size_t>(wout) |
        reinterpret_cast<size_t>(bm)) & 15) != 0 || (reinterpret_cast<size_t>(h_proj) & 7) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                                 \
  case TN:                                                                                                            \
    return rows == kWwRows ? launch_fwd<TN, kWwRows>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, \
                                                     y, ld, bound, B, N, S, size, d_a, nh, parts, st)                 \
                           : launch_fwd<TN, kWwHalfRows>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout,   \
                                                         bout, y, ld, bound, B, N, S, size, d_a, nh, parts, st);
  BCNF_WW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

// The inverse's (forward 0) or the forward's (forward 1, on tiles of `rows`
// rows) bytes of dynamic shared memory a block and clusters resident on the
// card at once at this shape, into out[0..1]; returns a cudaError_t
// (cudaErrorInvalidValue where the shape is refused).
extern "C" int bcnf_flow_wide_layout(int Hp, int size, int d_a, int rows, int forward, int* out) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size || (rows != kWwRows && rows != kWwHalfRows))
    return cudaErrorInvalidValue;
#define BCNF_CASE(TN) \
  case TN:            \
    return layout<TN>(size, d_a, rows, forward != 0, out);
  BCNF_WW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // BCNF_WW_DEVICE_ONLY
