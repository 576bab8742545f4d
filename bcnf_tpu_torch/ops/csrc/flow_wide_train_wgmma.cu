// K2b in 3xTF32 on Hopper's warpgroup tensor-core products (`wgmma`) at the
// wide padded hidden widths Hp 768 and 1024 (TN 24 and 32): the training
// backward of the whole flow, on the clusters and the distributed tile of
// the wide forward (flow_wide_wgmma.cu, whose device parts it includes).
// The narrower widths run flow_train_wgmma.cu; the one-pass and strict modes
// keep their routes.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `bwd_call` of
// `_make_fused_flow_train` (the Pallas TPU kernel `_flow_bwd_train_kernel`)
// at those widths in the default mode. Host side and plain PyTorch version
// (`fused_flow_train_bwd`, `train_bwd_route`, `prepare_wide_train_weights`,
// `fused_flow_train_backward_reference` with `mm=ops/tf32.py::matmul_3xtf32`):
// bcnf_tpu_torch/ops/flow_kernel.py. What it computes is
// flow_train_kernel.cu's header: for k = S-1 .. 0 the step's MLP recomputed
// from the step inputs K2a stored, its backward, and every weight grad
// summed over the B rows.
//
// What bounds it on an H100: the square products, three equal thirds (the
// recompute h_l Wm_l, the backward da_{l+1} Wm_l^T, the weight grads
// h_l^T da_{l+1}), 3 x 2 nh Hp^2 FLOP a row and step, at a third of the dense
// TF32 rate (3xTF32): 20.1 ms at the wide config's 32 steps of 4 layers at
// Hp 1024 and 4096 rows. The recompute and the backward stream each hidden
// weight once a tile of rows from L2 in float32 (the wide forward's stream),
// the weight grads read the tiles' scratch.
//
// Design, per step (two launches a step and one a call; `parts` runs each
// kind alone; the rows kernels on a high-priority stream of their own, each
// step's weight-grad pass on the caller's stream beside the next step's rows
// kernel, on two sets of scratch planes in turn):
// 1. `wide_train_rows` (BWD_ROWS): the wide forward's cluster of C = Hp/128
//    blocks on a tile of RW rows (128, or 64 up to WIDE_FWD_HALF_MAX_ROWS
//    rows, `wide_fwd_rows`), block `rank` owning 128 columns of every hidden
//    layer in a fragment-major tile that the other blocks read through
//    distributed shared memory (its k-steps rotated to start at its own);
//    the producer warpgroup streams the step's 2 nh hidden weights in
//    float32 through the hi ring (the recompute's Wm^T, then the backward's
//    Wm, both laid out by `prepare_wide_weights`, once a step for K2a and
//    K2b: `prepare_wide_train_weights`) and splits each stage's lo; every
//    kWwFwdFold k-steps' three passes go into a fresh sum folded into float32
//    running sums. The recompute: h_0 (FMA), then h_{l+1} = gelu(h_l Wm_l +
//    bm_l) on `wgmma`, each layer's gelu'(a_l) to a row-major scratch plane
//    and h_l (l < nh) to the weight-grad pass's B layout, with its lo = h -
//    tf32(h) in a plane of its own (the tensor cores read h truncated), rows
//    past B as zeros; the output layer split by inputs with a reducer a row
//    (the wide forward's). The backward: the coupling's per row (every block
//    alike), dh = dout Wout^T of the block's columns (FMA, Wout in shared
//    memory), then da_{l+1} Wm_l^T on `wgmma` on the same kind of tile, each
//    da_{l+1} (l < nh) to the weight-grad pass's A layout (rows past B as
//    zeros), da_0 to dh_proj[k]; dx_a = da_0 W1y^T split by inputs with a
//    reducer a row, as the output layer. Hand-offs between the blocks as the
//    wide forward's (`free` after each product on one tile, two landed sets
//    in turn; two tiles in turn at 64 rows). dWout, dW1y and the bias and
//    ActNorm column sums are float32 FMA over the tile's rows into a partial
//    per step and cluster: no atomics.
// 2. `wide_dwm` (BWD_WEIGHT_GRADS): dWm_l^T = da_{l+1}^T h_l over the rows, a
//    block a 128 x 128 tile of one layer (nh x Hp/128 x Hp/128 blocks a
//    step), two consumer warpgroups, each one m64n128 product a k-step on
//    the stage of B they share: A = da_{l+1} split into hi and lo in
//    registers as loaded, B = h_l and its lo, 32-row stages bulk-copied into
//    a 2-stage ring, each stage's three passes into a fresh accumulator added
//    to float32 running sums; dbm_l the float32 column sums of A.
// 3. `tw_reduce` (BWD_ACTNORM, once after the last step): the partials
//    summed over the clusters in cluster order into dWout, dbout, dW1y, db1
//    and the ActNorm grads (zero at the final step).
// Deterministic: every sum has one order; a run gives the same bits.

#define BCNF_WW_DEVICE_ONLY
#include "flow_wide_wgmma.cu"
#include "train_partials.cuh"

#include <initializer_list>
#include <mutex>

namespace {

using namespace bcnf;

constexpr int kWtGwRows = 32;      // rows (k) a stage of the weight-grad pass
constexpr int kWtGwRing = 2;       // its stages
constexpr int kWtGwGroups = 2;     // its consumer warpgroups, each 64 of the block's dWm columns on one B stage
constexpr int kWtGwThreads = 128 * kWtGwGroups;
constexpr int kWtGwM = 64;         // dWm columns (A's features: da's) a warpgroup: one wgmma M
constexpr int kWtGwN = 128;        // dWm rows (B's features: h's) a block: one m64n128 product
constexpr int kWtBarrierFloats = 16;
// `parts` bits: the rows kernels, the weight-grad passes, the reduction
constexpr int kWtRows = 1, kWtGrads = 2, kWtReduce = 4;
constexpr int kWtMaxDevices = 64;

// x, which the compiler may not compute before this point (nor hoist out of
// a loop).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

struct WtScratch {
  float* gs;    // gelu'(a_l), l <= nh: row-major planes of rows_c x Hp
  float* h;     // h_l, l < nh, in the B layout (plane l), its lo = h - tf32(h) nh planes on
  float* da;    // da_{l+1}, l < nh, in the A layout (plane l)
  float* part;  // a Partial per step and cluster
};

// Floats of the rows kernel's shared memory before its barriers: the tile
// (two at 64 rows), the hi and lo rings, the step's W1y, b1 and Wout of the
// block's columns, then per row x1, dx2 (then dx1), [t | s'] (then dout),
// dx_a and dld, and the C blocks' partials of the rows a block reduces
// (n_out or d_a floats a row), to an even count.
__host__ __device__ inline size_t wt_floats(int Hp, int size, int d_a, int rows) {
  const int C = Hp / kWwCols, n_out = 2 * (size - d_a), xw = n_out > d_a ? n_out : d_a;
  const size_t floats = static_cast<size_t>(rows == kWwHalfRows ? 2 : 1) * rows * kWwCols +
                        static_cast<size_t>(kWwHiStages + kWwLoStages) * kWwStage + ww_narrow_floats(d_a, n_out) +
                        static_cast<size_t>(rows) * (2 * size + n_out + d_a + 1) +
                        static_cast<size_t>(C) * ww_reduce_rows(C, rows) * xw;
  return (floats + 1) & ~static_cast<size_t>(1);
}

// The rows kernel's dynamic shared memory (ops/flow_kernel.py:
// `wide_train_smem` mirrors this sum): wt_floats, then two barriers a ring
// stage, three hand-off barriers a block of the cluster (free, and two sets
// of landed) and one for the step's narrow weights.
size_t wt_smem(int Hp, int size, int d_a, int rows) {
  return sizeof(float) * wt_floats(Hp, size, d_a, rows) +
         sizeof(uint64_t) * (2 * (kWwHiStages + kWwLoStages) + 3 * static_cast<size_t>(Hp / kWwCols) + 1);
}

// The weight-grad pass's: barriers and kWtGwRing stages of 32-row blocks of
// A (32 x 64 a warpgroup), B (32 x 128) and B's lo.
size_t wt_gw_smem() {
  return sizeof(float) *
         (kWtBarrierFloats + static_cast<size_t>(kWtGwRing) * kWtGwRows * (kWtGwGroups * kWtGwM + 2 * kWtGwN));
}
static_assert(kWtGwRows % 32 == 0, "a weight-grad stage is whole 32-row blocks of the stage layouts");

template <int TN, int RW>
__global__ void __launch_bounds__(kWwThreads, 1)
wide_train_rows(const float* __restrict__ bound, const float* __restrict__ h_proj, const float* __restrict__ dld,
                const float* __restrict__ an_s, const float* __restrict__ an_b, const float* __restrict__ ortho,
                const float* __restrict__ w1y, const float* __restrict__ b1, const float* __restrict__ wf,
                const float* __restrict__ wb, const float* __restrict__ bm, const float* __restrict__ wout,
                const float* __restrict__ bout, float* __restrict__ dxy, float* __restrict__ dhp, WtScratch sc,
                int B, int S, int k, int size, int d_a, int nh) {
  static_assert(RW == kWwRows || RW == kWwHalfRows, "a tile of 128 or 64 rows");
  static_assert(kWwStageK % 2 == 0, "the two A register sets alternate within a stage");
  constexpr int Hp = 32 * TN, C = Hp / kWwCols, KS = Hp / 8;  // blocks a cluster, k-steps a layer
  constexpr int NJ = KS / kWwStageK;                            // stages a layer
  constexpr int KB = kWwCols / 8;                               // k-steps a block's columns hold
  constexpr int RR = ww_reduce_rows(C, RW);                     // rows a block reduces
  constexpr bool kSplitCols = RW == kWwHalfRows;                // the warpgroups split the block's columns
  constexpr bool kTwoTiles = kSplitCols;                        // two tiles in turn, no `free` hand-off
  constexpr int NW = kSplitCols ? kWwCols / 2 : kWwCols;        // a warpgroup's columns: one m64nNW product
  constexpr int R = NW / 2;                                     // its accumulators a thread
  constexpr int RPT = RW * 4 / kWwConsumers;                    // rows a thread of the input layer
  static_assert(KS % kWwFwdFold == 0 && kWwFwdFold > 0, "a fold divides a layer's k-steps");
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const bool inner = k < S - 1;  // step S-1 is the final coupling alone
  // a scratch plane's floats, computed where it is used (as are the step's
  // partial and the ActNorm scale below), not kept through the products
  auto plane = [&]() { return static_cast<size_t>(opaque(static_cast<int>(gridDim.x) / C)) * RW * Hp; };
  auto partial = [&](const Partial& pt) {
    return sc.part + (static_cast<size_t>(opaque(k)) * (gridDim.x / C) + blockIdx.x / C) * pt.floats;
  };

  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);          // RW x 128 (two at 64 rows), fragment-major
  float* hi_ring = tile + (kTwoTiles ? 2 : 1) * RW * kWwCols;
  float* lo_ring = hi_ring + kWwHiStages * kWwStage;
  float* nw = lo_ring + kWwLoStages * kWwStage;             // W1y (d_a x 128), b1, Wout (128 x n_out)
  float* x1s = nw + ww_narrow_floats(d_a, n_out);           // RW x size: x1 = x_k s_k + b_k
  float* dx2s = x1s + RW * size;                            // RW x size: dy Q^T, then dx1
  float* outs = dx2s + RW * size;                           // RW x n_out: [t | s'], then dout
  float* dxas = outs + RW * n_out;                          // RW x d_a: dx_a = da_0 W1y^T
  float* dlds = dxas + RW * d_a;                            // RW
  float* gather = dlds + RW;                                // C x RR x n_out (or d_a): the reduced rows' partials
  uint64_t* hi_full = reinterpret_cast<uint64_t*>(tile + wt_floats(Hp, size, d_a, RW));
  uint64_t* hi_empty = hi_full + kWwHiStages;
  uint64_t* lo_full = hi_empty + kWwHiStages;
  uint64_t* lo_empty = lo_full + kWwLoStages;
  uint64_t* free_ = lo_empty + kWwLoStages;  // free[c]: block c is done reading the tiles
  uint64_t* landed = free_ + C;              // landed[set C + c]: block c's part of a hand-off is written
  uint64_t* nw_full = landed + 2 * C;        // the step's narrow weights in nw

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int cluster = static_cast<int>(blockIdx.x) / C;
  const int row0 = cluster * RW;
  const int c0 = static_cast<int>(rank) * kWwCols;  // the block's columns
  const float* sck = an_s + static_cast<size_t>(k) * size;
  const float* bik = an_b + static_cast<size_t>(k) * size;
  const float* Q = ortho + static_cast<size_t>(k) * size * size;

  // ---- the rows' inputs: x1 = x_k s_k + b_k (identity at the final step),
  // dx2 = dy Q^T (dy at the final step), dld; rows past B: x_k, dy, dld zero
  for (int p = tid; p < RW * size; p += kWwThreads) {
    const int r = p / size, i = p % size;
    const bool valid = row0 + r < B;
    const float x = valid ? bound[(static_cast<size_t>(k) * B + row0) * size + p] : 0.0f;
    x1s[p] = inner ? x * sck[i] + bik[i] : x;
    float v = 0.0f;
    if (valid) {
      const float* dy = dxy + static_cast<size_t>(row0 + r) * size;
      if (inner) {
        for (int j = 0; j < size; ++j) v = fmaf(dy[j], Q[i * size + j], v);
      } else {
        v = dy[i];
      }
    }
    dx2s[p] = v;
  }
  if (tid < RW) dlds[tid] = row0 + tid < B ? dld[row0 + tid] : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWwHiStages; ++i) {
      mbar_init(&hi_full[i], 1);
      mbar_init(&hi_empty[i], kWwConsumers / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < kWwLoStages; ++i) {
      mbar_init(&lo_full[i], 3);                   // one arrival a splitting warp
      mbar_init(&lo_empty[i], kWwConsumers / 32);
    }
    for (int c = 0; c < C; ++c) {
      mbar_init(&free_[c], kWwConsumers);  // every consumer thread of block c
      mbar_init(&landed[c], kWwConsumers);
      mbar_init(&landed[C + c], kWwConsumers);
    }
    mbar_init(nw_full, 1);
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are initialised, its rows' inputs written

  const int total = 2 * nh * NJ;  // stages of the launch: the recompute's nh layers, then the backward's
  if (tid >= kWwConsumers) {
    // ---- the producer warpgroup: warp 0's first thread issues the stages
    // (layer L < nh: Wm_L^T from wf; then Wm_l from wb for l = nh-1 .. 0), in
    // the consumers' order; its second thread copies the step's W1y, b1 and
    // Wout of the block's columns; warps 1-3 split each stage's lo
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kWwConsumers, lane = tid & 31;
    if (p == 0) {
      constexpr uint32_t bytes = kWwStage * sizeof(float);
      for (int m = 0; m < total; ++m) {
        const int slot = m % kWwHiStages;
        mbar_wait(&hi_empty[slot], ((m / kWwHiStages) & 1) ^ 1);
        const int j = (m % NJ + static_cast<int>(rank) * (KB / kWwStageK)) % NJ;  // in the block's turn
        const int L = m / NJ, l = L < nh ? L : 2 * nh - 1 - L;
        const float* src = (L < nh ? wf : wb) + ((((static_cast<size_t>(k) * nh + l) * NJ + j) * C + rank) * kWwStage);
        mbar_arrive_expect_tx(&hi_full[slot], bytes);
        bulk_copy_g2s(hi_ring + slot * kWwStage, src, bytes, &hi_full[slot]);
      }
    } else if (p == 1) {
      constexpr uint32_t row = kWwCols * sizeof(float);
      mbar_arrive_expect_tx(nw_full, static_cast<uint32_t>(ww_narrow_floats(d_a, n_out)) * sizeof(float));
      for (int i = 0; i < d_a; ++i)
        bulk_copy_g2s(nw + i * kWwCols, w1y + (static_cast<size_t>(k) * d_a + i) * Hp + c0, row, nw_full);
      bulk_copy_g2s(nw + d_a * kWwCols, b1 + static_cast<size_t>(k) * Hp + c0, row, nw_full);
      bulk_copy_g2s(nw + (d_a + 1) * kWwCols, wout + (static_cast<size_t>(k) * Hp + c0) * n_out, n_out * row, nw_full);
    } else if (p >= 32) {
      const int t = p - 32;  // 96 splitting threads: lo = w - tf32(w); hi is the stage as copied
      for (int m = 0; m < total; ++m) {
        const int hs = m % kWwHiStages, ls = m % kWwLoStages;
        mbar_wait(&hi_full[hs], (m / kWwHiStages) & 1);
        mbar_wait(&lo_empty[ls], ((m / kWwLoStages) & 1) ^ 1);
        const float4* h4 = reinterpret_cast<const float4*>(hi_ring + hs * kWwStage);
        float4* l4 = reinterpret_cast<float4*>(lo_ring + ls * kWwStage);
#pragma unroll 2
        for (int i = t; i < kWwStage / 4; i += 96) {
          const float4 w = h4[i];
          l4[i] = make_float4(w.x - trunc_tf32(w.x), w.y - trunc_tf32(w.y), w.z - trunc_tf32(w.z),
                              w.w - trunc_tf32(w.w));
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(&lo_full[ls]);
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
  // this thread's A fragment of a k-step: one 16-byte read, at this offset
  // in its owner's tile (fragment-major), a k-step 512 bytes on
  const uint32_t frag_off = 16u * static_cast<uint32_t>(((wr0 / 16 + w4) * KB) * 32 + lane);
  const int turn = KB * static_cast<int>(rank);
  auto layer_tile = [&](int l) { return kTwoTiles && (l & 1) ? tile + RW * kWwCols : tile; };  // h_l's, da_l's
  float* cur = tile;  // the tile the layer's products read
  auto frag_at = [&](int s) {  // k-step (s + KB rank) % KS, in its owner's tile, shared::cluster
    const int ks = (s + turn) % KS;
    return map_peer(cur, static_cast<uint32_t>(ks / KB)) + frag_off + 512u * (ks % KB);
  };
  int m = 0;                   // the rings' stage
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
  // h_l (l < nh) of the pair (row, col), (row, col + 1) of the tile to the
  // weight-grad pass's B planes (col + 1 is 4 floats on), and its lo; rows
  // past B as zeros
  auto store_h = [&](int l, int row, int col, float h0, float h1) {
    const bool valid = row0 + row < B;
    float* o = sc.h + static_cast<size_t>(l) * plane() + hT_index(row0 + row, c0 + col, Hp);
    const float v0 = valid ? h0 : 0.0f, v1 = valid ? h1 : 0.0f;
    o[0] = v0;
    o[4] = v1;
    float* lo = o + static_cast<size_t>(nh) * plane();
    lo[0] = v0 - trunc_tf32(v0);
    lo[4] = v1 - trunc_tf32(v1);
  };

  // ---- recompute: h_0 = gelu(x1_a W1y + b1 + h_proj[k, row]) (FMA): the
  // block's columns into its tile, 64 row groups x 4 column lanes, RPT rows
  // a thread, each sum in input_layer's order; gelu'(a_0) to plane 0
  {
    const int rg = tid >> 2, cl = tid & 3;
    float2 hv[kWwCols / 8][RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + rg + 64 * r;
      const float* hp = h_proj + (static_cast<size_t>(k) * B + (row < B ? row : 0)) * Hp + c0;
#pragma unroll
      for (int j = 0; j < kWwCols / 8; ++j)
        hv[j][r] = row < B ? *reinterpret_cast<const float2*>(hp + 2 * (cl + 4 * j)) : make_float2(0.0f, 0.0f);
    }
    mbar_wait(nw_full, 0);  // the step's W1y, b1 and Wout
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
          const float xi = x1s[(rg + 64 * r) * size + i];
          a[r].x = fmaf(xi, w.x, a[r].x);
          a[r].y = fmaf(xi, w.y, a[r].y);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = rg + 64 * r;
        float h0, h1, d0, d1;
        gelu_and_grad(a[r].x, h0, d0);
        gelu_and_grad(a[r].y, h1, d1);
        tile[ww_frag_index(row, lc)] = h0;
        tile[ww_frag_index(row, lc + 1)] = h1;
        *reinterpret_cast<float2*>(sc.gs + static_cast<size_t>(row0 + row) * Hp + c0 + lc) = make_float2(d0, d1);
        store_h(0, row, lc, h0, h1);
      }
    }
  }
  hand_off_landed();

  float acc[R];  // a product's float32 sums (wgmma_tf32.cuh's D layout), then dh
  // acc = the layer's tile `cur` (RW x Hp, distributed) @ the next weight's
  // stages (this warpgroup's columns): one group in flight behind the next,
  // every kWwFwdFold k-steps' passes folded into acc
  auto product = [&]() {
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    float part[R], nxt[4];
    uint32_t a[2][2][4] = {};  // [k-step parity][hi, lo]: the group in flight reads the other set
    uint32_t keep = 0u;        // the next group's scale-d: 0 starts a fold afresh
    ld_cluster4(frag_at(0), nxt);
#pragma unroll 1
    for (int j = 0; j < NJ; ++j, ++m) {
      const int hs = m % kWwHiStages, ls = m % kWwLoStages;
      mbar_wait(&lo_full[ls], (m / kWwLoStages) & 1);
#pragma unroll
      for (int u = 0; u < kWwStageK; ++u) {
        const int s = kWwStageK * j + u, b = u & 1;
        const float cv[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
        split_tf32(cv, a[b][0], a[b][1]);
        const uint64_t bh = smem_desc(hi_ring + hs * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
        const uint64_t bl = smem_desc(lo_ring + ls * kWwStage + u * kWwKStep + 8 * wc0, 128, 256);
        wgmma_fence();
        WgmmaTf32<NW>::mma(part, a[b][1], bh, keep);
        WgmmaTf32<NW>::mma(part, a[b][0], bl);
        WgmmaTf32<NW>::mma(part, a[b][0], bh);
        wgmma_commit();
        if (s + 1 < KS) ld_cluster4(frag_at(s + 1), nxt);  // read while the group runs
        wgmma_wait<1>();  // k-step s - 1's group is done: its A registers and, at a stage's first, its stage
        hold_fragment(a[b ^ 1][0]);
        hold_fragment(a[b ^ 1][1]);
        keep = 1u;
        if (u == 0 && j > 0 && lane == 0) {
          mbar_arrive(&hi_empty[(m - 1) % kWwHiStages]);
          mbar_arrive(&lo_empty[(m - 1) % kWwLoStages]);
        }
        if ((s + 1) % kWwFwdFold == 0) {  // the fold
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
    if (lane == 0) {  // the layer's last stage
      mbar_arrive(&hi_empty[(m - 1) % kWwHiStages]);
      mbar_arrive(&lo_empty[(m - 1) % kWwLoStages]);
    }
    fence_operands(acc);
  };

  // The thread's accumulator pairs: f(e, row, col) for elements e, e + 1 at
  // (row, col), (row, col + 1) of the block's tile, kChunk column groups at
  // a time, load(row, col) for every pair of a chunk issued first. The
  // thread's first row and column pass through `opaque`, so that the
  // compiler computes their addresses here, not once before the layers'
  // loop, where they would stay live through the products (and spill).
  constexpr int kChunk = 4;
  auto each_loaded = [&](auto&& load, auto&& f) {
    const int r0 = opaque(wr0 + 16 * w4 + g), q0 = opaque(wc0 + 2 * q);
#pragma unroll
    for (int j0 = 0; j0 < NW / 8; j0 += kChunk) {
      float2 v[kChunk][2];
#pragma unroll
      for (int j = j0; j < j0 + kChunk; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[j - j0][h] = load(r0 + 8 * h, q0 + 8 * j);
#pragma unroll
      for (int j = j0; j < j0 + kChunk; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) f(4 * j + 2 * h, r0 + 8 * h, q0 + 8 * j, v[j - j0][h]);
    }
  };
  // h_{l+1} = gelu(acc + bm_l) into its tile, gelu'(a_{l+1}) to plane l + 1,
  // h_{l+1} to the weight-grad pass's B unless it is h_nh
  auto forward_out = [&](int l) {
    const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp + c0;
    float* next = layer_tile(l + 1);
    float* gl = sc.gs + static_cast<size_t>(l + 1) * plane() + static_cast<size_t>(row0) * Hp + c0;
    each_loaded([&](int, int col) { return *reinterpret_cast<const float2*>(bias + col); },
                [&](int e, int row, int col, float2 bb) {
                  float h0, h1, d0, d1;
                  gelu_and_grad(acc[e] + bb.x, h0, d0);
                  gelu_and_grad(acc[e + 1] + bb.y, h1, d1);
                  next[ww_frag_index(row, col)] = h0;
                  next[ww_frag_index(row, col + 1)] = h1;
                  *reinterpret_cast<float2*>(gl + static_cast<size_t>(row) * Hp + col) = make_float2(d0, d1);
                  if (l + 1 < nh) store_h(l + 1, row, col, h0, h1);
                });
  };
  // da_l = gelu'(a_l) dh (dh in acc) into its tile; da_l (l >= 1) to the
  // weight-grad pass's A (plane l - 1; rows past B as zeros), da_0 to
  // dh_proj[k] (rows < B)
  auto backward_out = [&](int l) {
    float* dst = layer_tile(l);
    const float* gl = sc.gs + static_cast<size_t>(l) * plane() + static_cast<size_t>(row0) * Hp + c0;
    each_loaded([&](int row, int col) { return *reinterpret_cast<const float2*>(gl + static_cast<size_t>(row) * Hp + col); },
                [&](int e, int row, int col, float2 gp) {
                  const float da0 = acc[e] * gp.x, da1 = acc[e + 1] * gp.y;
                  const bool valid = row0 + row < B;
                  dst[ww_frag_index(row, col)] = da0;
                  dst[ww_frag_index(row, col + 1)] = da1;
                  if (l > 0) {  // col and col + 1 stay side by side under the swizzle
                    *reinterpret_cast<float2*>(sc.da + static_cast<size_t>(l - 1) * plane() +
                                               daA_index(row0 + row, c0 + col, Hp / 64)) =
                        valid ? make_float2(da0, da1) : make_float2(0.0f, 0.0f);
                  } else if (valid) {
                    *reinterpret_cast<float2*>(dhp + (static_cast<size_t>(k) * B + row0 + row) * Hp + c0 + col) =
                        make_float2(da0, da1);
                  }
                });
  };

  // ---- the hidden layers: the recompute's L = 0 .. nh-1 (h_{L+1} = gelu(h_L
  // Wm_L + bm_L)), then the backward's l = nh-1 .. 0 (dh_l = da_{l+1} Wm_l^T),
  // between them the output layer and the step's backward up to da_nh; h_l
  // and da_l in tile l % 2 (at 64 rows; else the one tile)
  for (int L = 0; L < 2 * nh; ++L) {
    const bool fwd = L < nh;
    const int l = fwd ? L : 2 * nh - 1 - L;
    if (L == nh) {
      const float* hn = layer_tile(nh);  // h_nh, read by this block alone
      const float* wo = nw + (d_a + 1) * kWwCols;
      // ---- output layer: the block's partial [t | s'] over its 128 units
      // (FMA, Wout from `nw`), a thread one column of 4 rows, the sum in the
      // order of the units; each row's partial into slot `rank` of its
      // reducer's gather buffer (row r: block r % C, its row r / C)
      for (int item = tid; item < (RW / 4) * n_out; item += kWwConsumers) {
        const int c = item % n_out, r0 = (item / n_out) * 4;
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int kk = 0; kk < kWwCols; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* tv = hn + ww_frag_index(r0 + r, kk);  // 4 columns: 4 floats apart
            s4[r] = fmaf(tv[0], w0, s4[r]);
            s4[r] = fmaf(tv[4], w1, s4[r]);
            s4[r] = fmaf(tv[8], w2, s4[r]);
            s4[r] = fmaf(tv[12], w3, s4[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + r;
          st_peer(map_peer(gather + (rank * RR + row / C) * n_out + c, static_cast<uint32_t>(row % C)), s4[r]);
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
      // ---- backward through the affine update (every block alike): dout =
      // [dz_b | (dz_b e^s x1_b + dld)(1 - s^2)] in place of [t | s'], dx1's
      // x_b part dz_b e^s in dx2's
      for (int p = tid; p < RW * d_b; p += kWwConsumers) {
        const int r = p / d_b, j = p % d_b;
        const float s = tanhf(outs[r * n_out + d_b + j]);
        const float es = expf(s);
        const float dzb = dx2s[r * size + d_a + j];
        const float ds = dzb * es * x1s[r * size + d_a + j] + dlds[r];
        outs[r * n_out + j] = dzb;
        outs[r * n_out + d_b + j] = ds * (1.0f - s * s);
        dx2s[r * size + d_a + j] = dzb * es;
      }
      consumer_sync();
      // ---- the cluster's partials: dWout = h_nh^T dout (the block's rows of
      // it, float32 FMA; a thread a row of it and 4 outputs), dbout (rank 0)
      const Partial pt(Hp, size, d_a);
      float* pk = partial(pt);
      {
        const int groups = (n_out + 3) / 4;
        for (int item = tid; item < kWwCols * groups; item += kWwConsumers) {
          const int i = item % kWwCols, c = 4 * (item / kWwCols);
          float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
          for (int r = 0; r < RW; ++r) {
            const float h = hn[ww_frag_index(r, i)];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c + u < n_out) s4[u] = fmaf(h, outs[r * n_out + c + u], s4[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u < n_out) pk[pt.out + static_cast<size_t>(c0 + i) * n_out + c + u] = s4[u];
        }
      }
      if (rank == 0 && tid < n_out) {
        float s = 0.0f;
        for (int r = 0; r < RW; ++r) s += outs[r * n_out + tid];
        pk[pt.bout + tid] = s;
      }
      // ---- dh = dout Wout^T of the warpgroup's columns (FMA; Wout from `nw`;
      // each sum in the order of the outputs) into the accumulator
      {
        const float* oa = outs + (wr0 + 16 * w4 + g) * n_out;
        const float* ob = oa + 8 * n_out;
        const float* wq = wo + (wc0 + 2 * q) * n_out;
#pragma unroll
        for (int e = 0; e < R; ++e) acc[e] = 0.0f;
#pragma unroll 1
        for (int c = 0; c < n_out; ++c) {
          const float da = oa[c], db = ob[c];
#pragma unroll
          for (int j = 0; j < NW / 8; ++j) {
            const float w0 = wq[(8 * j) * n_out + c], w1 = wq[(8 * j + 1) * n_out + c];
            acc[4 * j] = fmaf(da, w0, acc[4 * j]);
            acc[4 * j + 1] = fmaf(da, w1, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(db, w0, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(db, w1, acc[4 * j + 3]);
          }
        }
      }
      consumer_sync();  // the block's readers of h_nh are done
      backward_out(nh);
      hand_off_landed();
    }
    cur = layer_tile(fwd ? l : l + 1);
    product();
    if (!kTwoTiles) hand_off_free();  // every block is done reading the tiles
    if (fwd) {
      forward_out(l);
    } else {
      backward_out(l);
    }
    if (fwd || l > 0) {
      hand_off_landed();
    } else {
      consumer_sync();  // da_0 is read by this block alone
    }
  }

  // ---- dx_a = da_0 W1y^T split by inputs: the block's partial over its 128
  // columns (FMA, W1y from `nw`; a thread one input of 4 rows, the sum in
  // the order of the columns), each row's into its reducer's gather buffer;
  // db1 = sum da_0 and dW1y = x1_a^T da_0 of the block's columns (float32)
  const Partial pt(Hp, size, d_a);
  float* pk = partial(pt);
  {
    const float* d0t = layer_tile(0);
    for (int item = tid; item < (RW / 4) * d_a; item += kWwConsumers) {
      const int i = item % d_a, r0 = (item / d_a) * 4;
      const float* w = nw + i * kWwCols;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int kk = 0; kk < kWwCols; kk += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* tv = d0t + ww_frag_index(r0 + r, kk);
          s4[r] = fmaf(tv[0], wv.x, s4[r]);
          s4[r] = fmaf(tv[4], wv.y, s4[r]);
          s4[r] = fmaf(tv[8], wv.z, s4[r]);
          s4[r] = fmaf(tv[12], wv.w, s4[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + r;
        st_peer(map_peer(gather + (rank * RR + row / C) * d_a + i, static_cast<uint32_t>(row % C)), s4[r]);
      }
    }
    for (int c = tid; c < kWwCols; c += kWwConsumers) {
      float s = 0.0f;
      for (int r = 0; r < RW; ++r) s += d0t[ww_frag_index(r, c)];
      pk[pt.b1 + c0 + c] = s;
    }
    const int groups = (d_a + 3) / 4;
    for (int item = tid; item < kWwCols * groups; item += kWwConsumers) {
      const int c = item % kWwCols, i0 = 4 * (item / kWwCols);
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int r = 0; r < RW; ++r) {
        const float h = d0t[ww_frag_index(r, c)];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u < d_a) s4[u] = fmaf(x1s[r * size + i0 + u], h, s4[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < d_a) pk[pt.w1y + static_cast<size_t>(i0 + u) * Hp + c0 + c] = s4[u];
    }
  }
  hand_off_landed();
  // ---- dx_a of this block's rows: the C partials summed in rank order,
  // stored into every block
  for (int item = tid; item < RR * d_a; item += kWwConsumers) {
    const int i = item / d_a, c = item % d_a, row = static_cast<int>(rank) + C * i;
    if (row < RW) {
      float v = gather[i * d_a + c];
#pragma unroll
      for (int cb = 1; cb < C; ++cb) v += gather[(cb * RR + i) * d_a + c];
#pragma unroll
      for (int cb = 0; cb < C; ++cb) st_peer(map_peer(dxas + row * d_a + c, static_cast<uint32_t>(cb)), v);
    }
  }
  hand_off_landed();

  // ---- rank 0: dx1 = [dx2_a + dx_a | dz_b e^s], the carried dx = dx1 s_k,
  // the ActNorm sums [sum dx1 x_k | sum dx1 | sum dld]
  if (rank == 0) {
    const float* sc_k = an_s + static_cast<size_t>(opaque(k)) * size;
    for (int p = tid; p < RW * size; p += kWwConsumers) {
      const int r = p / size, i = p % size;
      const float d = i < d_a ? dx2s[p] + dxas[r * d_a + i] : dx2s[p];
      dx2s[p] = d;
      if (row0 + r < B) dxy[static_cast<size_t>(row0) * size + p] = inner ? d * sc_k[i] : d;
    }
    consumer_sync();
    if (tid <= 2 * size) {
      float s = 0.0f;
      if (tid < size) {  // sum dx1 x_k
        for (int r = 0; r < RW; ++r) {
          const float x = row0 + r < B ? bound[(static_cast<size_t>(k) * B + row0 + r) * size + tid] : 0.0f;
          s = fmaf(dx2s[r * size + tid], x, s);
        }
      } else if (tid < 2 * size) {  // sum dx1
        for (int r = 0; r < RW; ++r) s += dx2s[r * size + tid - size];
      } else {  // sum dld
        for (int r = 0; r < RW; ++r) s += dlds[r];
      }
      pk[pt.an + tid] = s;
    }
  }
  cluster_sync();  // the producers' counterpart
}

// dWm_l^T = da_{l+1}^T h_l and dbm_l = sum da_{l+1} over the rows, for every
// layer of step k: block (l, mb, nt) takes dWm_l's columns mb*64G .. (A's
// features; warpgroup wg 64 of them from mb*64G + 64 wg) and rows nt*128 ..
// (B's, which its G warpgroups share).
template <int TN>
__global__ void __launch_bounds__(kWtGwThreads, 1)
wide_dwm(const float* __restrict__ da, const float* __restrict__ hs, float* __restrict__ dwm,
         float* __restrict__ dbm, int rows, int k, int nh) {
  constexpr int Hp = 32 * TN, MT = Hp / kWtGwM, NT = Hp / kWtGwN, R = kWtGwN / 2, G = kWtGwGroups;
  static_assert(MT % G == 0, "a block's warpgroups take whole 64-feature tiles");
  // a stage: kWtGwRows / 32 row blocks of 32, each the G warpgroups' A (32 x 64 each, contiguous in the scratch),
  // B (32 x 128) and B's lo, as the scratch holds them
  constexpr int a_floats = 32 * kWtGwM, b_floats = 32 * kWtGwN, sub = G * a_floats + 2 * b_floats,
                subs = kWtGwRows / 32, stage = subs * sub;
  const int l = static_cast<int>(blockIdx.x) / (MT / G * NT), nt = static_cast<int>(blockIdx.x) % NT;
  const int wg = threadIdx.x >> 7;
  const int mb = (static_cast<int>(blockIdx.x) / NT) % (MT / G), mt = mb * G + wg;  // the warpgroup's A tile
  const int n_rs = rows / kWtGwRows;
  const size_t plane = static_cast<size_t>(rows) * Hp;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(smem4) + kWtBarrierFloats;
  const int tid = threadIdx.x, w4 = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const float* a_src = da + static_cast<size_t>(l) * plane + mb * G * a_floats;
  const float* b_src = hs + static_cast<size_t>(l) * plane + nt * (kWtGwN / 8) * 256;
  const float* b_lo = b_src + static_cast<size_t>(nh) * plane;

  auto issue = [&](int s) {
    if (s >= n_rs) return;
    const int slot = s % kWtGwRing;
    float* dst = ring + slot * stage;
    mbar_arrive_expect_tx(&full[slot], stage * sizeof(float));
    for (int u = 0; u < subs; ++u) {
      const size_t rs = static_cast<size_t>(s) * subs + u;  // the 32-row block
      bulk_copy_g2s(dst + u * sub, a_src + rs * MT * a_floats, G * a_floats * sizeof(float), &full[slot]);
      bulk_copy_g2s(dst + u * sub + G * a_floats, b_src + rs * (Hp / 8) * 256, b_floats * sizeof(float),
                    &full[slot]);
      bulk_copy_g2s(dst + u * sub + G * a_floats + b_floats, b_lo + rs * (Hp / 8) * 256, b_floats * sizeof(float),
                    &full[slot]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kWtGwRing; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int s = 0; s < kWtGwRing; ++s) issue(s);
  }
  __syncthreads();

  float sum[R], acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) sum[e] = 0.0f;
  float sa0 = 0.0f, sa1 = 0.0f;  // A's raw column sums: features m0 and m0 + 8
  const int m0 = 16 * w4 + g, sw = q << 3;
#pragma unroll 1
  for (int s = 0; s < n_rs; ++s) {
    const int slot = s % kWtGwRing;
    mbar_wait(&full[slot], static_cast<uint32_t>(s / kWtGwRing) & 1u);
    const float* st = ring + slot * stage;
    uint32_t ahi[kWtGwRows / 8][4], alo[kWtGwRows / 8][4];
    // the stage's part of the column sums, added to them once a stage
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kWtGwRows / 8; ++kk) {
      const float* r0 = st + (kk / 4) * sub + wg * a_floats + (8 * (kk % 4) + q) * kWtGwM;
      const float* r1 = r0 + 4 * kWtGwM;
      const float v[4] = {r0[m0 ^ sw], r0[(m0 + 8) ^ sw], r1[m0 ^ sw], r1[(m0 + 8) ^ sw]};
      ps0 += v[0];
      ps0 += v[2];
      ps1 += v[1];
      ps1 += v[3];
      split_tf32(v, ahi[kk], alo[kk]);
    }
    sa0 += ps0;
    sa1 += ps1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWtGwRows / 8; ++kk) {
      const float* b = st + (kk / 4) * sub + G * a_floats + 2 * (kk % 4) * 32;
      wgmma_3xtf32<kWtGwN>(acc, ahi[kk], alo[kk], smem_desc(b, 128, 1024), smem_desc(b + b_floats, 128, 1024),
                            kk == 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int e = 0; e < R; ++e) sum[e] += acc[e];
    __syncthreads();  // the slot's readers are done
    if (tid == 0) issue(s + kWtGwRing);
  }

  float* out = dwm + (static_cast<size_t>(k) * nh + l) * Hp * Hp;
#pragma unroll
  for (int j = 0; j < kWtGwN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mm = mt * kWtGwM + m0 + 8 * h, n = nt * kWtGwN + 8 * j + 2 * q + e;
        out[static_cast<size_t>(n) * Hp + mm] = sum[4 * j + 2 * h + e];
      }
  sa0 += __shfl_xor_sync(0xffffffffu, sa0, 1);
  sa0 += __shfl_xor_sync(0xffffffffu, sa0, 2);
  sa1 += __shfl_xor_sync(0xffffffffu, sa1, 1);
  sa1 += __shfl_xor_sync(0xffffffffu, sa1, 2);
  if (nt == 0 && q == 0) {
    float* bias = dbm + (static_cast<size_t>(k) * nh + l) * Hp + mt * kWtGwM;
    bias[m0] = sa0;
    bias[m0 + 8] = sa1;
  }
}

// Step k's rows kernel (what == kWtRows) or its weight-grad pass (kWtGrads)
// on `stream`.
template <int TN, int RW>
cudaError_t launch_step(const float* bound, const float* h_proj, const float* dld, const float* an_s,
                        const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wf,
                        const float* wb, const float* bm, const float* wout, const float* bout, float* dx, float* dhp,
                        float* dwm, float* dbm, WtScratch sc, int B, int S, int k, int size, int d_a, int nh,
                        int what, cudaStream_t stream) {
  constexpr int Hp = 32 * TN;
  const int clusters = (B + RW - 1) / RW;
  cudaError_t err;
  if (what == kWtRows) {
    const size_t smem = wt_smem(Hp, size, d_a, RW);
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    if ((err = ww_launch<TN>(wide_train_rows<TN, RW>, smem, B, RW, stream, bound, h_proj, dld, an_s, an_b, ortho, w1y,
                             b1, wf, wb, bm, wout, bout, dx, dhp, sc, B, S, k, size, d_a, nh)) != cudaSuccess)
      return err;
  }
  if (what == kWtGrads) {
    const size_t smem = wt_gw_smem();
    if ((err = cudaFuncSetAttribute(wide_dwm<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    wide_dwm<TN><<<nh * (Hp / kWtGwM / kWtGwGroups) * (Hp / kWtGwN), kWtGwThreads, smem, stream>>>(
        sc.da, sc.h, dwm, dbm, clusters * RW, k, nh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// [rows kernel bytes of shared memory a block, its clusters resident at
// once on the card, weight-grad pass bytes a block, its blocks resident on
// an SM] on tiles of RW rows
template <int TN, int RW>
cudaError_t wt_layout(int size, int d_a, int* out) {
  constexpr int Hp = 32 * TN;
  const size_t smem = wt_smem(Hp, size, d_a, RW);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  out[0] = static_cast<int>(smem);
  out[1] = resident_clusters<TN>(wide_train_rows<TN, RW>, smem);
  if (out[1] <= 0) return out[1] < 0 ? static_cast<cudaError_t>(-out[1]) : cudaErrorInvalidConfiguration;
  const size_t gsmem = wt_gw_smem();
  out[2] = static_cast<int>(gsmem);
  cudaError_t err = cudaFuncSetAttribute(wide_dwm<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(gsmem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], wide_dwm<TN>, kWtGwThreads, gsmem);
}

// A step's scratch planes: gelu'(a_l) (nh + 1), h_l and its lo in the B
// layout (2 nh), da_{l+1} in the A layout (nh).
size_t step_planes(int nh) { return 4 * static_cast<size_t>(nh) + 1; }

// Two sets of a step's planes (steps k and k - 1 in turn, so that a step's
// weight-grad pass can run beside the next step's rows kernel), then the
// partials of every step.
size_t scratch_floats(int B, int S, int size, int d_a, int nh, int Hp, int rows) {
  const size_t clusters = (B + rows - 1) / rows;
  const size_t plane = clusters * rows * Hp;
  return 2 * step_planes(nh) * plane + static_cast<size_t>(S) * clusters * Partial(Hp, size, d_a).floats;
}

// A high-priority stream for the rows kernels (their pending clusters take
// the SMs before the weight-grad blocks queued on the caller's stream) and
// the events that order the two, made once a device.
struct WtStreams {
  cudaStream_t rows;
  cudaEvent_t start, rows_done[2], grads_done[2];
};

cudaError_t wt_streams(WtStreams** out) {
  static std::mutex mu;
  static WtStreams made[kWtMaxDevices];
  static bool ready[kWtMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kWtMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  WtStreams& s = made[dev];
  if (!ready[dev]) {
    int least = 0, greatest = 0;
    if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (err = cudaStreamCreateWithPriority(&s.rows, cudaStreamNonBlocking, greatest)) != cudaSuccess)
      return err;
    for (cudaEvent_t* e : {&s.start, &s.rows_done[0], &s.rows_done[1], &s.grads_done[0], &s.grads_done[1]})
      if ((err = cudaEventCreateWithFlags(e, cudaEventDisableTiming)) != cudaSuccess) return err;
    ready[dev] = true;
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

#define BCNF_WT_CASES(Hp, rows, CASE) \
  switch ((Hp) / 32 * 1000 + (rows)) { \
    CASE(24, 64)                        \
    CASE(24, 128)                       \
    CASE(32, 64)                        \
    CASE(32, 128)                       \
    default:                            \
      break;                            \
  }

// C entry points, loaded with ctypes.

// Floats of scratch `bcnf_flow_train_bwd_wide` needs on tiles of `rows` rows
// (the wrapper allocates it).
extern "C" long long bcnf_flow_train_wide_scratch(int B, int S, int size, int d_a, int nh, int Hp, int rows) {
  return static_cast<long long>(scratch_floats(B, S, size, d_a, nh, Hp, rows));
}

// K2b on this route: arguments as flow_train_kernel.cu's `bcnf_flow_train_bwd`,
// with `wstages` (the hidden weights as `prepare_wide_train_weights` lays them
// out: (2 [Wm^T, Wm], S, nh, Hp/8/kWwStageK, Hp/kWwCols, kWwStageK,
// kWwCols/8, 2, 8, 4) floats, each direction `prepare_wide_weights`' layout
// of Wm and of Wm^T; 16-byte aligned) in place of wm, on tiles of `rows`
// rows (kWwRows or kWwHalfRows). Hp must be 768 or 1024; a shape past the
// rows kernel's shared memory returns cudaErrorInvalidValue. `parts` (bits)
// runs the rows kernels (kWtRows, with the copy of dz that starts them), the
// weight-grad passes (kWtGrads) and the final reduction (kWtReduce: dWout,
// dbout, dW1y, db1, the ActNorm grads); the wrapper passes all three. With
// both of the first, step k's weight-grad pass runs on the caller's stream
// beside step k - 1's rows kernel, which runs on a stream of its own (each
// step's scratch planes in one of two sets in turn; everything joins the
// caller's stream before the reduction). Returns the first failing call's
// cudaError_t.
extern "C" int bcnf_flow_train_bwd_wide(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wstages,
    const float* bm, const float* wout, const float* bout, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int S, int size, int d_a, int nh, int Hp, int rows, int parts, void* stream) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || Hp % 32 != 0 ||
      (rows != kWwRows && rows != kWwHalfRows) ||
      ((reinterpret_cast<size_t>(wstages) | reinterpret_cast<size_t>(scratch) | reinterpret_cast<size_t>(w1y) |
        reinterpret_cast<size_t>(b1) | reinterpret_cast<size_t>(wout)) & 15) != 0 ||
      ((reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(dhp) | reinterpret_cast<size_t>(bm)) & 7) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int clusters = (B + rows - 1) / rows;
  const size_t plane = static_cast<size_t>(clusters) * rows * Hp;
  const float* wb = wstages + static_cast<size_t>(S) * nh * Hp * Hp;
  auto scratch_set = [&](int b) {  // set b of a step's scratch planes
    WtScratch sc;
    sc.gs = scratch + b * step_planes(nh) * plane;
    sc.h = sc.gs + (nh + 1) * plane;
    sc.da = sc.h + 2 * static_cast<size_t>(nh) * plane;
    sc.part = scratch + 2 * step_planes(nh) * plane;
    return sc;
  };
  auto step = [&](int k, int what, cudaStream_t s, WtScratch sc) {
    cudaError_t err = cudaErrorInvalidValue;
#define BCNF_CASE(TN, RW)                                                                                           \
  case TN * 1000 + RW:                                                                                              \
    err = launch_step<TN, RW>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wstages, wb, bm, wout, bout, dx, dhp, \
                              dwm, dbm, sc, B, S, k, size, d_a, nh, what, s);                                       \
    break;
    BCNF_WT_CASES(Hp, rows, BCNF_CASE)
#undef BCNF_CASE
    return err;
  };

  cudaError_t err;
  const bool beside = (parts & (kWtRows | kWtGrads)) == (kWtRows | kWtGrads);
  WtStreams* o = nullptr;
  if (beside && (err = wt_streams(&o)) != cudaSuccess) return err;
  cudaStream_t rs = beside ? o->rows : st;  // the rows kernels' stream
  if ((parts & kWtRows) &&
      (err = cudaMemcpyAsync(dx, dz, sizeof(float) * B * size, cudaMemcpyDeviceToDevice, st)) != cudaSuccess)
    return err;
  if (beside && ((err = cudaEventRecord(o->start, st)) != cudaSuccess ||
                 (err = cudaStreamWaitEvent(rs, o->start, 0)) != cudaSuccess))
    return err;
  for (int k = S - 1; k >= 0; --k) {
    const int b = beside ? k & 1 : 0;
    const WtScratch sc = scratch_set(b);
    if (beside && k + 2 < S && (err = cudaStreamWaitEvent(rs, o->grads_done[b], 0)) != cudaSuccess)
      return err;  // step k + 2's weight-grad pass is done with set b
    if ((parts & kWtRows) && (err = step(k, kWtRows, rs, sc)) != cudaSuccess) return err;
    if (beside && ((err = cudaEventRecord(o->rows_done[b], rs)) != cudaSuccess ||
                   (err = cudaStreamWaitEvent(st, o->rows_done[b], 0)) != cudaSuccess))
      return err;
    if ((parts & kWtGrads) && (err = step(k, kWtGrads, st, sc)) != cudaSuccess) return err;
    if (beside && (err = cudaEventRecord(o->grads_done[b], st)) != cudaSuccess) return err;
  }
  if (parts & kWtReduce) {  // the caller's stream has waited for every rows kernel
    const long long n = static_cast<long long>(S) * (Partial(Hp, size, d_a).an + 2 * size);
    tw_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(scratch_set(0).part, an_s, dwout, dw1y, dbout,
                                                                     db1, dan_s, dan_b, S, clusters, Hp, size, d_a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// The route's layout at this shape on tiles of `rows` rows (see `wt_layout`),
// into out[0..3]; returns a cudaError_t (cudaErrorInvalidValue where the
// shape is refused).
extern "C" int bcnf_flow_train_wide_layout(int Hp, int size, int d_a, int rows, int* out) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size) return cudaErrorInvalidValue;
#define BCNF_CASE(TN, RW) \
  case TN * 1000 + RW:    \
    return wt_layout<TN, RW>(size, d_a, out);
  BCNF_WT_CASES(Hp, rows, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
