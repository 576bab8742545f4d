// K1's inverse in 3xTF32 on Hopper's warpgroup tensor-core products (`wgmma`)
// at the wide padded hidden widths Hp 768 and 1024 (TN 24 and 32), where the
// 64-row float32 tile of flow_wgmma.cu no longer fits a block (263 KB at Hp
// 1024) and its fold no longer fits the registers.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow with inverse=True (the
// Pallas TPU kernel `_flow_kernel`) at those widths in the default mode, and
// the inverse of bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4),
// which the port runs as this kernel at one step. Host side and plain
// PyTorch version: bcnf_tpu_torch/ops/flow_kernel.py (`fused_flow`,
// `flow_route`, `prepare_wide_weights`, `wide_grid`, `fused_flow_reference`).
//
// What it computes, for every row r (conditioned on h_proj[k, r % N]): step
// S-1 (the final coupling alone), then for k = S-2 .. 0: x <- x Q_k^T,
// coupling^-1, ActNorm^-1; the coupling on x = [x_a | x_b] being
// a = gelu(x_a W1y + b1 + h_proj), a = gelu(a Wm_l + bm_l) for each hidden
// layer, [t | s'] = a Wout + bout, s = tanh(s'), x_b <- (x_b - t) exp(-s).
//
// What bounds it on an H100: the square hidden products, 2 nh Hp^2 FLOP a
// row and step, on the tensor cores at a third of the dense TF32 rate
// (3xTF32: three products a product), and the hidden weights' traffic from
// L2: every tile of rows reads each hidden weight once, in float32 (4 MB a
// layer at Hp 1024; 272 GB a call of 80,000 rows in 128-row tiles, 26 steps
// of 4 layers), which at L2's few TB/s takes about as long as the products.
// As built (PERF.md, tools/k1_wide_parts.py; an H100 at Hp 1024, 80,000
// rows of 26 steps): 374 ms against a 101.6 ms bound, 27%, and not bound by
// the tensor cores. The products alone (stale stages, each block's own
// tile) take 272 ms, 217 with a third of their passes, 209 without the
// fold's adds; the stream and the split alone take 209 ms, of which the
// rings' barriers, the FMA layers and the hand-offs alone take 116; the
// whole call overlaps the two only in part. Reading the fragments from the
// owners' tiles adds ~47 ms; the FMA layers, the mixes and the hand-offs
// with no hidden layer take 48. Measured and not kept: a second fresh
// accumulator in flight, a fold every 2 k-steps, hi truncated, a 4-stage
// hi ring, clusters starting a layer at different stages.
//
// Design.
// - A cluster of C = Hp / 128 blocks (6 at Hp 768, 8 at 1024) owns 128 rows
//   for all S steps; block `rank` owns columns [128 rank, 128 rank + 128)
//   of every hidden layer, and its consumer warpgroup w rows [64 w, 64 w +
//   64): one m64n128 product a k-step, 64 running sums and a 64-float fresh
//   accumulator a thread, each k-step's three passes into the fresh one
//   (scale-d 0), waited for and folded into the running sums by float32 adds
//   (the fold of flow_wgmma.cu, which keeps a 1024-long dot product's 128
//   truncating k-stages out of the sums' bits). A weight stage thus serves
//   128 rows: each weight is read from L2 once a 128-row tile.
// - A distributed tile: each block keeps only its own 128 columns of h_l
//   for the 128 rows, 128 x 132 floats. The A fragment of k-step s lies in
//   the tile of block s / 16; each consumer thread reads its four values
//   there through distributed shared memory (`ld.shared::cluster`) a k-step
//   ahead, and splits them into hi = tf32(a) and lo = a - hi in registers.
//   Block r takes the k-steps in turn from its own (16 r, 16 r + 1, .. mod
//   Hp/8), and its weight stages in the same order, so that at each k-step
//   every block's tile is read by one block: read all from one owner, the
//   eight blocks' fragments took three times the products' time.
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
//   from the phase it waits for).
// - Each weight read once a tile from L2, in float32: the hidden weights are
//   laid out once a call (`prepare_wide_weights`: float32, transposed to
//   K-major core-matrix order, kWwStageK k-steps of a block's 128 columns
//   contiguous, 8 KB), and one producer thread bulk-copies
//   (`cp.async.bulk`) each such stage into a ring of kWwHiStages slots, up
//   to kWwHiStages ahead across layers and steps. Three producer warps split
//   each stage in place: hi = tf32_rna(w) over the copy, lo = w - hi into a
//   ring of kWwLoStages slots, fenced for the async proxy that `wgmma` reads
//   through; the consumers take the stage once its lo is written, and
//   release both slots after its last k-step.
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
//   after another, the mix, the coupling update and ActNorm^-1, which run in
//   every block on the same data, keep their states equal to the bit. Rank
//   0 stores y. Rows past B run on zeros and are not stored.
// 66 KB of tile, 64 KB of hi ring, 24 KB of lo ring, the rows' state (19 KB
// at size 19) and the output layer's buffers (18 KB) come to ~192 KB of the
// 227 KB.

#include "flow_rows.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kWwRows = 128;                   // rows of a cluster: two wgmma M, one a consumer warpgroup
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
constexpr int kWwLd = kWwCols + 4;  // the tile's row stride (conflict-free fragment loads)
constexpr int kWwKStep = 8 * kWwCols;  // floats of a k-step of a block's columns
constexpr int kWwStage = kWwStageK * kWwKStep;  // floats of a stage
// The parts a launch runs: all, or some left out to time the rest
// (tools/k1_wide_parts.py): the products, the stages' copies, the
// fragments' reads from the owners' tiles (without it each block reads its
// own), the producers' split
constexpr int kWwProducts = 1, kWwCopies = 2, kWwExchange = 4, kWwSplit = 8;
// Registers a thread: a block of 12 warps starts with 168 (65,536 / 384); the
// producer warpgroup, which splits the stages, keeps 56, and the consumers
// take 224 each from what it gives up: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// Rows a block reduces in the output layer: rows r with r % C == rank.
__host__ __device__ constexpr int ww_reduce_rows(int C) { return (kWwRows + C - 1) / C; }

// The kernel's dynamic shared memory (ops/flow_kernel.py: kernel_smem mirrors
// this sum): the tile, the hi and lo rings, x and x Q^T, the partial [t | s']
// of the block's reduced rows from each of the C blocks and [t | s'] of every
// row, two barriers a ring stage and three hand-off barriers a block of the
// cluster (free, and two sets of landed).
size_t ww_smem(int Hp, int size, int d_a) {
  const int C = Hp / kWwCols;
  const size_t n_out = 2 * static_cast<size_t>(size - d_a);
  return sizeof(float) * (static_cast<size_t>(kWwRows) * kWwLd +
                          static_cast<size_t>(kWwHiStages + kWwLoStages) * kWwStage +
                          static_cast<size_t>(kWwRows) * 2 * size +
                          (static_cast<size_t>(C) * ww_reduce_rows(C) + kWwRows) * n_out) +
         sizeof(uint64_t) * (2 * (kWwHiStages + kWwLoStages) + 3 * static_cast<size_t>(C));
}

bool ww_takes(int Hp, int size, int d_a) { return ww_smem(Hp, size, d_a) <= kSmemLimit; }

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

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (`wgmma`'s operand reads).
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A thread's four values of its m64 x k8 fragment (rows g (+8) of its warp's
// 16, columns q (+4) of the k-step's 8) at shared::cluster address `at` of
// the first, in a tile of row stride kWwLd.
__device__ __forceinline__ void load_frag(uint32_t at, float (&v)[4]) {
  v[0] = ld_cluster(at);
  v[1] = ld_cluster(at + 4u * 8 * kWwLd);
  v[2] = ld_cluster(at + 4u * 4);
  v[3] = ld_cluster(at + 4u * (8 * kWwLd + 4));
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
  constexpr int Hp = 32 * TN, C = Hp / kWwCols, KS = Hp / 8;  // blocks a cluster, k-steps a layer
  constexpr int NJ = KS / kWwStageK;                            // stages a layer
  constexpr int KB = kWwCols / 8;                               // k-steps a block's columns hold
  constexpr int RR = ww_reduce_rows(C);                         // rows a block reduces
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // 128 x kWwLd: the block's columns of h_l
  float* hi_ring = tile + kWwRows * kWwLd;         // kWwHiStages stages, bulk-copied, then rounded to hi
  float* lo_ring = hi_ring + kWwHiStages * kWwStage;  // kWwLoStages stages of lo
  float* xs = lo_ring + kWwLoStages * kWwStage;    // 128 x size: the rows' state
  float* xt = xs + kWwRows * size;                 // 128 x size: the mix's output
  float* gather = xt + kWwRows * size;             // C x RR x n_out: the partials of the rows this block reduces
  float* outs = gather + C * RR * n_out;           // 128 x n_out: [t | s'] of every row
  uint64_t* hi_full = reinterpret_cast<uint64_t*>(outs + kWwRows * n_out);
  uint64_t* hi_empty = hi_full + kWwHiStages;
  uint64_t* lo_full = hi_empty + kWwHiStages;  // the stage is split: hi and lo ready
  uint64_t* lo_empty = lo_full + kWwLoStages;
  uint64_t* free_ = lo_empty + kWwLoStages;  // free[c]: block c is done reading the tiles of h_l
  uint64_t* landed = free_ + C;  // landed[set C + c]: block c's part of a hand-off is written (2 sets in turn)

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * kWwRows;
  const int c0 = static_cast<int>(rank) * kWwCols;  // the block's columns
  for (int p = tid; p < kWwRows * size; p += kWwThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWwHiStages; ++i) {
      mbar_init(&hi_full[i], 1);
      mbar_init(&hi_empty[i], kWwConsumers / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < kWwLoStages; ++i) {
      mbar_init(&lo_full[i], 3);                   // one arrival a splitting warp
      mbar_init(&lo_empty[i], kWwConsumers / 32);  // one arrival a consumer warp
    }
    for (int c = 0; c < C; ++c) {
      mbar_init(&free_[c], kWwConsumers);  // every consumer thread of block c
      mbar_init(&landed[c], kWwConsumers);
      mbar_init(&landed[C + c], kWwConsumers);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are initialised before any block reaches them

  const int total = S * nh * NJ;  // stages of the whole call
  if (tid >= kWwConsumers) {
    // ---- the producer warpgroup: warp 0's first thread issues the stages,
    // warps 1-3 split them, in the consumers' order across layers and steps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kWwConsumers, lane = tid & 31;
    if (p == 0) {
      constexpr uint32_t bytes = kWwStage * sizeof(float);
      for (int m = 0; m < total; ++m) {
        const int slot = m % kWwHiStages;
        mbar_wait(&hi_empty[slot], ((m / kWwHiStages) & 1) ^ 1);
        if (parts & kWwCopies) {
          // stage m % NJ of layer (step, l), rank's part: at ((layer NJ + j) C + rank) stages
          const int j = (m % NJ + static_cast<int>(rank) * (KB / kWwStageK)) % NJ;  // in the block's turn
          const int layer = m / NJ, l = layer % nh, k = S - 1 - layer / nh;
          const float* src = wstages + ((((static_cast<size_t>(k) * nh + l) * NJ + j) * C + rank) * kWwStage);
          mbar_arrive_expect_tx(&hi_full[slot], bytes);
          bulk_copy_g2s(hi_ring + slot * kWwStage, src, bytes, &hi_full[slot]);
        } else {
          mbar_arrive(&hi_full[slot]);  // timing the rest: the stage as it is
        }
      }
    } else if (p >= 32) {
      const int t = p - 32;  // 96 splitting threads
      for (int m = 0; m < total; ++m) {
        const int hs = m % kWwHiStages, ls = m % kWwLoStages;
        mbar_wait(&hi_full[hs], (m / kWwHiStages) & 1);
        mbar_wait(&lo_empty[ls], ((m / kWwLoStages) & 1) ^ 1);
        if (parts & kWwSplit) {
          float4* h4 = reinterpret_cast<float4*>(hi_ring + hs * kWwStage);
          float4* l4 = reinterpret_cast<float4*>(lo_ring + ls * kWwStage);
#pragma unroll 2
          for (int i = t; i < kWwStage / 4; i += 96) {
            const float4 w = h4[i];
            const float4 h = make_float4(rna(w.x), rna(w.y), rna(w.z), rna(w.w));
            h4[i] = h;
            l4[i] = make_float4(w.x - h.x, w.y - h.y, w.z - h.z, w.w - h.w);
          }
          fence_async_shared();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&lo_full[ls]);
      }
    }
    cluster_sync();  // no block leaves while another may reach its memory
    return;
  }

  // ---- the consumers: 256 threads, two warpgroups, warpgroup wg rows 64 wg ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool exchange = parts & kWwExchange;
  // this thread's first fragment value's offset in a tile, in bytes
  const uint32_t frag_off = 4u * static_cast<uint32_t>((64 * wg + 16 * w4 + g) * kWwLd + q);
  // the address of this thread's A fragment of the layer's s-th k-step in the
  // block's turn, k-step (s + KB rank) % KS, in its owner's tile (without the
  // exchange: in this block's), shared::cluster
  const int turn = KB * static_cast<int>(rank);
  auto frag_at = [&](int s) {
    const int ks = (s + turn) % KS;
    return map_peer(tile, exchange ? static_cast<uint32_t>(ks / KB) : rank) + frag_off + 32u * (ks % KB);
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
    const int k = S - 1 - it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;

    if (inner) {  // ---- x <- x Q_k^T (FMA)
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      for (int p = tid; p < kWwRows * size; p += kWwConsumers) {
        const int r = p / size, j = p % size;
        float acc = 0.0f;
        for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
        xt[p] = acc;
      }
      float* t = xs;
      xs = xt;
      xt = t;
    }
    consumer_sync();  // x Q^T written; the previous output layer is done reading the tile

    // ---- h_0 = gelu(x_a W1y + b1 + h_proj[k, row % N]) (FMA): the block's
    // columns into its tile, 64 row pairs x 4 column lanes, 2 rows a thread,
    // W1y's column pair loaded once for both, each sum in input_layer's order
    {
      const float* w1 = w1y + static_cast<size_t>(k) * d_a * Hp;
      const float* b1k = b1 + static_cast<size_t>(k) * Hp;
      const int rg = tid >> 2, cl = tid & 3;
      const float* hp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + rg + 64 * r;
        hp[r] = row < B ? h_proj + (static_cast<size_t>(k) * N + row % N) * Hp : nullptr;
      }
#pragma unroll 2
      for (int j = 0; j < kWwCols / 8; ++j) {
        const int lc = 2 * (cl + 4 * j), col = c0 + lc;
        const float2 bias = *reinterpret_cast<const float2*>(b1k + col);
        float2 a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 h = hp[r] != nullptr ? *reinterpret_cast<const float2*>(hp[r] + col) : make_float2(0.0f, 0.0f);
          a[r] = make_float2(bias.x + h.x, bias.y + h.y);
        }
#pragma unroll 4
        for (int i = 0; i < d_a; ++i) {
          const float2 w = *reinterpret_cast<const float2*>(w1 + i * Hp + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float xi = xs[(rg + 64 * r) * size + i];
            a[r].x = fmaf(xi, w.x, a[r].x);
            a[r].y = fmaf(xi, w.y, a[r].y);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(tile + (rg + 64 * r) * kWwLd + lc) =
              make_float2(gelu_tanh(a[r].x), gelu_tanh(a[r].y));
      }
    }
    hand_off_landed();

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma in 3xTF32,
    // each k-step's passes into a fresh accumulator folded into the running sums
    for (int l = 0; l < nh; ++l) {
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
      if (!(parts & kWwProducts)) {  // timing the rest: the stages as they come
        for (int j = 0; j < NJ; ++j, ++m) {
          mbar_wait(&lo_full[m % kWwLoStages], (m / kWwLoStages) & 1);
          if (lane == 0) {
            mbar_arrive(&hi_empty[m % kWwHiStages]);
            mbar_arrive(&lo_empty[m % kWwLoStages]);
          }
        }
      } else {
        float part[64], nxt[4];
        load_frag(frag_at(0), nxt);
#pragma unroll 1
        for (int j = 0; j < NJ; ++j, ++m) {
          const int hs = m % kWwHiStages, ls = m % kWwLoStages;
          mbar_wait(&lo_full[ls], (m / kWwLoStages) & 1);
#pragma unroll
          for (int u = 0; u < kWwStageK; ++u) {
            const int s = kWwStageK * j + u;
            uint32_t ahi[4], alo[4];
            const float cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
            if (s + 1 < KS) load_frag(frag_at(s + 1), nxt);
            split_tf32(cur, ahi, alo);
            const uint64_t bh = smem_desc(hi_ring + hs * kWwStage + u * kWwKStep, 128, 256);
            const uint64_t bl = smem_desc(lo_ring + ls * kWwStage + u * kWwKStep, 128, 256);
            wgmma_fence();
            WgmmaTf32<128>::mma(part, alo, bh, 0);
            WgmmaTf32<128>::mma(part, ahi, bl);
            WgmmaTf32<128>::mma(part, ahi, bh);
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
            for (int e = 0; e < 64; ++e) acc[e] += part[e];
          }
        }
      }
      hand_off_free();  // every block is done reading the tiles of h_l
      const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp + c0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * wg + 16 * w4 + g + 8 * h, col = 8 * j + 2 * q;
          *reinterpret_cast<float2*>(tile + row * kWwLd + col) =
              make_float2(gelu_tanh(acc[4 * j + 2 * h] + bias[col]), gelu_tanh(acc[4 * j + 2 * h + 1] + bias[col + 1]));
        }
      hand_off_landed();
    }

    // ---- output layer: the block's partial [t | s'] over its 128 units (FMA;
    // Wout from L1/L2), a thread one column of 4 rows, the sum in the order
    // of the units; each row's partial into slot `rank` of its reducer's
    // gather buffer (row r: block r % C, its row r / C)
    {
      const float* wo = wout + (static_cast<size_t>(k) * Hp + c0) * n_out;
      for (int item = tid; item < (kWwRows / 4) * n_out; item += kWwConsumers) {
        const int c = item % n_out, r0 = (item / n_out) * 4;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int kk = 0; kk < kWwCols; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(tile + (r0 + r) * kWwLd + kk);
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
    }
    hand_off_landed();

    // ---- [t | s'] of this block's rows: the C partials summed in rank
    // order, then the bias, stored into every block
    {
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      for (int item = tid; item < RR * n_out; item += kWwConsumers) {
        const int i = item / n_out, c = item % n_out, row = static_cast<int>(rank) + C * i;
        if (row < kWwRows) {
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

    // ---- x_b <- (x_b - t) exp(-s) (one thread a row, the same in every block)
    if (tid < kWwRows) {
      const float* o = outs + tid * n_out;
      float* xr = xs + tid * size;
      for (int j = 0; j < d_b; ++j) xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-tanhf(o[d_b + j]));
    }
    consumer_sync();

    if (inner) {  // ---- ActNorm^-1
      for (int p = tid; p < kWwRows * size; p += kWwConsumers) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      consumer_sync();
    }
  }

  if (rank == 0) {
    for (int p = tid; p < kWwRows * size; p += kWwConsumers)
      if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
  }
  cluster_sync();  // the producers' counterpart
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

template <int TN>
cudaError_t launch(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                   const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                   const float* bout, float* y, int B, int N, int S, int size, int d_a, int nh, int parts,
                   cudaStream_t stream) {
  constexpr int Hp = 32 * TN;
  if (!ww_takes(Hp, size, d_a)) return cudaErrorInvalidValue;
  const size_t smem = ww_smem(Hp, size, d_a);
  cudaError_t err = cudaFuncSetAttribute(flow_inverse_wide<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a cluster a 128-row tile (ops/flow_kernel.py: `wide_grid` mirrors this);
  // a refused launch returns its error (nothing stands in for it)
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ww_config<TN>(attr, smem, (B + kWwRows - 1) / kWwRows, stream);
  err = cudaLaunchKernelEx(&cfg, flow_inverse_wide<TN>, x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout,
                           bout, y, B, N, S, size, d_a, nh, parts);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the kernel resident on the whole card at once at this shape (as
// the occupancy calculator gives it), or minus a cudaError_t.
template <int TN>
int resident_clusters(int size, int d_a) {
  constexpr int Hp = 32 * TN;
  if (!ww_takes(Hp, size, d_a)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ww_smem(Hp, size, d_a);
  cudaError_t err = cudaFuncSetAttribute(flow_inverse_wide<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ww_config<TN>(attr, smem, 1, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, flow_inverse_wide<TN>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // namespace

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

// Clusters of the wide inverse the card holds at once at this shape, or
// minus a cudaError_t.
extern "C" int bcnf_flow_wide_clusters(int Hp, int size, int d_a) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size) return -static_cast<int>(cudaErrorInvalidValue);
#define BCNF_CASE(TN) \
  case TN:            \
    return resident_clusters<TN>(size, d_a);
  BCNF_WW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a block takes at this shape (as the
// launcher computes it), or minus a cudaError_t where the shape is refused.
extern "C" int bcnf_flow_wide_smem(int Hp, int size, int d_a) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size || !ww_takes(Hp, size, d_a))
    return -static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ww_smem(Hp, size, d_a));
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
