// One LSTM direction's recurrence over T steps, forward (K3a) and backward
// (K3b).
//
// Replaces: bcnf_tpu/ops/lstm_kernel.py, `run_fwd` (the Pallas TPU kernel
// `_fwd_kernel`) and `run_bwd` (`_bwd_kernel`). Host side and plain PyTorch
// versions: bcnf_tpu_torch/ops/lstm_kernel.py.
//
// What it computes, for each row r of the batch (xp is time-major
// (T, B, 4H), gate order i, f, g, o; W_hh is (H, 4H); t walks T-1 .. 0 when
// reverse):
//   K3a: gates = xp[t] + h W_hh; i, f, o = sigmoid, g = tanh;
//        c = f c + i g; h = o tanh(c); hs[t] = h, cs[t] = c (h = c = 0 first).
//   K3b: in the opposite order, from the saved hs, cs and the cotangent dhs:
//        recompute the step's gates from h_prev, c_prev (zeros at the
//        forward's first step); dh = dhs[t] + dh_next; do = dh tanh(c);
//        dc = dh o (1 - tanh^2 c) + dc_next; dgates = [dc g i(1-i) |
//        dc c_prev f(1-f) | dc i (1-g^2) | do o(1-o)] = dxp[t];
//        dh_next = dgates W_hh^T; dc_next = dc f; and
//        dW_hh = sum over t and rows of h_prev^T dgates.
//
// What bounds it on an H100. A step is a (B x H) @ (H x 4H) product, 8 H^2
// FLOP a row: 19.3 GFLOP a direction at the flagship's B = 4096, T = 30,
// H = 140. Both kernels take their products on the tensor cores in 3xTF32
// (mma_tf32.cuh: three products a product, at a third of the 494.7 TFLOP/s
// TF32 rate), so K3a is bound by its bytes (xp in, hs and cs out: 0.12 ms)
// about as much as by its operations (0.12 ms); K3b does three such products
// (3 x 57.2 GFLOP, 0.35 ms).
//
// K3a's design: tensor cores in 3xTF32, W_hh resident. The TPU kernel keeps
// the whole time loop inside one invocation per batch tile; here a
// thread-block cluster of 8 blocks owns kFwdRows = 64 rows for all T steps,
// so batch 4096 is 64 clusters of 8 blocks, two blocks an SM at the
// flagship's widths (the card holds 30 such clusters at once: clusters take
// whole groups of SMs). Block q owns hidden units
// q*U .. q*U + U - 1 (U = Hp/8) of every gate and keeps W_hh's columns of
// those units (Hp x 4U, 55 KB at H = 140) in shared memory for the whole
// launch: W_hh is read once a block, not once a step. The block orders
// those columns as it loads them, so that one n-tile pair of the product's
// C fragments gives a thread i, f (first tile) and g, o (second) of the same
// unit: the cell update runs on the accumulators, c stays in registers, and
// no gate sum goes through shared memory. A step: (1) the
// gate sums of the block's columns, h (64 x Hp, all units) times the
// resident slice; (2) the cell update for the block's units, hs and cs
// written at width H, masked, and the new h of those units into the
// block's own h tile (no other block writes those columns); (3) those
// columns written into the 7 other blocks' h tiles through distributed
// shared memory, 16 bytes a store (push). Two split cluster barriers a step
// order the exchange: every block is done reading its h tile before any
// block writes into it, and every write has landed before the next
// product; the cell update runs between an arrive and its wait. The next step's xp is prefetched into L2 before each product and
// loaded after it, so no register holds it across the product.
//
// K3b's design: tensor cores in 3xTF32 (mma_tf32.cuh), W_hh resident. A
// thread-block cluster of 8 blocks owns 32 rows for all T steps; block q owns
// hidden units q*U .. q*U + U - 1 (U = Hp/8) of every gate and keeps W_hh's
// columns of those units (Hp x 4U, 54 KB at H = 140) in shared memory for the
// whole launch, so W_hh is read from L2 once a block, not twice a step. A
// step: (1) the gate sums of the block's columns, h_prev times the resident
// slice (h_prev arrives by cp.async during the step before; the cell's
// inputs xp, c_prev, dhs are loaded to registers before the product);
// (2) the cell's backward for the block's units, one thread an element, dc
// carried in registers; (3) the block's partial dh_next of all Hp units,
// dgates (its columns) times the same slice read transposed; (4) each block
// sums its own units' dh_next from the 8 blocks' partials through
// distributed shared memory, in rank order (deterministic). Two split
// cluster barriers a step order the exchange; the work between an arrive and
// its wait hides its latency. At the flagship's Hp = 160 a block takes
// 106 KB, so two fit an SM. Each gate block is zero-padded on
// its own to Hp = 32*TN (the host pads W_hh to (Hp, 4Hp)): padded units keep
// c = 0, h = 0 and dgates = 0. xp, hs, cs, dhs and dxp are read and written at
// their own width H, masked; rows past B are computed on zeros and not
// stored. dW_hh is the TPU kernel's per-tile VMEM sum made deterministic:
// after the recurrence, atb.cuh's tensor-core A^T B pass forms h_prev^T dxp
// over the (T-1) B rows that have an h_prev (time-major, they are one
// contiguous block of hs and of dxp), in fixed row chunks of at most 2048
// rows whose partial products a last kernel adds in a fixed order: no
// atomics. expf/tanhf without fast-math; sigmoid = 1/(1+exp(-x)).

#include <cooperative_groups.h>

#include "atb.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bcnf;

// dW_hh's row chunks: at most kMaxSplit of at least kSplitRows rows. Each
// block of atb_kernel sums its chunk's rows one after the other; short
// chunks keep that float32 sum's rounding at ~1e-6 of the grad's scale
// (119k rows in 58 chunks at the flagship's batch 4096).
constexpr int kMaxSplit = 64;
constexpr int kSplitRows = 2048;

// K3a (K3b): a cluster of kCluster blocks owns kFwdRows (kBwdRows) rows.
constexpr int kCluster = 8;
constexpr int kFwdRows = 64;
constexpr int kBwdRows = 32;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// barrier.cluster in two halves: arrive (release) and wait (acquire). Every
// thread of the cluster's blocks alternates the two.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }
// *p = v in the shared memory of block `rank` of the cluster, p being the
// same variable's address in this block's.
__device__ __forceinline__ void st_cluster_f4(float* p, int rank, float4 v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void prefetch_l2(const float* p) { asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p)); }

// K3a's shared-memory layout for Hp = 32*TN; the leading dimensions keep
// the fragment loads and the exchange's stores free of bank conflicts.
template <int TN>
struct FwdShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int U = Hp / kCluster;  // units a block owns in each gate: 4 TN, TN quads of 4
  static constexpr int NG = 4 * U;         // its gate columns: a pair of n-tiles a quad
  static constexpr int ldw = NG + 8;       // w_s: Hp x NG
  static constexpr int ldh = Hp + 4;       // h_s: kFwdRows x Hp
  static constexpr int QW = (TN + 1) / 2;  // quads of a warp, at most (warps 0-3: quads 0, 2, ..; 4-7: 1, 3, ..)
  static constexpr size_t smem =
      sizeof(float) * (static_cast<size_t>(Hp) * ldw + static_cast<size_t>(kFwdRows) * ldh);
  // two blocks an SM where their shared memory fits (the flagship's Hp = 160
  // and t_DLSTM_large's 128): registers are then capped at 128 a thread
  static constexpr int kMinBlocks = 2 * smem <= 226 * 1024 ? 2 : 1;
};

template <int TN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, FwdShape<TN>::kMinBlocks)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh, float* __restrict__ hs,
                float* __restrict__ cs, int T, int B, int H, int reverse) {
  using S = FwdShape<TN>;
  constexpr int Hp = S::Hp, U = S::U, NG = S::NG, QW = S::QW, R = kFwdRows;
  const int G = 4 * H;
  const int Kp = (H + 7) & ~7;  // the product's depth: h's padded units are 0

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / kCluster) * R;

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // the block's gate columns of W_hh, resident
  float* h_s = w_s + Hp * S::ldw;                // h of the step before, all Hp units of the cluster's rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, nq = warp >> 2;  // the warp's m-tile (16 rows) and its first quad
  const int nb = 2 * ((TN - nq + 1) / 2);   // its n-tiles: the pairs of quads nq, nq + 2, ...

  // the block's columns of W_hh (H, 4H), zero-padded to Hp rows and units,
  // in the order that gives a thread all four gates of its units: column
  // 16 p + 8 tile + 2 t + e of w_s is gate 2 tile + e of unit rank*U + 4 p + t
  for (int e = tid; e < Hp * NG; e += kThreads) {
    const int k = e / NG, n = e % NG;
    const int u = rank * U + 4 * (n / 16) + n / 2 % 4, gate = 2 * (n / 8 % 2) + n % 2;
    w_s[k * S::ldw + n] = k < H && u < H ? w_hh[static_cast<size_t>(k) * G + gate * H + u] : 0.0f;
  }
  for (int e = tid; e < R * S::ldh; e += kThreads) h_s[e] = 0.0f;

  // The thread's cells: quad i (p = nq + 2 i), rows 16 mt + g + 8 r of the
  // cluster's tile, unit rank*U + 4p + t4, c carried in registers. Their
  // xp of step tau: the gate q of cell (i, r) at xp_at(tau, i, r) + q H.
  float c[QW][2];
  auto cell_ok = [&](int i, int r) {
    return nq + 2 * i < TN && row0 + 16 * mt + g + 8 * r < B && rank * U + 4 * (nq + 2 * i) + t4 < H;
  };
  auto xp_at = [&](int tau, int i, int r) {
    const int t = reverse ? T - 1 - tau : tau;
    return xp + (static_cast<size_t>(t) * B + row0 + 16 * mt + g + 8 * r) * G + rank * U + 4 * (nq + 2 * i) + t4;
  };
#pragma unroll
  for (int i = 0; i < QW; ++i) c[i][0] = c[i][1] = 0.0f;
  __syncthreads();

  for (int tau = 0; tau < T; ++tau) {
    const int t = reverse ? T - 1 - tau : tau;
    // the next step's xp into L2 now, so that its loads after that step's
    // product are short; no registers held across the product
    if (tau + 1 < T) {
#pragma unroll
      for (int i = 0; i < QW; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (cell_ok(i, r)) {
#pragma unroll
            for (int q = 0; q < 4; ++q) prefetch_l2(xp_at(tau + 1, i, r) + q * H);
          }
    }
    // (1) the gate sums of the block's columns: h (R x Hp) @ w_s (Hp x NG);
    // zero at the first step (h = 0)
    float acc[1][2 * QW][4] = {};
    if (tau > 0) {
      cluster_wait();  // (B) every block's h of the step before is in h_s
#pragma unroll 2
      for (int k0 = 0; k0 < Kp; k0 += 8) {
        const FragA fa[1] = {load_a_rowmajor(h_s + 16 * mt * S::ldh + k0, S::ldh, lane)};
        FragB fb[2 * QW];
#pragma unroll
        for (int j = 0; j < 2 * QW; ++j)
          if (j < nb) fb[j] = load_b_kmajor(w_s + k0 * S::ldw + 8 * (2 * (nq + 2 * (j / 2)) + j % 2), S::ldw, lane);
        mma_3xtf32(acc, fa, fb, nb);
      }
    }
    cluster_arrive();  // (A) done reading h_s
    __syncthreads();   // ... this block's warps too: its own units' columns take the new h

    // (2) the cell update: i, f in the quad's first n-tile, g, o in its second
    float xg[QW][2][4];
#pragma unroll
    for (int i = 0; i < QW; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[i][r][q] = cell_ok(i, r) ? xp_at(tau, i, r)[q * H] : 0.0f;
#pragma unroll
    for (int i = 0; i < QW; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool valid = cell_ok(i, r);
        const float ig = sigmoid_f(acc[0][2 * i][2 * r] + xg[i][r][0]);
        const float f = sigmoid_f(acc[0][2 * i][2 * r + 1] + xg[i][r][1]);
        const float gg = tanhf(acc[0][2 * i + 1][2 * r] + xg[i][r][2]);
        const float o = sigmoid_f(acc[0][2 * i + 1][2 * r + 1] + xg[i][r][3]);
        c[i][r] = f * c[i][r] + ig * gg;
        const float h = valid ? o * tanhf(c[i][r]) : 0.0f;
        if (nq + 2 * i < TN) h_s[(16 * mt + g + 8 * r) * S::ldh + rank * U + 4 * (nq + 2 * i) + t4] = h;
        if (valid) {
          const size_t s0 = (static_cast<size_t>(t) * B + row0 + 16 * mt + g + 8 * r) * H + rank * U +
                            4 * (nq + 2 * i) + t4;
          hs[s0] = h;
          cs[s0] = c[i][r];
        }
      }
    __syncthreads();  // this block's units of the new h are in its h_s
    cluster_wait();   // (A) every block is done reading its h_s
    if (tau + 1 == T) break;

    // (3) those units into the 7 other blocks' h_s, 16 bytes a store, each
    // block starting at the next rank
    for (int e = tid; e < (kCluster - 1) * R * (U / 4); e += kThreads) {
      const int q = (rank + 1 + e / (R * U / 4)) % kCluster, r = e % (R * U / 4) / (U / 4), j = e % (U / 4) * 4;
      float* p = h_s + r * S::ldh + rank * U + j;
      st_cluster_f4(p, q, *reinterpret_cast<const float4*>(p));
    }
    cluster_arrive();  // (B) this block's h has landed everywhere
  }
}

// K3b's shared-memory layout for Hp = 32*TN; the leading dimensions keep the
// fragment loads free of bank conflicts (or at most two-way).
template <int TN>
struct BwdShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int U = Hp / kCluster;  // units a block owns in each gate: 4 TN
  static constexpr int NG = 4 * U;         // its gate columns
  static constexpr int ldw = NG + 4;       // w_s: Hp x NG, W_hh's column g*Hp + rank*U + j as g*U + j
  static constexpr int ldh = Hp + 4;       // h_s: kBwdRows x Hp
  static constexpr int ldg = NG + 4;       // dg_s: kBwdRows x NG
  static constexpr int ldp = Hp + 4;       // part_s: kBwdRows x Hp
  static constexpr int E = (kBwdRows * U + kThreads - 1) / kThreads;  // cell elements of a thread
  static constexpr size_t smem =
      sizeof(float) * (static_cast<size_t>(Hp) * ldw + static_cast<size_t>(kBwdRows) * (ldh + ldg + ldp));
  // two blocks an SM where their shared memory fits (the flagship's Hp = 160
  // and t_DLSTM_large's 128): registers are then capped at 128 a thread
  static constexpr int kMinBlocks = 2 * smem <= 226 * 1024 ? 2 : 1;
};

template <int TN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, BwdShape<TN>::kMinBlocks)
lstm_bwd_kernel(const float* __restrict__ xp, const float* __restrict__ wp, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ dhs, float* __restrict__ dxp,
                int T, int B, int H, int reverse) {
  using S = BwdShape<TN>;
  constexpr int Hp = S::Hp, U = S::U, NG = S::NG, BM = kBwdRows;
  constexpr int NTG = NG / 8;        // n-tiles of the gate product: 2 TN
  constexpr int PG = (NTG + 3) / 4;  // ... of one warp
  const int G = 4 * H;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / kCluster) * BM;
  const int rows = B - row0 < BM ? B - row0 : BM;  // the cluster's rows inside the batch

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // the block's columns of W_hh, resident
  float* h_s = w_s + Hp * S::ldw;                // h_prev, all Hp units
  float* dg_s = h_s + BM * S::ldh;               // the gate sums, then dgates, of the block's columns
  float* part_s = dg_s + BM * S::ldg;            // dgates (block's columns) W_hh^T: partial dh_next

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 1, nq = warp >> 1;  // a warp's m-tile, and its first n-tile (then every 4th)

  for (int e = tid; e < Hp * NG / 4; e += kThreads) {
    const int k = e / (NG / 4), c = (e % (NG / 4)) * 4;
    cp_async16(w_s + k * S::ldw + c, wp + static_cast<size_t>(k) * 4 * Hp + (c / U) * Hp + rank * U + c % U);
  }
  cp_async_commit();
  for (int e = tid; e < BM * S::ldh; e += kThreads)
    if (e % S::ldh >= H || e / S::ldh >= rows) h_s[e] = 0.0f;  // padded units, rows past B: h_prev = 0

  // h_prev of step tau into h_s, asynchronously (the caller waits): the
  // cluster's rows of hs at the forward step before (one contiguous block of
  // hs), zeros at the forward's first step
  auto load_h = [&](int tau) {
    const int t = reverse ? tau : T - 1 - tau;
    if (t == (reverse ? T - 1 : 0)) {
      for (int e = tid; e < rows * H; e += kThreads) h_s[(e / H) * S::ldh + e % H] = 0.0f;
      return;
    }
    const float* src = hs + (static_cast<size_t>(reverse ? t + 1 : t - 1) * B + row0) * H;
    if ((H & 3) == 0) {
      for (int e = tid; e < rows * (H / 4); e += kThreads) {
        const int r = e / (H / 4), u = (e % (H / 4)) * 4;
        cp_async16(h_s + r * S::ldh + u, src + r * H + u);
      }
    } else {
      for (int e = tid; e < rows * H; e += kThreads) cp_async4(h_s + (e / H) * S::ldh + e % H, src + e);
    }
  };
  load_h(0);
  cp_async_commit();

  float dc_next[S::E];
#pragma unroll
  for (int i = 0; i < S::E; ++i) dc_next[i] = 0.0f;

  cluster_arrive();  // (1) every block of the cluster has started
  for (int tau = 0; tau < T; ++tau) {
    const int t = reverse ? tau : T - 1 - tau;     // the opposite order of the forward
    const bool first = t == (reverse ? T - 1 : 0);  // the forward's first step
    const int tp = reverse ? t + 1 : t - 1;

    // the cell's inputs from global memory (xp, c_prev, dhs), loaded now so
    // that their latency hides behind the gate product
    float xg[S::E][4], cpv[S::E], dhv[S::E];
#pragma unroll
    for (int i = 0; i < S::E; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / U, u = rank * U + e % U, row = row0 + r;
      const bool valid = e < BM * U && row < B && u < H;
      const size_t x0 = (static_cast<size_t>(t) * B + row) * G + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[i][q] = valid ? xp[x0 + q * H] : 0.0f;
      cpv[i] = valid && !first ? cs[(static_cast<size_t>(tp) * B + row) * H + u] : 0.0f;
      dhv[i] = valid ? dhs[(static_cast<size_t>(t) * B + row) * H + u] : 0.0f;
    }
    cp_async_wait<0>();  // h_prev (and, at the first step, w_s) has landed
    __syncthreads();

    // the gate sums of the block's columns: h_prev (BM x Hp) @ w_s (Hp x NG)
    const int pg = (NTG - nq + 3) / 4;  // the warp's n-tiles: nq, nq + 4, ...
    float acc[1][PG][4] = {};
#pragma unroll 4
    for (int k0 = 0; k0 < Hp; k0 += 8) {
      const FragA fa[1] = {load_a_rowmajor(h_s + 16 * mt * S::ldh + k0, S::ldh, lane)};
      FragB fb[PG];
#pragma unroll
      for (int i = 0; i < PG; ++i)
        if (i < pg) fb[i] = load_b_kmajor(w_s + k0 * S::ldw + 8 * (nq + 4 * i), S::ldw, lane);
      mma_3xtf32(acc, fa, fb, pg);
    }
#pragma unroll
    for (int i = 0; i < PG; ++i) {
      if (i < pg) {
        float* d = dg_s + (16 * mt + g) * S::ldg + 8 * (nq + 4 * i) + 2 * t4;
        d[0] = acc[0][i][0];
        d[1] = acc[0][i][1];
        d[8 * S::ldg] = acc[0][i][2];
        d[8 * S::ldg + 1] = acc[0][i][3];
      }
    }
    __syncthreads();  // the gate sums are complete; h_s is free
    if (tau + 1 < T) {
      load_h(tau + 1);  // the next step's h_prev lands behind this step's cell and partial product
      cp_async_commit();
    }
    cluster_wait();  // (1) the other blocks' partials of the step before are in their part_s

    // the cell's backward, one thread an element (row r, unit j of the block)
#pragma unroll
    for (int i = 0; i < S::E; ++i) {
      const int e = tid + kThreads * i;
      if (e < BM * U) {
        const int r = e / U, j = e % U, u = rank * U + j, row = row0 + r;
        const bool valid = row < B && u < H;
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] = dg_s[r * S::ldg + q * U + j] + xg[i][q];
        float dh_next = 0.0f;
        if (tau > 0) {  // the 8 blocks' partials in rank order
#pragma unroll
          for (int q = 0; q < kCluster; ++q) dh_next += cluster.map_shared_rank(part_s, q)[r * S::ldp + u];
        }
        const float c_prev = cpv[i];
        const float ig = sigmoid_f(gate[0]);
        const float f = sigmoid_f(gate[1]);
        const float gg = tanhf(gate[2]);
        const float o = sigmoid_f(gate[3]);
        const float cc = f * c_prev + ig * gg;
        const float tc = tanhf(cc);
        const float dh = dhv[i] + dh_next;
        const float dout = dh * tc;
        const float dc = dh * o * (1.0f - tc * tc) + dc_next[i];
        float dg[4] = {dc * gg * ig * (1.0f - ig), dc * c_prev * f * (1.0f - f), dc * ig * (1.0f - gg * gg),
                       dout * o * (1.0f - o)};
        const size_t x0 = (static_cast<size_t>(t) * B + row) * G + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!valid) dg[q] = 0.0f;
          dg_s[r * S::ldg + q * U + j] = dg[q];
          if (valid) dxp[x0 + q * H] = dg[q];
        }
        dc_next[i] = valid ? dc * f : 0.0f;
      }
    }
    cluster_arrive();  // (2) done reading the other blocks' part_s
    if (tau == T - 1) {
      cluster_wait();  // no block leaves while another may still read its part_s
      break;
    }
    __syncthreads();  // dgates complete in dg_s

    // the block's partial dh_next of all units: dgates (BM x NG) @ w_s^T (NG x Hp)
    float pacc[1][TN][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < NG; k0 += 8) {
      const FragA fa[1] = {load_a_rowmajor(dg_s + 16 * mt * S::ldg + k0, S::ldg, lane)};
      FragB fb[TN];
#pragma unroll
      for (int i = 0; i < TN; ++i) fb[i] = load_b_nmajor(w_s + 8 * (nq + 4 * i) * S::ldw + k0, S::ldw, lane);
      mma_3xtf32(pacc, fa, fb);
    }
    cluster_wait();  // (2) every block has read its units from part_s
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      float* d = part_s + (16 * mt + g) * S::ldp + 8 * (nq + 4 * i) + 2 * t4;
      d[0] = pacc[0][i][0];
      d[1] = pacc[0][i][1];
      d[8 * S::ldp] = pacc[0][i][2];
      d[8 * S::ldp + 1] = pacc[0][i][3];
    }
    cluster_arrive();  // (1) part_s holds this step's partials
  }
}

// out[i] = sum_p parts[p * n + i], p in order: the split dW_hh pass's sum.
__global__ void sum_parts_kernel(const float* __restrict__ parts, int n_parts, int n,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < n_parts; ++p) s += parts[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

template <int TN>
cudaError_t launch_fwd(const float* xp, const float* w_hh, float* hs, float* cs, int T, int B, int H, int reverse,
                       cudaStream_t stream) {
  using S = FwdShape<TN>;
  static_assert(S::smem <= kSmemLimit, "K3a's shared memory exceeds a block's");
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::smem));
  if (err != cudaSuccess) return err;
  const int clusters = (B + kFwdRows - 1) / kFwdRows;
  lstm_fwd_kernel<TN><<<clusters * kCluster, kThreads, S::smem, stream>>>(xp, w_hh, hs, cs, T, B, H, reverse);
  return cudaGetLastError();
}

// K3a's launch at batch B: out = {rows a cluster, clusters, clusters the card
// holds at once}; the waves are clusters over the last.
template <int TN>
cudaError_t fwd_layout(int B, int* out) {
  using S = FwdShape<TN>;
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::smem));
  if (err != cudaSuccess) return err;
  const int clusters = (B + kFwdRows - 1) / kFwdRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::smem;
  out[0] = kFwdRows;
  out[1] = clusters;
  return cudaOccupancyMaxActiveClusters(&out[2], reinterpret_cast<const void*>(lstm_fwd_kernel<TN>), &cfg);
}

template <int TN>
cudaError_t launch_bwd(const float* xp, const float* wp, const float* hs, const float* cs,
                       const float* dhs, float* dxp, int T, int B, int H, int reverse,
                       cudaStream_t stream) {
  using S = BwdShape<TN>;
  static_assert(S::smem <= kSmemLimit, "K3b's shared memory exceeds a block's");
  cudaError_t err = cudaFuncSetAttribute(lstm_bwd_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::smem));
  if (err != cudaSuccess) return err;
  const int clusters = (B + kBwdRows - 1) / kBwdRows;
  lstm_bwd_kernel<TN><<<clusters * kCluster, kThreads, S::smem, stream>>>(xp, wp, hs, cs, dhs, dxp, T, B,
                                                                          H, reverse);
  return cudaGetLastError();
}

int n_split(int T, int B) {
  const long long rows = static_cast<long long>(T - 1) * B;
  const long long n = (rows + kSplitRows - 1) / kSplitRows;
  return n < 1 ? 1 : (n > kMaxSplit ? kMaxSplit : static_cast<int>(n));
}

#define BCNF_LSTM_CASES(CALL)              \
  switch (Hp / 32) {                       \
    case 1: CALL(1)                        \
    case 2: CALL(2)                        \
    case 3: CALL(3)                        \
    case 4: CALL(4)                        \
    case 5: CALL(5)                        \
    case 6: CALL(6)                        \
    case 7: CALL(7)                        \
    case 8: CALL(8)                        \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace

// C entry points, loaded with ctypes. Hp (the per-gate padded width) must be
// 32*TN for a compiled TN (1..8) with H <= Hp. Each returns the cudaError_t
// of its launches.

// K3a: hs, cs (T, B, H) of one direction from xp (T, B, 4H) and W_hh
// (H, 4H) as they are.
extern "C" int bcnf_lstm_fwd(const float* xp, const float* w_hh, float* hs, float* cs, int T, int B, int H,
                             int Hp, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > Hp || Hp % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CALL(TN) return launch_fwd<TN>(xp, w_hh, hs, cs, T, B, H, reverse, st);
  BCNF_LSTM_CASES(BCNF_CALL)
#undef BCNF_CALL
}

// K3a's layout at batch B (out: rows a cluster, clusters, clusters resident
// at once), for the smoke run's wave count.
extern "C" int bcnf_lstm_fwd_layout(int B, int Hp, int* out) {
  if (B <= 0 || Hp % 32 != 0) return cudaErrorInvalidValue;
#define BCNF_CALL(TN) return fwd_layout<TN>(B, out);
  BCNF_LSTM_CASES(BCNF_CALL)
#undef BCNF_CALL
}

// K3b, part 1, the recurrence: dxp (T, B, 4H) from the forward's xp, hs, cs
// and the cotangent dhs (T, B, H); wp is W_hh padded per gate to (Hp, 4Hp).
extern "C" int bcnf_lstm_bwd_rec(const float* xp, const float* wp, const float* hs, const float* cs,
                                 const float* dhs, float* dxp, int T, int B, int H, int Hp, int reverse,
                                 void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > Hp || Hp % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CALL(TN) return launch_bwd<TN>(xp, wp, hs, cs, dhs, dxp, T, B, H, reverse, st);
  BCNF_LSTM_CASES(BCNF_CALL)
#undef BCNF_CALL
}

// Floats of scratch `bcnf_lstm_bwd_dw` needs (the wrapper allocates it).
extern "C" long long bcnf_lstm_bwd_scratch(int T, int B, int H) {
  const int n = n_split(T, B);
  return n > 1 ? static_cast<long long>(n) * H * 4 * H : 0;
}

// K3b, part 2: dW_hh (H, 4H) = h_prev^T dgates over the (T-1) B rows that
// have an h_prev, from hs and part 1's dxp.
extern "C" int bcnf_lstm_bwd_dw(const float* hs, const float* dxp, float* dw, float* scratch, int T, int B,
                                int H, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = 4 * H;
  const size_t skip = static_cast<size_t>(B);  // the first step's rows, in forward order
  const int rows = (T - 1) * B;
  const int n = n_split(T, B);
  const int chunk = rows > n ? (rows + n - 1) / n : 1;
  const AtbJob job = {reverse ? hs + skip * H : hs, reverse ? dxp : dxp + skip * G, n > 1 ? scratch : dw,
                      nullptr, H, G, H, G, rows, chunk};
  cudaError_t err = launch_atb(&job, 1, st);
  if (err != cudaSuccess) return err;
  const int parts = atb_chunks(job);
  if (n > 1) {
    sum_parts_kernel<<<(H * G + 255) / 256, 256, 0, st>>>(scratch, parts, H * G, dw);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// The A^T B pass of atb.cuh alone, for the tests: c (ceil(k / chunk), m, n)
// partial products of a (k, m) and b (k, n), and sums (same count, n) the
// partial column sums of b (not written when null).
extern "C" int bcnf_atb(const float* a, const float* b, float* c, float* sums, int lda, int ldb, int m, int n,
                        int k, int chunk, void* stream) {
  if (m < 0 || n <= 0 || k < 0 || chunk < 1) return cudaErrorInvalidValue;
  const AtbJob job = {a, b, c, sums, lda, ldb, m, n, k, chunk};
  return launch_atb(&job, 1, static_cast<cudaStream_t>(stream));
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
