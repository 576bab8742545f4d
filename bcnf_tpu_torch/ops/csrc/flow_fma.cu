// K1 in exact float32 on the FMA pipe (the strict mode, `pallas_strict`):
// the whole conditional RealNVP flow, forward or inverse, in one launch,
// every product and every sum in float32, no tensor-core instruction; and
// the strict K2a, the same forward storing each step's input rows and
// keeping, for the strict K2b, each layer's activations and gelu' and each
// step's s (`fma_keep_act`, `fma_keep_s`).
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow at precision="highest"
// (the Pallas TPU kernel `_flow_kernel` in its exact-float32 mode), which the
// JAX model's strict flag selects (bcnf_tpu/models/cnf.py), and `fwd_call`
// of `_make_fused_flow_train` at precision="highest" (K2a,
// `_flow_fwd_train_kernel`). Host side and plain PyTorch versions:
// bcnf_tpu_torch/ops/flow_kernel.py (`fused_flow` and `fused_flow_train_fwd`
// with mode=MODE_FMA, `fused_flow_reference`, `fused_flow_train_reference`,
// `fma_layout`). K1's kernel (`fma_flow_kernel`) and K2a's
// (`fma_flow_train_kernel`, with kBound) share one body, `fma_flow`; K1's
// SASS is its own kernel's as before the store was added. The strict K2b
// (flow_train_fma.cu) includes the device parts of this file, above
// `BCNF_FMA_DEVICE_ONLY`.
//
// What it computes, for every row r (conditioned on h_proj[k, r % N]):
//   forward: for k = 0 .. S-1: ActNorm, coupling, x <- x Q_k (steps < S-1);
//            logdet = sum log|s_an| + sum s;
//   inverse: for k = S-1 .. 0: x <- x Q_k^T (steps < S-1), coupling^-1,
//            ActNorm^-1;
// the coupling on x = [x_a | x_b] being a = gelu(x_a W1y + b1 + h_proj),
// a = gelu(a Wm_l + bm_l) for each hidden layer, [t | s'] = a Wout + bout,
// s = tanh(s'), x_b <- exp(s) x_b + t (forward) or (x_b - t) exp(-s).
// GELU is the tanh form, as jax.nn.gelu and the Pallas kernel compute it.
//
// What bounds it on an H100: operations. At the flagship widths (H 526, 4
// hidden layers, 26 steps) a row costs 58.3 MFLOP, 98.7% of it in the
// square hidden products, at the float32 FMA rate (66.9 TFLOP/s, 128 FMA a
// clock and SM); the ~124 MB of weights are shared by every row.
//
// Design (each point answers a measurement of the first strict kernel or of
// this one's other builds: PERF.md, `tools/strict_flow_parts.py`).
// - A round is 8R rows (R = 4: 32 rows; R = 2 above Hp 544): two row groups
//   of 4R rows, each computed by 4 warps, one a quarter of the Hp = 32 TN
//   hidden columns. A lane owns R rows of its group (by lane / 8) and TN
//   columns of its warp's quarter (4-column groups 32 q + 4 (lane % 8), then
//   single columns 32 Q4 + 8 i + lane % 8): R x TN accumulators, 68 at the
//   flagship. A k-step is one 16-byte load of the lane's rows' activations
//   and TN / 4 16-byte loads and TN % 4 single ones of its weights, beside
//   R TN FMAs: 6 loads for 68 FMAs (the first kernel: 19 for 136). Shared
//   memory serves these loads in R + TN passes a warp, 21 for 68 FMAs, near
//   what it serves at the FMA rate: taking the weights' loads out saves 15
//   of 120 ms. 8 rows a lane would halve that, but its 136 accumulators
//   spill at the 168 registers a thread of a 12-warp block (9 warps get no
//   more: the register file is handed out to warps in fours), and a block of
//   8 warps (255 registers) issuing its own copies took 162 ms.
// - Activations stay in shared memory, transposed (actT[k][row], row stride
//   8R + 4). The 4 warps of a row group hand a layer's activations over
//   through a named barrier of their 128 threads (before its epilogue
//   overwrites the tile, and after); nothing else is block-wide.
// - Weights stream through a ring of stages in shared memory (2-6 stages of
//   16 weight rows, 8 above Hp 544, as many as the shared memory holds: 4 at
//   the flagship's shape; 16-row stages halve the hand-offs of 8-row ones,
//   -5%), filled by a producer warpgroup, one thread of which issues bulk
//   copies (`cp.async.bulk`) completing on each stage's full mbarrier; every
//   consumer warp waits on a stage's full barrier and, when done, arrives on
//   its empty barrier (CTA scope). W1y (the input layer), the Wm and Wout
//   (the output layer) of every step pass through the ring in the order
//   they are used. The block is 12 warps, compiled to 168 registers a
//   thread.
// - The output layer (2 d_b columns) and the row work (ActNorm, the mixes,
//   the affine update) take R rows a warp: 32 / R lanes share a row in the
//   output layer, each summing every (32 / R)-th k for up to 24 columns at
//   once; xor shuffles (a fixed tree) add the parts, and the sums of
//   successive stages are added to [t | s'] in stage order.
// - Persistent blocks, one an SM: the ceil(B / 4R) row groups are split into
//   one contiguous range a block (sizes differ by at most one); a block walks
//   its range in rounds of 2 groups, the ring streaming the weights once a
//   round. A round with one group leaves its other 4 warps idle (they still
//   pass the ring's stages).
// - No atomics, and every sum in a fixed order: two calls give equal bits.
// - K2a's keep (2(nh + 1) S B Hp floats of h and gelu', 2.32 GB at the
//   flagship's 4096 rows, 0.69 ms of bytes beside the 3.57 ms of products)
//   leaves the epilogue without holding its registers or global addresses.
//   h is already in the tile: the producer warpgroup's other 3 warps (the
//   keepers) store each row group's rows of it to the keep during the next
//   layer's products, handed the tile through named barriers (ready after
//   the epilogue, free before the next one writes it). gelu' goes into 2
//   ring stages that the producer hands out as staging slots after each
//   layer's products (a stage holds a row group's rows of one layer,
//   column-major as the keep lays gelu' out, so the epilogue writes each
//   column's rows at once, with no buffer); the producer puts the next
//   layer's first stages on their way into the ring's other slots, then
//   copies each written slot to the keep with one bulk store (`cp.async.bulk`
//   shared -> global) and waits for the store to have read it
//   (`wait_group.read`) before it takes the slot again. (Storing from the epilogue's registers, `__stcs` a
//   row, spilled 228 bytes and took 1.0-1.1 ms that overlapped nothing;
//   handing out 4 slots for h and gelu' kept the next layer's first stages
//   from loading until the stores had read them.)
//
// The hidden width is zero-padded to Hp by the host (exact: padded units
// stay 0 because gelu(0) = 0). Rows past B in a ragged group are computed
// on zeros and not stored. nh may be 0 (K4 of a coupling with one hidden
// layer runs as K1 at one step). The weights, b1, bm and h_proj must be
// 16-byte aligned (they are read 16 bytes at a time).

#include "flow_common.cuh"
#include "wgmma_tf32.cuh"  // the mbarriers and bulk copies (no tensor-core product is used here)

namespace {

using namespace bcnf;

constexpr int kFmaWarps = 8;                      // consumer warps: 2 row groups x 4 column quarters
constexpr int kFmaConsumers = 32 * kFmaWarps;
constexpr int kFmaThreads = kFmaConsumers + 128;  // and a producer warpgroup (one thread issues)
constexpr int kFmaLaneRows = 4;                   // rows a lane (a round: 8 x that)
constexpr int kFmaWideTN = 17;                    // above this TN: half the rows a lane, half-size stages
constexpr int kFmaStageRows = 16;                 // weight rows a ring stage
constexpr int kFmaRingMin = 2;                    // stages of the weight ring
constexpr int kFmaRingMax = 6;
constexpr int kFmaOutPairs = 12;                  // output columns a lane sums at once, in pairs
constexpr int kFmaKeepers = 96;                   // K2a: the producer warpgroup's other 3 warps store h
constexpr int kFmaHandOff = 128 + kFmaKeepers;    // a row group's warps and the keepers, at the tile's hand-offs
constexpr int kFmaReady = 3, kFmaFree = 5;        // their named barriers, + the row group (1, 2: group_sync)

// Rows a lane, and floats a ring stage holds (its weight rows, and at least
// 4 rows of Wout), at TN.
__host__ __device__ constexpr int fma_lane_rows(int TN) { return TN > kFmaWideTN ? kFmaLaneRows / 2 : kFmaLaneRows; }
__host__ __device__ constexpr int fma_stage(int TN, int size, int d_a) {
  return (TN > kFmaWideTN ? kFmaStageRows / 2 : kFmaStageRows) * 32 * TN > 8 * (size - d_a)
             ? (TN > kFmaWideTN ? kFmaStageRows / 2 : kFmaStageRows) * 32 * TN
             : 8 * (size - d_a);
}

// Shared memory a block takes: the ring's two barriers a stage, the
// transposed tile, the ring, and the round's rows of [x | x Q | t s' | logdet].
__host__ __device__ constexpr size_t fma_smem(int TN, int size, int d_a, int stages) {
  return 16 * static_cast<size_t>(stages) +
         sizeof(float) * (static_cast<size_t>(32 * TN) * (8 * fma_lane_rows(TN) + 4) +
                          static_cast<size_t>(stages) * fma_stage(TN, size, d_a) +
                          static_cast<size_t>(8 * fma_lane_rows(TN)) * (4 * size - 2 * d_a + 1));
}

template <int TN>
struct FmaShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int R = fma_lane_rows(TN);  // rows a lane
  static constexpr int G = 4 * R;              // rows a row group
  static constexpr int BM = 2 * G;             // rows a round
  static constexpr int ldT = BM + 4;           // row stride of the transposed tile
  static constexpr int BK = TN > kFmaWideTN ? kFmaStageRows / 2 : kFmaStageRows;  // weight rows a stage
  static constexpr int QW = 8 * TN;            // columns of a warp's quarter
  static constexpr int Q4 = TN / 4, Q1 = TN % 4;
  // the hidden column of a lane's j-th accumulator (lc = lane % 8) in quarter cq
  static __device__ __forceinline__ int col(int j, int cq, int lc) {
    return cq * QW + (j < 4 * Q4 ? 32 * (j / 4) + 4 * lc + j % 4 : 32 * Q4 + 8 * (j - 4 * Q4) + lc);
  }
};

// w[j] = row[col(j, cq, lc)]: TN / 4 16-byte loads, then TN % 4 single ones.
template <int TN>
__device__ __forceinline__ void load_cols(const float* row, int cq, int lc, float (&w)[TN]) {
  using Sh = FmaShape<TN>;
  row += cq * Sh::QW;
#pragma unroll
  for (int q = 0; q < Sh::Q4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(row + 32 * q + 4 * lc);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < Sh::Q1; ++i) w[4 * Sh::Q4 + i] = row[32 * Sh::Q4 + 8 * i + lc];
}

// a[r] = p[r] for the lane's R rows (16 or 8 bytes at once).
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
    static_assert(R == 2, "2 or 4 rows a lane");
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  }
}

template <int R, int TN>
__device__ __forceinline__ void fma_k(const float (&w)[TN], const float (&a)[R], float (&acc)[R][TN]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(a[r], w[j], acc[r][j]);
}

// acc[r][j] += sum_kk at[kk][r] ws[kk][col j] over a stage's BK weight rows;
// `at` is the lane's rows of the transposed tile at the stage's first k.
template <int R, int TN>
__device__ __forceinline__ void hidden_product(const float* ws, const float* at, float (&acc)[R][TN], int cq, int lc) {
  using Sh = FmaShape<TN>;
#pragma unroll
  for (int kk = 0; kk < Sh::BK; ++kk) {
    float w[TN], a[R];
    load_cols<TN>(ws + kk * Sh::Hp, cq, lc, w);
    load_rows<R>(at + kk * Sh::ldT, a);
    fma_k<R, TN>(w, a, acc);
  }
}

// acc[r][j] += sum_kk xa[r][kk] ws[kk][col j] over nk input rows of W1y; xa
// is the lane's rows of x at the stage's first input (row stride `size`).
template <int R, int TN>
__device__ __forceinline__ void input_product(const float* ws, int nk, const float* xa, int size, float (&acc)[R][TN],
                                              int cq, int lc) {
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    float w[TN], a[R];
    load_cols<TN>(ws + kk * 32 * TN, cq, lc, w);
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = xa[r * size + kk];
    fma_k<R, TN>(w, a, acc);
  }
}

// The lane's activations gelu(acc + bias) into its rows of the transposed
// tile (`at`: the tile at the lane's first row); bias may be null.
template <int R, int TN>
__device__ __forceinline__ void store_act(float* at, const float (&acc)[R][TN], const float* bias, int cq, int lc) {
  using Sh = FmaShape<TN>;
  float b[TN];
  if (bias != nullptr) {
    load_cols<TN>(bias, cq, lc, b);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = gelu_tanh(acc[r][j] + b[j]);
    float* dst = at + Sh::col(j, cq, lc) * Sh::ldT;
    if constexpr (R == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    }
  }
}

// The activations the strict K2a keeps for the strict K2b
// (flow_train_fma.cu), which then recomputes nothing of the MLP: for each
// step k, h_l = gelu(a_l) for l = 0 .. nh, then gelu'(a_l) for l = 0 .. nh,
// each of Bp = B rounded up to the row group (fma_keep_rows) x Hp floats: h
// row-major, gelu' a row group at a time (group g's G x Hp block at g G Hp,
// column-major and swizzled: keep_grad_at); rows past B hold what the
// kernel computes for them (the flow of a zero row, conditioned on
// h_proj[k, r % B]) and are never read; after
// every step's, the output layer's s = tanh(s') of every step (B x d_b
// each). Offsets in floats (the host's copy: ops/flow_kernel.py::
// fma_keep_floats).
__host__ __device__ inline int fma_keep_rows(int B, int Hp) {
  const int G = 4 * fma_lane_rows(Hp / 32);
  return (B + G - 1) / G * G;
}
__host__ __device__ inline size_t fma_keep_act(int k, int l, bool grad, int B, int nh, int Hp) {
  return ((static_cast<size_t>(k) * 2 + (grad ? 1 : 0)) * (nh + 1) + l) * fma_keep_rows(B, Hp) * Hp;
}
__host__ __device__ inline size_t fma_keep_s(int k, int B, int S, int nh, int Hp, int d_b) {
  return static_cast<size_t>(S) * 2 * (nh + 1) * fma_keep_rows(B, Hp) * Hp + static_cast<size_t>(k) * B * d_b;
}
__host__ __device__ inline size_t fma_keep_floats(int B, int S, int nh, int Hp, int d_b) {
  return fma_keep_s(S, B, S, nh, Hp, d_b);
}

// Where gelu' of column `col`, rows R rb .. R rb + R - 1 of a row group (rb
// = lane / 8 for the products' lanes), lies within the group's G x Hp block
// (of the keep, of K2a's staging slot, of K2b's ring stage), in floats:
// column-major in units of R rows, a column's 4 units together, each unit's
// index XOR-ed with (col / 4) % 8 (shifted up one at R = 2) within its
// aligned 8 units (16 at R = 2). The 8 lanes of one 16-byte shared-memory
// phase (16 lanes of an 8-byte one) take columns 4 apart: unswizzled they all
// meet one bank group, swizzled none meets another's. The host's copy:
// ops/flow_kernel.py::fma_keep_grad_at.
template <int R>
__host__ __device__ constexpr int keep_grad_at(int col, int rb) {
  return R * ((4 * col + rb) ^ (((col >> 2) & 7) << (R == 2 ? 1 : 0)));
}

// p[r] = v[r] for the lane's R rows (16 or 8 bytes at once).
template <int R>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// v[r] for the lane's R rows into column `col` of the transposed tile.
template <int R>
__device__ __forceinline__ void store_col(float* at, int col, int ldT, const float (&v)[R]) {
  float* dst = at + col * ldT;
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// store_act, keeping what the strict K2b reads: h = gelu(acc + bias) into
// the tile and gelu'(acc + bias) into the lane's rows (rb: lane / 8) of a
// staging slot of the ring, both column by column (`sg`: the row group's G x
// Hp block, laid out as the keep lays it out: keep_grad_at), which the
// producer then copies to the keep in bulk. bias may be null. h is
// store_act's value (gelu_and_grad: the same expression).
template <int R, int TN>
__device__ __forceinline__ void keep_act(float* at, const float (&acc)[R][TN], const float* bias, float* sg, int rb,
                                         int cq, int lc) {
  using Sh = FmaShape<TN>;
#pragma unroll
  for (int q = 0; q < Sh::Q4; ++q) {  // 4 adjacent columns, their bias in one load
    const int col = Sh::col(4 * q, cq, lc);
    const float4 b4 = bias != nullptr ? *reinterpret_cast<const float4*>(bias + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float h[R], g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) gelu_and_grad(acc[r][4 * q + c] + b[c], h[r], g[r]);
      store_col<R>(at, col + c, Sh::ldT, h);
      store_rows<R>(sg + keep_grad_at<R>(col + c, rb), g);
    }
  }
#pragma unroll
  for (int i = 0; i < Sh::Q1; ++i) {
    const int j = 4 * Sh::Q4 + i, col = Sh::col(j, cq, lc);
    const float b = bias != nullptr ? bias[col] : 0.0f;
    float h[R], g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gelu_and_grad(acc[r][j] + b, h[r], g[r]);
    store_col<R>(at, col, Sh::ldT, h);
    store_rows<R>(sg + keep_grad_at<R>(col, rb), g);
  }
}

// The warps of named barrier `id` (bar.sync waits for `n` threads' arrival;
// bar.arrive counts this thread's and goes on).
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- bulk stores, shared -> global (the keep's staged rows)

__device__ __forceinline__ void bulk_store_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until at most N of the issuing thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// This thread's shared-memory writes, before a bulk copy (the async proxy) reads them.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// outs[r][c] += sum_kk at[kk][r] ws[kk][c] over nk rows of Wout (n_out
// columns a row), for a warp's R rows: KQ = 32 / R lanes share a row, lane
// kq summing kk = kq, kq + KQ, ..; their parts are added by xor shuffles and
// the row's first lane adds the sum to outs.
template <int R>
__device__ __forceinline__ void output_product(const float* ws, int nk, const float* at, int ldT, float* outs,
                                               int n_out, int lane) {
  constexpr int KQ = 32 / R;
  const int r = lane / KQ, kq = lane % KQ;
  for (int c0 = 0; c0 < n_out; c0 += 2 * kFmaOutPairs) {
    const int np = min(kFmaOutPairs, (n_out - c0) / 2);
    float2 acc[kFmaOutPairs];
#pragma unroll
    for (int p = 0; p < kFmaOutPairs; ++p) acc[p] = make_float2(0.0f, 0.0f);
#pragma unroll 2
    for (int kk = kq; kk < nk; kk += KQ) {
      const float a = at[kk * ldT + r];
      const float2* wr = reinterpret_cast<const float2*>(ws + kk * n_out + c0);
#pragma unroll
      for (int p = 0; p < kFmaOutPairs; ++p) {
        if (p < np) {
          const float2 w = wr[p];
          acc[p].x = fmaf(a, w.x, acc[p].x);
          acc[p].y = fmaf(a, w.y, acc[p].y);
        }
      }
    }
#pragma unroll
    for (int off = KQ / 2; off > 0; off /= 2) {
#pragma unroll
      for (int p = 0; p < kFmaOutPairs; ++p) {
        acc[p].x += __shfl_xor_sync(0xffffffffu, acc[p].x, off);
        acc[p].y += __shfl_xor_sync(0xffffffffu, acc[p].y, off);
      }
    }
    if (kq == 0) {
#pragma unroll
      for (int p = 0; p < kFmaOutPairs; ++p) {
        if (p < np) {
          outs[r * n_out + c0 + 2 * p] += acc[p].x;
          outs[r * n_out + c0 + 2 * p + 1] += acc[p].y;
        }
      }
    }
  }
}

// The 4 warps of row group `rg` (128 threads) wait for each other.
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + rg) : "memory");
}

// The ring's stages as a warp walks them: slot and phase parity.
struct RingCursor {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// K2a's epilogue where it keeps, for a lane of row group rg (its first row
// `lane_row` within the group): once the keepers have taken the tile's last
// h out (not before the first epilogue), the layer's h into the tile and
// gelu' into the group's one of the next 2 ring slots (the round's first row
// group's, then its second's: the producer's `keep_items`, which hands both
// out at once), the warp passing both.
template <int R, int TN>
__device__ __forceinline__ void keep_epilogue(float* at, const float (&acc)[R][TN], const float* bias, bool active,
                                              bool& kept_before, int rg, int cq, int lc, int lane_row, uint64_t* full,
                                              uint64_t* empty, float* ring, int stage, int stages, RingCursor& ring_at) {
  if (kept_before) bar_sync(kFmaFree + rg, kFmaHandOff);
  kept_before = true;
  RingCursor second = ring_at;
  second.advance(stages);
  mbar_wait(full + ring_at.slot, ring_at.phase);
  mbar_wait(full + second.slot, second.phase);
  if (active) {
    const int slot = rg == 0 ? ring_at.slot : second.slot;
    keep_act<R, TN>(at, acc, bias, ring + static_cast<size_t>(slot) * stage, lane_row / R, cq, lc);
    fence_async_smem();
  }
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    mbar_arrive(empty + ring_at.slot);
    mbar_arrive(empty + second.slot);
  }
  ring_at = second;
  ring_at.advance(stages);
}

// The block's contiguous range [g0, g1) of the `groups` row groups (the
// host's copy: ops/flow_kernel.py::fma_groups).
__device__ __forceinline__ void block_groups(int groups, int& g0, int& g1) {
  g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * groups / gridDim.x);
  g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * groups / gridDim.x);
}

// The card's SMs (0 where it cannot be read).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

#ifndef BCNF_FMA_DEVICE_ONLY  // flow_train_fma.cu takes the helpers above, not the kernels below

// The flow over the block's rounds; with kBound (K2a's forward; row r takes
// h_proj[k * N + r], N >= B, and a row r >= B of the last row group, which
// is computed but never stored, h_proj[k * N + r % B], within the B rows it
// was given) each step's input rows are also stored to
// bound[k] (S x B x size) and, where keep is not null, each layer's
// activations and s to keep (fma_keep_act, fma_keep_s): the activations
// through staging slots of the ring, copied out in bulk by the producer.
template <int TN, bool kBound>
__device__ __forceinline__ void fma_flow(const float* __restrict__ x, const float* __restrict__ h_proj,
                                         const float* __restrict__ an_s, const float* __restrict__ an_b,
                                         const float* __restrict__ ortho, const float* __restrict__ w1y,
                                         const float* __restrict__ b1, const float* __restrict__ wm,
                                         const float* __restrict__ bm, const float* __restrict__ wout,
                                         const float* __restrict__ bout, float* __restrict__ y,
                                         float* __restrict__ ld_out, float* __restrict__ bound,
                                         float* __restrict__ keep, int B, int N, int S,
                                         int size, int d_a, int nh, int inverse, int stages, int groups) {
  using Sh = FmaShape<TN>;
  constexpr int Hp = Sh::Hp, BK = Sh::BK, ldT = Sh::ldT, R = Sh::R, G = Sh::G, BM = Sh::BM;
  const int d_b = size - d_a, n_out = 2 * d_b;
  const int stage = fma_stage(TN, size, d_a);
  const int n_in = (d_a + BK - 1) / BK;                // stages of W1y a step
  const int out_rows = min(Hp, (stage / n_out) & ~3);  // rows of Wout a stage
  const int n_outs = (Hp + out_rows - 1) / out_rows;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + stages;
  float* actT = reinterpret_cast<float*>(empty + stages);  // Hp x ldT: a[row][k] at actT[k * ldT + row]
  float* ring = actT + Hp * ldT;
  float* xs = ring + static_cast<size_t>(stages) * stage;  // BM x size: the round's rows' state
  float* xt = xs + BM * size;                              // BM x size: the mix's output
  float* outs = xt + BM * size;                            // BM x n_out: [t | s'], then [t | s]
  float* lds = outs + BM * n_out;                          // BM: logdet

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int g0, g1;
  block_groups(groups, g0, g1);
  const int rounds = (g1 - g0 + 1) / 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kFmaWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if constexpr (kBound) {
    static_assert(Sh::BK == Sh::G, "a ring stage holds a row group's rows of one kept layer");
  }
  const bool keeping = kBound && keep != nullptr;  // K2a keeps what the strict K2b reads

  if constexpr (kBound) {
    if (warp > kFmaWarps) {  // ---- K2a's keepers: each layer's h, from the tile to the keep
      if (!keeping) return;
      const int tid = threadIdx.x - kFmaConsumers - 32;
      for (int t = 0; t < rounds; ++t) {
        for (int k = 0; k < S; ++k) {
          for (int l = 0; l <= nh; ++l) {
            float* hs = keep + fma_keep_act(k, l, false, B, nh, Hp);
            for (int rg = 0; rg < 2; ++rg) {
              bar_sync(kFmaReady + rg, kFmaHandOff);  // the group's h is in the tile
              const int grp = g0 + 2 * t + rg;
              for (int e = tid; e < G * (Hp / 4) && grp < g1; e += kFmaKeepers) {  // a warp: G rows, 32 / G quads
                const int r = e % G, c = 4 * (e / G);
                const float* src = actT + c * ldT + rg * G + r;
                __stcs(reinterpret_cast<float4*>(hs + (static_cast<size_t>(grp) * G + r) * Hp + c),
                       make_float4(src[0], src[ldT], src[2 * ldT], src[3 * ldT]));
              }
              bar_arrive(kFmaFree + rg, kFmaHandOff);  // ... and out of it
            }
          }
        }
      }
      return;
    }
    if (warp == kFmaWarps) {  // ---- K2a's producer: K1's weights, and the keep's staging slots between layers
      if (threadIdx.x != kFmaConsumers) return;
      RingCursor next;
      int issued = 0, n_commit = 0;
      uint64_t reading = ~0ull;  // a slot's 8 bits: the number (mod 128) of the bulk store reading it; 255: none
      // The last layer's 2 gelu' slots while not yet stored: the first's place in the ring, the layer, and the
      // slots taken since (the next layer's first stages load into the other slots meanwhile).
      int pend = -1, pend_k = 0, pend_l = 0, pend_t = 0, since = 0;
      uint32_t pend_phase = 0;
      auto claim = [&]() {  // the next slot, once its last users are done with it: every warp, and a bulk store
        if (issued++ >= stages) mbar_wait(empty + next.slot, next.phase ^ 1u);
        const int q = static_cast<int>((reading >> (8 * next.slot)) & 255u);
        if (q != 255) {
          const int later = (n_commit - 1 - q) & 127;  // stores committed after it
          if (later == 0) bulk_wait_read<0>();
          else if (later == 1) bulk_wait_read<1>();
          else if (later == 2) bulk_wait_read<2>();
          else bulk_wait_read<3>();
          reading |= 255ull << (8 * next.slot);
        }
      };
      // Gelu' slot i (the round's row group i), once that group's warps have written it and every warp has
      // passed it: one bulk store to the keep's rows of its group.
      auto store = [&](int i) {
        const int slot = (pend + i) % stages;
        mbar_wait(empty + slot, pend_phase ^ (static_cast<uint32_t>((pend + i) / stages) & 1u));
        const int grp = g0 + 2 * pend_t + i;
        const int rows = grp < g1 ? min(G, B - grp * G) : 0;
        if (rows > 0) {
          bulk_store_s2g(keep + fma_keep_act(pend_k, pend_l, true, B, nh, Hp) + static_cast<size_t>(grp) * G * Hp,
                         ring + static_cast<size_t>(slot) * stage, 4u * static_cast<uint32_t>(G * Hp));
          bulk_commit();
          reading = (reading & ~(255ull << (8 * slot))) | (static_cast<uint64_t>(n_commit & 127) << (8 * slot));
          ++n_commit;
        }
      };
      auto flush = [&]() {
        if (pend >= 0) {
          store(0);
          store(1);
          pend = -1;
        }
      };
      auto push = [&](const float* src, int floats) {
        if (pend >= 0 && since++ >= stages - 2) flush();  // the next slot is a gelu' slot: stored first
        claim();
        const uint32_t bytes = 4u * static_cast<uint32_t>(floats);
        uint64_t* bar = full + next.slot;
        float* dst = ring + static_cast<size_t>(next.slot) * stage;
        mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);
        next.advance(stages);
      };
      // Layer l's gelu' at step k in round t: the next 2 slots, handed out for the consumers to write (a ring
      // has at least 2 stages), stored once the next stages-2 weight stages are on their way.
      auto keep_items = [&](int k, int l, int t) {
        flush();
        pend = next.slot, pend_phase = next.phase, pend_k = k, pend_l = l, pend_t = t, since = 0;
        for (int i = 0; i < 2; ++i) {
          claim();
          mbar_arrive(full + next.slot);  // no copy in: the consumers write it
          next.advance(stages);
        }
      };
      for (int t = 0; t < rounds; ++t) {
        for (int k = 0; k < S; ++k) {
          for (int j = 0; j < n_in; ++j)
            push(w1y + (static_cast<size_t>(k) * d_a + j * BK) * Hp, min(BK, d_a - j * BK) * Hp);
          if (keeping) keep_items(k, 0, t);
          for (int l = 0; l < nh; ++l) {
            for (int s = 0; s < Hp / BK; ++s)
              push(wm + ((static_cast<size_t>(k) * nh + l) * Hp + s * BK) * Hp, BK * Hp);
            if (keeping) keep_items(k, l + 1, t);
          }
          for (int j = 0; j < n_outs; ++j)
            push(wout + (static_cast<size_t>(k) * Hp + j * out_rows) * n_out, min(out_rows, Hp - j * out_rows) * n_out);
        }
      }
      flush();
      bulk_wait_all();  // the keep's stores complete before the block ends
      return;
    }
  } else if (warp >= kFmaWarps) {  // ---- the producer: every weight a step uses, in the order used
    if (threadIdx.x != kFmaConsumers) return;
    RingCursor next;
    int issued = 0;
    auto push = [&](const float* src, int floats) {
      if (issued++ >= stages) mbar_wait(empty + next.slot, next.phase ^ 1u);  // released by every warp
      const uint32_t bytes = 4u * static_cast<uint32_t>(floats);
      uint64_t* bar = full + next.slot;
      float* dst = ring + static_cast<size_t>(next.slot) * stage;
      mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);
      next.advance(stages);
    };
    for (int t = 0; t < rounds; ++t) {
      for (int it = 0; it < S; ++it) {
        const int k = inverse ? S - 1 - it : it;
        for (int j = 0; j < n_in; ++j)
          push(w1y + (static_cast<size_t>(k) * d_a + j * BK) * Hp, min(BK, d_a - j * BK) * Hp);
        for (int l = 0; l < nh; ++l)
          for (int s = 0; s < Hp / BK; ++s)
            push(wm + ((static_cast<size_t>(k) * nh + l) * Hp + s * BK) * Hp, BK * Hp);
        for (int j = 0; j < n_outs; ++j)
          push(wout + (static_cast<size_t>(k) * Hp + j * out_rows) * n_out, min(out_rows, Hp - j * out_rows) * n_out);
      }
    }
    return;
  }

  // ---- a consumer warp: row group rg, column quarter cq. In the products
  // its lane's rows are prod_row .. (by lane / 8); its own rows, for the row
  // work and the output layer, own_row .. (by cq): R of each.
  const int rg = warp / 4, cq = warp % 4, lc = lane % 8;
  const int prod_row = rg * G + R * (lane / 8), own_row = rg * G + R * cq;
  float* at = actT + prod_row;  // the lane's rows of the tile
  RingCursor ring_at;
  auto wait = [&]() -> const float* {  // the next stage, once its copy has landed
    mbar_wait(full + ring_at.slot, ring_at.phase);
    return ring + static_cast<size_t>(ring_at.slot) * stage;
  };
  auto release = [&]() {  // ... and when every lane of the warp is done with it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + ring_at.slot);
    ring_at.advance(stages);
  };
  bool kept_before = false;  // K2a: an epilogue has handed the keepers the tile

  for (int t = 0; t < rounds; ++t) {
    const bool active = g0 + 2 * t + rg < g1;  // the row group has rows this round
    const int row0 = (g0 + 2 * t) * G;          // the round's first row
    if (active) {
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p;
        xs[q] = row0 + q / size < B ? x[static_cast<size_t>(row0) * size + q] : 0.0f;
      }
      if (lane < R) lds[own_row + lane] = 0.0f;
    }

    for (int it = 0; it < S; ++it) {
      const int k = inverse ? S - 1 - it : it;
      const bool inner = k < S - 1;  // step S-1 is the final coupling alone
      const float* sc = an_s + static_cast<size_t>(k) * size;
      const float* bi = an_b + static_cast<size_t>(k) * size;
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      // the input layer's sums start at b1 + h_proj[k, row % N] (K2a: row,
      // or row % B past B): loaded first, so that the loads are in flight
      // during the row work
      float acc[R][TN];
      if (active) {
        float b[TN];
        load_cols<TN>(b1 + static_cast<size_t>(k) * Hp, cq, lc, b);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float h[TN];
          const int row = row0 + prod_row + r;
          const int hrow = kBound ? (row < B ? row : row % B) : row % N;
          load_cols<TN>(h_proj + (static_cast<size_t>(k) * N + hrow) * Hp, cq, lc, h);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = b[j] + h[j];
        }
      }

      if constexpr (kBound) {  // the step's input rows, before its ActNorm
        if (active) {
          for (int p = lane; p < R * size; p += 32) {
            const int q = own_row * size + p;
            if (row0 + q / size < B) bound[(static_cast<size_t>(k) * B + row0) * size + q] = xs[q];
          }
        }
      }

      // ---- the warp's own rows: ActNorm (forward) or x <- x Q^T (inverse)
      if (active && inner) {
        if (!inverse) {
          for (int p = lane; p < R * size; p += 32) {
            const int i = p % size;
            xs[own_row * size + p] = xs[own_row * size + p] * sc[i] + bi[i];
          }
          if (lane < R) {
            float l = 0.0f;
            for (int i = 0; i < size; ++i) l += logf(fabsf(sc[i]));
            lds[own_row + lane] += l;
          }
        } else {
          for (int p = lane; p < R * size; p += 32) {
            const int r = own_row + p / size, j = p % size;
            float a = 0.0f;
            for (int i = 0; i < size; ++i) a = fmaf(xs[r * size + i], Q[j * size + i], a);
            xt[r * size + j] = a;
          }
        }
      }
      if (inner && inverse) {  // every warp swaps: the state moved to the other buffer
        float* tmp = xs;
        xs = xt;
        xt = tmp;
      }
      group_sync(rg);  // the group's x is ready, and the last step's readers of the tile are done

      // ---- input layer: gelu(x_a W1y + b1 + h_proj[k, row % N])
      for (int j = 0; j < n_in; ++j) {
        const float* ws = wait();
        if (active) input_product<R, TN>(ws, min(BK, d_a - j * BK), xs + prod_row * size + j * BK, size, acc, cq, lc);
        release();
      }
      if (keeping) {
        keep_epilogue<R, TN>(at, acc, nullptr, active, kept_before, rg, cq, lc, prod_row - rg * G, full, empty, ring,
                             stage, stages, ring_at);
      } else {
        if (active) store_act<R, TN>(at, acc, nullptr, cq, lc);
      }
      group_sync(rg);
      if (keeping) bar_arrive(kFmaReady + rg, kFmaHandOff);  // the keepers may take h out

      // ---- hidden layers: a <- gelu(a Wm_l + bm_l)
      for (int l = 0; l < nh; ++l) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;
#pragma unroll 1
        for (int s = 0; s < Hp / BK; ++s) {
          const float* ws = wait();
          if (active) hidden_product<R, TN>(ws, at + s * BK * ldT, acc, cq, lc);
          release();
        }
        group_sync(rg);  // every warp of the group is done reading the tile
        if (keeping) {
          keep_epilogue<R, TN>(at, acc, bm + (static_cast<size_t>(k) * nh + l) * Hp, active, kept_before, rg, cq, lc,
                               prod_row - rg * G, full, empty, ring, stage, stages, ring_at);
        } else {
          if (active) store_act<R, TN>(at, acc, bm + (static_cast<size_t>(k) * nh + l) * Hp, cq, lc);
        }
        group_sync(rg);
        if (keeping) bar_arrive(kFmaReady + rg, kFmaHandOff);
      }

      // ---- output layer: [t | s'] = a Wout + bout, the warp's own rows
      float* o = outs + own_row * n_out;
      if (active) {
        const float* bo = bout + static_cast<size_t>(k) * n_out;
        for (int p = lane; p < R * n_out; p += 32) o[p] = bo[p % n_out];
      }
      __syncwarp();
      for (int j = 0; j < n_outs; ++j) {
        const float* ws = wait();
        if (active)
          output_product<R>(ws, min(out_rows, Hp - j * out_rows), actT + j * out_rows * ldT + own_row, ldT, o, n_out,
                            lane);
        release();
      }
      __syncwarp();

      // ---- the warp's own rows: the affine update of x_b (the forward keeps
      // s for its logdet), then x <- x Q (forward) or ActNorm^-1 (inverse)
      if (active) {
        for (int p = lane; p < R * d_b; p += 32) {
          const int r = p / d_b, j = p % d_b;
          float* xb = xs + (own_row + r) * size + d_a + j;
          const float s = tanhf(o[r * n_out + d_b + j]);
          if (!inverse) {
            *xb = expf(s) * *xb + o[r * n_out + j];
            o[r * n_out + d_b + j] = s;
            if (keeping) {
              if (row0 + own_row + r < B)
                keep[fma_keep_s(k, B, S, nh, Hp, d_b) + static_cast<size_t>(row0 + own_row + r) * d_b + j] = s;
            }
          } else {
            *xb = (*xb - o[r * n_out + j]) * expf(-s);
          }
        }
        __syncwarp();
        if (!inverse && lane < R) {
          float l = 0.0f;
          for (int j = 0; j < d_b; ++j) l += o[lane * n_out + d_b + j];
          lds[own_row + lane] += l;
        }
      }
      if (inner) {
        if (!inverse) {
          if (active) {
            for (int p = lane; p < R * size; p += 32) {
              const int r = own_row + p / size, j = p % size;
              float a = 0.0f;
              for (int i = 0; i < size; ++i) a = fmaf(xs[r * size + i], Q[i * size + j], a);
              xt[r * size + j] = a;
            }
          }
          float* tmp = xs;  // every warp swaps
          xs = xt;
          xt = tmp;
        } else if (active) {
          for (int p = lane; p < R * size; p += 32) {
            const int i = p % size;
            xs[own_row * size + p] = (xs[own_row * size + p] - bi[i]) / sc[i];
          }
        }
      }
      __syncwarp();
    }

    if (active) {
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p;
        if (row0 + q / size < B) y[static_cast<size_t>(row0) * size + q] = xs[q];
      }
      if (!inverse && lane < R && row0 + own_row + lane < B) ld_out[row0 + own_row + lane] = lds[own_row + lane];
    }
  }
  if (keeping) bar_sync(kFmaFree + rg, kFmaHandOff);  // the keepers' last hand-off
}

// K1: the flow, forward or inverse.
template <int TN>
__global__ void __launch_bounds__(kFmaThreads, 1)
fma_flow_kernel(const float* __restrict__ x, const float* __restrict__ h_proj, const float* __restrict__ an_s,
                const float* __restrict__ an_b, const float* __restrict__ ortho, const float* __restrict__ w1y,
                const float* __restrict__ b1, const float* __restrict__ wm, const float* __restrict__ bm,
                const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ y,
                float* __restrict__ ld_out, int B, int N, int S, int size, int d_a, int nh, int inverse,
                int stages, int groups) {
  fma_flow<TN, false>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld_out, nullptr, nullptr, B, N, S,
                      size, d_a, nh, inverse, stages, groups);
}

// K2a: the forward with its step-input store and, where keep is not null,
// its keep; row r takes h_proj[k * N + r].
template <int TN>
__global__ void __launch_bounds__(kFmaThreads, 1)
fma_flow_train_kernel(const float* __restrict__ x, const float* __restrict__ h_proj, const float* __restrict__ an_s,
                      const float* __restrict__ an_b, const float* __restrict__ ortho, const float* __restrict__ w1y,
                      const float* __restrict__ b1, const float* __restrict__ wm, const float* __restrict__ bm,
                      const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ z,
                      float* __restrict__ ld_out, float* __restrict__ bound, float* __restrict__ keep, int B, int N,
                      int S, int size, int d_a, int nh, int stages, int groups) {
  fma_flow<TN, true>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, z, ld_out, bound, keep, B, N, S, size,
                     d_a, nh, 0, stages, groups);
}

// The launch's layout: blocks, ring stages and shared memory, or
// cudaErrorInvalidValue where no ring fits (the host's copy:
// ops/flow_kernel.py::fma_layout).
cudaError_t fma_layout(int TN, int B, int size, int d_a, int sms, int* blocks, int* stages, size_t* smem) {
  *stages = 0;
  for (int r = kFmaRingMax; r >= kFmaRingMin && *stages == 0; --r)
    if (fma_smem(TN, size, d_a, r) <= kSmemLimit) *stages = r;
  if (*stages == 0) return cudaErrorInvalidValue;
  *smem = fma_smem(TN, size, d_a, *stages);
  const int groups = (B + 4 * fma_lane_rows(TN) - 1) / (4 * fma_lane_rows(TN));
  *blocks = groups < sms ? groups : sms;
  return cudaSuccess;
}

// K1 (bound and keep null) or K2a (the forward, bound not null: storing the
// step inputs to bound and, where keep is not null, the activations the
// strict K2b reads to keep).
template <int TN>
cudaError_t fma_launch(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                       const float* w1y, const float* b1, const float* wm, const float* bm, const float* wout,
                       const float* bout, float* y, float* ld, float* bound, float* keep, int B, int N, int S, int size,
                       int d_a, int nh, int inverse, int sms, cudaStream_t stream) {
  int blocks, stages;
  size_t smem;
  cudaError_t err = fma_layout(TN, B, size, d_a, sms, &blocks, &stages, &smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + FmaShape<TN>::G - 1) / FmaShape<TN>::G;
  if (bound == nullptr) {
    err = cudaFuncSetAttribute(fma_flow_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fma_flow_kernel<TN><<<blocks, kFmaThreads, smem, stream>>>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout,
                                                               bout, y, ld, B, N, S, size, d_a, nh, inverse, stages,
                                                               groups);
  } else {
    err = cudaFuncSetAttribute(fma_flow_train_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fma_flow_train_kernel<TN><<<blocks, kFmaThreads, smem, stream>>>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm,
                                                                     wout, bout, y, ld, bound, keep, B, N, S, size, d_a,
                                                                     nh, stages, groups);
  }
  return cudaGetLastError();
}

// Check a call and launch it at its TN: K1 (bound null) or K2a.
int fma_call(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
             const float* w1y, const float* b1, const float* wm, const float* bm, const float* wout, const float* bout,
             float* y, float* ld, float* bound, float* keep, int B, int N, int S, int size, int d_a, int nh, int Hp,
             int inverse, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 ||
      (!inverse && ld == nullptr) || (keep != nullptr && bound == nullptr) || (bound != nullptr && N < B) ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(wout) |
        reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(b1) | reinterpret_cast<size_t>(bm) |
        reinterpret_cast<size_t>(keep)) & 15) != 0)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                                \
  case TN:                                                                                                           \
    return fma_launch<TN>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld, bound, keep, B, N, S, size, \
                          d_a, nh, inverse, sms, st);
  switch (Hp / 32) {
    BCNF_CASE(1)
    BCNF_CASE(2)
    BCNF_CASE(4)
    BCNF_CASE(8)
    BCNF_CASE(12)
    BCNF_CASE(16)
    BCNF_CASE(17)
    BCNF_CASE(24)
    BCNF_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef BCNF_CASE
}

#endif  // BCNF_FMA_DEVICE_ONLY

}  // namespace

#ifndef BCNF_FMA_DEVICE_ONLY

// C entry points, loaded with ctypes. Hp (the padded hidden width) must be
// 32*TN for a compiled TN; each returns the cudaError_t of its launch.

// K1 in exact float32 (the strict mode): the flow, forward (y = z, ld =
// logdet) or inverse, on float32 FMA. Row r takes h_proj[k, r % N].
extern "C" int bcnf_fused_flow(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                               const float* ortho, const float* w1y, const float* b1, const float* wm, const float* bm,
                               const float* wout, const float* bout, float* y, float* ld, int B, int N, int S,
                               int size, int d_a, int nh, int Hp, int inverse, void* stream) {
  return fma_call(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld, nullptr, nullptr, B, N, S, size,
                  d_a, nh, Hp, inverse, stream);
}

// K2a in exact float32: the forward (z, ld = logdet) of B rows with each
// step's input rows stored to bound (S x B x size) and, where keep is not
// null, the activations the strict K2b reads to keep (16-byte aligned,
// bcnf_flow_fma_keep floats for B rows); row r takes h_proj[k * N + r] (N >=
// B: B rows of a larger batch's projections, whose rows of a step are N
// apart, as the strict K2b's row chunks run it; the rows it computes past B
// take h_proj[k * N + r % B], so that it reads none of h_proj's past its B).
extern "C" int bcnf_fused_flow_train(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                     const float* ortho, const float* w1y, const float* b1, const float* wm,
                                     const float* bm, const float* wout, const float* bout, float* z, float* ld,
                                     float* bound, float* keep, int B, int N, int S, int size, int d_a, int nh, int Hp,
                                     void* stream) {
  if (bound == nullptr) return cudaErrorInvalidValue;
  return fma_call(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, z, ld, bound, keep, B, N, S, size, d_a,
                  nh, Hp, 0, stream);
}

// Floats of the strict K2a's keep (fma_keep_floats).
extern "C" long long bcnf_flow_fma_keep(int B, int S, int size, int d_a, int nh, int Hp) {
  return static_cast<long long>(fma_keep_floats(B, S, nh, Hp, size - d_a));
}

// The layout a call at this shape takes on the current card: out[0..4] =
// rows a lane, blocks, ring stages, floats a stage, bytes of shared memory.
extern "C" int bcnf_flow_fma_layout(int B, int size, int d_a, int Hp, int* out) {
  if (B <= 0 || d_a <= 0 || d_a >= size || Hp % 32 != 0 || Hp / 32 > 32) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  int blocks = 0, stages = 0;
  size_t smem = 0;
  const cudaError_t err = fma_layout(Hp / 32, B, size, d_a, sms, &blocks, &stages, &smem);
  out[0] = fma_lane_rows(Hp / 32);
  out[1] = blocks;
  out[2] = stages;
  out[3] = fma_stage(Hp / 32, size, d_a);
  out[4] = static_cast<int>(smem);
  return err;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // BCNF_FMA_DEVICE_ONLY
