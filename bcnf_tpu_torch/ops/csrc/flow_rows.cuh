// The row-tile machinery of the flow kernels: the whole-flow walk of K1's
// forward, K1's wide inverse and K2a (flow_kernel.cu, `rows_flow_kernel`) and
// K2b's per-step rows kernel (flow_train_kernel.cu, `bwd_rows_kernel`) run
// the same coupling MLP on the same tiles, so they share these pieces; K1's
// inverse on `wgmma` (flow_wgmma.cu) takes `input_layer` from here.
//
// A block of 512 threads (16 warps) owns BM rows (32, or 16 at the widest
// hidden widths). Their activation tile (BM x Hp, Hp = 32*TN) sits in shared
// memory. A square hidden product (BM x Hp by Hp x Hp) runs on `mma.sync` in
// kPasses tensor-core passes (mma_tf32.cuh: 3xTF32, or one TF32 pass in the
// library built for the reduced mode): warp w owns n-tiles w, w+16, ... of all BM rows,
// the weight streamed from L2 in BK-row (W) or BK-column (W^T, read as it is
// stored) stages through a 3-stage cp.async ring, one barrier a stage. The
// narrow products (the d_a inputs, the n_out outputs) stay float32 FMA and
// read their weights from the same ring, staged between the square products.

#pragma once

#include "flow_common.cuh"
#include "mma_tf32.cuh"

// The tensor-core passes of the flow kernels' products: 3 (3xTF32, the
// default mode, which serves the "highest"/"float32" contract) or 1 (one TF32
// pass, the reduced mode). bcnf_tpu_torch/ops/_build.py compiles each flow
// source twice, the second time with -DBCNF_TF32_PASSES=1, into a library of
// its own; the narrow products and the mixes stay float32 FMA in both.
#ifndef BCNF_TF32_PASSES
#define BCNF_TF32_PASSES 3
#endif

namespace bcnf {

constexpr int kPasses = BCNF_TF32_PASSES;
static_assert(kPasses == 1 || kPasses == 3, "BCNF_TF32_PASSES must be 1 or 3");

constexpr int kRingStages = 3;
constexpr int kRowThreads = 512;  // the rows kernels' block
constexpr int kRowWarps = kRowThreads / 32;

// Copy n floats (n a multiple of 4, both ends 16-byte aligned) with all of
// the rows kernel's threads.
__device__ __forceinline__ void load_floats(float* dst, const float* src, int n, int tid) {
  for (int i = tid * 4; i < n; i += kRowThreads * 4) cp_async16(dst + i, src + i);
}

// The rows kernels' shapes for Hp = 32*TN, BM rows and BK-deep weight stages.
template <int TN, int BM, int BK>
struct RowShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int NT = Hp / 8;                       // n-tiles of a square product
  static constexpr int NTW = (NT + kRowWarps - 1) / kRowWarps;  // ... of one warp, at most
  static constexpr int MT = BM / 16;                            // m-tiles
  static constexpr int ldA = Hp + 4;                            // activation tile (row-major A)
  static constexpr int ldK = Hp + 8;                            // a stage of BK rows of W
  static constexpr int ldN = BK + 4;                            // a stage of BK columns of W (Hp rows)
  static constexpr int stage = BK * ldK > Hp * ldN ? BK * ldK : Hp * ldN;
  // Between the square products the ring holds W1y (d_a x Hp) or Wout
  // (Hp x n_out) where it is large enough (the flagship's widths and far
  // wider); otherwise the narrow products read them from global memory.
  __host__ __device__ static bool narrow_in_ring(int size, int d_a) {
    const int widest = d_a > 2 * (size - d_a) ? d_a : 2 * (size - d_a);
    return static_cast<size_t>(kRingStages) * stage >= static_cast<size_t>(Hp) * widest;
  }
  // The activation tile and the ring, which both kernels hold.
  static constexpr size_t tile_floats = static_cast<size_t>(BM) * ldA + static_cast<size_t>(kRingStages) * stage;
};

// acc = act (BM x Hp, shared) @ W (forward) or @ W^T (kTrans), W an Hp x Hp
// weight in global memory, row-major. Warp w's n-tiles are w + 16 i. Starts
// and ends with a barrier: the caller may write act, or the ring, right
// before and after.
template <int TN, int BM, int BK, bool kTrans>
__device__ __forceinline__ void square_product(const float* act, const float* W, float* ring,
                                               float (&acc)[BM / 16][RowShape<TN, BM, BK>::NTW][4],
                                               int warp, int lane, int tid) {
  using S = RowShape<TN, BM, BK>;
  constexpr int Hp = S::Hp, n_slabs = Hp / BK;
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int i = 0; i < S::NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][i][e] = 0.0f;

  __syncthreads();  // the ring's last readers are done
  auto load = [&](int slab) {
    float* st = ring + (slab % kRingStages) * S::stage;
    if (!kTrans) {  // rows slab*BK .. of W
      const float* src = W + static_cast<size_t>(slab) * BK * Hp;
      for (int e = tid; e < BK * Hp / 4; e += kRowThreads) {
        const int kr = e / (Hp / 4), c = (e % (Hp / 4)) * 4;
        cp_async16(st + kr * S::ldK + c, src + kr * Hp + c);
      }
    } else {  // columns slab*BK .. of every row of W
      const float* src = W + slab * BK;
      for (int e = tid; e < Hp * BK / 4; e += kRowThreads) {
        const int n = e / (BK / 4), c = (e % (BK / 4)) * 4;
        cp_async16(st + n * S::ldN + c, src + static_cast<size_t>(n) * Hp + c);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < n_slabs) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<kRingStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();                   // ... and everyone's; slab s-1's stage is free again
    if (s + kRingStages - 1 < n_slabs) load(s + kRingStages - 1);
    cp_async_commit();
    const float* st = ring + (s % kRingStages) * S::stage;
    const int nb = (S::NT - warp + kRowWarps - 1) / kRowWarps;  // the warp's n-tiles: w, w + 16, ...
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragA fa[S::MT];
      FragB fb[S::NTW];
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi) fa[mi] = load_a_rowmajor(act + 16 * mi * S::ldA + s * BK + kk, S::ldA, lane);
#pragma unroll
      for (int i = 0; i < S::NTW; ++i) {
        const int nt = warp + kRowWarps * i;
        if (i < nb) {
          fb[i] = kTrans ? load_b_nmajor(st + 8 * nt * S::ldN + kk, S::ldN, lane)
                         : load_b_kmajor(st + kk * S::ldK + 8 * nt, S::ldK, lane);
        }
      }
      mma_passes<kPasses>(acc, fa, fb, nb);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The thread's elements of a BM x Hp product, pairs of columns as
// square_product's C fragments hold them: f(row, col, mi, i, h) for the pair
// at (row, col) and (row, col + 1), held in acc[mi][i][2h] and acc[mi][i][2h + 1].
template <int TN, int BM, int BK, class F>
__device__ __forceinline__ void each_pair(int warp, int lane, F&& f) {
  using S = RowShape<TN, BM, BK>;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int i = 0; i < S::NTW; ++i) {
      const int nt = warp + kRowWarps * i;
      if (nt < S::NT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) f(16 * mi + g + 8 * h, 8 * nt + 2 * t4, mi, i, h);
      }
    }
}

// The coupling MLP's first pre-activation for one row at columns col and
// col + 1: x1 W1y[k] + b1[k] + h_proj[k, row] over the row's d_a inputs x1,
// float32 FMA in the order of the inputs. `w1` (d_a x Hp) is W1y[k], `b1`
// b1[k], `hp` the row's h_proj[k] (null for a row past the batch: zeros).
template <int Hp>
__device__ __forceinline__ float2 input_layer(const float* x1, const float* w1, const float* b1, const float* hp,
                                              int d_a, int col) {
  const float2 h = hp != nullptr ? *reinterpret_cast<const float2*>(hp + col) : make_float2(0.0f, 0.0f);
  float a0 = b1[col] + h.x;
  float a1 = b1[col + 1] + h.y;
  for (int i = 0; i < d_a; ++i) {
    const float2 w = *reinterpret_cast<const float2*>(w1 + i * Hp + col);
    a0 = fmaf(x1[i], w.x, a0);
    a1 = fmaf(x1[i], w.y, a1);
  }
  return make_float2(a0, a1);
}

// A narrow product's weight (n floats) for the ring when `in_ring`, copied by
// all threads between two barriers (the ring's last readers are done before
// it); returns where the product reads the weight.
__device__ __forceinline__ const float* stage_weight(float* ring, const float* src, int n, bool in_ring, int tid) {
  if (!in_ring) return src;
  __syncthreads();
  load_floats(ring, src, n, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  return ring;
}

// out[r][c] = sum_{i < K} act[r * lda + i] * W[i * w_row + c * w_col] + bias[c]
// for r < BM and c < n_cols, W in shared memory, one output a thread in
// turn, float32 FMA in the order of i. `bias` may be null.
__device__ __forceinline__ void narrow_product(const float* act, int lda, int BM, int K, const float* W,
                                               int w_row, int w_col, const float* bias, float* out,
                                               int n_cols, int tid) {
  for (int p = tid; p < BM * n_cols; p += kRowThreads) {
    const int r = p / n_cols, c = p % n_cols;
    const float* a = act + r * lda;
    const float* Wc = W + c * w_col;
    float acc = 0.0f;
    for (int kk = 0; kk < K; kk += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + kk);
      acc = fmaf(v.x, Wc[kk * w_row], acc);
      acc = fmaf(v.y, Wc[(kk + 1) * w_row], acc);
      acc = fmaf(v.z, Wc[(kk + 2) * w_row], acc);
      acc = fmaf(v.w, Wc[(kk + 3) * w_row], acc);
    }
    out[p] = acc + (bias == nullptr ? 0.0f : bias[c]);
  }
}

// Dispatch on Hp = 32*TN to CASE(TN, BM, BK), the widths both rows kernels
// are compiled for (bcnf_tpu_torch/ops/flow_kernel.py: KERNEL_TN); any other
// width returns cudaErrorInvalidValue from the enclosing function.
#define BCNF_ROW_CASES(Hp, CASE)             \
  switch ((Hp) / 32) {                       \
    CASE(1, 32, 16)                          \
    CASE(2, 32, 16)                          \
    CASE(4, 32, 16)                          \
    CASE(8, 32, 16)                          \
    CASE(12, 32, 16)                         \
    CASE(16, 32, 16)                         \
    CASE(17, 32, 16)                         \
    CASE(24, 16, 8)                          \
    CASE(32, 16, 8)                          \
    default:                                 \
      return cudaErrorInvalidValue;          \
  }

}  // namespace bcnf
