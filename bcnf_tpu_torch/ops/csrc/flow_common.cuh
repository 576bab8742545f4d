// Device helpers shared by the hand-written kernels (flow_kernel.cu: K1, K4
// as K1 at one step, and the training forward K2a; flow_wgmma.cu: K1's
// inverse on `wgmma`; flow_train_kernel.cu: the training backward K2b;
// lstm_kernel.cu: K3a/K3b).
//
// Layout conventions of the strict K1's float32 FMA products (mac_slab,
// matmul_hidden, matmul_narrow): 256 threads = 8 warps; a thread (ty = warp, tx = lane)
// owns rows ty*TM + r (r < TM) and hidden columns tx + 32*j (j < TN) of a
// block's BM x Hp activation tile, Hp = 32*TN. Weights are stored (in, out),
// so BK consecutive input rows of a weight are one contiguous slab.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace bcnf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use

constexpr float kGeluK0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluK1 = 0.044715f;

// GELU in its tanh form, as jax.nn.gelu and the Pallas kernels compute it.
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(kGeluK0 * (x + kGeluK1 * x * x * x)));
}

// d gelu_tanh / dx = 0.5 (1 + tanh u) + 0.5 x (1 - tanh^2 u) k0 (1 + 3 k1 x^2).
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kGeluK0 * (x + kGeluK1 * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kGeluK0 * (1.0f + 3.0f * kGeluK1 * x * x);
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n contiguous floats (n a multiple of 4, both ends 16-byte aligned).
__device__ __forceinline__ void load_slab(float* dst, const float* src, int n, int tid) {
  for (int i = tid * 4; i < n; i += kThreads * 4) cp_async16(dst + i, src + i);
}

// acc[r][j] += sum_{kk < BK} a[row r][k0 + kk] * ws[kk][col j], where this
// thread's rows are ty*TM + r and its columns tx + 32*j; the activation tile
// and the weight slab are both 32*TN wide.
template <int TM, int TN>
__device__ __forceinline__ void mac_slab(const float* act, int k0, const float* ws, int BK, float (&acc)[TM][TN],
                                         int ty, int tx) {
  constexpr int Hp = 32 * TN;
#pragma unroll 1
  for (int kk = 0; kk < BK; kk += 4) {
    float4 a[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      a[r] = *reinterpret_cast<const float4*>(act + (ty * TM + r) * Hp + k0 + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* wrow = ws + (kk + q) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float w = wrow[32 * j];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r][j] = fmaf(lane(a[r], q), w, acc[r][j]);
      }
    }
  }
}

// acc = act (BM x Hp, shared) @ W (Hp x Hp, global, row-major), Hp = 32*TN,
// with W streamed through the two-slab cp.async double buffer `slab`
// (2 x BK x Hp floats). Ends with a barrier, so the caller may overwrite
// `act` right after.
template <int TM, int TN>
__device__ __forceinline__ void matmul_hidden(const float* act, const float* W, float* slab, int BK,
                                              float (&acc)[TM][TN], int ty, int tx, int tid) {
  constexpr int Hp = 32 * TN;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;
  const int n_slabs = Hp / BK;
  load_slab(slab, W, BK * Hp, tid);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      load_slab(slab + ((s + 1) & 1) * BK * Hp, W + static_cast<size_t>(s + 1) * BK * Hp, BK * Hp, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mac_slab<TM, TN>(act, s * BK, slab + (s & 1) * BK * Hp, BK, acc, ty, tx);
    __syncthreads();
  }
}

// out[r][c] = sum_i act[r][i] * W[i * w_row + c * w_col] + bias[c] for the
// block's BM rows and c < n_cols, one column per lane (n_cols is small: the
// coupling's [t | s'] outputs or the d_a inputs). `bias` may be null.
template <int TM, int TN>
__device__ __forceinline__ void matmul_narrow(const float* act, const float* W, int w_row, int w_col,
                                              const float* bias, float* out, int n_cols, int ty,
                                              int tx) {
  constexpr int Hp = 32 * TN;
  for (int c = tx; c < ((n_cols + 31) / 32) * 32; c += 32) {
    if (c < n_cols) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.0f;
      const float* Wc = W + static_cast<size_t>(c) * w_col;
      for (int kk = 0; kk < Hp; kk += 4) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = Wc[static_cast<size_t>(kk + q) * w_row];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(act + (ty * TM + r) * Hp + kk);
          acc[r] = fmaf(a.x, w[0], acc[r]);
          acc[r] = fmaf(a.y, w[1], acc[r]);
          acc[r] = fmaf(a.z, w[2], acc[r]);
          acc[r] = fmaf(a.w, w[3], acc[r]);
        }
      }
      const float bo = bias == nullptr ? 0.0f : bias[c];
#pragma unroll
      for (int r = 0; r < TM; ++r) out[(ty * TM + r) * n_cols + c] = acc[r] + bo;
    }
  }
}

}  // namespace bcnf
