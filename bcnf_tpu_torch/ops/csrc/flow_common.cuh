// Device helpers shared by the hand-written kernels (flow_kernel.cu: K1, K4
// as K1 at one step, and the training forward K2a; flow_wgmma.cu: K1's
// inverse on `wgmma`; flow_fma.cu: the strict K1 on float32 FMA;
// flow_train_kernel.cu and flow_train_wgmma.cu: the training backward K2b;
// lstm_kernel.cu: K3a/K3b).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace bcnf {

constexpr int kThreads = 256;
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

// gelu_tanh(x) and gelu_tanh_grad(x) from one tanh: the same expressions,
// so the same values.
__device__ __forceinline__ void gelu_and_grad(float x, float& h, float& d) {
  const float t = tanhf(kGeluK0 * (x + kGeluK1 * x * x * x));
  h = 0.5f * x * (1.0f + t);
  d = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kGeluK0 * (1.0f + 3.0f * kGeluK1 * x * x);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4-byte asynchronous copy (any alignment), for the ragged and unaligned
// edges that the 16-byte cp_async16 cannot take.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bcnf
