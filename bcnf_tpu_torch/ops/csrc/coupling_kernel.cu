// One conditional affine coupling, forward or inverse, in one kernel: K4.
//
// Replaces: bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (the
// Pallas TPU kernel `_coupling_kernel`). Host side and plain PyTorch
// version: bcnf_tpu_torch/ops/coupling_kernel.py.
//
// What it computes, for every row r (row r is conditioned on
// h_proj[r % N], the hoisted h W1_h of its condition, as K1 does):
//   a = gelu(x_a W1y + b1 + h_proj); a = gelu(a Wm_l + bm_l) for each of the
//   nh hidden layers; [t | s'] = a Wout + bout; s = tanh(s');
//   forward: out = exp(s) x_b + t, logdet = sum s; inverse: out = (x_b - t) exp(-s).
// GELU is the tanh form, as jax.nn.gelu and the Pallas kernel compute it.
//
// What bounds it on an H100: operations. At the flagship widths (H = 526,
// 4 hidden layers) a row costs 2.24 MFLOP, against ~4.7 MB of weights that
// every row shares, so any batch past a few thousand rows is compute-bound
// on float32 FMA (no tensor cores: exact float32).
//
// Design: K1's step body (flow_kernel.cu) without the ActNorm and the mix.
// One block of 256 threads owns BM = 8*TM rows; the activation tile sits in
// shared memory and each thread keeps a TM x TN tile of the next layer's
// sums in registers (flow_common.cuh's matmul_hidden streams each hidden
// weight from L2 in BK-row slabs through a cp.async double buffer); the
// narrow output layer gives one column to a lane. The hidden width is
// zero-padded to Hp = 32*TN by the host (exact: gelu(0) = 0). Rows past B in
// the ragged last tile are computed on zeros and not stored.

#include "flow_common.cuh"

namespace {

using namespace bcnf;

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
coupling_kernel(const float* __restrict__ x_a, const float* __restrict__ x_b,
                const float* __restrict__ h_proj, const float* __restrict__ w1y,
                const float* __restrict__ b1, const float* __restrict__ wm,
                const float* __restrict__ bm, const float* __restrict__ wout,
                const float* __restrict__ bout, float* __restrict__ out, float* __restrict__ ld_out,
                int B, int N, int d_a, int d_b, int nh, int BK, int inverse) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // BM x Hp
  float* slab = act + BM * Hp;                   // 2 x BK x Hp
  float* xas = slab + 2 * BK * Hp;               // BM x d_a
  float* outs = xas + BM * d_a;                  // BM x n_out: [t | s']

  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
  const int row0 = blockIdx.x * BM;

  for (int p = tid; p < BM * d_a; p += kThreads) {
    xas[p] = row0 + p / d_a < B ? x_a[static_cast<size_t>(row0) * d_a + p] : 0.0f;
  }
  __syncthreads();

  // ---- first layer: gelu(x_a W1y + b1 + h_proj[row % N])
  {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float* hp = h_proj + static_cast<size_t>((row0 + ty * TM + r) % N) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = b1[tx + 32 * j] + hp[32 * j];
    }
    for (int i = 0; i < d_a; ++i) {
      const float* wr = w1y + static_cast<size_t>(i) * Hp + tx;
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = wr[32 * j];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float xa = xas[(ty * TM + r) * d_a + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(xa, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) act[(ty * TM + r) * Hp + tx + 32 * j] = gelu_tanh(acc[r][j]);
  }
  __syncthreads();

  // ---- hidden layers: a <- gelu(a Wm_l + bm_l)
  for (int l = 0; l < nh; ++l) {
    float acc[TM][TN];
    matmul_hidden<TM, TN>(act, wm + static_cast<size_t>(l) * Hp * Hp, slab, BK, acc, ty, tx, tid);
    const float* bias = bm + static_cast<size_t>(l) * Hp + tx;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        act[(ty * TM + r) * Hp + tx + 32 * j] = gelu_tanh(acc[r][j] + bias[32 * j]);
    __syncthreads();
  }

  // ---- output layer: [t | s'] = a Wout + bout, one column per lane
  matmul_narrow<TM, TN>(act, wout, n_out, 1, bout, outs, n_out, ty, tx);
  __syncthreads();

  // ---- affine update of x_b and the row's logdet (one thread per row)
  if (tid < BM && row0 + tid < B) {
    const size_t row = static_cast<size_t>(row0 + tid);
    const float* o = outs + tid * n_out;
    float l = 0.0f;
    for (int j = 0; j < d_b; ++j) {
      const float t = o[j];
      const float s = tanhf(o[d_b + j]);
      const float xb = x_b[row * d_b + j];
      if (!inverse) {
        out[row * d_b + j] = expf(s) * xb + t;
        l += s;
      } else {
        out[row * d_b + j] = (xb - t) * expf(-s);
      }
    }
    if (!inverse) ld_out[row] = l;
  }
}

template <int TM, int TN>
cudaError_t launch(const float* x_a, const float* x_b, const float* h_proj, const float* w1y,
                   const float* b1, const float* wm, const float* bm, const float* wout,
                   const float* bout, float* out, float* ld, int B, int N, int d_a, int d_b, int nh,
                   int inverse, cudaStream_t stream) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  const size_t fixed = sizeof(float) * static_cast<size_t>(BM) * (Hp + d_a + 2 * d_b);
  int BK = 16;
  while (BK >= 4 && fixed + sizeof(float) * 2 * BK * Hp > kSmemLimit) BK /= 2;
  if (BK < 4) return cudaErrorInvalidValue;
  const size_t smem = fixed + sizeof(float) * 2 * BK * Hp;
  cudaError_t err = cudaFuncSetAttribute(coupling_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  coupling_kernel<TM, TN><<<(B + BM - 1) / BM, kThreads, smem, stream>>>(
      x_a, x_b, h_proj, w1y, b1, wm, bm, wout, bout, out, ld, B, N, d_a, d_b, nh, BK, inverse);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Hp (the padded hidden width) must be
// 32*TN for a compiled TN (the widths of K1); x_a (B, d_a), x_b (B, d_b),
// h_proj (N, Hp), w1y (d_a, Hp), b1 (Hp), wm (nh, Hp, Hp), bm (nh, Hp),
// wout (Hp, 2 d_b), bout (2 d_b); writes out (B, d_b) and, forward, ld (B).
// Returns the cudaError_t of the launch.
extern "C" int bcnf_coupling(const float* x_a, const float* x_b, const float* h_proj,
                             const float* w1y, const float* b1, const float* wm, const float* bm,
                             const float* wout, const float* bout, float* out, float* ld, int B,
                             int N, int d_a, int d_b, int nh, int Hp, int inverse, void* stream) {
  if (B <= 0 || N <= 0 || d_a <= 0 || d_b <= 0 || nh < 0 || Hp % 32 != 0 ||
      (!inverse && ld == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TM, TN)                                                                       \
  case TN:                                                                                      \
    return launch<TM, TN>(x_a, x_b, h_proj, w1y, b1, wm, bm, wout, bout, out, ld, B, N, d_a, d_b, \
                          nh, inverse, st);
  switch (Hp / 32) {
    BCNF_CASE(8, 1)
    BCNF_CASE(8, 2)
    BCNF_CASE(8, 4)
    BCNF_CASE(8, 8)
    BCNF_CASE(8, 12)
    BCNF_CASE(8, 16)
    BCNF_CASE(8, 17)
    BCNF_CASE(4, 24)
    BCNF_CASE(4, 32)
    default:
      return cudaErrorInvalidValue;
  }
#undef BCNF_CASE
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
