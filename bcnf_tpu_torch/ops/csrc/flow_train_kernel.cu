// The backward of the whole conditional RealNVP flow for training: K2b.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `bwd_call` of
// `_make_fused_flow_train` (the Pallas TPU kernel `_flow_bwd_train_kernel`).
// Host side and plain PyTorch version (`fused_flow_train_backward_reference`):
// bcnf_tpu_torch/ops/flow_kernel.py. Its forward, K2a, is flow_kernel.cu.
//
// What it computes. From the step inputs x_k = bound[k] (S, B, size) that K2a
// stored, the cotangents dz (B, size) and dld (B) of z and logdet, and the
// stacked weights, walking k = S-1 .. 0:
//   recompute: x1 = x_k s_k + b_k (identity at the final step k = S-1);
//     a_0 = x1_a W1y + b1 + h_proj[k]; h_l = gelu(a_l);
//     a_{l+1} = h_l Wm_l + bm_l; [t | s'] = h_nh Wout + bout; s = tanh(s').
//   backward: dx2 = dy Q_k^T; dout = [dz_b | (dz_b e^s x1_b + dld)(1 - s^2)];
//     dh = dout Wout^T; da_l = gelu'(a_l) dh, dh = da_{l+1} Wm_l^T ...;
//     dh_proj[k] = da_0; dx1 = [dx2_a + da_0 W1y^T | dz_b e^s]; dy <- dx1 s_k.
//   weight grads, summed over all B rows: dWm_l = h_l^T da_{l+1},
//     dWout = h_nh^T dout, dW1y = x1_a^T da_0, the biases' column sums, and
//     the ActNorm's dscale = sum dx1 x_k + sum(dld) / s_k, dbias = sum dx1
//     (zero at the final step). The orthonormal mixes get no grad.
//
// What bounds it on an H100: operations. Per row and step it does the
// forward's MLP again, the same products transposed for dh, and the weight
// products: about three times K2a's ~58 MFLOP a row, in float32 FMA.
//
// Design, per step, in reverse order (all launches on the caller's stream):
// 1. `transpose_kernel` writes this step's Wm_l^T and Wout^T to scratch, so
//    the backward products stream weight slabs exactly as the forward does.
// 2. `bwd_rows_kernel`: one block of 256 threads owns BM = 32 rows, as K1
//    does: it recomputes the MLP (activation tile in shared memory, weights
//    through the cp.async double buffer), storing h_l and gelu'(a_l) to a
//    global scratch ((nh+1) x B x Hp each), then runs the backward on the
//    same tile and writes da_l (da_0 is dh_proj[k]) and dout. The TPU kernel
//    kept these pre-activations in a 100 MB VMEM window; a block's 227 KB of
//    shared memory cannot, so they go through L2/HBM. The carried dx is
//    updated in place: a block only touches its own rows.
// 3. `atb_kernel` (atb.cuh, shared with the LSTM backward): every weight
//    grad of the step as C = A^T B over the B rows, one 64 x 64 output tile
//    per block, each block looping over all rows in a fixed order. A's row
//    M is taken to be all ones, so row M of the product is the column sums:
//    the bias grads come out of the same pass. No atomics: the result does
//    not depend on the launch order, which is the TPU kernel's
//    VMEM-resident accumulation made deterministic.
// After the last step, `actnorm_grad_kernel` forms the ActNorm grads from the
// column sums. Rows past B are computed on zeros and never stored or summed.

#include "atb.cuh"

namespace {

using namespace bcnf;

constexpr int kRowTM = 4;  // rows per warp in bwd_rows_kernel: BM = 32

template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
bwd_rows_kernel(const float* __restrict__ bound, const float* __restrict__ h_proj,
                const float* __restrict__ dld, const float* __restrict__ an_s,
                const float* __restrict__ an_b, const float* __restrict__ ortho,
                const float* __restrict__ w1y, const float* __restrict__ b1,
                const float* __restrict__ wm, const float* __restrict__ bm,
                const float* __restrict__ wout, const float* __restrict__ bout,
                const float* __restrict__ wmT, const float* __restrict__ woutT,
                float* __restrict__ dxy, float* __restrict__ dhp, float* __restrict__ hs_g,
                float* __restrict__ gs_g, float* __restrict__ da_g, float* __restrict__ dout_g,
                float* __restrict__ x1_g, float* __restrict__ an_g, int B, int S, int k, int size,
                int d_a, int nh, int BK) {
  constexpr int TM = kRowTM;
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const int n_an = 2 * size + 1;
  const bool inner = k < S - 1;
  const size_t BHp = static_cast<size_t>(B) * Hp;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // BM x Hp
  float* slab = act + BM * Hp;                   // 2 x BK x Hp
  float* xs = slab + 2 * BK * Hp;                // BM x size: x_k
  float* x1s = xs + BM * size;                   // BM x size: after the ActNorm
  float* dys = x1s + BM * size;                  // BM x size: cotangent of the step's output
  float* dx2s = dys + BM * size;                 // BM x size: dy Q^T
  float* dx1s = dx2s + BM * size;                // BM x size: x_b part of dx1
  float* outs = dx1s + BM * size;                // BM x n_out: [t | s'], then dout
  float* dxas = outs + BM * n_out;               // BM x d_a: da_0 W1y^T
  float* dlds = dxas + BM * d_a;                 // BM

  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
  const int row0 = blockIdx.x * BM;
  const float* sc = an_s + static_cast<size_t>(k) * size;
  const float* bi = an_b + static_cast<size_t>(k) * size;
  const float* Q = ortho + static_cast<size_t>(k) * size * size;

  // ---- the step's input rows, the incoming cotangent, dlogdet
  for (int p = tid; p < BM * size; p += kThreads) {
    const bool valid = row0 + p / size < B;
    xs[p] = valid ? bound[(static_cast<size_t>(k) * B + row0) * size + p] : 0.0f;
    dys[p] = valid ? dxy[static_cast<size_t>(row0) * size + p] : 0.0f;
  }
  if (tid < BM) dlds[tid] = row0 + tid < B ? dld[row0 + tid] : 0.0f;
  __syncthreads();
  for (int p = tid; p < BM * size; p += kThreads) {
    const int i = p % size;
    x1s[p] = inner ? xs[p] * sc[i] + bi[i] : xs[p];
    if (row0 + p / size < B) x1_g[static_cast<size_t>(row0) * size + p] = x1s[p];
  }
  __syncthreads();

  // ---- recompute the MLP: a_0 = x1_a W1y + b1 + h_proj[k, row]
  {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int grow = row0 + ty * TM + r;
      const float* hp = h_proj + (static_cast<size_t>(k) * B + grow) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[r][j] = b1[static_cast<size_t>(k) * Hp + tx + 32 * j] + (grow < B ? hp[32 * j] : 0.0f);
    }
    for (int i = 0; i < d_a; ++i) {
      const float* wr = w1y + (static_cast<size_t>(k) * d_a + i) * Hp + tx;
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = wr[32 * j];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float xa = x1s[(ty * TM + r) * size + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(xa, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int grow = row0 + ty * TM + r;
      const size_t g0 = static_cast<size_t>(grow) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float h = gelu_tanh(acc[r][j]);
        act[(ty * TM + r) * Hp + tx + 32 * j] = h;
        if (grow < B) {
          hs_g[g0 + 32 * j] = h;
          gs_g[g0 + 32 * j] = gelu_tanh_grad(acc[r][j]);
        }
      }
    }
  }
  __syncthreads();

  // ---- hidden layers: a_{l+1} = h_l Wm_l + bm_l, keeping h and gelu'(a)
  for (int l = 0; l < nh; ++l) {
    float acc[TM][TN];
    matmul_hidden<TM, TN>(act, wm + (static_cast<size_t>(k) * nh + l) * Hp * Hp, slab, BK, acc, ty,
                          tx, tid);
    const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp + tx;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int grow = row0 + ty * TM + r;
      const size_t g0 = (l + 1) * BHp + static_cast<size_t>(grow) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float a = acc[r][j] + bias[32 * j];
        const float h = gelu_tanh(a);
        act[(ty * TM + r) * Hp + tx + 32 * j] = h;
        if (grow < B) {
          hs_g[g0 + 32 * j] = h;
          gs_g[g0 + 32 * j] = gelu_tanh_grad(a);
        }
      }
    }
    __syncthreads();
  }

  // ---- output layer: [t | s'] = h_nh Wout + bout
  matmul_narrow<TM, TN>(act, wout + static_cast<size_t>(k) * Hp * n_out, n_out, 1,
                        bout + static_cast<size_t>(k) * n_out, outs, n_out, ty, tx);
  __syncthreads();

  // ---- backward through the mix and the affine update
  for (int p = tid; p < BM * size; p += kThreads) {
    const int r = p / size, i = p % size;
    float v = dys[p];
    if (inner) {  // dx2 = dy Q^T
      v = 0.0f;
      for (int j = 0; j < size; ++j) v = fmaf(dys[r * size + j], Q[i * size + j], v);
    }
    dx2s[p] = v;
  }
  __syncthreads();
  for (int p = tid; p < BM * d_b; p += kThreads) {
    const int r = p / d_b, j = p % d_b;
    const float s = tanhf(outs[r * n_out + d_b + j]);
    const float es = expf(s);
    const float dzb = dx2s[r * size + d_a + j];
    const float ds = dzb * es * x1s[r * size + d_a + j] + dlds[r];
    outs[r * n_out + j] = dzb;                       // dt
    outs[r * n_out + d_b + j] = ds * (1.0f - s * s);  // ds'
    dx1s[r * size + d_a + j] = dzb * es;
  }
  __syncthreads();
  for (int p = tid; p < BM * n_out; p += kThreads) {
    if (row0 + p / n_out < B) dout_g[static_cast<size_t>(row0) * n_out + p] = outs[p];
  }

  // ---- dh = dout Wout^T; da_nh = gelu'(a_nh) dh
  {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;
    for (int c = 0; c < n_out; ++c) {
      const float* wr = woutT + static_cast<size_t>(c) * Hp + tx;
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = wr[32 * j];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float d = outs[(ty * TM + r) * n_out + c];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(d, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int grow = row0 + ty * TM + r;
      const size_t g0 = static_cast<size_t>(grow) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float da = grow < B ? acc[r][j] * gs_g[nh * BHp + g0 + 32 * j] : 0.0f;
        act[(ty * TM + r) * Hp + tx + 32 * j] = da;
        if (grow < B) da_g[(nh - 1) * BHp + g0 + 32 * j] = da;
      }
    }
  }
  __syncthreads();

  // ---- hidden layers backward: dh = da_{l+1} Wm_l^T; da_l = gelu'(a_l) dh
  for (int l = nh - 1; l >= 0; --l) {
    float acc[TM][TN];
    matmul_hidden<TM, TN>(act, wmT + static_cast<size_t>(l) * Hp * Hp, slab, BK, acc, ty, tx, tid);
    float* dst = l > 0 ? da_g + (l - 1) * BHp : dhp + static_cast<size_t>(k) * BHp;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int grow = row0 + ty * TM + r;
      const size_t g0 = static_cast<size_t>(grow) * Hp + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float da = grow < B ? acc[r][j] * gs_g[l * BHp + g0 + 32 * j] : 0.0f;
        act[(ty * TM + r) * Hp + tx + 32 * j] = da;
        if (grow < B) dst[g0 + 32 * j] = da;
      }
    }
    __syncthreads();
  }

  // ---- dx_a through the MLP: da_0 W1y^T
  matmul_narrow<TM, TN>(act, w1y + static_cast<size_t>(k) * d_a * Hp, 1, Hp, nullptr, dxas, d_a,
                        ty, tx);
  __syncthreads();

  // ---- dx1, the carried dx = dx1 s_k, and the ActNorm rows [dx1 x_k | dx1 | dld]
  for (int p = tid; p < BM * size; p += kThreads) {
    const int r = p / size, i = p % size;
    const int grow = row0 + r;
    if (grow < B) {
      const float d = i < d_a ? dx2s[p] + dxas[r * d_a + i] : dx1s[p];
      dxy[static_cast<size_t>(row0) * size + p] = inner ? d * sc[i] : d;
      float* an = an_g + static_cast<size_t>(grow) * n_an;
      an[i] = d * xs[p];
      an[size + i] = d;
    }
  }
  if (tid < BM && row0 + tid < B) an_g[static_cast<size_t>(row0 + tid) * n_an + 2 * size] = dlds[tid];
}

// out[z] = in[z]^T for a batch of rows x cols matrices (32 x 32 tiles).
__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
                                 int cols) {
  __shared__ float tile[32][33];
  const size_t off = static_cast<size_t>(blockIdx.z) * rows * cols;
  const int c0 = blockIdx.x * 32;
  const int r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[off + static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) out[off + static_cast<size_t>(c) * rows + r] = tile[threadIdx.x][i];
  }
}

// dscale[k] = sum(dx1 x_k) + sum(dld) / scale[k], dbias[k] = sum(dx1); zero
// at the final step, whose ActNorm slot is the identity.
__global__ void actnorm_grad_kernel(const float* __restrict__ sums, const float* __restrict__ an_s,
                                    float* __restrict__ dan_s, float* __restrict__ dan_b, int S,
                                    int size) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * size) return;
  const int k = idx / size, i = idx % size;
  if (k < S - 1) {
    const float* sk = sums + static_cast<size_t>(k) * (2 * size + 1);
    dan_s[idx] = sk[i] + sk[2 * size] / an_s[idx];
    dan_b[idx] = sk[size + i];
  } else {
    dan_s[idx] = 0.0f;
    dan_b[idx] = 0.0f;
  }
}

template <int TN>
cudaError_t launch_rows(const float* bound, const float* h_proj, const float* dld,
                        const float* an_s, const float* an_b, const float* ortho, const float* w1y,
                        const float* b1, const float* wm, const float* bm, const float* wout,
                        const float* bout, const float* wmT, const float* woutT, float* dxy,
                        float* dhp, float* hs, float* gs, float* da, float* dout, float* x1,
                        float* an, int B, int S, int k, int size, int d_a, int nh,
                        cudaStream_t stream) {
  constexpr int BM = kWarps * kRowTM;
  constexpr int Hp = 32 * TN;
  const int n_out = 2 * (size - d_a);
  const size_t fixed = sizeof(float) * (static_cast<size_t>(BM) * Hp +
                                        static_cast<size_t>(BM) * (5 * size + n_out + d_a + 1));
  int BK = 16;
  while (BK >= 4 && fixed + sizeof(float) * 2 * BK * Hp > kSmemLimit) BK /= 2;
  if (BK < 4) return cudaErrorInvalidValue;
  const size_t smem = fixed + sizeof(float) * 2 * BK * Hp;
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_rows_kernel<TN><<<(B + BM - 1) / BM, kThreads, smem, stream>>>(
      bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, wmT, woutT, dxy, dhp, hs,
      gs, da, dout, x1, an, B, S, k, size, d_a, nh, BK);
  return cudaGetLastError();
}

size_t scratch_floats(int B, int S, int size, int d_a, int nh, int Hp) {
  const size_t n_out = 2 * static_cast<size_t>(size - d_a);
  const size_t BHp = static_cast<size_t>(B) * Hp;
  return static_cast<size_t>(nh) * Hp * Hp + n_out * Hp  // this step's Wm^T, Wout^T
         + (3 * static_cast<size_t>(nh) + 2) * BHp       // h_l, gelu'(a_l): nh+1 each; da_1..nh
         + static_cast<size_t>(B) * (n_out + size + 2 * size + 1)  // dout, x1, ActNorm rows
         + static_cast<size_t>(S) * (2 * size + 1);                // ActNorm column sums
}

}  // namespace

// Floats of scratch `bcnf_flow_train_bwd` needs (the wrapper allocates it).
extern "C" long long bcnf_flow_train_bwd_scratch(int B, int S, int size, int d_a, int nh, int Hp) {
  return static_cast<long long>(scratch_floats(B, S, size, d_a, nh, Hp));
}

// K2b: every grad of the training forward. Inputs as K2a's plus bound
// (S, B, size), dz (B, size) and dld (B); writes dx (B, size), dhp (S, B, Hp),
// dan_s/dan_b (S, size), dw1y (S, d_a, Hp), db1 (S, Hp), dwm (S, nh, Hp, Hp),
// dbm (S, nh, Hp), dwout (S, Hp, n_out), dbout (S, n_out). Hp must be 32*TN
// for a compiled TN. Returns the first failing launch's cudaError_t.
extern "C" int bcnf_flow_train_bwd(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wm,
    const float* bm, const float* wout, const float* bout, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int S, int size, int d_a, int nh, int Hp, void* stream) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || Hp % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = 2 * (size - d_a);
  const int n_an = 2 * size + 1;
  const size_t BHp = static_cast<size_t>(B) * Hp;
  float* wmT = scratch;
  float* woutT = wmT + static_cast<size_t>(nh) * Hp * Hp;
  float* hs = woutT + static_cast<size_t>(n_out) * Hp;
  float* gs = hs + (nh + 1) * BHp;
  float* da = gs + (nh + 1) * BHp;
  float* dout = da + nh * BHp;
  float* x1 = dout + static_cast<size_t>(B) * n_out;
  float* an = x1 + static_cast<size_t>(B) * size;
  float* sums = an + static_cast<size_t>(B) * n_an;

  cudaError_t err = cudaMemcpyAsync(dx, dz, sizeof(float) * B * size, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int k = S - 1; k >= 0; --k) {
    const float* wm_k = wm + static_cast<size_t>(k) * nh * Hp * Hp;
    transpose_kernel<<<dim3(Hp / 32, Hp / 32, nh), dim3(32, 8), 0, st>>>(wm_k, wmT, Hp, Hp);
    transpose_kernel<<<dim3((n_out + 31) / 32, Hp / 32, 1), dim3(32, 8), 0, st>>>(
        wout + static_cast<size_t>(k) * Hp * n_out, woutT, Hp, n_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

#define BCNF_CASE(TN)                                                                             \
  case TN:                                                                                        \
    err = launch_rows<TN>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, wmT, \
                          woutT, dx, dhp, hs, gs, da, dout, x1, an, B, S, k, size, d_a, nh, st);   \
    break;
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
    if (err != cudaSuccess) return err;

    AtbJob jobs[kMaxJobs * 2];
    int n_jobs = 0;
    for (int l = 0; l < nh && n_jobs < 2 * kMaxJobs - 3; ++l) {
      const size_t wl = static_cast<size_t>(k) * nh + l;
      jobs[n_jobs++] = {hs + l * BHp, da + l * BHp, dwm + wl * Hp * Hp, dbm + wl * Hp, Hp, Hp, Hp, Hp, B};
    }
    if (n_jobs != nh) return cudaErrorInvalidValue;  // more hidden layers than the job table holds
    jobs[n_jobs++] = {hs + nh * BHp, dout, dwout + static_cast<size_t>(k) * Hp * n_out,
                      dbout + static_cast<size_t>(k) * n_out, Hp, n_out, Hp, n_out, B};
    jobs[n_jobs++] = {x1, dhp + k * BHp, dw1y + static_cast<size_t>(k) * d_a * Hp,
                      db1 + static_cast<size_t>(k) * Hp, size, Hp, d_a, Hp, B};
    jobs[n_jobs++] = {nullptr, an, nullptr, sums + static_cast<size_t>(k) * n_an, 0, n_an, 0, n_an, B};
    if ((err = launch_atb(jobs, n_jobs, st)) != cudaSuccess) return err;
  }
  actnorm_grad_kernel<<<(S * size + 255) / 256, 256, 0, st>>>(sums, an_s, dan_s, dan_b, S, size);
  return cudaGetLastError();
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
