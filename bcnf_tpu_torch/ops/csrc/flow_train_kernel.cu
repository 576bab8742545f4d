// The backward of the whole conditional RealNVP flow for training: K2b.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `bwd_call` of
// `_make_fused_flow_train` (the Pallas TPU kernel `_flow_bwd_train_kernel`).
// Host side and plain PyTorch version (`fused_flow_train_backward_reference`):
// bcnf_tpu_torch/ops/flow_kernel.py. Its forward, K2a, is in flow_kernel.cu.
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
// products: about three times K2a's ~58 MFLOP a row. The square hidden
// products and the weight grads run on tensor cores in 3xTF32
// (mma_tf32.cuh, the counterpart of the JAX kernel's "x3" mode), so the
// bound is 3 x operations at the dense TF32 rate; the narrow products (the
// d_a inputs, the n_out outputs, the mixes) stay float32 FMA.
//
// The reduced mode (the library built with BCNF_TF32_PASSES=1, flow_rows.cuh:
// the JAX kernel's "default" mode, which serves the "default", "bfloat16" and
// "BF16_BF16_F32_X3" precisions) takes the square hidden products and the
// weight grads in one TF32 pass, each operand rounded once (mma_tf32.cuh:
// `mma_passes<1>`); its bound is operations at the dense TF32 rate. The narrow
// products and the mixes stay float32 FMA, and the column sums (bias and
// ActNorm grads) 3xTF32, as in the default mode (atb.cuh).
//
// Design, per step, in reverse order (all launches on the caller's stream):
// 1. `bwd_rows_kernel`: one block of 512 threads (16 warps, so that each
//    scheduler has four to hide the fragment loads' and the products'
//    latency) owns BM rows (32, or 16 at the widest hidden widths), as K1
//    does. It recomputes the MLP and runs the backward on one activation
//    tile in shared memory, with the row-tile machinery it shares with K2a
//    (flow_rows.cuh): each square product on `mma.sync` in 3xTF32, the
//    weight streamed through a 3-stage cp.async ring (W^T read as it is
//    stored, so no transposed copy is made), the narrow products' weights
//    (W1y, Wout) staged in the same ring. h_l and gelu'(a_l) (one tanh for both) go to a global scratch
//    ((nh+1) x B x Hp each) and da_l after them: the TPU kernel kept these in
//    a 100 MB VMEM window, a block's 227 KB cannot. The carried dx is
//    updated in place: a block only touches its own rows.
// 2. `atb_kernel` (atb.cuh, shared with the LSTM backward): every weight
//    grad of the step as C = A^T B over the B rows in one launch, tensor
//    cores in 3xTF32; A's column M is taken to be all ones, so row M of the
//    product is the column sums (the bias grads and the ActNorm sums). No
//    atomics, one block a row range in a fixed order: the TPU kernel's
//    VMEM-resident accumulation made deterministic.
// After the last step, `actnorm_grad_kernel` forms the ActNorm grads from the
// column sums. Rows past B are computed on zeros and never stored or summed.
// The entry point's `parts` mask runs the rows kernels (1), the weight-grad
// passes (2) or the ActNorm grads (4) alone, so each part can be timed.

#include "atb.cuh"
#include "flow_rows.cuh"

namespace {

using namespace bcnf;

template <int TN, int BM, int BK>
__global__ void __launch_bounds__(kRowThreads, 1)
bwd_rows_kernel(const float* __restrict__ bound, const float* __restrict__ h_proj,
                const float* __restrict__ dld, const float* __restrict__ an_s,
                const float* __restrict__ an_b, const float* __restrict__ ortho,
                const float* __restrict__ w1y, const float* __restrict__ b1,
                const float* __restrict__ wm, const float* __restrict__ bm,
                const float* __restrict__ wout, const float* __restrict__ bout,
                float* __restrict__ dxy, float* __restrict__ dhp, float* __restrict__ hs_g,
                float* __restrict__ gs_g, float* __restrict__ da_g, float* __restrict__ dout_g,
                float* __restrict__ x1_g, float* __restrict__ an_g, int B, int S, int k, int size,
                int d_a, int nh) {
  using Sh = RowShape<TN, BM, BK>;
  constexpr int Hp = Sh::Hp, MT = Sh::MT, NTW = Sh::NTW, ldA = Sh::ldA;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;
  const int n_an = 2 * size + 1;
  const bool inner = k < S - 1;
  const size_t BHp = static_cast<size_t>(B) * Hp;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // BM x Hp (ld ldA)
  float* ring = act + BM * ldA;                  // kRingStages weight stages
  float* xs = ring + kRingStages * Sh::stage;    // BM x size: x_k
  float* x1s = xs + BM * size;                   // BM x size: after the ActNorm
  float* dys = x1s + BM * size;                  // BM x size: cotangent of the step's output
  float* dx2s = dys + BM * size;                 // BM x size: dy Q^T
  float* dx1s = dx2s + BM * size;                // BM x size: x_b part of dx1
  float* outs = dx1s + BM * size;                // BM x n_out: [t | s'], then dout
  float* dxas = outs + BM * n_out;               // BM x d_a: da_0 W1y^T
  float* dlds = dxas + BM * d_a;                 // BM

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const float* sc = an_s + static_cast<size_t>(k) * size;
  const float* bi = an_b + static_cast<size_t>(k) * size;
  const float* Q = ortho + static_cast<size_t>(k) * size * size;

  auto store2 = [](float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); };
  auto load2 = [](const float* p) { return *reinterpret_cast<const float2*>(p); };
  auto pairs = [&](auto&& f) { each_pair<TN, BM, BK>(warp, lane, f); };

  // ---- the step's input rows, the incoming cotangent, dlogdet
  for (int p = tid; p < BM * size; p += kRowThreads) {
    const bool valid = row0 + p / size < B;
    xs[p] = valid ? bound[(static_cast<size_t>(k) * B + row0) * size + p] : 0.0f;
    dys[p] = valid ? dxy[static_cast<size_t>(row0) * size + p] : 0.0f;
  }
  if (tid < BM) dlds[tid] = row0 + tid < B ? dld[row0 + tid] : 0.0f;
  __syncthreads();
  for (int p = tid; p < BM * size; p += kRowThreads) {
    const int i = p % size;
    x1s[p] = inner ? xs[p] * sc[i] + bi[i] : xs[p];
    if (row0 + p / size < B) x1_g[static_cast<size_t>(row0) * size + p] = x1s[p];
  }
  __syncthreads();

  // h = gelu(a) into the tile, and h, gelu'(a) of layer `l` to the scratch
  auto keep = [&](int l, int row, int col, float a0, float a1) {
    float h0, h1, d0, d1;
    gelu_and_grad(a0, h0, d0);
    gelu_and_grad(a1, h1, d1);
    store2(act + row * ldA + col, h0, h1);
    if (row0 + row < B) {
      const size_t o = l * BHp + static_cast<size_t>(row0 + row) * Hp + col;
      store2(hs_g + o, h0, h1);
      store2(gs_g + o, d0, d1);
    }
  };
  // The narrow products' weights go into the ring (free between the square
  // products): W1y[k] (d_a x Hp), Wout[k] (Hp x n_out).
  const float* w1_g = w1y + static_cast<size_t>(k) * d_a * Hp;
  const float* wo_g = wout + static_cast<size_t>(k) * Hp * n_out;
  const bool in_ring = Sh::narrow_in_ring(size, d_a);

  // ---- recompute the MLP: a_0 = x1_a W1y + b1 + h_proj[k, row] (FMA)
  {
    const float* w1 = stage_weight(ring, w1_g, d_a * Hp, in_ring, tid);
    pairs([&](int row, int col, int, int, int) {
      const float* hp = row0 + row < B ? h_proj + (static_cast<size_t>(k) * B + row0 + row) * Hp : nullptr;
      const float2 a = input_layer<Hp>(x1s + row * size, w1, b1 + static_cast<size_t>(k) * Hp, hp, d_a, col);
      keep(0, row, col, a.x, a.y);
    });
  }

  // ---- hidden layers: a_{l+1} = h_l Wm_l + bm_l on tensor cores
  for (int l = 0; l < nh; ++l) {
    float acc[MT][NTW][4];
    const size_t wl = static_cast<size_t>(k) * nh + l;
    square_product<TN, BM, BK, false>(act, wm + wl * Hp * Hp, ring, acc, warp, lane, tid);
    const float* bias = bm + wl * Hp;
    pairs([&](int row, int col, int mi, int i, int h) {
      keep(l + 1, row, col, acc[mi][i][2 * h] + bias[col], acc[mi][i][2 * h + 1] + bias[col + 1]);
    });
  }
  __syncthreads();

  // ---- output layer: [t | s'] = h_nh Wout + bout (FMA)
  const float* wo = stage_weight(ring, wo_g, Hp * n_out, in_ring, tid);
  narrow_product(act, ldA, BM, Hp, wo, n_out, 1, bout + static_cast<size_t>(k) * n_out, outs, n_out, tid);
  __syncthreads();

  // ---- backward through the mix and the affine update
  for (int p = tid; p < BM * size; p += kRowThreads) {
    const int r = p / size, i = p % size;
    float v = dys[p];
    if (inner) {  // dx2 = dy Q^T
      v = 0.0f;
      for (int j = 0; j < size; ++j) v = fmaf(dys[r * size + j], Q[i * size + j], v);
    }
    dx2s[p] = v;
  }
  __syncthreads();
  for (int p = tid; p < BM * d_b; p += kRowThreads) {
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
  for (int p = tid; p < BM * n_out; p += kRowThreads) {
    if (row0 + p / n_out < B) dout_g[static_cast<size_t>(row0) * n_out + p] = outs[p];
  }

  // da = gelu'(a_l) dh into the tile and to `dst` (rows past B: zeros)
  auto grad = [&](int l, float* dst, int row, int col, float d0, float d1) {
    const bool valid = row0 + row < B;
    const size_t o = static_cast<size_t>(row0 + row) * Hp + col;
    const float2 gp = valid ? load2(gs_g + l * BHp + o) : make_float2(0.0f, 0.0f);
    const float da0 = d0 * gp.x, da1 = d1 * gp.y;
    store2(act + row * ldA + col, da0, da1);
    if (valid) store2(dst + o, da0, da1);
  };

  // ---- dh = dout Wout^T (FMA, Wout still staged); da_nh = gelu'(a_nh) dh
  {
    pairs([&](int row, int col, int, int, int) {
      float d0 = 0.0f, d1 = 0.0f;
      for (int c = 0; c < n_out; ++c) {
        const float d = outs[row * n_out + c];
        d0 = fmaf(d, wo[static_cast<size_t>(col) * n_out + c], d0);
        d1 = fmaf(d, wo[static_cast<size_t>(col + 1) * n_out + c], d1);
      }
      grad(nh, da_g + (nh - 1) * BHp, row, col, d0, d1);
    });
  }

  // ---- hidden layers backward: dh = da_{l+1} Wm_l^T; da_l = gelu'(a_l) dh
  for (int l = nh - 1; l >= 0; --l) {
    float acc[MT][NTW][4];
    square_product<TN, BM, BK, true>(act, wm + (static_cast<size_t>(k) * nh + l) * Hp * Hp, ring, acc, warp,
                                     lane, tid);
    float* dst = l > 0 ? da_g + (l - 1) * BHp : dhp + static_cast<size_t>(k) * BHp;
    pairs([&](int row, int col, int mi, int i, int h) {
      grad(l, dst, row, col, acc[mi][i][2 * h], acc[mi][i][2 * h + 1]);
    });
  }
  __syncthreads();

  // ---- dx_a through the MLP: da_0 W1y^T (FMA)
  narrow_product(act, ldA, BM, Hp, stage_weight(ring, w1_g, d_a * Hp, in_ring, tid), 1, Hp, nullptr, dxas, d_a, tid);
  __syncthreads();

  // ---- dx1, the carried dx = dx1 s_k, and the ActNorm rows [dx1 x_k | dx1 | dld]
  for (int p = tid; p < BM * size; p += kRowThreads) {
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

template <int TN, int BM, int BK>
cudaError_t launch_rows(const float* bound, const float* h_proj, const float* dld,
                        const float* an_s, const float* an_b, const float* ortho, const float* w1y,
                        const float* b1, const float* wm, const float* bm, const float* wout,
                        const float* bout, float* dxy, float* dhp, float* hs, float* gs, float* da,
                        float* dout, float* x1, float* an, int B, int S, int k, int size, int d_a, int nh,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (RowShape<TN, BM, BK>::tile_floats +
                                       static_cast<size_t>(BM) * (5 * size + 2 * (size - d_a) + d_a + 1));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_kernel<TN, BM, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_rows_kernel<TN, BM, BK><<<(B + BM - 1) / BM, kRowThreads, smem, stream>>>(
      bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, dxy, dhp, hs, gs, da, dout, x1,
      an, B, S, k, size, d_a, nh);
  return cudaGetLastError();
}

size_t scratch_floats(int B, int S, int size, int d_a, int nh, int Hp) {
  const size_t n_out = 2 * static_cast<size_t>(size - d_a);
  const size_t BHp = static_cast<size_t>(B) * Hp;
  return (3 * static_cast<size_t>(nh) + 2) * BHp                  // h_l, gelu'(a_l): nh+1 each; da_1..nh
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
// for a compiled TN; the weights 16-byte aligned; the rows kernel's shared
// memory bounds `size` (at Hp = 544, size <= 38; the repo's models have at
// most 21): a shape past it returns cudaErrorInvalidValue. `parts` (bits) runs the
// rows kernels (1, with the copy of dz that starts them), the weight-grad
// passes (2) and the ActNorm grads (4); the wrapper passes 7. Returns the
// first failing launch's cudaError_t.
extern "C" int bcnf_flow_train_bwd(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wm,
    const float* bm, const float* wout, const float* bout, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || nh + 3 > kAtbMaxJobs || Hp % 32 != 0 ||
      ((reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(wout)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = 2 * (size - d_a);
  const int n_an = 2 * size + 1;
  const size_t BHp = static_cast<size_t>(B) * Hp;
  float* hs = scratch;
  float* gs = hs + (nh + 1) * BHp;
  float* da = gs + (nh + 1) * BHp;
  float* dout = da + nh * BHp;
  float* x1 = dout + static_cast<size_t>(B) * n_out;
  float* an = x1 + static_cast<size_t>(B) * size;
  float* sums = an + static_cast<size_t>(B) * n_an;

  cudaError_t err;
  if ((parts & 1) &&
      (err = cudaMemcpyAsync(dx, dz, sizeof(float) * B * size, cudaMemcpyDeviceToDevice, st)) != cudaSuccess)
    return err;
  for (int k = S - 1; k >= 0; --k) {
    if (parts & 1) {
#define BCNF_CASE(TN, BM, BK)                                                                          \
  case TN:                                                                                             \
    err = launch_rows<TN, BM, BK>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, dx, \
                                  dhp, hs, gs, da, dout, x1, an, B, S, k, size, d_a, nh, st);          \
    break;
      BCNF_ROW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
      if (err != cudaSuccess) return err;
    }
    if (parts & 2) {
      AtbJob jobs[kAtbMaxJobs];
      int n_jobs = 0;
      for (int l = 0; l < nh; ++l) {
        const size_t wl = static_cast<size_t>(k) * nh + l;
        jobs[n_jobs++] = {hs + l * BHp, da + l * BHp, dwm + wl * Hp * Hp, dbm + wl * Hp, Hp, Hp, Hp, Hp, B, B};
      }
      jobs[n_jobs++] = {hs + nh * BHp, dout, dwout + static_cast<size_t>(k) * Hp * n_out,
                        dbout + static_cast<size_t>(k) * n_out, Hp, n_out, Hp, n_out, B, B};
      jobs[n_jobs++] = {x1, dhp + k * BHp, dw1y + static_cast<size_t>(k) * d_a * Hp,
                        db1 + static_cast<size_t>(k) * Hp, size, Hp, d_a, Hp, B, B};
      jobs[n_jobs++] = {nullptr, an, nullptr, sums + static_cast<size_t>(k) * n_an, 0, n_an, 0, n_an, B, B};
      if ((err = launch_atb<kPasses>(jobs, n_jobs, st)) != cudaSuccess) return err;
    }
  }
  if (parts & 4) {
    actnorm_grad_kernel<<<(S * size + 255) / 256, 256, 0, st>>>(sums, an_s, dan_s, dan_b, S, size);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
