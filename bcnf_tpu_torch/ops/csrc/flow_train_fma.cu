// The backward of the whole conditional RealNVP flow for training in exact
// float32 (the strict mode, `pallas_strict`): K2b on the FMA pipe, every
// product and every sum in float32, no tensor-core instruction.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py, `bwd_call` of
// `_make_fused_flow_train` at precision="highest" (the Pallas TPU kernel
// `_flow_bwd_train_kernel` with every `_dot` at Precision.HIGHEST), which the
// JAX model's strict flag selects for training (bcnf_tpu/models/cnf.py,
// `forward_fused_flow`). Host side and plain PyTorch version
// (`fused_flow_train_backward_reference` with mm=torch.matmul):
// bcnf_tpu_torch/ops/flow_kernel.py. Its forward, the strict K2a, is
// flow_fma.cu's `fma_flow_train_kernel`.
//
// What it computes is what flow_train_kernel.cu computes (the 3xTF32 K2b):
// from the step inputs x_k = bound[k], the cotangents dz, dld and the
// weights, walking k = S-1 .. 0: the step's MLP recomputed from x1 = x_k s_k
// + b_k (h_l = gelu(a_l)); dx2 = dy Q_k^T; dout = [dz_b | (dz_b e^s x1_b +
// dld)(1 - s^2)]; dh = dout Wout^T, da_l = gelu'(a_l) dh, dh = da_l Wm^T ..;
// dh_proj[k] = da_0; dx1 = [dx2_a + da_0 W1y^T | dz_b e^s], dy <- dx1 s_k;
// the weight grads summed over the B rows (dWm_l = h_l^T da_{l+1}, dWout =
// h_nh^T dout, dW1y = x1_a^T da_0), the biases' column sums and the
// ActNorm's dscale = sum dx1 x_k + sum(dld) / s_k, dbias = sum dx1 (zero at
// the final step). The orthonormal mixes get no grad.
//
// What bounds it on an H100: operations at the float32 FMA rate (66.9
// TFLOP/s). At the flagship's widths (H 526, 4 hidden layers, 26 steps) a
// row costs three times K1's forward, ~175 MFLOP: 717 GFLOP at 4096 rows,
// 10.7 ms at the FMA rate.
//
// Design: the simple correct kernel first, on flow_fma.cu's parts (its lane
// layout, its products and its producer's bulk-copy ring). Per step, in
// reverse order, on the caller's stream:
// 1. `ft_rows_kernel`: persistent blocks, one an SM, over balanced ranges of
//    row groups, in rounds of two groups, as the strict K1: 8 consumer warps
//    (2 row groups x 4 column quarters, a lane R rows x TN columns) and a
//    producer warpgroup, one thread of which streams every weight the step
//    uses through the ring in the order used: W1y, Wm_l, Wout (the
//    recompute), Wout^T, Wm_l^T for l = nh-1 .. 0, W1y^T (the backward). The
//    transposed weights are copied once a call by `ft_transpose_kernel`
//    (rows of W^T as the products read rows of W). h_l and gelu'(a_l) go to
//    a global scratch ((nh+1) x B x Hp each) and da_l after them, as in
//    flow_train_kernel.cu; each lane reads back only what it wrote.
// 2. `ft_atb_kernel`: every weight grad of the step as C = A^T B over the B
//    rows in one launch (nh + 3 jobs), A's column m taken to be all ones so
//    that row m is B's column sums (the bias and ActNorm sums). A block owns
//    one 64 x 64 tile of one job and walks all B rows in order, 32 at a
//    time, through a 3-stage cp.async ring (16-byte copies where rows are
//    aligned, 4-byte ones at ragged or unaligned edges: no thread waits on
//    a load); each 32-row stage is summed into
//    fresh registers and then added to the running sum (a two-level sum:
//    ~160 float32 additions deep, not 4096).
// After the last step `ft_actnorm_kernel` forms the ActNorm grads. No
// atomics, every sum in a fixed order: two calls give equal bits. Rows past B
// are computed on zeros and never stored or summed. The entry point's
// `parts` mask runs the rows kernels (1, with the copy of dz and the
// transposes), the weight-grad passes (2) or the ActNorm grads (4) alone.

#define BCNF_FMA_DEVICE_ONLY  // flow_fma.cu's device parts, without its kernels and entry points
#include "flow_fma.cu"

namespace {

using namespace bcnf;

constexpr int kFtMaxJobs = 32;  // weight-grad jobs one launch holds: nh + 3 a step
constexpr int kFtTile = 64;     // the weight-grad pass's output tile (kFtTile x kFtTile)
constexpr int kFtK = 32;        // rows of A and B a stage of that pass
constexpr int kFtRing = 3;      // its cp.async stages
constexpr int kFtThreads = 128;

// W1y^T's row length: d_a rounded up to even (its output layer reads pairs).
__host__ __device__ constexpr int ft_dap(int d_a) { return d_a + (d_a & 1); }

// Floats a ring stage of the rows kernel holds: the strict K1's stage, and
// at least 4 rows of W1y^T.
__host__ __device__ constexpr int ft_stage(int TN, int size, int d_a) {
  return fma_stage(TN, size, d_a) > 4 * ft_dap(d_a) ? fma_stage(TN, size, d_a) : 4 * ft_dap(d_a);
}

// Shared memory a block of the rows kernel takes: the ring's two barriers a
// stage, the transposed tile, the ring, and the round's rows of [x_k | x1 |
// dy | dx2 | [t | s'], then dout | dz_b e^s | da_0 W1y^T | dld].
__host__ __device__ constexpr size_t ft_smem(int TN, int size, int d_a, int stages) {
  return 16 * static_cast<size_t>(stages) +
         sizeof(float) * (static_cast<size_t>(32 * TN) * (8 * fma_lane_rows(TN) + 4) +
                          static_cast<size_t>(stages) * ft_stage(TN, size, d_a) +
                          static_cast<size_t>(8 * fma_lane_rows(TN)) *
                              (4 * size + 3 * (size - d_a) + ft_dap(d_a) + 1));
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

// The recompute's epilogue: h = gelu(acc + bias) into the tile, and h and
// gelu'(acc + bias) to the layer's scratch rows hs, gs (B x Hp; rows past B
// not stored). `row` is the lane's first row; bias may be null.
template <int R, int TN>
__device__ __forceinline__ void keep_act(float* at, const float (&acc)[R][TN], const float* bias, float* hs,
                                         float* gs, int row, int B, int cq, int lc) {
  using Sh = FmaShape<TN>;
  float b[TN];
  if (bias != nullptr) {
    load_cols<TN>(bias, cq, lc, b);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < Sh::Q4; ++q) {  // 4 adjacent columns: 16-byte stores to the scratch
    float h[4][R], g[4][R];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < R; ++r) gelu_and_grad(acc[r][4 * q + c] + b[4 * q + c], h[c][r], g[c][r]);
      store_col<R>(at, Sh::col(4 * q + c, cq, lc), Sh::ldT, h[c]);
    }
    const int col = Sh::col(4 * q, cq, lc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row + r < B) {
        const size_t o = static_cast<size_t>(row + r) * Sh::Hp + col;
        *reinterpret_cast<float4*>(hs + o) = make_float4(h[0][r], h[1][r], h[2][r], h[3][r]);
        *reinterpret_cast<float4*>(gs + o) = make_float4(g[0][r], g[1][r], g[2][r], g[3][r]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Sh::Q1; ++i) {
    const int j = 4 * Sh::Q4 + i, col = Sh::col(j, cq, lc);
    float h[R], g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gelu_and_grad(acc[r][j] + b[j], h[r], g[r]);
    store_col<R>(at, col, Sh::ldT, h);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row + r < B) {
        hs[static_cast<size_t>(row + r) * Sh::Hp + col] = h[r];
        gs[static_cast<size_t>(row + r) * Sh::Hp + col] = g[r];
      }
    }
  }
}

// The backward's epilogue: da = acc gelu'(a), gelu'(a) read back from the
// layer's scratch rows gs (this lane's own writes; 0 past B), into the tile
// and to dst (B x Hp; rows past B not stored).
template <int R, int TN>
__device__ __forceinline__ void grad_act(float* at, const float (&acc)[R][TN], const float* gs, float* dst, int row,
                                         int B, int cq, int lc) {
  using Sh = FmaShape<TN>;
#pragma unroll
  for (int q = 0; q < Sh::Q4; ++q) {
    const int col = Sh::col(4 * q, cq, lc);
    float d[4][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t o = static_cast<size_t>(row + r) * Sh::Hp + col;
      const float4 g = row + r < B ? *reinterpret_cast<const float4*>(gs + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      d[0][r] = acc[r][4 * q] * g.x;
      d[1][r] = acc[r][4 * q + 1] * g.y;
      d[2][r] = acc[r][4 * q + 2] * g.z;
      d[3][r] = acc[r][4 * q + 3] * g.w;
      if (row + r < B) *reinterpret_cast<float4*>(dst + o) = make_float4(d[0][r], d[1][r], d[2][r], d[3][r]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) store_col<R>(at, Sh::col(4 * q + c, cq, lc), Sh::ldT, d[c]);
  }
#pragma unroll
  for (int i = 0; i < Sh::Q1; ++i) {
    const int j = 4 * Sh::Q4 + i, col = Sh::col(j, cq, lc);
    float d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t o = static_cast<size_t>(row + r) * Sh::Hp + col;
      d[r] = row + r < B ? acc[r][j] * gs[o] : 0.0f;
      if (row + r < B) dst[o] = d[r];
    }
    store_col<R>(at, col, Sh::ldT, d);
  }
}

template <int TN>
__global__ void __launch_bounds__(kFmaThreads, 1)
ft_rows_kernel(const float* __restrict__ bound, const float* __restrict__ h_proj, const float* __restrict__ dld,
               const float* __restrict__ an_s, const float* __restrict__ an_b, const float* __restrict__ ortho,
               const float* __restrict__ w1y, const float* __restrict__ b1, const float* __restrict__ wm,
               const float* __restrict__ bm, const float* __restrict__ wout, const float* __restrict__ bout,
               const float* __restrict__ wmT, const float* __restrict__ woutT, const float* __restrict__ w1yT,
               float* __restrict__ dxy, float* __restrict__ dhp, float* __restrict__ hs_g, float* __restrict__ gs_g,
               float* __restrict__ da_g, float* __restrict__ dout_g, float* __restrict__ x1_g,
               float* __restrict__ an_g, int B, int S, int k, int size, int d_a, int nh, int stages, int groups) {
  using Sh = FmaShape<TN>;
  constexpr int Hp = Sh::Hp, BK = Sh::BK, ldT = Sh::ldT, R = Sh::R, G = Sh::G, BM = Sh::BM;
  const int d_b = size - d_a, n_out = 2 * d_b, d_ap = ft_dap(d_a), n_an = 2 * size + 1;
  const bool inner = k < S - 1;  // step S-1 is the final coupling alone
  const size_t BHp = static_cast<size_t>(B) * Hp;
  const int stage = ft_stage(TN, size, d_a);
  const int n_in = (d_a + BK - 1) / BK;                // stages of W1y
  const int out_rows = min(Hp, (stage / n_out) & ~3);  // rows of Wout a stage
  const int n_outs = (Hp + out_rows - 1) / out_rows;
  const int n_dh = (n_out + BK - 1) / BK;              // stages of Wout^T
  const int t_rows = min(Hp, (stage / d_ap) & ~3);     // rows of W1y^T a stage
  const int n_t = (Hp + t_rows - 1) / t_rows;

  const float* sc = an_s + static_cast<size_t>(k) * size;
  const float* bi = an_b + static_cast<size_t>(k) * size;
  const float* Q = ortho + static_cast<size_t>(k) * size * size;
  const float* w1y_k = w1y + static_cast<size_t>(k) * d_a * Hp;
  const float* wm_k = wm + static_cast<size_t>(k) * nh * Hp * Hp;
  const float* wout_k = wout + static_cast<size_t>(k) * Hp * n_out;
  const float* wmT_k = wmT + static_cast<size_t>(k) * nh * Hp * Hp;
  const float* woutT_k = woutT + static_cast<size_t>(k) * n_out * Hp;
  const float* w1yT_k = w1yT + static_cast<size_t>(k) * Hp * d_ap;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + stages;
  float* actT = reinterpret_cast<float*>(empty + stages);  // Hp x ldT: a[row][k] at actT[k * ldT + row]
  float* ring = actT + Hp * ldT;
  float* xs = ring + static_cast<size_t>(stages) * stage;  // BM x size: x_k
  float* x1s = xs + BM * size;                             // BM x size: after the ActNorm
  float* dys = x1s + BM * size;                            // BM x size: cotangent of the step's output
  float* dx2s = dys + BM * size;                           // BM x size: dy Q^T
  float* outs = dx2s + BM * size;                          // BM x n_out: [t | s'], then dout
  float* dx1b = outs + BM * n_out;                         // BM x d_b: dz_b e^s
  float* dxas = dx1b + BM * d_b;                           // BM x d_ap: da_0 W1y^T
  float* dlds = dxas + BM * d_ap;                          // BM

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

  if (warp >= kFmaWarps) {  // ---- the producer: every weight the step uses, in the order used
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
      for (int j = 0; j < n_in; ++j) push(w1y_k + static_cast<size_t>(j) * BK * Hp, min(BK, d_a - j * BK) * Hp);
      for (int l = 0; l < nh; ++l)
        for (int s = 0; s < Hp / BK; ++s) push(wm_k + (static_cast<size_t>(l) * Hp + s * BK) * Hp, BK * Hp);
      for (int j = 0; j < n_outs; ++j)
        push(wout_k + static_cast<size_t>(j) * out_rows * n_out, min(out_rows, Hp - j * out_rows) * n_out);
      for (int j = 0; j < n_dh; ++j) push(woutT_k + static_cast<size_t>(j) * BK * Hp, min(BK, n_out - j * BK) * Hp);
      for (int l = nh - 1; l >= 0; --l)
        for (int s = 0; s < Hp / BK; ++s) push(wmT_k + (static_cast<size_t>(l) * Hp + s * BK) * Hp, BK * Hp);
      for (int j = 0; j < n_t; ++j)
        push(w1yT_k + static_cast<size_t>(j) * t_rows * d_ap, min(t_rows, Hp - j * t_rows) * d_ap);
    }
    return;
  }

  // ---- a consumer warp: row group rg, column quarter cq; its lane's rows in
  // the products prod_row .. (by lane / 8), its own rows for the row work and
  // the narrow outputs own_row .. (by cq): R of each.
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
  auto zero = [](float (&acc)[R][TN]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;
  };

  for (int t = 0; t < rounds; ++t) {
    const bool active = g0 + 2 * t + rg < g1;  // the row group has rows this round
    const int row0 = (g0 + 2 * t) * G;          // the round's first row
    const int lrow = row0 + prod_row;           // the lane's first row in the products

    // ---- the warp's own rows: x_k, x1 (to the scratch for dW1y), dy, dld
    if (active) {
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p, i = p % size;
        const bool valid = row0 + q / size < B;
        const float xv = valid ? bound[(static_cast<size_t>(k) * B + row0) * size + q] : 0.0f;
        const float x1 = inner ? xv * sc[i] + bi[i] : xv;
        xs[q] = xv;
        x1s[q] = x1;
        dys[q] = valid ? dxy[static_cast<size_t>(row0) * size + q] : 0.0f;
        if (valid) x1_g[static_cast<size_t>(row0) * size + q] = x1;
      }
      if (lane < R) dlds[own_row + lane] = row0 + own_row + lane < B ? dld[row0 + own_row + lane] : 0.0f;
    }
    // the input layer's sums start at b1 + h_proj[k, row] (0 past B)
    float acc[R][TN];
    if (active) {
      float b[TN];
      load_cols<TN>(b1 + static_cast<size_t>(k) * Hp, cq, lc, b);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float h[TN];
        if (lrow + r < B) {
          load_cols<TN>(h_proj + (static_cast<size_t>(k) * B + lrow + r) * Hp, cq, lc, h);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) h[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = b[j] + h[j];
      }
    }
    group_sync(rg);  // the group's x1 is ready, and the last round's readers of the tile are done

    // ---- recompute: a_0 = x1_a W1y + b1 + h_proj, h_0 = gelu(a_0)
    for (int j = 0; j < n_in; ++j) {
      const float* ws = wait();
      if (active) input_product<R, TN>(ws, min(BK, d_a - j * BK), x1s + prod_row * size + j * BK, size, acc, cq, lc);
      release();
    }
    if (active) keep_act<R, TN>(at, acc, nullptr, hs_g, gs_g, lrow, B, cq, lc);
    group_sync(rg);

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l)
    for (int l = 0; l < nh; ++l) {
      zero(acc);
#pragma unroll 1
      for (int s = 0; s < Hp / BK; ++s) {
        const float* ws = wait();
        if (active) hidden_product<R, TN>(ws, at + s * BK * ldT, acc, cq, lc);
        release();
      }
      group_sync(rg);  // every warp of the group is done reading the tile
      if (active)
        keep_act<R, TN>(at, acc, bm + (static_cast<size_t>(k) * nh + l) * Hp, hs_g + (l + 1) * BHp,
                        gs_g + (l + 1) * BHp, lrow, B, cq, lc);
      group_sync(rg);
    }

    // ---- output layer: [t | s'] = h_nh Wout + bout, the warp's own rows
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

    // ---- the warp's own rows: dx2 = dy Q^T, dout, dz_b e^s
    if (active) {
      for (int p = lane; p < R * size; p += 32) {
        const int r = own_row + p / size, i = p % size;
        float v = dys[r * size + i];
        if (inner) {
          v = 0.0f;
          for (int j = 0; j < size; ++j) v = fmaf(dys[r * size + j], Q[i * size + j], v);
        }
        dx2s[r * size + i] = v;
      }
      __syncwarp();
      for (int p = lane; p < R * d_b; p += 32) {
        const int r = p / d_b, j = p % d_b, rr = own_row + r;
        const float s = tanhf(o[r * n_out + d_b + j]);
        const float es = expf(s);
        const float dzb = dx2s[rr * size + d_a + j];
        const float ds = dzb * es * x1s[rr * size + d_a + j] + dlds[rr];
        o[r * n_out + j] = dzb;                       // dt
        o[r * n_out + d_b + j] = ds * (1.0f - s * s);  // ds'
        dx1b[rr * d_b + j] = dzb * es;
      }
      __syncwarp();
      for (int p = lane; p < R * n_out; p += 32)
        if (row0 + own_row + p / n_out < B) dout_g[static_cast<size_t>(row0 + own_row) * n_out + p] = o[p];
    }
    group_sync(rg);  // the group's dout is ready, and the output layer's reads of the tile are done

    // ---- dh = dout Wout^T; da_nh = gelu'(a_nh) dh
    zero(acc);
    for (int j = 0; j < n_dh; ++j) {
      const float* ws = wait();
      if (active) input_product<R, TN>(ws, min(BK, n_out - j * BK), outs + prod_row * n_out + j * BK, n_out, acc, cq, lc);
      release();
    }
    if (active) grad_act<R, TN>(at, acc, gs_g + nh * BHp, da_g + (nh - 1) * BHp, lrow, B, cq, lc);
    group_sync(rg);

    // ---- hidden layers backward: dh = da_{l+1} Wm_l^T; da_l = gelu'(a_l) dh
    for (int l = nh - 1; l >= 0; --l) {
      zero(acc);
#pragma unroll 1
      for (int s = 0; s < Hp / BK; ++s) {
        const float* ws = wait();
        if (active) hidden_product<R, TN>(ws, at + s * BK * ldT, acc, cq, lc);
        release();
      }
      group_sync(rg);
      if (active)
        grad_act<R, TN>(at, acc, gs_g + l * BHp, l > 0 ? da_g + (l - 1) * BHp : dhp + static_cast<size_t>(k) * BHp,
                        lrow, B, cq, lc);
      group_sync(rg);
    }

    // ---- dx_a through the MLP: da_0 W1y^T, the warp's own rows
    float* dxa = dxas + own_row * d_ap;
    if (active)
      for (int p = lane; p < R * d_ap; p += 32) dxa[p] = 0.0f;
    __syncwarp();
    for (int j = 0; j < n_t; ++j) {
      const float* ws = wait();
      if (active)
        output_product<R>(ws, min(t_rows, Hp - j * t_rows), actT + j * t_rows * ldT + own_row, ldT, dxa, d_ap, lane);
      release();
    }
    __syncwarp();

    // ---- dx1, the carried dx = dx1 s_k, and the ActNorm rows [dx1 x_k | dx1 | dld]
    if (active) {
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p, r = q / size, i = p % size, grow = row0 + r;
        if (grow < B) {
          const float d = i < d_a ? dx2s[q] + dxas[r * d_ap + i] : dx1b[r * d_b + i - d_a];
          dxy[static_cast<size_t>(row0) * size + q] = inner ? d * sc[i] : d;
          float* an = an_g + static_cast<size_t>(grow) * n_an;
          an[i] = d * xs[q];
          an[size + i] = d;
        }
      }
      if (lane < R && row0 + own_row + lane < B)
        an_g[static_cast<size_t>(row0 + own_row + lane) * n_an + 2 * size] = dlds[own_row + lane];
    }
    __syncwarp();
  }
}

// C = A^T B over the k rows of A (k x m, ld lda) and B (k x n, ld ldb); A's
// column m is taken to be all ones, so that row m of the product (written to
// `sums`, where not null) is B's column sums. m = 0: the sums alone.
struct FtJob {
  const float* a;
  const float* b;
  float* c;     // m x n, row-major
  float* sums;  // n
  int lda, ldb, m, n;
};
struct FtJobs {
  FtJob job[kFtMaxJobs];
  int first[kFtMaxJobs + 1];  // first block of each job
  int n_jobs, k;
};

__host__ __device__ inline int ft_tiles_m(const FtJob& jb) {
  return (jb.m + (jb.sums != nullptr ? 1 : 0) + kFtTile - 1) / kFtTile;
}
__host__ __device__ inline int ft_tiles_n(const FtJob& jb) { return (jb.n + kFtTile - 1) / kFtTile; }

// A block: one kFtTile x kFtTile tile of one job, its 128 threads each 4
// rows (m) x 8 columns (n: 4 at 4 tx, 4 at 32 + 4 tx) of it.
__global__ void __launch_bounds__(kFtThreads) ft_atb_kernel(const FtJobs jobs) {
  int j = 0;
  while (j + 1 < jobs.n_jobs && static_cast<int>(blockIdx.x) >= jobs.first[j + 1]) ++j;
  const FtJob jb = jobs.job[j];
  const int tn = ft_tiles_n(jb), local = blockIdx.x - jobs.first[j];
  const int m0 = local / tn * kFtTile, n0 = local % tn * kFtTile;
  const int K = jobs.k;

  extern __shared__ float4 ft_smem4[];
  float* smem = reinterpret_cast<float*>(ft_smem4);  // kFtRing stages of [A: kFtK x kFtTile | B: kFtK x kFtTile]
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const bool vec_a = jb.m > 0 && (jb.lda & 3) == 0 && (reinterpret_cast<size_t>(jb.a) & 15) == 0;
  const bool vec_b = (jb.ldb & 3) == 0 && (reinterpret_cast<size_t>(jb.b) & 15) == 0;

  // rows kt kFtK .. of A's columns m0 .. (ones at column m, zeros past it and
  // past the k rows) and of B's columns n0 .. into stage s
  auto load_stage = [&](int s, int kt) {
    float* as = smem + s * 2 * kFtK * kFtTile;
    float* bs = as + kFtK * kFtTile;
    for (int e = tid; e < kFtK * kFtTile / 4; e += kFtThreads) {
      const int kr = e / (kFtTile / 4), q = e % (kFtTile / 4) * 4, row = kt * kFtK + kr;
      float* da = as + kr * kFtTile + q;
      const int m = m0 + q;
      if (row < K && vec_a && m + 3 < jb.m) {
        cp_async16(da, jb.a + static_cast<size_t>(row) * jb.lda + m);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row < K && m + i < jb.m) cp_async4(da + i, jb.a + static_cast<size_t>(row) * jb.lda + m + i);
          else da[i] = row < K && m + i == jb.m ? 1.0f : 0.0f;
        }
      }
      float* db = bs + kr * kFtTile + q;
      const int n = n0 + q;
      if (row < K && vec_b && n + 3 < jb.n) {
        cp_async16(db, jb.b + static_cast<size_t>(row) * jb.ldb + n);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row < K && n + i < jb.n) cp_async4(db + i, jb.b + static_cast<size_t>(row) * jb.ldb + n + i);
          else db[i] = 0.0f;
        }
      }
    }
  };

  float sum[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) sum[i][c] = 0.0f;
  const int nk = (K + kFtK - 1) / kFtK;
#pragma unroll
  for (int s = 0; s < kFtRing - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFtRing - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; stage kt-1 is free again
    if (kt + kFtRing - 1 < nk) load_stage((kt + kFtRing - 1) % kFtRing, kt + kFtRing - 1);
    cp_async_commit();
    const float* as = smem + (kt % kFtRing) * 2 * kFtK * kFtTile;
    const float* bs = as + kFtK * kFtTile;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < kFtK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(as + kk * kFtTile + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kFtTile + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kFtTile + 32 + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) sum[i][c] += acc[i][c];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + (c < 4 ? 4 * tx + c : 32 + 4 * tx + c - 4);
      if (n >= jb.n) continue;
      if (m < jb.m) jb.c[static_cast<size_t>(m) * jb.n + n] = sum[i][c];
      else if (m == jb.m && jb.sums != nullptr) jb.sums[n] = sum[i][c];
    }
  }
}

// out[b][c][r] = in[b][r][c] for r < rows, 0 for rows <= r < ld_out: a
// batch of rows x cols matrices transposed into rows of ld_out floats.
__global__ void ft_transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int rows, int cols,
                                    int ld_out) {
  __shared__ float tile[32][33];
  const float* src = in + static_cast<size_t>(blockIdx.z) * rows * cols;
  float* dst = out + static_cast<size_t>(blockIdx.z) * cols * ld_out;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] = r < rows && c < cols ? src[static_cast<size_t>(r) * cols + c] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < ld_out) dst[static_cast<size_t>(c) * ld_out + r] = tile[threadIdx.x][i];
  }
}

cudaError_t transpose(const float* in, float* out, int batch, int rows, int cols, int ld_out, cudaStream_t stream) {
  ft_transpose_kernel<<<dim3((cols + 31) / 32, (ld_out + 31) / 32, batch), dim3(32, 8), 0, stream>>>(in, out, rows,
                                                                                                    cols, ld_out);
  return cudaGetLastError();
}

// dscale[k] = sum(dx1 x_k) + sum(dld) / scale[k], dbias[k] = sum(dx1); zero
// at the final step, whose ActNorm slot is the identity.
__global__ void ft_actnorm_kernel(const float* __restrict__ sums, const float* __restrict__ an_s,
                                  float* __restrict__ dan_s, float* __restrict__ dan_b, int S, int size) {
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

// The rows kernel's launch: blocks, ring stages and shared memory, or
// cudaErrorInvalidValue where no ring fits (the host's copy:
// ops/flow_kernel.py::fma_train_layout).
cudaError_t ft_layout(int TN, int B, int size, int d_a, int sms, int* blocks, int* stages, size_t* smem) {
  *stages = 0;
  for (int r = kFmaRingMax; r >= kFmaRingMin && *stages == 0; --r)
    if (ft_smem(TN, size, d_a, r) <= kSmemLimit) *stages = r;
  if (*stages == 0) return cudaErrorInvalidValue;
  *smem = ft_smem(TN, size, d_a, *stages);
  const int groups = (B + 4 * fma_lane_rows(TN) - 1) / (4 * fma_lane_rows(TN));
  *blocks = groups < sms ? groups : sms;
  return cudaSuccess;
}

template <int TN>
cudaError_t launch_rows(const float* bound, const float* h_proj, const float* dld, const float* an_s,
                        const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wm,
                        const float* bm, const float* wout, const float* bout, const float* wmT, const float* woutT,
                        const float* w1yT, float* dxy, float* dhp, float* hs, float* gs, float* da, float* dout,
                        float* x1, float* an, int B, int S, int k, int size, int d_a, int nh, int sms,
                        cudaStream_t stream) {
  int blocks, stages;
  size_t smem;
  cudaError_t err = ft_layout(TN, B, size, d_a, sms, &blocks, &stages, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ft_rows_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (B + FmaShape<TN>::G - 1) / FmaShape<TN>::G;
  ft_rows_kernel<TN><<<blocks, kFmaThreads, smem, stream>>>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm,
                                                            wout, bout, wmT, woutT, w1yT, dxy, dhp, hs, gs, da, dout,
                                                            x1, an, B, S, k, size, d_a, nh, stages, groups);
  return cudaGetLastError();
}

cudaError_t launch_atb(const FtJob* list, int n_jobs, int K, cudaStream_t stream) {
  if (n_jobs < 1 || n_jobs > kFtMaxJobs) return cudaErrorInvalidValue;
  FtJobs jobs = {};
  jobs.n_jobs = n_jobs;
  jobs.k = K;
  int blocks = 0;
  for (int j = 0; j < n_jobs; ++j) {
    jobs.job[j] = list[j];
    jobs.first[j] = blocks;
    blocks += ft_tiles_m(list[j]) * ft_tiles_n(list[j]);
  }
  jobs.first[n_jobs] = blocks;
  const int smem = static_cast<int>(sizeof(float)) * kFtRing * 2 * kFtK * kFtTile;
  cudaError_t err = cudaFuncSetAttribute(ft_atb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ft_atb_kernel<<<blocks, kFtThreads, smem, stream>>>(jobs);
  return cudaGetLastError();
}

size_t align4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// The scratch's parts, in floats, in order: Wm^T, Wout^T, W1y^T; h_l and
// gelu'(a_l) (nh + 1 each), da_1 .. da_nh; dout, x1, the ActNorm rows; the
// ActNorm column sums. Each starts 16-byte aligned.
void scratch_parts(int B, int S, int size, int d_a, int nh, int Hp, size_t* parts) {
  const size_t n_out = 2 * static_cast<size_t>(size - d_a), BHp = static_cast<size_t>(B) * Hp;
  const size_t lens[] = {static_cast<size_t>(S) * nh * Hp * Hp, S * n_out * Hp, static_cast<size_t>(S) * Hp * ft_dap(d_a),
                         (nh + 1) * BHp, (nh + 1) * BHp, nh * BHp, B * n_out, static_cast<size_t>(B) * size,
                         static_cast<size_t>(B) * (2 * size + 1), static_cast<size_t>(S) * (2 * size + 1)};
  parts[0] = 0;
  for (int i = 0; i < 10; ++i) parts[i + 1] = parts[i] + align4(lens[i]);
}

}  // namespace

// Floats of scratch `bcnf_flow_train_bwd_fma` needs (the wrapper allocates it).
extern "C" long long bcnf_flow_train_fma_scratch(int B, int S, int size, int d_a, int nh, int Hp) {
  size_t parts[11];
  scratch_parts(B, S, size, d_a, nh, Hp, parts);
  return static_cast<long long>(parts[10]);
}

// The rows kernel's layout a call at this shape takes on the current card:
// out[0..4] = rows a lane, blocks, ring stages, floats a stage, bytes of
// shared memory.
extern "C" int bcnf_flow_train_fma_layout(int B, int size, int d_a, int Hp, int* out) {
  if (B <= 0 || d_a <= 0 || d_a >= size || Hp % 32 != 0 || Hp / 32 > 32) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  int blocks = 0, stages = 0;
  size_t smem = 0;
  const cudaError_t err = ft_layout(Hp / 32, B, size, d_a, sms, &blocks, &stages, &smem);
  out[0] = fma_lane_rows(Hp / 32);
  out[1] = blocks;
  out[2] = stages;
  out[3] = ft_stage(Hp / 32, size, d_a);
  out[4] = static_cast<int>(smem);
  return err;
}

// The strict K2b: every grad of the training forward, in float32 FMA.
// Arguments as flow_train_kernel.cu's `bcnf_flow_train_bwd` (the 3xTF32
// K2b); Hp must be 32*TN for a compiled TN, nh >= 1 with nh + 3 jobs within
// kFtMaxJobs, the rows kernel's ring within a block's shared memory, the
// weights, b1, bm and h_proj 16-byte aligned: else cudaErrorInvalidValue.
// `parts` (bits) runs the rows kernels (1, with the copy of dz and the
// transposed weights), the weight-grad passes (2) and the ActNorm grads (4);
// the wrapper passes 7. Returns the first failing launch's cudaError_t.
extern "C" int bcnf_flow_train_bwd_fma(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wm,
    const float* bm, const float* wout, const float* bout, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || nh + 3 > kFtMaxJobs || Hp % 32 != 0 ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(wout) |
        reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(b1) | reinterpret_cast<size_t>(bm) |
        reinterpret_cast<size_t>(scratch)) & 15) != 0)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = 2 * (size - d_a), n_an = 2 * size + 1, d_ap = ft_dap(d_a);
  const size_t BHp = static_cast<size_t>(B) * Hp;
  size_t at[11];
  scratch_parts(B, S, size, d_a, nh, Hp, at);
  float* wmT = scratch + at[0];
  float* woutT = scratch + at[1];
  float* w1yT = scratch + at[2];
  float* hs = scratch + at[3];
  float* gs = scratch + at[4];
  float* da = scratch + at[5];
  float* dout = scratch + at[6];
  float* x1 = scratch + at[7];
  float* an = scratch + at[8];
  float* sums = scratch + at[9];

  cudaError_t err;
  if (parts & 1) {
    if ((err = cudaMemcpyAsync(dx, dz, sizeof(float) * B * size, cudaMemcpyDeviceToDevice, st)) != cudaSuccess ||
        (err = transpose(wm, wmT, S * nh, Hp, Hp, Hp, st)) != cudaSuccess ||
        (err = transpose(wout, woutT, S, Hp, n_out, Hp, st)) != cudaSuccess ||
        (err = transpose(w1y, w1yT, S, d_a, Hp, d_ap, st)) != cudaSuccess)
      return err;
  }
  for (int k = S - 1; k >= 0; --k) {
    if (parts & 1) {
#define BCNF_CASE(TN)                                                                                             \
  case TN:                                                                                                        \
    err = launch_rows<TN>(bound, h_proj, dld, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, wmT, woutT, w1yT, dx, \
                          dhp, hs, gs, da, dout, x1, an, B, S, k, size, d_a, nh, sms, st);                        \
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
    }
    if (parts & 2) {
      FtJob jobs[kFtMaxJobs];
      int n_jobs = 0;
      for (int l = 0; l < nh; ++l) {
        const size_t wl = static_cast<size_t>(k) * nh + l;
        jobs[n_jobs++] = {hs + l * BHp, da + l * BHp, dwm + wl * Hp * Hp, dbm + wl * Hp, Hp, Hp, Hp, Hp};
      }
      jobs[n_jobs++] = {hs + nh * BHp, dout, dwout + static_cast<size_t>(k) * Hp * n_out,
                        dbout + static_cast<size_t>(k) * n_out, Hp, n_out, Hp, n_out};
      jobs[n_jobs++] = {x1, dhp + k * BHp, dw1y + static_cast<size_t>(k) * d_a * Hp, db1 + static_cast<size_t>(k) * Hp,
                        size, Hp, d_a, Hp};
      jobs[n_jobs++] = {nullptr, an, nullptr, sums + static_cast<size_t>(k) * n_an, 0, n_an, 0, n_an};
      if ((err = launch_atb(jobs, n_jobs, B, st)) != cudaSuccess) return err;
    }
  }
  if (parts & 4) {
    ft_actnorm_kernel<<<(S * size + 255) / 256, 256, 0, st>>>(sums, an_s, dan_s, dan_b, S, size);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
