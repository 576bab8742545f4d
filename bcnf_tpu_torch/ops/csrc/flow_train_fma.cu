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
// weights, walking k = S-1 .. 0: x1 = x_k s_k + b_k; dx2 = dy Q_k^T; dout =
// [dz_b | (dz_b e^s x1_b + dld)(1 - s^2)]; dh = dout Wout^T, da_l = gelu'(a_l)
// dh, dh = da_l Wm^T ..; dh_proj[k] = da_0; dx1 = [dx2_a + da_0 W1y^T | dz_b
// e^s], dy <- dx1 s_k; the weight grads summed over the B rows (dWm_l = h_l^T
// da_{l+1}, dWout = h_nh^T dout, dW1y = x1_a^T da_0), the biases' column
// sums and the ActNorm's dscale = sum dx1 x_k + sum(dld) / s_k, dbias = sum
// dx1 (zero at the final step). The orthonormal mixes get no grad.
//
// What bounds it on an H100: operations at the float32 FMA rate (66.9
// TFLOP/s). At the flagship's widths (H 526, 4 hidden layers, 26 steps) the
// function is three times K1's forward a row, ~175 MFLOP: 717 GFLOP at 4096
// rows, 10.7 ms. This kernel recomputes nothing of the MLP: the strict K2a
// keeps h_l, gelu'(a_l) and s for it (flow_fma.cu: fma_keep_act), so it does
// two thirds of that work (478 GFLOP, 7.1 ms at the FMA rate) and reads
// 2(nh + 1) B Hp floats of activations instead.
//
// Design (each point answers a measurement of the first strict K2b, which
// recomputed the MLP a step in a rows kernel a step and ran a weight-grad
// pass a step: PERF.md, `tools/strict_train_parts.py`):
// 1. `ft_rows_kernel`, one launch for every step: persistent blocks, one an
//    SM, over balanced ranges of row groups, in rounds of two groups, on the
//    strict K1's lane layout (8 consumer warps: 2 row groups x 4 column
//    quarters, a lane R rows x TN columns; flow_fma.cu). A round walks k =
//    S-1 .. 0 with its rows' carried dy in shared memory; a producer thread
//    streams the weights of every step through one ring, running ahead
//    across layers and steps: Wout^T, Wm_l^T for l = nh-1 .. 0, W1y^T (rows
//    of W^T as the products read rows of W, copied once a call by
//    `ft_transpose_kernel`), each layer's weights followed by its gelu'(a_l)
//    from K2a's keep, one stage for each row group's block (as K2a's
//    epilogue writes it: flow_fma.cu's keep_grad_at), so that the
//    epilogue reads them from shared memory (read from device memory by each
//    lane, they cost 2.7 ms: `no_acts`); s is read from the keep. x1, dout,
//    da_l (l >= 1) and the ActNorm rows [dx1 x_k | dx1 | dld] of every step
//    go to the scratch, da_0 to dh_proj.
// 2. `ft_atb_kernel`, one launch for every step's weight grads: C = A^T B
//    over the B rows for nh + 3 jobs a step (S x the tiles of a step), A's
//    column m taken to be all ones so that row m is B's column sums (the
//    bias and ActNorm sums). A block owns one 128 x 128 tile of one job of
//    one step, 256 threads of 8 x 8 outputs (2 x 2 blocks of 4 x 4), and
//    walks all B rows in order, 32 at a time, through a 3-stage cp.async
//    ring; each 32-row stage is summed into fresh registers and then added
//    to the running sum (a two-level sum, ~160 float32 additions deep: one
//    running sum over the 4096 rows doubles the distance from float64,
//    `tools/strict_train_parts.py`'s atb_one_level). The fresh sums take one
//    row half at a time (three 16-byte shared loads for 32 FMAs a row), so
//    that two blocks fit an SM (128 registers): 16 warps to hide the loads'
//    latencies, which the first design lacked (1 block of 4 warps an SM:
//    +45%). A tile whose rows or columns end within its first half skips
//    its other half (block-uniform: the tiles at Hp 544's edges, the narrow
//    jobs).
// After the weight grads `ft_actnorm_kernel` forms the ActNorm grads. No
// atomics, every sum in a fixed order: two calls give equal bits. Rows past B
// are computed on zeros and never stored or summed. The entry point's
// `parts` mask runs the rows kernel (1, with the transposed weights' copies),
// the weight-grad pass (2) or the ActNorm grads (4) alone.

#define BCNF_FMA_DEVICE_ONLY  // flow_fma.cu's device parts, without its kernels and entry points
#include "flow_fma.cu"

namespace {

using namespace bcnf;

constexpr int kFtMaxJobs = 32;  // weight-grad jobs a step one launch holds: nh + 3
constexpr int kFtTile = 128;    // the weight-grad pass's output tile (kFtTile x kFtTile)
constexpr int kFtK = 32;        // rows of A and B a stage of that pass
constexpr int kFtRing = 3;      // its cp.async stages
constexpr int kFtThreads = 256;

// W1y^T's row length: d_a rounded up to even (its output layer reads pairs).
__host__ __device__ constexpr int ft_dap(int d_a) { return d_a + (d_a & 1); }

// Floats a ring stage of the rows kernel holds: the strict K1's stage, and
// at least 4 rows of W1y^T.
__host__ __device__ constexpr int ft_stage(int TN, int size, int d_a) {
  return fma_stage(TN, size, d_a) > 4 * ft_dap(d_a) ? fma_stage(TN, size, d_a) : 4 * ft_dap(d_a);
}

// Shared memory a block of the rows kernel takes: the ring's two barriers a
// stage, the transposed tile, the ring, and the round's rows of [x_k | x1 |
// dy | dx2 | dout | dz_b e^s | da_0 W1y^T | dld].
__host__ __device__ constexpr size_t ft_smem(int TN, int size, int d_a, int stages) {
  return 16 * static_cast<size_t>(stages) +
         sizeof(float) * (static_cast<size_t>(32 * TN) * (8 * fma_lane_rows(TN) + 4) +
                          static_cast<size_t>(stages) * ft_stage(TN, size, d_a) +
                          static_cast<size_t>(8 * fma_lane_rows(TN)) *
                              (4 * size + 3 * (size - d_a) + ft_dap(d_a) + 1));
}

// The backward's epilogue: da = acc gelu'(a), into the tile and to dst (B x
// Hp; rows past B not stored). gelu'(a) of the lane's rows (rb: lane / 8) is
// read from the ring stage that holds its row group's block of K2a's keep
// (`gs`, laid out as flow_fma.cu's keep_grad_at; d is 0 for rows past B).
// `row` is the lane's first row.
template <int R, int TN>
__device__ __forceinline__ void grad_act(float* at, const float (&acc)[R][TN], const float* gs, int rb, float* dst,
                                         int row, int B, int cq, int lc) {
  using Sh = FmaShape<TN>;
#pragma unroll
  for (int q = 0; q < Sh::Q4; ++q) {
    const int col = Sh::col(4 * q, cq, lc);
    float d[4][R];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float g[R];
      load_rows<R>(gs + keep_grad_at<R>(col + c, rb), g);
#pragma unroll
      for (int r = 0; r < R; ++r) d[c][r] = row + r < B ? acc[r][4 * q + c] * g[r] : 0.0f;
      store_col<R>(at, col + c, Sh::ldT, d[c]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row + r < B)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(row + r) * Sh::Hp + col) =
            make_float4(d[0][r], d[1][r], d[2][r], d[3][r]);
  }
#pragma unroll
  for (int i = 0; i < Sh::Q1; ++i) {
    const int j = 4 * Sh::Q4 + i, col = Sh::col(j, cq, lc);
    float d[R], g[R];
    load_rows<R>(gs + keep_grad_at<R>(col, rb), g);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = row + r < B ? acc[r][j] * g[r] : 0.0f;
      if (row + r < B) dst[static_cast<size_t>(row + r) * Sh::Hp + col] = d[r];
    }
    store_col<R>(at, col, Sh::ldT, d);
  }
}

// The scratch's parts, in floats, in order: Wm^T, Wout^T, W1y^T; da_1 ..
// da_nh of every step; dout, x1 and the ActNorm rows of every step; the
// ActNorm column sums. Each starts 16-byte aligned.
size_t align4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

void scratch_parts(int B, int S, int size, int d_a, int nh, int Hp, size_t* parts) {
  const size_t n_out = 2 * static_cast<size_t>(size - d_a), SB = static_cast<size_t>(S) * B;
  const size_t lens[] = {static_cast<size_t>(S) * nh * Hp * Hp, S * n_out * Hp, static_cast<size_t>(S) * Hp * ft_dap(d_a),
                         SB * nh * Hp, SB * n_out, SB * size, SB * (2 * size + 1), static_cast<size_t>(S) * (2 * size + 1)};
  parts[0] = 0;
  for (int i = 0; i < 8; ++i) parts[i + 1] = parts[i] + align4(lens[i]);
}

template <int TN>
__global__ void __launch_bounds__(kFmaThreads, 1)
ft_rows_kernel(const float* __restrict__ bound, const float* __restrict__ dz, const float* __restrict__ dld,
               const float* __restrict__ an_s, const float* __restrict__ an_b, const float* __restrict__ ortho,
               const float* __restrict__ keep, const float* __restrict__ wmT, const float* __restrict__ woutT,
               const float* __restrict__ w1yT, float* __restrict__ dx, float* __restrict__ dhp,
               float* __restrict__ da_g, float* __restrict__ dout_g, float* __restrict__ x1_g,
               float* __restrict__ an_g, int B, int Bs, int S, int size, int d_a, int nh, int stages, int groups) {
  using Sh = FmaShape<TN>;
  constexpr int Hp = Sh::Hp, BK = Sh::BK, ldT = Sh::ldT, R = Sh::R, G = Sh::G, BM = Sh::BM;
  const int d_b = size - d_a, n_out = 2 * d_b, d_ap = ft_dap(d_a), n_an = 2 * size + 1;
  const size_t BHp = static_cast<size_t>(B) * Hp;
  const int stage = ft_stage(TN, size, d_a);
  const int n_dh = (n_out + BK - 1) / BK;           // stages of Wout^T
  const int t_rows = min(Hp, (stage / d_ap) & ~3);  // rows of W1y^T a stage
  const int n_t = (Hp + t_rows - 1) / t_rows;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + stages;
  float* actT = reinterpret_cast<float*>(empty + stages);  // Hp x ldT: a[row][k] at actT[k * ldT + row]
  float* ring = actT + Hp * ldT;
  float* xs = ring + static_cast<size_t>(stages) * stage;  // BM x size: x_k
  float* x1s = xs + BM * size;                             // BM x size: after the ActNorm
  float* dys = x1s + BM * size;                            // BM x size: cotangent of the step's output, carried
  float* dx2s = dys + BM * size;                           // BM x size: dy Q^T
  float* outs = dx2s + BM * size;                          // BM x n_out: dout
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

  if (warp >= kFmaWarps) {  // ---- the producer: every step's transposed weights, in the order used
    if (threadIdx.x != kFmaConsumers) return;
    RingCursor next;
    int issued = 0;
    auto push = [&](const float* src, int floats) {  // floats 0: a stage with nothing in it
      if (issued++ >= stages) mbar_wait(empty + next.slot, next.phase ^ 1u);  // released by every warp
      const uint32_t bytes = 4u * static_cast<uint32_t>(floats);
      uint64_t* bar = full + next.slot;
      float* dst = ring + static_cast<size_t>(next.slot) * stage;
      if (bytes > 0) {
        mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);
      } else {
        mbar_arrive(bar);
      }
      next.advance(stages);
    };
    auto push_grad = [&](int t, int k, int l) {  // gelu'(a_l) of the round's two row groups, a stage each
      for (int h = 0; h < 2; ++h) {
        const int grp = g0 + 2 * t + h;
        push(keep + fma_keep_act(k, l, true, B, nh, Hp) + static_cast<size_t>(grp) * G * Hp, grp < g1 ? G * Hp : 0);
      }
    };
    for (int t = 0; t < rounds; ++t) {
      for (int k = S - 1; k >= 0; --k) {
        const float* wmT_k = wmT + static_cast<size_t>(k) * nh * Hp * Hp;
        const float* woutT_k = woutT + static_cast<size_t>(k) * n_out * Hp;
        const float* w1yT_k = w1yT + static_cast<size_t>(k) * Hp * d_ap;
        for (int j = 0; j < n_dh; ++j) push(woutT_k + static_cast<size_t>(j) * BK * Hp, min(BK, n_out - j * BK) * Hp);
        push_grad(t, k, nh);
        for (int l = nh - 1; l >= 0; --l) {
          for (int s = 0; s < Hp / BK; ++s) push(wmT_k + (static_cast<size_t>(l) * Hp + s * BK) * Hp, BK * Hp);
          push_grad(t, k, l);
        }
        for (int j = 0; j < n_t; ++j)
          push(w1yT_k + static_cast<size_t>(j) * t_rows * d_ap, min(t_rows, Hp - j * t_rows) * d_ap);
      }
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
    if (active) {  // the warp's own rows of dz and dld, carried through the steps
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p;
        dys[q] = row0 + q / size < B ? dz[static_cast<size_t>(row0) * size + q] : 0.0f;
      }
      if (lane < R) dlds[own_row + lane] = row0 + own_row + lane < B ? dld[row0 + own_row + lane] : 0.0f;
    }
    __syncwarp();

    for (int k = S - 1; k >= 0; --k) {
      const bool inner = k < S - 1;  // step S-1 is the final coupling alone
      const float* sc = an_s + static_cast<size_t>(k) * size;
      const float* bi = an_b + static_cast<size_t>(k) * size;
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      const float* sk = keep + fma_keep_s(k, B, S, nh, Hp, d_b);
      const size_t SBk = static_cast<size_t>(k) * B, SBsk = static_cast<size_t>(k) * Bs;

      // ---- the warp's own rows: x_k, x1 (to the scratch for dW1y), dx2 = dy Q^T, dout, dz_b e^s
      float* o = outs + own_row * n_out;
      if (active) {
        for (int p = lane; p < R * size; p += 32) {
          const int q = own_row * size + p, i = p % size;
          const bool valid = row0 + q / size < B;
          const float xv = valid ? bound[(SBsk + row0) * size + q] : 0.0f;
          const float x1 = inner ? xv * sc[i] + bi[i] : xv;
          xs[q] = xv;
          x1s[q] = x1;
          if (valid) x1_g[(SBk + row0) * size + q] = x1;
        }
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
          const float s = row0 + rr < B ? sk[(row0 + rr) * d_b + j] : 0.0f;
          const float es = expf(s);
          const float dzb = dx2s[rr * size + d_a + j];
          const float ds = dzb * es * x1s[rr * size + d_a + j] + dlds[rr];
          o[r * n_out + j] = dzb;                       // dt
          o[r * n_out + d_b + j] = ds * (1.0f - s * s);  // ds'
          dx1b[rr * d_b + j] = dzb * es;
        }
        __syncwarp();
        for (int p = lane; p < R * n_out; p += 32)
          if (row0 + own_row + p / n_out < B) dout_g[(SBk + row0 + own_row) * n_out + p] = o[p];
      }
      group_sync(rg);  // the group's dout is ready, and the last step's reads of the tile are done

      // ---- dh = dout Wout^T; da_nh = gelu'(a_nh) dh
      float acc[R][TN];
      zero(acc);
      for (int j = 0; j < n_dh; ++j) {
        const float* ws = wait();
        if (active)
          input_product<R, TN>(ws, min(BK, n_out - j * BK), outs + prod_row * n_out + j * BK, n_out, acc, cq, lc);
        release();
      }
      auto epilogue = [&](float* dst) {  // the next two stages: each row group's rows of gelu'(a_l)
        for (int h = 0; h < 2; ++h) {
          const float* gs = wait();
          if (active && h == rg) grad_act<R, TN>(at, acc, gs, (prod_row - rg * G) / R, dst, lrow, B, cq, lc);
          release();
        }
      };
      float* da_k = da_g + static_cast<size_t>(k) * nh * BHp;  // da_1 .. da_nh of step k
      epilogue(da_k + (nh - 1) * BHp);
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
        epilogue(l > 0 ? da_k + (l - 1) * BHp : dhp + SBsk * Hp);
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

      // ---- dx1, the carried dy = dx1 s_k, and the ActNorm rows [dx1 x_k | dx1 | dld]
      if (active) {
        for (int p = lane; p < R * size; p += 32) {
          const int q = own_row * size + p, r = q / size, i = p % size, grow = row0 + r;
          const float d = i < d_a ? dx2s[q] + dxas[r * d_ap + i] : dx1b[r * d_b + i - d_a];
          dys[q] = inner ? d * sc[i] : d;
          if (grow < B) {
            float* an = an_g + (SBk + grow) * n_an;
            an[i] = d * xs[q];
            an[size + i] = d;
          }
        }
        if (lane < R && row0 + own_row + lane < B) an_g[(SBk + row0 + own_row + lane) * n_an + 2 * size] = dlds[own_row + lane];
      }
      __syncwarp();
    }

    if (active) {  // the round's rows of dx
      for (int p = lane; p < R * size; p += 32) {
        const int q = own_row * size + p;
        if (row0 + q / size < B) dx[static_cast<size_t>(row0) * size + q] = dys[q];
      }
    }
  }
}

// C = A^T B over the k rows of A (k x m, ld lda) and B (k x n, ld ldb) of
// each step; A's column m is taken to be all ones, so that row m of the
// product (written to `sums`, where not null) is B's column sums. m = 0: the
// sums alone. Step s's operands and outputs start s times their stride on.
struct FtJob {
  const float* a;
  const float* b;
  float* c;     // m x n, row-major
  float* sums;  // n
  long long sa, sb, sc, ss;
  int lda, ldb, m, n;
};
struct FtJobs {
  FtJob job[kFtMaxJobs];
  int first[kFtMaxJobs + 1];  // first block of each job within a step
  int n_jobs, k;
};

__host__ __device__ inline int ft_tiles_m(const FtJob& jb) {
  return (jb.m + (jb.sums != nullptr ? 1 : 0) + kFtTile - 1) / kFtTile;
}
__host__ __device__ inline int ft_tiles_n(const FtJob& jb) { return (jb.n + kFtTile - 1) / kFtTile; }

// v = row[4t .. 4t+3] and row[64 + 4t .. 64 + 4t+3]: a thread's 8 columns
// of a tile's row of B in a stage (two 16-byte shared loads).
__device__ __forceinline__ void ld_frag(const float* row, int t, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 hi = *reinterpret_cast<const float4*>(row + kFtTile / 2 + 4 * t);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The tile's product over all k rows, MI x NJ of its 4 x 4 blocks a thread
// (2 x 2 as built; 1 where the tile's rows or columns end in its first half).
// A stage's rows are summed into fresh registers one row half at a time
// (4 x 4 NJ sums, then added to the running sums), so that a thread holds
// 64 running and 32 fresh sums: two blocks an SM at 128 registers. Every
// output's sum is taken in the same order as with all 64 fresh at once. A
// warp (16 rows x 32 columns of each half) with no row or no column in the
// job only loads, leaving the SM's issue slots to the other warps (the
// edges at Hp 544, dWout's 18 columns, dW1y's 11 rows).
template <int MI, int NJ>
__device__ __forceinline__ void atb_tile(const FtJob& jb, const float* a, const float* b, int K, int m0, int n0,
                                         float* smem, float (&sum)[8][8]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;  // a warp: 16 rows x 32 columns a half
  const bool vec_a = jb.m > 0 && (jb.lda & 3) == 0 && (reinterpret_cast<size_t>(a) & 15) == 0;
  const bool vec_b = (jb.ldb & 3) == 0 && (reinterpret_cast<size_t>(b) & 15) == 0;
  const int rows_m = MI * kFtTile / 2, cols_n = NJ * kFtTile / 2;  // the tile's part loaded
  // a warp whose first rows or columns lie past the job's has none in its other half either: it only loads
  const bool busy = m0 + (warp / 2) * 16 < jb.m + (jb.sums != nullptr ? 1 : 0) && n0 + (warp % 2) * 32 < jb.n;

  // rows kt kFtK .. of A's columns m0 .. (ones at column m, zeros past it and
  // past the k rows) and of B's columns n0 .. into stage s
  auto load_stage = [&](int s, int kt) {
    float* as = smem + s * 2 * kFtK * kFtTile;
    float* bs = as + kFtK * kFtTile;
    for (int e = tid; e < kFtK * kFtTile / 4; e += kFtThreads) {
      const int kr = e / (kFtTile / 4), q = e % (kFtTile / 4) * 4, row = kt * kFtK + kr;
      if (q < rows_m) {
        float* da = as + kr * kFtTile + q;
        const int m = m0 + q;
        if (row < K && vec_a && m + 3 < jb.m) {
          cp_async16(da, a + static_cast<size_t>(row) * jb.lda + m);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (row < K && m + i < jb.m) cp_async4(da + i, a + static_cast<size_t>(row) * jb.lda + m + i);
            else da[i] = row < K && m + i == jb.m ? 1.0f : 0.0f;
          }
        }
      }
      if (q < cols_n) {
        float* db = bs + kr * kFtTile + q;
        const int n = n0 + q;
        if (row < K && vec_b && n + 3 < jb.n) {
          cp_async16(db, b + static_cast<size_t>(row) * jb.ldb + n);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (row < K && n + i < jb.n) cp_async4(db + i, b + static_cast<size_t>(row) * jb.ldb + n + i);
            else db[i] = 0.0f;
          }
        }
      }
    }
  };

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
#pragma unroll
    for (int h = 0; h < MI; ++h) {  // the thread's row halves in turn: 4 x 4 NJ fresh sums at a time
      if (!busy) break;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.0f;  // the stage's fresh sums
#pragma unroll 4
      for (int kk = 0; kk < kFtK; ++kk) {
        float bv[8];
        const float4 a = *reinterpret_cast<const float4*>(as + kk * kFtTile + h * kFtTile / 2 + 4 * ty);
        ld_frag(bs + kk * kFtTile, tx, bv);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NJ; ++c) sum[4 * h + i][c] += acc[i][c];
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kFtThreads, 2) ft_atb_kernel(const FtJobs jobs) {
  const int per_step = jobs.first[jobs.n_jobs];
  const int step = blockIdx.x / per_step, local0 = blockIdx.x % per_step;
  int j = 0;
  while (j + 1 < jobs.n_jobs && local0 >= jobs.first[j + 1]) ++j;
  const FtJob jb = jobs.job[j];
  const int tn = ft_tiles_n(jb), local = local0 - jobs.first[j];
  const int m0 = local / tn * kFtTile, n0 = local % tn * kFtTile;
  const float* a = jb.a == nullptr ? nullptr : jb.a + step * jb.sa;
  const float* b = jb.b + step * jb.sb;
  float* c = jb.c == nullptr ? nullptr : jb.c + step * jb.sc;
  float* sums = jb.sums == nullptr ? nullptr : jb.sums + step * jb.ss;

  extern __shared__ float4 ft_smem4[];
  float* smem = reinterpret_cast<float*>(ft_smem4);  // kFtRing stages of [A: kFtK x kFtTile | B: kFtK x kFtTile]
  float sum[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) sum[i][cc] = 0.0f;
  const int mt = jb.m + (sums != nullptr ? 1 : 0);  // rows of the product, the sums' row included
  const bool two_m = mt - m0 > kFtTile / 2, two_n = jb.n - n0 > kFtTile / 2;
  if (two_m && two_n) atb_tile<2, 2>(jb, a, b, jobs.k, m0, n0, smem, sum);
  else if (two_m) atb_tile<2, 1>(jb, a, b, jobs.k, m0, n0, smem, sum);
  else if (two_n) atb_tile<1, 2>(jb, a, b, jobs.k, m0, n0, smem, sum);
  else atb_tile<1, 1>(jb, a, b, jobs.k, m0, n0, smem, sum);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : kFtTile / 2 + 4 * ty + i - 4);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int n = n0 + (cc < 4 ? 4 * tx + cc : kFtTile / 2 + 4 * tx + cc - 4);
      if (n >= jb.n) continue;
      if (m < jb.m) c[static_cast<size_t>(m) * jb.n + n] = sum[i][cc];
      else if (m == jb.m && sums != nullptr) sums[n] = sum[i][cc];
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
cudaError_t launch_rows(const float* bound, const float* dz, const float* dld, const float* an_s, const float* an_b,
                        const float* ortho, const float* keep, const float* wmT, const float* woutT, const float* w1yT,
                        float* dx, float* dhp, float* da, float* dout, float* x1, float* an, int B, int Bs, int S,
                        int size, int d_a, int nh, int sms, cudaStream_t stream) {
  int blocks, stages;
  size_t smem;
  cudaError_t err = ft_layout(TN, B, size, d_a, sms, &blocks, &stages, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ft_rows_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (B + FmaShape<TN>::G - 1) / FmaShape<TN>::G;
  ft_rows_kernel<TN><<<blocks, kFmaThreads, smem, stream>>>(bound, dz, dld, an_s, an_b, ortho, keep, wmT, woutT, w1yT,
                                                            dx, dhp, da, dout, x1, an, B, Bs, S, size, d_a, nh,
                                                            stages, groups);
  return cudaGetLastError();
}

// The weight-grad jobs of a step over B rows, with their strides between
// steps (dh_proj's rows of a step are Bs apart; the host's copy:
// ops/flow_kernel.py::fma_atb_jobs).
int atb_jobs(const float* keep, const float* dhp, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout,
             float* dbout, const float* da, const float* dout, const float* x1, const float* an, float* sums, int B,
             int Bs, int size, int d_a, int nh, int Hp, FtJob* jobs) {
  const int n_out = 2 * (size - d_a), n_an = 2 * size + 1;
  const long long BHp = static_cast<long long>(B) * Hp, keep_step = 2LL * (nh + 1) * fma_keep_rows(B, Hp) * Hp;
  int n = 0;
  for (int l = 0; l < nh; ++l)
    jobs[n++] = {keep + fma_keep_act(0, l, false, B, nh, Hp), da + l * BHp, dwm + static_cast<size_t>(l) * Hp * Hp,
                 dbm + static_cast<size_t>(l) * Hp, keep_step, nh * BHp, static_cast<long long>(nh) * Hp * Hp,
                 static_cast<long long>(nh) * Hp, Hp, Hp, Hp, Hp};
  jobs[n++] = {keep + fma_keep_act(0, nh, false, B, nh, Hp), dout, dwout, dbout, keep_step,
               static_cast<long long>(B) * n_out, static_cast<long long>(Hp) * n_out, n_out, Hp, n_out, Hp, n_out};
  jobs[n++] = {x1, dhp, dw1y, db1, static_cast<long long>(B) * size, static_cast<long long>(Bs) * Hp,
               static_cast<long long>(d_a) * Hp, Hp, size, Hp, d_a, Hp};
  jobs[n++] = {nullptr, an, nullptr, sums, 0, static_cast<long long>(B) * n_an, 0, n_an, 0, n_an, 0, n_an};
  return n;
}

cudaError_t launch_atb(const FtJob* list, int n_jobs, int K, int S, cudaStream_t stream) {
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
  ft_atb_kernel<<<blocks * S, kFtThreads, smem, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch `bcnf_flow_train_bwd_fma` needs (the wrapper allocates it).
extern "C" long long bcnf_flow_train_fma_scratch(int B, int S, int size, int d_a, int nh, int Hp) {
  size_t parts[9];
  scratch_parts(B, S, size, d_a, nh, Hp, parts);
  return static_cast<long long>(parts[8]);
}

// The layout a call at this shape takes on the current card: out[0..4] =
// the rows kernel's rows a lane, blocks, ring stages, floats a stage, bytes
// of shared memory; out[5] = the weight-grad pass's blocks (every step's).
extern "C" int bcnf_flow_train_fma_layout(int B, int S, int size, int d_a, int nh, int Hp, int* out) {
  if (B <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 || nh + 3 > kFtMaxJobs || Hp % 32 != 0 || Hp / 32 > 32)
    return cudaErrorInvalidValue;
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
  FtJob jobs[kFtMaxJobs];
  float dummy[4];  // the tiles depend on the jobs' shapes and on which have sums, not on their memory
  const int n_jobs = atb_jobs(dummy, dummy, dummy, dummy, dummy, dummy, dummy, dummy, dummy, dummy, dummy, dummy,
                              dummy, B, B, size, d_a, nh, Hp, jobs);
  int tiles = 0;
  for (int j = 0; j < n_jobs; ++j) tiles += ft_tiles_m(jobs[j]) * ft_tiles_n(jobs[j]);
  out[5] = S * tiles;
  return err;
}

// The strict K2b: every grad of the training forward, in float32 FMA, from
// the activations the strict K2a kept (`keep`: flow_fma.cu's fma_keep_act,
// fma_keep_s; the same bound, h_proj and weights), for the `count` rows from
// row `first` of a batch of B (bound, dz, dld, dx and dh_proj hold B rows a
// step; keep and the scratch are for `count` rows, as the K2a that ran on
// those rows kept them; the weight and ActNorm grads are those rows' sums).
// Arguments otherwise as flow_train_kernel.cu's `bcnf_flow_train_bwd` (the
// 3xTF32 K2b); Hp must be
// 32*TN for a compiled TN, nh >= 1 with nh + 3 jobs within kFtMaxJobs, the
// rows kernel's ring within a block's shared memory, the weights, h_proj,
// keep and the scratch 16-byte aligned: else cudaErrorInvalidValue. `parts`
// (bits) runs the rows kernel (1, with the transposed weights' copies), the
// weight-grad pass (2) and the ActNorm grads (4); the wrapper passes 7.
// Returns the first failing launch's cudaError_t.
extern "C" int bcnf_flow_train_bwd_fma(
    const float* bound, const float* h_proj, const float* dz, const float* dld, const float* an_s,
    const float* an_b, const float* ortho, const float* w1y, const float* b1, const float* wm,
    const float* bm, const float* wout, const float* bout, const float* keep, float* dx, float* dhp, float* dan_s,
    float* dan_b, float* dw1y, float* db1, float* dwm, float* dbm, float* dwout, float* dbout,
    float* scratch, int B, int first, int count, int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || first < 0 || count <= 0 || first > B - count || S <= 0 || d_a <= 0 || d_a >= size || nh < 1 ||
      nh + 3 > kFtMaxJobs || Hp % 32 != 0 || keep == nullptr ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(wout) |
        reinterpret_cast<size_t>(h_proj) | reinterpret_cast<size_t>(keep) | reinterpret_cast<size_t>(scratch)) & 15) != 0)
    return cudaErrorInvalidValue;
  (void)b1, (void)bm, (void)bout;  // the biases enter through the kept activations
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = 2 * (size - d_a), d_ap = ft_dap(d_a);
  bound += static_cast<size_t>(first) * size;  // the range's rows; the steps stay B rows apart
  dz += static_cast<size_t>(first) * size;
  dld += first;
  dx += static_cast<size_t>(first) * size;
  dhp += static_cast<size_t>(first) * Hp;
  size_t at[9];
  scratch_parts(count, S, size, d_a, nh, Hp, at);
  float* wmT = scratch + at[0];
  float* woutT = scratch + at[1];
  float* w1yT = scratch + at[2];
  float* da = scratch + at[3];
  float* dout = scratch + at[4];
  float* x1 = scratch + at[5];
  float* an = scratch + at[6];
  float* sums = scratch + at[7];

  cudaError_t err;
  if (parts & 1) {
    if ((err = transpose(wm, wmT, S * nh, Hp, Hp, Hp, st)) != cudaSuccess ||
        (err = transpose(wout, woutT, S, Hp, n_out, Hp, st)) != cudaSuccess ||
        (err = transpose(w1y, w1yT, S, d_a, Hp, d_ap, st)) != cudaSuccess)
      return err;
#define BCNF_CASE(TN)                                                                                                \
  case TN:                                                                                                           \
    err = launch_rows<TN>(bound, dz, dld, an_s, an_b, ortho, keep, wmT, woutT, w1yT, dx, dhp, da, dout, x1, an, count, \
                          B, S, size, d_a, nh, sms, st);                                                             \
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
    const int n_jobs = atb_jobs(keep, dhp, dw1y, db1, dwm, dbm, dwout, dbout, da, dout, x1, an, sums, count, B, size,
                                d_a, nh, Hp, jobs);
    if ((err = launch_atb(jobs, n_jobs, count, S, st)) != cudaSuccess) return err;
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
