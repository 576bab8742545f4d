// K1's inverse on Hopper's warpgroup tensor-core products (`wgmma`), 3xTF32,
// at the padded hidden widths Hp <= 544 (TN <= 17; the flagship's 526 pads to
// 544). Wider models take the row-tile inverse of flow_kernel.cu.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow with inverse=True (the
// Pallas TPU kernel `_flow_kernel`), and the inverse of
// bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4), which the port
// runs as this kernel at one step. Host side and plain PyTorch versions:
// bcnf_tpu_torch/ops/flow_kernel.py (`fused_flow`, `prepare_weights`,
// `fused_flow_reference`).
//
// What it computes, for every row r (conditioned on h_proj[k, r % N]): step
// S-1 (the final coupling alone), then for k = S-2 .. 0: x <- x Q_k^T,
// coupling^-1, ActNorm^-1; the coupling on x = [x_a | x_b] being
// a = gelu(x_a W1y + b1 + h_proj), a = gelu(a Wm_l + bm_l) for each hidden
// layer, [t | s'] = a Wout + bout, s = tanh(s'), x_b <- (x_b - t) exp(-s).
//
// What bounds it on an H100: the square hidden products, 4 x 2 x 526^2 FLOP
// a row and step, ~99% of the work, in 3xTF32 (three tensor-core products a
// product: a third of the 494.7 TFLOP/s dense TF32 rate), and the weights'
// traffic from L2: every 64-row block reads each step's hidden weights, hi
// and lo, once (2.37 MB a layer at Hp 544; for 80,000 rows ~308 GB a call),
// which at L2's rate of a few TB/s takes about as long as the products.
//
// Design.
// - Tile: a block owns 64 rows (one `wgmma` M) for all S steps; their
//   activations stay in shared memory as float32 (64 x (Hp + 4)), the rows'
//   state, the mix's output and [t | s'] beside them.
// - Warps: two consumer warpgroups each own half of the Hp output columns, as
//   two m64nNk8 products of N = 8 TN (n136 at Hp 544: 136 accumulator
//   registers a thread); a producer warpgroup streams the weights (one of
//   its threads issues the copies). The block's 384 threads start with 168
//   registers each; `setmaxnreg` takes the producers down to 40 and gives the
//   consumers 232 from what they release, which holds the accumulators, the
//   A fragment and its split without spills.
// - A operand: from registers. Each consumer loads its m64 x k8 fragment of
//   the float32 tile and splits it in registers into hi = tf32(a) (rounded)
//   and lo = a - hi (truncated by the tensor cores): four values a thread and
//   k-step.
// - B operand: the hidden weights prepared once per call on the card
//   (`prepare_weights`): transposed to K-major, split into hi and lo (the same
//   bits as the split of mma_tf32.cuh), and laid out stage by stage, 8 input
//   rows a stage, in the core-matrix order the descriptor reads, so one 1-D
//   bulk copy (`cp.async.bulk`, no tensor map) moves a stage's hi and lo
//   (64 Hp bytes: 34,816 at Hp 544).
// - Products: a_lo b_hi + a_hi b_lo + a_hi b_hi, three `wgmma`s a product a
//   k-step, into one float32 accumulator (the two small terms first).
// - Producer: one thread walks the weight stages of every step and layer in
//   the consumers' order and keeps them in flight through a 2-stage ring of
//   mbarriers (full: the copy's bytes landed; empty: the 256 consumer threads
//   are done with it). Two stages are what shared memory holds beside the
//   tile: 140 KB of tile, 70 KB of ring and the rows' state (~14 KB at the
//   flagship's size 19) come to ~224 KB of the 227 KB.
// - The narrow products (W1y: d_a inputs; Wout: 2 d_b outputs; ~2% of the
//   work) and the mixes stay float32 FMA and read their weights from global
//   memory through L1 and L2, as does the ActNorm: the ring has no room for
//   Wout (83 KB at Hp 544), and they are too small to need it. Wout's product
//   gives a thread one column and 8 rows, so each weight is loaded once for 8
//   rows.
// - Not built: a cluster of 2 blocks that multicasts each stage to both
//   (which would halve the L2 traffic), and a persistent grid; the first
//   measurement decides whether either is worth its complexity (PERF.md).
// - The tensor cores' accumulator truncates; over 544-long dot products the
//   inverse's samples stay within the 1e-4 bar of the float32 plain version
//   (measured: PERF.md), so each k-stage is not folded into a separate float32
//   sum (which would double the accumulator registers).

#include "flow_rows.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace bcnf;

constexpr int kWgRows = 64;                    // one wgmma M
constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
constexpr int kWgStages = 2;                   // the weight ring
constexpr int kWgProducts = 1, kWgCopies = 2;  // the parts a launch runs (both, or one alone to time it)
// Registers a thread: a block of 12 warps starts with 168 (65,536 / 384); the
// producer warpgroup gives up all but 40 to the block's pool, from which the
// consumers take 232 each: 128 x 40 + 256 x 232 = 384 x 168.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int TN>
struct WgShape {
  static constexpr int Hp = 32 * TN;
  static constexpr int ldA = Hp + 4;      // the activation tile (conflict-free fragment loads)
  static constexpr int NP = 8 * TN;       // columns of one product (two a warpgroup)
  static constexpr int R = NP / 2;        // its accumulator floats a thread
  static constexpr int stage = 16 * Hp;   // floats of a stage: 8 input rows of W^T, hi then lo
  static constexpr int n_stages = Hp / 8;  // stages a layer
};

// The kernel's dynamic shared memory (bcnf_tpu_torch/ops/flow_kernel.py:
// kernel_smem mirrors this sum): tile, ring, x, x Q^T, [t | s'], 4 barriers.
size_t wg_smem(int Hp, int size, int d_a) {
  return sizeof(float) * (static_cast<size_t>(kWgRows) * (Hp + 4) + static_cast<size_t>(kWgStages) * 16 * Hp +
                          static_cast<size_t>(kWgRows) * (2 * size + 2 * (size - d_a))) +
         2 * kWgStages * sizeof(uint64_t);
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory"); }

template <int TN>
__global__ void __launch_bounds__(kWgThreads, 1)
flow_inverse_wgmma(const float* __restrict__ x, const float* __restrict__ h_proj,
                   const float* __restrict__ an_s, const float* __restrict__ an_b,
                   const float* __restrict__ ortho, const float* __restrict__ w1y,
                   const float* __restrict__ b1, const float* __restrict__ wstages,
                   const float* __restrict__ bm, const float* __restrict__ wout,
                   const float* __restrict__ bout, float* __restrict__ y, int B, int N, int S, int size,
                   int d_a, int nh, int parts) {
  using W = WgShape<TN>;
  constexpr int Hp = W::Hp, ldA = W::ldA;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // 64 x Hp (ld ldA)
  float* ring = act + kWgRows * ldA;             // kWgStages weight stages
  float* xs = ring + kWgStages * W::stage;       // 64 x size: the rows' state
  float* xt = xs + kWgRows * size;               // 64 x size: the mix's output
  float* outs = xt + kWgRows * size;             // 64 x n_out: [t | s']
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kWgRows * n_out);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kWgRows;
  for (int p = tid; p < kWgRows * size; p += kWgThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    // ---- the producer warpgroup: one thread issues every hidden weight's
    // stages, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kWgConsumers) {
      int st = 0;
      uint32_t ph = 0;
      for (int it = 0; it < S; ++it) {
        const int k = S - 1 - it;
        for (int l = 0; l < nh; ++l) {
          const float* src = wstages + (static_cast<size_t>(k) * nh + l) * W::n_stages * W::stage;
          for (int s = 0; s < W::n_stages; ++s) {
            mbar_wait(&empty[st], ph ^ 1);
            if (parts & kWgCopies) {
              mbar_arrive_expect_tx(&full[st], W::stage * sizeof(float));
              bulk_copy_g2s(ring + st * W::stage, src + static_cast<size_t>(s) * W::stage,
                            W::stage * sizeof(float), &full[st]);
            } else {
              mbar_arrive(&full[st]);  // timing the products alone: the stage as it is
            }
            if (++st == kWgStages) {
              st = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: 256 threads, two warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  int st = 0;
  uint32_t ph = 0;

  for (int it = 0; it < S; ++it) {
    const int k = S - 1 - it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;

    if (inner) {  // ---- x <- x Q_k^T (FMA)
      const float* Q = ortho + static_cast<size_t>(k) * size * size;
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) {
        const int r = p / size, j = p % size;
        float acc = 0.0f;
        for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
        xt[p] = acc;
      }
      float* t = xs;
      xs = xt;
      xt = t;
      consumer_sync();
    }

    // ---- h_0 = gelu(x_a W1y + b1 + h_proj[k, row % N]) (FMA) into the tile
    {
      const float* w1 = w1y + static_cast<size_t>(k) * d_a * Hp;
      const float* b1k = b1 + static_cast<size_t>(k) * Hp;
      for (int p = tid; p < kWgRows * Hp / 2; p += kWgConsumers) {
        const int row = p / (Hp / 2), col = 2 * (p % (Hp / 2));
        const float* hp =
            row0 + row < B ? h_proj + (static_cast<size_t>(k) * N + (row0 + row) % N) * Hp : nullptr;
        const float2 a = input_layer<Hp>(xs + row * size, w1, b1k, hp, d_a, col);
        *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(gelu_tanh(a.x), gelu_tanh(a.y));
      }
    }
    consumer_sync();

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l) on wgmma, 3xTF32
    for (int l = 0; l < nh; ++l) {
      float acc[2][W::R];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < W::R; ++e) acc[p][e] = 0.0f;
#pragma unroll 1
      for (int s = 0; s < W::n_stages; ++s) {
        if (!(parts & kWgProducts)) {  // timing the weights' stream alone
          mbar_wait(&full[st], ph);
          mbar_arrive(&empty[st]);
          if (++st == kWgStages) {
            st = 0;
            ph ^= 1;
          }
          continue;
        }
        // this warp's m64 x k8 fragment of the tile: rows 16 w4 + g (+8), columns 8 s + q (+4)
        const float* a0 = act + (16 * w4 + g) * ldA + 8 * s + q;
        const float v[4] = {a0[0], a0[8 * ldA], a0[4], a0[8 * ldA + 4]};
        uint32_t ahi[4], alo[4];
        split_tf32(v, ahi, alo);
        mbar_wait(&full[st], ph);
        // the warpgroup's two products: n-groups wg 2 TN + p TN of the stage's hi and lo halves
        const float* hi0 = ring + st * W::stage + (wg * 2 * TN) * 64;
        const float* lo0 = hi0 + 8 * Hp;
        const uint64_t bh0 = smem_desc(hi0, 128, 256), bh1 = smem_desc(hi0 + TN * 64, 128, 256);
        const uint64_t bl0 = smem_desc(lo0, 128, 256), bl1 = smem_desc(lo0 + TN * 64, 128, 256);
        wgmma_fence();
        WgmmaTf32<W::NP>::mma(acc[0], alo, bh0);
        WgmmaTf32<W::NP>::mma(acc[1], alo, bh1);
        WgmmaTf32<W::NP>::mma(acc[0], ahi, bl0);
        WgmmaTf32<W::NP>::mma(acc[1], ahi, bl1);
        WgmmaTf32<W::NP>::mma(acc[0], ahi, bh0);
        WgmmaTf32<W::NP>::mma(acc[1], ahi, bh1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc[0]);
        fence_operands(acc[1]);
        mbar_arrive(&empty[st]);
        if (++st == kWgStages) {
          st = 0;
          ph ^= 1;
        }
      }
      consumer_sync();  // every warp is done reading the tile
      const float* bias = bm + (static_cast<size_t>(k) * nh + l) * Hp;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * w4 + g + 8 * h, col = wg * 16 * TN + p * 8 * TN + 8 * j + 2 * q;
            *reinterpret_cast<float2*>(act + row * ldA + col) =
                make_float2(gelu_tanh(acc[p][4 * j + 2 * h] + bias[col]),
                            gelu_tanh(acc[p][4 * j + 2 * h + 1] + bias[col + 1]));
          }
      consumer_sync();
    }

    // ---- output layer: [t | s'] = h_nh Wout + bout (FMA; Wout from L1/L2),
    // a thread one column and 8 rows, the sum in the order of the inputs
    {
      const float* wo = wout + static_cast<size_t>(k) * Hp * n_out;
      const float* bo = bout + static_cast<size_t>(k) * n_out;
      for (int item = tid; item < (kWgRows / 8) * n_out; item += kWgConsumers) {
        const int c = item % n_out, r0 = (item / n_out) * 8;
        float acc[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
        for (int kk = 0; kk < Hp; kk += 4) {
          const float w0 = wo[kk * n_out + c], w1 = wo[(kk + 1) * n_out + c];
          const float w2 = wo[(kk + 2) * n_out + c], w3 = wo[(kk + 3) * n_out + c];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(act + (r0 + r) * ldA + kk);
            acc[r] = fmaf(v.x, w0, acc[r]);
            acc[r] = fmaf(v.y, w1, acc[r]);
            acc[r] = fmaf(v.z, w2, acc[r]);
            acc[r] = fmaf(v.w, w3, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) outs[(r0 + r) * n_out + c] = acc[r] + bo[c];
      }
    }
    consumer_sync();

    // ---- x_b <- (x_b - t) exp(-s) (one thread a row)
    if (tid < kWgRows) {
      float* xr = xs + tid * size;
      const float* o = outs + tid * n_out;
      for (int j = 0; j < d_b; ++j) xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-tanhf(o[d_b + j]));
    }
    consumer_sync();

    if (inner) {  // ---- ActNorm^-1
      for (int p = tid; p < kWgRows * size; p += kWgConsumers) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      consumer_sync();
    }
  }

  for (int p = tid; p < kWgRows * size; p += kWgConsumers) {
    if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
  }
}

template <int TN>
cudaError_t launch(const float* x, const float* h_proj, const float* an_s, const float* an_b, const float* ortho,
                   const float* w1y, const float* b1, const float* wstages, const float* bm, const float* wout,
                   const float* bout, float* y, int B, int N, int S, int size, int d_a, int nh, int parts,
                   cudaStream_t stream) {
  const size_t smem = wg_smem(32 * TN, size, d_a);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flow_inverse_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flow_inverse_wgmma<TN><<<(B + kWgRows - 1) / kWgRows, kWgThreads, smem, stream>>>(
      x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S, size, d_a, nh, parts);
  return cudaGetLastError();
}

template <int TN>
int occupancy(int size, int d_a) {
  const size_t smem = wg_smem(32 * TN, size, d_a);
  if (smem > kSmemLimit) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flow_inverse_wgmma<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flow_inverse_wgmma<TN>, kWgThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

#define BCNF_WG_CASES(Hp, CASE) \
  switch ((Hp) / 32) {          \
    CASE(1)                     \
    CASE(2)                     \
    CASE(4)                     \
    CASE(8)                     \
    CASE(12)                    \
    CASE(16)                    \
    CASE(17)                    \
    default:                    \
      break;                    \
  }

// C entry points, loaded with ctypes.

// K1's inverse: y (B, size) from x (B, size); `wstages` is the hidden weights
// as `prepare_weights` lays them out, (S, nh, Hp/8, 2, Hp/8, 2, 8, 4) floats,
// 16-byte aligned. Hp must be 32*TN for TN in 1, 2, 4, 8, 12, 16, 17; a
// `size` past the shared memory returns cudaErrorInvalidValue. `parts` is
// kWgProducts | kWgCopies for the inverse; one of them alone times that part
// (the other skipped, y not the inverse).
extern "C" int bcnf_flow_inverse_wgmma(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                                       const float* ortho, const float* w1y, const float* b1, const float* wstages,
                                       const float* bm, const float* wout, const float* bout, float* y, int B, int N,
                                       int S, int size, int d_a, int nh, int Hp, int parts, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 ||
      (nh > 0 && (reinterpret_cast<size_t>(wstages) & 15) != 0) ||
      ((reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(h_proj)) & 7) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN)                                                                                              \
  case TN:                                                                                                         \
    return launch<TN>(x, h_proj, an_s, an_b, ortho, w1y, b1, wstages, bm, wout, bout, y, B, N, S, size, d_a, nh, \
                      parts, st);
  BCNF_WG_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return cudaErrorInvalidValue;
}

// Blocks of the wgmma inverse resident on one SM at this shape (as the
// occupancy calculator gives it), or minus a cudaError_t.
extern "C" int bcnf_flow_wgmma_occupancy(int Hp, int size, int d_a) {
  if (Hp % 32 != 0 || d_a <= 0 || d_a >= size) return -static_cast<int>(cudaErrorInvalidValue);
#define BCNF_CASE(TN) \
  case TN:            \
    return occupancy<TN>(size, d_a);
  BCNF_WG_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
