// The whole conditional RealNVP flow in one kernel: K1 on the row tiles and
// the training forward K2a, both 3xTF32 on the tensor cores (and in one TF32
// pass, `*_tf32`), where no `wgmma` route takes the shape: the padded widths
// 768 and 1024 run 3xTF32 both ways on csrc/flow_wide_wgmma.cu and up to 544
// on csrc/flow_wgmma.cu and csrc/flow_fwd_wgmma.cu, so in 3xTF32 these row
// tiles run sizes past those kernels' shared memory, or forced (the tools
// and chip_smoke.py time them so). K1 in exact float32 on FMA (the strict
// mode) is csrc/flow_fma.cu.
//
// Replaces: bcnf_tpu/ops/flow_kernel.py::fused_flow (the Pallas TPU kernel
// `_flow_kernel`: `bcnf_flow_rows`), the per-coupling
// kernel bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling (K4, which the
// port runs as K1 at one step) and, through `bcnf_flow_rows` with `bound`,
// the training forward `fwd_call` of `_make_fused_flow_train`
// (`_flow_fwd_train_kernel`). Host side and plain PyTorch versions:
// bcnf_tpu_torch/ops/flow_kernel.py. The training backward (K2b) is
// csrc/flow_train_kernel.cu; K1's inverse on `wgmma`, csrc/flow_wgmma.cu.
//
// What it computes, for every row r of x (rows are draws-major; row r is
// conditioned on h_proj[step, r % N]):
//   inverse: step K (the final coupling alone), then for k = K-1 .. 0:
//            x <- x Q_k^T, coupling^-1, ActNorm^-1
//   forward: for k = 0 .. K-1: ActNorm, coupling, x <- x Q_k; then step K;
//            logdet = sum log|s_an| + sum s.
//   coupling on x = [x_a | x_b]: a = gelu(x_a W1y + b1 + h_proj); a = gelu(a Wm_i
//   + bm_i) for each hidden layer; [t | s'] = a Wout + bout; s = tanh(s');
//   x_b <- exp(s) x_b + t (forward) or (x_b - t) exp(-s) (inverse).
//   GELU is the tanh form, as jax.nn.gelu and the Pallas kernel compute it.
//   K2a is the forward that also stores each row's input to step k in
//   bound[k] (`bound_ref[0] = x` of the TPU kernel): the (S, B, size)
//   residual from which the backward recomputes every step. Training rows
//   have their own conditions, N = B.
//
// What bounds them on an H100: operations. At the flagship widths (H = 526,
// 4 hidden layers, 26 steps) a row costs ~58 MFLOP, almost all in the
// H x H layers, while the ~120 MB of weights are shared by every row, so any
// batch past a few thousand rows is compute-bound: at a third of the dense
// TF32 rate in 3xTF32 (the counterpart of the JAX kernel's "x3" mode, which
// serves its "highest" contract).
// K2a's extra store is S*size floats a row (~2 KB), nothing beside that.
//
// The row tiles (`rows_flow_kernel`, on flow_rows.cuh, shared with K2b's rows
// kernel): one block of 512 threads (16 warps) owns BM = 32 rows (16 at the
// widest widths) for all S steps, so 4096 rows fill 128 SMs. The rows' state,
// their logdet, the ActNorm, the mixes and the affine update stay in shared
// memory; the nh square hidden products of a step run on `mma.sync` in
// 3xTF32, each weight streamed from L2 through the 3-stage cp.async ring;
// W1y and Wout are staged in the ring between them for the narrow products,
// which stay float32 FMA, as the mixes do. One template serves K2a (with the
// `bound` store; its arithmetic order is K2a's own), K1's forward
// and the inverse, which walks the steps in reverse (final coupling first)
// and takes x Q^T, the MLP, (x_b - t) exp(-s), then ActNorm^-1.
//
// The reduced mode: the library built with BCNF_TF32_PASSES=1 (flow_rows.cuh)
// runs the row tiles' square hidden products in one TF32 pass, each operand
// rounded once (mma_tf32.cuh: `mma_passes<1>`; the JAX kernel's "default"
// mode, which serves the "default", "bfloat16" and "BF16_BF16_F32_X3"
// precisions), so K1's forward, the wide inverse and K2a are bound at the
// dense TF32 rate, a third of the 3xTF32 bound; the narrow products and the
// mixes are the same in both libraries.
//
// The hidden width is zero-padded to Hp = 32*TN by the host (exact:
// padded units stay 0 because gelu(0) = 0). Rows past B in the ragged last
// tile are computed on zeros and not stored. nh may be 0 (K4 of a coupling
// with one hidden layer).

#include "flow_rows.cuh"

namespace {

using namespace bcnf;

// The row-tile walk over the flow on the tensor cores: K2a (kBound: the
// forward that also stores each step's input rows; N = B), K1's forward
// (!kBound) and K1's inverse (kInverse) at the widths the wgmma inverse
// (flow_wgmma.cu) does not hold. Row r takes its condition h_proj[k, r % N].
template <int TN, int BM, int BK, bool kBound, bool kInverse>
__global__ void __launch_bounds__(kRowThreads, 1)
rows_flow_kernel(const float* __restrict__ x, const float* __restrict__ h_proj,
                 const float* __restrict__ an_s, const float* __restrict__ an_b,
                 const float* __restrict__ ortho, const float* __restrict__ w1y,
                 const float* __restrict__ b1, const float* __restrict__ wm,
                 const float* __restrict__ bm, const float* __restrict__ wout,
                 const float* __restrict__ bout, float* __restrict__ y, float* __restrict__ ld_out,
                 float* __restrict__ bound, int B, int N, int S, int size, int d_a, int nh) {
  static_assert(!(kBound && kInverse), "the step inputs are stored by the training forward only");
  using Sh = RowShape<TN, BM, BK>;
  constexpr int Hp = Sh::Hp, ldA = Sh::ldA;
  const int d_b = size - d_a;
  const int n_out = 2 * d_b;

  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // BM x Hp (ld ldA)
  float* ring = act + BM * ldA;                  // kRingStages weight stages
  float* xs = ring + kRingStages * Sh::stage;    // BM x size: the rows' state
  float* xt = xs + BM * size;                    // BM x size: the mix's output
  float* outs = xt + BM * size;                  // BM x n_out: [t | s']
  float* lds = outs + BM * n_out;                // BM: logdet

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const bool in_ring = Sh::narrow_in_ring(size, d_a);

  for (int p = tid; p < BM * size; p += kRowThreads)
    xs[p] = row0 + p / size < B ? x[static_cast<size_t>(row0) * size + p] : 0.0f;
  if (tid < BM) lds[tid] = 0.0f;
  __syncthreads();

  for (int it = 0; it < S; ++it) {
    const int k = kInverse ? S - 1 - it : it;
    const bool inner = k < S - 1;  // step S-1 is the final coupling alone
    const float* sc = an_s + static_cast<size_t>(k) * size;
    const float* bi = an_b + static_cast<size_t>(k) * size;
    const float* Q = ortho + static_cast<size_t>(k) * size * size;

    if (!kInverse) {
      // ---- the step's input rows to bound[k] (K2a), then the ActNorm
      float* bk = kBound ? bound + (static_cast<size_t>(k) * B + row0) * size : nullptr;
      for (int p = tid; p < BM * size; p += kRowThreads) {
        if (kBound && row0 + p / size < B) bk[p] = xs[p];
        if (inner) xs[p] = xs[p] * sc[p % size] + bi[p % size];
      }
      if (inner && tid < BM) {
        float l = 0.0f;
        for (int i = 0; i < size; ++i) l += logf(fabsf(sc[i]));
        lds[tid] += l;
      }
      __syncthreads();
    } else if (inner) {
      // ---- x <- x Q_k^T (FMA)
      for (int p = tid; p < BM * size; p += kRowThreads) {
        const int r = p / size, j = p % size;
        float acc = 0.0f;
        for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[j * size + i], acc);
        xt[p] = acc;
      }
      float* t = xs;
      xs = xt;
      xt = t;
      __syncthreads();
    }

    // ---- a_0 = x1_a W1y + b1 + h_proj[k, row % N] (FMA); h_0 = gelu(a_0) into the tile
    const float* w1 = stage_weight(ring, w1y + static_cast<size_t>(k) * d_a * Hp, d_a * Hp, in_ring, tid);
    each_pair<TN, BM, BK>(warp, lane, [&](int row, int col, int, int, int) {
      const float* hp =
          row0 + row < B ? h_proj + (static_cast<size_t>(k) * N + (row0 + row) % N) * Hp : nullptr;
      const float2 a = input_layer<Hp>(xs + row * size, w1, b1 + static_cast<size_t>(k) * Hp, hp, d_a, col);
      *reinterpret_cast<float2*>(act + row * ldA + col) = make_float2(gelu_tanh(a.x), gelu_tanh(a.y));
    });

    // ---- hidden layers: h_{l+1} = gelu(h_l Wm_l + bm_l), products on tensor cores
    for (int l = 0; l < nh; ++l) {
      float acc[Sh::MT][Sh::NTW][4];
      const size_t wl = static_cast<size_t>(k) * nh + l;
      square_product<TN, BM, BK, false>(act, wm + wl * Hp * Hp, ring, acc, warp, lane, tid);
      const float* bias = bm + wl * Hp;
      each_pair<TN, BM, BK>(warp, lane, [&](int row, int col, int mi, int i, int h) {
        *reinterpret_cast<float2*>(act + row * ldA + col) =
            make_float2(gelu_tanh(acc[mi][i][2 * h] + bias[col]), gelu_tanh(acc[mi][i][2 * h + 1] + bias[col + 1]));
      });
    }
    __syncthreads();

    // ---- output layer: [t | s'] = h_nh Wout + bout (FMA)
    const float* wo = stage_weight(ring, wout + static_cast<size_t>(k) * Hp * n_out, Hp * n_out, in_ring, tid);
    narrow_product(act, ldA, BM, Hp, wo, n_out, 1, bout + static_cast<size_t>(k) * n_out, outs, n_out, tid);
    __syncthreads();

    // ---- affine update of x_b, and the forward's logdet (one thread a row)
    if (tid < BM) {
      float* xr = xs + tid * size;
      const float* o = outs + tid * n_out;
      float l = 0.0f;
      for (int j = 0; j < d_b; ++j) {
        const float s = tanhf(o[d_b + j]);
        if (!kInverse) {
          xr[d_a + j] = expf(s) * xr[d_a + j] + o[j];
          l += s;
        } else {
          xr[d_a + j] = (xr[d_a + j] - o[j]) * expf(-s);
        }
      }
      if (!kInverse) lds[tid] += l;
    }
    __syncthreads();

    if (inner) {
      if (!kInverse) {
        // ---- x <- x Q_k (FMA)
        for (int p = tid; p < BM * size; p += kRowThreads) {
          const int r = p / size, j = p % size;
          float acc = 0.0f;
          for (int i = 0; i < size; ++i) acc = fmaf(xs[r * size + i], Q[i * size + j], acc);
          xt[p] = acc;
        }
        float* t = xs;
        xs = xt;
        xt = t;
      } else {
        // ---- ActNorm^-1
        for (int p = tid; p < BM * size; p += kRowThreads) xs[p] = (xs[p] - bi[p % size]) / sc[p % size];
      }
      __syncthreads();
    }
  }

  for (int p = tid; p < BM * size; p += kRowThreads) {
    if (row0 + p / size < B) y[static_cast<size_t>(row0) * size + p] = xs[p];
  }
  if (!kInverse && tid < BM && row0 + tid < B) ld_out[row0 + tid] = lds[tid];
}

template <int TN, int BM, int BK, bool kBound, bool kInverse>
cudaError_t launch_rows(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                        const float* ortho, const float* w1y, const float* b1, const float* wm, const float* bm,
                        const float* wout, const float* bout, float* y, float* ld, float* bound, int B, int N, int S,
                        int size, int d_a, int nh, cudaStream_t stream) {
  // the tile, the ring, and BM rows of [x | x Q | t s' | logdet]: less than
  // K2b's rows kernel takes for the same shape, so K2a runs every shape K2b
  // runs (bcnf_tpu_torch/ops/flow_kernel.py: kernel_smem mirrors this sum)
  const size_t smem = sizeof(float) * (RowShape<TN, BM, BK>::tile_floats +
                                       static_cast<size_t>(BM) * (2 * size + 2 * (size - d_a) + 1));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rows_flow_kernel<TN, BM, BK, kBound, kInverse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rows_flow_kernel<TN, BM, BK, kBound, kInverse><<<(B + BM - 1) / BM, kRowThreads, smem, stream>>>(
      x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld, bound, B, N, S, size, d_a, nh);
  return cudaGetLastError();
}

template <int TN, int BM, int BK>
cudaError_t launch_rows_mode(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                             const float* ortho, const float* w1y, const float* b1, const float* wm, const float* bm,
                             const float* wout, const float* bout, float* y, float* ld, float* bound, int B, int N,
                             int S, int size, int d_a, int nh, int inverse, cudaStream_t stream) {
  if (inverse)
    return launch_rows<TN, BM, BK, false, true>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld,
                                                 bound, B, N, S, size, d_a, nh, stream);
  if (bound != nullptr)
    return launch_rows<TN, BM, BK, true, false>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld,
                                                 bound, B, N, S, size, d_a, nh, stream);
  return launch_rows<TN, BM, BK, false, false>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld,
                                                bound, B, N, S, size, d_a, nh, stream);
}

}  // namespace

// C entry points, loaded with ctypes. Hp (the padded hidden width) must be
// 32*TN for a compiled TN; each returns the cudaError_t of its launch.

// The row-tile kernels: K1's forward (y = z, ld = logdet), K1's inverse
// (ld and bound null) and K2a, the training forward (bound non-null: every
// step's input rows, (S, B, size); call it with N = B, h_proj (S, B, Hp)).
// Row r takes h_proj[k, r % N]. The weights must be 16-byte aligned; a
// `size` past the kernel's shared memory (at Hp = 544, size <= 29) returns
// cudaErrorInvalidValue.
extern "C" int bcnf_flow_rows(const float* x, const float* h_proj, const float* an_s, const float* an_b,
                              const float* ortho, const float* w1y, const float* b1, const float* wm,
                              const float* bm, const float* wout, const float* bout, float* y, float* ld,
                              float* bound, int B, int N, int S, int size, int d_a, int nh, int Hp, int inverse,
                              void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || d_a <= 0 || d_a >= size || nh < 0 || Hp % 32 != 0 ||
      (!inverse && ld == nullptr) || (inverse && bound != nullptr) ||
      ((reinterpret_cast<size_t>(wm) | reinterpret_cast<size_t>(w1y) | reinterpret_cast<size_t>(wout)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CASE(TN, BM, BK) \
  case TN:                    \
    return launch_rows_mode<TN, BM, BK>(x, h_proj, an_s, an_b, ortho, w1y, b1, wm, bm, wout, bout, y, ld, bound, B, \
                                        N, S, size, d_a, nh, inverse, st);
  BCNF_ROW_CASES(Hp, BCNF_CASE)
#undef BCNF_CASE
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
