// One LSTM direction's recurrence over T steps, forward (K3a) and backward
// (K3b).
//
// Replaces: bcnf_tpu/ops/lstm_kernel.py, `run_fwd` (the Pallas TPU kernel
// `_fwd_kernel`) and `run_bwd` (`_bwd_kernel`). Host side and plain PyTorch
// versions: bcnf_tpu_torch/ops/lstm_kernel.py.
//
// What it computes, for each row r of the batch (xp is time-major
// (T, B, 4H), gate order i, f, g, o; W_hh is (H, 4H); t walks T-1 .. 0 when
// reverse):
//   K3a: gates = xp[t] + h W_hh; i, f, o = sigmoid, g = tanh;
//        c = f c + i g; h = o tanh(c); hs[t] = h, cs[t] = c (h = c = 0 first).
//   K3b: in the opposite order, from the saved hs, cs and the cotangent dhs:
//        recompute the step's gates from h_prev, c_prev (zeros at the
//        forward's first step); dh = dhs[t] + dh_next; do = dh tanh(c);
//        dc = dh o (1 - tanh^2 c) + dc_next; dgates = [dc g i(1-i) |
//        dc c_prev f(1-f) | dc i (1-g^2) | do o(1-o)] = dxp[t];
//        dh_next = dgates W_hh^T; dc_next = dc f; and
//        dW_hh = sum over t and rows of h_prev^T dgates.
//
// What bounds it on an H100: operations. A step is a (B x H) @ (H x 4H)
// product, 8 H^2 FLOP a row: 19.3 GFLOP a direction at the flagship's
// B = 4096, T = 30, H = 140 (0.29 ms at the float32 rate), against 0.12 ms
// for its bytes (xp in, hs and cs out). K3b does three such products.
//
// Design. The TPU kernel keeps the whole time loop inside one invocation per
// batch tile; here one block of 256 threads owns BM = 8*TM rows for all T
// steps. A thread owns hidden units u = tx + 32*j (j < TN) of all four gates,
// so the cell update needs no exchange: c (and in K3b the carried dh, dc)
// stays in registers, the gate sums of a step in an accumulator tile. h (K3b:
// also dgates) sits in shared memory for the step's product. W_hh does not
// fit a block (313 KB at H = 140, against 227 KB of shared memory), so it is
// streamed every step in BK-row slabs through the cp.async double buffer of
// flow_common.cuh; resident blocks walk the steps together and keep it hot in
// the 50 MB L2. Each gate block is zero-padded on its own to Hp = 32*TN (the
// host pads W_hh to (Hp, 4Hp), K3b also passes its transpose): padded units
// keep c = 0.5*0 + 0.5*tanh(0) = 0 and h = 0. xp, hs, cs, dhs and dxp are
// read and written at their own width H, masked; rows past B are computed on
// zeros and not stored. dW_hh is the TPU kernel's per-tile VMEM sum made
// deterministic: after the recurrence, atb.cuh's A^T B pass forms
// h_prev^T dxp over the (T-1) B rows that have an h_prev (time-major, they
// are one contiguous block of hs and of dxp), split into fixed row chunks
// whose partial products a last kernel adds in a fixed order: no atomics.
// float32 FMA only; expf/tanhf without fast-math; sigmoid = 1/(1+exp(-x)).

#include "atb.cuh"

namespace {

using namespace bcnf;

// dW_hh's row chunks: at most kMaxSplit of at least kSplitRows rows. Each
// block of atb_kernel sums its chunk's rows one after the other; short
// chunks keep that float32 sum's rounding at ~1e-6 of the grad's scale
// (119k rows in 58 chunks at the flagship's batch 4096).
constexpr int kMaxSplit = 64;
constexpr int kSplitRows = 2048;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ wp, float* __restrict__ hs,
                float* __restrict__ cs, int T, int B, int H, int reverse, int BK) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  const int G = 4 * H;

  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // BM x Hp: h of the step before
  float* slab = h_s + BM * Hp;                    // 2 x BK x 4Hp

  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
  const int row0 = blockIdx.x * BM;

  for (int p = tid; p < BM * Hp; p += kThreads) h_s[p] = 0.0f;
  float c[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[r][j] = 0.0f;

  for (int tau = 0; tau < T; ++tau) {
    const int t = reverse ? T - 1 - tau : tau;
    // h W_hh; the product's first barrier makes the h tile written below
    // (and its zeros) visible, its last one ends every read of it
    float acc[TM][4 * TN];
    matmul_hidden<TM, TN, 4 * TN>(h_s, wp, slab, BK, acc, ty, tx, tid);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + ty * TM + r;
      const size_t x0 = (static_cast<size_t>(t) * B + row) * G;
      const size_t s0 = (static_cast<size_t>(t) * B + row) * H;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int u = tx + 32 * j;
        const bool valid = row < B && u < H;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = (valid ? xp[x0 + g * H + u] : 0.0f) + acc[r][g * TN + j];
        const float i = sigmoid_f(gate[0]);
        const float f = sigmoid_f(gate[1]);
        const float gg = tanhf(gate[2]);
        const float o = sigmoid_f(gate[3]);
        c[r][j] = f * c[r][j] + i * gg;
        const float h = valid ? o * tanhf(c[r][j]) : 0.0f;
        h_s[(ty * TM + r) * Hp + u] = h;
        if (valid) {
          hs[s0 + u] = h;
          cs[s0 + u] = c[r][j];
        }
      }
    }
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ xp, const float* __restrict__ wp,
                const float* __restrict__ wpt, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ dhs, float* __restrict__ dxp,
                int T, int B, int H, int reverse, int BK) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  const int G = 4 * H;

  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // BM x Hp: h_prev
  float* dg_s = h_s + BM * Hp;                    // BM x 4Hp: the step's dgates
  float* slab = dg_s + BM * 4 * Hp;               // 2 x BK x 4Hp

  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
  const int row0 = blockIdx.x * BM;

  float dh_next[TM][TN], dc_next[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) dh_next[r][j] = dc_next[r][j] = 0.0f;

  for (int tau = 0; tau < T; ++tau) {
    const int t = reverse ? tau : T - 1 - tau;     // the opposite order of the forward
    const bool first = t == (reverse ? T - 1 : 0);  // the forward's first step
    const int tp = reverse ? t + 1 : t - 1;

    float c_prev[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + ty * TM + r;
      const size_t p0 = (static_cast<size_t>(first ? t : tp) * B + row) * H;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int u = tx + 32 * j;
        const bool valid = !first && row < B && u < H;
        h_s[(ty * TM + r) * Hp + u] = valid ? hs[p0 + u] : 0.0f;
        c_prev[r][j] = valid ? cs[p0 + u] : 0.0f;
      }
    }
    float acc[TM][4 * TN];
    matmul_hidden<TM, TN, 4 * TN>(h_s, wp, slab, BK, acc, ty, tx, tid);  // h_prev W_hh

#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + ty * TM + r;
      const size_t x0 = (static_cast<size_t>(t) * B + row) * G;
      const size_t s0 = (static_cast<size_t>(t) * B + row) * H;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int u = tx + 32 * j;
        const bool valid = row < B && u < H;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = (valid ? xp[x0 + g * H + u] : 0.0f) + acc[r][g * TN + j];
        const float i = sigmoid_f(gate[0]);
        const float f = sigmoid_f(gate[1]);
        const float gg = tanhf(gate[2]);
        const float o = sigmoid_f(gate[3]);
        const float cc = f * c_prev[r][j] + i * gg;
        const float tc = tanhf(cc);
        const float dh = (valid ? dhs[s0 + u] : 0.0f) + dh_next[r][j];
        const float dout = dh * tc;
        const float dc = dh * o * (1.0f - tc * tc) + dc_next[r][j];
        float dg[4] = {dc * gg * i * (1.0f - i), dc * c_prev[r][j] * f * (1.0f - f),
                       dc * i * (1.0f - gg * gg), dout * o * (1.0f - o)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (!valid) dg[g] = 0.0f;
          dg_s[(ty * TM + r) * 4 * Hp + g * Hp + u] = dg[g];
          if (valid) dxp[x0 + g * H + u] = dg[g];
        }
        dc_next[r][j] = valid ? dc * f : 0.0f;
      }
    }
    // dh_next = dgates W_hh^T; the product's first barrier publishes dg_s
    float acc2[TM][TN];
    matmul_hidden<TM, 4 * TN, TN>(dg_s, wpt, slab, BK, acc2, ty, tx, tid);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) dh_next[r][j] = acc2[r][j];
  }
}

// out[i] = sum_p parts[p * n + i], p in order: the split dW_hh pass's sum.
__global__ void sum_parts_kernel(const float* __restrict__ parts, int n_parts, int n,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < n_parts; ++p) s += parts[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

// Shared memory of a launch, with the slab depth BK halved until it fits.
size_t fit_smem(size_t fixed, int slab_row_floats, int* BK) {
  *BK = 16;
  while (*BK >= 4 && fixed + sizeof(float) * 2 * *BK * slab_row_floats > kSmemLimit) *BK /= 2;
  return fixed + sizeof(float) * 2 * *BK * slab_row_floats;
}

template <int TM, int TN>
cudaError_t launch_fwd(const float* xp, const float* wp, float* hs, float* cs, int T, int B, int H,
                       int reverse, cudaStream_t stream) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  int BK;
  const size_t smem = fit_smem(sizeof(float) * BM * Hp, 4 * Hp, &BK);
  if (BK < 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<TM, TN><<<(B + BM - 1) / BM, kThreads, smem, stream>>>(xp, wp, hs, cs, T, B, H,
                                                                         reverse, BK);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_bwd(const float* xp, const float* wp, const float* wpt, const float* hs,
                       const float* cs, const float* dhs, float* dxp, int T, int B, int H,
                       int reverse, cudaStream_t stream) {
  constexpr int BM = kWarps * TM;
  constexpr int Hp = 32 * TN;
  int BK;
  const size_t smem = fit_smem(sizeof(float) * BM * 5 * Hp, 4 * Hp, &BK);
  if (BK < 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_bwd_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bwd_kernel<TM, TN><<<(B + BM - 1) / BM, kThreads, smem, stream>>>(
      xp, wp, wpt, hs, cs, dhs, dxp, T, B, H, reverse, BK);
  return cudaGetLastError();
}

int n_split(int T, int B) {
  const long long rows = static_cast<long long>(T - 1) * B;
  const long long n = (rows + kSplitRows - 1) / kSplitRows;
  return n < 1 ? 1 : (n > kMaxSplit ? kMaxSplit : static_cast<int>(n));
}

#define BCNF_LSTM_CASES(CALL) \
  switch (Hp / 32) {          \
    case 1: CALL(4, 1)        \
    case 2: CALL(4, 2)        \
    case 3: CALL(4, 3)        \
    case 4: CALL(4, 4)        \
    case 5: CALL(4, 5)        \
    case 6: CALL(2, 6)        \
    case 7: CALL(2, 7)        \
    case 8: CALL(2, 8)        \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace

// C entry points, loaded with ctypes. Hp (the per-gate padded width) must be
// 32*TN for a compiled TN (1..8) with H <= Hp; wp is W_hh padded per gate to
// (Hp, 4Hp), wpt its transpose. Each returns the cudaError_t of its launches.

// K3a: hs, cs (T, B, H) of one direction from xp (T, B, 4H).
extern "C" int bcnf_lstm_fwd(const float* xp, const float* wp, float* hs, float* cs, int T, int B, int H,
                             int Hp, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > Hp || Hp % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BCNF_CALL(TM, TN) return launch_fwd<TM, TN>(xp, wp, hs, cs, T, B, H, reverse, st);
  BCNF_LSTM_CASES(BCNF_CALL)
#undef BCNF_CALL
}

// Floats of scratch `bcnf_lstm_bwd` needs (the wrapper allocates it).
extern "C" long long bcnf_lstm_bwd_scratch(int T, int B, int H) {
  const int n = n_split(T, B);
  return n > 1 ? static_cast<long long>(n) * H * 4 * H : 0;
}

// K3b: dxp (T, B, 4H) and dW_hh (H, 4H) from the forward's xp, hs, cs and the
// cotangent dhs (T, B, H).
extern "C" int bcnf_lstm_bwd(const float* xp, const float* wp, const float* wpt, const float* hs,
                             const float* cs, const float* dhs, float* dxp, float* dw, float* scratch,
                             int T, int B, int H, int Hp, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > Hp || Hp % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define BCNF_CALL(TM, TN) \
  err = launch_bwd<TM, TN>(xp, wp, wpt, hs, cs, dhs, dxp, T, B, H, reverse, st); \
  break;
  BCNF_LSTM_CASES(BCNF_CALL)
#undef BCNF_CALL
  if (err != cudaSuccess) return err;

  // dW_hh = h_prev^T dgates over the (T-1) B rows that have an h_prev
  const int G = 4 * H;
  const size_t skip = static_cast<size_t>(B);  // the first step's rows, in forward order
  const float* a = reverse ? hs + skip * H : hs;
  const float* b = reverse ? dxp : dxp + skip * G;
  const int rows = (T - 1) * B;
  const int n = n_split(T, B);
  const int chunk = (rows + n - 1) / n;
  AtbJob jobs[kMaxSplit];
  for (int p = 0; p < n; ++p) {
    const int r0 = p * chunk;
    const int k = rows - r0 < chunk ? (rows - r0 > 0 ? rows - r0 : 0) : chunk;
    jobs[p] = {a + static_cast<size_t>(r0) * H, b + static_cast<size_t>(r0) * G,
               n > 1 ? scratch + static_cast<size_t>(p) * H * G : dw, nullptr, H, G, H, G, k};
  }
  if ((err = launch_atb(jobs, n, st)) != cudaSuccess) return err;
  if (n > 1) {
    sum_parts_kernel<<<(H * G + 255) / 256, 256, 0, st>>>(scratch, n, H * G, dw);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

extern "C" const char* bcnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
