// C = A^T B over the rows of A and B: the deterministic weight-grad pass
// shared by the training backward K2b (flow_train_kernel.cu) and the LSTM
// backward K3b (lstm_kernel.cu), on tensor cores in 3xTF32 (mma_tf32.cuh),
// or with P = 1 (K2b's reduced mode) in one TF32 pass for the weight rows.
// The column sums (the ones row, and a job with m = 0) stay 3xTF32 in both:
// the JAX kernels take the bias and ActNorm grads as float32 sums, not as
// products at the kernel's precision; a warp whose 32 rows reach the ones
// row takes all of its rows in 3xTF32.
//
// What bounds it on an H100: operations, 2 m n k FLOP a product, at a third
// of the dense TF32 rate; its inputs are read once a 64 x 128 output tile.
//
// Design. A block owns one 64 x 128 output tile of one row chunk of one job;
// its 8 warps (2 x 4) each hold a 32 x 32 tile of the sum in registers. The
// block walks its chunk's rows in order, 32 at a time, through a 4-stage
// cp.async ring in shared memory (16-byte copies where rows are aligned,
// 4-byte copies at ragged or unaligned edges), so the next three stages load
// while one is multiplied; two blocks fit an SM. Each stage's 32 rows go into a fresh tensor-core
// accumulator, which is then added to the running sum by a float32 add: the
// tensor cores' accumulator does not round to nearest, and over a long sum
// (4096 rows of a bias grad) that bias grows past the float32 grad bar. Every job of a call goes into one launch (a block
// finds its job, chunk and tile from its index). A's column m (one past its
// last) is taken to be all ones, so row m of the product is B's column sums:
// a layer's bias grad comes out of the same pass. Deterministic: a chunk's
// rows are summed by one block in a fixed order, chunks go to separate
// partials (the caller adds them in a fixed order), and there are no atomics.

#pragma once

#include "flow_common.cuh"
#include "mma_tf32.cuh"

namespace bcnf {

struct AtbJob {
  const float* a;  // k x m, leading dimension lda (unused when m = 0)
  const float* b;  // k x n, leading dimension ldb
  float* c;        // m x n row-major for each chunk, chunk p at c + p m n (unused when m = 0)
  float* sums;     // n for each chunk, chunk p at sums + p n: B's column sums (not written when null)
  int lda, ldb, m, n;
  int k;           // rows of a and b
  int chunk;       // rows a partial sums: ceil(k / chunk) partials (at least one)
};

constexpr int kAtbMaxJobs = 16;
struct AtbJobs {
  AtbJob job[kAtbMaxJobs];
  int first[kAtbMaxJobs + 1];  // first block of each job
  int n_jobs;
};

constexpr int kAtbM = 64, kAtbN = 128, kAtbK = 32, kAtbStages = 4;
constexpr int kAtbLdA = kAtbM + 8;  // bank-conflict-free k-major fragment loads
constexpr int kAtbLdB = kAtbN + 8;
constexpr int kAtbStageFloats = kAtbK * (kAtbLdA + kAtbLdB);
constexpr size_t kAtbSmem = sizeof(float) * kAtbStages * kAtbStageFloats;

__host__ __device__ inline int atb_tiles_m(const AtbJob& jb) {
  return (jb.m + (jb.sums != nullptr ? 1 : 0) + kAtbM - 1) / kAtbM;
}
__host__ __device__ inline int atb_tiles_n(const AtbJob& jb) { return (jb.n + kAtbN - 1) / kAtbN; }
__host__ __device__ inline int atb_chunks(const AtbJob& jb) {
  const int n = (jb.k + jb.chunk - 1) / jb.chunk;
  return n > 1 ? n : 1;
}

// static: each library that includes this header keeps its own copy
template <int P>
static __global__ void __launch_bounds__(kThreads, 2) atb_kernel(const AtbJobs jobs) {
  int j = 0;
  while (j + 1 < jobs.n_jobs && static_cast<int>(blockIdx.x) >= jobs.first[j + 1]) ++j;
  const AtbJob jb = jobs.job[j];
  const int tm = atb_tiles_m(jb), tn = atb_tiles_n(jb);
  const int local = blockIdx.x - jobs.first[j];
  const int p = local / (tm * tn);
  const int m0 = (local % (tm * tn)) / tn * kAtbM;
  const int n0 = (local % tn) * kAtbN;
  const int r0 = p * jb.chunk;
  const int rows = jb.k - r0 < jb.chunk ? jb.k - r0 : jb.chunk;

  extern __shared__ float4 atb_smem4[];
  float* smem = reinterpret_cast<float*>(atb_smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const bool vec_a = jb.m > 0 && (jb.lda & 3) == 0 && (reinterpret_cast<size_t>(jb.a) & 15) == 0;
  const bool vec_b = (jb.ldb & 3) == 0 && (reinterpret_cast<size_t>(jb.b) & 15) == 0;
  const float* a = jb.m > 0 ? jb.a + static_cast<size_t>(r0) * jb.lda : nullptr;
  const float* b = jb.b + static_cast<size_t>(r0) * jb.ldb;
  const bool one_pass = P == 1 && m0 + wm + 32 <= jb.m;  // the warp's rows are all weight rows

  // rows kt*kAtbK .. +kAtbK of the chunk into stage s: A's columns m0.. (ones
  // at column m, zeros past it and past the chunk's rows), B's columns n0..
  auto load_stage = [&](int s, int kt) {
    float* as = smem + s * kAtbStageFloats;
    float* bs = as + kAtbK * kAtbLdA;
    for (int e = tid; e < kAtbK * kAtbM / 4; e += kThreads) {
      const int kr = e / (kAtbM / 4), q = (e % (kAtbM / 4)) * 4;
      const int row = kt * kAtbK + kr, m = m0 + q;
      float* dst = as + kr * kAtbLdA + q;
      if (row < rows && vec_a && m + 3 < jb.m) {
        cp_async16(dst, a + static_cast<size_t>(row) * jb.lda + m);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row < rows && m + i < jb.m) cp_async4(dst + i, a + static_cast<size_t>(row) * jb.lda + m + i);
          else dst[i] = row < rows && m + i == jb.m ? 1.0f : 0.0f;
        }
      }
    }
    for (int e = tid; e < kAtbK * kAtbN / 4; e += kThreads) {
      const int kr = e / (kAtbN / 4), q = (e % (kAtbN / 4)) * 4;
      const int row = kt * kAtbK + kr, n = n0 + q;
      float* dst = bs + kr * kAtbLdB + q;
      if (row < rows && vec_b && n + 3 < jb.n) {
        cp_async16(dst, b + static_cast<size_t>(row) * jb.ldb + n);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row < rows && n + i < jb.n) cp_async4(dst + i, b + static_cast<size_t>(row) * jb.ldb + n + i);
          else dst[i] = 0.0f;
        }
      }
    }
  };

  float sum[2][4][4];  // the running sum of the stages
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][jn][e] = 0.0f;

  const int nk = rows > 0 ? (rows + kAtbK - 1) / kAtbK : 0;
#pragma unroll
  for (int s = 0; s < kAtbStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kAtbStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                  // ... and everyone's; stage kt-1 is free again
    const int nxt = kt + kAtbStages - 1;
    if (nxt < nk) load_stage(nxt % kAtbStages, nxt);
    cp_async_commit();
    const float* as = smem + (kt % kAtbStages) * kAtbStageFloats;
    const float* bs = as + kAtbK * kAtbLdA;
    float acc[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kAtbK; kk += 8) {
      FragA fa[2];
      FragB fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) fa[i] = load_a_kmajor(as + kk * kAtbLdA + wm + 16 * i, kAtbLdA, lane);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) fb[jn] = load_b_kmajor(bs + kk * kAtbLdB + wn + 8 * jn, kAtbLdB, lane);
      if (one_pass) mma_passes<1>(acc, fa, fb);
      else mma_3xtf32(acc, fa, fb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][jn][e] += acc[i][jn][e];
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  float* c = jb.m > 0 ? jb.c + static_cast<size_t>(p) * jb.m * jb.n : nullptr;
  float* sums = jb.sums != nullptr ? jb.sums + static_cast<size_t>(p) * jb.n : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + (e >> 1) * 8;
        const int n = n0 + wn + 8 * jn + 2 * t + (e & 1);
        if (n >= jb.n) continue;
        if (m < jb.m) c[static_cast<size_t>(m) * jb.n + n] = sum[i][jn][e];
        else if (m == jb.m && sums != nullptr) sums[n] = sum[i][jn][e];
      }
}

// Enqueue every job in one launch, its weight rows in P passes; returns the
// launch's error.
template <int P = 3>
static cudaError_t launch_atb(const AtbJob* list, int n_jobs, cudaStream_t stream) {
  if (n_jobs < 1 || n_jobs > kAtbMaxJobs) return cudaErrorInvalidValue;
  AtbJobs jobs = {};
  jobs.n_jobs = n_jobs;
  int blocks = 0;
  for (int j = 0; j < n_jobs; ++j) {
    if (list[j].chunk < 1) return cudaErrorInvalidValue;
    jobs.job[j] = list[j];
    jobs.first[j] = blocks;
    blocks += atb_chunks(list[j]) * atb_tiles_m(list[j]) * atb_tiles_n(list[j]);
  }
  jobs.first[n_jobs] = blocks;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(atb_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kAtbSmem));
  if (err != cudaSuccess) return err;
  atb_kernel<P><<<blocks, kThreads, kAtbSmem, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace bcnf
