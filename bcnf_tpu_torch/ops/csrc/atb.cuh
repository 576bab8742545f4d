// C = A^T B over the rows of A and B: the deterministic weight-grad pass
// shared by the training backward K2b (flow_train_kernel.cu) and the LSTM
// backward K3b (lstm_kernel.cu).
//
// Each block owns one 64 x 64 output tile and loops over all of its job's
// rows in a fixed order; several products go into one launch (blockIdx.z
// picks the job). A's row m (one past its last column) is taken to be all
// ones, so row m of the product is B's column sums: a layer's bias grad
// comes out of the same pass. No atomics, so the result does not depend on
// the order in which blocks run.

#pragma once

#include "flow_common.cuh"

namespace bcnf {

struct AtbJob {
  const float* a;  // k x m, leading dimension lda (unused when m = 0)
  const float* b;  // k x n, leading dimension ldb
  float* c;        // m x n, row-major (unused when m = 0)
  float* sums;     // n: the column sums of b (not written when null)
  int lda, ldb, m, n;
  int k;           // rows of a and b
};

constexpr int kMaxJobs = 8;
struct AtbJobs {
  AtbJob job[kMaxJobs];
};

constexpr int kTile = 64;   // output tile, 16 x 16 threads of 4 x 4
constexpr int kTileK = 16;  // rows per shared-memory stage

// static: each library that includes this header keeps its own copy
static __global__ void __launch_bounds__(kThreads)
atb_kernel(const AtbJobs jobs) {
  const AtbJob jb = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  if (m0 > jb.m || n0 >= jb.n) return;  // output rows 0..m: row m holds the column sums

  __shared__ float4 as4[kTileK * kTile / 4];
  __shared__ float4 bs4[kTileK * kTile / 4];
  float* as = reinterpret_cast<float*>(as4);
  float* bs = reinterpret_cast<float*>(bs4);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < jb.k; k0 += kTileK) {
    for (int e = tid; e < kTileK * kTile; e += kThreads) {
      const int kr = k0 + e / kTile;
      const int m = m0 + e % kTile;
      const int n = n0 + e % kTile;
      float va = 0.0f, vb = 0.0f;
      if (kr < jb.k) {
        va = m < jb.m ? jb.a[static_cast<size_t>(kr) * jb.lda + m] : (m == jb.m ? 1.0f : 0.0f);
        if (n < jb.n) vb = jb.b[static_cast<size_t>(kr) * jb.ldb + n];
      }
      as[e] = va;
      bs[e] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = as4[(kk * kTile + ty * 4) / 4];
      const float4 b = bs4[(kk * kTile + tx * 4) / 4];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= jb.n) continue;
      if (m < jb.m) jb.c[static_cast<size_t>(m) * jb.n + n] = acc[i][j];
      else if (m == jb.m && jb.sums != nullptr) jb.sums[n] = acc[i][j];
    }
  }
}

// Enqueue the jobs, kMaxJobs to a launch; returns the first launch error.
static cudaError_t launch_atb(const AtbJob* list, int n_jobs, cudaStream_t stream) {
  for (int j0 = 0; j0 < n_jobs; j0 += kMaxJobs) {
    AtbJobs jobs = {};
    const int n = n_jobs - j0 < kMaxJobs ? n_jobs - j0 : kMaxJobs;
    int max_m = 0, max_n = 0;
    for (int j = 0; j < n; ++j) {
      jobs.job[j] = list[j0 + j];
      max_m = list[j0 + j].m > max_m ? list[j0 + j].m : max_m;
      max_n = list[j0 + j].n > max_n ? list[j0 + j].n : max_n;
    }
    const dim3 grid((max_n + kTile - 1) / kTile, max_m / kTile + 1, n);
    atb_kernel<<<grid, kThreads, 0, stream>>>(jobs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace bcnf
