// What K2b's two 3xTF32 `wgmma` routes share: flow_train_wgmma.cu (Hp <=
// 544) and flow_wide_train_wgmma.cu (Hp 768 and 1024). Their rows kernels
// write h_l and da_{l+1} in the weight-grad pass's stage layouts
// (`hT_index`, `daA_index`) and the narrow weights' and the ActNorm's sums
// into a partial per step and cluster (`Partial`), which `tw_reduce` sums
// once a call. Each source includes it once, into its own anonymous
// namespace.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Offsets of a (step, cluster) partial: dWout (Hp x n_out), dW1y (d_a x Hp),
// dbout (n_out), db1 (Hp), the ActNorm sums (sum dx1 x_k: size, sum dx1:
// size, sum dld: 1).
struct Partial {
  int out, w1y, bout, b1, an, floats;
  __host__ __device__ Partial(int Hp, int size, int d_a) {
    const int n_out = 2 * (size - d_a);
    out = 0;
    w1y = Hp * n_out;
    bout = w1y + d_a * Hp;
    b1 = bout + n_out;
    an = b1 + Hp;
    floats = (an + 2 * size + 1 + 3) / 4 * 4;  // 16-byte aligned records
  }
};

// h_l as the weight-grad pass's B stages: row r, feature f of a plane laid
// out (rows / 32, Hp / 8 feature groups, 8 row quads, 8 features, 4 rows).
__device__ __forceinline__ size_t hT_index(int r, int f, int Hp) {
  return ((static_cast<size_t>(r >> 5) * (Hp >> 3) + (f >> 3)) << 8) + (((r & 31) >> 2) << 5) + ((f & 7) << 2) +
         (r & 3);
}

// da_l as its A stages: (rows / 32, MT feature tiles, 32 rows, 64 features),
// feature f of row r at column (f mod 64) XOR 8 (r mod 4).
__device__ __forceinline__ size_t daA_index(int r, int f, int MT) {
  return ((static_cast<size_t>(r >> 5) * MT + (f >> 6)) << 11) + ((r & 31) << 6) + ((f & 63) ^ ((r & 3) << 3));
}

// The partials of every step summed over the clusters in cluster order into
// dWout, dW1y, dbout, db1 and the ActNorm grads: dscale[k] = sum(dx1 x_k) +
// sum(dld) / scale[k], dbias[k] = sum(dx1); zero at the final step.
__global__ void tw_reduce(const float* __restrict__ part, const float* __restrict__ an_s, float* __restrict__ dwout,
                          float* __restrict__ dw1y, float* __restrict__ dbout, float* __restrict__ db1,
                          float* __restrict__ dan_s, float* __restrict__ dan_b, int S, int clusters, int Hp, int size,
                          int d_a) {
  const Partial pt(Hp, size, d_a);
  const int n_out = 2 * (size - d_a);
  const int G = pt.an + 2 * size;  // outputs a step
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(S) * G) return;
  const int k = static_cast<int>(idx / G);
  int o = static_cast<int>(idx % G);
  const float* p = part + static_cast<size_t>(k) * clusters * pt.floats;
  auto total = [&](int f) {
    float s = 0.0f;
    for (int c = 0; c < clusters; ++c) s += p[static_cast<size_t>(c) * pt.floats + f];
    return s;
  };
  if (o < pt.w1y) {
    dwout[static_cast<size_t>(k) * Hp * n_out + o] = total(pt.out + o);
  } else if (o < pt.bout) {
    dw1y[static_cast<size_t>(k) * d_a * Hp + o - pt.w1y] = total(o);
  } else if (o < pt.b1) {
    dbout[static_cast<size_t>(k) * n_out + o - pt.bout] = total(o);
  } else if (o < pt.an) {
    db1[static_cast<size_t>(k) * Hp + o - pt.b1] = total(o);
  } else {
    o -= pt.an;
    const int i = o % size;
    float v = 0.0f;
    if (k < S - 1)
      v = o < size ? total(pt.an + i) + total(pt.an + 2 * size) / an_s[k * size + i] : total(pt.an + size + i);
    (o < size ? dan_s : dan_b)[k * size + i] = v;
  }
}

}  // namespace
