// 3xTF32 products on Hopper's tensor cores: the building blocks of the
// training kernels K2a and K2b (flow_rows.cuh), the LSTM kernels K3a and K3b
// (lstm_kernel.cu) and the A^T B weight-grad pass (atb.cuh); and the one-pass
// TF32 product of the flow kernels' reduced mode (`mma_passes<1>`).
//
// Which JAX mode it mirrors. The JAX package serves its "highest"/"float32"
// contract in the fused kernels with a split-operand product on the matrix
// unit, not with exact float32: CondRealNVP maps "highest" to "x3"
// (bcnf_tpu/models/cnf.py, `_FUSED_PRECISION_MODES`), the bf16 x 3
// decomposition of `_dot`/`_dotg` (bcnf_tpu/ops/flow_kernel.py). Its Hopper
// counterpart is 3xTF32: a float32 x splits into hi = tf32(x) (round to
// nearest, ties away from zero, as cvt.rna) and lo = x - hi (exact; the
// tensor cores truncate it to TF32), and a product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi on `mma.sync.m16n8k8` with tf32 operands
// and a float32 accumulator. The dropped a_lo b_lo term, lo's truncation and
// the accumulator leave a relative error of ~2^-21 a product, near
// float32's 2^-24 and far below bf16 x 3's.
//
// What bounds it: three tensor-core products per product, so a third of the
// dense TF32 rate (494.7 TFLOP/s on an H100 SXM: ~165 effective, 2.5x the
// 66.9 TFLOP/s float32 FMA rate of flow_common.cuh's path). Operands are
// split as their fragments are loaded from shared memory, 3 instructions a
// value (mma_3xtf32 then keeps a warp's products of one term together).
//
// bcnf_tpu_torch/ops/tf32.py is the plain PyTorch model of this arithmetic
// (`round_tf32`, `matmul_3xtf32`), for the tests only.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), lane = 4 g + t:
//   A (16 x 8, row):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (t, g), b1 (t+4, g)           as (k, n)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bcnf {

// TF32 of x, rounded to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives on finite values and on +-inf (adding half of the
// 13 dropped bits' range carries into the kept ones exactly when the dropped
// part is at least half; a carry out of the mantissa moves the exponent up),
// in two integer operations where ptxas lowers cvt.rna to four with a NaN
// guard.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
// The same, kept in a float.
__device__ __forceinline__ float rna(float x) { return __uint_as_float(tf32_rna(x)); }

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = tf32_rna(x); lo = x - hi (exact), handed to the tensor cores as it
// is: they read a TF32 operand's top 19 bits, so lo is truncated to TF32
// there, which costs at most its last bit (|x - hi| <= 2^-11 |x|, so lo is
// within 2^-21 |x| of x - hi) and saves the second rounding.
template <int N>
__device__ __forceinline__ void split_tf32(const float (&v)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
  }
}

// A fragment of the 16 x 8 tile whose (0, 0) element is s[0]; element (row, k)
// at s[row * ld + k] (row-major A).
__device__ __forceinline__ FragA load_a_rowmajor(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[4] = {s[g * ld + t], s[(g + 8) * ld + t], s[g * ld + t + 4], s[(g + 8) * ld + t + 4]};
  FragA f;
  split_tf32(v, f.hi, f.lo);
  return f;
}

// The same, element (row, k) at s[k * ld + row] (A stored transposed).
__device__ __forceinline__ FragA load_a_kmajor(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[4] = {s[t * ld + g], s[t * ld + g + 8], s[(t + 4) * ld + g], s[(t + 4) * ld + g + 8]};
  FragA f;
  split_tf32(v, f.hi, f.lo);
  return f;
}

// B fragment of the 8 x 8 tile whose (0, 0) element is s[0]; element (k, n)
// at s[k * ld + n].
__device__ __forceinline__ FragB load_b_kmajor(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[2] = {s[t * ld + g], s[(t + 4) * ld + g]};
  FragB f;
  split_tf32(v, f.hi, f.lo);
  return f;
}

// The same, element (k, n) at s[n * ld + k]: a product with a weight's
// transpose reads the weight as it is stored.
__device__ __forceinline__ FragB load_b_nmajor(const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[2] = {s[g * ld + t], s[g * ld + t + 4]};
  FragB f;
  split_tf32(v, f.hi, f.lo);
  return f;
}

// Not volatile: the product has no side effect, so the compiler may
// interleave it with other work.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += a[i] b[j] in 3xTF32 for i < NA and j < nb (<= NB): the two
// small terms first, the large one last, each term over all the pairs
// before the next. A warp issues in order, so the three products into one
// accumulator are kept apart: the tensor cores work on independent
// accumulators in between instead of waiting out each product's latency.
template <int NA, int NB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NA][NB][4], const FragA (&a)[NA], const FragB (&b)[NB],
                                           int nb = NB) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) mma_tf32(acc[i][j], a[i].lo, b[j].hi);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) mma_tf32(acc[i][j], a[i].hi, b[j].lo);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) mma_tf32(acc[i][j], a[i].hi, b[j].hi);
}

// acc[i][j] += a[i] b[j] in P tensor-core passes a product: P = 3 is
// mma_3xtf32; P = 1 is one TF32 pass, a_hi b_hi, each operand rounded once to
// TF32 (tf32_rna, the bits of cvt.rna): the Hopper counterpart of the JAX
// kernels' reduced "default" mode (one bf16 pass on the TPU's matrix unit),
// which serves the "default", "bfloat16" and "BF16_BF16_F32_X3" precisions
// (bcnf_tpu/models/cnf.py, `_FUSED_PRECISION_MODES`). The loaders' lo halves
// are then never read, and the compiler drops them.
template <int P, int NA, int NB>
__device__ __forceinline__ void mma_passes(float (&acc)[NA][NB][4], const FragA (&a)[NA], const FragB (&b)[NB],
                                           int nb = NB) {
  static_assert(P == 1 || P == 3, "a product takes one TF32 pass or three (3xTF32)");
  if constexpr (P == 3) {
    mma_3xtf32(acc, a, b, nb);
  } else {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j < nb) mma_tf32(acc[i][j], a[i].hi, b[j].hi);
  }
}

}  // namespace bcnf
