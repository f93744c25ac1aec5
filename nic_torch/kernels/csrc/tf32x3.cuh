// fp32 dots on the tensor cores as three TF32 products (sm_90a), shared by
// the decodes' tensor-core tail (decode_mma.cuh: K1/K5, K2, K3, K4) and the
// train kernels' fp32-dot bodies (train_common.cuh: K11's ff_pixel_tf32,
// K12's ff3_pixel_tf32).
//
// Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// a b is taken as al bh + ah bl + ah bh in m16n8k8 tf32 products with fp32
// accumulators; the dropped al bl is ~2^-22 of a product.
//
// Fragment layout (PTX ISA, mma.m16n8k8 .tf32): lane (g, q) = (lane / 4,
// lane % 4) holds A rows g and g + 8 at columns q and q + 4, B rows q and
// q + 4 at column g, and the accumulator rows g and g + 8 at columns 2 q and
// 2 q + 1. In the accumulator layout of a [16][64] activation, h[nt][2 s +
// i] is row g + 8 s, unit 8 nt + 2 q + i (eight n8 tiles); its k8 tile t is
// an A operand when logical columns q and q + 4 stand for units 8 t + 2 q
// and 8 t + 2 q + 1 (perm_a), and the B tiles here are laid out to match: a
// B tile is staged by output column n as float4s {hi(b[2p][n]),
// hi(b[2p + 1][n]), lo(b[2p][n]), lo(b[2p + 1][n])}, one per k pair p, so
// that lane (g, q) of k8 tile t reads its two B words, hi and lo, in one
// 16-byte load at pair 4 t + q of row n = 8 nt + g.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nic_tf32 {

// x rounded to tf32 (round to nearest, ties away), as its fp32 bits
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: m16n8k8, tf32 inputs, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the fp32 A fragment of one k8 tile as tf32 hi and lo parts
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_of(a[e]);
    lo[e] = tf32_of(a[e] - __uint_as_float(hi[e]));
  }
}

// the B words of one k pair as {hi(w0), hi(w1), lo(w0), lo(w1)}
__device__ __forceinline__ float4 hilo2(float w0, float w1) {
  const uint32_t h0 = tf32_of(w0), h1 = tf32_of(w1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(tf32_of(w0 - __uint_as_float(h0))),
                     __uint_as_float(tf32_of(w1 - __uint_as_float(h1))));
}

// d += a b in three tf32 products: al bh + ah bl + ah bh (al bl dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float4 b) {
  mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// k8 tile t of a [16][64] activation in the accumulator layout as the tf32
// A fragment: logical columns q and q + 4 are units 8 t + 2 q and 8 t + 2 q
// + 1 (the B tiles are laid out to match)
__device__ __forceinline__ void perm_a(const float (&h)[8][4], int t,
                                       float (&a)[4]) {
  a[0] = h[t][0];
  a[1] = h[t][2];
  a[2] = h[t][1];
  a[3] = h[t][3];
}

// A B tile of kn rows (a multiple of 16) and 64 columns into dst in the
// layout above, rows of kn / 2 + 4 float4s (so the 16-byte loads of a
// quarter warp hit 32 banks): element (k, n) is src[k * ld_k + n * ld_n],
// zero from row kmax on. All threads of the block take part.
__device__ __forceinline__ void stage_b_pairs(float4* dst,
                                              const float* __restrict__ src,
                                              size_t ld_k, size_t ld_n,
                                              int kn, int kmax) {
  const int rw = kn / 2 + 4;
  for (int i = threadIdx.x; i < 32 * kn; i += blockDim.x) {
    const int kp = i / 64, n = i % 64, k = 2 * kp;
    const float* s = src + static_cast<size_t>(k) * ld_k + n * ld_n;
    const float w0 = k < kmax ? s[0] : 0.0f;
    const float w1 = k + 1 < kmax ? s[ld_k] : 0.0f;
    dst[n * rw + kp] = hilo2(w0, w1);
  }
}

// d[nt] += h W over one 64 x 64 tile: h a [16][64] activation in the
// accumulator layout, W staged by stage_b_pairs (kn = 64, rows of 36)
__device__ __forceinline__ void tile_3xtf32(float (&d)[8][4],
                                            const float (&h)[8][4],
                                            const float4* w, int g, int q) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float a[4];
    uint32_t ah[4], al[4];
    perm_a(h, t, a);
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_3xtf32(d[nt], ah, al, w[(8 * nt + g) * 36 + 4 * t + q]);
  }
}

}  // namespace nic_tf32
