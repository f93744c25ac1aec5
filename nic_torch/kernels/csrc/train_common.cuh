// Device code shared by the train kernels (train_fused_ff.cu, kernel3 in
// 2D; train_fused_ff3.cu, kernel3 in 3D; train_fused.cu, the dx and
// node-gradient kernels): bf16 rounding of dot inputs, the GELU pair and
// its derivative, the counter-hash feature noise, W1 rows staged in shared
// memory or read from device memory, kernel3's per-pixel MLP tail on the
// CUDA cores (ff_tail) and on the tensor cores (ff_tail_mma, with
// noise_mma and the mma.sync/ldmatrix wrappers, for bf16 dots; with
// noise_tf32 and tf32x3.cuh's three-product TF32 dots for fp32 dots), the
// eps^T dz1 kernel (ff_epsgrad, bf16 dots on the tensor cores over
// cp.async-staged tiles of dz1), and the per-crop node-window (2D: one
// read of dz1, node_windows + node_corners) and node-volume (3D: the
// same in one read, node_volumes + node_volume_corners) reductions of dz1,
// and ff_pe_sum, the fixed-order sum of kernel3's PE-grad block partials.
//
// Everything here sits in an anonymous namespace: each source that
// includes it gets its own copy (the __constant__ tables included), so the
// objects link without clashing symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

// Loops over the hidden width unroll fully up to H = 64, where the arrays
// they index stay in registers. At H = 128 they stay loops (those arrays
// live in local memory, and the H = 128 kernels are slow): fully unrolled,
// their straight-line code would take ptxas longer than a build may.
#ifndef NIC_UNROLL_H
#define NIC_PRAGMA(x) _Pragma(#x)
#define NIC_UNROLL_H(n) NIC_PRAGMA(unroll (H > 64 ? 1 : (n)))
#endif

// Notes a per-pixel body's launch in the launch log (body_log.cu): called
// with the function pointer just launched, once the launch succeeded.
extern "C" void nic_note_body(const void* kernel);

namespace {

using namespace nic_tf32;

constexpr int TP = 128;   // pixels per tile = threads per block
constexpr int LDP = 132;  // row stride of the [unit][pixel] staging tiles

enum Gelu { kErf = 0, kPoly = 1 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float cd(float x) {
  return BF16 ? bf16_round(x) : x;
}

// erf by Abramowitz & Stegun 7.1.26, as nic/kernels/decode_fused.py _erf
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t + -1.453152027f) * t + 1.421413741f) * t +
        -0.284496736f) * t + 0.254829592f) * t;
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return sign * (1.0f - poly * expf(-ax * ax));
}

__device__ __constant__ float kPolyC[9] = {
    6.063213460406e-06f, 3.988279991626e-01f, -6.618728056429e-02f,
    9.689185146121e-03f, -1.058572076001e-03f, 8.262109727744e-05f,
    -4.286269517788e-06f, 1.303813961965e-07f, -1.739696971198e-09f};

// k * kPolyC[k], the product taken in double and rounded once, as JAX
// multiplies the Python constants
__device__ __constant__ float kPolyD[9] = {
    0.0f, 0.39882799983024597f, -0.13237455487251282f, 0.02906755544245243f,
    -0.004234288353472948f, 0.0004131054738536477f, -2.5717617972986773e-05f,
    9.126697477768175e-07f, -1.3917575536481763e-08f};

// the train kernels' GELU pair (nic/kernels/train_fused.py _gelu_fwd/_bwd)
template <int G>
__device__ __forceinline__ float gelu_f(float z) {
  if (G == kErf) {
    const float cdf = 0.5f * (1.0f + erf_as(z * 0.7071067811865476f));
    return z * cdf;
  } else {
    const float u = z * z;
    float acc = kPolyC[8];
#pragma unroll
    for (int i = 7; i >= 0; --i) acc = acc * u + kPolyC[i];
    const float h = 0.5f * z + acc;
    return z > 4.0f ? z : (z < -4.0f ? 0.0f : h);
  }
}

template <int G>
__device__ __forceinline__ float gelu_d(float z) {
  if (G == kErf) {
    const float cdf = 0.5f * (1.0f + erf_as(z * 0.7071067811865476f));
    return cdf + z * (0.3989422804014327f * expf(-0.5f * z * z));
  } else {
    const float u = z * z;
    float acc = kPolyD[8];
#pragma unroll
    for (int k = 7; k >= 1; --k) acc = acc * u + kPolyD[k];
    const float g = 0.5f + 2.0f * z * acc;
    return z > 4.0f ? 1.0f : (z < -4.0f ? 0.0f : g);
  }
}

// the counter hash of nic/kernels/train_fused_ff.py eps_uniform (int32
// wrapping multiplies and logical shifts = uint32 arithmetic)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float eps_uniform(uint32_t ctr, uint32_t s0,
                                             uint32_t s1, float scale) {
  const uint32_t x = mix32(mix32(ctr ^ s0) ^ s1);
  return (__uint_as_float((x >> 9) | 0x3F800000u) - 1.5f) * scale;
}

// The largest dynamic shared memory a block may use (227 KB), and the W1
// rule of the train kernels: W1 [F][H] is staged in shared memory, rounded
// to the dot type, when it fits beside the kernel's other tiles; otherwise
// its rows are read from device memory through L1 (every thread of a block
// reads the same row at the same time) and rounded as they arrive.
constexpr size_t kMaxSmem = 232448;

// acc[h] += x * W[h] over one W1 row (16-byte aligned): staged (kGlobal
// false) or read from device memory and rounded here (kGlobal true)
template <int H, bool BF16, bool kGlobal>
__device__ __forceinline__ void fma_row(float (&acc)[H], float x,
                                        const float* row) {
  const float4* wr = reinterpret_cast<const float4*>(row);
NIC_UNROLL_H(H / 4)
  for (int h4 = 0; h4 < H / 4; ++h4) {
    float4 w;
    if (kGlobal) {
      w = __ldg(wr + h4);
      w = make_float4(cd<BF16>(w.x), cd<BF16>(w.y), cd<BF16>(w.z),
                      cd<BF16>(w.w));
    } else {
      w = wr[h4];
    }
    acc[4 * h4] = fmaf(x, w.x, acc[4 * h4]);
    acc[4 * h4 + 1] = fmaf(x, w.y, acc[4 * h4 + 1]);
    acc[4 * h4 + 2] = fmaf(x, w.z, acc[4 * h4 + 2]);
    acc[4 * h4 + 3] = fmaf(x, w.w, acc[4 * h4 + 3]);
  }
}

// v . W over one W1 row, in four interleaved partial sums
template <int H, bool BF16, bool kGlobal>
__device__ __forceinline__ float dot_row(const float (&v)[H],
                                         const float* row) {
  const float4* wr = reinterpret_cast<const float4*>(row);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
NIC_UNROLL_H(H / 4)
  for (int h4 = 0; h4 < H / 4; ++h4) {
    float4 w;
    if (kGlobal) {
      w = __ldg(wr + h4);
      w = make_float4(cd<BF16>(w.x), cd<BF16>(w.y), cd<BF16>(w.z),
                      cd<BF16>(w.w));
    } else {
      w = wr[h4];
    }
    s0 = fmaf(v[4 * h4], w.x, s0);
    s1 = fmaf(v[4 * h4 + 1], w.y, s1);
    s2 = fmaf(v[4 * h4 + 2], w.z, s2);
    s3 = fmaf(v[4 * h4 + 3], w.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// z1 += eps_j W1[j] over the pixel's nfeat features (kernel3's feature
// noise; eps from the counter hash at ctr0 + j, rounded to the dot type)
template <int H, bool BF16, bool kGlobal>
__device__ __forceinline__ void noise_rows(float (&z1)[H], const float* w1,
                                           int nfeat, uint32_t ctr0,
                                           uint32_t s0, uint32_t s1,
                                           float scale) {
  for (int j = 0; j < nfeat; ++j) {
    const float e = cd<BF16>(
        eps_uniform(ctr0 + static_cast<uint32_t>(j), s0, s1, scale));
    fma_row<H, BF16, kGlobal>(z1, e, w1 + static_cast<size_t>(j) * H);
  }
}

// W1 staged in shared memory (rounded), or nothing when it stays in
// device memory; every thread of the block takes part
template <bool BF16>
__device__ __forceinline__ void stage_w1(float* sW1, const float* w1, int n,
                                         bool staged) {
  if (staged)
    for (int i = threadIdx.x; i < n; i += blockDim.x) sW1[i] = cd<BF16>(w1[i]);
}

// four consecutive entries of a staged row as floats (fp32 rows, or bf16
// rows whose values are already bf16: the tensor-core tail's h2b)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// block sums of dW3 = h2b^T dz3b (rows 0..H-1 of the loop, from the
// staged h2b [H][LDP] and dz3b [3][LDP]), db3 from the raw dz3 (rows H..H+2)
// and the loss (row H+3), set on the block's first tile and added to
// after it; a thread takes rows tid, tid + TP, ...
template <int H, typename T>
__device__ __forceinline__ void tail_w3_sums(const T* sB, const float* sD,
                                             float* mypart, bool first,
                                             float inv_total) {
  for (int row = threadIdx.x; row < H + 4; row += TP) {
    if (row < H) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int p = 0; p < TP; p += 4) {
        const float4 hv = ld4(sB + row * LDP + p);
        const float4 d0 = *reinterpret_cast<const float4*>(sD + 0 * LDP + p);
        const float4 d1 = *reinterpret_cast<const float4*>(sD + 1 * LDP + p);
        const float4 d2 = *reinterpret_cast<const float4*>(sD + 2 * LDP + p);
        a0 += hv.x * d0.x + hv.y * d0.y + hv.z * d0.z + hv.w * d0.w;
        a1 += hv.x * d1.x + hv.y * d1.y + hv.z * d1.z + hv.w * d1.w;
        a2 += hv.x * d2.x + hv.y * d2.y + hv.z * d2.z + hv.w * d2.w;
      }
      float* dst = mypart + 4 + row * 3;
      dst[0] = first ? a0 : dst[0] + a0;
      dst[1] = first ? a1 : dst[1] + a1;
      dst[2] = first ? a2 : dst[2] + a2;
    } else {
      const int r = row - H;  // 0..2: db3[c] from raw dz3; 3: loss
      const float* src = sD + (r < 3 ? 3 + r : 6) * LDP;
      float a = 0.0f;
      for (int p = 0; p < TP; p += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + p);
        a += (v.x + v.y) + (v.z + v.w);
      }
      if (r == 3) a *= inv_total;
      float* dst = mypart + (r < 3 ? 1 + r : 0);
      dst[0] = first ? a : dst[0] + a;
    }
  }
}

// kernel3's per-pixel MLP tail, from z1 (in registers) to dz1: the
// forward z2 = gelu(z1)b W2 + b2, out = sigmoid(gelu(z2)b W3 + b3), the
// squared error, and the backward dz3, dz2, dz1 (written to device memory
// for the valid pixels, row `pix` of [N, H]); then the block's partial
// sums of loss, dW3, db3, dW2, db2 into `mypart` (layout [loss, db3[3],
// dW3[H][3], db2[H], dW2[H][H]]), set on the block's first tile and
// added to after it. sA, sB ([H][LDP]) and sD ([7][LDP]) stage the tile's
// activations transposed, so each thread writes its own column and the
// reductions read four pixels per 16-byte load. Every thread of the block
// calls it (it synchronises).
template <int H, bool BF16, int G>
__device__ __forceinline__ void ff_tail(
    float (&z1)[H], bool valid, size_t pix, const float* sW2,
    const float* sW3, const float* sb2, const float* sb3, float* sA,
    float* sB, float* sD, const float* __restrict__ tgt,
    float* __restrict__ out, float* __restrict__ dz1, float* mypart,
    bool first, float inv_total) {
  const int tid = threadIdx.x;
  float z2[H];
  float dz3[3] = {0.0f, 0.0f, 0.0f}, dz3b[3] = {0.0f, 0.0f, 0.0f};
  float lossv = 0.0f;
  if (valid) {
    // layer 2: z2 = h1b W2 + b2, h1b staged for dW2
NIC_UNROLL_H(H)
    for (int j = 0; j < H; ++j) z2[j] = 0.0f;
NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) {
      const float hk = cd<BF16>(gelu_f<G>(z1[k]));
      sA[k * LDP + tid] = hk;
      const float4* wr = reinterpret_cast<const float4*>(sW2 + k * H);
NIC_UNROLL_H(H / 4)
      for (int j4 = 0; j4 < H / 4; ++j4) {
        const float4 w = wr[j4];
        z2[4 * j4] = fmaf(hk, w.x, z2[4 * j4]);
        z2[4 * j4 + 1] = fmaf(hk, w.y, z2[4 * j4 + 1]);
        z2[4 * j4 + 2] = fmaf(hk, w.z, z2[4 * j4 + 2]);
        z2[4 * j4 + 3] = fmaf(hk, w.w, z2[4 * j4 + 3]);
      }
    }
    // layer 3, sigmoid, loss and dz3
    float o3[3] = {0.0f, 0.0f, 0.0f};
NIC_UNROLL_H(H)
    for (int j = 0; j < H; ++j) {
      z2[j] += sb2[j];
      const float h2 = cd<BF16>(gelu_f<G>(z2[j]));
      sB[j * LDP + tid] = h2;
      o3[0] = fmaf(h2, sW3[j * 3 + 0], o3[0]);
      o3[1] = fmaf(h2, sW3[j * 3 + 1], o3[1]);
      o3[2] = fmaf(h2, sW3[j * 3 + 2], o3[2]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ov = 1.0f / (1.0f + expf(-(o3[c] + sb3[c])));
      out[pix * 3 + c] = ov;
      const float diff = ov - tgt[pix * 3 + c];
      lossv = fmaf(diff, diff, lossv);
      dz3[c] = (2.0f * inv_total) * diff * ov * (1.0f - ov);
      dz3b[c] = cd<BF16>(dz3[c]);
    }
    // dz2 = (dz3b W3^T) * gelu'(z2), in place of z2
NIC_UNROLL_H(H)
    for (int j = 0; j < H; ++j) {
      const float dh2 = dz3b[0] * sW3[j * 3 + 0] + dz3b[1] * sW3[j * 3 + 1] +
                        dz3b[2] * sW3[j * 3 + 2];
      z2[j] = dh2 * gelu_d<G>(z2[j]);
    }
  } else {
NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) {
      sA[k * LDP + tid] = 0.0f;
      sB[k * LDP + tid] = 0.0f;
      z2[k] = 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sD[c * LDP + tid] = dz3b[c];
    sD[(3 + c) * LDP + tid] = dz3[c];
  }
  sD[6 * LDP + tid] = lossv;
  __syncthreads();

  tail_w3_sums<H>(sB, sD, mypart, first, inv_total);
  __syncthreads();

  // raw dz2 to sB (dW2, db2), then dh1 = dz2b W2^T and dz1 = dh1 gelu'(z1)
NIC_UNROLL_H(H)
  for (int j = 0; j < H; ++j) {
    sB[j * LDP + tid] = z2[j];
    z2[j] = cd<BF16>(z2[j]);
  }
  if (valid) {
    float* drow = dz1 + pix * H;
NIC_UNROLL_H(H / 4)
    for (int k4 = 0; k4 < H / 4; ++k4) {
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * k4 + q;
        const float4* wr = reinterpret_cast<const float4*>(sW2 + k * H);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
NIC_UNROLL_H(H / 4)
        for (int j4 = 0; j4 < H / 4; ++j4) {
          const float4 w = wr[j4];
          s0 = fmaf(z2[4 * j4], w.x, s0);
          s1 = fmaf(z2[4 * j4 + 1], w.y, s1);
          s2 = fmaf(z2[4 * j4 + 2], w.z, s2);
          s3 = fmaf(z2[4 * j4 + 3], w.w, s3);
        }
        d[q] = ((s0 + s1) + (s2 + s3)) * gelu_d<G>(z1[k]);
      }
      reinterpret_cast<float4*>(drow)[k4] = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
  __syncthreads();

  // block sums of dW2 = h1b^T dz2b and db2: thread owns j = jq + JQ*jj
  // (jj < 4) and k = kg + KG*m (m < KPT)
  {
    constexpr int JQ = H / 4;
    constexpr int KG = TP / JQ;
    constexpr int KPT = H >= KG ? H / KG : 1;
    const int jq = tid % JQ, kg = tid / JQ;
    if (kg < H) {
      float acc[KPT][4];
      float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
NIC_UNROLL_H(KPT)
      for (int m = 0; m < KPT; ++m)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[m][jj] = 0.0f;
      for (int p = 0; p < TP; p += 4) {
        float4 bv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bv[jj] = *reinterpret_cast<const float4*>(sB + (jq + JQ * jj) * LDP + p);
          if (kg == 0) bsum[jj] += (bv[jj].x + bv[jj].y) + (bv[jj].z + bv[jj].w);
          bv[jj] = make_float4(cd<BF16>(bv[jj].x), cd<BF16>(bv[jj].y),
                               cd<BF16>(bv[jj].z), cd<BF16>(bv[jj].w));
        }
NIC_UNROLL_H(KPT)
        for (int m = 0; m < KPT; ++m) {
          const float4 av =
              *reinterpret_cast<const float4*>(sA + (kg + KG * m) * LDP + p);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float a = acc[m][jj];
            a = fmaf(av.x, bv[jj].x, a);
            a = fmaf(av.y, bv[jj].y, a);
            a = fmaf(av.z, bv[jj].z, a);
            a = fmaf(av.w, bv[jj].w, a);
            acc[m][jj] = a;
          }
        }
      }
      float* dW2 = mypart + 4 + 4 * H;
      float* db2 = mypart + 4 + 3 * H;
NIC_UNROLL_H(KPT)
      for (int m = 0; m < KPT; ++m)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float* dst = dW2 + (kg + KG * m) * H + jq + JQ * jj;
          *dst = first ? acc[m][jj] : *dst + acc[m][jj];
        }
      if (kg == 0)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float* dst = db2 + jq + JQ * jj;
          *dst = first ? bsum[jj] : *dst + bsum[jj];
        }
    }
  }
  __syncthreads();
}

// ---- tensor-core pieces (bf16 or 3xTF32 inputs, fp32 accumulators) ------

constexpr int MT = 256;   // threads of a tensor-core block: 8 warps x 16 pixels
constexpr int LDB = 72;   // bf16 row stride of the tensor-core tiles: 144 B,
                          // so ldmatrix rows are 16-byte aligned and the
                          // 8 rows of a matrix hit distinct banks

// v rounded up to a multiple of 16 (an m16n8k16 product's k)
__host__ __device__ __forceinline__ int pad16(int v) {
  return (v + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b: one m16n8k16 product, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The tensor-core layout of kernel3's tail: a warp owns 16 pixels of the
// 128-pixel tile (rows 16 warp + g and + 8, g = lane / 4) and holds a
// [16][64] activation as the accumulator of eight n-tiles (m16n8k16 and
// m16n8k8 lay it out alike), v[nt][e]: pixel row g (e < 2) or g + 8 (e >=
// 2), unit 8 nt + 2 (lane % 4) + (e & 1). Two neighbouring n-tiles of that
// layout are the A operand of the next bf16 product, and one n-tile that
// of the next TF32 product (perm_a, tf32x3.cuh), so z1 -> h1 -> z2 and dz2
// -> dh1 stay in registers.

// z1 += eps W1 over kernel3's feature noise for the warp's 16 pixels (the
// accumulator layout above): A is the counter-hash eps, rounded to bf16,
// built in registers (pixel row r at counter ctr[r] + feature, zero past
// nfeat and for invalid rows); B is W1^T, bf16 [64][ldk] in shared memory,
// or (kGlobal) W1 [F][64] fp32 in device memory rounded as it is read
template <bool kGlobal>
__device__ __forceinline__ void noise_mma(float (&z1)[8][4],
                                          const __nv_bfloat16* sW1t, int ldk,
                                          const float* __restrict__ w1,
                                          int nfeat, const uint32_t (&ctr)[2],
                                          const bool (&valid)[2], uint32_t s0,
                                          uint32_t s1, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  auto eps = [&](int r, int j) -> float {
    return (valid[r] && j < nfeat)
               ? eps_uniform(ctr[r] + static_cast<uint32_t>(j), s0, s1, scale)
               : 0.0f;
  };
  auto w1g = [&](int k, int n) -> float {
    return k < nfeat ? __ldg(w1 + static_cast<size_t>(k) * 64 + n) : 0.0f;
  };
  for (int k0 = 0; k0 < nfeat; k0 += 16) {
    const int c = k0 + 2 * q;
    const uint32_t a[4] = {pack_bf16(eps(0, c), eps(0, c + 1)),
                           pack_bf16(eps(1, c), eps(1, c + 1)),
                           pack_bf16(eps(0, c + 8), eps(0, c + 9)),
                           pack_bf16(eps(1, c + 8), eps(1, c + 9))};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = 8 * nt + g;
      uint32_t b0, b1;
      if (kGlobal) {
        b0 = pack_bf16(w1g(c, n), w1g(c + 1, n));
        b1 = pack_bf16(w1g(c + 8, n), w1g(c + 9, n));
      } else {
        const __nv_bfloat16* w = sW1t + n * ldk + c;
        b0 = ld_u32(w);
        b1 = ld_u32(w + 8);
      }
      mma16816(z1[nt], a, b0, b1);
    }
  }
}

// z1 += eps W1 over kernel3's feature noise for the warp's 16 pixels in
// fp32-dot mode: three TF32 products a k8 slab (tf32x3.cuh). A is the
// counter-hash eps, unrounded, built in registers and split into hi and lo
// (logical columns q and q + 4 of slab k0 are features k0 + 2 q and k0 + 2
// q + 1; zero past nfeat and for invalid rows); B is W1 as stage_b_pairs
// leaves it, rows of ldw float4s (kGlobal false), or W1 [F][64] fp32 in
// device memory, split as it is read (kGlobal true)
template <bool kGlobal>
__device__ __forceinline__ void noise_tf32(float (&z1)[8][4],
                                           const float4* sW1, int ldw,
                                           const float* __restrict__ w1,
                                           int nfeat, const uint32_t (&ctr)[2],
                                           const bool (&valid)[2], uint32_t s0,
                                           uint32_t s1, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  auto eps = [&](int r, int j) -> float {
    return (valid[r] && j < nfeat)
               ? eps_uniform(ctr[r] + static_cast<uint32_t>(j), s0, s1, scale)
               : 0.0f;
  };
  auto w1g = [&](int k, int n) -> float {
    return k < nfeat ? __ldg(w1 + static_cast<size_t>(k) * 64 + n) : 0.0f;
  };
  for (int k0 = 0; k0 < nfeat; k0 += 8) {
    const int c = k0 + 2 * q;
    const float a[4] = {eps(0, c), eps(1, c), eps(0, c + 1), eps(1, c + 1)};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = 8 * nt + g;
      mma_3xtf32(z1[nt], ah, al,
                 kGlobal ? hilo2(w1g(c, n), w1g(c + 1, n))
                         : sW1[n * ldw + k0 / 2 + q]);
    }
  }
}

// shared memory of the tensor-core tail, bf16 dots
struct TailMma {
  __nv_bfloat16* sB;          // h2b [64][LDP], for dW3
  float* sD;                  // dz3b, dz3, loss [7][LDP]
  float* sDb2;                // the warps' db2 sums [8][64]
  __nv_bfloat16* sH1;         // h1b [128][LDB], for dW2
  __nv_bfloat16* sDZ;         // dz2b [128][LDB], for dW2
  const __nv_bfloat16* sW2t;  // W2^T [64 (out j)][LDB]
  const __nv_bfloat16* sW2;   // W2 [64 (in k)][LDB]
  const float* sW3;           // [64][3], bf16 values
  const float* sb2;
  const float* sb3;
};

constexpr int LDF = 72;  // fp32 row stride of the 3xTF32 tail's [pixel][unit]
                         // tiles: 8 words mod 32, so a fragment's loads
                         // (rows q, units g) hit 32 distinct banks
constexpr int RED_W = 64 * 3 + 64 + 4;  // floats of a warp's sums: dW3
                                        // [64][3], db2 [64], db3 [3], loss

// shared memory of the tensor-core tail, fp32 dots (3xTF32)
struct TailTf32 {
  float* sH1;          // h1 [TP][LDF], for dW2
  float* sDZ;          // dz2 [TP][LDF], for dW2
  float* sRed;         // the warps' sums [8][RED_W]
  const float4* sW2;   // W2 as z2's B (stage_b_pairs: rows [64 j][36] of k)
  const float4* sW2t;  // W2^T as dh1's B (rows [64 k][36] of j)
  const float* sW3;    // [64][3]
  const float* sb2;
  const float* sb3;
};

// kernel3's per-pixel MLP tail on the tensor cores, H = 64, for a block of
// MT threads and a tile of TP = 128 pixels: from z1 (the accumulator layout
// above) to dz1 = dh1 gelu'(z1), left in z1's registers (zero for invalid
// pixels) and, when dz1_out is not null, written for the valid pixels
// (rows pix[r] of [N, 64]). The dot kind is the shared memory's, S:
// TailMma for bf16 dots (every dot input rounded to bf16, m16n8k16
// products), TailTf32 for fp32 dots (three m16n8k8 TF32 products a dot,
// tf32x3.cuh).
// z2 = h1 W2 and dh1 = dz2 W2^T are products with A in registers; dW2 =
// h1^T dz2 over the tile is one with both operands staged in shared
// memory (bf16: ldmatrix.trans; fp32: [pixel][unit] rows of LDF, split as
// read), added to the warp's slice dw2 (units 16 (warp / 2).., outputs 32
// (warp % 2)..) in registers, which the caller writes once. The GELUs, the
// 64 -> 3 layer, the sigmoid, the loss and dh2 = dz3b W3^T stay on the
// CUDA cores. The block's partial sums of loss, dW3, db3 and db2 are set
// on its first tile and added to after it: bf16 stages h2b, dz3 and the
// loss for tail_w3_sums and sums db2 per warp by shuffles; fp32 keeps h2 in
// registers and sums all of them per warp by shuffles, then over the
// warps in order. Every sum runs in a fixed order. All threads call it (it
// synchronises); on return the tail's staging tiles are free.
template <int G, typename S>
__device__ __forceinline__ void ff_tail_mma(
    float (&z1)[8][4], const bool (&valid)[2], const size_t (&pix)[2],
    const S& s, const float* __restrict__ tgt, float* __restrict__ out,
    float* __restrict__ dz1_out, float* mypart, bool first, float inv_total,
    float (&dw2)[4][4]) {
  constexpr bool kTf32 = std::is_same<S, TailTf32>::value;
  constexpr int H = 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row[2] = {16 * warp + g, 16 * warp + g + 8};

  // h1 = gelu(z1) (bf16: h1b): z2's A operand, and staged for dW2; z2 =
  // h1 W2 + b2
  float z2[8][4];
  if constexpr (kTf32) {
    float h1[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h1[nt][e] = gelu_f<G>(z1[nt][e]);
        z2[nt][e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(s.sH1 + row[r] * LDF + 8 * nt + 2 * q) =
            make_float2(h1[nt][2 * r], h1[nt][2 * r + 1]);
    }
    tile_3xtf32(z2, h1, s.sW2, g, q);
  } else {
    uint32_t ah[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t lo =
          pack_bf16(gelu_f<G>(z1[nt][0]), gelu_f<G>(z1[nt][1]));
      const uint32_t hi =
          pack_bf16(gelu_f<G>(z1[nt][2]), gelu_f<G>(z1[nt][3]));
      *reinterpret_cast<uint32_t*>(s.sH1 + row[0] * LDB + 8 * nt + 2 * q) = lo;
      *reinterpret_cast<uint32_t*>(s.sH1 + row[1] * LDB + 8 * nt + 2 * q) = hi;
      ah[nt >> 1][(nt & 1) * 2] = lo;
      ah[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      z2[nt][0] = z2[nt][1] = z2[nt][2] = z2[nt][3] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const __nv_bfloat16* w = s.sW2t + (8 * nt + g) * LDB + 16 * kb + 2 * q;
        mma16816(z2[nt], ah[kb], ld_u32(w), ld_u32(w + 8));
      }
    }
  }
  // layer 3 (this thread's 16 units of its two pixels, then the quad's
  // sum); h2 (fp32) stays in registers for dW3, h2b (bf16) is staged
  float o3[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float h2[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * q + (e & 1), r = e >> 1;
      z2[nt][e] += s.sb2[j];
      const float h = cd<!kTf32>(gelu_f<G>(z2[nt][e]));
      if constexpr (kTf32)
        h2[nt][e] = h;
      else
        s.sB[j * LDP + row[r]] = __float2bfloat16_rn(h);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o3[r][c] = fmaf(h, s.sW3[j * 3 + c], o3[r][c]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o3[r][c] += __shfl_xor_sync(0xffffffffu, o3[r][c], 1);
      o3[r][c] += __shfl_xor_sync(0xffffffffu, o3[r][c], 2);
    }
  // sigmoid, loss and dz3 per pixel (the quad's threads alike)
  float dz3b[2][3], lossr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lossv = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float dz3 = 0.0f;
      if (valid[r]) {
        const float ov = 1.0f / (1.0f + expf(-(o3[r][c] + s.sb3[c])));
        if (q == 0) out[pix[r] * 3 + c] = ov;
        const float diff = ov - tgt[pix[r] * 3 + c];
        lossv = fmaf(diff, diff, lossv);
        dz3 = (2.0f * inv_total) * diff * ov * (1.0f - ov);
      }
      dz3b[r][c] = cd<!kTf32>(dz3);
      if constexpr (!kTf32)
        if (q == 0) {
          s.sD[c * LDP + row[r]] = dz3b[r][c];
          s.sD[(3 + c) * LDP + row[r]] = dz3;
        }
    }
    lossr[r] = lossv;
    if constexpr (!kTf32)
      if (q == 0) s.sD[6 * LDP + row[r]] = lossv;
  }
  // a value summed over the warp's 8 row groups (lanes of one q)
  auto rows_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    return v;
  };
  // fp32: the warp's sums of dW3 = h2^T dz3, db3 and the loss (over its
  // 16 pixels: this thread's two, then the 8 row groups)
  float* red = nullptr;
  if constexpr (kTf32) {
    red = s.sRed + warp * RED_W;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = rows_sum(fmaf(h2[nt][2 + i], dz3b[1][c],
                                        h2[nt][i] * dz3b[0][c]));
          if (g == 0) red[(8 * nt + 2 * q + i) * 3 + c] = v;
        }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = rows_sum(c < 3 ? dz3b[0][c] + dz3b[1][c]
                                     : lossr[0] + lossr[1]);
      if (lane == 0) red[4 * H + c] = v;
    }
  }
  // dz2 = (dz3b W3^T) gelu'(z2) in place of z2; db2 over the warp's pixels;
  // dz2 (bf16: dz2b, also dh1's A operand) staged for dW2
  uint32_t ad[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * q + (e & 1), r = e >> 1;
      const float dh2 = dz3b[r][0] * s.sW3[j * 3 + 0] +
                        dz3b[r][1] * s.sW3[j * 3 + 1] +
                        dz3b[r][2] * s.sW3[j * 3 + 2];
      z2[nt][e] = dh2 * gelu_d<G>(z2[nt][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float b = rows_sum(z2[nt][i] + z2[nt][2 + i]);
      if (g == 0) {
        if constexpr (kTf32)
          red[3 * H + 8 * nt + 2 * q + i] = b;
        else
          s.sDb2[warp * H + 8 * nt + 2 * q + i] = b;
      }
    }
    if constexpr (kTf32) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(s.sDZ + row[r] * LDF + 8 * nt + 2 * q) =
            make_float2(z2[nt][2 * r], z2[nt][2 * r + 1]);
    } else {
      const uint32_t lo = pack_bf16(z2[nt][0], z2[nt][1]);
      const uint32_t hi = pack_bf16(z2[nt][2], z2[nt][3]);
      *reinterpret_cast<uint32_t*>(s.sDZ + row[0] * LDB + 8 * nt + 2 * q) = lo;
      *reinterpret_cast<uint32_t*>(s.sDZ + row[1] * LDB + 8 * nt + 2 * q) = hi;
      ad[nt >> 1][(nt & 1) * 2] = lo;
      ad[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
  }
  // dh1 = dz2 W2^T, dz1 = dh1 gelu'(z1) in place of z1 (and to device
  // memory when asked)
  auto put_dz1 = [&](int nt, const float (&d)[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float d0 = valid[r] ? d[2 * r] * gelu_d<G>(z1[nt][2 * r]) : 0.0f;
      const float d1 =
          valid[r] ? d[2 * r + 1] * gelu_d<G>(z1[nt][2 * r + 1]) : 0.0f;
      z1[nt][2 * r] = d0;
      z1[nt][2 * r + 1] = d1;
      if (dz1_out != nullptr && valid[r])
        *reinterpret_cast<float2*>(dz1_out + pix[r] * H + 8 * nt + 2 * q) =
            make_float2(d0, d1);
    }
  };
  if constexpr (kTf32) {
    float d[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.0f;
    tile_3xtf32(d, z2, s.sW2t, g, q);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) put_dz1(nt, d[nt]);
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const __nv_bfloat16* w = s.sW2 + (8 * nt + g) * LDB + 16 * kb + 2 * q;
        mma16816(d, ad[kb], ld_u32(w), ld_u32(w + 8));
      }
      put_dz1(nt, d);
    }
  }
  __syncthreads();

  // the block's sums of loss, dW3, db3 and db2
  if constexpr (kTf32) {
    // each over the warps in order: row i of the warps' sums is dW3 (i <
    // 3 H, at 4 + i of the partial row), db2, db3 or the loss
    for (int i = tid; i < RED_W; i += MT) {
      float a = 0.0f;
      for (int w = 0; w < MT / 32; ++w) a += s.sRed[w * RED_W + i];
      const int at = i < 4 * H ? 4 + i : i == 4 * H + 3 ? 0 : i - 4 * H + 1;
      if (at == 0) a *= inv_total;
      mypart[at] = first ? a : mypart[at] + a;
    }
  } else {
    // loss, dW3, db3 (threads 0..67) and db2 (128..191)
    tail_w3_sums<H>(s.sB, s.sD, mypart, first, inv_total);
    if (tid >= 128 && tid < 128 + H) {
      const int j = tid - 128;
      float a = 0.0f;
      for (int w = 0; w < MT / 32; ++w) a += s.sDb2[w * H + j];
      float* dst = mypart + 4 + 3 * H + j;
      *dst = first ? a : *dst + a;
    }
  }
  // dW2 += h1^T dz2 over the tile's 128 pixels, the warp's slice
  const int mt = warp >> 1, nb = (warp & 1) * 4;
  if constexpr (kTf32) {
#pragma unroll 2
    for (int ks = 0; ks < TP / 8; ++ks) {
      const float* h = s.sH1 + (8 * ks + q) * LDF + 16 * mt + g;
      const float* z = s.sDZ + (8 * ks + q) * LDF + 8 * nb + g;
      const float a[4] = {h[0], h[8], h[4 * LDF], h[4 * LDF + 8]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        mma_3xtf32(dw2[t], ah, al, hilo2(z[8 * t], z[4 * LDF + 8 * t]));
    }
  } else {
    const int i = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < TP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4_trans(a, s.sH1 + (16 * ks + 8 * (i >> 1) + rr) * LDB + 16 * mt +
                           8 * (i & 1));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, s.sDZ + (16 * ks + 8 * (i & 1) + rr) * LDB +
                             8 * (nb + 2 * np + (i >> 1)));
        mma16816(dw2[2 * np], a, b[0], b[1]);
        mma16816(dw2[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();
}

// the thread's two pixel rows of a tile in the accumulator layout: valid,
// index (0 past npix) and noise counter base
__device__ __forceinline__ void tile_rows(int tile, int npix, int fslot,
                                          uint32_t pixel_base, bool (&valid)[2],
                                          size_t (&pix)[2],
                                          uint32_t (&ctr)[2]) {
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = tile * TP + 16 * warp + gq + 8 * r;
    valid[r] = p < npix;
    pix[r] = valid[r] ? static_cast<size_t>(p) : 0;
    ctr[r] = (static_cast<uint32_t>(p) + pixel_base) *
             static_cast<uint32_t>(fslot);
  }
}

// the block's dW2 (the warps' slices dw2 of ff_tail_mma), written once
// into its partial row
__device__ __forceinline__ void put_dw2(float* mypart, const float (&dw2)[4][4]) {
  constexpr int H = 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  float* dW2 = mypart + 4 + 4 * H;
  const int mt = warp >> 1, nb = (warp & 1) * 4;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dW2 + (16 * mt + gq + 8 * r) * H +
                                 8 * (nb + t) + 2 * q) =
          make_float2(dw2[t][2 * r], dw2[t][2 * r + 1]);
}

// Geometry of the feature noise: npix pixels, nfeat features in slots of
// fslot (counter = (pixel + pixel_base) * fslot + feature), amplitude
// eps_scale = 2^-bits (0: no noise).
struct NoiseGeo {
  int npix, nfeat, fslot;
  float eps_scale;
  uint32_t s0, s1, pixel_base;
};

// ---- eps^T dz1 (kernel3 with feature noise) -----------------------------
//
// Replaces the eps^T dz1 of the Pallas kernels nic/kernels/train_fused_ff.py
// `_kernel_ff` (:371) and train_fused_ff3.py `_kernel_ff3`, which take it
// on dz1 while it is in VMEM. Here dz1 [N, H] fp32 comes back from device
// memory once (the per-pixel body wrote it), and eps is regenerated from
// the counter hash: the eps_uniform stream the body adds to z1. Output:
// per-block partials part [nblk][nfeat][H] over the block's 128-pixel tiles
// (blockIdx.x, + gridDim.x, ...), summed afterwards in a fixed order.
//
// What bounds it (8 x 256^2, H = 64, F = 73): dz1 read once, 134 MB, 0.040
// ms at 3.35 TB/s; 2 N F H = 4.9 GFLOP, 0.005 ms on the bf16 tensor cores;
// and the hash, ~21 integer operations for each of the N F = 38 M eps.
// Design: 256 threads. Each tile of dz1 (128 pixels x H contiguous floats)
// comes into a shared-memory stage by 16-byte cp.async copies, the next
// tile's copy in flight while the block works on this one (two stages);
// the block hashes the tile's eps cooperatively into shared memory. In
// bf16-dot mode (eps and dz1 rounded to bf16, as the JAX kernel's dot
// takes them) eps^T dz1 runs as m16n8k16 tensor-core products with fp32
// accumulators: warp w owns units 8w..8w+7 of every 64 and every feature
// of the pass; its A operand (eps^T) is read by ldmatrix.trans from
// [pixel][feature] bf16 rows, its B operand (dz1) from the fp32 stage,
// rounded to bf16 as it is packed; the accumulators (PASS / 16 x H / 64
// m16n8 tiles: 20 floats a thread at H = 64, PASS = 80) stay in registers
// over the block's tiles. In fp32-dot mode a thread owns 4 units x PASS /
// (256 / (H / 4)) features on the CUDA cores (fp32 FMAs, eps as [feature]
// [pixel] fp32). The features go in passes of PASS (one pass when nfeat <=
// PASS), each pass walking the block's tiles again. Every sum runs in a
// fixed order (no atomics), so two runs are bit-identical.

constexpr int ET = 256;  // threads of an eps^T dz1 block

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory of ff_epsgrad: two dz1 stages [TP][H + 4] fp32, then eps
// (bf16 [TP][PASS + 8] for the tensor cores, fp32 [PASS][LDP] otherwise):
// 92,160 bytes at H = 64, PASS = 80 in bf16-dot mode (two blocks an SM)
template <int H, bool BF16, int PASS>
constexpr size_t epsgrad_smem() {
  return 2 * sizeof(float) * TP * (H + 4) +
         (BF16 ? sizeof(__nv_bfloat16) * TP * (PASS + 8)
               : sizeof(float) * PASS * LDP);
}

// one tile of dz1 (pixels tile * TP.., zeros past npix) into a stage, one
// 16-byte copy per thread and step, neighbouring threads on neighbouring
// addresses
template <int H>
__device__ __forceinline__ void epsgrad_fetch(float* stage,
                                              const float* __restrict__ dz1,
                                              int tile, int npix) {
  constexpr int Q = H / 4;
  for (int c = threadIdx.x; c < TP * Q; c += ET) {
    const int row = c / Q, col = c % Q;
    const int pix = tile * TP + row;
    const bool in = pix < npix;
    cp_async16(stage + row * (H + 4) + 4 * col,
               dz1 + (in ? static_cast<size_t>(pix) * H + 4 * col : 0),
               in ? 16 : 0);
  }
  cp_async_commit();
}

template <int H, bool BF16, int PASS>
__global__ void __launch_bounds__(ET, 2)
ff_epsgrad(const float* __restrict__ dz1, float* __restrict__ part,
           NoiseGeo g) {
  static_assert(H % 64 == 0 && PASS % 16 == 0, "H: 64s; PASS: 16s");
  constexpr int LDZ = H + 4;     // stage row stride (floats)
  constexpr int LDE = PASS + 8;  // bf16 eps row stride: 16-byte rows whose
                                 // 8 ldmatrix rows hit distinct banks
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [2][TP][LDZ]
  void* se = stage + 2 * TP * LDZ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * g.nfeat * H;
  const int tiles = (g.npix + TP - 1) / TP;
  const int ntb = static_cast<int>(blockIdx.x) < tiles
                      ? (tiles - 1 - static_cast<int>(blockIdx.x)) /
                                static_cast<int>(gridDim.x) + 1
                      : 0;
  // bf16: m16n8 tiles (feature tile mt, unit tile 8 warp + 64 nw); fp32:
  // features kg + KG m, units 4 jq..4 jq + 3
  constexpr int MTF = PASS / 16, NTW = H / 64;
  constexpr int JQ = H / 4, KG = ET / JQ, JPT = PASS / KG;
  static_assert(BF16 || PASS % KG == 0, "fp32 features per thread");
  const int jq = tid % JQ, kg = tid / JQ;
  for (int j0 = 0; j0 < g.nfeat; j0 += PASS) {
    const int nf = min(PASS, g.nfeat - j0);
    float acc[BF16 ? MTF * NTW : JPT][4];
#pragma unroll
    for (int m = 0; m < (BF16 ? MTF * NTW : JPT); ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
    if (ntb > 0) epsgrad_fetch<H>(stage, dz1, blockIdx.x, g.npix);
    for (int t = 0; t < ntb; ++t) {
      const int tile = blockIdx.x + t * gridDim.x;
      const float* cur = stage + (t & 1) * TP * LDZ;
      if (t + 1 < ntb)
        epsgrad_fetch<H>(stage + ((t + 1) & 1) * TP * LDZ, dz1,
                         tile + gridDim.x, g.npix);
      // the tile's eps (zero past npix and past the pass's nf features)
      if constexpr (BF16) {
        // four features a thread and step (independent hash chains),
        // stored as 8 bytes of bf16
        auto* sE = static_cast<__nv_bfloat16*>(se);  // [TP][LDE]
#pragma unroll 2
        for (int i = tid; i < TP * (PASS / 4); i += ET) {
          const int p = i / (PASS / 4), j = 4 * (i % (PASS / 4));
          const int pix = tile * TP + p;
          float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (pix < g.npix) {
            const uint32_t ctr =
                (static_cast<uint32_t>(pix) + g.pixel_base) *
                    static_cast<uint32_t>(g.fslot) +
                static_cast<uint32_t>(j0 + j);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (j + u < nf)
                e[u] = eps_uniform(ctr + static_cast<uint32_t>(u), g.s0,
                                   g.s1, g.eps_scale);
          }
          *reinterpret_cast<uint2*>(sE + p * LDE + j) =
              make_uint2(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]));
        }
      } else {
        float* sE = static_cast<float*>(se);  // [PASS][LDP]
        for (int i = tid; i < nf * TP; i += ET) {
          const int j = i / TP, p = i % TP;
          const int pix = tile * TP + p;
          sE[j * LDP + p] =
              pix < g.npix
                  ? eps_uniform((static_cast<uint32_t>(pix) + g.pixel_base) *
                                        static_cast<uint32_t>(g.fslot) +
                                    static_cast<uint32_t>(j0 + j),
                                g.s0, g.s1, g.eps_scale)
                  : 0.0f;
        }
      }
      if (t + 1 < ntb)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if constexpr (BF16) {
        const auto* sE = static_cast<const __nv_bfloat16*>(se);
        const int li = lane >> 3, rr = lane & 7;
#pragma unroll 2
        for (int ks = 0; ks < TP / 16; ++ks) {
          // B = dz1 [16 pixels][8 units] of each unit tile, from the stage
          uint32_t b[NTW][2];
#pragma unroll
          for (int nw = 0; nw < NTW; ++nw) {
            const float* z = cur + (16 * ks + 2 * q) * LDZ + 64 * nw +
                             8 * warp + gq;
            b[nw][0] = pack_bf16(z[0], z[LDZ]);
            b[nw][1] = pack_bf16(z[8 * LDZ], z[9 * LDZ]);
          }
#pragma unroll
          for (int mt = 0; mt < MTF; ++mt) {
            if (16 * mt < nf) {
              uint32_t a[4];
              ldsm_x4_trans(a, sE + (16 * ks + 8 * (li >> 1) + rr) * LDE +
                                   16 * mt + 8 * (li & 1));
#pragma unroll
              for (int nw = 0; nw < NTW; ++nw)
                mma16816(acc[mt * NTW + nw], a, b[nw][0], b[nw][1]);
            }
          }
        }
      } else {
        const float* sE = static_cast<const float*>(se);
        for (int p = 0; p < TP; p += 4) {
          float z[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v =
                *reinterpret_cast<const float4*>(cur + (p + i) * LDZ + 4 * jq);
            z[i][0] = v.x;
            z[i][1] = v.y;
            z[i][2] = v.z;
            z[i][3] = v.w;
          }
#pragma unroll
          for (int m = 0; m < JPT; ++m) {
            const int j = kg + KG * m;
            if (j < nf) {
              const float4 ev =
                  *reinterpret_cast<const float4*>(sE + j * LDP + p);
#pragma unroll
              for (int hh = 0; hh < 4; ++hh) {
                float s = acc[m][hh];
                s = fmaf(ev.x, z[0][hh], s);
                s = fmaf(ev.y, z[1][hh], s);
                s = fmaf(ev.z, z[2][hh], s);
                s = fmaf(ev.w, z[3][hh], s);
                acc[m][hh] = s;
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if constexpr (BF16) {
#pragma unroll
      for (int mt = 0; mt < MTF; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 16 * mt + gq + 8 * r;
          if (j < nf)
#pragma unroll
            for (int nw = 0; nw < NTW; ++nw)
              *reinterpret_cast<float2*>(mypart + (j0 + j) * H + 64 * nw +
                                         8 * warp + 2 * q) =
                  make_float2(acc[mt * NTW + nw][2 * r],
                              acc[mt * NTW + nw][2 * r + 1]);
        }
    } else {
#pragma unroll
      for (int m = 0; m < JPT; ++m) {
        const int j = kg + KG * m;
        if (j < nf)
          *reinterpret_cast<float4*>(mypart + (j0 + j) * H + 4 * jq) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
  }
}

template <int H, bool BF16, int PASS>
cudaError_t launch_epsgrad(const float* dz1, float* part, const NoiseGeo& g,
                           int nblk, cudaStream_t stream) {
  constexpr size_t smem = epsgrad_smem<H, BF16, PASS>();
  auto kern = ff_epsgrad<H, BF16, PASS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<nblk, ET, smem, stream>>>(dz1, part, g);
  return cudaGetLastError();
}

// ---- the node windows of dz1 (2D) ---------------------------------------
//
// Geometry: crops of n x n pixels at origins org [crops][2] on a lattice of
// period f (G0 cells) and f1 = 2f (G1 nodes); per crop a P window of rows0
// x cols0 cells and a C1 window of rows1 x cols1 nodes, gathered from as
// many C1 cells: node q takes cells q - 1 and q per axis, and cells 0 ..
// rows1 - 1 (cols1 - 1) hold every pixel and every P window cell, at any
// n and phase.
struct WinGeo {
  int crops, n, f, f1, rows0, cols0, rows1, cols1;
  float inv_f1;
};

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

__device__ __forceinline__ void fma4(float4& a, float w, const float4& x) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

// Replaces the node windows of the Pallas kernels nic/kernels/
// train_fused_ff.py `_kernel_ff` (:374-391) and train_fused.py
// `_kernel_ng` (:405), which sum dz1 into each crop's windows while it is
// in VMEM. Per crop of dz1 [crops * n * n][H] (row-major per crop): the P
// window [crops][rows0][cols0][H] of G0 cell sums, and the C1 window
// [crops][rows1][cols1][H], where each pixel adds (1-u)(1-v), (1-u)v,
// u(1-v), uv of its dz1 to its four C1 nodes (u, v the in-cell fractions
// at the absolute coordinate's phase). Window node q of a crop at origin o
// is the absolute cell o/f + q (o/f1 + q for C1).
//
// What bounds it (8 x 256^2, H = 64): dz1 read once, 134 MB, plus 11 MB of
// windows: 0.043 ms at 3.35 TB/s. Design: two passes, each sum in a fixed
// order (no atomics). node_windows: a thread owns 4 units of one C1 cell of
// one crop (the cell's f1 x f1 pixels at the crop's phase, cut at the
// crop's edges) and reads each of its pixels once, 16 bytes at a time; the
// 16 threads of a cell cover 64 units, so a warp's load is two pixels' 256
// contiguous bytes. The cell holds whole G0 cells (f1 = 2f and both
// lattices sit at absolute multiples), so the thread writes its four G0
// cell sums straight to the P window, and its four corner partials (the
// cell's pixels weighted towards each of its four C1 nodes) to corners
// [crops][rows1][cols1][4][H]. node_corners: a thread sums a C1 node's
// at most four corner partials, in a fixed order, into the C1 window.
__global__ void __launch_bounds__(256)
node_windows(const float* __restrict__ dz1, const int* __restrict__ org,
             float* __restrict__ win_p, float* __restrict__ corners,
             WinGeo g, int H) {
  const int h = blockIdx.y * 64 + 4 * threadIdx.x;
  const int per_crop = g.rows1 * g.cols1;
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  if (cell >= g.crops * per_crop) return;
  const int crop = cell / per_crop, rem = cell % per_crop;
  const int a = rem / g.cols1, b = rem % g.cols1;
  const int n = g.n, f = g.f, f1 = g.f1;
  const int phr = org[2 * crop] % f1, phc = org[2 * crop + 1] % f1;
  // the cell's first row and column in the crop (negative at a phase),
  // its pixels' ranges and the first row and column of its second G0 half
  const int r0 = a * f1 - phr, c0 = b * f1 - phc;
  const int rlo = max(r0, 0), rhi = min(r0 + f1, n);
  const int clo = max(c0, 0), chi = min(c0 + f1, n);
  const int rm = min(max(r0 + f, rlo), rhi), cm = min(max(c0 + f, clo), chi);
  const float* base = dz1 + static_cast<size_t>(crop) * n * n * H + h;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 p[2][2] = {{zero, zero}, {zero, zero}};
  float4 k[2][2] = {{zero, zero}, {zero, zero}};
  // one row of the cell: its G0 halves' sums into pl, pr; its pixels
  // weighted 1-v and v, then by 1-u and u, into the corner partials
  auto row = [&](int r, float4& pl, float4& pr) {
    const float* px = base + static_cast<size_t>(r) * n * H;
    float4 left = zero, right = zero, sa = zero, sb = zero;
#pragma unroll 4
    for (int c = clo; c < cm; ++c) {
      const float v = static_cast<float>(c - c0) * g.inv_f1;
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(px + static_cast<size_t>(c) * H));
      add4(left, x);
      fma4(sa, 1.0f - v, x);
      fma4(sb, v, x);
    }
#pragma unroll 4
    for (int c = cm; c < chi; ++c) {
      const float v = static_cast<float>(c - c0) * g.inv_f1;
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(px + static_cast<size_t>(c) * H));
      add4(right, x);
      fma4(sa, 1.0f - v, x);
      fma4(sb, v, x);
    }
    add4(pl, left);
    add4(pr, right);
    const float u = static_cast<float>(r - r0) * g.inv_f1;
    fma4(k[0][0], 1.0f - u, sa);
    fma4(k[0][1], 1.0f - u, sb);
    fma4(k[1][0], u, sa);
    fma4(k[1][1], u, sb);
  };
  for (int r = rlo; r < rm; ++r) row(r, p[0][0], p[0][1]);
  for (int r = rm; r < rhi; ++r) row(r, p[1][0], p[1][1]);
  // G0 cell (2a + hr - sr, 2b + hc - sc) of the P window: sr, sc = 1 where
  // the crop's phase starts in the second half of a C1 cell
  const int sr = phr >= f, sc = phc >= f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int qr = 2 * a + hr - sr, qc = 2 * b + hc - sc;
      if (qr >= 0 && qr < g.rows0 && qc >= 0 && qc < g.cols0)
        *reinterpret_cast<float4*>(
            win_p + ((static_cast<size_t>(crop) * g.rows0 + qr) * g.cols0 +
                     qc) * H + h) = p[hr][hc];
    }
  float* kc = corners + static_cast<size_t>(cell) * 4 * H + h;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(kc + c * H) = k[c >> 1][c & 1];
}

// C1 node (qr, qc) of a crop = corner (da, db) of cell (qr - da, qc - db)
// over (da, db) = (0, 0), (0, 1), (1, 0), (1, 1), cells before the first
// skipped
__global__ void __launch_bounds__(256)
node_corners(const float* __restrict__ corners, float* __restrict__ win_c1,
             WinGeo g, int H) {
  const int h = blockIdx.y * 64 + 4 * threadIdx.x;
  const int per_crop = g.rows1 * g.cols1;
  const int node = blockIdx.x * blockDim.y + threadIdx.y;
  if (node >= g.crops * per_crop) return;
  const int crop = node / per_crop, rem = node % per_crop;
  const int qr = rem / g.cols1, qc = rem % g.cols1;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a = qr - (c >> 1), b = qc - (c & 1);
    if (a >= 0 && b >= 0)
      add4(acc, __ldg(reinterpret_cast<const float4*>(
                    corners +
                    ((static_cast<size_t>(crop) * g.rows1 + a) * g.cols1 +
                     b) * 4 * H + c * H + h)));
  }
  *reinterpret_cast<float4*>(win_c1 + static_cast<size_t>(node) * H + h) = acc;
}

// window extents of crops of n at period f (the JAX package's nr0/nc0/
// nr1/nc1 with one row block per crop)
inline WinGeo win_geo(int crops, int n, int f) {
  WinGeo w;
  w.crops = crops;
  w.n = n;
  w.f = f;
  w.f1 = 2 * f;
  w.rows0 = (n + f - 2) / f + 1;
  w.cols0 = w.rows0;
  w.rows1 = (n + 2 * f - 2) / (2 * f) + 2;
  w.cols1 = n / (2 * f) + 2;
  w.inv_f1 = 1.0f / static_cast<float>(2 * f);
  return w;
}

// the windows of dz1 [crops * n * n][H], H a multiple of 64; corners:
// scratch of [crops][rows1][cols1][4][H] floats
cudaError_t launch_node_windows(const float* dz1, const int* org,
                                float* win_p, float* win_c1, float* corners,
                                const WinGeo& w, int H, cudaStream_t stream) {
  const dim3 blk(16, 16);
  const dim3 grid((w.crops * w.rows1 * w.cols1 + blk.y - 1) / blk.y, H / 64);
  node_windows<<<grid, blk, 0, stream>>>(dz1, org, win_p, corners, w, H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  node_corners<<<grid, blk, 0, stream>>>(corners, win_c1, w, H);
  return cudaGetLastError();
}

// 3D: crops of n^3 voxels at origins org [crops][3] (slab, a1, a2) on a
// lattice of period f (G0 cells) and f1 = 2f (G1 nodes); per crop a P
// window of r0 x r0 x r0 cells and a C1 window of r1 x c1 x c1 nodes.
struct VolGeo {
  int crops, n, f, f1, r0, r1, c1;
  float inv_f1;
};

// Replaces the node volumes of the Pallas kernels nic/kernels/
// train_fused_ff3.py `_kernel_ff3` (:237-268) and train_fused.py
// `_kernel_ng3` (:1048; dp :1075, dc1 :1099), which sum dz1 into each
// crop's windows while it is in VMEM. Per crop of dz1 [crops * n^3][H]
// (row-major per crop): the P window [crops][r0][r0][r0][H] of G0 cell
// sums at period f per axis, and the C1 window [crops][r1][c1][c1][H],
// where each voxel adds its dz1 with the trilinear weights of its eight C1
// nodes at period f1 = 2f (per axis 1-u to its floor node and u to the
// next, u the in-cell fraction at the absolute coordinate's phase). Window
// node q of a crop at origin o is the absolute cell o/f + q (o/f1 + q for
// C1).
//
// What bounds it (8 x 32^3, f = 4, H = 64): dz1 read once, 67.1 MB, plus
// 1.9 MB of windows: 0.021 ms at 3.35 TB/s. A thread per (window node,
// unit) would read each voxel about nine times and leave the C1 threads a
// serial (2 f1)^3-term loop. Design: the 2D node_windows + node_corners
// in 3D, two passes, each sum in a fixed order (no atomics).
// node_volumes: a block owns one C1 cell of one crop (the cell's f1^3
// voxels at the crop's phase, cut at the crop's edges) and reads each of
// its voxels once, 16 bytes at a time: 16 threads cover 64 units of a
// voxel, so a warp's load is two voxels' 256 contiguous bytes. The cell's
// f1 x f1 lines (s, a), each walked along b, fall in four G0 quarters
// (hs, ha); the block's 16 line slots take 4 a quarter, so a thread keeps
// only its quarter's two G0 half sums and the eight corner partials in
// registers, and it loads each line in chunks of 8 voxels at once. The
// cell holds whole G0 cells (f1 = 2f and both lattices sit at absolute
// multiples): the block sums its slots in a fixed order in shared memory
// and writes its eight G0 cell sums straight to the P window and its
// eight corner partials (the cell's voxels weighted towards each of its
// eight C1 nodes) to corners [crops][r1][c1][c1][8][H]; a cell outside
// the crop writes zeros at once. node_volume_corners: a thread sums a C1
// node's at most eight corner partials, in a fixed order, into the C1
// window. f is a power of two.
constexpr int NVT = 256;  // threads of a node_volumes block

// one axis of a C1 cell q at period f for a crop whose origin has phase
// ph = o % 2f: the cell's first voxel (negative at a phase), its voxel
// range [lo, hi) in the crop and the first voxel of its second G0 half
struct CellAxis {
  int base, lo, hi, mid;
};

__device__ __forceinline__ CellAxis cell_axis(int q, int f, int ph, int n) {
  CellAxis c;
  c.base = 2 * q * f - ph;
  c.lo = max(c.base, 0);
  c.hi = min(c.base + 2 * f, n);
  c.mid = min(max(c.base + f, c.lo), c.hi);
  return c;
}

__global__ void __launch_bounds__(NVT, 2)
node_volumes(const float* __restrict__ dz1, const int* __restrict__ org,
             float* __restrict__ win_p, float* __restrict__ corners,
             VolGeo g, int H) {
  // per warp: its quarter's 2 G0 half sums and the 8 corner partials
  __shared__ float4 red[NVT / 32][10][16];
  const int u = threadIdx.x & 15, slot = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quarter = slot >> 2, sub = slot & 3;
  const int hs = quarter >> 1, ha = quarter & 1;
  const int h = blockIdx.y * 64 + 4 * u;
  const int per_crop = g.r1 * g.c1 * g.c1;
  const int cell = blockIdx.x;
  const int crop = cell / per_crop, rem = cell % per_crop;
  const int q[3] = {rem / (g.c1 * g.c1), rem / g.c1 % g.c1, rem % g.c1};
  const int* o = org + 3 * crop;
  const int n = g.n, f = g.f, lf = __ffs(f) - 1;
  int ph[3];
  CellAxis ax[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ph[d] = o[d] & (g.f1 - 1);
    ax[d] = cell_axis(q[d], f, ph[d], n);
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // output i of thread (slot = i, u): G0 cell (i >> 2, i >> 1 & 1, i & 1),
  // at 2 q + half - sh per axis of the P window (sh = 1 where the crop's
  // phase starts in the second half of a C1 cell), or corner i - 8 in the
  // same order
  auto write = [&](int i, float4 acc) {
    if (i < 8) {
      int qp[3];
      bool in = true;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        qp[d] = 2 * q[d] + ((i >> (2 - d)) & 1) - (ph[d] >= f);
        in = in && qp[d] >= 0 && qp[d] < g.r0;
      }
      if (in)
        *reinterpret_cast<float4*>(
            win_p + (((static_cast<size_t>(crop) * g.r0 + qp[0]) * g.r0 +
                      qp[1]) * g.r0 + qp[2]) * H + h) = acc;
    } else {
      *reinterpret_cast<float4*>(
          corners + (static_cast<size_t>(cell) * 8 + (i - 8)) * H + h) = acc;
    }
  };
  if (ax[0].hi <= ax[0].lo || ax[1].hi <= ax[1].lo || ax[2].hi <= ax[2].lo) {
    write(slot, zero);
    return;
  }
  const float* base = dz1 + static_cast<size_t>(crop) * n * n * n * H + h;
  // the thread's lines m = sub, sub + 4, ... of its quarter's f x f, each
  // in chunks of 8 voxels: unit e is chunk e % chunks of line e / chunks
  const int chunks = (ax[2].hi - ax[2].lo + 7) >> 3;
  const int units = sub < f * f ? ((f * f - sub + 3) >> 2) * chunks : 0;
  float4 p0 = zero, p1 = zero, k[8], sa = zero, sb = zero;
#pragma unroll
  for (int c = 0; c < 8; ++c) k[c] = zero;
  for (int e = 0; e < units; ++e) {
    const int line = chunks == 1 ? e : e / chunks;
    const int m = sub + 4 * line;
    const int s = ax[0].base + hs * f + (m >> lf);
    const int a = ax[1].base + ha * f + (m & (f - 1));
    const int b0 = ax[2].lo + 8 * (e - line * chunks);
    if (s < ax[0].lo || s >= ax[0].hi || a < ax[1].lo || a >= ax[1].hi)
      continue;
    const float* px =
        base + ((static_cast<size_t>(s) * n + a) * n + b0) * H;
    float4 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = b0 + j < ax[2].hi
                 ? __ldg(reinterpret_cast<const float4*>(px + j * H))
                 : zero;
    // the chunk's G0 half sums, and its voxels weighted 1-v and v
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = b0 + j;
      const float v = static_cast<float>(b - ax[2].base) * g.inv_f1;
      const bool first = b < ax[2].mid;
      add4(p0, first ? x[j] : zero);
      add4(p1, first ? zero : x[j]);
      fma4(sa, 1.0f - v, x[j]);
      fma4(sb, v, x[j]);
    }
    if (e - line * chunks == chunks - 1) {  // the line's last chunk
      const float us = static_cast<float>(s - ax[0].base) * g.inv_f1;
      const float ua = static_cast<float>(a - ax[1].base) * g.inv_f1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w =
            ((c >> 1) ? us : 1.0f - us) * ((c & 1) ? ua : 1.0f - ua);
        fma4(k[2 * c], w, sa);
        fma4(k[2 * c + 1], w, sb);
      }
      sa = zero;
      sb = zero;
    }
  }
  // the warp's two slots (one quarter), then the quarter's two warps or,
  // for the corners, all eight warps in order
  auto put = [&](int i, float4 t) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, 16);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, 16);
    t.z += __shfl_xor_sync(0xffffffffu, t.z, 16);
    t.w += __shfl_xor_sync(0xffffffffu, t.w, 16);
    if (lane < 16) red[warp][i][u] = t;
  };
  put(0, p0);
  put(1, p1);
#pragma unroll
  for (int c = 0; c < 8; ++c) put(2 + c, k[c]);
  __syncthreads();
  float4 acc;
  if (slot < 8) {
    const int w0 = 2 * (slot >> 1);  // warps of G0 quarter slot >> 1
    acc = red[w0][slot & 1][u];
    add4(acc, red[w0 + 1][slot & 1][u]);
  } else {
    acc = red[0][slot - 6][u];
#pragma unroll
    for (int w = 1; w < NVT / 32; ++w) add4(acc, red[w][slot - 6][u]);
  }
  write(slot, acc);
}

// C1 node (Q0, Q1, Q2) of a crop = corner (d0, d1, d2) of cell Q - d over
// d in {0, 1}^3 in lexicographic order, cells before the first skipped
__global__ void __launch_bounds__(256)
node_volume_corners(const float* __restrict__ corners,
                    float* __restrict__ win_c1, VolGeo g, int H) {
  const int h = blockIdx.y * 64 + 4 * threadIdx.x;
  const int per_crop = g.r1 * g.c1 * g.c1;
  const int node = blockIdx.x * blockDim.y + threadIdx.y;
  if (node >= g.crops * per_crop) return;
  const int crop = node / per_crop, rem = node % per_crop;
  const int q0 = rem / (g.c1 * g.c1), q1 = rem / g.c1 % g.c1, q2 = rem % g.c1;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a0 = q0 - (c >> 2), a1 = q1 - ((c >> 1) & 1), a2 = q2 - (c & 1);
    if (a0 >= 0 && a1 >= 0 && a2 >= 0)
      add4(acc, __ldg(reinterpret_cast<const float4*>(
                    corners +
                    ((((static_cast<size_t>(crop) * g.r1 + a0) * g.c1 + a1) *
                          g.c1 + a2) * 8 + c) * H + h)));
  }
  *reinterpret_cast<float4*>(win_c1 + static_cast<size_t>(node) * H + h) = acc;
}

// window extents of crops of n^3 at period f (the JAX package's na0, and
// rows1/na1 of _accumulate_node_volumes)
inline VolGeo vol_geo(int crops, int n, int f) {
  VolGeo v;
  v.crops = crops;
  v.n = n;
  v.f = f;
  v.f1 = 2 * f;
  v.r0 = (n + f - 2) / f + 1;
  v.r1 = (n + 2 * f - 2) / (2 * f) + 2;
  v.c1 = n / (2 * f) + 2;
  v.inv_f1 = 1.0f / static_cast<float>(2 * f);
  return v;
}

// the volumes of dz1 [crops * n^3][H], H a multiple of 64, f a power of
// two; corners: scratch of [crops][r1][c1][c1][8][H] floats
cudaError_t launch_node_volumes(const float* dz1, const int* org,
                                float* win_p, float* win_c1, float* corners,
                                const VolGeo& v, int H, cudaStream_t stream) {
  if (v.f & (v.f - 1)) return cudaErrorInvalidValue;  // f: a power of two
  const int cells = v.crops * v.r1 * v.c1 * v.c1;
  node_volumes<<<dim3(cells, H / 64), NVT, 0, stream>>>(dz1, org, win_p,
                                                       corners, v, H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 blk(16, 16);
  node_volume_corners<<<dim3((cells + blk.y - 1) / blk.y, H / 64), blk, 0,
                        stream>>>(corners, win_c1, v, H);
  return cudaGetLastError();
}

// ---- the PE grads' last step (kernel3's part C, 2D and 3D) ------------
//
// out [rowlen][H] = the sum of the nblk blocks' partials part [nblk][rowlen]
// [H] (ff_pe_band's rows of 2 npe + 1, ff3_pe_band's of 3 npe + 1): a
// group of 16 threads (one 64-unit block) takes blocks g, g + 16, ... in
// order, then the 16 groups are summed in order
__global__ void __launch_bounds__(256)
ff_pe_sum(const float* __restrict__ part, float* __restrict__ out, int nblk,
          int rowlen, int H) {
  __shared__ float4 red[16][16];
  const int u = threadIdx.x & 15, grp = threadIdx.x >> 4;
  const int row = blockIdx.x, h = blockIdx.y * 64 + 4 * u;
  const float* src = part + static_cast<size_t>(row) * H + h;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int b = grp; b < nblk; b += 16)
    add4(acc, __ldg(reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(b) * rowlen * H)));
  red[grp][u] = acc;
  __syncthreads();
  if (grp == 0) {
    for (int i = 1; i < 16; ++i) add4(acc, red[i][u]);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * H + h) =
        acc;
  }
}

}  // namespace
