// Device code shared by the train kernels (train_fused_ff.cu, kernel3 in
// 2D; train_fused_ff3.cu, kernel3 in 3D; train_fused.cu, the dx and
// node-gradient kernels): bf16 rounding of dot inputs, the GELU pair and
// its derivative, the counter-hash feature noise, kernel3's per-pixel MLP
// tail (ff_tail) and eps^T dz1 kernel (ff_epsgrad), and the per-crop
// node-window (2D) and node-volume (3D) reductions of dz1.
//
// Everything here sits in an anonymous namespace: each source that
// includes it gets its own copy (the __constant__ tables included), so the
// objects link without clashing symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
#pragma unroll
    for (int j = 0; j < H; ++j) z2[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float hk = cd<BF16>(gelu_f<G>(z1[k]));
      sA[k * LDP + tid] = hk;
      const float4* wr = reinterpret_cast<const float4*>(sW2 + k * H);
#pragma unroll
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
#pragma unroll
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
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float dh2 = dz3b[0] * sW3[j * 3 + 0] + dz3b[1] * sW3[j * 3 + 1] +
                        dz3b[2] * sW3[j * 3 + 2];
      z2[j] = dh2 * gelu_d<G>(z2[j]);
    }
  } else {
#pragma unroll
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

  // block sums of dW3 = h2b^T dz3b, db3, loss
  if (tid < H) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int p = 0; p < TP; p += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(sB + tid * LDP + p);
      const float4 d0 = *reinterpret_cast<const float4*>(sD + 0 * LDP + p);
      const float4 d1 = *reinterpret_cast<const float4*>(sD + 1 * LDP + p);
      const float4 d2 = *reinterpret_cast<const float4*>(sD + 2 * LDP + p);
      a0 += hv.x * d0.x + hv.y * d0.y + hv.z * d0.z + hv.w * d0.w;
      a1 += hv.x * d1.x + hv.y * d1.y + hv.z * d1.z + hv.w * d1.w;
      a2 += hv.x * d2.x + hv.y * d2.y + hv.z * d2.z + hv.w * d2.w;
    }
    float* dst = mypart + 4 + tid * 3;
    dst[0] = first ? a0 : dst[0] + a0;
    dst[1] = first ? a1 : dst[1] + a1;
    dst[2] = first ? a2 : dst[2] + a2;
  } else if (tid < H + 4) {
    const int row = tid - H;  // 0..2: db3[c] from raw dz3; 3: loss
    const float* src = sD + (row < 3 ? 3 + row : 6) * LDP;
    float a = 0.0f;
    for (int p = 0; p < TP; p += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + p);
      a += (v.x + v.y) + (v.z + v.w);
    }
    if (row == 3) a *= inv_total;
    float* dst = mypart + (row < 3 ? 1 + row : 0);
    dst[0] = first ? a : dst[0] + a;
  }
  __syncthreads();

  // raw dz2 to sB (dW2, db2), then dh1 = dz2b W2^T and dz1 = dh1 gelu'(z1)
#pragma unroll
  for (int j = 0; j < H; ++j) {
    sB[j * LDP + tid] = z2[j];
    z2[j] = cd<BF16>(z2[j]);
  }
  if (valid) {
    float* drow = dz1 + pix * H;
#pragma unroll
    for (int k4 = 0; k4 < H / 4; ++k4) {
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * k4 + q;
        const float4* wr = reinterpret_cast<const float4*>(sW2 + k * H);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
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
#pragma unroll
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
#pragma unroll
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
#pragma unroll
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

// Geometry of the feature noise: npix pixels, nfeat features in slots of
// fslot (counter = (pixel + pixel_base) * fslot + feature), amplitude
// eps_scale = 2^-bits (0: no noise).
struct NoiseGeo {
  int npix, nfeat, fslot;
  float eps_scale;
  uint32_t s0, s1, pixel_base;
};

// eps^T dz1, per-block partials [nblk][nfeat][H], the eps stream
// regenerated from the counter hash (kernel3 with feature noise; dz1
// rounded to the dot type, as the JAX kernel's dot takes it). MAXF bounds
// nfeat.
template <int H, bool BF16, int MAXF>
__global__ void __launch_bounds__(TP, 2)
ff_epsgrad(const float* __restrict__ dz1, float* __restrict__ part,
           NoiseGeo g) {
  extern __shared__ float4 smem4[];
  float* sZ = reinterpret_cast<float*>(smem4);  // dz1b [H][LDP]
  float* sE = sZ + H * LDP;                     // eps [fslot][LDP]
  constexpr int JQ = H / 4;                     // h = jq + JQ*hh
  constexpr int KG = TP / JQ;                   // feature j = kg + KG*m
  constexpr int JPT = (MAXF + KG - 1) / KG;
  const int tid = threadIdx.x;
  const int jq = tid % JQ, kg = tid / JQ;
  float acc[JPT][4];
#pragma unroll
  for (int m = 0; m < JPT; ++m)
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) acc[m][hh] = 0.0f;
  const int tiles = (g.npix + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pix = tile * TP + tid;
    if (pix < g.npix) {
      const float* drow = dz1 + static_cast<size_t>(pix) * H;
      for (int h = 0; h < H; ++h) sZ[h * LDP + tid] = cd<BF16>(drow[h]);
      const uint32_t ctr0 = (static_cast<uint32_t>(pix) + g.pixel_base) *
                            static_cast<uint32_t>(g.fslot);
      for (int j = 0; j < g.nfeat; ++j)
        sE[j * LDP + tid] = cd<BF16>(eps_uniform(
            ctr0 + static_cast<uint32_t>(j), g.s0, g.s1, g.eps_scale));
    } else {
      for (int h = 0; h < H; ++h) sZ[h * LDP + tid] = 0.0f;
      for (int j = 0; j < g.nfeat; ++j) sE[j * LDP + tid] = 0.0f;
    }
    __syncthreads();
    for (int p = 0; p < TP; p += 4) {
      float4 zv[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
        zv[hh] = *reinterpret_cast<const float4*>(sZ + (jq + JQ * hh) * LDP + p);
#pragma unroll
      for (int m = 0; m < JPT; ++m) {
        const int j = kg + KG * m;
        if (j < g.nfeat) {
          const float4 ev = *reinterpret_cast<const float4*>(sE + j * LDP + p);
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            float a = acc[m][hh];
            a = fmaf(ev.x, zv[hh].x, a);
            a = fmaf(ev.y, zv[hh].y, a);
            a = fmaf(ev.z, zv[hh].z, a);
            a = fmaf(ev.w, zv[hh].w, a);
            acc[m][hh] = a;
          }
        }
      }
    }
    __syncthreads();
  }
  float* mypart = part + static_cast<size_t>(blockIdx.x) * g.nfeat * H;
#pragma unroll
  for (int m = 0; m < JPT; ++m) {
    const int j = kg + KG * m;
    if (j < g.nfeat)
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) mypart[j * H + jq + JQ * hh] = acc[m][hh];
  }
}

template <int H, bool BF16, int MAXF>
cudaError_t launch_epsgrad(const float* dz1, float* part, const NoiseGeo& g,
                           int nblk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (H * LDP + g.fslot * LDP);
  auto kern = ff_epsgrad<H, BF16, MAXF>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<nblk, TP, smem, stream>>>(dz1, part, g);
  return cudaGetLastError();
}

// Geometry of the node windows: crops of n x n pixels at origins org
// [crops][2] on a lattice of period f (G0 cells) and f1 = 2f (G1 nodes);
// windows of rows0 x cols0 P cells and rows1 x cols1 C1 nodes per crop.
struct WinGeo {
  int crops, n, f, f1, rows0, cols0, rows1, cols1;
  float inv_f1;
};

// Per-crop node windows of dz1 [crops * n * n][H] (row-major per crop):
// P window [crops][rows0][cols0][H] of cell sums; C1 window
// [crops][rows1][cols1][H], where each pixel adds (1-u)(1-v), (1-u)v,
// u(1-v), uv of its dz1 to its four C1 nodes (u, v the in-cell fractions
// at the absolute coordinate's phase). Window node q of a crop at origin o
// is the absolute cell o/f + q (o/f1 + q for C1). Thread = (window node,
// h); block = (H, 256/H); each thread sums its own output in a fixed
// order.
template <int H>
__global__ void node_windows(const float* __restrict__ dz1,
                             const int* __restrict__ org,
                             float* __restrict__ win_p,
                             float* __restrict__ win_c1, WinGeo g) {
  const int h = threadIdx.x;
  const int node = blockIdx.x * blockDim.y + threadIdx.y;
  const int rows0 = g.rows0, cols0 = g.cols0;
  const int rows1 = g.rows1, cols1 = g.cols1;
  const int np = g.crops * rows0 * cols0;
  const int nc = g.crops * rows1 * cols1;
  if (node >= np + nc) return;
  const int n = g.n;
  const float* base;
  float acc = 0.0f;
  if (node < np) {
    const int crop = node / (rows0 * cols0), rem = node % (rows0 * cols0);
    const int qr = rem / cols0, qc = rem % cols0;
    const int r0 = qr * g.f - org[2 * crop] % g.f;
    const int c0 = qc * g.f - org[2 * crop + 1] % g.f;
    base = dz1 + static_cast<size_t>(crop) * n * n * H + h;
    for (int r = max(r0, 0); r < min(r0 + g.f, n); ++r) {
      float s = 0.0f;
      for (int c = max(c0, 0); c < min(c0 + g.f, n); ++c)
        s += base[(static_cast<size_t>(r) * n + c) * H];
      acc += s;
    }
    win_p[static_cast<size_t>(node) * H + h] = acc;
    return;
  }
  const int nd = node - np;
  const int crop = nd / (rows1 * cols1), rem = nd % (rows1 * cols1);
  const int qr = rem / cols1, qc = rem % cols1;
  const int f1 = g.f1;
  const int ph = org[2 * crop] % f1, phc = org[2 * crop + 1] % f1;
  base = dz1 + static_cast<size_t>(crop) * n * n * H + h;
  // rows of cell qr-1 (weight u), then of cell qr (weight 1-u)
  const int rlo = max((qr - 1) * f1 - ph, 0), rhi = min((qr + 1) * f1 - ph, n);
  for (int r = rlo; r < rhi; ++r) {
    const float u = static_cast<float>((r + ph) % f1) * g.inv_f1;
    const float wr = ((r + ph) / f1 == qr) ? 1.0f - u : u;
    // this cell's columns with weight 1-v, the previous cell's with v
    float sa = 0.0f, sb = 0.0f;
    for (int c = max(qc * f1 - phc, 0); c < min((qc + 1) * f1 - phc, n); ++c) {
      const float v = static_cast<float>((c + phc) % f1) * g.inv_f1;
      sa += (1.0f - v) * base[(static_cast<size_t>(r) * n + c) * H];
    }
    for (int c = max((qc - 1) * f1 - phc, 0); c < min(qc * f1 - phc, n); ++c) {
      const float v = static_cast<float>((c + phc) % f1) * g.inv_f1;
      sb += v * base[(static_cast<size_t>(r) * n + c) * H];
    }
    acc += wr * (sa + sb);
  }
  win_c1[static_cast<size_t>(nd) * H + h] = acc;
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

template <int H>
cudaError_t launch_node_windows(const float* dz1, const int* org,
                                float* win_p, float* win_c1, const WinGeo& w,
                                cudaStream_t stream) {
  const dim3 blk(H, 256 / H);
  const int nodes = w.crops * (w.rows0 * w.cols0 + w.rows1 * w.cols1);
  node_windows<H><<<(nodes + blk.y - 1) / blk.y, blk, 0, stream>>>(
      dz1, org, win_p, win_c1, w);
  return cudaGetLastError();
}

// 3D: crops of n^3 voxels at origins org [crops][3] (slab, a1, a2) on a
// lattice of period f (G0 cells) and f1 = 2f (G1 nodes); per crop a P
// window of r0 x r0 x r0 cells and a C1 window of r1 x c1 x c1 nodes.
struct VolGeo {
  int crops, n, f, f1, r0, r1, c1;
  float inv_f1;
};

// the voxel range [lo, hi) of axis coordinate v = 0..n-1 in cell q at
// period f for a crop whose origin has phase ph = o % f
__device__ __forceinline__ void cell_range(int q, int f, int ph, int n,
                                           int& lo, int& hi) {
  lo = max(q * f - ph, 0);
  hi = min((q + 1) * f - ph, n);
}

// Per-crop node volumes of dz1 [crops * n^3][H] (row-major per crop): P
// window [crops][r0][r0][r0][H] of cell sums at period f per axis; C1
// window [crops][r1][c1][c1][H] where each voxel adds its dz1 with the
// trilinear weights of its eight C1 nodes at period f1 (per axis 1-u to
// its floor node and u to the next, u the in-cell fraction at the absolute
// coordinate's phase). Window node q of a crop at origin o is the
// absolute cell o/f + q (o/f1 + q for C1). Thread = (window node, h);
// block = (H, 256/H); each thread sums its own output in a fixed order.
template <int H>
__global__ void node_volumes(const float* __restrict__ dz1,
                             const int* __restrict__ org,
                             float* __restrict__ win_p,
                             float* __restrict__ win_c1, VolGeo g) {
  const int h = threadIdx.x;
  const int node = blockIdx.x * blockDim.y + threadIdx.y;
  const int r0 = g.r0, r1 = g.r1, c1 = g.c1;
  const int np = g.crops * r0 * r0 * r0;
  const int nc = g.crops * r1 * c1 * c1;
  if (node >= np + nc) return;
  const int n = g.n;
  float acc = 0.0f;
  if (node < np) {
    const int crop = node / (r0 * r0 * r0);
    int rem = node % (r0 * r0 * r0);
    const int qs = rem / (r0 * r0), qa = rem / r0 % r0, qb = rem % r0;
    const int* o = org + 3 * crop;
    const float* base = dz1 + static_cast<size_t>(crop) * n * n * n * H + h;
    int slo, shi, alo, ahi, blo, bhi;
    cell_range(qs, g.f, o[0] % g.f, n, slo, shi);
    cell_range(qa, g.f, o[1] % g.f, n, alo, ahi);
    cell_range(qb, g.f, o[2] % g.f, n, blo, bhi);
    for (int s = slo; s < shi; ++s)
      for (int a = alo; a < ahi; ++a) {
        float sum = 0.0f;
        for (int b = blo; b < bhi; ++b)
          sum += base[((static_cast<size_t>(s) * n + a) * n + b) * H];
        acc += sum;
      }
    win_p[static_cast<size_t>(node) * H + h] = acc;
    return;
  }
  const int nd = node - np;
  const int crop = nd / (r1 * c1 * c1);
  const int rem = nd % (r1 * c1 * c1);
  const int q[3] = {rem / (c1 * c1), rem / c1 % c1, rem % c1};
  const int* o = org + 3 * crop;
  const int f1 = g.f1;
  const float* base = dz1 + static_cast<size_t>(crop) * n * n * n * H + h;
  // per axis: the voxels of cell q-1 (weight u) and of cell q (1-u)
  int lo[3], hi[3], ph[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ph[d] = o[d] % f1;
    lo[d] = max((q[d] - 1) * f1 - ph[d], 0);
    hi[d] = min((q[d] + 1) * f1 - ph[d], n);
  }
  for (int s = lo[0]; s < hi[0]; ++s) {
    const float us = static_cast<float>((s + ph[0]) % f1) * g.inv_f1;
    const float ws = ((s + ph[0]) / f1 == q[0]) ? 1.0f - us : us;
    float sa = 0.0f;
    for (int a = lo[1]; a < hi[1]; ++a) {
      const float ua = static_cast<float>((a + ph[1]) % f1) * g.inv_f1;
      const float wa = ((a + ph[1]) / f1 == q[1]) ? 1.0f - ua : ua;
      float sb = 0.0f;
      for (int b = lo[2]; b < hi[2]; ++b) {
        const float ub = static_cast<float>((b + ph[2]) % f1) * g.inv_f1;
        const float wb = ((b + ph[2]) / f1 == q[2]) ? 1.0f - ub : ub;
        sb = fmaf(wb, base[((static_cast<size_t>(s) * n + a) * n + b) * H], sb);
      }
      sa = fmaf(wa, sb, sa);
    }
    acc = fmaf(ws, sa, acc);
  }
  win_c1[static_cast<size_t>(nd) * H + h] = acc;
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

template <int H>
cudaError_t launch_node_volumes(const float* dz1, const int* org,
                                float* win_p, float* win_c1, const VolGeo& v,
                                cudaStream_t stream) {
  const dim3 blk(H, 256 / H);
  const int nodes = v.crops * (v.r0 * v.r0 * v.r0 + v.r1 * v.c1 * v.c1);
  node_volumes<H><<<(nodes + blk.y - 1) / blk.y, blk, 0, stream>>>(
      dz1, org, win_p, win_c1, v);
  return cudaGetLastError();
}

}  // namespace
