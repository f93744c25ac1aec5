// Device code shared by the train kernels (train_fused_ff.cu, kernel3;
// train_fused.cu, the dx and node-gradient kernels): bf16 rounding of dot
// inputs, the GELU pair and its derivative, and the per-crop node-window
// reduction of dz1.
//
// Everything here sits in an anonymous namespace: each source that
// includes it gets its own copy (the __constant__ tables included), so the
// objects link without clashing symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace
