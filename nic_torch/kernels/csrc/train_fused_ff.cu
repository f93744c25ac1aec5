// The feature-free fused train step (kernel3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nic/kernels/train_fused_ff.py `_kernel_ff`
// (launched by `_impl_ff`, pallas_call at :568). The first-layer fold
// (P = sum_k shift_k(G0) W1_k, C1 = G1 W1_g1) runs before it in PyTorch and
// the unfold after it (nic_torch/kernels/train_fused_ff.py). For pixel
// (r, c) of crop i at origin (o0, o1), absolute (y, x) = (o0 + r, o1 + c):
//
//   z1 = P[y/f, x/f] + bilinear(C1 at (y/f1, x/f1))
//        + tri(y/f1) Wpe0 + tri(x/f1) Wpe1 + bvec   (+ eps W1 with noise)
//   out = sigmoid(gelu(gelu(z1) W2 + b2) W3 + b3),  loss = mean((out-t)^2)
//
// and the full backward. One entry point, nic_train_fused_ff, runs five
// kernels back to back on the caller's stream (the MLP tail, the eps
// kernel, the counter hash and the window kernel are shared with the 3D
// kernel3, train_fused_ff3.cu, through train_common.cuh):
//
//   A ff_pixel   the per-pixel step over 128-pixel tiles, each block
//                walking a fixed set of tiles: z1 build, MLP forward, loss,
//                the backward down to dz1 (written to device memory,
//                [N, H]), and the block's partial sums of loss, dW3, db3,
//                dW2, db2. In bf16-dot mode (the flagship's) this is
//                ff_pixel_mma on the tensor cores; in fp32-dot mode
//                ff_pixel, one thread per pixel on the CUDA cores;
//   B node_windows + node_corners (train_common.cuh) the node-resolution
//                cotangents per crop window: P-cell sums of dz1 and C1
//                interpolation-weighted sums, each pixel read once (a
//                thread per C1 cell and 4 units, then a small pass that
//                sums each C1 node's four cell corners);
//   C ff_rowcol  row and column sums of dz1 per crop, then ff_pe: the PE
//                tables against them (dWpe0, dWpe1) and db1;
//   D ff_epsgrad (train_common.cuh; noise only) eps^T dz1 per block, the
//                eps stream regenerated from the counter hash; in
//                bf16-dot mode on the tensor cores (mma.sync m16n8k16).
//
// Every reduction is a fixed-order sum (no atomics): per-block partials
// are summed afterwards in a fixed order, so two runs are bit-identical.
//
// Design of ff_pixel (fp32 dots): weights live in shared memory and every
// thread of a block reads the same weight at the same time (broadcast).
// The activations the weight gradients need (gelu(z1), gelu(z2), dz2, dz3)
// are staged per tile in shared memory, transposed ([unit][pixel], row
// stride 132 floats) so each thread writes and reads its own column
// without bank conflicts and the reduction reads four pixels per 16-byte
// load: dW2 = h1^T dz2 is a 64x64x128 product per tile, each thread
// owning 32 of its outputs. TF32 would not hold fp32-dot mode's
// tolerances, so its products stay fp32 FMAs.
//
// Design of ff_pixel_mma (bf16 dots): every dot input (h1, h2, the weights,
// eps, and the cotangents dz3, dz2 on their way into a dot) is already
// rounded to bf16 as JAX's astype(bf16) does, and every sum is fp32, so
// bf16 tensor cores with fp32 accumulators (mma.sync m16n8k16) compute the
// same products; only the order of summation changes. Its four products
// are tensor-core tiles: eps W1 (A built from the counter hash in
// registers), z2 = h1 W2 and dh1 = dz2 W2^T (A in registers: a warp's
// 16-pixel accumulator tile is the next product's A operand), and dW2 =
// h1^T dz2 over the tile (both operands staged in shared memory and read
// with ldmatrix.trans, the block's slice accumulated in registers over its
// tiles). The z1 base, the GELUs, the 64 -> 3 layer, the loss and dh2 stay
// on the CUDA cores (train_common.cuh ff_tail_mma). 256 threads and
// ~109 KB of shared memory per block, two blocks per SM: 16 warps, where
// ff_pixel runs 8.
//
// What bounds it: per pixel the three 64x64 products (forward z2, backward
// dh1, the dW2 reduction) are ~12.3 kFMA, plus ~4.7 kFMA for eps W1 with
// noise and ~4.7 kFMA for eps^T dz1 in D: ~21 kFMA, i.e. ~22 GFLOP per
// flagship step (524,288 pixels): ~0.35 ms on the fp32 CUDA cores at 67
// TFLOP/s, 0.023 ms on the bf16 tensor cores at 989, against ~0.5 GB of
// device-memory traffic (dz1 written once, read by B and D once each and
// by C twice: ~0.2 ms at 3.35 TB/s). On the tensor cores the bytes, the
// GELUs and the hash bound A and D, not the products.
// Not carried over from the TPU kernel: lane packing of two row blocks
// with block-diagonal weights, the per-step parameter tiles, the per-crop
// window staging and the scratch-ref expansions; this kernel indexes the
// planes directly at the crop origin.
//
// Widths: H = 64 only (a narrower model is zero-padded to 64 by the
// wrapper, nic_torch/kernels/_widths.py); any F (W1 is read from device
// memory where it does not fit in shared memory).
//
// The entry point does not synchronise, allocates nothing, and returns
// cudaGetLastError(). The GELU pair, the bf16 rounding and the window
// kernel are shared with train_fused.cu through train_common.cuh.

#include <stdint.h>

#include "train_common.cuh"

namespace {

// tri(t / 2^octave - offset) of PE row o (nic/kernels/train_fused_ff.py
// _tri_slot_consts: the (octave 0, offset 0.5) slot and rows past the
// last full octave are zero)
__device__ __forceinline__ float tri_pe(float t, int o, int npe) {
  const int j = npe - 1 - o;
  if (j == 0 || j >= 2 * (npe / 2)) return 0.0f;
  const float inv_div = 1.0f / static_cast<float>(1 << (j / 2));
  const float off = (j % 2 == 0) ? 0.5f : 0.0f;
  const float u = t * inv_div - off;
  const float m = u - 2.0f * floorf(u * 0.5f);
  return 2.0f * fabsf(m - 1.0f) - 1.0f;
}

struct Geo {
  int crops, n, f, f1, p_rows, p_cols, c1_rows, c1_cols, npe, nfeat, fslot;
  int npix, w1_smem;  // w1_smem: W1 staged in shared memory (else read)
  float inv_f1, inv_total, eps_scale;
  uint32_t s0, s1, pixel_base;
};

// ---- A: per-pixel forward + backward, block partials of the MLP grads ---
//
// partial row layout (floats): [loss, db3[3], dW3[H][3], db2[H], dW2[H][H]].
// ff_pixel is fp32-dot mode's (one thread per pixel, CUDA cores);
// bf16-dot mode runs ff_pixel_mma below.
template <int H, int G>
__global__ void __launch_bounds__(TP, 2)
ff_pixel(const float* __restrict__ pp, const float* __restrict__ c1p,
         const float* __restrict__ w1, const float* __restrict__ bvec,
         const float* __restrict__ wpe0, const float* __restrict__ wpe1,
         const float* __restrict__ w2, const float* __restrict__ b2,
         const float* __restrict__ w3, const float* __restrict__ b3,
         const float* __restrict__ tgt, const int* __restrict__ org,
         float* __restrict__ out, float* __restrict__ dz1,
         float* __restrict__ part, Geo g) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // h1b [H][LDP]
  float* sB = sA + H * LDP;                     // h2b, then dz2 [H][LDP]
  float* sD = sB + H * LDP;                     // dz3b, dz3, loss [7][LDP]
  float* sW2 = sD + 7 * LDP;                    // [H][H] (in, out)
  float* sW3 = sW2 + H * H;                     // [H][3]
  float* sb2 = sW3 + H * 3;
  float* sbv = sb2 + H;
  float* sb3 = sbv + H;                         // [4]
  float* sPe0 = sb3 + 4;                        // [8][H]
  float* sPe1 = sPe0 + 8 * H;                   // [8][H]
  float* sW1 = sPe1 + 8 * H;                    // [nfeat][H] with noise

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += TP) sW2[i] = w2[i];
  for (int i = tid; i < H * 3; i += TP) sW3[i] = w3[i];
  for (int i = tid; i < H; i += TP) {
    sb2[i] = b2[i];
    sbv[i] = bvec[i];
  }
  if (tid < 3) sb3[tid] = b3[tid];
  for (int i = tid; i < 8 * H; i += TP) {
    const bool in = i < g.npe * H;
    sPe0[i] = in ? wpe0[i] : 0.0f;
    sPe1[i] = in ? wpe1[i] : 0.0f;
  }
  const bool noise = g.eps_scale != 0.0f;
  stage_w1<false>(sW1, w1, g.nfeat * H, noise && g.w1_smem);
  __syncthreads();

  constexpr int PART = 4 + 4 * H + H * H;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * PART;
  const int nn = g.n * g.n;
  const int tiles = (g.npix + TP - 1) / TP;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int pix = tile * TP + tid;
    const bool valid = pix < g.npix;
    float z1[H];
    if (valid) {
      const int crop = pix / nn, rem = pix % nn;
      const int y = org[2 * crop] + rem / g.n;
      const int x = org[2 * crop + 1] + rem % g.n;
      // eps W1 first (it is added last, as in the JAX kernel)
NIC_UNROLL_H(H)
      for (int h = 0; h < H; ++h) z1[h] = 0.0f;
      if (noise) {
        const uint32_t ctr0 =
            (static_cast<uint32_t>(pix) + g.pixel_base) *
            static_cast<uint32_t>(g.fslot);
        if (g.w1_smem)
          noise_rows<H, false, false>(z1, sW1, g.nfeat, ctr0, g.s0, g.s1,
                                     g.eps_scale);
        else
          noise_rows<H, false, true>(z1, w1, g.nfeat, ctr0, g.s0, g.s1,
                                    g.eps_scale);
      }
      const float ty = static_cast<float>(y) * g.inv_f1;
      const float tx = static_cast<float>(x) * g.inv_f1;
      float trow[8], tcol[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        trow[o] = o < g.npe ? tri_pe(ty, o, g.npe) : 0.0f;
        tcol[o] = o < g.npe ? tri_pe(tx, o, g.npe) : 0.0f;
      }
      const float fr = static_cast<float>(y % g.f1) * g.inv_f1;
      const float fc = static_cast<float>(x % g.f1) * g.inv_f1;
      const int r1 = y / g.f1, cc1 = x / g.f1;
      const int r1b = min(r1 + 1, g.c1_rows - 1);
      const int c1b = min(cc1 + 1, g.c1_cols - 1);
      const float* prow =
          pp + (static_cast<size_t>(y / g.f) * g.p_cols + x / g.f) * H;
      const float* q00 = c1p + (static_cast<size_t>(r1) * g.c1_cols + cc1) * H;
      const float* q01 = c1p + (static_cast<size_t>(r1) * g.c1_cols + c1b) * H;
      const float* q10 = c1p + (static_cast<size_t>(r1b) * g.c1_cols + cc1) * H;
      const float* q11 = c1p + (static_cast<size_t>(r1b) * g.c1_cols + c1b) * H;
NIC_UNROLL_H(H / 4)
      for (int h4 = 0; h4 < H / 4; ++h4) {
        const float4 pv = reinterpret_cast<const float4*>(prow)[h4];
        const float4 a0 = reinterpret_cast<const float4*>(q00)[h4];
        const float4 a1 = reinterpret_cast<const float4*>(q01)[h4];
        const float4 b0 = reinterpret_cast<const float4*>(q10)[h4];
        const float4 b1 = reinterpret_cast<const float4*>(q11)[h4];
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float v00[4] = {a0.x, a0.y, a0.z, a0.w};
        const float v01[4] = {a1.x, a1.y, a1.z, a1.w};
        const float v10[4] = {b0.x, b0.y, b0.z, b0.w};
        const float v11[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = 4 * h4 + q;
          const float ra = (1.0f - fc) * v00[q] + fc * v01[q];
          const float rb = (1.0f - fc) * v10[q] + fc * v11[q];
          const float c1t = (1.0f - fr) * ra + fr * rb;
          float peu = 0.0f, pec = 0.0f;
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            peu = fmaf(trow[o], sPe0[o * H + h], peu);
            pec = fmaf(tcol[o], sPe1[o * H + h], pec);
          }
          const float base = (((pa[q] + c1t) + peu) + pec) + sbv[h];
          z1[h] = noise ? base + z1[h] : base;
        }
      }
    }
    ff_tail<H, false, G>(z1, valid, static_cast<size_t>(pix), sW2, sW3, sb2,
                        sb3, sA, sB, sD, tgt, out, dz1, mypart, first,
                        g.inv_total);
  }
}

// ---- A in bf16-dot mode: the same step on the tensor cores ------------
//
// 256 threads (8 warps) per block, one 128-pixel tile at a time; a warp owns
// 16 pixels and each thread two of them (rows g and g + 8 of the warp, g =
// lane / 4) at 16 of the 64 units, the m16n8k16 accumulator layout of
// train_common.cuh. The thread builds those z1 entries on the CUDA cores
// (P cell, bilinear C1, triangular PE, bias), adds eps W1 from noise_mma,
// and hands z1 to ff_tail_mma. The block's slice of dW2 stays in
// registers over all its tiles and is written once at the end.
//
// Shared memory (bytes): h2b [64][132] bf16 16,896; dz3b, dz3, loss [7][132]
// 3,696; per-warp db2 [8][64] 2,048; W3, b2, bvec, b3 1,296; PE tables
// [2][8][64] 4,096; h1b and dz2b [128][72] bf16 36,864; W2^T and W2 [64][72]
// bf16 18,432: 83,328, plus with noise W1^T [64][pad16(F) + 8] bf16
// (11,264 at F = 73): 94,592 at the flagship, so two blocks (16 warps) fit
// on an SM; __launch_bounds__(256, 2) holds a thread to 128 registers.
// From F = 1153 on, W1 is read from device memory instead.
constexpr size_t kMmaFixedSmem = 83328;

size_t ff_mma_smem(int nfeat, bool w1_smem) {
  const size_t ldk = static_cast<size_t>((nfeat + 15) / 16 * 16 + 8);
  return kMmaFixedSmem + (w1_smem ? 64 * ldk * sizeof(__nv_bfloat16) : 0);
}

template <int G>
__global__ void __launch_bounds__(MT, 2)
ff_pixel_mma(const float* __restrict__ pp, const float* __restrict__ c1p,
             const float* __restrict__ w1, const float* __restrict__ bvec,
             const float* __restrict__ wpe0, const float* __restrict__ wpe1,
             const float* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ w3, const float* __restrict__ b3,
             const float* __restrict__ tgt, const int* __restrict__ org,
             float* __restrict__ out, float* __restrict__ dz1,
             float* __restrict__ part, Geo g) {
  constexpr int H = 64;
  extern __shared__ float4 smem4[];
  auto* sB = reinterpret_cast<__nv_bfloat16*>(smem4);  // h2b [H][LDP]
  float* sD = reinterpret_cast<float*>(sB + H * LDP);  // [7][LDP]
  float* sDb2 = sD + 7 * LDP;                          // [8][H]
  float* sW3 = sDb2 + 8 * H;                           // [H][3]
  float* sb2 = sW3 + 3 * H;
  float* sbv = sb2 + H;
  float* sb3 = sbv + H;                         // [4]
  float* sPe0 = sb3 + 4;                        // [8][H]
  float* sPe1 = sPe0 + 8 * H;                   // [8][H]
  auto* sH1 = reinterpret_cast<__nv_bfloat16*>(sPe1 + 8 * H);  // [TP][LDB]
  __nv_bfloat16* sDZ = sH1 + TP * LDB;          // [TP][LDB]
  __nv_bfloat16* sW2t = sDZ + TP * LDB;         // [H][LDB] (out, in)
  __nv_bfloat16* sW2 = sW2t + H * LDB;          // [H][LDB] (in, out)
  __nv_bfloat16* sW1t = sW2 + H * LDB;          // [H][ldk] with noise
  const int ldk = (g.nfeat + 15) / 16 * 16 + 8;

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += MT) {
    const int k = i / H, j = i % H;
    const __nv_bfloat16 w = __float2bfloat16_rn(w2[i]);
    sW2[k * LDB + j] = w;
    sW2t[j * LDB + k] = w;
  }
  for (int i = tid; i < H * 3; i += MT) sW3[i] = bf16_round(w3[i]);
  for (int i = tid; i < H; i += MT) {
    sb2[i] = b2[i];
    sbv[i] = bvec[i];
  }
  if (tid < 3) sb3[tid] = b3[tid];
  for (int i = tid; i < 8 * H; i += MT) {
    const bool in = i < g.npe * H;
    sPe0[i] = in ? wpe0[i] : 0.0f;
    sPe1[i] = in ? wpe1[i] : 0.0f;
  }
  const bool noise = g.eps_scale != 0.0f;
  if (noise && g.w1_smem)
    for (int i = tid; i < H * ldk; i += MT) {
      const int h = i / ldk, k = i % ldk;
      sW1t[i] = __float2bfloat16_rn(k < g.nfeat ? w1[k * H + h] : 0.0f);
    }
  __syncthreads();

  const TailMma ts{sB, sD, sDb2, sH1, sDZ, sW2t, sW2, sW3, sb2, sb3};
  constexpr int PART = 4 + 4 * H + H * H;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * PART;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int nn = g.n * g.n;
  const int tiles = (g.npix + TP - 1) / TP;
  float dw2[4][4] = {};
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    bool valid[2];
    size_t pix[2];
    uint32_t ctr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = tile * TP + 16 * warp + gq + 8 * r;
      valid[r] = p < g.npix;
      pix[r] = valid[r] ? static_cast<size_t>(p) : 0;
      ctr[r] = (static_cast<uint32_t>(p) + g.pixel_base) *
               static_cast<uint32_t>(g.fslot);
    }
    // eps W1 first (it is added last, as in the JAX kernel)
    float z1[8][4] = {};
    if (noise) {
      if (g.w1_smem)
        noise_mma<false>(z1, sW1t, ldk, w1, g.nfeat, ctr, valid, g.s0, g.s1,
                         g.eps_scale);
      else
        noise_mma<true>(z1, sW1t, ldk, w1, g.nfeat, ctr, valid, g.s0, g.s1,
                        g.eps_scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      const int crop = static_cast<int>(pix[r]) / nn;
      const int rem = static_cast<int>(pix[r]) % nn;
      const int y = org[2 * crop] + rem / g.n;
      const int x = org[2 * crop + 1] + rem % g.n;
      const float ty = static_cast<float>(y) * g.inv_f1;
      const float tx = static_cast<float>(x) * g.inv_f1;
      float trow[8], tcol[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        trow[o] = o < g.npe ? tri_pe(ty, o, g.npe) : 0.0f;
        tcol[o] = o < g.npe ? tri_pe(tx, o, g.npe) : 0.0f;
      }
      const float fr = static_cast<float>(y % g.f1) * g.inv_f1;
      const float fc = static_cast<float>(x % g.f1) * g.inv_f1;
      const int r1 = y / g.f1, cc1 = x / g.f1;
      const int r1b = min(r1 + 1, g.c1_rows - 1);
      const int c1b = min(cc1 + 1, g.c1_cols - 1);
      const float* prow =
          pp + (static_cast<size_t>(y / g.f) * g.p_cols + x / g.f) * H;
      const float* q00 = c1p + (static_cast<size_t>(r1) * g.c1_cols + cc1) * H;
      const float* q01 = c1p + (static_cast<size_t>(r1) * g.c1_cols + c1b) * H;
      const float* q10 = c1p + (static_cast<size_t>(r1b) * g.c1_cols + cc1) * H;
      const float* q11 = c1p + (static_cast<size_t>(r1b) * g.c1_cols + c1b) * H;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int h0 = 8 * nt + 2 * q;
        const float2 pv = *reinterpret_cast<const float2*>(prow + h0);
        const float2 a0 = *reinterpret_cast<const float2*>(q00 + h0);
        const float2 a1 = *reinterpret_cast<const float2*>(q01 + h0);
        const float2 b0 = *reinterpret_cast<const float2*>(q10 + h0);
        const float2 b1 = *reinterpret_cast<const float2*>(q11 + h0);
        const float pa[2] = {pv.x, pv.y}, v00[2] = {a0.x, a0.y};
        const float v01[2] = {a1.x, a1.y}, v10[2] = {b0.x, b0.y};
        const float v11[2] = {b1.x, b1.y};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int h = h0 + i;
          const float ra = (1.0f - fc) * v00[i] + fc * v01[i];
          const float rb = (1.0f - fc) * v10[i] + fc * v11[i];
          const float c1t = (1.0f - fr) * ra + fr * rb;
          float peu = 0.0f, pec = 0.0f;
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            peu = fmaf(trow[o], sPe0[o * H + h], peu);
            pec = fmaf(tcol[o], sPe1[o * H + h], pec);
          }
          const float base = (((pa[i] + c1t) + peu) + pec) + sbv[h];
          float& z = z1[nt][2 * r + i];
          z = noise ? base + z : base;
        }
      }
    }
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out, dz1, mypart, first,
                   g.inv_total, dw2);
  }
  // the block's dW2, written once
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

// ---- C: row and column sums of dz1, then the PE grads and db1 ----------
template <int H>
__global__ void ff_rowcol(const float* __restrict__ dz1,
                          float* __restrict__ sums, Geo g) {
  const int h = threadIdx.x;
  const int idx = blockIdx.x * blockDim.y + threadIdx.y;  // (crop, line)
  const int n = g.n;
  if (idx >= g.crops * n) return;
  const int crop = idx / n, line = idx % n;
  const float* base = dz1 + static_cast<size_t>(crop) * n * n * H + h;
  float sr = 0.0f, sc = 0.0f;
  for (int k = 0; k < n; ++k) {
    sr += base[(static_cast<size_t>(line) * n + k) * H];  // row `line`
    sc += base[(static_cast<size_t>(k) * n + line) * H];  // column `line`
  }
  sums[static_cast<size_t>(idx) * H + h] = sr;
  sums[(static_cast<size_t>(g.crops) * n + idx) * H + h] = sc;
}

// rows 0..npe-1: dWpe0, npe..2npe-1: dWpe1, 2npe: db1
template <int H>
__global__ void ff_pe(const float* __restrict__ sums,
                      const int* __restrict__ org, float* __restrict__ pe,
                      Geo g) {
  const int h = threadIdx.x;
  const int row = blockIdx.x;
  const int n = g.n;
  const bool col = row >= g.npe && row < 2 * g.npe;
  const float* s = sums + (col ? static_cast<size_t>(g.crops) * n * H : 0) + h;
  float acc = 0.0f;
  for (int crop = 0; crop < g.crops; ++crop) {
    const int o = org[2 * crop + (col ? 1 : 0)];
    for (int k = 0; k < n; ++k) {
      const float v = s[(static_cast<size_t>(crop) * n + k) * H];
      if (row == 2 * g.npe) {
        acc += v;
      } else {
        const float t = static_cast<float>(o + k) * g.inv_f1;
        acc = fmaf(tri_pe(t, col ? row - g.npe : row, g.npe), v, acc);
      }
    }
  }
  pe[row * H + h] = acc;
}

struct Args {
  const float *pp, *c1p, *w1, *bvec, *wpe0, *wpe1, *w2, *b2, *w3, *b3, *tgt;
  const int* org;
  float *out, *dz1, *part_mlp, *win_p, *win_c1, *corners, *sums, *pe,
      *part_eps;
  int nblk_mlp, nblk_eps;
  WinGeo win;
  Geo g;
  cudaStream_t stream;
};

// shared memory of ff_pixel: the staging tiles, W2, W3, b2, bvec, b3, the
// PE tables and, with noise when it fits, W1 (93,056 bytes at H = 64; W1
// adds 256 F bytes and stays in device memory from F = 545 on)
template <int H>
size_t ff_smem(int nfeat, bool w1_smem) {
  return sizeof(float) * (2 * H * LDP + 7 * LDP + H * H + 3 * H + 2 * H + 4 +
                          16 * H +
                          (w1_smem ? static_cast<size_t>(nfeat) * H : 0));
}

// bf16-dot mode runs the tensor-core kernel, fp32-dot mode ff_pixel
template <int H, bool BF16, int G>
cudaError_t launch_pixel(const Args& a) {
  if constexpr (BF16) {
    const size_t smem = ff_mma_smem(a.g.nfeat, a.g.w1_smem);
    auto kern = ff_pixel_mma<G>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<a.nblk_mlp, MT, smem, a.stream>>>(
        a.pp, a.c1p, a.w1, a.bvec, a.wpe0, a.wpe1, a.w2, a.b2, a.w3, a.b3,
        a.tgt, a.org, a.out, a.dz1, a.part_mlp, a.g);
    e = cudaGetLastError();
    if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
    return e;
  } else {
    const size_t smem = ff_smem<H>(a.g.nfeat, a.g.w1_smem);
    auto kern = ff_pixel<H, G>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<a.nblk_mlp, TP, smem, a.stream>>>(
        a.pp, a.c1p, a.w1, a.bvec, a.wpe0, a.wpe1, a.w2, a.b2, a.w3, a.b3,
        a.tgt, a.org, a.out, a.dz1, a.part_mlp, a.g);
    e = cudaGetLastError();
    if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
    return e;
  }
}

template <int H, bool BF16>
cudaError_t launch_rest(const Args& a) {
  const dim3 blk(H, 256 / H);
  cudaError_t e = launch_node_windows(a.dz1, a.org, a.win_p, a.win_c1,
                                      a.corners, a.win, H, a.stream);
  if (e != cudaSuccess) return e;
  const int lines = a.g.crops * a.g.n;
  ff_rowcol<H><<<(lines + blk.y - 1) / blk.y, blk, 0, a.stream>>>(
      a.dz1, a.sums, a.g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ff_pe<H><<<2 * a.g.npe + 1, H, 0, a.stream>>>(a.sums, a.org, a.pe, a.g);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nblk_eps == 0) return e;
  NoiseGeo ng;
  ng.npix = a.g.npix;
  ng.nfeat = a.g.nfeat;
  ng.fslot = a.g.fslot;
  ng.eps_scale = a.g.eps_scale;
  ng.s0 = a.g.s0;
  ng.s1 = a.g.s1;
  ng.pixel_base = a.g.pixel_base;
  return launch_epsgrad<H, BF16, 80>(a.dz1, a.part_eps, ng, a.nblk_eps,
                                     a.stream);
}

template <int H, bool BF16, int G>
cudaError_t launch_all(const Args& a) {
  const cudaError_t e = launch_pixel<H, BF16, G>(a);
  if (e != cudaSuccess) return e;
  return launch_rest<H, BF16>(a);
}

template <int H, bool BF16>
cudaError_t dispatch_gelu(int gelu_id, const Args& a) {
  switch (gelu_id) {
    case kErf: return launch_all<H, BF16, kErf>(a);
    case kPoly: return launch_all<H, BF16, kPoly>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nic_train_fused_ff(
    const void* p_plane, const void* c1_plane, const void* w1,
    const void* bvec, const void* wpe0, const void* wpe1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* tgt,
    const void* origins, void* out, void* dz1, void* part_mlp, void* win_p,
    void* win_c1, void* win_corners, void* sums, void* pe_grads,
    void* part_eps, int crops,
    int n, int f, int p_rows, int p_cols, int c1_rows, int c1_cols,
    int hidden, int npe, int nfeat, int fslot, int bf16, int gelu_id,
    int mma, int nbits, int s0, int s1, int pixel_base, int nblk_mlp,
    int nblk_eps, void* stream) {
  // the caller names the body: ff_pixel_mma takes bf16 dots, ff_pixel fp32
  if (crops <= 0 || n <= 0 || f <= 0 || npe < 0 || npe > 8 || nfeat <= 0 ||
      fslot < nfeat || nblk_mlp <= 0 || (nbits > 0) != (nblk_eps > 0) ||
      (mma != 0) != (bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g;
  g.crops = crops;
  g.n = n;
  g.f = f;
  g.f1 = 2 * f;
  g.p_rows = p_rows;
  g.p_cols = p_cols;
  g.c1_rows = c1_rows;
  g.c1_cols = c1_cols;
  g.npe = npe;
  g.nfeat = nfeat;
  g.fslot = fslot;
  g.npix = crops * n * n;
  g.inv_f1 = 1.0f / static_cast<float>(2 * f);
  g.inv_total = 1.0f / (static_cast<float>(g.npix) * 3.0f);
  g.eps_scale = nbits > 0 ? ldexpf(1.0f, -nbits) : 0.0f;
  g.s0 = static_cast<uint32_t>(s0);
  g.s1 = static_cast<uint32_t>(s1);
  g.pixel_base = static_cast<uint32_t>(pixel_base);
  g.w1_smem = nbits > 0 && (bf16 ? ff_mma_smem(nfeat, true)
                                  : ff_smem<64>(nfeat, true)) <= kMaxSmem;
  Args a;
  a.pp = static_cast<const float*>(p_plane);
  a.c1p = static_cast<const float*>(c1_plane);
  a.w1 = static_cast<const float*>(w1);
  a.bvec = static_cast<const float*>(bvec);
  a.wpe0 = static_cast<const float*>(wpe0);
  a.wpe1 = static_cast<const float*>(wpe1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const float*>(w3);
  a.b3 = static_cast<const float*>(b3);
  a.tgt = static_cast<const float*>(tgt);
  a.org = static_cast<const int*>(origins);
  a.out = static_cast<float*>(out);
  a.dz1 = static_cast<float*>(dz1);
  a.part_mlp = static_cast<float*>(part_mlp);
  a.win_p = static_cast<float*>(win_p);
  a.win_c1 = static_cast<float*>(win_c1);
  a.corners = static_cast<float*>(win_corners);
  a.sums = static_cast<float*>(sums);
  a.pe = static_cast<float*>(pe_grads);
  a.part_eps = static_cast<float*>(part_eps);
  a.nblk_mlp = nblk_mlp;
  a.nblk_eps = nblk_eps;
  a.win = win_geo(crops, n, f);
  a.g = g;
  a.stream = static_cast<cudaStream_t>(stream);
  if (hidden != 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = bf16 ? dispatch_gelu<64, true>(gelu_id, a)
                             : dispatch_gelu<64, false>(gelu_id, a);
  return static_cast<int>(e);
}

// eps^T dz1 alone (D as K11 and K12 launch it): per-block partials part
// [nblk][nfeat][H] of dz1 [npix][hidden] against the counter-hash eps of
// nfeat features in slots of fslot (2^-nbits, stream words s0, s1, pixel
// base), the features in passes of feat_pass: K11's (H = 64, 80) or K12's
// (64, 128; 128, 64).
extern "C" int nic_eps_grad(const void* dz1, void* part, int npix, int nfeat,
                            int fslot, int hidden, int feat_pass, int bf16,
                            int nbits, int s0, int s1, int pixel_base,
                            int nblk, void* stream) {
  if (npix <= 0 || nfeat <= 0 || fslot < nfeat || nbits <= 0 || nblk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NoiseGeo g;
  g.npix = npix;
  g.nfeat = nfeat;
  g.fslot = fslot;
  g.eps_scale = ldexpf(1.0f, -nbits);
  g.s0 = static_cast<uint32_t>(s0);
  g.s1 = static_cast<uint32_t>(s1);
  g.pixel_base = static_cast<uint32_t>(pixel_base);
  const auto* d = static_cast<const float*>(dz1);
  auto* pt = static_cast<float*>(part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (hidden == 64 && feat_pass == 80)
    e = bf16 ? launch_epsgrad<64, true, 80>(d, pt, g, nblk, st)
             : launch_epsgrad<64, false, 80>(d, pt, g, nblk, st);
  else if (hidden == 64 && feat_pass == 128)
    e = bf16 ? launch_epsgrad<64, true, 128>(d, pt, g, nblk, st)
             : launch_epsgrad<64, false, 128>(d, pt, g, nblk, st);
  else if (hidden == 128 && feat_pass == 64)
    e = bf16 ? launch_epsgrad<128, true, 64>(d, pt, g, nblk, st)
             : launch_epsgrad<128, false, 64>(d, pt, g, nblk, st);
  return static_cast<int>(e);
}
