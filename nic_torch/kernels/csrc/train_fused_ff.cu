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
// and the full backward. One entry point, nic_train_fused_ff, runs six
// kernels back to back on the caller's stream (the MLP tail, the eps
// kernel and the counter hash are shared with the 3D kernel3,
// train_fused_ff3.cu, and the window kernels with kernel2, train_fused.cu,
// through train_common.cuh):
//
//   A ff_pixel_mma / ff_pixel_tf32  the per-pixel step over 128-pixel
//                tiles on the tensor cores, each block walking a fixed set
//                of tiles: z1 build, MLP forward, loss, the backward down
//                to dz1 (written to device memory, [N, H]), and the
//                block's partial sums of loss, dW3, db3, dW2, db2.
//                ff_pixel_mma takes bf16 dots (the flagship's mode),
//                ff_pixel_tf32 fp32 dots as three TF32 products each;
//   B node_windows + node_corners (train_common.cuh) the node-resolution
//                cotangents per crop window: P-cell sums of dz1 and C1
//                interpolation-weighted sums, each pixel read once (a
//                thread per C1 cell and 4 units, then a small pass that
//                sums each C1 node's four cell corners);
//   C ff_pe_band (below) + ff_pe_sum the PE grads (the PE tables
//                against each crop's row and column sums of dz1: dWpe0,
//                dWpe1) and db1, each pixel read once (a block per crop
//                and band of rows writes partials, then a small pass sums
//                them in a fixed order);
//   D ff_epsgrad (train_common.cuh; noise only) eps^T dz1 per block, the
//                eps stream regenerated from the counter hash; in
//                bf16-dot mode on the tensor cores (mma.sync m16n8k16).
//
// Every reduction is a fixed-order sum (no atomics): per-block partials
// are summed afterwards in a fixed order, so two runs are bit-identical.
//
// Design of the two bodies. They share their layout, their z1 build and
// their tail (train_common.cuh ff_tail_mma, templated on the dot kind):
// 256 threads, a warp owning 16 pixels of the tile in the mma accumulator
// layout, and four products as tensor-core tiles: eps W1 (A built from the
// counter hash in registers), z2 = h1 W2 and dh1 = dz2 W2^T (A in
// registers: a warp's 16-pixel accumulator tile is the next product's A
// operand), and dW2 = h1^T dz2 over the tile (both operands staged in
// shared memory, the block's slice accumulated in registers over its
// tiles). The z1 base, the GELUs, the 64 -> 3 layer, the loss and dh2 stay
// on the CUDA cores in fp32.
//   ff_pixel_mma (bf16 dots): every dot input (h1, h2, the weights, eps,
// and the cotangents dz3, dz2 on their way into a dot) is already rounded
// to bf16 as JAX's astype(bf16) does, and every sum is fp32, so bf16
// m16n8k16 products with fp32 accumulators compute the same products; only
// the order of summation changes. dW2's operands are staged as bf16 and
// read with ldmatrix.trans. ~109 KB of shared memory, two blocks per SM.
//   ff_pixel_tf32 (fp32 dots): one TF32 product (10 mantissa bits) would
// not hold fp32-dot mode's tolerances, three do (tf32x3.cuh: each operand
// split into TF32 hi and lo parts, al bh + ah bl + ah bh in m16n8k8
// products, fp32 accumulators; the dropped al bl is ~2^-22 of a product),
// as K1-K5 take their fp32 dots. The A operands are split in registers
// (eps unrounded from the hash, h1 and dz2 from the accumulators), W2, W2^T
// and W1 are staged once per block as hi/lo float4 B tiles, and dW2's
// operands as fp32 [pixel][unit] rows of 72 floats (ldmatrix has no 32-bit
// transpose; that stride keeps the fragment loads free of bank conflicts),
// split as read. The fp32 tiles take ~206 KB at the flagship: one block
// of 8 warps per SM, 255 registers a thread, h2 kept in registers and the
// dW3, db3, db2 and loss sums taken per warp by shuffles.
//
// What bounds it: per pixel the three 64x64 products (forward z2, backward
// dh1, the dW2 reduction) are ~12.3 kFMA, plus ~4.7 kFMA for eps W1 with
// noise and ~4.7 kFMA for eps^T dz1 in D: ~21 kFMA, i.e. ~22 GFLOP per
// flagship step (524,288 pixels): ~0.35 ms on the fp32 CUDA cores at 67
// TFLOP/s, 0.023 ms on the bf16 tensor cores at 989 and, as three TF32
// products, 0.13 ms at 495 / 3, against ~0.5 GB of device-memory traffic
// (dz1 written once, read by B, C and D once each: ~0.16 ms at 3.35 TB/s).
// In bf16 the bytes, the GELUs and the hash bound A and D, not the
// products; in 3xTF32 the products' issue and the GELUs share A.
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
// Two bodies, one per dot kind, on the tensor cores: ff_pixel_mma (bf16
// dots) and ff_pixel_tf32 (fp32 dots as three TF32 products). 256 threads
// (8 warps) per block, one 128-pixel tile at a time; a warp owns 16 pixels
// and each thread two of them (rows g and g + 8 of the warp, g = lane / 4)
// at 16 of the 64 units, the accumulator layout of train_common.cuh. The
// thread builds those z1 entries on the CUDA cores (add_z1_base: P cell,
// bilinear C1, triangular PE, bias), adds eps W1 from noise_mma /
// noise_tf32 first, and hands z1 to ff_tail_mma. The block's slice of dW2
// stays in registers over all its tiles and is written once at the end.

// z1 of the thread's pixel row r (pixel p) += its base, in the accumulator
// layout, after eps W1 (which the JAX kernel adds last)
__device__ __forceinline__ void add_z1_base(
    float (&z1)[8][4], int r, int p, bool noise, const float* __restrict__ pp,
    const float* __restrict__ c1p, const int* __restrict__ org,
    const float* sPe0, const float* sPe1, const float* sbv, const Geo& g) {
  constexpr int H = 64;
  const int q = threadIdx.x & 3;
  const int nn = g.n * g.n;
  const int crop = p / nn, rem = p % nn;
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

// Shared memory of ff_pixel_mma (bytes): h2b [64][132] bf16 16,896; dz3b,
// dz3, loss [7][132] 3,696; per-warp db2 [8][64] 2,048; W3, b2, bvec, b3
// 1,296; PE tables [2][8][64] 4,096; h1b and dz2b [128][72] bf16 36,864;
// W2^T and W2 [64][72] bf16 18,432: 83,328, plus with noise W1^T
// [64][pad16(F) + 8] bf16 (11,264 at F = 73): 94,592 at the flagship, so
// two blocks (16 warps) fit on an SM; __launch_bounds__(256, 2) holds a
// thread to 128 registers. From F = 1153 on, W1 is read from device memory
// instead.
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
  const int tiles = (g.npix + TP - 1) / TP;
  float dw2[4][4] = {};
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    bool valid[2];
    size_t pix[2];
    uint32_t ctr[2];
    tile_rows(tile, g.npix, g.fslot, g.pixel_base, valid, pix, ctr);
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
    for (int r = 0; r < 2; ++r)
      if (valid[r])
        add_z1_base(z1, r, static_cast<int>(pix[r]), noise, pp, c1p, org,
                    sPe0, sPe1, sbv, g);
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out, dz1, mypart, first,
                   g.inv_total, dw2);
  }
  put_dw2(mypart, dw2);
}

// Shared memory of ff_pixel_tf32 (bytes): W2 and W2^T as TF32 hi/lo B
// tiles [64][36] float4 36,864 each; h1 and dz2 [128][72] fp32 36,864 each;
// the warps' sums [8][260] 8,320; W3, b2, bvec, b3 1,296; PE tables
// [2][8][64] 4,096: 161,168, plus with noise W1 as TF32 hi/lo B tiles
// [64][pad16(F) / 2 + 4] float4 (45,056 at F = 73): 206,224 at the
// flagship, so one block (8 warps) an SM; __launch_bounds__(256, 1) leaves
// a thread 255 registers. From F = 129 on, W1 is read from device memory
// and split as it is read.
constexpr size_t kTf32FixedSmem = 161168;

size_t ff_tf32_smem(int nfeat, bool w1_smem) {
  const size_t ldw = static_cast<size_t>(pad16(nfeat) / 2 + 4);
  return kTf32FixedSmem + (w1_smem ? 64 * ldw * sizeof(float4) : 0);
}

template <int G>
__global__ void __launch_bounds__(MT, 1)
ff_pixel_tf32(const float* __restrict__ pp, const float* __restrict__ c1p,
              const float* __restrict__ w1, const float* __restrict__ bvec,
              const float* __restrict__ wpe0, const float* __restrict__ wpe1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              const float* __restrict__ tgt, const int* __restrict__ org,
              float* __restrict__ out, float* __restrict__ dz1,
              float* __restrict__ part, Geo g) {
  constexpr int H = 64;
  extern __shared__ float4 smem4[];
  float4* sW2 = smem4;                                    // [H][36]
  float4* sW2t = sW2 + H * 36;                            // [H][36]
  float* sH1 = reinterpret_cast<float*>(sW2t + H * 36);   // [TP][LDF]
  float* sDZ = sH1 + TP * LDF;                            // [TP][LDF]
  float* sRed = sDZ + TP * LDF;                           // [8][RED_W]
  float* sW3 = sRed + (MT / 32) * RED_W;                  // [H][3]
  float* sb2 = sW3 + 3 * H;
  float* sbv = sb2 + H;
  float* sb3 = sbv + H;                                   // [4]
  float* sPe0 = sb3 + 4;                                  // [8][H]
  float* sPe1 = sPe0 + 8 * H;                             // [8][H]
  float4* sW1 = reinterpret_cast<float4*>(sPe1 + 8 * H);  // [H][ldw] noise
  const int ldw = pad16(g.nfeat) / 2 + 4;

  const int tid = threadIdx.x;
  stage_b_pairs(sW2, w2, H, 1, H, H);   // (k, n) = W2[k][n]
  stage_b_pairs(sW2t, w2, 1, H, H, H);  // (k, n) = W2[n][k]
  for (int i = tid; i < H * 3; i += MT) sW3[i] = w3[i];
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
    stage_b_pairs(sW1, w1, H, 1, pad16(g.nfeat), g.nfeat);
  __syncthreads();

  const TailTf32 ts{sH1, sDZ, sRed, sW2, sW2t, sW3, sb2, sb3};
  constexpr int PART = 4 + 4 * H + H * H;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * PART;
  const int tiles = (g.npix + TP - 1) / TP;
  float dw2[4][4] = {};
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    bool valid[2];
    size_t pix[2];
    uint32_t ctr[2];
    tile_rows(tile, g.npix, g.fslot, g.pixel_base, valid, pix, ctr);
    // eps W1 first (it is added last, as in the JAX kernel)
    float z1[8][4] = {};
    if (noise) {
      if (g.w1_smem)
        noise_tf32<false>(z1, sW1, ldw, w1, g.nfeat, ctr, valid, g.s0, g.s1,
                          g.eps_scale);
      else
        noise_tf32<true>(z1, sW1, ldw, w1, g.nfeat, ctr, valid, g.s0, g.s1,
                         g.eps_scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (valid[r])
        add_z1_base(z1, r, static_cast<int>(pix[r]), noise, pp, c1p, org,
                    sPe0, sPe1, sbv, g);
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out, dz1, mypart, first,
                   g.inv_total, dw2);
  }
  put_dw2(mypart, dw2);
}

// ---- C: the PE grads and db1 in one pass over dz1 ----------------------
//
// Replaces the row/column sums and their table contractions of the Pallas
// kernel `_kernel_ff` (nic/kernels/train_fused_ff.py:360-365): dWpe0[o] =
// sum over crops and rows r of tri(o, (org0 + r) / f1) rowsum[crop, r],
// dWpe1 the same over the column sums at org1, db1 = sum of dz1.
//
// What bounds it (8 x 256^2, H = 64): dz1 read once, 134 MB: 0.040 ms at
// 3.35 TB/s; the contractions are ~0. Row sums and column sums each taken
// in a pass of their own would read dz1 twice (the columns at an n H
// stride), and a contraction over all crops' lines is one long serial
// chain. Design: two launches, every sum in a fixed order (no atomics).
// ff_pe_band: a block owns one crop and a band of PE_ROWS rows and reads
// each of its pixels once, 16 bytes at a time: 16 threads cover 64 units
// of a pixel and the block's 16 column slots split the row, so a warp's
// load is two pixels' 256 contiguous bytes, and a thread walks its
// columns down the band, PE_ROWS independent loads at a time. A thread
// keeps its columns' share of each band row and contracts each of its
// band columns (the crop's origin gives the column's absolute coordinate)
// with the column tri values at once; the block then finishes each row's
// sum in shared memory in a fixed order, multiplies it by its row tri
// values, and writes its partials of dWpe0, dWpe1 and db1 (no row or
// column sums go to device memory). 256 blocks at the flagship, two an
// SM. ff_pe_sum (train_common.cuh) sums the blocks' partials in one
// fixed order.
constexpr int PE_ROWS = 8;  // rows of a band
constexpr int PE_T = 256;   // threads of an ff_pe_band block

// the PE geometry; a block's partials are rows [dWpe0 (npe) | dWpe1 (npe)
// | db1] of H
struct PeGeo {
  int crops, n, npe, bands;
  float inv_f1;
};

PeGeo pe_geo(int crops, int n, int f, int npe) {
  PeGeo g;
  g.crops = crops;
  g.n = n;
  g.npe = npe;
  g.bands = (n + PE_ROWS - 1) / PE_ROWS;
  g.inv_f1 = 1.0f / static_cast<float>(2 * f);
  return g;
}

__global__ void __launch_bounds__(PE_T, 2)
ff_pe_band(const float* __restrict__ dz1, const int* __restrict__ org,
           float* __restrict__ part, PeGeo g, int H) {
  // per warp: its slots' row shares (PE_ROWS) and column PE partials (8)
  __shared__ float4 red[PE_T / 32][PE_ROWS + 8][16];
  __shared__ float4 rows[PE_ROWS][16];  // the band's finished row sums
  const int u = threadIdx.x & 15, slot = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int crop = blockIdx.x / g.bands, band = blockIdx.x % g.bands;
  const int n = g.n, r0 = band * PE_ROWS, nr = min(PE_ROWS, n - r0);
  const int h = blockIdx.y * 64 + 4 * u;
  const float* base =
      dz1 + (static_cast<size_t>(crop) * n + r0) * n * H + h;
  const int o0 = org[2 * crop], o1 = org[2 * crop + 1];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 rs[PE_ROWS], cp[8];
#pragma unroll
  for (int r = 0; r < PE_ROWS; ++r) rs[r] = zero;
#pragma unroll
  for (int o = 0; o < 8; ++o) cp[o] = zero;
  for (int c = slot; c < n; c += 16) {
    const float* px = base + static_cast<size_t>(c) * H;
    float4 x[PE_ROWS];
#pragma unroll
    for (int r = 0; r < PE_ROWS; ++r)
      x[r] = r < nr ? __ldg(reinterpret_cast<const float4*>(
                          px + static_cast<size_t>(r) * n * H))
                    : zero;
    float4 col = x[0];
    add4(rs[0], x[0]);
#pragma unroll
    for (int r = 1; r < PE_ROWS; ++r) {
      add4(col, x[r]);
      add4(rs[r], x[r]);
    }
    const float t = static_cast<float>(o1 + c) * g.inv_f1;
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (o < g.npe) fma4(cp[o], tri_pe(t, o, g.npe), col);
  }
  // the warp's two slots, then the warps in order
  auto put = [&](int i, float4 v) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, 16);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, 16);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, 16);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, 16);
    if (lane < 16) red[warp][i][u] = v;
  };
#pragma unroll
  for (int r = 0; r < PE_ROWS; ++r) put(r, rs[r]);
#pragma unroll
  for (int o = 0; o < 8; ++o) put(PE_ROWS + o, cp[o]);
  __syncthreads();
  const int rowlen = 2 * g.npe + 1;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * rowlen * H + h;
  // thread (slot, u) finishes row `slot` of the band, or for slot = 8 + o
  // the block's dWpe1 row o
  float4 acc = red[0][slot][u];
#pragma unroll
  for (int w = 1; w < PE_T / 32; ++w) add4(acc, red[w][slot][u]);
  if (slot < PE_ROWS)
    rows[slot][u] = acc;
  else if (slot - PE_ROWS < g.npe)
    *reinterpret_cast<float4*>(mypart +
                               static_cast<size_t>(g.npe + slot - PE_ROWS) *
                                   H) = acc;
  __syncthreads();
  // the finished rows by their tri values (dWpe0 row o = slot) and db1
  if (slot <= g.npe) {
    float4 s = zero;
    for (int r = 0; r < nr; ++r) {
      const float w =
          slot == g.npe
              ? 1.0f
              : tri_pe(static_cast<float>(o0 + r0 + r) * g.inv_f1, slot,
                       g.npe);
      fma4(s, w, rows[r][u]);
    }
    *reinterpret_cast<float4*>(
        mypart + static_cast<size_t>(slot == g.npe ? 2 * g.npe : slot) * H) =
        s;
  }
}

// C on dz1 [crops * n^2][H], H a multiple of 64: part, scratch of
// [crops * bands][2 npe + 1][H] floats; out [2 npe + 1][H]
cudaError_t launch_pe_grads(const float* dz1, const int* org, float* part,
                            float* out, const PeGeo& g, int H,
                            cudaStream_t stream) {
  const int nblk = g.crops * g.bands;
  ff_pe_band<<<dim3(nblk, H / 64), PE_T, 0, stream>>>(dz1, org, part, g, H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ff_pe_sum<<<dim3(2 * g.npe + 1, H / 64), 256, 0, stream>>>(
      part, out, nblk, 2 * g.npe + 1, H);
  return cudaGetLastError();
}

struct Args {
  const float *pp, *c1p, *w1, *bvec, *wpe0, *wpe1, *w2, *b2, *w3, *b3, *tgt;
  const int* org;
  float *out, *dz1, *part_mlp, *win_p, *win_c1, *corners, *part_pe, *pe,
      *part_eps;
  int nblk_mlp, nblk_eps;
  WinGeo win;
  PeGeo pg;
  Geo g;
  cudaStream_t stream;
};

// the per-pixel bodies, by the id the caller passes (nic_torch/kernels/
// train_fused_ff.py BODY_IDS, from _widths.kernel_body)
enum Body { kMma = 1, kTf32 = 2 };

// the body of the dot kind: ff_pixel_mma for bf16 dots, ff_pixel_tf32 for
// fp32 dots
template <bool BF16, int G>
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
    const size_t smem = ff_tf32_smem(a.g.nfeat, a.g.w1_smem);
    auto kern = ff_pixel_tf32<G>;
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
  }
}

template <int H, bool BF16>
cudaError_t launch_rest(const Args& a) {
  cudaError_t e = launch_node_windows(a.dz1, a.org, a.win_p, a.win_c1,
                                      a.corners, a.win, H, a.stream);
  if (e != cudaSuccess) return e;
  e = launch_pe_grads(a.dz1, a.org, a.part_pe, a.pe, a.pg, H, a.stream);
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
  const cudaError_t e = launch_pixel<BF16, G>(a);
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
    void* win_c1, void* win_corners, void* part_pe, void* pe_grads,
    void* part_eps, int crops,
    int n, int f, int p_rows, int p_cols, int c1_rows, int c1_cols,
    int hidden, int npe, int nfeat, int fslot, int bf16, int gelu_id,
    int body, int nbits, int s0, int s1, int pixel_base, int nblk_mlp,
    int nblk_eps, void* stream) {
  // the caller names the body: ff_pixel_mma takes bf16 dots, ff_pixel_tf32
  // fp32 dots; any other pairing is refused
  if (crops <= 0 || n <= 0 || f <= 0 || npe < 0 || npe > 8 || nfeat <= 0 ||
      fslot < nfeat || nblk_mlp <= 0 || (nbits > 0) != (nblk_eps > 0) ||
      body != (bf16 ? kMma : kTf32))
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
                                  : ff_tf32_smem(nfeat, true)) <= kMaxSmem;
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
  a.part_pe = static_cast<float*>(part_pe);
  a.pe = static_cast<float*>(pe_grads);
  a.part_eps = static_cast<float*>(part_eps);
  a.nblk_mlp = nblk_mlp;
  a.nblk_eps = nblk_eps;
  a.win = win_geo(crops, n, f);
  a.pg = pe_geo(crops, n, f, npe);
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

// C alone (as K11 launches it): the PE grads and db1, out [2 npe + 1][H]
// (dWpe0 | dWpe1 | db1), of dz1 [crops n^2][hidden] for crops of n x n at
// origins [crops][2] on the lattice of period f; part: scratch of
// [crops * ceil(n / PE_ROWS)][2 npe + 1][hidden] floats; hidden a multiple
// of 64.
extern "C" int nic_pe_grads(const void* dz1, const void* origins, void* part,
                            void* out, int crops, int n, int f, int npe,
                            int hidden, void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 || npe < 0 || npe > 8 || hidden <= 0 ||
      hidden % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_pe_grads(
      static_cast<const float*>(dz1), static_cast<const int*>(origins),
      static_cast<float*>(part), static_cast<float*>(out),
      pe_geo(crops, n, f, npe), hidden, static_cast<cudaStream_t>(stream)));
}
