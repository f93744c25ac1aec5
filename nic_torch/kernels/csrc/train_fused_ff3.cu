// The feature-free fused train step in 3D (kernel3, methods 3 and 4) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nic/kernels/train_fused_ff3.py
// `_kernel_ff3` (launched by `_impl_ff3`, pallas_call at :462). The
// first-layer fold (P = sum_k shift_k(G0) W1_k over the 8 dense or 4
// even-parity corners, C1 = G1 W1_g1) and the three per-crop PE tables
// (PE(t) W1_pe for the slab, a1 and a2 axes, with b1 + lod w_lod folded
// into the a1 table) run before it in PyTorch, and the unfold after it
// (nic_torch/kernels/train_fused_ff3.py). For voxel (s, a, b) of crop i at
// origin (o0, o1, o2), absolute (S, A, B) = (o0 + s, o1 + a, o2 + b):
//
//   z1 = P[S/f, A/f, B/f] + trilinear(C1 at (S/f1, A/f1, B/f1))
//        + pe0[i, s] + pe1[i, a] + pe2[i, b]      (+ eps W1 with noise)
//   out = sigmoid(gelu(gelu(z1) W2 + b2) W3 + b3),  loss = mean((out-t)^2)
//
// and the full backward. One entry point, nic_train_fused_ff3, runs on the
// caller's stream:
//
//   A the per-voxel step over 128-voxel tiles, each block walking a fixed
//                   set of tiles: the z1 build, then the MLP tail of
//                   train_common.cuh: forward, loss, backward down to dz1
//                   (written [N, H]) and the block partials of loss, dW3,
//                   db3, dW2, db2. At H = 64 on the tensor cores
//                   (ff_tail_mma, as K11's bodies): ff3_pixel_mma for bf16
//                   dots, ff3_pixel_tf32 for fp32 dots as three TF32
//                   products each; at H = 128 ff3_pixel, one thread per
//                   voxel on the CUDA cores (ff_tail). The caller names the
//                   body (`body`, nic_torch/kernels/_widths.py
//                   kernel_body) and a body that does not take the mode
//                   and width is refused;
//   B node_volumes + node_volume_corners (train_common.cuh, shared with
//                   the 3D kernel2) the node-resolution cotangents per
//                   crop: P-cell sums of dz1 at period f per axis, C1
//                   trilinear-weighted sums at period 2f, each voxel read
//                   once (a block per C1 cell, then a small pass that sums
//                   each C1 node's eight cell corners);
//   C ff3_pe_band + ff_pe_sum the PE grads (the PE tables against each
//                   crop's slab, a1 and a2 sums of dz1: dWpe0, dWpe1,
//                   dWpe2) and db1, each voxel read once (a block per crop
//                   and band of slabs contracts its sums on the SM and
//                   writes partials, then a small pass sums them in a
//                   fixed order);
//   D ff_epsgrad    (train_common.cuh, shared with the 2D kernel3; noise
//                   only) eps^T dz1 per block, in bf16-dot mode on the
//                   tensor cores.
//
// The feature noise is the JAX kernel's stream: counter (crop n^3 + voxel
// + pixel_base) * pad8(F) + feature, the row-major voxel index being the
// JAX kernel's ((crop nb + b) R + irow); the counter hash as in 2D.
//
// Every reduction is a fixed-order sum (no atomics), so two runs are
// bit-identical. Surgical bf16 as in JAX: dot inputs rounded with
// __float2bfloat16_rn, every sum and elementwise op fp32, the node and PE
// reductions on the fp32 dz1.
//
// Not carried over from the TPU kernel: the per-crop staged windows and
// the scalar-prefetch index maps that fetch them, the one-hot indicator
// matmul that forms the row sums (a Mosaic relayout workaround), the
// packed parameter tile and the lane padding of the windows; this kernel
// indexes the folded volumes directly at the voxel's absolute cell.
//
// What bounds it: per voxel the three 64x64 products (forward z2,
// backward dh1, the dW2 reduction) are ~12.3 kFMA, plus 2 F H (~16 kFMA at
// F = 127) for eps W1 and eps^T dz1 with noise: at the protocol's 8 x 32^3
// = 262,144 voxels ~16 GFLOP with noise, ~0.24 ms of fp32 CUDA cores at 67
// TFLOP/s, against ~0.2 GB of traffic (dz1 written once, read by B, C, D).
// On the bf16 tensor cores (ff3_pixel_mma) the products take ~0.016 ms and
// the bytes, the z1 build's nine gathers and the GELUs bound A; as three
// TF32 products (ff3_pixel_tf32, at 495 / 3 TFLOP/s) ~0.067 ms of A's
// 11 GFLOP, beside the same CUDA-core work.
//
// Widths: H = 64 and H = 128 are built (a narrower model is zero-padded
// to the next by the wrapper, nic_torch/kernels/_widths.py; at H = 64
// bf16 dots run ff3_pixel_mma and fp32 dots ff3_pixel_tf32, at H = 128
// both run ff3_pixel), and any F.
// At H = 128 the staging tiles and W2 take 206,464 bytes of shared memory,
// so W1 (F = 127: another 65 KB) does not fit beside them: the noise term
// reads W1's rows from device memory through L1 instead (ff3_smem picks
// this from F); ff_epsgrad takes the features in passes of 64 there (128
// at H = 64), any F in both.
//
// The entry point does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "train_common.cuh"

namespace {

struct Geo3 {
  int crops, n, f, f1, p_side, c_side, nfeat, fslot, npix;
  int w1_smem;  // W1 staged in shared memory (else read from device memory)
  float inv_f1, inv_total, eps_scale;
  uint32_t s0, s1, pixel_base;
};

template <int H, bool BF16, int G>
__global__ void __launch_bounds__(TP, 1)
ff3_pixel(const float* __restrict__ pv, const float* __restrict__ c1v,
          const float* __restrict__ w1, const float* __restrict__ pe,
          const float* __restrict__ w2, const float* __restrict__ b2,
          const float* __restrict__ w3, const float* __restrict__ b3,
          const float* __restrict__ tgt, const int* __restrict__ org,
          float* __restrict__ out, float* __restrict__ dz1,
          float* __restrict__ part, Geo3 g) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // h1b [H][LDP]
  float* sB = sA + H * LDP;                     // h2b, then dz2 [H][LDP]
  float* sD = sB + H * LDP;                     // dz3b, dz3, loss [7][LDP]
  float* sW2 = sD + 7 * LDP;                    // [H][H] (in, out)
  float* sW3 = sW2 + H * H;                     // [H][3]
  float* sb2 = sW3 + H * 3;
  float* sb3 = sb2 + H;                         // [4]
  float* sW1 = sb3 + 4;                         // [nfeat][H] with noise

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += TP) sW2[i] = cd<BF16>(w2[i]);
  for (int i = tid; i < H * 3; i += TP) sW3[i] = cd<BF16>(w3[i]);
  for (int i = tid; i < H; i += TP) sb2[i] = b2[i];
  if (tid < 3) sb3[tid] = b3[tid];
  const bool noise = g.eps_scale != 0.0f;
  stage_w1<BF16>(sW1, w1, g.nfeat * H, noise && g.w1_smem);
  __syncthreads();

  constexpr int PART = 4 + 4 * H + H * H;
  float* mypart = part + static_cast<size_t>(blockIdx.x) * PART;
  const int n = g.n;
  const int n3 = n * n * n;
  const size_t tab = static_cast<size_t>(g.crops) * n * H;  // one PE table
  const int ps = g.p_side, cs = g.c_side;
  const int tiles = (g.npix + TP - 1) / TP;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int pix = tile * TP + tid;
    const bool valid = pix < g.npix;
    float z1[H];
    if (valid) {
      const int crop = pix / n3, rem = pix % n3;
      const int s = rem / (n * n), a = rem / n % n, b = rem % n;
      const int* o = org + 3 * crop;
      const int S = o[0] + s, A = o[1] + a, B = o[2] + b;
      // eps W1 first (it is added last, as in the JAX kernel)
NIC_UNROLL_H(H)
      for (int h = 0; h < H; ++h) z1[h] = 0.0f;
      if (noise) {
        const uint32_t ctr0 = (static_cast<uint32_t>(pix) + g.pixel_base) *
                              static_cast<uint32_t>(g.fslot);
        if (g.w1_smem)
          noise_rows<H, BF16, false>(z1, sW1, g.nfeat, ctr0, g.s0, g.s1,
                                     g.eps_scale);
        else
          noise_rows<H, BF16, true>(z1, w1, g.nfeat, ctr0, g.s0, g.s1,
                                    g.eps_scale);
      }
      // C1 taps: nodes S/f1, A/f1, B/f1 and the next ones (clamped; the
      // clamped tap always has weight 0), in-cell fractions u
      const float us = static_cast<float>(S % g.f1) * g.inv_f1;
      const float ua = static_cast<float>(A % g.f1) * g.inv_f1;
      const float ub = static_cast<float>(B % g.f1) * g.inv_f1;
      const int s0 = S / g.f1, a0 = A / g.f1, b0 = B / g.f1;
      const int s1 = min(s0 + 1, cs - 1), a1 = min(a0 + 1, cs - 1);
      const int b1 = min(b0 + 1, cs - 1);
      const float* q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        q[k] = c1v + ((static_cast<size_t>(k & 4 ? s1 : s0) * cs +
                       (k & 2 ? a1 : a0)) * cs + (k & 1 ? b1 : b0)) * H;
      const float* prow =
          pv + ((static_cast<size_t>(S / g.f) * ps + A / g.f) * ps + B / g.f) *
                   H;
      const float* e0 = pe + (static_cast<size_t>(crop) * n + s) * H;
      const float* e1 = pe + tab + (static_cast<size_t>(crop) * n + a) * H;
      const float* e2 = pe + 2 * tab + (static_cast<size_t>(crop) * n + b) * H;
NIC_UNROLL_H(H / 4)
      for (int h4 = 0; h4 < H / 4; ++h4) {
        float v[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 t = reinterpret_cast<const float4*>(q[k])[h4];
          v[k][0] = t.x; v[k][1] = t.y; v[k][2] = t.z; v[k][3] = t.w;
        }
        const float4 p4 = reinterpret_cast<const float4*>(prow)[h4];
        const float4 f0 = reinterpret_cast<const float4*>(e0)[h4];
        const float4 f1 = reinterpret_cast<const float4*>(e1)[h4];
        const float4 f2 = reinterpret_cast<const float4*>(e2)[h4];
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float t0[4] = {f0.x, f0.y, f0.z, f0.w};
        const float t1[4] = {f1.x, f1.y, f1.z, f1.w};
        const float t2[4] = {f2.x, f2.y, f2.z, f2.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // a2 first, then a1, then the slab axis
          float ab[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            ab[k] = (1.0f - ub) * v[2 * k][c] + ub * v[2 * k + 1][c];
          const float sa0 = (1.0f - ua) * ab[0] + ua * ab[1];
          const float sa1 = (1.0f - ua) * ab[2] + ua * ab[3];
          const float c1t = (1.0f - us) * sa0 + us * sa1;
          const float base = (((pa[c] + c1t) + t0[c]) + t1[c]) + t2[c];
          const int h = 4 * h4 + c;
          z1[h] = noise ? base + z1[h] : base;
        }
      }
    }
    ff_tail<H, BF16, G>(z1, valid, static_cast<size_t>(pix), sW2, sW3, sb2,
                        sb3, sA, sB, sD, tgt, out, dz1, mypart, first,
                        g.inv_total);
  }
}

// ---- A at H = 64 on the tensor cores: ff3_pixel_mma and ff3_pixel_tf32 --
//
// The layout of K11's bodies (train_fused_ff.cu): 256 threads (8 warps),
// one 128-voxel tile at a time; a warp owns 16 voxels and each thread two
// of them (rows g and g + 8 of the warp, g = lane / 4) at 16 of the 64
// units, the accumulator layout of train_common.cuh. The thread builds
// those z1 entries on the CUDA cores with float2 loads (add_z1_base3),
// adds eps W1 first (noise_mma, W1^T in bf16, for bf16 dots; noise_tf32,
// W1 as TF32 hi/lo B tiles, for fp32 dots) and hands z1 to ff_tail_mma,
// which writes dz1 for node_volumes, ff3_pe_band and ff_epsgrad. The
// block's slice of dW2 stays in registers over its tiles and is written
// once.

// z1 of the thread's voxel row r (voxel p) += its base, in the
// accumulator layout, after eps W1: the P cell; the eight C1 taps,
// trilinear, a2 then a1 then the slab axis; the three PE rows (ff3_pixel's
// order of summation)
__device__ __forceinline__ void add_z1_base3(
    float (&z1)[8][4], int r, int p, bool noise, const float* __restrict__ pv,
    const float* __restrict__ c1v, const float* __restrict__ pe,
    const int* __restrict__ org, const Geo3& g) {
  constexpr int H = 64;
  const int q = threadIdx.x & 3;
  const int n = g.n;
  const int n3 = n * n * n;
  const size_t tab = static_cast<size_t>(g.crops) * n * H;  // one PE table
  const int ps = g.p_side, cs = g.c_side;
  const int crop = p / n3, rem = p % n3;
  const int vs = rem / (n * n), va = rem / n % n, vb = rem % n;
  const int* o = org + 3 * crop;
  const int S = o[0] + vs, A = o[1] + va, B = o[2] + vb;
  // C1 taps: nodes S/f1, A/f1, B/f1 and the next ones (clamped; the
  // clamped tap always has weight 0), in-cell fractions u
  const float us = static_cast<float>(S % g.f1) * g.inv_f1;
  const float ua = static_cast<float>(A % g.f1) * g.inv_f1;
  const float ub = static_cast<float>(B % g.f1) * g.inv_f1;
  const int s0 = S / g.f1, a0 = A / g.f1, b0 = B / g.f1;
  const int s1 = min(s0 + 1, cs - 1), a1 = min(a0 + 1, cs - 1);
  const int b1 = min(b0 + 1, cs - 1);
  const float* tap[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    tap[k] = c1v + ((static_cast<size_t>(k & 4 ? s1 : s0) * cs +
                     (k & 2 ? a1 : a0)) * cs + (k & 1 ? b1 : b0)) * H;
  const float* prow =
      pv + ((static_cast<size_t>(S / g.f) * ps + A / g.f) * ps + B / g.f) * H;
  const float* e0 = pe + (static_cast<size_t>(crop) * n + vs) * H;
  const float* e1 = pe + tab + (static_cast<size_t>(crop) * n + va) * H;
  const float* e2 = pe + 2 * tab + (static_cast<size_t>(crop) * n + vb) * H;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int h0 = 8 * nt + 2 * q;
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = *reinterpret_cast<const float2*>(tap[k] + h0);
    const float2 p2 = *reinterpret_cast<const float2*>(prow + h0);
    const float2 f0 = *reinterpret_cast<const float2*>(e0 + h0);
    const float2 f1 = *reinterpret_cast<const float2*>(e1 + h0);
    const float2 f2 = *reinterpret_cast<const float2*>(e2 + h0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a2 first, then a1, then the slab axis
      float ab[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = i ? v[2 * k].y : v[2 * k].x;
        const float hi = i ? v[2 * k + 1].y : v[2 * k + 1].x;
        ab[k] = (1.0f - ub) * lo + ub * hi;
      }
      const float sa0 = (1.0f - ua) * ab[0] + ua * ab[1];
      const float sa1 = (1.0f - ua) * ab[2] + ua * ab[3];
      const float c1t = (1.0f - us) * sa0 + us * sa1;
      const float base = ((((i ? p2.y : p2.x) + c1t) + (i ? f0.y : f0.x)) +
                          (i ? f1.y : f1.x)) + (i ? f2.y : f2.x);
      float& z = z1[nt][2 * r + i];
      z = noise ? base + z : base;
    }
  }
}

// Shared memory of ff3_pixel_mma (bytes): h2b [64][132] bf16 16,896; dz3b,
// dz3, loss [7][132] 3,696; per-warp db2 [8][64] 2,048; W3, b2, b3 1,040;
// h1b and dz2b [128][72] bf16 36,864; W2^T and W2 [64][72] bf16 18,432:
// 78,976, plus with noise W1^T [64][pad16(F) + 8] bf16 (17,408 at F =
// 127): 96,384 at the 3D protocol, so two blocks (16 warps) fit on an SM.
// From F = 1185 on, W1 is read from device memory instead.
constexpr size_t kMma3FixedSmem = 78976;

size_t ff3_mma_smem(int nfeat, bool w1_smem) {
  const size_t ldk = static_cast<size_t>((nfeat + 15) / 16 * 16 + 8);
  return kMma3FixedSmem + (w1_smem ? 64 * ldk * sizeof(__nv_bfloat16) : 0);
}

template <int G>
__global__ void __launch_bounds__(MT, 2)
ff3_pixel_mma(const float* __restrict__ pv, const float* __restrict__ c1v,
              const float* __restrict__ w1, const float* __restrict__ pe,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              const float* __restrict__ tgt, const int* __restrict__ org,
              float* __restrict__ out, float* __restrict__ dz1,
              float* __restrict__ part, Geo3 g) {
  constexpr int H = 64;
  extern __shared__ float4 smem4[];
  auto* sB = reinterpret_cast<__nv_bfloat16*>(smem4);  // h2b [H][LDP]
  float* sD = reinterpret_cast<float*>(sB + H * LDP);  // [7][LDP]
  float* sDb2 = sD + 7 * LDP;                          // [8][H]
  float* sW3 = sDb2 + 8 * H;                           // [H][3]
  float* sb2 = sW3 + 3 * H;
  float* sb3 = sb2 + H;                                // [4]
  auto* sH1 = reinterpret_cast<__nv_bfloat16*>(sb3 + 4);  // [TP][LDB]
  __nv_bfloat16* sDZ = sH1 + TP * LDB;                    // [TP][LDB]
  __nv_bfloat16* sW2t = sDZ + TP * LDB;                   // [H][LDB] (out, in)
  __nv_bfloat16* sW2 = sW2t + H * LDB;                    // [H][LDB] (in, out)
  __nv_bfloat16* sW1t = sW2 + H * LDB;                    // [H][ldk] with noise
  const int ldk = (g.nfeat + 15) / 16 * 16 + 8;

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += MT) {
    const int k = i / H, j = i % H;
    const __nv_bfloat16 w = __float2bfloat16_rn(w2[i]);
    sW2[k * LDB + j] = w;
    sW2t[j * LDB + k] = w;
  }
  for (int i = tid; i < H * 3; i += MT) sW3[i] = bf16_round(w3[i]);
  for (int i = tid; i < H; i += MT) sb2[i] = b2[i];
  if (tid < 3) sb3[tid] = b3[tid];
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
        add_z1_base3(z1, r, static_cast<int>(pix[r]), noise, pv, c1v, pe, org,
                     g);
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out, dz1, mypart, first,
                   g.inv_total, dw2);
  }
  put_dw2(mypart, dw2);
}

// Shared memory of ff3_pixel_tf32 (bytes): W2 and W2^T as TF32 hi/lo B
// tiles [64][36] float4 36,864 each; h1 and dz2 [128][72] fp32 36,864 each;
// the warps' sums [8][260] 8,320; W3, b2, b3 1,040: 156,816, plus with
// noise W1 as TF32 hi/lo B tiles [64][pad16(F) / 2 + 4] float4 (69,632 at
// F = 127): 226,448 at the 3D protocol, one block (8 warps) an SM. From F
// = 129 on, W1 is read from device memory and split as it is read.
constexpr size_t kTf32Fixed3Smem = 156816;

size_t ff3_tf32_smem(int nfeat, bool w1_smem) {
  const size_t ldw = static_cast<size_t>(pad16(nfeat) / 2 + 4);
  return kTf32Fixed3Smem + (w1_smem ? 64 * ldw * sizeof(float4) : 0);
}

template <int G>
__global__ void __launch_bounds__(MT, 1)
ff3_pixel_tf32(const float* __restrict__ pv, const float* __restrict__ c1v,
               const float* __restrict__ w1, const float* __restrict__ pe,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               const float* __restrict__ tgt, const int* __restrict__ org,
               float* __restrict__ out, float* __restrict__ dz1,
               float* __restrict__ part, Geo3 g) {
  constexpr int H = 64;
  extern __shared__ float4 smem4[];
  float4* sW2 = smem4;                                   // [H][36]
  float4* sW2t = sW2 + H * 36;                           // [H][36]
  float* sH1 = reinterpret_cast<float*>(sW2t + H * 36);  // [TP][LDF]
  float* sDZ = sH1 + TP * LDF;                           // [TP][LDF]
  float* sRed = sDZ + TP * LDF;                          // [8][RED_W]
  float* sW3 = sRed + (MT / 32) * RED_W;                 // [H][3]
  float* sb2 = sW3 + 3 * H;
  float* sb3 = sb2 + H;                                  // [4]
  float4* sW1 = reinterpret_cast<float4*>(sb3 + 4);      // [H][ldw] noise
  const int ldw = pad16(g.nfeat) / 2 + 4;

  const int tid = threadIdx.x;
  stage_b_pairs(sW2, w2, H, 1, H, H);   // (k, n) = W2[k][n]
  stage_b_pairs(sW2t, w2, 1, H, H, H);  // (k, n) = W2[n][k]
  for (int i = tid; i < H * 3; i += MT) sW3[i] = w3[i];
  for (int i = tid; i < H; i += MT) sb2[i] = b2[i];
  if (tid < 3) sb3[tid] = b3[tid];
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
        add_z1_base3(z1, r, static_cast<int>(pix[r]), noise, pv, c1v, pe, org,
                     g);
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out, dz1, mypart, first,
                   g.inv_total, dw2);
  }
  put_dw2(mypart, dw2);
}

// ---- C: the PE grads and db1 in one pass over dz1 ---------------------
//
// Replaces the slab, a1 and a2 sums of the Pallas kernel `_kernel_ff3`
// (nic/kernels/train_fused_ff3.py:225-234) and their table contractions,
// which JAX leaves to XLA: dWpe0[o] = sum over crops and slabs s of
// T0[crop][s][o] slabsum[crop][s] (slabsum: dz1 summed over the crop's a1
// and a2), dWpe1 and dWpe2 the same over the a1 sums (over slab and a2)
// and the a2 sums (over slab and a1) with T1 and T2, db1 = sum of dz1.
// T is pe_tables' [3][crops][n][npe], zero-padded to 8 entries a row.
//
// What bounds it (8 x 32^3, H = 64): dz1 read once, 67 MB: 0.020 ms at
// 3.35 TB/s; the contractions are ~0. Design (K11's part C, ff_pe_band,
// carried to 3D): two launches, every sum in a fixed order, no atomics.
// ff3_pe_band: a block owns one crop and a band of PE3_SLABS slabs and
// reads each of their voxels once, 16 bytes at a time: 16 threads cover 64
// units of a voxel and the block's 16 slots each own the a1 rows slot,
// slot + 16, ...; a thread walks its rows' lines (a1, a2) along a2, loads
// the line's band of slabs (PE3_SLABS independent loads, four lines
// unrolled), keeps its share of each slab's sum, contracts each line's sum
// over the band with the line's a2 table row at once and each row's sum
// with its a1 table row when the row ends. The contraction is linear, so
// these band partials of dWpe1 and dWpe2 add exactly as partial sums
// would. The block then sums its slots' shares in a fixed order in shared
// memory, finishes each slab's sum (complete in the block), contracts it
// with the slab's T0 row and adds it to db1, and writes its partial rows
// [dWpe0 (npe) | dWpe1 (npe) | dWpe2 (npe) | db1] of H. ff_pe_sum
// (train_common.cuh) sums the blocks' partials in one fixed order. No
// slab, a1 or a2 sum reaches device memory.
constexpr int PE3_SLABS = 2;  // slabs of a band
constexpr int PE3_T = 256;    // threads of an ff3_pe_band block

struct Pe3Geo {
  int crops, n, npe, bands;
};

Pe3Geo pe3_geo(int crops, int n, int npe) {
  Pe3Geo g;
  g.crops = crops;
  g.n = n;
  g.npe = npe;
  g.bands = (n + PE3_SLABS - 1) / PE3_SLABS;
  return g;
}

// eight entries of a table row [8] as fma weights on a float4
__device__ __forceinline__ void fma_row8(float4 (&acc)[8], const float* t,
                                         int npe, const float4& v) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(t));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(t + 4));
  const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (o < npe) fma4(acc[o], w[o], v);
}

__global__ void __launch_bounds__(PE3_T, 2)
ff3_pe_band(const float* __restrict__ dz1, const float* __restrict__ tab,
            float* __restrict__ part, Pe3Geo g, int H) {
  // per warp: its slots' slab shares, a1 and a2 contractions
  constexpr int NI = PE3_SLABS + 16;
  __shared__ float4 red[PE3_T / 32][NI][16];
  __shared__ float4 slabs[PE3_SLABS][16];  // the band's finished slab sums
  const int u = threadIdx.x & 15, slot = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int crop = blockIdx.x / g.bands, band = blockIdx.x % g.bands;
  const int n = g.n, s0 = band * PE3_SLABS, ns = min(PE3_SLABS, n - s0);
  const int h = blockIdx.y * 64 + 4 * u;
  const size_t slab = static_cast<size_t>(n) * n * H;  // floats of a slab
  const float* base = dz1 + (static_cast<size_t>(crop) * n + s0) * slab + h;
  const float* t1 = tab + (static_cast<size_t>(g.crops) + crop) * n * 8;
  const float* t2 = tab + (static_cast<size_t>(2 * g.crops) + crop) * n * 8;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 rs[PE3_SLABS], c1[8], c2[8];
#pragma unroll
  for (int s = 0; s < PE3_SLABS; ++s) rs[s] = zero;
#pragma unroll
  for (int o = 0; o < 8; ++o) c1[o] = c2[o] = zero;
  for (int a = slot; a < n; a += 16) {
    const float* pa = base + static_cast<size_t>(a) * n * H;
    float4 row = zero;  // the row's line sums over the band
#pragma unroll 4
    for (int b = 0; b < n; ++b) {
      const float* px = pa + static_cast<size_t>(b) * H;
      float4 x[PE3_SLABS];
#pragma unroll
      for (int s = 0; s < PE3_SLABS; ++s)
        x[s] = s < ns ? __ldg(reinterpret_cast<const float4*>(px + s * slab))
                      : zero;
      float4 line = x[0];
      add4(rs[0], x[0]);
#pragma unroll
      for (int s = 1; s < PE3_SLABS; ++s) {
        add4(line, x[s]);
        add4(rs[s], x[s]);
      }
      add4(row, line);
      fma_row8(c2, t2 + 8 * b, g.npe, line);
    }
    fma_row8(c1, t1 + 8 * a, g.npe, row);
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
  for (int s = 0; s < PE3_SLABS; ++s) put(s, rs[s]);
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    put(PE3_SLABS + o, c1[o]);
    put(PE3_SLABS + 8 + o, c2[o]);
  }
  __syncthreads();
  float* mypart =
      part + static_cast<size_t>(blockIdx.x) * (3 * g.npe + 1) * H + h;
  // thread (slot, u) finishes item slot (and slot + 16): a slab sum, or
  // the block's dWpe1 / dWpe2 row
  for (int i = slot; i < NI; i += 16) {
    float4 acc = red[0][i][u];
#pragma unroll
    for (int w = 1; w < PE3_T / 32; ++w) add4(acc, red[w][i][u]);
    if (i < PE3_SLABS) {
      slabs[i][u] = acc;
    } else {
      const int axis = 1 + (i - PE3_SLABS) / 8, o = (i - PE3_SLABS) % 8;
      if (o < g.npe)
        *reinterpret_cast<float4*>(
            mypart + static_cast<size_t>(axis * g.npe + o) * H) = acc;
    }
  }
  __syncthreads();
  // the finished slabs by their T0 values (dWpe0 row o = slot) and db1
  if (slot <= g.npe) {
    const float* t0 = tab + (static_cast<size_t>(crop) * n + s0) * 8;
    float4 acc = zero;
    for (int s = 0; s < ns; ++s)
      fma4(acc, slot == g.npe ? 1.0f : __ldg(t0 + 8 * s + slot), slabs[s][u]);
    *reinterpret_cast<float4*>(
        mypart + static_cast<size_t>(slot == g.npe ? 3 * g.npe : slot) * H) =
        acc;
  }
}

// C on dz1 [crops * n^3][H], H a multiple of 64, with the PE tables tab
// [3][crops][n][8]: part, scratch of [crops * bands][3 npe + 1][H] floats;
// out [3 npe + 1][H] (dWpe0 | dWpe1 | dWpe2 | db1)
cudaError_t launch_pe_grads3(const float* dz1, const float* tab, float* part,
                             float* out, const Pe3Geo& g, int H,
                             cudaStream_t stream) {
  const int nblk = g.crops * g.bands;
  ff3_pe_band<<<dim3(nblk, H / 64), PE3_T, 0, stream>>>(dz1, tab, part, g,
                                                          H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ff_pe_sum<<<dim3(3 * g.npe + 1, H / 64), 256, 0, stream>>>(
      part, out, nblk, 3 * g.npe + 1, H);
  return cudaGetLastError();
}

struct Args3 {
  const float *pv, *c1v, *w1, *pe, *tab, *w2, *b2, *w3, *b3, *tgt;
  const int* org;
  float *out, *dz1, *part_mlp, *win_p, *win_c1, *corners, *part_pe,
      *pe_grads, *part_eps;
  int nblk_mlp, nblk_eps, body;
  VolGeo vol;
  Pe3Geo pg;
  Geo3 g;
  cudaStream_t stream;
};

// shared memory of ff3_pixel (built at H = 128): the staging tiles, W2,
// W3, b2, b3 and, with noise when it fits, W1 (2 x [H][132] + [7][132] +
// H^2 + 4H + 4 floats: 206,464 bytes; W1 adds 4 F H bytes, so it stays in
// device memory from F = 51 on)
template <int H>
size_t ff3_smem(int nfeat, bool w1_smem) {
  return sizeof(float) * (2 * H * LDP + 7 * LDP + H * H + 3 * H + H + 4 +
                          (w1_smem ? static_cast<size_t>(nfeat) * H : 0));
}

// the per-voxel bodies, by the id the caller passes (nic_torch/kernels/
// train_fused_ff3.py BODY_IDS, from _widths.kernel_body)
enum Body { kCudaCore = 0, kMma = 1, kTf32 = 2 };

// the per-voxel body the caller names (a.body): ff3_pixel_mma for bf16 dots
// and ff3_pixel_tf32 for fp32 dots at H = 64, ff3_pixel at H = 128; any
// other pairing is refused
template <int H, bool BF16, int G>
cudaError_t launch_pixel(const Args3& a) {
  cudaError_t e;
  if constexpr (H == 64 && BF16) {
    if (a.body != kMma) return cudaErrorInvalidValue;
    const size_t smem = ff3_mma_smem(a.g.nfeat, a.g.w1_smem);
    auto kern = ff3_pixel_mma<G>;
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<a.nblk_mlp, MT, smem, a.stream>>>(
        a.pv, a.c1v, a.w1, a.pe, a.w2, a.b2, a.w3, a.b3, a.tgt, a.org,
        a.out, a.dz1, a.part_mlp, a.g);
    e = cudaGetLastError();
    if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  } else if constexpr (H == 64) {
    if (a.body != kTf32) return cudaErrorInvalidValue;
    const size_t smem = ff3_tf32_smem(a.g.nfeat, a.g.w1_smem);
    auto kern = ff3_pixel_tf32<G>;
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<a.nblk_mlp, MT, smem, a.stream>>>(
        a.pv, a.c1v, a.w1, a.pe, a.w2, a.b2, a.w3, a.b3, a.tgt, a.org,
        a.out, a.dz1, a.part_mlp, a.g);
    e = cudaGetLastError();
    if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  } else {
    if (a.body != kCudaCore) return cudaErrorInvalidValue;
    const size_t smem = ff3_smem<H>(a.g.nfeat, a.g.w1_smem);
    auto kern = ff3_pixel<H, BF16, G>;
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<a.nblk_mlp, TP, smem, a.stream>>>(
        a.pv, a.c1v, a.w1, a.pe, a.w2, a.b2, a.w3, a.b3, a.tgt, a.org,
        a.out, a.dz1, a.part_mlp, a.g);
    e = cudaGetLastError();
    if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  }
  return e;
}

template <int H, bool BF16, int G>
cudaError_t launch_all(const Args3& a) {
  cudaError_t e = launch_pixel<H, BF16, G>(a);
  if (e != cudaSuccess) return e;
  e = launch_node_volumes(a.dz1, a.org, a.win_p, a.win_c1, a.corners, a.vol,
                          H, a.stream);
  if (e != cudaSuccess) return e;
  e = launch_pe_grads3(a.dz1, a.tab, a.part_pe, a.pe_grads, a.pg, H,
                       a.stream);
  if (e != cudaSuccess || a.nblk_eps == 0) return e;
  NoiseGeo ng;
  ng.npix = a.g.npix;
  ng.nfeat = a.g.nfeat;
  ng.fslot = a.g.fslot;
  ng.eps_scale = a.g.eps_scale;
  ng.s0 = a.g.s0;
  ng.s1 = a.g.s1;
  ng.pixel_base = a.g.pixel_base;
  return launch_epsgrad<H, BF16, (H > 64 ? 64 : 128)>(
      a.dz1, a.part_eps, ng, a.nblk_eps, a.stream);
}

template <int H, bool BF16>
cudaError_t dispatch_gelu(int gelu_id, const Args3& a) {
  switch (gelu_id) {
    case kErf: return launch_all<H, BF16, kErf>(a);
    case kPoly: return launch_all<H, BF16, kPoly>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K12: loss, out [N, 3] and the per-block partials part_mlp [nblk_mlp][4 +
// 4H + H*H] (ff_tail's layout), dz1 [N, H] (scratch), the per-crop node
// volumes win_p [crops][r0^3][H] and win_c1 [crops][r1][c1][c1][H]
// (extents in train_common.cuh vol_geo; corners [crops][r1][c1][c1][8][H]
// scratch), the PE grads and db1 pe_grads [3 npe + 1][H] (dWpe0 | dWpe1 |
// dWpe2 | db1; part_pe [nic_pe3_blocks(crops, n)][3 npe + 1][H] scratch)
// and, with noise (nbits > 0), part_eps [nblk_eps][nfeat][H], for crops of
// n^3 voxels (N = crops n^3, row-major per crop) at origins [crops][3] on
// the lattice of period f. p_vol [p_side^3][H], c1_vol [c_side^3][H], pe
// [3][crops][n][H] (the PE rows through W1), tables [3][crops][n][8] (the
// PE values, zero past npe).
extern "C" int nic_train_fused_ff3(
    const void* p_vol, const void* c1_vol, const void* w1, const void* pe,
    const void* tables, const void* w2, const void* b2, const void* w3,
    const void* b3, const void* tgt, const void* origins, void* out,
    void* dz1, void* part_mlp, void* win_p, void* win_c1, void* win_corners,
    void* part_pe, void* pe_grads, void* part_eps, int crops, int n, int f,
    int p_side, int c_side, int hidden, int npe, int nfeat, int fslot,
    int bf16, int gelu_id, int body, int nbits, int s0, int s1,
    int pixel_base, int nblk_mlp, int nblk_eps, void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 || p_side <= 0 || c_side <= 0 ||
      npe < 0 || npe > 8 || nfeat <= 0 || fslot < nfeat || nblk_mlp <= 0 ||
      (nbits > 0) != (nblk_eps > 0) || (hidden != 64 && hidden != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo3 g;
  g.crops = crops;
  g.n = n;
  g.f = f;
  g.f1 = 2 * f;
  g.p_side = p_side;
  g.c_side = c_side;
  g.nfeat = nfeat;
  g.fslot = fslot;
  g.npix = crops * n * n * n;
  g.inv_f1 = 1.0f / static_cast<float>(2 * f);
  g.inv_total = 1.0f / (static_cast<float>(g.npix) * 3.0f);
  g.eps_scale = nbits > 0 ? ldexpf(1.0f, -nbits) : 0.0f;
  g.s0 = static_cast<uint32_t>(s0);
  g.s1 = static_cast<uint32_t>(s1);
  g.pixel_base = static_cast<uint32_t>(pixel_base);
  g.w1_smem = nbits > 0 && (body == kMma    ? ff3_mma_smem(nfeat, true)
                            : body == kTf32 ? ff3_tf32_smem(nfeat, true)
                                            : ff3_smem<128>(nfeat, true)) <=
                               kMaxSmem;
  Args3 a;
  a.pv = static_cast<const float*>(p_vol);
  a.c1v = static_cast<const float*>(c1_vol);
  a.w1 = static_cast<const float*>(w1);
  a.pe = static_cast<const float*>(pe);
  a.tab = static_cast<const float*>(tables);
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
  a.pe_grads = static_cast<float*>(pe_grads);
  a.part_eps = static_cast<float*>(part_eps);
  a.nblk_mlp = nblk_mlp;
  a.nblk_eps = nblk_eps;
  a.body = body;
  a.vol = vol_geo(crops, n, f);
  a.pg = pe3_geo(crops, n, npe);
  a.g = g;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (hidden == 64)
    e = bf16 ? dispatch_gelu<64, true>(gelu_id, a)
             : dispatch_gelu<64, false>(gelu_id, a);
  else
    e = bf16 ? dispatch_gelu<128, true>(gelu_id, a)
             : dispatch_gelu<128, false>(gelu_id, a);
  return static_cast<int>(e);
}

// the blocks of ff3_pe_band for crops of n^3 voxels, a block per crop and
// band of PE3_SLABS slabs: the rows of part C's partials scratch, which
// the caller sizes by this
extern "C" int nic_pe3_blocks(int crops, int n) {
  const Pe3Geo g = pe3_geo(crops, n, 0);
  return g.crops * g.bands;
}

// C alone (as K12 launches it): the PE grads and db1, out [3 npe + 1][H]
// (dWpe0 | dWpe1 | dWpe2 | db1), of dz1 [crops n^3][hidden] for crops of
// n^3 voxels with the PE tables tab [3][crops][n][8] (zero past npe);
// part: scratch of [nic_pe3_blocks(crops, n)][3 npe + 1][hidden]
// floats; hidden a multiple of 64.
extern "C" int nic_pe_grads3(const void* dz1, const void* tables, void* part,
                             void* out, int crops, int n, int npe, int hidden,
                             void* stream) {
  if (crops <= 0 || n <= 0 || npe < 0 || npe > 8 || hidden <= 0 ||
      hidden % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_pe_grads3(
      static_cast<const float*>(dz1), static_cast<const float*>(tables),
      static_cast<float*>(part), static_cast<float*>(out),
      pe3_geo(crops, n, npe), hidden, static_cast<cudaStream_t>(stream)));
}
