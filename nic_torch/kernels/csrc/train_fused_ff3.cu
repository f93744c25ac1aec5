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
//   A ff3_pixel     one thread per voxel, 128-voxel tiles, each block
//                   walking a fixed set of tiles: the z1 build, then the
//                   MLP tail of train_common.cuh (ff_tail, shared with the
//                   2D kernel3): forward, loss, backward down to dz1
//                   (written [N, H]) and the block partials of loss, dW3,
//                   db3, dW2, db2. In bf16-dot mode at H = 64 this is
//                   ff3_pixel_mma on the tensor cores (ff_tail_mma, as
//                   K11's ff_pixel_mma); the caller names the body
//                   (`mma`, nic_torch/kernels/_widths.py kernel_body) and
//                   a body that does not take the mode is refused;
//   B node_volumes  (train_common.cuh, shared with the 3D kernel2) the
//                   node-resolution cotangents per crop: P-cell sums of
//                   dz1 at period f per axis, C1 trilinear-weighted sums
//                   at period 2f;
//   C ff3_sums      the slab, a1 and a2 sums of dz1 per crop, which the
//                   wrapper contracts with the PE tables (dW1's PE rows)
//                   and sums to db1;
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
// the bytes, the z1 build's nine gathers and the GELUs bound A.
//
// Widths: H = 64 and H = 128 are built (a narrower model is zero-padded
// to the next by the wrapper, nic_torch/kernels/_widths.py; bf16 dots at
// H = 64 run ff3_pixel_mma, fp32 dots and H = 128 ff3_pixel), and any F.
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

// ---- A in bf16-dot mode at H = 64: the same step on the tensor cores -----
//
// The layout of K11's ff_pixel_mma (train_fused_ff.cu): 256 threads (8
// warps), one 128-voxel tile at a time; a warp owns 16 voxels and each
// thread two of them (rows g and g + 8 of the warp, g = lane / 4) at 16 of
// the 64 units, the m16n8k16 accumulator layout of train_common.cuh. The
// thread builds those z1 entries on the CUDA cores with float2 loads (the P
// cell; the eight C1 taps, trilinear, a2 then a1 then the slab axis; the
// three PE rows; ff3_pixel's order of summation), adds eps W1 from
// noise_mma (W1^T in bf16) and hands z1 to ff_tail_mma, which writes dz1
// for node_volumes, ff3_sums and ff_epsgrad. The block's slice of dW2
// stays in registers over its tiles and is written once.
//
// Shared memory (bytes): h2b [64][132] bf16 16,896; dz3b, dz3, loss
// [7][132] 3,696; per-warp db2 [8][64] 2,048; W3, b2, b3 1,040; h1b and
// dz2b [128][72] bf16 36,864; W2^T and W2 [64][72] bf16 18,432: 78,976,
// plus with noise W1^T [64][pad16(F) + 8] bf16 (17,408 at F = 127): 96,384
// at the 3D protocol, so two blocks (16 warps) fit on an SM. From F = 1185
// on, W1 is read from device memory instead.
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
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int n = g.n;
  const int n3 = n * n * n;
  const size_t tab = static_cast<size_t>(g.crops) * n * H;  // one PE table
  const int ps = g.p_side, cs = g.c_side;
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
      const int p = static_cast<int>(pix[r]);
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
          pv + ((static_cast<size_t>(S / g.f) * ps + A / g.f) * ps + B / g.f) *
                   H;
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

// sums [3][crops][n][H]: axis 0 the slab sums (over a1, a2), axis 1 the
// a1 sums (over slab, a2), axis 2 the a2 sums (over slab, a1) of dz1.
// Thread = (axis, crop, line, h); each sums its n^2 values in a fixed
// order.
template <int H>
__global__ void ff3_sums(const float* __restrict__ dz1,
                         float* __restrict__ sums, Geo3 g) {
  const int h = threadIdx.x;
  const int idx = blockIdx.x * blockDim.y + threadIdx.y;
  const int n = g.n;
  if (idx >= 3 * g.crops * n) return;
  const int axis = idx / (g.crops * n), rem = idx % (g.crops * n);
  const int crop = rem / n, line = rem % n;
  const float* base = dz1 + static_cast<size_t>(crop) * n * n * n * H + h;
  // strides (in voxels) of the summed-over axes and of the line's axis
  const size_t st[3] = {static_cast<size_t>(n) * n, static_cast<size_t>(n), 1};
  const size_t sl = st[axis];
  const size_t su = st[axis == 0 ? 1 : 0], sv = st[axis == 2 ? 1 : 2];
  float acc = 0.0f;
  for (int u = 0; u < n; ++u) {
    float part = 0.0f;
    for (int v = 0; v < n; ++v)
      part += base[(line * sl + u * su + v * sv) * H];
    acc += part;
  }
  sums[static_cast<size_t>(idx) * H + h] = acc;
}

struct Args3 {
  const float *pv, *c1v, *w1, *pe, *w2, *b2, *w3, *b3, *tgt;
  const int* org;
  float *out, *dz1, *part_mlp, *win_p, *win_c1, *sums, *part_eps;
  int nblk_mlp, nblk_eps, mma;
  VolGeo vol;
  Geo3 g;
  cudaStream_t stream;
};

// shared memory of ff3_pixel: the staging tiles, W2, W3, b2, b3 and, with
// noise when it fits, W1 (2 x [H][132] + [7][132] + H^2 + 4H + 4 floats:
// 88,704 bytes at H = 64, 206,464 at H = 128; W1 adds 4 F H bytes, so it
// stays in device memory from F = 141 on at H = 64 and F = 51 at H = 128)
template <int H>
size_t ff3_smem(int nfeat, bool w1_smem) {
  return sizeof(float) * (2 * H * LDP + 7 * LDP + H * H + 3 * H + H + 4 +
                          (w1_smem ? static_cast<size_t>(nfeat) * H : 0));
}

// the per-voxel body the caller names (a.mma): ff3_pixel_mma for bf16 dots
// at H = 64, ff3_pixel for fp32 dots and for H = 128; any other pairing
// is refused
template <int H, bool BF16, int G>
cudaError_t launch_pixel(const Args3& a) {
  cudaError_t e;
  if constexpr (H == 64 && BF16) {
    if (!a.mma) return cudaErrorInvalidValue;
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
  } else {
    if (a.mma) return cudaErrorInvalidValue;
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
  e = launch_node_volumes(a.dz1, a.org, a.win_p, a.win_c1, a.vol, H,
                          a.stream);
  if (e != cudaSuccess) return e;
  const dim3 blk(H, 256 / H);
  const int lines = 3 * a.g.crops * a.g.n;
  ff3_sums<H><<<(lines + blk.y - 1) / blk.y, blk, 0, a.stream>>>(a.dz1,
                                                                  a.sums, a.g);
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
// (extents in train_common.cuh vol_geo), the PE sums [3][crops][n][H] and,
// with noise (nbits > 0), part_eps [nblk_eps][nfeat][H], for crops of n^3
// voxels (N = crops n^3, row-major per crop) at origins [crops][3] on the
// lattice of period f. p_vol [p_side^3][H], c1_vol [c_side^3][H], pe
// [3][crops][n][H].
extern "C" int nic_train_fused_ff3(
    const void* p_vol, const void* c1_vol, const void* w1, const void* pe,
    const void* w2, const void* b2, const void* w3, const void* b3,
    const void* tgt, const void* origins, void* out, void* dz1,
    void* part_mlp, void* win_p, void* win_c1, void* sums, void* part_eps,
    int crops, int n, int f, int p_side, int c_side, int hidden, int nfeat,
    int fslot, int bf16, int gelu_id, int mma, int nbits, int s0, int s1,
    int pixel_base, int nblk_mlp, int nblk_eps, void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 || p_side <= 0 || c_side <= 0 ||
      nfeat <= 0 || fslot < nfeat || nblk_mlp <= 0 ||
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
  g.w1_smem = nbits > 0 && (mma ? ff3_mma_smem(nfeat, true)
                                 : hidden == 64 ? ff3_smem<64>(nfeat, true)
                                                : ff3_smem<128>(nfeat, true)) <=
                               kMaxSmem;
  Args3 a;
  a.pv = static_cast<const float*>(p_vol);
  a.c1v = static_cast<const float*>(c1_vol);
  a.w1 = static_cast<const float*>(w1);
  a.pe = static_cast<const float*>(pe);
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
  a.sums = static_cast<float*>(sums);
  a.part_eps = static_cast<float*>(part_eps);
  a.nblk_mlp = nblk_mlp;
  a.nblk_eps = nblk_eps;
  a.mma = mma;
  a.vol = vol_geo(crops, n, f);
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
