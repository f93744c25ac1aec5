// The fused MLP train step on gather-built features in bf16-dot mode, on
// the tensor cores, for Hopper (sm_90a): mlp_pixel_mma, the per-pixel body
// that the dx kernel (K6) and the node-gradient kernels (K7, K9) of
// train_fused.cu launch when their dots take bf16 inputs at H = 64 (fp32
// dots and H = 128 keep train_fused.cu's mlp_pixel on the CUDA cores).
//
// Replaces, with mlp_pixel, the per-pixel work of the Pallas TPU kernels of
// nic/kernels/train_fused.py: `_kernel` (K6, pallas_call at :230),
// `_kernel_ng` (K7, :510; K8 the same math) and `_kernel_ng3` (K9, :1171;
// K10 the same math). For decoder-input rows x [N, F] and targets [N, 3]:
//
//   z1 = x W1 + b1,  out = sigmoid(gelu(gelu(z1) W2 + b2) W3 + b3),
//   loss = mean((out - t)^2)
//
// and the full backward down to the block's partial sums of loss, dW3,
// db3, dW2, db2, db1 and dW1 = x^T dz1, then dx = dz1 W1^T [N, F] (K6) or
// the fp32 dz1 [N, 64] that node_windows / node_volumes reduce (K7, K9).
//
// What bounds it: per pixel the dots z1 (2 F H FLOP), z2, dh1 and dW2
// (6 H H), the 64 -> 3 layer with its two backward products (18 H), dW1
// (2 F H) and, for K6, dx (2 F H): 44 kFLOP at F = 73 for K7, so 23 GFLOP
// at its 8 x 256^2 pixels, 0.024 ms on the bf16 tensor cores at 989
// TFLOP/s, against 0.17 GB of bytes (x read once, out and dz1 written),
// 0.051 ms at 3.35 TB/s: the bytes bound it. What holds it in practice is
// the CUDA-core work per pixel (the GELUs, the 64 -> 3 layer, staging x).
//
// Design. The rounding contract is the JAX kernels': every dot input (x,
// W1, W2, W3, h1, h2, dz3, dz2, and dz1 on its way into dW1 and dx) is
// rounded to bf16 and every sum stays fp32, so m16n8k16 bf16 products with
// fp32 accumulators compute the same products in another summation order.
// The layout is K11's ff_pixel_mma (train_fused_ff.cu): 256 threads, one
// 128-pixel tile at a time, a warp owning 16 pixels in the accumulator
// layout of train_common.cuh, two blocks per SM where shared memory allows
// (F <= 80; one at the 3D F = 127).
//   - x: the tile's [cnt, F] slab (rows not 16-byte aligned at F = 73,
//     79, 127) is read coalesced with scalar loads and rounded to bf16 once
//     into sX [128][ldc] (k padded to a multiple of 16 with zeros, zero rows
//     past the valid pixels); W1^T as bf16 [64][ldc], staged once.
//   - z1 = xb W1 + b1: one m16n8k16 product per k-slab (A from sX), then
//     ff_tail_mma (train_common.cuh, shared with K11 and K12), which leaves
//     the fp32 dz1 in z1's registers and, for K7/K9, writes it to device
//     memory.
//   - db1: from the fp32 dz1, per warp by shuffles, then over the warps in
//     order, as db2.
//   - dx = dz1b W1^T (K6): A from the dz1 registers rounded to bf16, B from
//     sW1t read with ldmatrix.trans; each warp stages its [16][32] result
//     blocks in shared memory and writes them as coalesced rows.
//   - dW1 = xb^T dz1b over the tile: dz1b staged as bf16 [128][72], both
//     operands read with ldmatrix.trans; warp w owns units 8w..8w+7 of
//     every feature and adds its tile sums to the block's partial row in
//     device memory (each element by one thread, tile after tile: a fixed
//     order, no atomics). The row's db1/dW1 stay in L2 across the tiles.
//   - Any F: up to 384 features x and W1^T are staged whole; past that in
//     chunks of 384, staged again for dW1 (x) and dx (W1^T).
// Invalid rows (the last, partial tile; path A's N = 8) are zero in x's
// tile and in dz1, so dW1, dW2 and db1 do not see them.
//
// The entry point does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "train_common.cuh"

namespace {

constexpr int kMaxFc = 384;  // features of x staged per chunk at most

// fc: features per chunk (a multiple of 16), ldc = fc + 8 the bf16 row
// stride of sX and sW1t (rows 16-byte aligned, ldmatrix rows on distinct
// banks)
struct MmaShape {
  int npix, feat, write_dx, fc, ldc;
  float inv_total;
};

// Shared memory (bytes): h2b [64][132] bf16 16,896; dz3b, dz3, loss
// [7][132] 3,696; per-warp db2, then db1 [8][64] 2,048; W3, b1, b2, b3
// 1,296; h1b and dz2b, then dz1b [128][72] bf16 36,864 (h1b's also stages
// dx); W2^T and W2 [64][72] bf16 18,432: 79,232; then W1^T [64][ldc] and x
// [128][ldc] bf16, 384 ldc: 113,024 at F = 73 or 79 (two blocks per SM),
// 131,456 at F = 127 (one).
constexpr size_t kMmaFixedSmem = 79232;

size_t mma_smem(int ldc) {
  return kMmaFixedSmem +
         static_cast<size_t>(TP + 64) * ldc * sizeof(__nv_bfloat16);
}

// x's columns [c0, c0 + nf) of the tile's [cnt, F] slab, rounded to bf16,
// into sX [TP][ldc]: kp = pad16(nf) columns, zero past nf and in the rows
// from cnt on; consecutive threads read consecutive columns of a row
__device__ __forceinline__ void stage_x(__nv_bfloat16* sX, const float* xt,
                                        int F, int c0, int nf, int kp,
                                        int cnt, int ldc) {
  int p = threadIdx.x / kp, j = threadIdx.x % kp;
  const int dp = MT / kp, dj = MT % kp;
  while (p < TP) {
    const float v = (p < cnt && j < nf)
                        ? xt[static_cast<size_t>(p) * F + c0 + j]
                        : 0.0f;
    sX[p * ldc + j] = __float2bfloat16_rn(v);
    p += dp;
    j += dj;
    if (j >= kp) {
      j -= kp;
      ++p;
    }
  }
}

// W1's rows [c0, c0 + nf) transposed into sW1t [64][ldc], rounded to bf16,
// zero in columns nf..kp-1
__device__ __forceinline__ void stage_w1t(__nv_bfloat16* sW1t,
                                          const float* w1, int c0, int nf,
                                          int kp, int ldc) {
  for (int i = threadIdx.x; i < 64 * kp; i += MT) {
    const int j = i >> 6, h = i & 63;
    sW1t[h * ldc + j] = __float2bfloat16_rn(
        j < nf ? w1[static_cast<size_t>(c0 + j) * 64 + h] : 0.0f);
  }
}

// partial row layout (floats): [loss, db3[3], dW3[64][3], db2[64],
// dW2[64][64], db1[64], dW1[F][64]], mlp_pixel's
template <int G>
__global__ void __launch_bounds__(MT, 2)
mlp_pixel_mma(const float* __restrict__ x, const float* __restrict__ tgt,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              float* __restrict__ out, float* __restrict__ grad_out,
              float* __restrict__ part, MmaShape s) {
  constexpr int H = 64;
  extern __shared__ float4 smem4[];
  auto* sB = reinterpret_cast<__nv_bfloat16*>(smem4);  // h2b [H][LDP]
  float* sD = reinterpret_cast<float*>(sB + H * LDP);  // [7][LDP]
  float* sDb = sD + 7 * LDP;                           // [8][H]
  float* sW3 = sDb + 8 * H;                            // [H][3]
  float* sb1 = sW3 + 3 * H;
  float* sb2 = sb1 + H;
  float* sb3 = sb2 + H;                                // [4]
  auto* sH1 = reinterpret_cast<__nv_bfloat16*>(sb3 + 4);  // [TP][LDB]
  __nv_bfloat16* sDZ = sH1 + TP * LDB;                    // [TP][LDB]
  __nv_bfloat16* sW2t = sDZ + TP * LDB;                   // [H][LDB] (out, in)
  __nv_bfloat16* sW2 = sW2t + H * LDB;                    // [H][LDB] (in, out)
  __nv_bfloat16* sW1t = sW2 + H * LDB;                    // [H][ldc]
  __nv_bfloat16* sX = sW1t + H * s.ldc;                   // [TP][ldc]
  float* sDx = reinterpret_cast<float*>(sH1);  // dx blocks [8][16][36]
  const int F = s.feat, FC = s.fc, ldc = s.ldc;
  const int nch = (F + FC - 1) / FC;

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += MT) {
    const int k = i / H, j = i % H;
    const __nv_bfloat16 w = __float2bfloat16_rn(w2[i]);
    sW2[k * LDB + j] = w;
    sW2t[j * LDB + k] = w;
  }
  for (int i = tid; i < H * 3; i += MT) sW3[i] = bf16_round(w3[i]);
  for (int i = tid; i < H; i += MT) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  if (tid < 3) sb3[tid] = b3[tid];
  if (nch == 1) stage_w1t(sW1t, w1, 0, F, pad16(F), ldc);
  __syncthreads();

  const TailMma ts{sB, sD, sDb, sH1, sDZ, sW2t, sW2, sW3, sb2, sb3};
  const size_t part_len = 4 + 5 * H + H * H + static_cast<size_t>(F) * H;
  float* mypart = part + blockIdx.x * part_len;
  float* db1p = mypart + 4 + 4 * H + H * H;
  float* dW1p = db1p + H;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const int row0 = 16 * warp + gq;
  const int tiles = (s.npix + TP - 1) / TP;
  float dw2[4][4] = {};
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int base = tile * TP;
    const int cnt = min(TP, s.npix - base);
    const float* xt = x + static_cast<size_t>(base) * F;
    bool valid[2];
    size_t pix[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      valid[r] = row0 + 8 * r < cnt;
      pix[r] = valid[r] ? static_cast<size_t>(base + row0 + 8 * r) : 0;
    }
    // layer 1: z1 = xb W1 + b1, x staged a chunk of features at a time
    float z1[8][4] = {};
    for (int c0 = 0; c0 < F; c0 += FC) {
      const int nf = min(FC, F - c0), kp = pad16(nf);
      __syncthreads();
      stage_x(sX, xt, F, c0, nf, kp, cnt, ldc);
      if (nch > 1) stage_w1t(sW1t, w1, c0, nf, kp, ldc);
      __syncthreads();
      for (int k0 = 0; k0 < kp; k0 += 16) {
        const __nv_bfloat16* xa = sX + row0 * ldc + k0 + 2 * q;
        const uint32_t a[4] = {ld_u32(xa), ld_u32(xa + 8 * ldc),
                               ld_u32(xa + 8), ld_u32(xa + 8 * ldc + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* w = sW1t + (8 * nt + gq) * ldc + k0 + 2 * q;
          mma16816(z1[nt], a, ld_u32(w), ld_u32(w + 8));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) z1[nt][e] += sb1[8 * nt + 2 * q + (e & 1)];
    ff_tail_mma<G>(z1, valid, pix, ts, tgt, out,
                   s.write_dx ? nullptr : grad_out, mypart, first,
                   s.inv_total, dw2);

    // z1 holds dz1 now (fp32, zero for invalid pixels). dz1b: dx's A
    // operand, and staged for dW1; db1 over the warp's pixels
    uint32_t ad[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float b = z1[nt][i] + z1[nt][2 + i];
        b += __shfl_xor_sync(0xffffffffu, b, 4);
        b += __shfl_xor_sync(0xffffffffu, b, 8);
        b += __shfl_xor_sync(0xffffffffu, b, 16);
        if (gq == 0) sDb[warp * H + 8 * nt + 2 * q + i] = b;
      }
      const uint32_t lo = pack_bf16(z1[nt][0], z1[nt][1]);
      const uint32_t hi = pack_bf16(z1[nt][2], z1[nt][3]);
      *reinterpret_cast<uint32_t*>(sDZ + row0 * LDB + 8 * nt + 2 * q) = lo;
      *reinterpret_cast<uint32_t*>(sDZ + (row0 + 8) * LDB + 8 * nt + 2 * q) =
          hi;
      ad[nt >> 1][(nt & 1) * 2] = lo;
      ad[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
    __syncthreads();

    // db1 over the warps in order (threads 128..191)
    if (tid >= 128 && tid < 128 + H) {
      const int j = tid - 128;
      float a = 0.0f;
      for (int w = 0; w < MT / 32; ++w) a += sDb[w * H + j];
      db1p[j] = first ? a : db1p[j] + a;
    }

    // dx = dz1b W1^T (K6), 32 features at a time: the warp's [16][32]
    // block staged in sDx, then written as coalesced rows
    if (s.write_dx) {
      float* st = sDx + warp * 16 * 36;
      float* dxt = grad_out + static_cast<size_t>(base) * F;
      for (int c0 = 0; c0 < F; c0 += FC) {
        const int nf = min(FC, F - c0), kp = pad16(nf);
        if (nch > 1) {
          __syncthreads();
          stage_w1t(sW1t, w1, c0, nf, kp, ldc);
          __syncthreads();
        }
        for (int n0 = 0; n0 < kp; n0 += 32) {
          float d[4][4] = {};
#pragma unroll
          for (int kb = 0; kb < 4; ++kb)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              if (n0 + 16 * np >= kp) continue;
              uint32_t b[4];
              ldsm_x4_trans(b, sW1t + (16 * kb + 8 * (li & 1) + lr) * ldc +
                                   n0 + 16 * np + 8 * (li >> 1));
              mma16816(d[2 * np], ad[kb], b[0], b[1]);
              mma16816(d[2 * np + 1], ad[kb], b[2], b[3]);
            }
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(st + (gq + 8 * r) * 36 + 8 * t +
                                         2 * q) =
                  make_float2(d[t][2 * r], d[t][2 * r + 1]);
          __syncwarp();
          const int nc = min(32, nf - n0);
          for (int rr = 0; rr < 16; ++rr) {
            const int p = 16 * warp + rr;
            if (p < cnt && lane < nc)
              dxt[static_cast<size_t>(p) * F + c0 + n0 + lane] =
                  st[rr * 36 + lane];
          }
          __syncwarp();
        }
      }
    }

    // dW1 += xb^T dz1b over the tile: warp w owns units 8w..8w+7 of every
    // feature; dz1b's fragments for the tile's 8 slabs of 16 pixels stay
    // in registers
    {
      uint32_t bz[8][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldsm_x4_trans(b, sDZ + (32 * kk + 8 * li + lr) * LDB + 8 * warp);
        bz[2 * kk][0] = b[0];
        bz[2 * kk][1] = b[1];
        bz[2 * kk + 1][0] = b[2];
        bz[2 * kk + 1][1] = b[3];
      }
      for (int c0 = 0; c0 < F; c0 += FC) {
        const int nf = min(FC, F - c0), kp = pad16(nf);
        if (nch > 1) {
          __syncthreads();
          stage_x(sX, xt, F, c0, nf, kp, cnt, ldc);
          __syncthreads();
        }
        for (int mt = 0; mt < kp / 16; ++mt) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < TP / 16; ++ks) {
            uint32_t a[4];
            ldsm_x4_trans(a, sX + (16 * ks + 8 * (li >> 1) + lr) * ldc +
                                 16 * mt + 8 * (li & 1));
            mma16816(acc, a, bz[ks][0], bz[ks][1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int f = c0 + 16 * mt + gq + 8 * r;
            if (f < F) {
              float2* dst = reinterpret_cast<float2*>(
                  dW1p + static_cast<size_t>(f) * H + 8 * warp + 2 * q);
              const float2 v = make_float2(acc[2 * r], acc[2 * r + 1]);
              *dst = first ? v : make_float2(dst->x + v.x, dst->y + v.y);
            }
          }
        }
      }
    }
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

template <int G>
cudaError_t launch_mma(const float* x, const float* tgt, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       const float* w3, const float* b3, float* out,
                       float* grad_out, float* part, const MmaShape& s,
                       int nblk, cudaStream_t stream) {
  const size_t smem = mma_smem(s.ldc);
  auto kern = mlp_pixel_mma<G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<nblk, MT, smem, stream>>>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                   grad_out, part, s);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

}  // namespace

// mlp_pixel_mma over N = npix rows of x [N, F] at H = 64: out [N, 3], the
// per-block partials part [nblk][4 + 5*64 + 64*64 + F*64] (layout above)
// and grad_out: dx [N, F] when write_dx, else dz1 [N, 64]. Called by
// train_fused.cu's entry points, which run the node reductions after it.
extern "C" int nic_mlp_pixel_mma(const float* x, const float* tgt,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2,
                                 const float* w3, const float* b3, float* out,
                                 float* grad_out, float* part, int npix,
                                 int feat, int write_dx, int gelu_id, int nblk,
                                 void* stream) {
  if (npix <= 0 || feat <= 0 || nblk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MmaShape s;
  s.npix = npix;
  s.feat = feat;
  s.write_dx = write_dx;
  s.fc = pad16(feat) < kMaxFc ? pad16(feat) : kMaxFc;
  s.ldc = s.fc + 8;
  s.inv_total = 1.0f / (static_cast<float>(npix) * 3.0f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (gelu_id == kErf)
    e = launch_mma<kErf>(x, tgt, w1, b1, w2, b2, w3, b3, out, grad_out, part,
                         s, nblk, st);
  if (gelu_id == kPoly)
    e = launch_mma<kPoly>(x, tgt, w1, b1, w2, b2, w3, b3, out, grad_out,
                          part, s, nblk, st);
  return static_cast<int>(e);
}
