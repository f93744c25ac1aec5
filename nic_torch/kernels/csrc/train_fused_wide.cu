// The fused MLP train step on gather-built features at any hidden width
// past 128, for Hopper (sm_90a): mlp_pixel_wide, the per-pixel body that
// the dx kernel (K6) and the node-gradient kernels (K7, K9) of
// train_fused.cu launch when H > 128 (H = 64 and 128 run mlp_pixel or
// mlp_pixel_mma there).
//
// Replaces, with those bodies, the per-pixel work of the Pallas TPU kernels
// of nic/kernels/train_fused.py: `_kernel` (K6, pallas_call at :230),
// `_kernel_ng` (K7, :510; K8 the same math) and `_kernel_ng3` (K9, :1171;
// K10 the same math), whose gates check no hidden width. For decoder-input
// rows x [N, F] and targets [N, 3]:
//
//   z1 = x W1 + b1,  out = sigmoid(gelu(gelu(z1) W2 + b2) W3 + b3),
//   loss = mean((out - t)^2)
//
// and the full backward down to the block's partial sums of loss, dW3,
// db3, dW2, db2, db1 and dW1 = x^T dz1, then dx = dz1 W1^T [N, F] (K6) or
// the fp32 dz1 [N, H] that node_windows / node_volumes reduce (K7, K9).
// The rounding contract is mlp_pixel's: with bf16 dot inputs x, W1, W2,
// W3, h1, h2, dz3, dz2 and dz1 are rounded to bf16 on their way into a dot
// and every sum stays fp32.
//
// Design: H is a runtime multiple of 64, walked in 64-unit column blocks.
// A block of 256 threads takes a tile of R pixels at a time (R = 64, 32 or
// 16: the largest whose tiles fit in shared memory at this H) and keeps
// the tile's z1 (then dz1) and z2 (then dz2) in shared memory as fp32
// [R][H]. Every product is a 64-column block: thread (c, pg) = (tid % 64,
// tid / 64) owns column c of the block for the tile's rows pg, pg + 4, ...
// (RPT = R / 4 accumulators), reads the activation rows by broadcast and
// the weight tile conflict-free. W2 is streamed through shared memory in
// 64 x 64 tiles (stride 65, so both W2 and W2^T read conflict-free), W1 and
// x by 64-feature chunks; h1 = gelu(z1) is formed once per 64-unit block
// into a [R][64] tile. The 64 -> 3 layer reduces over the columns with
// warp shuffles in a fixed order; the per-unit passes (dz2 = dh2 gelu'(z2)
// with dW3 and db2, then db1) give a thread one unit and walk the tile's
// rows in order. Every partial sum is set on the block's first tile and
// added to after it (one thread per element), so two runs give identical
// bits; there are no atomics. Rows past N are zero in x and get dz3 = 0,
// so they add nothing.
// Shared memory, in floats: 2 R H + 142 R + 5 H + 4164; at R = 16 a tile
// fits up to H = 1344, the widest this body takes (nic_torch/kernels/
// _widths.py WIDEST). It runs on the CUDA cores for both dot types; a
// tensor-core wide body is later work.
//
// Entry point nic_mlp_pixel_wide (called by train_fused.cu's entry
// points). It does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "train_common.cuh"

namespace {

constexpr int WT = 256;   // threads of a block
constexpr int CB = 64;    // columns of a block of the hidden or feature axis
constexpr int LDW = 65;   // row stride of the staged 64 x 64 weight tile

// shared memory of a tile of r rows at hidden width h, in floats
__host__ __device__ inline size_t wide_floats(int r, int h) {
  return 2 * static_cast<size_t>(r) * h + 142 * static_cast<size_t>(r) +
         5 * static_cast<size_t>(h) + 4164;
}

struct WideShape {
  int npix, feat, hidden, write_dx;
  float inv_total;
};

// x columns [f0, f0 + 64) of the tile's rows, rounded (zero past cnt, F)
template <bool BF16, int R>
__device__ __forceinline__ void wide_stage_x(float* sX, const float* xt,
                                             int F, int f0, int cnt) {
  for (int i = threadIdx.x; i < R * CB; i += WT) {
    const int p = i / CB, j = i % CB;
    sX[i] = (p < cnt && f0 + j < F)
                ? cd<BF16>(xt[static_cast<size_t>(p) * F + f0 + j])
                : 0.0f;
  }
}

// the 64 x 64 tile w[r0 + k][c0 + c] of a row-major [rows][ld] matrix into
// sW[k][c], rounded (zero past rows)
template <bool BF16>
__device__ __forceinline__ void wide_stage_w(float* sW, const float* w,
                                             int rows, int ld, int r0,
                                             int c0) {
  for (int i = threadIdx.x; i < CB * CB; i += WT) {
    const int k = i / CB, c = i % CB;
    sW[k * LDW + c] =
        r0 + k < rows ? cd<BF16>(w[static_cast<size_t>(r0 + k) * ld + c0 + c])
                      : 0.0f;
  }
}

// a partial-sum element: set on the block's first tile, added to after
__device__ __forceinline__ void put(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// partial row layout (floats): [loss, db3[3], dW3[H][3], db2[H], dW2[H][H],
// db1[H], dW1[F][H]], as mlp_pixel's
template <bool BF16, int G, int RPT>
__global__ void __launch_bounds__(WT, 1)
mlp_pixel_wide(const float* __restrict__ x, const float* __restrict__ tgt,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               float* __restrict__ out, float* __restrict__ grad_out,
               float* __restrict__ part, WideShape s) {
  constexpr int R = 4 * RPT;
  extern __shared__ float4 smem4[];
  const int H = s.hidden, F = s.feat, NB = H / CB;
  float* sZ1 = reinterpret_cast<float*>(smem4);  // z1, then dz1 [R][H]
  float* sZ2 = sZ1 + R * H;                      // z2 + b2, then dz2 [R][H]
  float* sH = sZ2 + R * H;                       // h1b of a block [R][64]
  float* sX = sH + R * CB;                       // xb of a chunk [R][64]
  float* sW = sX + R * CB;                       // weight tile [64][LDW]
  float* sD = sW + CB * LDW;                     // dz3b[3], dz3[3], loss [8][R]
  float* sO = sD + 8 * R;                        // o3 halves [6][R]
  float* sb1 = sO + 6 * R;
  float* sb2 = sb1 + H;
  float* sW3 = sb2 + H;                          // [H][3]
  float* sb3 = sW3 + 3 * H;                      // [4]

  const int tid = threadIdx.x;
  const int c = tid % CB, pg = tid / CB;
  const int lane = tid % 32, half = (tid / 32) % 2;
  for (int i = tid; i < H; i += WT) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  for (int i = tid; i < 3 * H; i += WT) sW3[i] = cd<BF16>(w3[i]);
  if (tid < 3) sb3[tid] = b3[tid];

  const size_t part_len = 4 + 5 * static_cast<size_t>(H) +
                          static_cast<size_t>(H) * H +
                          static_cast<size_t>(F) * H;
  float* mypart = part + blockIdx.x * part_len;
  float* dW3 = mypart + 4;
  float* db2 = mypart + 4 + 3 * H;
  float* dW2 = mypart + 4 + 4 * H;
  float* db1 = dW2 + static_cast<size_t>(H) * H;
  float* dW1 = db1 + H;
  const int tiles = (s.npix + R - 1) / R;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int base = tile * R;
    const int cnt = min(R, s.npix - base);
    const float* xt = x + static_cast<size_t>(base) * F;

    // layer 1: z1 = xb W1 + b1, x and W1 in 64-feature chunks
    for (int f0 = 0; f0 < F; f0 += CB) {
      __syncthreads();
      wide_stage_x<BF16, R>(sX, xt, F, f0, cnt);
      for (int kb = 0; kb < NB; ++kb) {
        __syncthreads();
        wide_stage_w<BF16>(sW, w1, F, H, f0, kb * CB);
        __syncthreads();
        float acc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
        for (int j = 0; j < CB; ++j) {
          const float w = sW[j * LDW + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            acc[i] = fmaf(sX[(pg + 4 * i) * CB + j], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float* z = sZ1 + (pg + 4 * i) * H + kb * CB + c;
          *z = (f0 == 0 ? acc[i] : *z + acc[i]) +
               (f0 + CB >= F ? sb1[kb * CB + c] : 0.0f);
        }
      }
    }

    // layer 2: z2 = h1b W2 + b2, h1b formed once per 64-unit block
    for (int kb = 0; kb < NB; ++kb) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        sH[(pg + 4 * i) * CB + c] =
            cd<BF16>(gelu_f<G>(sZ1[(pg + 4 * i) * H + kb * CB + c]));
      for (int jb = 0; jb < NB; ++jb) {
        __syncthreads();
        wide_stage_w<BF16>(sW, w2, H, H, kb * CB, jb * CB);
        __syncthreads();
        float acc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
        for (int k = 0; k < CB; ++k) {
          const float w = sW[k * LDW + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            acc[i] = fmaf(sH[(pg + 4 * i) * CB + k], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float* z = sZ2 + (pg + 4 * i) * H + jb * CB + c;
          *z = (kb == 0 ? acc[i] : *z + acc[i]) +
               (kb == NB - 1 ? sb2[jb * CB + c] : 0.0f);
        }
      }
    }
    __syncthreads();

    // layer 3: o3 = h2b W3 per row, summed over the 64 columns by warp
    // shuffles (each warp holds 32 of them), then over the two warps
#pragma unroll 1
    for (int i = 0; i < RPT; ++i) {
      const int p = pg + 4 * i;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int jb = 0; jb < NB; ++jb) {
        const int j = jb * CB + c;
        const float h2 = cd<BF16>(gelu_f<G>(sZ2[p * H + j]));
        a0 = fmaf(h2, sW3[j * 3 + 0], a0);
        a1 = fmaf(h2, sW3[j * 3 + 1], a1);
        a2 = fmaf(h2, sW3[j * 3 + 2], a2);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, off);
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        sO[(3 * half + 0) * R + p] = a0;
        sO[(3 * half + 1) * R + p] = a1;
        sO[(3 * half + 2) * R + p] = a2;
      }
    }
    __syncthreads();
    // sigmoid, loss and dz3 per row
    if (tid < R) {
      const int p = tid;
      float lossv = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        float dz3 = 0.0f;
        if (p < cnt) {
          const float o3 = sO[cc * R + p] + sO[(3 + cc) * R + p];
          const float ov = 1.0f / (1.0f + expf(-(o3 + sb3[cc])));
          const size_t idx = static_cast<size_t>(base + p) * 3 + cc;
          out[idx] = ov;
          const float diff = ov - tgt[idx];
          lossv = fmaf(diff, diff, lossv);
          dz3 = (2.0f * s.inv_total) * diff * ov * (1.0f - ov);
        }
        sD[cc * R + p] = cd<BF16>(dz3);
        sD[(3 + cc) * R + p] = dz3;
      }
      sD[6 * R + p] = lossv;
    }
    __syncthreads();

    // per unit j: dW3 = h2b^T dz3b, dz2 = (dz3b W3^T) gelu'(z2) in place
    // of z2, db2 = the sum of dz2; then db3 and the loss
    for (int j = tid; j < H; j += WT) {
      const float w0 = sW3[j * 3 + 0], w1v = sW3[j * 3 + 1],
                  w2v = sW3[j * 3 + 2];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, db = 0.0f;
      for (int p = 0; p < R; ++p) {
        const float z = sZ2[p * H + j];
        const float h2 = cd<BF16>(gelu_f<G>(z));
        const float d0 = sD[p], d1 = sD[R + p], d2 = sD[2 * R + p];
        a0 = fmaf(h2, d0, a0);
        a1 = fmaf(h2, d1, a1);
        a2 = fmaf(h2, d2, a2);
        const float dz = (d0 * w0 + d1 * w1v + d2 * w2v) * gelu_d<G>(z);
        sZ2[p * H + j] = dz;
        db += dz;
      }
      put(dW3 + j * 3 + 0, a0, first);
      put(dW3 + j * 3 + 1, a1, first);
      put(dW3 + j * 3 + 2, a2, first);
      put(db2 + j, db, first);
    }
    if (tid < 4) {
      const float* src = sD + (tid < 3 ? 3 + tid : 6) * R;
      float a = 0.0f;
      for (int p = 0; p < R; ++p) a += src[p];
      if (tid == 3) a *= s.inv_total;
      put(mypart + (tid < 3 ? 1 + tid : 0), a, first);
    }

    // layer 2 backward, per 64-unit block kb of h1: dh1 = dz2b W2^T and
    // dW2 = h1b^T dz2b over the W2 tiles (kb, jb); then dz1 = dh1 gelu'(z1)
    // in place of z1
    for (int kb = 0; kb < NB; ++kb) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        sH[(pg + 4 * i) * CB + c] =
            cd<BF16>(gelu_f<G>(sZ1[(pg + 4 * i) * H + kb * CB + c]));
      float dh[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dh[i] = 0.0f;
      for (int jb = 0; jb < NB; ++jb) {
        __syncthreads();
        wide_stage_w<BF16>(sW, w2, H, H, kb * CB, jb * CB);
        __syncthreads();
        // dh1[p][kb 64 + c] += sum_j dz2b[p][jb 64 + j] W2[kb 64 + c][jb 64 + j]
        for (int j = 0; j < CB; ++j) {
          const float w = sW[c * LDW + j];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            dh[i] = fmaf(cd<BF16>(sZ2[(pg + 4 * i) * H + jb * CB + j]), w,
                         dh[i]);
        }
        // dW2[kb 64 + pg + 4 m][jb 64 + c] over the tile's rows
        float acc[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) acc[m] = 0.0f;
        for (int p = 0; p < R; ++p) {
          const float d = cd<BF16>(sZ2[p * H + jb * CB + c]);
#pragma unroll
          for (int m = 0; m < 16; ++m)
            acc[m] = fmaf(sH[p * CB + pg + 4 * m], d, acc[m]);
        }
#pragma unroll
        for (int m = 0; m < 16; ++m)
          put(dW2 + static_cast<size_t>(kb * CB + pg + 4 * m) * H + jb * CB + c,
              acc[m], first);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float* z = sZ1 + (pg + 4 * i) * H + kb * CB + c;
        *z = dh[i] * gelu_d<G>(*z);
      }
    }
    __syncthreads();

    // dz1 out (K7, K9), db1 per unit
    if (!s.write_dx)
      for (int i = 0; i < RPT; ++i) {
        const int p = pg + 4 * i;
        if (p < cnt)
          for (int kb = 0; kb < NB; ++kb)
            grad_out[static_cast<size_t>(base + p) * H + kb * CB + c] =
                sZ1[p * H + kb * CB + c];
      }
    for (int j = tid; j < H; j += WT) {
      float a = 0.0f;
      for (int p = 0; p < R; ++p) a += sZ1[p * H + j];
      put(db1 + j, a, first);
    }

    // dW1 = xb^T dz1b and dx = dz1b W1^T, by 64-feature chunks of x and W1
    for (int f0 = 0; f0 < F; f0 += CB) {
      __syncthreads();
      wide_stage_x<BF16, R>(sX, xt, F, f0, cnt);
      float dx[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dx[i] = 0.0f;
      for (int kb = 0; kb < NB; ++kb) {
        __syncthreads();
        wide_stage_w<BF16>(sW, w1, F, H, f0, kb * CB);
        __syncthreads();
        float acc[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) acc[m] = 0.0f;
        for (int p = 0; p < R; ++p) {
          const float d = cd<BF16>(sZ1[p * H + kb * CB + c]);
#pragma unroll
          for (int m = 0; m < 16; ++m)
            acc[m] = fmaf(sX[p * CB + pg + 4 * m], d, acc[m]);
        }
#pragma unroll
        for (int m = 0; m < 16; ++m)
          if (f0 + pg + 4 * m < F)
            put(dW1 + static_cast<size_t>(f0 + pg + 4 * m) * H + kb * CB + c,
                acc[m], first);
        if (s.write_dx)
          for (int k = 0; k < CB; ++k) {
            const float w = sW[c * LDW + k];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              dx[i] = fmaf(cd<BF16>(sZ1[(pg + 4 * i) * H + kb * CB + k]), w,
                           dx[i]);
          }
      }
      if (s.write_dx && f0 + c < F)
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if (pg + 4 * i < cnt)
            grad_out[static_cast<size_t>(base + pg + 4 * i) * F + f0 + c] =
                dx[i];
    }
    __syncthreads();
  }
}

template <bool BF16, int G, int RPT>
cudaError_t launch_wide(const float* x, const float* tgt, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        const float* w3, const float* b3, float* out,
                        float* grad_out, float* part, const WideShape& s,
                        int nblk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * wide_floats(4 * RPT, s.hidden);
  auto kern = mlp_pixel_wide<BF16, G, RPT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<nblk, WT, smem, stream>>>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                   grad_out, part, s);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

template <bool BF16, int G>
cudaError_t launch_rows(const float* x, const float* tgt, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        const float* w3, const float* b3, float* out,
                        float* grad_out, float* part, const WideShape& s,
                        int nblk, cudaStream_t stream) {
  // the largest tile that fits at this width
  if (sizeof(float) * wide_floats(64, s.hidden) <= kMaxSmem)
    return launch_wide<BF16, G, 16>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                    grad_out, part, s, nblk, stream);
  if (sizeof(float) * wide_floats(32, s.hidden) <= kMaxSmem)
    return launch_wide<BF16, G, 8>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                   grad_out, part, s, nblk, stream);
  if (sizeof(float) * wide_floats(16, s.hidden) <= kMaxSmem)
    return launch_wide<BF16, G, 4>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                   grad_out, part, s, nblk, stream);
  return cudaErrorInvalidValue;  // past the widest width
}

}  // namespace

// mlp_pixel_wide over N = npix rows of x [N, F] at hidden width H (a
// multiple of 64 above 128): out [N, 3], the per-block partials part
// [nblk][4 + 5H + H*H + F*H] (layout above) and grad_out: dx [N, F] when
// write_dx, else dz1 [N, H]. Called by train_fused.cu's entry points,
// which run the node reductions after it.
extern "C" int nic_mlp_pixel_wide(const float* x, const float* tgt,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  const float* w3, const float* b3,
                                  float* out, float* grad_out, float* part,
                                  int npix, int feat, int hidden,
                                  int write_dx, int bf16, int gelu_id,
                                  int nblk, void* stream) {
  if (npix <= 0 || feat <= 0 || nblk <= 0 || hidden <= 128 || hidden % CB)
    return static_cast<int>(cudaErrorInvalidValue);
  WideShape s;
  s.npix = npix;
  s.feat = feat;
  s.hidden = hidden;
  s.write_dx = write_dx;
  s.inv_total = 1.0f / (static_cast<float>(npix) * 3.0f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NIC_WIDE(BF, G)                                                      \
  return static_cast<int>(launch_rows<BF, G>(x, tgt, w1, b1, w2, b2, w3, b3, \
                                             out, grad_out, part, s, nblk,  \
                                             st))
  if (bf16 && gelu_id == kErf) NIC_WIDE(true, kErf);
  if (bf16 && gelu_id == kPoly) NIC_WIDE(true, kPoly);
  if (!bf16 && gelu_id == kErf) NIC_WIDE(false, kErf);
  if (!bf16 && gelu_id == kPoly) NIC_WIDE(false, kPoly);
#undef NIC_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}
