// The fused MLP train step on gather-built features for Hopper (sm_90a):
// the dx kernel (TRAIN_FORWARD=kernel) and the node-gradient kernel
// (kernel2).
//
// Replaces the Pallas TPU kernels of nic/kernels/train_fused.py:
//   nic_train_fused_dx   `_kernel` (launched by `_impl`, pallas_call at :230)
//   nic_train_fused_ng   `_kernel_ng` (`_impl_ng`, pallas_call at :510) and
//                        its lane-packed twin `_kernel_ng2` (`_impl_ng2`,
//                        :762), which is the same math laid out for the
//                        TPU's 128-lane registers and is not carried over;
//   nic_train_fused_ng3  the 3D `_kernel_ng3` (`_impl_ng3`, :1171) and its
//                        lane-packed twin `_kernel_ng3_2` (`_impl_ng3_2`,
//                        :1345), likewise one kernel here.
//
// For decoder-input rows x [N, F] (the gather's features, QAT noise
// already added) and targets [N, 3]:
//
//   z1 = x W1 + b1,  out = sigmoid(gelu(gelu(z1) W2 + b2) W3 + b3),
//   loss = mean((out - t)^2)
//
// and the full backward. Each entry point runs one of four per-pixel
// bodies, which write the same outputs: in bf16-dot mode at H = 64
// mlp_pixel_mma (train_fused_mma.cu) and from H = 128 to 256
// mlp_pixel_mma_wide (train_fused_mma_wide.cu, W1 and W2 given as bf16) on
// the tensor cores; in fp32-dot mode at H = 64 and 128 mlp_pixel, below,
// and past H = 128 (bf16 dots past 256) mlp_pixel_wide
// (train_fused_wide.cu, any multiple of 64 up to 1344), on the CUDA
// cores. The caller names the body (`body`, from
// nic_torch/kernels/_widths.py kernel_body) and a body that does not take
// the mode or the width is refused. mlp_pixel: one thread per pixel,
// 128-pixel tiles, each block walking a fixed set of tiles. It stages the
// tile's x rows transposed in shared memory (coalesced reads of the
// contiguous [128, F] slab), builds z1, runs the forward, the loss and the
// backward down to dz1 (as K12's ff3_pixel does), and keeps its
// block's partial sums of loss, dW3, db3, dW2, db2, db1 and dW1 = x^T dz1
// in its own slot. A runtime flag picks what leaves the kernel (either
// body):
//   dx  dx = dz1 W1^T [N, F], staged through shared memory and written
//       coalesced; it flows back into the gather's scatter-add (K6);
//   ng  dz1 [N, H] in fp32, which node_windows (train_common.cuh, shared
//       with kernel3) reduces per crop window to the node-resolution
//       cotangents: P-cell sums of dz1 at period f and the C1
//       interpolation-weighted sums at period 2f (K7); in 3D node_volumes
//       + node_volume_corners do the same per crop volume, trilinear for
//       C1 (K9, shared with the 3D kernel3). No [N, F] cotangent exists.
// Surgical bf16 as in JAX: in bf16-dot mode x, h1, h2, the weights and
// the cotangents dz3, dz2, dz1 on their way into a dot are rounded with
// __float2bfloat16_rn; every sum and every elementwise op stays fp32, and
// the node reductions and db1 read dz1 in fp32.
//
// Every reduction is a fixed-order sum (no atomics): per-block partials
// are summed afterwards in a fixed order, so two runs are bit-identical.
// The kernel masks the last, partial tile, so any N works (path A's
// thumbnail LODs launch N = 8).
//
// What bounds it: per pixel the products z1 (F x 64), z2 and dh1 (64 x
// 64), the dW2 and dW1 reductions and, for dx, dz1 W1^T: ~22 kFMA (~26
// with dx). At the flagship N = 524,288 that is 6 N (F H + H H + 3 H) =
// 28.2 GFLOP with dx (the JAX cost model) and 4 N F H + 6 N (H H + 3 H) =
// 23.3 GFLOP without: 0.42 or 0.35 ms on the fp32 CUDA cores at
// 67 TFLOP/s. The bytes (x read once, out written, and dx for the dx
// kernel: 166 MB or 319 MB) take 0.05 or 0.10 ms at 3.35 TB/s. So the
// fp32 arithmetic bounds mlp_pixel, as it bounded K11; in bf16-dot mode
// the products run on the tensor cores (mlp_pixel_mma).
// Design: weights in shared memory, read by every thread at once
// (broadcast); activations and cotangents staged per tile as [unit][pixel]
// columns (stride 132 floats, conflict-free); ~146 KB of shared memory at
// F = 73 and ~190 KB at the 3D F = 127 (under the 227 KB opt-in), so one
// block of 128 threads per SM, whose 64-wide register rows give each
// thread independent FMA chains. dW1 = x^T dz1 is reduced in passes of 80
// features, so the wider F adds a pass, not registers.
// Widths: H = 64 and H = 128 are built for fp32 dots (bf16 dots run
// mlp_pixel_mma and mlp_pixel_mma_wide; a narrower model is zero-padded
// to 64 by the wrapper, nic_torch/kernels/_widths.py; a wider one to a
// multiple of 64 for mlp_pixel_wide), and any F runs. The node reductions
// take any multiple of 64 (train_common.cuh). Where
// x's slab and W1 do not both fit in shared memory (F > 183 at H = 64, any
// F > 24 at H = 128, whose W2 and staging tiles take 202 KB), W1 rows are
// read from device memory through L1 and x is staged in chunks of as many
// features as fit (mlp_layout), staged again for the dW1 sums and used
// chunk by chunk for dx.
//
// The entry points do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include "train_common.cuh"

// the tensor-core bodies (train_fused_mma.cu, train_fused_mma_wide.cu) and
// the CUDA-core wide body (train_fused_wide.cu)
extern "C" int nic_mlp_pixel_mma_wide(const float* x, const float* tgt,
                                      const void* w1, const float* b1,
                                      const void* w2, const float* b2,
                                      const float* w3, const float* b3,
                                      float* out, float* grad_out,
                                      float* part, int npix, int feat,
                                      int hidden, int write_dx, int gelu_id,
                                      int nblk, void* stream);
extern "C" int nic_mlp_pixel_mma(const float* x, const float* tgt,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2,
                                 const float* w3, const float* b3, float* out,
                                 float* grad_out, float* part, int npix,
                                 int feat, int write_dx, int gelu_id, int nblk,
                                 void* stream);
extern "C" int nic_mlp_pixel_wide(const float* x, const float* tgt,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  const float* w3, const float* b3,
                                  float* out, float* grad_out, float* part,
                                  int npix, int feat, int hidden,
                                  int write_dx, int bf16, int gelu_id,
                                  int nblk, void* stream);

namespace {

// fc: the features of x staged per pass (fc < feat: x is staged in
// chunks, again for the dW1 sums and dx); w1_smem: W1 staged in shared
// memory (else read from device memory)
struct Shape {
  int npix, feat, write_dx, fc, w1_smem;
  float inv_total;
};

// z1 += xb W1 over the staged chunk of nf features starting at j0
template <int H, bool kGlobal>
__device__ __forceinline__ void z1_chunk(float (&z1)[H], const float* sX,
                                         const float* w1, int j0, int nf) {
  for (int j = 0; j < nf; ++j)
    fma_row<H, false, kGlobal>(z1, sX[j * LDP + threadIdx.x],
                               w1 + static_cast<size_t>(j0 + j) * H);
}

// dx for the chunk's nf features (dz1b . W1 row) into sX
template <int H, bool kGlobal>
__device__ __forceinline__ void dx_chunk(const float (&db)[H], float* sX,
                                         const float* w1, int j0, int nf) {
  for (int j = 0; j < nf; ++j)
    sX[j * LDP + threadIdx.x] =
        dot_row<H, false, kGlobal>(db, w1 + static_cast<size_t>(j0 + j) * H);
}

// block sums of dW1 = xb^T dz1b over the nc staged features c0.. of x
// (sX) and, with the first chunk, db1 from the raw dz1 (sB): thread owns
// h = jq + JQ*hh (hh < 4) and feature j = j0 + kg + KG*m (m < JPT), in
// passes of KG*JPT = 80 features (one pass for nc <= 80)
template <int H>
__device__ __forceinline__ void dw1_sums(const float* sA, const float* sB,
                                         const float* sX, float* mypart,
                                         int c0, int nc, bool first) {
  constexpr int JQ = H / 4;
  constexpr int KG = TP / JQ;
  constexpr int JPT = (80 + KG - 1) / KG;
  const int tid = threadIdx.x;
  const int jq = tid % JQ, kg = tid / JQ;
  float* db1 = mypart + 4 + 4 * H + H * H;
  float* dW1 = db1 + H;
  for (int j0 = 0; j0 < nc; j0 += KG * JPT) {
    float acc[JPT][4];
    float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool with_b = kg == 0 && c0 == 0 && j0 == 0;
NIC_UNROLL_H(JPT)
    for (int m = 0; m < JPT; ++m)
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) acc[m][hh] = 0.0f;
    for (int p = 0; p < TP; p += 4) {
      float4 zv[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        zv[hh] = *reinterpret_cast<const float4*>(sA + (jq + JQ * hh) * LDP + p);
        if (with_b) {
          const float4 rv =
              *reinterpret_cast<const float4*>(sB + (jq + JQ * hh) * LDP + p);
          bsum[hh] += (rv.x + rv.y) + (rv.z + rv.w);
        }
      }
NIC_UNROLL_H(JPT)
      for (int m = 0; m < JPT; ++m) {
        const int j = j0 + kg + KG * m;
        if (j < nc) {
          const float4 xv = *reinterpret_cast<const float4*>(sX + j * LDP + p);
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            float a = acc[m][hh];
            a = fmaf(xv.x, zv[hh].x, a);
            a = fmaf(xv.y, zv[hh].y, a);
            a = fmaf(xv.z, zv[hh].z, a);
            a = fmaf(xv.w, zv[hh].w, a);
            acc[m][hh] = a;
          }
        }
      }
    }
NIC_UNROLL_H(JPT)
    for (int m = 0; m < JPT; ++m) {
      const int j = j0 + kg + KG * m;
      if (j < nc)
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          float* dst = dW1 + static_cast<size_t>(c0 + j) * H + jq + JQ * hh;
          *dst = first ? acc[m][hh] : *dst + acc[m][hh];
        }
    }
    if (with_b)
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float* dst = db1 + jq + JQ * hh;
        *dst = first ? bsum[hh] : *dst + bsum[hh];
      }
  }
}

// the tile's x columns [j0, j0 + nf): one [cnt, F] slab, read row by row
// and staged transposed (zeros past the end)
__device__ __forceinline__ void stage_x(float* sX, const float* xt, int F,
                                        int j0, int nf, int cnt) {
  for (int i = threadIdx.x; i < TP * nf; i += TP) {
    const int p = i / nf, j = i - p * nf;
    sX[j * LDP + p] = p < cnt ? xt[static_cast<size_t>(p) * F + j0 + j] : 0.0f;
  }
}

// partial row layout (floats): [loss, db3[3], dW3[H][3], db2[H], dW2[H][H],
// db1[H], dW1[F][H]]
template <int H, int G>
__global__ void __launch_bounds__(TP, 1)
mlp_pixel(const float* __restrict__ x, const float* __restrict__ tgt,
          const float* __restrict__ w1, const float* __restrict__ b1,
          const float* __restrict__ w2, const float* __restrict__ b2,
          const float* __restrict__ w3, const float* __restrict__ b3,
          float* __restrict__ out, float* __restrict__ grad_out,
          float* __restrict__ part, Shape s) {
  extern __shared__ float4 smem4[];
  const int F = s.feat, FC = s.fc;
  const bool chunked = FC < F;
  float* sA = reinterpret_cast<float*>(smem4);  // h1b, then dz1b [H][LDP]
  float* sB = sA + H * LDP;                     // h2b, dz2, then dz1 [H][LDP]
  float* sD = sB + H * LDP;                     // dz3b, dz3, loss [7][LDP]
  float* sX = sD + 7 * LDP;                     // xb, then dx [FC][LDP]
  float* sW2 = sX + FC * LDP;                   // [H][H] (in, out)
  float* sW3 = sW2 + H * H;                     // [H][3]
  float* sb1 = sW3 + H * 3;
  float* sb2 = sb1 + H;
  float* sb3 = sb2 + H;                         // [4]
  float* sW1 = sb3 + 4;                         // [F][H] when staged

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += TP) sW2[i] = w2[i];
  stage_w1<false>(sW1, w1, F * H, s.w1_smem);
  for (int i = tid; i < H * 3; i += TP) sW3[i] = w3[i];
  for (int i = tid; i < H; i += TP) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  if (tid < 3) sb3[tid] = b3[tid];
  __syncthreads();

  const size_t part_len = 4 + 5 * H + H * H + static_cast<size_t>(F) * H;
  float* mypart = part + blockIdx.x * part_len;
  const int tiles = (s.npix + TP - 1) / TP;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int base = tile * TP;
    const int cnt = min(TP, s.npix - base);
    const float* xt = x + static_cast<size_t>(base) * F;
    const bool valid = tid < cnt;
    const int pix = base + tid;
    float z1[H], z2[H];
    float dz3[3] = {0.0f, 0.0f, 0.0f}, dz3b[3] = {0.0f, 0.0f, 0.0f};
    float lossv = 0.0f;
    // layer 1: z1 = xb W1 + b1, x staged FC features at a time
NIC_UNROLL_H(H)
    for (int h = 0; h < H; ++h) z1[h] = 0.0f;
    for (int j0 = 0; j0 < F; j0 += FC) {
      const int nf = min(FC, F - j0);
      if (j0 > 0) __syncthreads();
      stage_x(sX, xt, F, j0, nf, cnt);
      __syncthreads();
      if (valid) {
        if (s.w1_smem)
          z1_chunk<H, false>(z1, sX, sW1, j0, nf);
        else
          z1_chunk<H, true>(z1, sX, w1, j0, nf);
      }
    }
    if (valid) {
NIC_UNROLL_H(H)
      for (int h = 0; h < H; ++h) z1[h] += sb1[h];
      // layer 2: z2 = h1b W2 + b2, h1b staged for dW2
NIC_UNROLL_H(H)
      for (int j = 0; j < H; ++j) z2[j] = 0.0f;
NIC_UNROLL_H(H)
      for (int k = 0; k < H; ++k) {
        const float hk = gelu_f<G>(z1[k]);
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
        const float h2 = gelu_f<G>(z2[j]);
        sB[j * LDP + tid] = h2;
        o3[0] = fmaf(h2, sW3[j * 3 + 0], o3[0]);
        o3[1] = fmaf(h2, sW3[j * 3 + 1], o3[1]);
        o3[2] = fmaf(h2, sW3[j * 3 + 2], o3[2]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ov = 1.0f / (1.0f + expf(-(o3[c] + sb3[c])));
        out[static_cast<size_t>(pix) * 3 + c] = ov;
        const float diff = ov - tgt[static_cast<size_t>(pix) * 3 + c];
        lossv = fmaf(diff, diff, lossv);
        dz3[c] = (2.0f * s.inv_total) * diff * ov * (1.0f - ov);
        dz3b[c] = dz3[c];
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

    // block sums of dW3 = h2b^T dz3b, db3, loss
    tail_w3_sums<H>(sB, sD, mypart, first, s.inv_total);
    __syncthreads();

    // raw dz2 to sB (dW2, db2), then dz1 = (dz2b W2^T) * gelu'(z1), in
    // place of z1
NIC_UNROLL_H(H)
    for (int j = 0; j < H; ++j) sB[j * LDP + tid] = z2[j];
    if (valid) {
NIC_UNROLL_H(H)
      for (int k = 0; k < H; ++k) {
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
        z1[k] = ((s0 + s1) + (s2 + s3)) * gelu_d<G>(z1[k]);
      }
    } else {
NIC_UNROLL_H(H)
      for (int k = 0; k < H; ++k) z1[k] = 0.0f;
    }
    __syncthreads();

    // block sums of dW2 = h1b^T dz2b and db2: thread owns j = jq + JQ*jj
    // (jj < 4) and k = kg + KG*m (m < KPT)
    constexpr int JQ = H / 4;
    constexpr int KG = TP / JQ;
    {
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

    // dz1b to sA (dW1), raw dz1 to sB (db1); the node-gradient kernel also
    // writes the raw dz1 row to device memory for the window reduction
NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) {
      sA[k * LDP + tid] = z1[k];
      sB[k * LDP + tid] = z1[k];
    }
    if (!s.write_dx && valid) {
      float4* drow = reinterpret_cast<float4*>(grad_out + static_cast<size_t>(pix) * H);
NIC_UNROLL_H(H / 4)
      for (int k4 = 0; k4 < H / 4; ++k4)
        drow[k4] = make_float4(z1[4 * k4], z1[4 * k4 + 1], z1[4 * k4 + 2],
                               z1[4 * k4 + 3]);
    }
    __syncthreads();

    // block sums of dW1 = xb^T dz1b and db1, over each staged chunk of x
    // (the whole slab, still in sX, unless chunked)
    for (int c0 = 0; c0 < F; c0 += FC) {
      const int nc = min(FC, F - c0);
      if (chunked) {
        __syncthreads();
        stage_x(sX, xt, F, c0, nc, cnt);
        __syncthreads();
      }
      dw1_sums<H>(sA, sB, sX, mypart, c0, nc, first);
    }

    if (s.write_dx) {
      // dx = dz1b W1^T into sX (free once the dW1 sums are read), FC
      // features at a time, each chunk written to the tile's [cnt, F] slab
      float db[H];
NIC_UNROLL_H(H)
      for (int h = 0; h < H; ++h) db[h] = z1[h];
      float* dxt = grad_out + static_cast<size_t>(base) * F;
      for (int c0 = 0; c0 < F; c0 += FC) {
        const int nc = min(FC, F - c0);
        __syncthreads();
        if (valid) {
          if (s.w1_smem)
            dx_chunk<H, false>(db, sX, sW1, c0, nc);
          else
            dx_chunk<H, true>(db, sX, w1, c0, nc);
        }
        __syncthreads();
        for (int i = tid; i < cnt * nc; i += TP) {
          const int p = i / nc, j = i - p * nc;
          dxt[static_cast<size_t>(p) * F + c0 + j] = sX[j * LDP + p];
        }
      }
    }
    __syncthreads();
  }
}

// shared memory of mlp_pixel for fc staged features of x, with W1 staged
// when w1_smem: 2 x [H][132] + [7][132] + fc [132] + H^2 + 5H + 4 floats,
// + F H for W1. The fixed part is 88,960 bytes at H = 64 and 206,976 at
// H = 128.
template <int H>
size_t mlp_smem(int feat, int fc, bool w1_smem) {
  return sizeof(float) *
         (2 * H * LDP + 7 * LDP + static_cast<size_t>(fc) * LDP + H * H +
          5 * H + 4 + (w1_smem ? static_cast<size_t>(feat) * H : 0));
}

// where x and W1 go: the whole slab of x and W1 in shared memory when both
// fit (at H = 64 up to F = 183); else W1 from device memory and x in as
// few chunks as fit (one up to F = 271 at H = 64; 48 features a chunk at
// H = 128)
template <int H>
void mlp_layout(Shape& s) {
  if (mlp_smem<H>(s.feat, s.feat, true) <= kMaxSmem) {
    s.fc = s.feat;
    s.w1_smem = 1;
    return;
  }
  s.w1_smem = 0;
  const size_t fixed = mlp_smem<H>(s.feat, 0, false);
  const int fit = static_cast<int>((kMaxSmem - fixed) / (sizeof(float) * LDP));
  s.fc = s.feat < fit ? s.feat : fit;
}

template <int H, int G>
cudaError_t launch_pixel(const float* x, const float* tgt, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* w3, const float* b3, float* out,
                         float* grad_out, float* part, Shape s,
                         int nblk, cudaStream_t stream) {
  mlp_layout<H>(s);
  const size_t smem = mlp_smem<H>(s.feat, s.fc, s.w1_smem);
  auto kern = mlp_pixel<H, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<nblk, TP, smem, stream>>>(x, tgt, w1, b1, w2, b2, w3, b3, out,
                                   grad_out, part, s);
  e = cudaGetLastError();
  if (e == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return e;
}

// the per-pixel bodies by the caller's id (nic_torch/kernels/
// train_fused.py BODY_IDS)
enum Body {
  kMlpPixel = 0,
  kMlpPixelMma = 1,
  kMlpPixelWide = 2,
  kMlpPixelMmaWide = 3
};

// body kMlpPixelMma: the tensor-core body (bf16 dots at H = 64 only);
// kMlpPixelMmaWide: the wide tensor-core body (bf16 dots from H = 128 to
// its widest, 256, with w1 and w2 pointing at bf16 copies of W1 and W2);
// kMlpPixelWide: H > 128; kMlpPixel: fp32 dots at 64 and 128. Any other
// pairing is refused.
cudaError_t dispatch(int hidden, int bf16, int gelu_id, int body,
                     const float* x, const float* tgt,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* out, float* grad_out, float* part, const Shape& s,
                     int nblk, cudaStream_t stream) {
  if (body == kMlpPixelMma) {
    if (hidden != 64 || !bf16) return cudaErrorInvalidValue;
    return static_cast<cudaError_t>(nic_mlp_pixel_mma(
        x, tgt, w1, b1, w2, b2, w3, b3, out, grad_out, part, s.npix, s.feat,
        s.write_dx, gelu_id, nblk, stream));
  }
  if (body == kMlpPixelMmaWide) {
    if (!bf16) return cudaErrorInvalidValue;
    return static_cast<cudaError_t>(nic_mlp_pixel_mma_wide(
        x, tgt, w1, b1, w2, b2, w3, b3, out, grad_out, part, s.npix, s.feat,
        hidden, s.write_dx, gelu_id, nblk, stream));
  }
  if (body == kMlpPixelWide) {
    if (hidden <= 128) return cudaErrorInvalidValue;
    return static_cast<cudaError_t>(nic_mlp_pixel_wide(
        x, tgt, w1, b1, w2, b2, w3, b3, out, grad_out, part, s.npix, s.feat,
        hidden, s.write_dx, bf16, gelu_id, nblk, stream));
  }
  // mlp_pixel takes fp32 dots only (bf16 dots run the tensor-core bodies)
  if (body != kMlpPixel || bf16) return cudaErrorInvalidValue;
#define NIC_WIDTH(H)                                                         \
  if (gelu_id == kErf)                                                       \
    return launch_pixel<H, kErf>(x, tgt, w1, b1, w2, b2, w3, b3, out,        \
                                 grad_out, part, s, nblk, stream);           \
  if (gelu_id == kPoly)                                                      \
    return launch_pixel<H, kPoly>(x, tgt, w1, b1, w2, b2, w3, b3, out,       \
                                  grad_out, part, s, nblk, stream);
  if (hidden == 64) { NIC_WIDTH(64) }
  if (hidden == 128) { NIC_WIDTH(128) }
#undef NIC_WIDTH
  return cudaErrorInvalidValue;
}

// H: 64, 128, or a multiple of 64 above them (the wide body)
bool bad_shape(int npix, int feat, int hidden, int nblk) {
  return npix <= 0 || feat <= 0 || hidden < 64 || hidden % 64 || nblk <= 0;
}

Shape make_shape(int npix, int feat, int write_dx) {
  Shape s;
  s.npix = npix;
  s.feat = feat;
  s.write_dx = write_dx;
  s.inv_total = 1.0f / (static_cast<float>(npix) * 3.0f);
  return s;
}

}  // namespace

// K6: loss, out [N, 3], dx [N, F] and the per-block partials
// [nblk][4 + 5H + H*H + F*H] (layout above).
extern "C" int nic_train_fused_dx(const void* x, const void* tgt,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* out,
                                  void* dx, void* part, int npix, int feat,
                                  int hidden, int bf16, int gelu_id, int body,
                                  int nblk, void* stream) {
  if (bad_shape(npix, feat, hidden, nblk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(npix, feat, 1);
  return static_cast<int>(dispatch(
      hidden, bf16, gelu_id, body, static_cast<const float*>(x),
      static_cast<const float*>(tgt), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out),
      static_cast<float*>(dx), static_cast<float*>(part), s, nblk,
      static_cast<cudaStream_t>(stream)));
}

// K7: loss, out [N, 3], the per-block partials, dz1 [N, H] (scratch) and
// the per-crop node windows win_p [crops][rows0][cols0][H], win_c1
// [crops][rows1][cols1][H] (extents in train_common.cuh win_geo; corners
// [crops][rows1][cols1][4][H] scratch), for crops of n x n pixels (N =
// crops n^2, row-major per crop) at origins [crops][2] on the lattice of
// period f.
extern "C" int nic_train_fused_ng(const void* x, const void* tgt,
                                  const void* origins, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* w3,
                                  const void* b3, void* out, void* dz1,
                                  void* part, void* win_p, void* win_c1,
                                  void* corners, int crops, int n, int f,
                                  int feat, int hidden, int bf16, int gelu_id,
                                  int body, int nblk, void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 ||
      bad_shape(crops * n * n, feat, hidden, nblk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(crops * n * n, feat, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dispatch(
      hidden, bf16, gelu_id, body, static_cast<const float*>(x),
      static_cast<const float*>(tgt), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out),
      static_cast<float*>(dz1), static_cast<float*>(part), s, nblk, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* d = static_cast<const float*>(dz1);
  const auto* o = static_cast<const int*>(origins);
  const WinGeo w = win_geo(crops, n, f);
  return static_cast<int>(launch_node_windows(
      d, o, static_cast<float*>(win_p), static_cast<float*>(win_c1),
      static_cast<float*>(corners), w, hidden, st));
}

// The node windows alone (B as K11 and K7 launch it) of dz1 [crops n^2]
// [hidden], hidden a multiple of 64: as nic_train_fused_ng's.
extern "C" int nic_node_windows(const void* dz1, const void* origins,
                                void* win_p, void* win_c1, void* corners,
                                int crops, int n, int f, int hidden,
                                void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 || hidden <= 0 || hidden % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_node_windows(
      static_cast<const float*>(dz1), static_cast<const int*>(origins),
      static_cast<float*>(win_p), static_cast<float*>(win_c1),
      static_cast<float*>(corners), win_geo(crops, n, f), hidden,
      static_cast<cudaStream_t>(stream)));
}

// K9 (3D kernel2): as K7 for crops of n^3 voxels (N = crops n^3,
// row-major per crop) at origins [crops][3]: the per-crop node volumes
// win_p [crops][r0][r0][r0][H] and win_c1 [crops][r1][c1][c1][H] (extents
// in train_common.cuh vol_geo; corners [crops][r1][c1][c1][8][H]
// scratch).
extern "C" int nic_train_fused_ng3(const void* x, const void* tgt,
                                   const void* origins, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, void* out, void* dz1,
                                   void* part, void* win_p, void* win_c1,
                                   void* corners, int crops, int n, int f,
                                   int feat,
                                   int hidden, int bf16, int gelu_id,
                                   int body, int nblk, void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 ||
      bad_shape(crops * n * n * n, feat, hidden, nblk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(crops * n * n * n, feat, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dispatch(
      hidden, bf16, gelu_id, body, static_cast<const float*>(x),
      static_cast<const float*>(tgt), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out),
      static_cast<float*>(dz1), static_cast<float*>(part), s, nblk, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* d = static_cast<const float*>(dz1);
  const auto* o = static_cast<const int*>(origins);
  const VolGeo v = vol_geo(crops, n, f);
  return static_cast<int>(launch_node_volumes(
      d, o, static_cast<float*>(win_p), static_cast<float*>(win_c1),
      static_cast<float*>(corners), v, hidden, st));
}

// The node volumes alone (B as K12 and K9 launch it) of dz1 [crops n^3]
// [hidden], hidden a multiple of 64: as nic_train_fused_ng3's.
extern "C" int nic_node_volumes(const void* dz1, const void* origins,
                                void* win_p, void* win_c1, void* corners,
                                int crops, int n, int f, int hidden,
                                void* stream) {
  if (crops <= 0 || n <= 0 || f <= 0 || hidden <= 0 || hidden % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_node_volumes(
      static_cast<const float*>(dz1), static_cast<const int*>(origins),
      static_cast<float*>(win_p), static_cast<float*>(win_c1),
      static_cast<float*>(corners), vol_geo(crops, n, f), hidden,
      static_cast<cudaStream_t>(stream)));
}
