// The fused MLP train step on gather-built features in bf16-dot mode past
// H = 64, on the tensor cores, for Hopper (sm_90a): mlp_pixel_mma_wide,
// the per-pixel body that the dx kernel (K6) and the node-gradient kernels
// (K7, K9) of train_fused.cu launch for bf16 dots at H = 128 and at every
// multiple of 64 past it up to 256 (H = 64 runs mlp_pixel_mma; fp32 dots,
// and bf16 dots past 256, run mlp_pixel and mlp_pixel_wide on the CUDA
// cores).
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
// The rounding contract is mlp_pixel_mma's: every dot input (x, W1, W2, W3,
// h1, h2, dz3, dz2, and dz1 on its way into dW1 and dx) is rounded to bf16
// and every sum stays fp32, so m16n8k16 bf16 products with fp32
// accumulators compute the plain version's products in another order.
//
// What bounds it (K7 at 8 x 256^2 = 524,288 pixels, F = 73): per pixel z1
// 2 F H, z2, dh1 and dW2 6 H^2, the 64 -> 3 layer 18 H and dW1 2 F H FLOP:
// 472.6 kFLOP at H = 256, 247.8 GFLOP, 0.2506 ms at 989 TFLOP/s, against
// 0.70 GB of bytes (x read, dz1 written, out and targets), 0.210 ms at
// 3.35 TB/s; at H = 128 the bytes bound it (0.433 GB, 0.129 ms). On the
// fp32 CUDA cores the products alone take 3.7 ms at H = 256.
//
// Design. H is a runtime multiple of 64, walked in 64-unit column blocks,
// as mlp_pixel_wide walks it. A block of 256 threads (8 warps) takes a
// tile of 64 pixels at a time and keeps the tile's z1 (then dz1) and z2 as
// fp32 [64][H + 8] in shared memory and h1b (then dz1b) and dz2b as bf16
// [64][H + 8]: 229,904 bytes at H = 256, the widest that fits. Every
// product is a [64][64] output block, warp w owning rows 16 (w % 4).. and
// columns 32 (w / 4).. as four m16n8 accumulators; A comes from the bf16
// activation tiles by ldmatrix (ldmatrix.trans for h1b^T, x^T), B from a
// 64 x 64 bf16 weight tile, which streams through shared memory by 16-byte
// cp.async copies through a ring of tiles (two at H = 256, up to eight at
// narrower widths: tiles i + 1 .. i + ring - 2 in flight while the block
// works on tile i, one barrier a tile). W1 and W2 come from the wrapper as bf16 (rounded as
// the plain version rounds them), so one copy of a W2 tile serves z2 =
// h1b W2 (B read by ldmatrix.trans) and dh1 = dz2b W2^T (B by ldmatrix),
// and one of a W1 tile z1 = xb W1 and dx = dz1b W1^T likewise. x comes in
// rounded to bf16, a chunk of up to 2H features at a time, staged where z2
// lives while z2 is not live. The GELUs, the 64 -> 3 layer, the sigmoid and
// the loss stay on the CUDA cores: o3 from the z2 accumulators, then per
// unit (a thread a unit, the tile's rows in order) dW3, db2 and dz2b from
// the fp32 z2, and db1 from the fp32 dz1. dW2 = h1b^T dz2b runs per 64 x
// 64 piece beside dh1 (both read the same dz2b block), and dW1 = xb^T
// dz1b with the dz1b fragments of a warp's 8 units in registers. Every
// partial sum (loss, dW3, db3, dW2, db2, db1, dW1) lives in the block's own
// row of device memory, set on its first tile and added to after it by
// the one thread that owns each element (its loads issued before the
// products that it adds), so two runs give identical bits; there are no
// atomics. Rows past N are zero in x and get dz3 = 0, so they
// add nothing.
//
// The `// @probe-mark <phase>` comments in the tile loop are where
// scripts/torch_wide_probe.py records the clock in its copy of this
// source; keep them at the phase boundaries, worded as they are.
//
// Entry point nic_mlp_pixel_mma_wide (called by train_fused.cu's entry
// points). It does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "train_common.cuh"

namespace {

constexpr int WR = 64;    // pixels of a tile
constexpr int LDT = 72;   // bf16 row stride of a staged 64 x 64 weight tile

// fc: the features of x staged at a time (all of them, padded to 16, up to
// 2H; past that chunks of 2H, a multiple of 64)
struct WideMmaShape {
  int npix, feat, hidden, write_dx, fc, ring;
  float inv_total;
};

constexpr size_t kTileBytes = 64 * LDT * sizeof(__nv_bfloat16);
constexpr int kMaxRing = 8;  // weight tiles in the ring at most

// shared memory (bytes) at hidden width h with a ring of `ring` weight
// tiles: z1/dz1 and z2 fp32, h1b/dz1b and dz2b bf16, each [64][h + 8];
// the weight tiles [64][72] bf16; b1, b2, W3, b3; dz3b, dz3, loss [8][64];
// the o3 halves [6][64]. The tile fits with the least ring, two tiles, up
// to h = 256 (229,904 bytes); narrower widths take as many more tiles as
// fit, up to kMaxRing (wide_mma_ring)
__host__ __device__ inline size_t wide_mma_smem(int h, int ring = 2) {
  const size_t l = static_cast<size_t>(h) + 8;
  return WR * l * (2 * sizeof(float) + 2 * sizeof(__nv_bfloat16)) +
         ring * kTileBytes +
         sizeof(float) * (5 * static_cast<size_t>(h) + 4 + 14 * WR);
}

int wide_mma_ring(int h) {
  int ring = 2;
  while (ring < kMaxRing && wide_mma_smem(h, ring + 1) <= kMaxSmem) ++ring;
  return ring;
}

// cp.async.wait_group with a runtime count (at most kMaxRing - 1)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The m16n8k16 operand fragments from bf16 tiles in shared memory (row
// stride ld): A of rows m0.. and columns k0.. of a row-major tile (frag_a)
// or of the transpose of a tile stored [k][m] (frag_at); B of the n-tiles
// n0 and n0 + 8 (b[0..1] and b[2..3]) from a tile stored [k][n] (frag_b_kn)
// or [n][k] (frag_b_nk)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, li = lane >> 3, lr = lane & 7;
  ldsm_x4(a, t + (m0 + 8 * (li & 1) + lr) * ld + k0 + 8 * (li >> 1));
}

__device__ __forceinline__ void frag_at(uint32_t (&a)[4],
                                        const __nv_bfloat16* t, int ld,
                                        int m0, int k0) {
  const int lane = threadIdx.x & 31, li = lane >> 3, lr = lane & 7;
  ldsm_x4_trans(a, t + (k0 + 8 * (li >> 1) + lr) * ld + m0 + 8 * (li & 1));
}

__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31, li = lane >> 3, lr = lane & 7;
  ldsm_x4_trans(b, t + (k0 + 8 * (li & 1) + lr) * ld + n0 + 8 * (li >> 1));
}

__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31, li = lane >> 3, lr = lane & 7;
  ldsm_x4(b, t + (n0 + 8 * (li >> 1) + lr) * ld + k0 + 8 * (li & 1));
}

// acc[nt] += a b over one k-step, the warp's four n-tiles: b01 holds
// n-tiles 0 and 1, b23 n-tiles 2 and 3
__device__ __forceinline__ void mma_k16(float (&acc)[4][4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b01)[4],
                                        const uint32_t (&b23)[4]) {
  mma16816(acc[0], a, b01[0], b01[1]);
  mma16816(acc[1], a, b01[2], b01[3]);
  mma16816(acc[2], a, b23[0], b23[1]);
  mma16816(acc[3], a, b23[2], b23[3]);
}

// a 64 x 64 weight tile: rows r0.. (zero from `rows` on) and columns c0..
// of a row-major bf16 matrix
struct WTile {
  const __nv_bfloat16* src;  // its row 0
  int rows, c0;
};

// the tile into dst [64][LDT] by 16-byte cp.async copies, one commit group
__device__ __forceinline__ void fetch_w(__nv_bfloat16* dst, const WTile& t,
                                        int ld) {
  for (int i = threadIdx.x; i < 64 * 8; i += MT) {
    const int r = i >> 3, c = 8 * (i & 7);
    const bool in = r < t.rows;
    cp_async16(dst + r * LDT + c,
               t.src + (in ? static_cast<size_t>(r) * ld + t.c0 + c : 0),
               in ? 16 : 0);
  }
  cp_async_commit();
}

// body(i, tile) over the T weight tiles src(i) names (of a matrix with row
// stride ld), through a ring of S tiles sW [S][64][LDT]. With S >= 3 the
// copies of tiles i + 1 .. i + S - 2 are in flight while the block works on
// tile i, and a tile's buffer is filled again two bodies after it was
// read, so one barrier a body (before it) suffices; with S = 2 tile i + 1's
// copy is in flight and a second barrier after each body frees its buffer.
// Every thread calls it; sW must be free, and the block is synchronised
// before each body and after the last.
template <typename Src, typename Body>
__device__ __forceinline__ void over_tiles(int T, __nv_bfloat16* sW, int S,
                                           int ld, Src src, Body body) {
  constexpr int TE = 64 * LDT;  // elements of a tile
  const int D = S >= 3 ? S - 2 : 1;  // tiles in flight beyond the current
  for (int j = 0; j < D && j < T; ++j) fetch_w(sW + j * TE, src(j), ld);
  for (int i = 0; i < T; ++i) {
    if (i + D < T) fetch_w(sW + ((i + D) % S) * TE, src(i + D), ld);
    cp_async_wait_n(min(D, T - 1 - i));
    __syncthreads();
    body(i, sW + (i % S) * TE);
    if (S == 2) __syncthreads();
  }
  if (S > 2) __syncthreads();
}

// x's columns [c0, c0 + nf) of the tile's [cnt, F] rows, rounded to bf16,
// into sX [WR][ldx]: pad16(nf) columns, zero past nf and in the rows from
// cnt on. When they are all of x's columns, the tile's rows are one
// contiguous slab of cnt F floats, 16-byte aligned (a tile starts 64 F
// floats after the last): it comes in by 16-byte loads, four in flight a
// thread, each value scattered to its row; else consecutive threads read
// consecutive columns of a row
__device__ __forceinline__ void stage_xw(__nv_bfloat16* sX, const float* xt,
                                         int F, int c0, int nf, int cnt,
                                         int ldx) {
  const int kp = pad16(nf);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (nf < F) {
    for (int i = threadIdx.x; i < WR * kp; i += MT) {
      const int p = i / kp, j = i - p * kp;
      sX[p * ldx + j] = __float2bfloat16_rn(
          p < cnt && j < nf ? xt[static_cast<size_t>(p) * F + c0 + j] : 0.0f);
    }
    return;
  }
  const int padc = kp - F;  // zero columns past F, every row
  for (int i = threadIdx.x; i < WR * padc; i += MT) {
    const int p = i / padc;
    sX[p * ldx + F + i - p * padc] = zero;
  }
  for (int i = threadIdx.x; i < (WR - cnt) * F; i += MT) {  // rows past cnt
    const int p = i / F;
    sX[(cnt + p) * ldx + i - p * F] = zero;
  }
  auto put = [&](int e, float v) {
    const int p = e / F;
    sX[p * ldx + e - p * F] = __float2bfloat16_rn(v);
  };
  const int n = cnt * F, n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(xt);
  for (int i = threadIdx.x; i < n4; i += 4 * MT) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = i + u * MT < n4 ? __ldg(x4 + i + u * MT)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * MT < n4) {
        const int e = 4 * (i + u * MT);
        put(e, v[u].x);
        put(e + 1, v[u].y);
        put(e + 2, v[u].z);
        put(e + 3, v[u].w);
      }
  }
  for (int e = 4 * n4 + threadIdx.x; e < n; e += MT) put(e, __ldg(xt + e));
}

// a partial-sum element: set on the block's first tile, added to after
__device__ __forceinline__ void put_w(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// partial row layout (floats): [loss, db3[3], dW3[H][3], db2[H], dW2[H][H],
// db1[H], dW1[F][H]], mlp_pixel's
template <int G>
__global__ void __launch_bounds__(MT, 1)
mlp_pixel_mma_wide(const float* __restrict__ x, const float* __restrict__ tgt,
                   const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   float* __restrict__ out, float* __restrict__ grad_out,
                   float* __restrict__ part, WideMmaShape s) {
  extern __shared__ float4 smem4[];
  const int H = s.hidden, F = s.feat, NB = H / 64, FC = s.fc;
  const int LZ = H + 8;    // row stride of the [WR][H] tiles (either type)
  const int ldx = FC + 8;  // bf16 row stride of the staged x chunk
  float* sZ1 = reinterpret_cast<float*>(smem4);  // z1, then dz1
  float* sZ2 = sZ1 + WR * LZ;                    // z2 + b2
  auto* sX = reinterpret_cast<__nv_bfloat16*>(sZ2);  // xb while z2 is dead
  auto* sH1 = reinterpret_cast<__nv_bfloat16*>(sZ2 + WR * LZ);  // h1b, dz1b
  __nv_bfloat16* sDZ = sH1 + WR * LZ;                           // dz2b
  __nv_bfloat16* sW = sDZ + WR * LZ;  // weight tiles [ring][64][LDT]
  const int S = s.ring;
  float* sb1 = reinterpret_cast<float*>(sW + S * 64 * LDT);
  float* sb2 = sb1 + H;
  float* sW3 = sb2 + H;   // [H][3], bf16 values
  float* sb3 = sW3 + 3 * H;
  float* sD = sb3 + 4;    // dz3b[3], dz3[3], loss [8][WR]
  float* sO = sD + 8 * WR;  // o3 of the two column halves [6][WR]

  const int tid = threadIdx.x;
  for (int i = tid; i < H; i += MT) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  for (int i = tid; i < 3 * H; i += MT) sW3[i] = bf16_round(w3[i]);
  if (tid < 3) sb3[tid] = b3[tid];

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int li = lane >> 3, lr = lane & 7;
  // the warp's rows 16 mt.. and columns 32 nh.. of a [64][64] block; the
  // thread's rows r0 and r0 + 8
  const int mt = warp & 3, nh = warp >> 2, r0 = 16 * mt + g;
  const size_t part_len = 4 + 5 * static_cast<size_t>(H) +
                          static_cast<size_t>(H) * H +
                          static_cast<size_t>(F) * H;
  float* mypart = part + blockIdx.x * part_len;
  float* pdW3 = mypart + 4;
  float* pdb2 = pdW3 + 3 * H;
  float* pdW2 = pdb2 + H;
  float* pdb1 = pdW2 + static_cast<size_t>(H) * H;
  float* pdW1 = pdb1 + H;
  const int nch = (F + FC - 1) / FC;  // chunks of x
  const int TW1 = (F + 63) / 64;      // 64-feature tiles of W1
  const int tiles = (s.npix + WR - 1) / WR;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int base = tile * WR;
    const int cnt = min(WR, s.npix - base);
    const float* xt = x + static_cast<size_t>(base) * F;
    // @probe-mark start
    float acc[4][4];
    auto zero_acc = [&]() {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    };

    // layer 1: z1 = xb W1 + b1 by 64-unit column blocks jb over W1's
    // 64-feature tiles t (a new chunk of x staged at its first tile), then
    // z1 to sZ1 and h1b = bf16(gelu(z1)) to sH1
    over_tiles(
        NB * TW1, sW, S, H,
        [&](int i) {
          const int t = i % TW1;
          return WTile{w1 + static_cast<size_t>(64 * t) * H,
                       min(64, F - 64 * t), 64 * (i / TW1)};
        },
        [&](int i, const __nv_bfloat16* wt) {
          const int jb = i / TW1, t = i % TW1, f0 = 64 * t;
          const int c0 = f0 / FC * FC;  // the chunk that holds tile t
          if (f0 == c0 && (nch > 1 || jb == 0)) {
            stage_xw(sX, xt, F, c0, min(FC, F - c0), cnt, ldx);
            __syncthreads();
          }
          if (t == 0) zero_acc();
          const int kp = pad16(min(64, F - f0));
          for (int k0 = 0; k0 < kp; k0 += 16) {
            uint32_t a[4], b01[4], b23[4];
            frag_a(a, sX, ldx, 16 * mt, f0 - c0 + k0);
            frag_b_kn(b01, wt, LDT, k0, 32 * nh);
            frag_b_kn(b23, wt, LDT, k0, 32 * nh + 16);
            mma_k16(acc, a, b01, b23);
          }
          if (t == TW1 - 1) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r;
                const int col = 64 * jb + 32 * nh + 8 * nt + 2 * q;
                const float z0 = acc[nt][2 * r] + sb1[col];
                const float z1 = acc[nt][2 * r + 1] + sb1[col + 1];
                *reinterpret_cast<float2*>(sZ1 + row * LZ + col) =
                    make_float2(z0, z1);
                *reinterpret_cast<uint32_t*>(sH1 + row * LZ + col) =
                    pack_bf16(gelu_f<G>(z0), gelu_f<G>(z1));
              }
          }
        });

    // @probe-mark layer 1
    // layer 2: z2 = h1b W2 + b2 by column blocks jb over W2's tiles (kb,
    // jb); z2 to sZ2, and the thread's share of o3 = h2b W3 over its
    // columns of every block
    float o3[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    over_tiles(
        NB * NB, sW, S, H,
        [&](int i) {
          return WTile{w2 + static_cast<size_t>(64 * (i % NB)) * H, 64,
                       64 * (i / NB)};
        },
        [&](int i, const __nv_bfloat16* wt) {
          const int jb = i / NB, kb = i % NB;
          if (kb == 0) zero_acc();
#pragma unroll
          for (int k0 = 0; k0 < 64; k0 += 16) {
            uint32_t a[4], b01[4], b23[4];
            frag_a(a, sH1, LZ, 16 * mt, 64 * kb + k0);
            frag_b_kn(b01, wt, LDT, k0, 32 * nh);
            frag_b_kn(b23, wt, LDT, k0, 32 * nh + 16);
            mma_k16(acc, a, b01, b23);
          }
          if (kb == NB - 1) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r;
                const int col = 64 * jb + 32 * nh + 8 * nt + 2 * q;
                const float z[2] = {acc[nt][2 * r] + sb2[col],
                                    acc[nt][2 * r + 1] + sb2[col + 1]};
                *reinterpret_cast<float2*>(sZ2 + row * LZ + col) =
                    make_float2(z[0], z[1]);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float h2 = bf16_round(gelu_f<G>(z[e]));
#pragma unroll
                  for (int c = 0; c < 3; ++c)
                    o3[r][c] = fmaf(h2, sW3[(col + e) * 3 + c], o3[r][c]);
                }
              }
          }
        });
    // @probe-mark layer 2
    // o3 per row: the quad's columns, then the two column halves in order
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o3[r][c] += __shfl_xor_sync(0xffffffffu, o3[r][c], 1);
        o3[r][c] += __shfl_xor_sync(0xffffffffu, o3[r][c], 2);
        if (q == 0) sO[(3 * nh + c) * WR + r0 + 8 * r] = o3[r][c];
      }
    __syncthreads();
    // @probe-mark o3 reduce
    // sigmoid, loss and dz3 per row
    if (tid < WR) {
      const int p = tid;
      float lossv = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dz3 = 0.0f;
        if (p < cnt) {
          const float o = sO[c * WR + p] + sO[(3 + c) * WR + p];
          const float ov = 1.0f / (1.0f + expf(-(o + sb3[c])));
          const size_t idx = static_cast<size_t>(base + p) * 3 + c;
          out[idx] = ov;
          const float diff = ov - tgt[idx];
          lossv = fmaf(diff, diff, lossv);
          dz3 = (2.0f * s.inv_total) * diff * ov * (1.0f - ov);
        }
        sD[c * WR + p] = bf16_round(dz3);
        sD[(3 + c) * WR + p] = dz3;
      }
      sD[6 * WR + p] = lossv;
    }
    __syncthreads();

    // @probe-mark sigmoid, dz3
    // per unit j: dW3 = h2b^T dz3b, dz2 = (dz3b W3^T) gelu'(z2) to sDZ as
    // bf16, db2 = the sum of dz2; then db3 and the loss. Below H = 256 the
    // block's threads split the rows into RG groups, whose sums meet in
    // the (free) weight ring in a fixed order
    const int RG = H < MT ? MT / H : 1, RR = WR / RG;
    float* sRed = reinterpret_cast<float*>(sW);  // [RG][4][H]
    for (int t = tid; t < RG * H; t += MT) {
      const int j = t % H, rg = t / H;
      const float w0 = sW3[j * 3 + 0], w1v = sW3[j * 3 + 1],
                  w2v = sW3[j * 3 + 2];
      // one group: the partials so far, loaded before the row walk
      const bool old = RG == 1 && !first;
      float a0 = old ? pdW3[j * 3 + 0] : 0.0f;
      float a1 = old ? pdW3[j * 3 + 1] : 0.0f;
      float a2 = old ? pdW3[j * 3 + 2] : 0.0f;
      float db = old ? pdb2[j] : 0.0f;
      for (int p = rg * RR; p < rg * RR + RR; ++p) {
        const float z = sZ2[p * LZ + j];
        const float h2 = bf16_round(gelu_f<G>(z));
        const float d0 = sD[p], d1 = sD[WR + p], d2 = sD[2 * WR + p];
        a0 = fmaf(h2, d0, a0);
        a1 = fmaf(h2, d1, a1);
        a2 = fmaf(h2, d2, a2);
        const float dz = (d0 * w0 + d1 * w1v + d2 * w2v) * gelu_d<G>(z);
        sDZ[p * LZ + j] = __float2bfloat16_rn(dz);
        db += dz;
      }
      if (RG == 1) {
        pdW3[j * 3 + 0] = a0;
        pdW3[j * 3 + 1] = a1;
        pdW3[j * 3 + 2] = a2;
        pdb2[j] = db;
      } else {
        sRed[(rg * 4 + 0) * H + j] = a0;
        sRed[(rg * 4 + 1) * H + j] = a1;
        sRed[(rg * 4 + 2) * H + j] = a2;
        sRed[(rg * 4 + 3) * H + j] = db;
      }
    }
    if (RG > 1) {
      __syncthreads();
      for (int j = tid; j < H; j += MT) {
        float v[4] = {first ? 0.0f : pdW3[j * 3 + 0],
                      first ? 0.0f : pdW3[j * 3 + 1],
                      first ? 0.0f : pdW3[j * 3 + 2],
                      first ? 0.0f : pdb2[j]};
        for (int rg = 0; rg < RG; ++rg)
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] += sRed[(rg * 4 + k) * H + j];
        pdW3[j * 3 + 0] = v[0];
        pdW3[j * 3 + 1] = v[1];
        pdW3[j * 3 + 2] = v[2];
        pdb2[j] = v[3];
      }
      __syncthreads();  // the ring's next copies overwrite sRed
    }
    if (tid < 4) {
      const float* src = sD + (tid < 3 ? 3 + tid : 6) * WR;
      float a = 0.0f;
      for (int p = 0; p < WR; ++p) a += src[p];
      if (tid == 3) a *= s.inv_total;
      put_w(mypart + (tid < 3 ? 1 + tid : 0), a, first);
    }

    // layer 2 backward by 64-unit blocks kb of h1 over W2's tiles (kb, jb):
    // dh1 = dz2b W2^T and dW2's piece (kb, jb) = h1b^T dz2b over the tile's
    // pixels; then dz1 = dh1 gelu'(z1) in place of z1 and dz1b in place of
    // h1b's block kb, which no later piece reads
    // @probe-mark dz2 pass
    // the thread's elements of dW2's piece i = (kb, jb) in the block's row
    auto piece = [&](int i) {
      return pdW2 + static_cast<size_t>(64 * (i / NB) + r0) * H +
             64 * (i % NB) + 32 * nh + 2 * q;
    };
    // the piece's sums so far, loaded a piece ahead so that the loads
    // overlap the products
    float2 oldn[4][2];
    auto load_piece = [&](int i) {
      const float* pw = piece(i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          oldn[nt][r] = first ? make_float2(0.0f, 0.0f)
                              : *reinterpret_cast<const float2*>(
                                    pw + static_cast<size_t>(8 * r) * H +
                                    8 * nt);
    };
    load_piece(0);
    over_tiles(
        NB * NB, sW, S, H,
        [&](int i) {
          return WTile{w2 + static_cast<size_t>(64 * (i / NB)) * H, 64,
                       64 * (i % NB)};
        },
        [&](int i, const __nv_bfloat16* wt) {
          const int kb = i / NB, jb = i % NB;
          if (jb == 0) zero_acc();
          float* pw = piece(i);
          float2 old[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) old[nt][r] = oldn[nt][r];
          if (i + 1 < NB * NB) load_piece(i + 1);
          float dw[4][4] = {};
#pragma unroll
          for (int k0 = 0; k0 < 64; k0 += 16) {
            uint32_t a[4], b01[4], b23[4];
            frag_a(a, sDZ, LZ, 16 * mt, 64 * jb + k0);
            frag_b_nk(b01, wt, LDT, k0, 32 * nh);
            frag_b_nk(b23, wt, LDT, k0, 32 * nh + 16);
            mma_k16(acc, a, b01, b23);
            frag_at(a, sH1, LZ, 64 * kb + 16 * mt, k0);
            frag_b_kn(b01, sDZ, LZ, k0, 64 * jb + 32 * nh);
            frag_b_kn(b23, sDZ, LZ, k0, 64 * jb + 32 * nh + 16);
            mma_k16(dw, a, b01, b23);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(pw + static_cast<size_t>(8 * r) * H +
                                         8 * nt) =
                  make_float2(old[nt][r].x + dw[nt][2 * r],
                              old[nt][r].y + dw[nt][2 * r + 1]);
          if (jb == NB - 1) {
            __syncthreads();  // every warp has read h1b's block kb
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r;
                const int col = 64 * kb + 32 * nh + 8 * nt + 2 * q;
                float2* z = reinterpret_cast<float2*>(sZ1 + row * LZ + col);
                const float2 zv = *z;
                const float d0 = acc[nt][2 * r] * gelu_d<G>(zv.x);
                const float d1 = acc[nt][2 * r + 1] * gelu_d<G>(zv.y);
                *z = make_float2(d0, d1);
                *reinterpret_cast<uint32_t*>(sH1 + row * LZ + col) =
                    pack_bf16(d0, d1);
              }
          }
        });

    // @probe-mark layer 2 back
    // dz1 out (K7, K9), coalesced rows; db1 per unit over the rows in order
    if (!s.write_dx) {
      const int q4 = H / 4;
      for (int i = tid; i < cnt * q4; i += MT) {
        const int p = i / q4, c = 4 * (i - p * q4);
        *reinterpret_cast<float4*>(grad_out + static_cast<size_t>(base + p) *
                                                  H + c) =
            *reinterpret_cast<const float4*>(sZ1 + p * LZ + c);
      }
    }
    for (int j = tid; j < H; j += MT) {
      float a = first ? 0.0f : pdb1[j];  // loaded before the row walk
      for (int p = 0; p < WR; ++p) a += sZ1[p * LZ + j];
      pdb1[j] = a;
    }

    // @probe-mark dz1 out, db1
    // dW1 = xb^T dz1b and, for K6, dx = dz1b W1^T, by chunks of x (staged
    // again where z2 lived)
    for (int c0 = 0; c0 < F; c0 += FC) {
      const int nf = min(FC, F - c0), kp = pad16(nf);
      __syncthreads();
      stage_xw(sX, xt, F, c0, nf, cnt, ldx);
      __syncthreads();
      // dW1: warp w owns units 8w..8w+7 of each block kb and every feature
      // of the chunk, in groups of four m-tiles of 16 features (their sums
      // so far loaded a group ahead); its dz1b fragments of block kb over
      // the tile's 64 pixels stay in registers
      const int ngr = (kp + 63) / 64;
      float2 oldn[4][2];
      auto load_group = [&](int idx) {
        const int m0 = 64 * (idx % ngr);
        const float* pw = pdW1 + static_cast<size_t>(c0 + m0 + g) * H +
                          64 * (idx / ngr) + 8 * warp + 2 * q;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool in = !first && c0 + m0 + 16 * mm + g + 8 * r < F;
            oldn[mm][r] = in ? *reinterpret_cast<const float2*>(
                                   pw + static_cast<size_t>(16 * mm + 8 * r) *
                                            H)
                             : make_float2(0.0f, 0.0f);
          }
      };
      load_group(0);
      uint32_t bz[4][2];
      for (int idx = 0; idx < NB * ngr; ++idx) {
        const int kb = idx / ngr, m0 = 64 * (idx % ngr);
        float2 old[4][2];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
#pragma unroll
          for (int r = 0; r < 2; ++r) old[mm][r] = oldn[mm][r];
        if (idx + 1 < NB * ngr) load_group(idx + 1);
        if (m0 == 0)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t b[4];
            ldsm_x4_trans(b, sH1 + (32 * kk + 8 * li + lr) * LZ + 64 * kb +
                                 8 * warp);
            bz[2 * kk][0] = b[0];
            bz[2 * kk][1] = b[1];
            bz[2 * kk + 1][0] = b[2];
            bz[2 * kk + 1][1] = b[3];
          }
        float d[4][4] = {};
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          if (m0 + 16 * mm >= kp) break;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t a[4];
            frag_at(a, sX, ldx, m0 + 16 * mm, 16 * ks);
            mma16816(d[mm], a, bz[ks][0], bz[ks][1]);
          }
        }
        float* pw = pdW1 + static_cast<size_t>(c0 + m0 + g) * H + 64 * kb +
                    8 * warp + 2 * q;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (c0 + m0 + 16 * mm + g + 8 * r < F)
              *reinterpret_cast<float2*>(
                  pw + static_cast<size_t>(16 * mm + 8 * r) * H) =
                  make_float2(old[mm][r].x + d[mm][2 * r],
                              old[mm][r].y + d[mm][2 * r + 1]);
      }
      if (!s.write_dx) continue;
      // dx: column blocks of 64 features fb over W1's tiles (fb, kb), read
      // as W1^T
      __syncthreads();
      over_tiles(
          (nf + 63) / 64 * NB, sW, S, H,
          [&](int i) {
            const int f0 = c0 + 64 * (i / NB);
            return WTile{w1 + static_cast<size_t>(f0) * H, min(64, F - f0),
                         64 * (i % NB)};
          },
          [&](int i, const __nv_bfloat16* wt) {
            const int fb = i / NB, kb = i % NB;
            if (kb == 0) zero_acc();
#pragma unroll
            for (int k0 = 0; k0 < 64; k0 += 16) {
              uint32_t a[4], b01[4], b23[4];
              frag_a(a, sH1, LZ, 16 * mt, 64 * kb + k0);
              frag_b_nk(b01, wt, LDT, k0, 32 * nh);
              frag_b_nk(b23, wt, LDT, k0, 32 * nh + 16);
              mma_k16(acc, a, b01, b23);
            }
            if (kb == NB - 1)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = r0 + 8 * (e >> 1);
                  const int f = c0 + 64 * fb + 32 * nh + 8 * nt + 2 * q +
                                (e & 1);
                  if (row < cnt && f < F)
                    grad_out[static_cast<size_t>(base + row) * F + f] =
                        acc[nt][e];
                }
          });
    }
    __syncthreads();
    // @probe-mark end
  }
}

template <int G>
cudaError_t launch_mma_wide(const float* x, const float* tgt,
                            const __nv_bfloat16* w1, const float* b1,
                            const __nv_bfloat16* w2, const float* b2,
                            const float* w3, const float* b3, float* out,
                            float* grad_out, float* part,
                            const WideMmaShape& s, int nblk,
                            cudaStream_t stream) {
  const size_t smem = wide_mma_smem(s.hidden, s.ring);
  auto kern = mlp_pixel_mma_wide<G>;
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

// mlp_pixel_mma_wide over N = npix rows of x [N, F] at hidden width H (a
// multiple of 64 from 128 up to the widest whose tile fits, 256), W1 [F, H]
// and W2 [H, H] given as bf16: out [N, 3], the per-block partials part
// [nblk][4 + 5H + H*H + F*H] (layout above) and grad_out: dx [N, F] when
// write_dx, else dz1 [N, H]. Called by train_fused.cu's entry points,
// which run the node reductions after it.
extern "C" int nic_mlp_pixel_mma_wide(const float* x, const float* tgt,
                                      const void* w1, const float* b1,
                                      const void* w2, const float* b2,
                                      const float* w3, const float* b3,
                                      float* out, float* grad_out,
                                      float* part, int npix, int feat,
                                      int hidden, int write_dx, int gelu_id,
                                      int nblk, void* stream) {
  if (npix <= 0 || feat <= 0 || nblk <= 0 || hidden < 128 || hidden % 64 ||
      wide_mma_smem(hidden) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  WideMmaShape s;
  s.npix = npix;
  s.feat = feat;
  s.hidden = hidden;
  s.write_dx = write_dx;
  s.fc = pad16(feat) < 2 * hidden ? pad16(feat) : 2 * hidden;
  s.ring = wide_mma_ring(hidden);
  s.inv_total = 1.0f / (static_cast<float>(npix) * 3.0f);
  const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
  const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (gelu_id == kErf)
    e = launch_mma_wide<kErf>(x, tgt, w1b, b1, w2b, b2, w3, b3, out,
                              grad_out, part, s, nblk, st);
  if (gelu_id == kPoly)
    e = launch_mma_wide<kPoly>(x, tgt, w1b, b1, w2b, b2, w3, b3, out,
                               grad_out, part, s, nblk, st);
  return static_cast<int>(e);
}
