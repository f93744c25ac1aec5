// The decodes' MLP tail on the tensor cores (sm_90a), shared by the
// per-pixel bodies decode_v2_mma (K1/K5, decode_fused_v2.cu),
// decode_z1mm_mma (K2, decode_z1mm.cu), decode_v1_mma (K3,
// decode_fused.cu) and mlp_tail_mma (K4, decode_fused_v3.cu):
//
//   rgb = sigmoid(gelu(h1 . W2 + b2) . W3 + b3),  h1 = gelu(z1)
//
// for one warp's 16 pixels, whose h1 the body has formed in the m16n8
// accumulator layout (mma_tail). The output is walked in 64-column blocks:
// h1 W2 on the tensor cores, the second GELU on each block's
// accumulators, which are then the A operand of the product with W3
// padded to n = 8, accumulated over the blocks; then the sigmoid, and rgb
// staged per warp and written as 48 consecutive floats. Dot inputs in
// bf16 (m16n8k16 products, exact in fp32) or, for fp32 dots, m16n8k8 tf32
// products of each operand's hi and lo parts (al bh + ah bl + ah bh; the
// dropped al bl is ~2^-22 of a product; tf32x3.cuh, shared with the train
// kernels' fp32-dot bodies). W2 is staged in shared memory in
// 64 x 64 tiles, all of them once per block (`whole`) or one at a time as
// the walk needs it. Also here: the B-tile staging and the feature-tile
// product of K3's first layer, and the asynchronous copies K4 streams its
// accumulator rows with.
//
// Fragment layout (PTX ISA, mma.m16n8k*): lane (g, q) = (lane / 4,
// lane % 4) holds rows g and g + 8 of the 16 pixels; in the accumulator
// layout h[nt][2 s + i] is row g + 8 s, unit 8 nt + 2 q + i of a 64-unit
// block (eight n8 tiles).

#pragma once

#include "decode_common.cuh"
#include "tf32x3.cuh"

namespace nic_decode {

using namespace nic_tf32;

constexpr int kTileBf16 = 9216;    // bytes of a staged 64 x 64 bf16 W2 tile
constexpr int kTileTf32 = 36864;   // bytes of a staged tf32 hi/lo W2 tile

// two consecutive plane or PE elements as fp32 (4- or 8-byte loads through
// the read-only path; the offsets are even and the rows 16-byte aligned)
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld2(const int16_t* p) {
  const int v = __ldg(reinterpret_cast<const int*>(p));
  return make_float2(static_cast<float>(static_cast<int16_t>(v & 0xffff)),
                     static_cast<float>(static_cast<int16_t>(v >> 16)));
}

// two consecutive shared-memory elements as fp32
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two bf16 values (already bf16, so the rounding is exact) as one word
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows k0 .. k0 + kn - 1 (zero from kmax on) and columns j0 .. j0 + 63 of
// a [K][ld] (in, out) matrix as a B tile, laid out by output unit n: bf16
// as words [64 n][kn / 2 + 4] (k pairs, 4 pad words), tf32 as float4
// {hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)} per k pair p, rows of kn / 2 + 4
// float4s. With kn a multiple of 16 the fragment loads of a warp (bf16)
// or a quarter warp (tf32's 16-byte loads) hit 32 banks. All threads take
// part.
template <bool kBf>
__device__ __forceinline__ void stage_b_tile(unsigned char* dst,
                                             const float* __restrict__ src,
                                             int ld, int k0, int kn, int kmax,
                                             int j0) {
  if (!kBf) {
    stage_b_pairs(reinterpret_cast<float4*>(dst),
                  src + static_cast<size_t>(k0) * ld + j0, ld, 1, kn,
                  kmax - k0);
    return;
  }
  const int rw = kn / 2 + 4;
  for (int i = threadIdx.x; i < 32 * kn; i += blockDim.x) {
    const int kp = i / 64, n = i % 64, k = k0 + 2 * kp;
    const float* s = src + static_cast<size_t>(k) * ld + j0 + n;
    const float w0 = k < kmax ? s[0] : 0.0f;
    const float w1 = k + 1 < kmax ? s[ld] : 0.0f;
    reinterpret_cast<uint32_t*>(dst)[n * rw + kp] = bf2(w0, w1);
  }
}

// W2 tile (kb, jb) of the [H][H] (in, out) matrix in that layout, rows of
// 36 (kTileBf16 or kTileTf32 bytes): stage_b_tile(dst, w2, H, 64 kb, 64,
// H, 64 jb), in the loop decode_v2_mma was tuned and checked with
template <bool kBf>
__device__ __forceinline__ void stage_w2_tile(unsigned char* dst,
                                              const float* __restrict__ w2,
                                              int H, int kb, int jb) {
  if (!kBf) {
    stage_b_pairs(reinterpret_cast<float4*>(dst),
                  w2 + static_cast<size_t>(kb) * 64 * H + jb * 64, H, 1, 64,
                  64);
    return;
  }
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) {
    const int kp = i / 64, n = i % 64;
    const float* src = w2 + static_cast<size_t>(kb * 64 + 2 * kp) * H +
                       jb * 64 + n;
    reinterpret_cast<uint32_t*>(dst)[n * 36 + kp] = bf2(src[0], src[H]);
  }
}

// k16 tile kt of a [16][64] activation in the accumulator layout as the
// bf16 A fragment
__device__ __forceinline__ void pack_a(const float (&h)[8][4], int kt,
                                       uint32_t (&a)[4]) {
  a[0] = bf2(h[2 * kt][0], h[2 * kt][1]);
  a[1] = bf2(h[2 * kt][2], h[2 * kt][3]);
  a[2] = bf2(h[2 * kt + 1][0], h[2 * kt + 1][1]);
  a[3] = bf2(h[2 * kt + 1][2], h[2 * kt + 1][3]);
}

// d[nt] += h W2 over one 64 x 64 tile (kBf: bf16; else 3xTF32)
template <bool kBf>
__device__ __forceinline__ void tile_product(float (&d)[8][4],
                                             const float (&h)[8][4],
                                             const unsigned char* tile,
                                             int g, int q) {
  if (kBf) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t a[4];
      pack_a(h, kt, a);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t* row = w + (8 * nt + g) * 36 + 8 * kt + q;
        mma_bf16(d[nt], a, row[0], row[4]);
      }
    }
  } else {
    tile_3xtf32(d, h, reinterpret_cast<const float4*>(tile), g, q);
  }
}

// d[nt] += x Wt over kn features: x the warp's [16][xs] fp32 feature tile
// (values already in the dot type), Wt a stage_b_tile tile of kn rows.
// The A fragments come from shared memory in the order the B tile
// expects: bf16 (g, 16 kt + 2 q + {0, 1, 8, 9}); tf32 logical columns q
// and q + 4 of k8 tile t are features 8 t + 2 q and 8 t + 2 q + 1, as in
// perm_a. xs % 16 == 8 keeps the 8-byte loads of a half warp on 32 banks.
template <bool kBf>
__device__ __forceinline__ void feature_product(float (&d)[8][4],
                                                const float* x, int xs,
                                                const unsigned char* tile,
                                                int kn, int g, int q) {
  const float* x0 = x + g * xs + 2 * q;  // pixel row g
  const float* x1 = x0 + 8 * xs;         // pixel row g + 8
  const int rw = kn / 2 + 4;
  if (kBf) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile);
#pragma unroll 1
    for (int kt = 0; kt < kn / 16; ++kt) {
      const float2 r0 = lds2(x0 + 16 * kt), r1 = lds2(x1 + 16 * kt);
      const float2 r2 = lds2(x0 + 16 * kt + 8), r3 = lds2(x1 + 16 * kt + 8);
      const uint32_t a[4] = {bf2(r0.x, r0.y), bf2(r1.x, r1.y),
                             bf2(r2.x, r2.y), bf2(r3.x, r3.y)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t* row = w + (8 * nt + g) * rw + 8 * kt + q;
        mma_bf16(d[nt], a, row[0], row[4]);
      }
    }
  } else {
    const float4* w = reinterpret_cast<const float4*>(tile);
#pragma unroll 1
    for (int t = 0; t < kn / 8; ++t) {
      const float2 r0 = lds2(x0 + 8 * t), r1 = lds2(x1 + 8 * t);
      const float a[4] = {r0.x, r1.x, r0.y, r1.y};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_3xtf32(d[nt], ah, al, w[(8 * nt + g) * rw + 4 * t + q]);
    }
  }
}

// o += h2 W3 for the 64 units of block jb: one n8 tile (outputs 0..2 real,
// the rest zero), B built from W3 [H][3] in shared memory
template <bool kBf>
__device__ __forceinline__ void w3_product(float (&o)[4],
                                           const float (&h)[8][4],
                                           const float* sW3, int jb, int g,
                                           int q) {
  auto w3 = [&](int k) { return g < 3 ? sW3[(jb * 64 + k) * 3 + g] : 0.0f; };
  if (kBf) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t a[4];
      pack_a(h, kt, a);
      const int k = 16 * kt + 2 * q;
      mma_bf16(o, a, bf2(w3(k), w3(k + 1)), bf2(w3(k + 8), w3(k + 9)));
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float a[4];
      uint32_t ah[4], al[4];
      perm_a(h, t, a);
      split4(a, ah, al);
      mma_3xtf32(o, ah, al, hilo2(w3(8 * t + 2 * q), w3(8 * t + 2 * q + 1)));
    }
  }
}

// h1 of 64-unit block kb into / out of this lane's slots in shared memory
// (bf16 pairs or fp32; each lane reads back only what it wrote): past
// H = 64 a warp's h1 waits there while the tail walks the output blocks
template <bool kBf>
__device__ __forceinline__ void park_h1(float* slot, int kb, int lane,
                                        const float (&h1)[8][4]) {
  float* sl = slot + kb * 32 * 32 + lane;
#pragma unroll
  for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kBf) {
        if (e % 2 == 0)
          reinterpret_cast<uint32_t*>(slot)[(kb * 16 + nt8 * 2 + e / 2) *
                                                32 + lane] =
              bf2(h1[nt8][e], h1[nt8][e + 1]);
      } else {
        sl[(nt8 * 4 + e) * 32] = h1[nt8][e];
      }
    }
}

template <bool kBf>
__device__ __forceinline__ void unpark_h1(const float* slot, int kb, int lane,
                                          float (&h1)[8][4]) {
#pragma unroll
  for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kBf) {
        if (e % 2 == 0) {
          const uint32_t v = reinterpret_cast<const uint32_t*>(
              slot)[(kb * 16 + nt8 * 2 + e / 2) * 32 + lane];
          const float2 fv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v));
          h1[nt8][e] = fv.x;
          h1[nt8][e + 1] = fv.y;
        }
      } else {
        h1[nt8][e] = slot[kb * 32 * 32 + (nt8 * 4 + e) * 32 + lane];
      }
    }
}

// The tail of one warp's 16 pixels from h1 (kOne: H = 64, h1 in
// registers; else nb = H / 64 blocks parked in `slot` by park_h1, h1 then
// scratch): layer 2 by output blocks jb over the W2 tiles (in sW2, all
// nb^2 with `whole`, else each staged there in turn: every thread of the
// block must call, equally often), the second GELU and W3, the sigmoid
// of b3 plus the three outputs, and rgb of the first cnt pixels to
// out_row()[0 .. 3 cnt). sOut: the warp's 48 floats of staging; (g, q)
// the lane's fragment coordinates. The output address is asked for only
// at the end, so that it holds no registers across the products (passed
// in as a pointer, it cost decode_v2_mma 20 B more of spills in fp32).
template <bool kBf, int G, bool kOne, typename OutRow>
__device__ __forceinline__ void mma_tail(
    float (&h1)[8][4], int nb, bool whole, unsigned char* sW2,
    const float* __restrict__ w2, int H, const float* sW3, const float* sb2,
    const float* sb3, float* sOut, const float* slot, OutRow out_row,
    int cnt, int g, int q, int lane) {
  const size_t tile_bytes = kBf ? kTileBf16 : kTileTf32;
  if (kOne) {  // one 64-unit block, W2 whole
    nb = 1;
    whole = true;
  }

  // layer 2 by output blocks jb, then the second GELU and W3
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int jb = 0; jb < nb; ++jb) {
    float d[8][4];
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt8][e] = 0.0f;
    for (int kb = 0; kb < nb; ++kb) {
      const unsigned char* tile_p = sW2;
      if (whole) {
        tile_p = sW2 + (kb * nb + jb) * tile_bytes;
      } else {
        __syncthreads();
        stage_w2_tile<kBf>(sW2, w2, H, kb, jb);
        __syncthreads();
      }
      if (!kOne) unpark_h1<kBf>(slot, kb, lane, h1);
      tile_product<kBf>(d, h1, tile_p, g, q);
    }
    // h2 = first_act(z2 + b2) on the accumulators, then its W3 product
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[nt8][e] = first_act<G, kBf, true>(
            d[nt8][e] + sb2[jb * 64 + 8 * nt8 + 2 * q + (e & 1)]);
    w3_product<kBf>(o, d, sW3, jb, g, q);
  }

  // sigmoid of outputs 0..2 (lanes q = 0: 0, 1; q = 1: 2), staged per
  // warp, then 48 consecutive floats
  if (q < 2)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 2 * q + i;
        if (col < 3)
          sOut[(g + 8 * s) * 3 + col] =
              1.0f / (1.0f + expf(-(o[2 * s + i] + sb3[col])));
      }
  __syncwarp();
  float* orow = out_row();
  for (int i = lane; i < 3 * cnt; i += 32) orow[i] = sOut[i];
  __syncwarp();
}

// ---- asynchronous copies (K4's accumulator stream) -----------------------

// 16 bytes global -> shared, bypassing L1 (cp.async.cg)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- launch geometry of the persistent tensor-core bodies -----------------

// the most warps a block can have, from `most` down to `least` by halving,
// whose shared memory bytes(warps) fits in what a block may hold; 0 when
// none does
template <typename Bytes>
__host__ int fit_warps(int most, int least, Bytes bytes) {
  for (int w = most; w >= least; w /= 2)
    if (bytes(w) <= kMaxSmem) return w;
  return 0;
}

// blocks of `threads` threads and `smem` bytes over `tiles` tiles: as many
// as stay resident on the card, at most one per tile (each walks tiles)
template <typename Kernel>
__host__ cudaError_t resident_grid(Kernel kern, int threads, size_t smem,
                                   long long tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

}  // namespace nic_decode
