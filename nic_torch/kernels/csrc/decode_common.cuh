// Device code shared by the decode kernels (K1/K5 in decode_fused_v2.cu, K2
// in decode_z1mm.cu, K3 in decode_fused.cu, K4 in decode_fused_v3.cu):
// the six GELUs, the plane modes, vector loads of plane rows, and the
// CUDA-core MLP tail
//
//   rgb = sigmoid(gelu(gelu(z1) . W2 + b2) . W3 + b3)
//
// on a pixel's first-layer preactivation z1 [H], held in registers, with
// W2 (transposed), b2, W3 and b3 staged once per block in shared memory
// (the CUDA-core bodies of K1/K5, K3 and K4 at H = 16); and the wide
// tail (wide_tail), which takes any H that is a multiple of 64 on a tile
// of 16 pixels whose z1 the kernel has written to shared memory as fp32
// [16][H] (K2, K3 and K4 past H = 128). The tensor-core tail of K1/K5,
// K2, K3 and K4 is decode_mma.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Notes a per-pixel body's launch in the launch log (body_log.cu): called
// with the function pointer just launched, once the launch succeeded.
extern "C" void nic_note_body(const void* kernel);

// Loops over the hidden width unroll fully up to H = 64, where the arrays
// they index stay in registers. At H = 128 they stay loops (those arrays
// live in local memory, and the H = 128 kernels are slow): fully unrolled,
// their straight-line code would take ptxas longer than a build may.
#ifndef NIC_UNROLL_H
#define NIC_PRAGMA(x) _Pragma(#x)
#define NIC_UNROLL_H(n) NIC_PRAGMA(unroll (H > 64 ? 1 : (n)))
#endif

namespace nic_decode {

enum Gelu { kExact = 0, kTanh, kQuick, kPoly, kErfPoly, kTanhErf };

// the plane modes of the folded decodes (K1, K5, K2)
enum PlaneMode { kF32 = 0, kBF16 = 1, kI16 = 2, kSurgical = 3 };

// storage types per plane mode: P/C1v element, row-PE element
template <int MODE> struct Types;
template <> struct Types<kF32> { using Plane = float; using Pe = float; };
template <> struct Types<kBF16> {
  using Plane = __nv_bfloat16; using Pe = __nv_bfloat16;
};
template <> struct Types<kI16> { using Plane = int16_t; using Pe = float; };
template <> struct Types<kSurgical> { using Plane = float; using Pe = float; };


// eight consecutive elements -> fp32 (16- or 32-byte vector loads; the
// wrappers check 16-byte alignment and H % 8 == 0)
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int16_t* p, float v[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const int16_t* s = reinterpret_cast<const int16_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(s[i]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Horner over coefficients c[0..n-1] (c[n-1] innermost), as the JAX
// package evaluates them
template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float v) {
  float acc = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = acc * v + c[i];
  return acc;
}

// The six GELUs of nic/kernels/decode_fused_v2.py:62-145 (and the A&S
// 7.1.26 erf of nic/kernels/decode_fused.py:55-71), with the JAX package's
// coefficients; double-precision constants are rounded to float once, as
// JAX does when it multiplies them into float32. kFast takes kExact's
// exponential and reciprocal from the hardware (__expf, __fdividef), a few
// ulp from expf and 1/x, and erf's sign by copysignf, one instruction (at
// z = 0 the GELU is 0 either way): the tensor-core bodies (decode_mma.cuh),
// where the precise ones cost 0.9 of K1's 2.2 ms at 2048^2 on an H100.
template <int G, bool kFast = false>
__device__ __forceinline__ float gelu(float x) {
  if (G == kExact) {
    const float z = x * static_cast<float>(0.7071067811865476);  // 1/sqrt2
    const float az = fabsf(z);
    const float t = kFast ? __fdividef(1.0f, 1.0f + 0.3275911f * az)
                          : 1.0f / (1.0f + 0.3275911f * az);
    const float poly =
        ((((1.061405429f * t + -1.453152027f) * t + 1.421413741f) * t +
          -0.284496736f) * t + 0.254829592f) * t;
    float erf;
    if (kFast) {
      erf = copysignf(1.0f - poly * __expf(-az * az), z);
    } else {
      const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
      erf = sign * (1.0f - poly * expf(-az * az));
    }
    return 0.5f * x * (1.0f + erf);
  } else if (G == kTanh) {
    const float c = static_cast<float>(0.7978845608028654);
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  } else if (G == kQuick) {
    return x * (1.0f / (1.0f + expf(-1.702f * x)));
  } else if (G == kPoly) {
    const float c[9] = {
        6.063213460406e-06f, 3.988279991626e-01f, -6.618728056429e-02f,
        9.689185146121e-03f, -1.058572076001e-03f, 8.262109727744e-05f,
        -4.286269517788e-06f, 1.303813961965e-07f, -1.739696971198e-09f};
    const float y = 0.5f * x + horner(c, x * x);
    return x > 4.0f ? x : (x < -4.0f ? 0.0f : y);
  } else if (G == kErfPoly) {
    const float c[17] = {
        0.36084712417350057f, -0.18016249079808996f, 0.1341197098397116f,
        -0.1092031839839547f, 0.09062792421675198f, -0.0739776908469364f,
        0.0581495074523071f, -0.0435456971886969f, 0.030547198182092263f,
        -0.019592030398672442f, 0.012233327075772783f,
        -0.008136814407460185f, 0.004267563623966739f,
        -0.001049107566569795f, 0.0006108818677171472f,
        -0.0009324910271702735f, 0.0003764209620008347f};
    const float inv_b2 = static_cast<float>(1.0 / (3.9188 * 3.9188));
    const float v = x * x * inv_b2 - 1.0f;
    const float erf = (x * static_cast<float>(0.7071067811865476)) *
                      horner(c, v);
    const float y = 0.5f * x * (1.0f + erf);
    return x > 5.54212f ? x : (x < -5.54212f ? 0.0f : y);
  } else {  // kTanhErf
    const float c[6] = {0.7978726340911436f, 0.03636569087245362f,
                        -5.790097523219499e-05f, -4.725206537106127e-05f,
                        2.7966636242742257e-06f, -5.653256767756493e-08f};
    const float p = horner(c, x * x);
    const float y = 0.5f * x * (1.0f + tanhf(p * x));
    return x > 5.0f ? x : (x < -5.0f ? 0.0f : y);
  }
}

// the tail's weights in shared memory; W2 transposed, so one 16-byte load
// feeds four FMAs, and every thread reads the same weight at the same
// time (a broadcast)
template <int H>
struct TailSmem {
  float4 w2t[H * H / 4];  // [j][k]
  float b2[H];
  float w3[H * 3];
  float b3[3];
};

// at H = 128 W2 (64 KB) would pass the 48 KB of static shared memory a
// block may hold: the tail reads it from device memory, [in=k][out=j],
// through L1 (every thread reads the same weight at the same time)
template <>
struct TailSmem<128> {
  const float* w2;
  float b2[128];
  float w3[128 * 3];
  float b3[3];
};

// all threads of the block take part; the caller synchronises after
template <int H>
__device__ __forceinline__ void stage_tail(TailSmem<H>& s,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           const float* __restrict__ w3,
                                           const float* __restrict__ b3) {
  if constexpr (H > 64) {
    if (threadIdx.x == 0) s.w2 = w2;
  } else {
    float* w2t = reinterpret_cast<float*>(s.w2t);
    for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
      const int k = i / H, j = i % H;  // w2 is [in=k][out=j]
      w2t[j * H + k] = w2[i];
    }
  }
  for (int i = threadIdx.x; i < H * 3; i += blockDim.x) s.w3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) s.b2[i] = b2[i];
  if (threadIdx.x < 3) s.b3[threadIdx.x] = b3[threadIdx.x];
}

// W2[4 k4 .. 4 k4 + 3][j]
template <int H>
__device__ __forceinline__ float4 w2_quad(const TailSmem<H>& s, int j,
                                          int k4) {
  if constexpr (H > 64) {
    const float* c = s.w2 + static_cast<size_t>(4 * k4) * H + j;
    return make_float4(__ldg(c), __ldg(c + H), __ldg(c + 2 * H),
                       __ldg(c + 3 * H));
  } else {
    return s.w2t[j * (H / 4) + k4];
  }
}

// gelu of a first-layer preactivation, as the second dot's input: rounded
// to bf16 with kDotBf16 (the weights already hold bf16 values)
template <int G, bool kDotBf16, bool kFast = false>
__device__ __forceinline__ float first_act(float z) {
  const float g = gelu<G, kFast>(z);
  return kDotBf16 ? bf16_round(g) : g;
}

// layers 2 and 3 on h = first_act(z1): the second layer is produced one
// unit at a time and folded straight into the three RGB sums, so gelu(h2)
// is never stored
template <int H, int G, bool kDotBf16>
__device__ __forceinline__ void mlp_head(const float (&h)[H],
                                         const TailSmem<H>& s,
                                         float* __restrict__ o) {
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
#pragma unroll 2
  for (int j = 0; j < H; ++j) {
    float s0 = 0.0f, s1 = 0.0f;
NIC_UNROLL_H(H / 4)
    for (int k4 = 0; k4 < H / 4; ++k4) {
      const float4 w = w2_quad<H>(s, j, k4);
      s0 = fmaf(h[4 * k4], w.x, s0);
      s1 = fmaf(h[4 * k4 + 1], w.y, s1);
      s0 = fmaf(h[4 * k4 + 2], w.z, s0);
      s1 = fmaf(h[4 * k4 + 3], w.w, s1);
    }
    float g = gelu<G>((s0 + s1) + s.b2[j]);
    if (kDotBf16) g = bf16_round(g);
    o0 = fmaf(g, s.w3[j * 3 + 0], o0);
    o1 = fmaf(g, s.w3[j * 3 + 1], o1);
    o2 = fmaf(g, s.w3[j * 3 + 2], o2);
  }
  o[0] = 1.0f / (1.0f + expf(-(o0 + s.b3[0])));
  o[1] = 1.0f / (1.0f + expf(-(o1 + s.b3[1])));
  o[2] = 1.0f / (1.0f + expf(-(o2 + s.b3[2])));
}

// the whole tail on the first-layer preactivation z (overwritten)
template <int H, int G, bool kDotBf16>
__device__ __forceinline__ void mlp_tail(float (&z)[H], const TailSmem<H>& s,
                                         float* __restrict__ o) {
NIC_UNROLL_H(H)
  for (int k = 0; k < H; ++k) z[k] = first_act<G, kDotBf16>(z[k]);
  mlp_head<H, G, kDotBf16>(z, s, o);
}

// the largest shared memory a block may use (227 KB)
constexpr size_t kMaxSmem = 232448;

// ---- the wide tail: any H that is a multiple of 64 ------------------------
//
// A block of WT threads decodes a tile of WR = 16 pixels. The kernel writes
// the tile's z1 into shared memory as fp32 [WR][H] (zero rows past the
// valid pixels), then every thread calls wide_tail, which forms h1 =
// first_act(z1) in place and walks the second product by 64-unit column
// blocks: thread (c, pg) = (tid % 64, tid / 64) owns output unit c of the
// block for the tile's rows pg + 4 i (i < 4), with W2 streamed through
// shared memory in 64 x 64 tiles (w2[k][j], read conflict-free), then the
// second GELU and its three products with W3, summed over the 64 columns
// by warp shuffles in a fixed order. The plane modes' dot rounding (h1 and
// h2 to bf16 with kDotBf16) and the GELUs are mlp_tail's. Shared memory,
// in floats: 16 H + 5280 (wide_floats), so a tile fits up to H = 3264.
constexpr int WT = 256;   // threads of a wide block
constexpr int WR = 16;    // pixels of a wide tile
constexpr int WCB = 64;   // columns of a block of the hidden axis
constexpr int WLDW = 65;  // row stride of the staged W2 tile

// the wide block's shared memory in floats: z1 [WR][H], the W2 tile, a
// [WR][64] feature chunk (K3) and the output halves [6][WR]
__host__ __device__ inline size_t wide_floats(int h) {
  return static_cast<size_t>(WR) * h + WCB * WLDW + 70 * WR;
}

struct WideSmem {
  float *z, *w, *x, *o;
  __device__ WideSmem(float* base, int h)
      : z(base), w(base + WR * h), x(w + WCB * WLDW), o(x + WCB * WR) {}
};

// rgb of the tile's first cnt pixels into out[p * 3 + c]; sm.z holds z1
// (every thread's writes done: the caller synchronises before the call)
template <int G, bool kDotBf16>
__device__ void wide_tail(const WideSmem& sm, int H,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          const float* __restrict__ w3,
                          const float* __restrict__ b3,
                          float* __restrict__ out, int cnt) {
  constexpr int RPT = WR / 4;
  const int tid = threadIdx.x;
  const int c = tid % WCB, pg = tid / WCB;
  const int lane = tid % 32, half = (tid / 32) % 2;
  for (int i = tid; i < WR * H; i += WT)
    sm.z[i] = first_act<G, kDotBf16>(sm.z[i]);
  float o[RPT][3];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i][0] = o[i][1] = o[i][2] = 0.0f;
  const int nb = H / WCB;
  for (int jb = 0; jb < nb; ++jb) {
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < nb; ++kb) {
      __syncthreads();
      for (int i = tid; i < WCB * WCB; i += WT) {
        const int k = i / WCB, j = i % WCB;
        sm.w[k * WLDW + j] =
            __ldg(w2 + static_cast<size_t>(kb * WCB + k) * H + jb * WCB + j);
      }
      __syncthreads();
      const float* zr = sm.z + kb * WCB;
#pragma unroll 4
      for (int k = 0; k < WCB; ++k) {
        const float w = sm.w[k * WLDW + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i] = fmaf(zr[(pg + 4 * i) * H + k], w, acc[i]);
      }
    }
    const int j = jb * WCB + c;
    const float bj = __ldg(b2 + j);
    const float v0 = __ldg(w3 + 3 * j), v1 = __ldg(w3 + 3 * j + 1),
                v2 = __ldg(w3 + 3 * j + 2);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float g = gelu<G>(acc[i] + bj);
      if (kDotBf16) g = bf16_round(g);
      o[i][0] = fmaf(g, v0, o[i][0]);
      o[i][1] = fmaf(g, v1, o[i][1]);
      o[i][2] = fmaf(g, v2, o[i][2]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      float a = o[i][cc];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) sm.o[(3 * half + cc) * WR + pg + 4 * i] = a;
    }
  __syncthreads();
  if (tid < cnt)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float a = sm.o[cc * WR + tid] + sm.o[(3 + cc) * WR + tid];
      out[tid * 3 + cc] = 1.0f / (1.0f + expf(-(a + __ldg(b3 + cc))));
    }
}

// a kernel whose static and dynamic shared memory together pass 48 KB must
// say so before its launch
template <typename Kernel>
__host__ cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nic_decode
