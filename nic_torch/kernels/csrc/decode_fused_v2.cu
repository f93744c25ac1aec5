// Per-pixel stage of the 2D and 3D folded decodes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nic/kernels/decode_fused_v2.py `_kernel`
// + `_mlp_tail`, launched by `_call` (pallas_call at :369, K1), and the
// same body over volumes, launched by nic/kernels/decode_fused_3d.py
// `_call3` (pallas_call at :144, K5). The column
// stage (W1 fold, column upsample/interp, column-PE + b1 + LOD folded into
// C1v, the row-PE table) runs before it in PyTorch
// (nic_torch/kernels/decode_fused_v2.py `_prepare_2d`). For output pixel
// (r, c) of an nr x ncl image, hidden width H:
//
//   z1  = P[r/f, c] + (1-u)*C1v[r/f1, c] + u*C1v[r/f1+1, c] + peu[r]
//         u = (r % f1)/f1; in i16 mode P and C1v are first scaled
//   rgb = sigmoid(gelu(gelu(z1) . W2 + b2) . W3 + b3)    -> out[r, c, :]
//
// Design: one thread per output pixel; a block is TILE_R rows x 128
// columns, its threads walking the TILE_R rows. W2 (transposed, so one
// 16-byte shared load feeds four FMAs), b2, W3 and b3 are staged in shared
// memory once per block; every thread reads the same weight at the same
// time, so the reads are broadcasts. z1 and gelu(z1) stay in registers
// (H floats), the second layer is produced one output unit at a time and
// folded straight into the three RGB sums, so gelu(h2) is never stored.
// Rows are indexed directly: C1v already carries the nr/f1+1 rows a halo
// window would fetch, and ragged edges are masked, so there is no padding.
// A volume is a stack of such frames (the 3D frame stage, frame-PE
// included, runs before the kernel in PyTorch, nic_torch/kernels/
// decode_fused_3d.py `_prepare_3d`): blockIdx.z walks the frames, each
// with its own P, C1v and output planes; the row-PE table and the weights
// are shared, and one launch covers the whole volume.
// The TPU-only devices of the JAX kernel (lane packing with block-diagonal
// weights, per-step weight tiling, planar output, the column-block retile)
// are not carried over.
//
// What bounds it: per pixel the two products are 2*(H*H + 3*H) = 8.6
// kFLOP at H = 64 plus 2*H = 128 GELUs (~20 fp32 instructions each), while
// it reads about H*(1/f + 2)*sizeof(plane) bytes of planes. At 2048^2 that
// is ~36 GFLOP + ~11 G GELU instructions against ~0.4 GB of fp32 planes:
// ~1 ms of fp32 CUDA-core issue against ~0.12 ms of HBM at 3.35 TB/s, so
// the fp32 CUDA cores, not bandwidth, bound this kernel. A wgmma version
// should move both 64-wide products onto the tensor cores (bf16 inputs,
// fp32 accumulators, h1 as the register A operand of a 64-row warpgroup
// tile), which leaves the GELUs and the plane reads as the bound, and then
// stage the plane rows through shared memory with TMA.
//
// Entry point: nic_decode_fused_v2 (plain C, loaded with ctypes). It
// launches on the given stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_C = 128;  // threads per block = pixel columns per block
constexpr int TILE_R = 4;    // pixel rows each block walks

enum PlaneMode { kF32 = 0, kBF16 = 1, kI16 = 2, kSurgical = 3 };
enum Gelu { kExact = 0, kTanh, kQuick, kPoly, kErfPoly, kTanhErf };

// storage types per plane mode: P/C1v element, row-PE element
template <int MODE> struct Types;
template <> struct Types<kF32> { using Plane = float; using Pe = float; };
template <> struct Types<kBF16> {
  using Plane = __nv_bfloat16; using Pe = __nv_bfloat16;
};
template <> struct Types<kI16> { using Plane = int16_t; using Pe = float; };
template <> struct Types<kSurgical> { using Plane = float; using Pe = float; };

// eight consecutive elements -> fp32 (16- or 32-byte vector loads; the
// wrapper checks 16-byte alignment and H % 8 == 0)
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
// JAX does when it multiplies them into float32.
template <int G>
__device__ __forceinline__ float gelu(float x) {
  if (G == kExact) {
    const float z = x * static_cast<float>(0.7071067811865476);  // 1/sqrt2
    const float az = fabsf(z);
    const float t = 1.0f / (1.0f + 0.3275911f * az);
    const float poly =
        ((((1.061405429f * t + -1.453152027f) * t + 1.421413741f) * t +
          -0.284496736f) * t + 0.254829592f) * t;
    const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
    const float erf = sign * (1.0f - poly * expf(-az * az));
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

template <int H, int MODE, int G>
__global__ void __launch_bounds__(TILE_C)
decode_fused_v2_kernel(const typename Types<MODE>::Plane* __restrict__ pc,
                       const typename Types<MODE>::Plane* __restrict__ c1v,
                       const typename Types<MODE>::Pe* __restrict__ peu,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3, float scale,
                       float* __restrict__ out, int nr, int ncl, int f,
                       int f1) {
  // frame blockIdx.z of a volume: its own P, C1v and output planes
  const size_t frame = blockIdx.z;
  pc += frame * static_cast<size_t>(nr / f) * ncl * H;
  c1v += frame * static_cast<size_t>(nr / f1 + 1) * ncl * H;
  out += frame * static_cast<size_t>(nr) * ncl * 3;
  constexpr bool kDotBf16 = MODE != kF32;  // bf16 inputs to both dots
  __shared__ float4 s_w2t[H * H / 4];  // W2 transposed: [j][k]
  __shared__ float s_b2[H];
  __shared__ float s_w3[H * 3];
  __shared__ float s_b3[3];

  float* w2t = reinterpret_cast<float*>(s_w2t);
  for (int i = threadIdx.x; i < H * H; i += TILE_C) {
    const int k = i / H, j = i % H;  // w2 is [in=k][out=j]
    w2t[j * H + k] = w2[i];
  }
  for (int i = threadIdx.x; i < H * 3; i += TILE_C) s_w3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += TILE_C) s_b2[i] = b2[i];
  if (threadIdx.x < 3) s_b3[threadIdx.x] = b3[threadIdx.x];
  __syncthreads();

  const int c = blockIdx.x * TILE_C + threadIdx.x;
  if (c >= ncl) return;
  for (int rr = 0; rr < TILE_R; ++rr) {
    const int r = blockIdx.y * TILE_R + rr;
    if (r >= nr) return;
    const int ia = r / f1;
    const float u = static_cast<float>(r % f1) / static_cast<float>(f1);
    const float um = 1.0f - u;
    const auto* prow = pc + (static_cast<size_t>(r / f) * ncl + c) * H;
    const auto* arow = c1v + (static_cast<size_t>(ia) * ncl + c) * H;
    const auto* brow = arow + static_cast<size_t>(ncl) * H;
    const auto* erow = peu + static_cast<size_t>(r) * H;

    // first layer: z1 -> gelu, kept in registers
    float h[H];
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 8) {
      float p[8], a[8], b[8], e[8];
      load8(prow + k0, p);
      load8(arow + k0, a);
      load8(brow + k0, b);
      load8(erow + k0, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float pv = p[i], av = a[i], bv = b[i];
        if (MODE == kI16) {
          pv *= scale;
          av *= scale;
          bv *= scale;
        }
        const float g = gelu<G>((pv + (um * av + u * bv)) + e[i]);
        h[k0 + i] = kDotBf16 ? bf16_round(g) : g;
      }
    }

    // second layer one unit at a time, folded into the RGB sums
    float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
#pragma unroll 2
    for (int j = 0; j < H; ++j) {
      const float4* wj = s_w2t + j * (H / 4);
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < H / 4; ++k4) {
        const float4 w = wj[k4];
        s0 = fmaf(h[4 * k4], w.x, s0);
        s1 = fmaf(h[4 * k4 + 1], w.y, s1);
        s0 = fmaf(h[4 * k4 + 2], w.z, s0);
        s1 = fmaf(h[4 * k4 + 3], w.w, s1);
      }
      float g = gelu<G>((s0 + s1) + s_b2[j]);
      if (kDotBf16) g = bf16_round(g);
      o0 = fmaf(g, s_w3[j * 3 + 0], o0);
      o1 = fmaf(g, s_w3[j * 3 + 1], o1);
      o2 = fmaf(g, s_w3[j * 3 + 2], o2);
    }
    float* o = out + (static_cast<size_t>(r) * ncl + c) * 3;
    o[0] = 1.0f / (1.0f + expf(-(o0 + s_b3[0])));
    o[1] = 1.0f / (1.0f + expf(-(o1 + s_b3[1])));
    o[2] = 1.0f / (1.0f + expf(-(o2 + s_b3[2])));
  }
}

struct Args {
  const void *pc, *c1v, *peu;
  const float *w2, *b2, *w3, *b3;
  float scale;
  float* out;
  int nr, ncl, f, f1, nt;
  cudaStream_t stream;
};

template <int H, int MODE, int G>
void launch(const Args& a) {
  using T = Types<MODE>;
  const dim3 grid((a.ncl + TILE_C - 1) / TILE_C, (a.nr + TILE_R - 1) / TILE_R,
                  a.nt);
  decode_fused_v2_kernel<H, MODE, G><<<grid, TILE_C, 0, a.stream>>>(
      static_cast<const typename T::Plane*>(a.pc),
      static_cast<const typename T::Plane*>(a.c1v),
      static_cast<const typename T::Pe*>(a.peu), a.w2, a.b2, a.w3, a.b3,
      a.scale, a.out, a.nr, a.ncl, a.f, a.f1);
}

template <int H, int MODE>
bool dispatch_gelu(int gelu_id, const Args& a) {
  switch (gelu_id) {
    case kExact: launch<H, MODE, kExact>(a); return true;
    case kTanh: launch<H, MODE, kTanh>(a); return true;
    case kQuick: launch<H, MODE, kQuick>(a); return true;
    case kPoly: launch<H, MODE, kPoly>(a); return true;
    case kErfPoly: launch<H, MODE, kErfPoly>(a); return true;
    case kTanhErf: launch<H, MODE, kTanhErf>(a); return true;
  }
  return false;
}

template <int H>
bool dispatch_mode(int mode, int gelu_id, const Args& a) {
  switch (mode) {
    case kF32: return dispatch_gelu<H, kF32>(gelu_id, a);
    case kBF16: return dispatch_gelu<H, kBF16>(gelu_id, a);
    case kI16: return dispatch_gelu<H, kI16>(gelu_id, a);
    case kSurgical: return dispatch_gelu<H, kSurgical>(gelu_id, a);
  }
  return false;
}

int decode(const void* pc, const void* c1v, const void* peu, const void* w2,
           const void* b2, const void* w3, const void* b3, float scale,
           void* out, int nt, int nr, int ncl, int hidden, int f, int f1,
           int mode, int gelu_id, void* stream) {
  if (nt <= 0 || nt > 65535 || nr <= 0 || ncl <= 0 || f <= 0 || f1 <= 0 ||
      nr % f || nr % f1 || (nr + TILE_R - 1) / TILE_R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{pc, c1v, peu,
               static_cast<const float*>(w2), static_cast<const float*>(b2),
               static_cast<const float*>(w3), static_cast<const float*>(b3),
               scale, static_cast<float*>(out), nr, ncl, f, f1, nt,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  switch (hidden) {
    case 16: ok = dispatch_mode<16>(mode, gelu_id, a); break;
    case 64: ok = dispatch_mode<64>(mode, gelu_id, a); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: one nr x ncl image; pc [nr/f][ncl][H], c1v [nr/f1 + 1][ncl][H],
// peu [nr][H] -> out [nr][ncl][3]
extern "C" int nic_decode_fused_v2(const void* pc, const void* c1v,
                                   const void* peu, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, float scale, void* out,
                                   int nr, int ncl, int hidden, int f, int f1,
                                   int mode, int gelu_id, void* stream) {
  return decode(pc, c1v, peu, w2, b2, w3, b3, scale, out, 1, nr, ncl, hidden,
                f, f1, mode, gelu_id, stream);
}

// K5: nt frames of nr x ncl; pc [nt][nr/f][ncl][H], c1v [nt][nr/f1 + 1]
// [ncl][H], peu [nr][H] (shared) -> out [nt][nr][ncl][3]
extern "C" int nic_decode_fused_3d(const void* pc, const void* c1v,
                                   const void* peu, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, float scale, void* out,
                                   int nt, int nr, int ncl, int hidden, int f,
                                   int f1, int mode, int gelu_id,
                                   void* stream) {
  return decode(pc, c1v, peu, w2, b2, w3, b3, scale, out, nt, nr, ncl, hidden,
                f, f1, mode, gelu_id, stream);
}

extern "C" const char* nic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
