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
// Two bodies, picked by the caller (`body`, from nic_torch/kernels/
// _widths.py decode_body), which refuses any other pairing:
//
// decode_v2_mma (H = 64 and every wider multiple of 64, every plane mode)
// puts both products on the tensor cores. Blocks of 8 warps (fewer where
// a wide H leaves no room) walk tiles of 8 image rows x 16 columns, warp w
// taking row w; a volume's frames follow one another. A warp builds its 16
// pixels' z1 straight into the m16n8 accumulator layout (each lane two
// pixels x two units per 8-unit n-tile), applies the first GELU on that
// fragment, and uses it as the A operand of h1 W2 with no shared-memory
// round trip at H = 64 (wider: h1 waits in per-lane slots in shared
// memory). The output is walked in 64-column blocks; the second GELU runs
// on each block's accumulators, which are then the A operand of the
// product with W3 padded to n = 8, accumulated over the blocks; then the
// sigmoid, and rgb staged per warp and written as consecutive floats. W2
// is staged in shared memory once per block up to H = 128 and streamed by
// 64 x 64 tiles past it. Modes with bf16 dot inputs (bf16, i16, surgical)
// take m16n8k16 bf16 products, exact in fp32, so only the summation order
// differs from the CUDA-core body. fp32 takes m16n8k8 tf32 products of
// each operand's hi and lo parts (al bh + ah bl + ah bh; the dropped al bl
// is ~2^-22 of a product), the W2 tiles staged as hi/lo pairs. The exact
// GELU takes its exponential and reciprocal from the hardware (gelu's
// kFast, decode_common.cuh): with the precise expf and 1/x it took 0.9 ms
// of the 2048^2 kernel's 2.2 (H100), and its outputs move by a few ulp,
// inside every fp32 limit (max|d| 4.2e-7 against the plain version, <= 1
// u8 LSB against the JAX fold).
// What bounds it: at 2048^2, H = 64, the dots are 36 GFLOP (0.04 ms of
// bf16 or ~0.1 ms of tf32 x 3 tensor work), and 2 x 64 GELUs per pixel
// (~20 instructions each) are ~0.35 ms of CUDA-core issue; the planes are
// ~0.4 GB of fp32 (0.12 ms of HBM), but each pixel reads its P row and two
// C1v rows (768 B in fp32) from L1 or L2. The measured 1.54 ms (fp32 exact)
// and 0.91 ms (bf16 poly; H100 80GB HBM3 at 700 W, scripts/torch_ab_decode.py) sit at
// ~2-3x those issue counts: the per-warp loads of a pixel tile are exposed
// latency at 16 warps per SM (ptxas: 128 registers, up to 32 B of spills
// in fp32 at H = 64; two blocks per SM; one block per SM with 178
// registers was slower, three with 80 registers and spills no faster).
// Staging the warp's h1 tile through shared memory with 512-byte loads
// instead was slower (1.10 against 0.91 ms at bf16 poly), so the
// fragments stay in registers.
//
// decode_fused_v2_kernel (H = 16) keeps the CUDA-core design: one thread
// per output pixel, a block TILE_R rows x 128 columns, W2 (transposed), b2,
// W3 and b3 in shared memory, z1 and gelu(z1) in registers.
//
// Rows are indexed directly: C1v already carries the nr/f1+1 rows a halo
// window would fetch, and ragged edges are masked, so there is no padding.
// A volume is a stack of such frames (the 3D frame stage, frame-PE
// included, runs before the kernel in PyTorch, nic_torch/kernels/
// decode_fused_3d.py `_prepare_3d`), each with its own P, C1v and output
// planes; the row-PE table and the weights are shared, and one launch
// covers the whole volume. The TPU-only devices of the JAX kernel (lane
// packing with block-diagonal weights, per-step weight tiling, planar
// output, the column-block retile) are not carried over. The wrapper
// zero-pads a width between 16 and 64, or between multiples of 64, to the
// next (nic_torch/kernels/_widths.py); a warp's tile fits up to H = 2432.
//
// decode_v2_mma's layers 2 and 3 and its tensor-core helpers live in
// decode_mma.cuh (mma_tail), shared with K2's decode_z1mm_mma
// (decode_z1mm.cu, this kernel with its z1 build replaced by a product),
// K3's decode_v1_mma (decode_fused.cu) and K4's mlp_tail_mma
// (decode_fused_v3.cu). The GELUs, the plane modes and the CUDA-core tail
// live in decode_common.cuh, shared with the CUDA-core bodies of K3 and
// K4.
//
// Entry points: nic_decode_fused_v2 (K1) and nic_decode_fused_3d (K5),
// plain C, loaded with ctypes. Each launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "decode_mma.cuh"

namespace {

using namespace nic_decode;

constexpr int TILE_C = 128;  // threads per block = pixel columns per block
constexpr int TILE_R = 4;    // pixel rows each block walks

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
  __shared__ TailSmem<H> sm;
  stage_tail<H>(sm, w2, b2, w3, b3);
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
NIC_UNROLL_H(H)
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
        h[k0 + i] = first_act<G, kDotBf16>((pv + (um * av + u * bv)) + e[i]);
      }
    }
    mlp_head<H, G, kDotBf16>(h, sm,
                             out + (static_cast<size_t>(r) * ncl + c) * 3);
  }
}

// ---- decode_v2_mma: the per-pixel stage on the tensor cores -------------

constexpr int MT = 256;            // threads of a full block: 8 warps
// bytes of a decode_v2_mma block of `warps` warps at H = 64 nb: the W2
// tiles (all of W2 for nb <= 2, else one streamed tile), W3 [H][3] and b2,
// b3, the warps' output rows, and past H = 64 the warps' h1 slots
__host__ __device__ inline size_t mma_bytes(int warps, int nb, bool bf) {
  const size_t tile = bf ? kTileBf16 : kTileTf32;
  return (nb <= 2 ? nb * nb : 1) * tile + 16 * 64 * static_cast<size_t>(nb) +
         16 + 192 * static_cast<size_t>(warps) +
         (nb > 1 ? static_cast<size_t>(warps) * nb * (bf ? 2048 : 4096) : 0);
}

// a pixel's plane rows and its interpolation weight
template <int MODE>
struct PixRows {
  const typename Types<MODE>::Plane *p, *a, *b;
  const typename Types<MODE>::Pe* e;
  float u, um;
};

// h1 = first_act(z1) of the warp's pixel rows g (px[0]) and g + 8 (px[1])
// for units 64 kb + 8 nt + 2 q + {0, 1}: the m16n8 accumulator layout of
// eight n-tiles, h[nt][2 s + i] = row g + 8 s, unit 8 nt + 2 q + i
template <int MODE, int G>
__device__ __forceinline__ void build_h1(float (&h)[8][4],
                                         const PixRows<MODE> (&px)[2],
                                         int kb, int q, float scale) {
  constexpr bool kBf = MODE != kF32;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int k = kb * 64 + 8 * nt + 2 * q;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float2 p = ld2(px[s].p + k), a = ld2(px[s].a + k), b = ld2(px[s].b + k);
      const float2 e = ld2(px[s].e + k);
      if (MODE == kI16) {
        p.x *= scale; p.y *= scale;
        a.x *= scale; a.y *= scale;
        b.x *= scale; b.y *= scale;
      }
      h[nt][2 * s] = first_act<G, kBf, true>(
          (p.x + (px[s].um * a.x + px[s].u * b.x)) + e.x);
      h[nt][2 * s + 1] = first_act<G, kBf, true>(
          (p.y + (px[s].um * a.y + px[s].u * b.y)) + e.y);
    }
  }
}

// The per-pixel stage on the tensor cores, for any H that is a multiple of
// 64 (kOne: H = 64, whose h1 stays in registers). A block tile is `warps`
// image rows x 16 columns of one frame (blocks walk the tiles; a volume's
// frames follow one another), warp w taking row w: the tile's rows share
// their C1v rows and, f at a time, their P rows, so the warps find them in
// L1. A warp builds its 16 pixels' z1 straight into the m16n8 accumulator
// layout and applies the first GELU there; h1 (kept per 64-unit block in
// registers at H = 64, else in the warp's slots in shared memory, each
// lane reading back only what it wrote) is the A operand of h1 W2, taken
// one 64-column block jb at a time; the second GELU runs on that block's
// accumulators, which are then the A operand of its product with W3
// (n = 8, three real columns). bf16 modes: m16n8k16 bf16 products (exact)
// with fp32 sums; fp32: m16n8k8 tf32 products of hi and lo parts (al bh +
// ah bl + ah bh). rgb is staged per warp and written as the warp's
// consecutive floats.
template <int MODE, int G, bool kOne>
__global__ void __launch_bounds__(MT, 2)
decode_v2_mma(const typename Types<MODE>::Plane* __restrict__ pc,
              const typename Types<MODE>::Plane* __restrict__ c1v,
              const typename Types<MODE>::Pe* __restrict__ peu,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              float scale, float* __restrict__ out, int nt, int nr, int ncl,
              int f, int f1, int H) {
  constexpr bool kBf = MODE != kF32;  // bf16 inputs to both dots
  extern __shared__ float4 mma_smem[];
  const int nb = kOne ? 1 : H / 64;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool whole = nb <= 2;
  const size_t tile_bytes = kBf ? kTileBf16 : kTileTf32;
  unsigned char* sW2 = reinterpret_cast<unsigned char*>(mma_smem);
  float* sW3 = reinterpret_cast<float*>(sW2 + (whole ? nb * nb : 1) *
                                                  tile_bytes);
  float* sb2 = sW3 + 3 * H;
  float* sb3 = sb2 + H;
  float* sOut = sb3 + 4 + 48 * warp;
  float* slot = sb3 + 4 + 48 * warps + warp * nb * (kBf ? 16 : 32) * 32;

  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sW3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb2[i] = b2[i];
  if (threadIdx.x < 3) sb3[threadIdx.x] = b3[threadIdx.x];
  if (whole)
    for (int kb = 0; kb < nb; ++kb)
      for (int jb = 0; jb < nb; ++jb)
        stage_w2_tile<kBf>(sW2 + (kb * nb + jb) * tile_bytes, w2, H, kb, jb);
  __syncthreads();

  // a block tile is `warps` image rows x 16 columns of one frame, warp w
  // taking row w: the tile's rows share their C1v rows and, f at a time,
  // their P rows, which the warps then read from L1
  const int bands = (nr + warps - 1) / warps, ctiles = (ncl + 15) / 16;
  const int per_frame = bands * ctiles, tiles = per_frame * nt;
  const size_t p_frame = static_cast<size_t>(nr / f) * ncl * H;
  const size_t c_frame = static_cast<size_t>(nr / f1 + 1) * ncl * H;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int fr = tile / per_frame, rem = tile - fr * per_frame;
    const int row = (rem / ctiles) * warps + warp, c0 = (rem % ctiles) * 16;
    // this warp's pixels, stored if row < nr and c < ncl; the loads of the
    // others are clamped inside the image
    const int cnt = row < nr ? min(16, ncl - c0) : 0;
    const int r = min(row, nr - 1);
    PixRows<MODE> px[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = min(c0 + g + 8 * s, ncl - 1);
      px[s].p = pc + fr * p_frame + (static_cast<size_t>(r / f) * ncl + c) * H;
      px[s].a = c1v + fr * c_frame +
                (static_cast<size_t>(r / f1) * ncl + c) * H;
      px[s].b = px[s].a + static_cast<size_t>(ncl) * H;
      px[s].e = peu + static_cast<size_t>(r) * H;
      px[s].u = static_cast<float>(r % f1) / static_cast<float>(f1);
      px[s].um = 1.0f - px[s].u;
    }

    // layer 1: h1 per 64-unit block, in registers (H = 64) or slots (as
    // park_h1 parks them; written out here, where ptxas then allocates
    // the registers it did before the tail moved to decode_mma.cuh)
    float h1[8][4];
    if (!kOne) {
      for (int kb = 0; kb < nb; ++kb) {
        build_h1<MODE, G>(h1, px, kb, q, scale);
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
    } else {
      build_h1<MODE, G>(h1, px, 0, q, scale);
    }
    // layers 2 and 3 (decode_mma.cuh)
    mma_tail<kBf, G, kOne>(
        h1, nb, whole, sW2, w2, H, sW3, sb2, sb3, sOut, slot,
        [&] { return out + ((static_cast<size_t>(fr) * nr + r) * ncl + c0) * 3; },
        cnt, g, q, lane);
  }
}

struct Args {
  const void *pc, *c1v, *peu;
  const float *w2, *b2, *w3, *b3;
  float scale;
  float* out;
  int nr, ncl, f, f1, nt, hidden;
  cudaStream_t stream;
};

// the CUDA-core body (H = 16)
template <int H, int MODE, int G>
cudaError_t launch(const Args& a) {
  using T = Types<MODE>;
  const dim3 grid((a.ncl + TILE_C - 1) / TILE_C, (a.nr + TILE_R - 1) / TILE_R,
                  a.nt);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kern = decode_fused_v2_kernel<H, MODE, G>;
  kern<<<grid, TILE_C, 0, a.stream>>>(
      static_cast<const typename T::Plane*>(a.pc),
      static_cast<const typename T::Plane*>(a.c1v),
      static_cast<const typename T::Pe*>(a.peu), a.w2, a.b2, a.w3, a.b3,
      a.scale, a.out, a.nr, a.ncl, a.f, a.f1);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

// the tensor-core body (kOne: H = 64, h1 in registers; else every wider
// multiple of 64, h1 in slots), on as many warps per block (8, 4, 2, 1) as
// fit in shared memory, as many blocks as stay resident, each walking
// tiles
template <int MODE, int G, bool kOne>
cudaError_t launch_mma(const Args& a) {
  using T = Types<MODE>;
  constexpr bool kBf = MODE != kF32;
  const int nb = a.hidden / 64;
  const int warps = fit_warps(MT / 32, 1, [&](int w) {
    return mma_bytes(w, nb, kBf);
  });
  if (!warps) return cudaErrorInvalidValue;  // past the widest
  const size_t smem = mma_bytes(warps, nb, kBf);
  auto kern = decode_v2_mma<MODE, G, kOne>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(a.nt) *
                          ((a.nr + warps - 1) / warps) * ((a.ncl + 15) / 16);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  int grid = 0;
  err = resident_grid(kern, 32 * warps, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, 32 * warps, smem, a.stream>>>(
      static_cast<const typename T::Plane*>(a.pc),
      static_cast<const typename T::Plane*>(a.c1v),
      static_cast<const typename T::Pe*>(a.peu), a.w2, a.b2, a.w3, a.b3,
      a.scale, a.out, a.nt, a.nr, a.ncl, a.f, a.f1, a.hidden);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

// the per-pixel bodies by the caller's id (nic_torch/kernels/
// decode_fused_v2.py _BODY_IDS): the CUDA-core body at its built width
// (dispatch_mode), the tensor-core body at kMmaMin (H = kMmaMin: h1 in
// registers) and every wider multiple of 64 (H = 0 here: h1 in slots)
enum Body { kCudaCore = 0, kMma = 1 };
constexpr int kMmaMin = 64;

template <int H, int MODE, int G, int B>
cudaError_t launch_body(const Args& a) {
  if constexpr (B == kMma)
    return launch_mma<MODE, G, H == kMmaMin>(a);
  else
    return launch<H, MODE, G>(a);
}

template <int H, int MODE, int B>
cudaError_t dispatch_gelu(int gelu_id, const Args& a) {
  switch (gelu_id) {
#define NIC_G(G) \
    case G: return launch_body<H, MODE, G, B>(a)
    NIC_G(kExact);
    NIC_G(kTanh);
    NIC_G(kQuick);
    NIC_G(kPoly);
    NIC_G(kErfPoly);
    NIC_G(kTanhErf);
#undef NIC_G
  }
  return cudaErrorInvalidValue;
}

template <int H, int B>
cudaError_t dispatch_planes(int mode, int gelu_id, const Args& a) {
  switch (mode) {
    case kF32: return dispatch_gelu<H, kF32, B>(gelu_id, a);
    case kBF16: return dispatch_gelu<H, kBF16, B>(gelu_id, a);
    case kI16: return dispatch_gelu<H, kI16, B>(gelu_id, a);
    case kSurgical: return dispatch_gelu<H, kSurgical, B>(gelu_id, a);
  }
  return cudaErrorInvalidValue;
}

template <int H>
cudaError_t dispatch_mode(int mode, int gelu_id, const Args& a) {
  return dispatch_planes<H, kCudaCore>(mode, gelu_id, a);
}

// body kCudaCore runs H = 16, kMma H = 64 and every wider multiple of 64
// (up to where a warp's tile still fits in shared memory); any other
// pairing is refused
int decode(const void* pc, const void* c1v, const void* peu, const void* w2,
           const void* b2, const void* w3, const void* b3, float scale,
           void* out, int nt, int nr, int ncl, int hidden, int f, int f1,
           int mode, int gelu_id, int body, void* stream) {
  if (nt <= 0 || nt > 65535 || nr <= 0 || ncl <= 0 || f <= 0 || f1 <= 0 ||
      nr % f || nr % f1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{pc, c1v, peu,
               static_cast<const float*>(w2), static_cast<const float*>(b2),
               static_cast<const float*>(w3), static_cast<const float*>(b3),
               scale, static_cast<float*>(out), nr, ncl, f, f1, nt, hidden,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (body == kCudaCore && hidden == 16)
    err = dispatch_mode<16>(mode, gelu_id, a);
  if (body == kMma && hidden == kMmaMin)
    err = dispatch_planes<kMmaMin, kMma>(mode, gelu_id, a);
  if (body == kMma && hidden > kMmaMin && hidden % 64 == 0)
    err = dispatch_planes<0, kMma>(mode, gelu_id, a);
  return static_cast<int>(err);
}


}  // namespace

// K1: one nr x ncl image; pc [nr/f][ncl][H], c1v [nr/f1 + 1][ncl][H],
// peu [nr][H] -> out [nr][ncl][3]
extern "C" int nic_decode_fused_v2(const void* pc, const void* c1v,
                                   const void* peu, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, float scale, void* out,
                                   int nr, int ncl, int hidden, int f, int f1,
                                   int mode, int gelu_id, int body,
                                   void* stream) {
  return decode(pc, c1v, peu, w2, b2, w3, b3, scale, out, 1, nr, ncl, hidden,
                f, f1, mode, gelu_id, body, stream);
}

// K5: nt frames of nr x ncl; pc [nt][nr/f][ncl][H], c1v [nt][nr/f1 + 1]
// [ncl][H], peu [nr][H] (shared) -> out [nt][nr][ncl][3]
extern "C" int nic_decode_fused_3d(const void* pc, const void* c1v,
                                   const void* peu, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, float scale, void* out,
                                   int nt, int nr, int ncl, int hidden, int f,
                                   int f1, int mode, int gelu_id, int body,
                                   void* stream) {
  return decode(pc, c1v, peu, w2, b2, w3, b3, scale, out, nt, nr, ncl, hidden,
                f, f1, mode, gelu_id, body, stream);
}

extern "C" const char* nic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
