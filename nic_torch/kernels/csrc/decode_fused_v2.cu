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
// columns, its threads walking the TILE_R rows. W2 (transposed), b2, W3
// and b3 are staged in shared memory once per block; z1 and gelu(z1) stay
// in registers (H floats).
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
// Built for H = 16, 64 and 128 (at 128 the tail reads W2 from device
// memory, decode_common.cuh); the wrapper zero-pads other widths up to the
// next of them (nic_torch/kernels/_widths.py).
//
// The GELUs, the plane modes, the plane-row loads and the MLP tail live in
// decode_common.cuh, shared with K2 (decode_z1mm.cu, this kernel with its
// z1 build replaced), K3 (decode_fused.cu) and K4 (decode_fused_v3.cu).
//
// Entry points: nic_decode_fused_v2 (K1) and nic_decode_fused_3d (K5),
// plain C, loaded with ctypes. Each launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include "decode_common.cuh"

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
    case 128: ok = dispatch_mode<128>(mode, gelu_id, a); break;
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
