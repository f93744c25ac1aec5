// The v1 fused 2D decode, for Hopper (sm_90a): per output pixel, the G0/G1
// lattice gather and interpolation, the positional encoding and the LOD
// constant feed the whole decoder MLP, in one kernel.
//
// Replaces the Pallas TPU kernel nic/kernels/decode_fused.py
// `_decode_kernel` (:124), launched by `_decode_fused_2d` (pallas_call at
// :258), K3. For output pixel (r, c) of an n x n decode at e = mip -
// 2 (level + 1), grids G0 [C][s0][s0] and G1 [C][s1][s1] in the grid dtype:
//
//   G0: the four corners at floor((r, c) * 2^e) + (0|1, 0|1): a nearest
//       upsample for e < 0, a strided take for e >= 0;
//   G1: bilinear at (r, c) * 2^(e-1) with the periodic fraction
//       ((r mod 2^(1-e)) / 2^(1-e)) for e <= 0; the four corners summed raw
//       for e == 1 (the reference's step == 2 quirk); corner (0, 0) for
//       e >= 2, where the coordinates land on nodes;
//   PE: triangular (with the zero rows of nic/kernels/decode_fused.py
//       `_pe_table_1d`) or sinusoidal, per axis, at (r, c) * 2^(e-1);
//   x = [4 G0 corners (C each) | G1 (C) | PE rows | PE cols | lod] rounded
//       to the grid dtype; rgb = sigmoid(gelu(gelu(x . W1 + b1) . W2 + b2)
//       . W3 + b3), dots on grid-dtype inputs with fp32 sums, the A&S erf
//       GELU.
//
// Three bodies, picked by the caller (`body`, from nic_torch/kernels/
// _widths.py decode_body), which refuses any other pairing:
//
// decode_v1_mma (H = 64 and 128) puts x W1 and the tail on the tensor
// cores. Blocks of 16 warps (fewer where shared memory leaves no room)
// walk tiles of `warps` image rows x 16 columns, warp w taking row w. The
// lanes form the warp's [16][F] feature tile in shared memory (v1_feature,
// rounded to the grid dtype, F padded with zeros to a multiple of 16: 80
// at F = 73), neighbouring lanes on neighbouring pixels of one feature.
// z1 = x W1 + b1 runs as m16n8 products (bf16 m16n8k16 for bf16 grids,
// 3xTF32 for fp32) with W1 staged once per block in the B-fragment layout
// (decode_mma.cuh stage_b_tile, the feature order of the A tile), one
// 64-unit output block at a time; the first GELU runs on its
// accumulators, and K1's tensor-core tail (decode_mma.cuh mma_tail)
// follows. Where W1 and W2 whole leave no room for four warps (fp32 at
// H = 128, or a large F), both are streamed through one 64 x 64 tile, the
// features in 64-feature chunks. The exact GELU takes its exponential and
// reciprocal from the hardware (gelu's kFast), as K1's does.
//
// decode_fused_v1_kernel (H = 16) keeps the CUDA-core design: one thread
// per pixel, a block of 128 columns whose threads walk `rows` rows
// (fused_rows_per_block, the JAX block picker), W1 and the tail weights
// staged once per block (W1 read from device memory where it does not fit
// in shared memory); each feature is formed in a register and folded into
// the H first-layer sums at once, then the tail of decode_common.cuh.
//
// decode_v1_wide (past H = 128, any multiple of 64): a block per 16 pixels
// of a row, whose features go by 64-feature chunks into shared memory and
// z1 = x W1 + b1 into the wide tail's [16][H] tile (decode_common.cuh).
//
// Neither x nor the feature matrix reaches device memory (the whole point
// of v1). The grids are read in their [C, S, S] layout through L2
// (neighbouring lanes read neighbouring nodes; the flagship's level 0 is
// 0.8 MB): the channel-last relayout and the VMEM window slicing of the
// TPU kernel are not carried over.
//
// What bounds it: 2*(F*H + H*H + 3*H) = 17,920 flop a pixel at F = 73,
// H = 64 (twice K1's, which folds W1 into the grids): 75 GFLOP at 2048^2,
// 0.46 ms of 3xTF32 at 495/3 TFLOP/s (1.12 ms on the fp32 CUDA cores),
// 0.08 ms in bf16; the grids it reads are a few MB. Forming the features
// takes ~100 scattered grid loads and the PE's transcendentals a pixel.
//
// Entry point: nic_decode_fused_v1 (plain C, loaded with ctypes). It
// launches on the given stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().

#include <type_traits>

#include "decode_mma.cuh"

namespace {

using namespace nic_decode;

constexpr int THREADS = 128;

// one decoder-input feature into the H first-layer sums
template <int H, bool kBf16>
__device__ __forceinline__ void feed(float x, const float4* __restrict__ wf,
                                     float (&z)[H]) {
  if (kBf16) x = bf16_round(x);
NIC_UNROLL_H(H / 4)
  for (int k4 = 0; k4 < H / 4; ++k4) {
    const float4 w = wf[k4];
    z[4 * k4] = fmaf(x, w.x, z[4 * k4]);
    z[4 * k4 + 1] = fmaf(x, w.y, z[4 * k4 + 1]);
    z[4 * k4 + 2] = fmaf(x, w.z, z[4 * k4 + 2]);
    z[4 * k4 + 3] = fmaf(x, w.w, z[4 * k4 + 3]);
  }
}

// PE row p of one axis at coordinate x (nic_torch/core/encodings.py)
__device__ __forceinline__ float pe_value(float x, int p, int pe, int tri,
                                          float pe_scale) {
  if (tri) {
    const int j = pe - 1 - p;
    if (j == 0 || j >= 2 * (pe / 2)) return 0.0f;
    const float y = ldexpf(x, -(j / 2)) - ((j % 2 == 0) ? 0.5f : 0.0f);
    const float m = y - 2.0f * floorf(y * 0.5f);  // floored mod 2
    return 2.0f * fabsf(m - 1.0f) - 1.0f;
  }
  const float w = expf(static_cast<float>(p / 2 * 2) * pe_scale);
  const float phase = x * w;
  return (p % 2 == 0) ? sinf(phase) : cosf(phase);
}

template <int H, typename T>
__global__ void __launch_bounds__(THREADS)
decode_fused_v1_kernel(const T* __restrict__ g0, const T* __restrict__ g1,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ out,
                       int n, int nch, int s0, int s1, int e, int pe, int tri,
                       float pe_scale, float lod, int rows, int w1_smem) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ TailSmem<H> sm;
  __shared__ float sb1[H];
  const int nfeat = 5 * nch + 2 * pe + 1;
  // W1 [F][H/4] in shared memory, or read from device memory when it did
  // not fit there (the launch gives no dynamic shared memory then)
  const float4* sw1 = w1_smem ? reinterpret_cast<const float4*>(dyn)
                              : reinterpret_cast<const float4*>(w1);
  stage_tail<H>(sm, w2, b2, w3, b3);
  if (w1_smem)
    for (int i = threadIdx.x; i < nfeat * H; i += THREADS)
      reinterpret_cast<float*>(dyn)[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += THREADS) sb1[i] = b1[i];
  __syncthreads();

  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= n) return;
  const size_t plane0 = static_cast<size_t>(s0) * s0;
  const size_t plane1 = static_cast<size_t>(s1) * s1;
  for (int rr = 0; rr < rows; ++rr) {
    const int r = blockIdx.y * rows + rr;
    if (r >= n) return;
    float z[H];
NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) z[k] = 0.0f;
    const float4* wf = sw1;

    // G0: four corners, C channels each, in corner-major order
    const int y0 = e < 0 ? (r >> -e) : (r << e);
    const int x0 = e < 0 ? (c >> -e) : (c << e);
    for (int k = 0; k < 4; ++k) {
      const T* q = g0 + static_cast<size_t>(y0 + (k >> 1)) * s0 + x0 + (k & 1);
      for (int ch = 0; ch < nch; ++ch, wf += H / 4)
        feed<H, kBf16>(to_float(q[ch * plane0]), wf, z);
    }

    // G1 at half resolution
    if (e <= 0) {
      const int sh = 1 - e;  // period f1 = 2^sh pixels
      const float fu = ldexpf(static_cast<float>(r & ((1 << sh) - 1)), -sh);
      const float fv = ldexpf(static_cast<float>(c & ((1 << sh) - 1)), -sh);
      const float w00 = (1.0f - fu) * (1.0f - fv), w01 = (1.0f - fu) * fv;
      const float w10 = fu * (1.0f - fv), w11 = fu * fv;
      const T* q = g1 + static_cast<size_t>(r >> sh) * s1 + (c >> sh);
      for (int ch = 0; ch < nch; ++ch, wf += H / 4) {
        const T* p = q + ch * plane1;
        float g = to_float(p[0]) * w00;
        g = g + to_float(p[1]) * w01;
        g = g + to_float(p[s1]) * w10;
        g = g + to_float(p[s1 + 1]) * w11;
        feed<H, kBf16>(g, wf, z);
      }
    } else if (e == 1) {  // the step == 2 quirk: corners summed raw
      const T* q = g1 + static_cast<size_t>(r) * s1 + c;
      for (int ch = 0; ch < nch; ++ch, wf += H / 4) {
        const T* p = q + ch * plane1;
        const float g = ((to_float(p[0]) + to_float(p[1])) + to_float(p[s1])) +
                        to_float(p[s1 + 1]);
        feed<H, kBf16>(g, wf, z);
      }
    } else {  // e >= 2: on the nodes, corner (0, 0)
      const T* q = g1 + static_cast<size_t>(r << (e - 1)) * s1 + (c << (e - 1));
      for (int ch = 0; ch < nch; ++ch, wf += H / 4)
        feed<H, kBf16>(to_float(q[ch * plane1]), wf, z);
    }

    // PE rows, PE columns, at G1-resolution coordinates; then the LOD
    const float u = ldexpf(static_cast<float>(r), e - 1);
    const float v = ldexpf(static_cast<float>(c), e - 1);
    for (int p = 0; p < pe; ++p, wf += H / 4)
      feed<H, kBf16>(pe_value(u, p, pe, tri, pe_scale), wf, z);
    for (int p = 0; p < pe; ++p, wf += H / 4)
      feed<H, kBf16>(pe_value(v, p, pe, tri, pe_scale), wf, z);
    feed<H, kBf16>(lod, wf, z);

NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) z[k] += sb1[k];
    mlp_tail<H, kExact, kBf16>(z, sm,
                               out + (static_cast<size_t>(r) * n + c) * 3);
  }
}

template <int H, typename T>
int launch(const void* g0, const void* g1, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* w3, const float* b3,
           float* out, int n, int nch, int s0, int s1, int e, int pe,
           int tri, float pe_scale, float lod, int rows,
           cudaStream_t stream) {
  auto kern = decode_fused_v1_kernel<H, T>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t w1_bytes = static_cast<size_t>(5 * nch + 2 * pe + 1) * H * 4;
  const int w1_smem = w1_bytes + attr.sharedSizeBytes <= kMaxSmem;
  const size_t smem = w1_smem ? w1_bytes : 0;
  err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + THREADS - 1) / THREADS, (n + rows - 1) / rows);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(g0), static_cast<const T*>(g1), w1, b1, w2, b2,
      w3, b3, out, n, nch, s0, s1, e, pe, tri, pe_scale, lod, rows, w1_smem);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// the G1 term of channel plane pl at pixel (r, c), as
// decode_fused_v1_kernel forms it
template <typename T>
__device__ __forceinline__ float g1_value(const T* __restrict__ pl, int r,
                                          int c, int s1, int e) {
  if (e <= 0) {
    const int sh = 1 - e;
    const float fu = ldexpf(static_cast<float>(r & ((1 << sh) - 1)), -sh);
    const float fv = ldexpf(static_cast<float>(c & ((1 << sh) - 1)), -sh);
    const T* p = pl + static_cast<size_t>(r >> sh) * s1 + (c >> sh);
    float g = to_float(p[0]) * ((1.0f - fu) * (1.0f - fv));
    g = g + to_float(p[1]) * ((1.0f - fu) * fv);
    g = g + to_float(p[s1]) * (fu * (1.0f - fv));
    g = g + to_float(p[s1 + 1]) * (fu * fv);
    return g;
  }
  if (e == 1) {
    const T* p = pl + static_cast<size_t>(r) * s1 + c;
    return ((to_float(p[0]) + to_float(p[1])) + to_float(p[s1])) +
           to_float(p[s1 + 1]);
  }
  return to_float(pl[static_cast<size_t>(r << (e - 1)) * s1 + (c << (e - 1))]);
}

// feature f of pixel (r, c), as decode_fused_v1_kernel feeds them: four
// G0 corners x C, G1 (C), PE rows, PE columns, the LOD
template <typename T>
__device__ float v1_feature(int f, const T* __restrict__ g0,
                            const T* __restrict__ g1, int r, int c, int nch,
                            int s0, int s1, int e, int pe, int tri,
                            float pe_scale, float lod) {
  if (f < 4 * nch) {
    const int k = f / nch, ch = f % nch;
    const int y0 = e < 0 ? (r >> -e) : (r << e);
    const int x0 = e < 0 ? (c >> -e) : (c << e);
    return to_float(g0[static_cast<size_t>(ch) * s0 * s0 +
                       static_cast<size_t>(y0 + (k >> 1)) * s0 + x0 +
                       (k & 1)]);
  }
  f -= 4 * nch;
  if (f < nch)
    return g1_value<T>(g1 + static_cast<size_t>(f) * s1 * s1, r, c, s1, e);
  f -= nch;
  if (f < pe) return pe_value(ldexpf(static_cast<float>(r), e - 1), f, pe, tri,
                              pe_scale);
  f -= pe;
  if (f < pe) return pe_value(ldexpf(static_cast<float>(c), e - 1), f, pe, tri,
                              pe_scale);
  return lod;
}

// ---- decode_v1_mma: the whole MLP on the tensor cores --------------------

constexpr int VT = 512;  // threads of a full decode_v1_mma block: 16 warps

// bytes of a decode_v1_mma block of `warps` warps at H = 64 nb with F
// padded to fp: with `whole`, W1 as nb B tiles of fp rows and the nb^2 W2
// tiles, else one streamed 64 x 64 tile for both; W3 [H][3], b1, b2, b3;
// and per warp its output rows, its feature tile [16][cols + 8] (cols =
// fp, or a 64-feature chunk when streamed) and past H = 64 its h1 slots
__host__ inline size_t v1_bytes(int warps, int nb, int fp, bool whole,
                                bool bf) {
  const size_t tile = bf ? kTileBf16 : kTileTf32;
  const size_t w1 = static_cast<size_t>(nb) * 64 * (fp / 2 + 4) * (bf ? 4 : 16);
  const int cols = whole ? fp : 64;
  return (whole ? w1 + nb * nb * tile : tile) +
         20 * 64 * static_cast<size_t>(nb) + 16 +
         static_cast<size_t>(warps) *
             (192 + 16 * (cols + 8) * 4 +
              (nb > 1 ? nb * (bf ? 2048 : 4096) : 0));
}

// features k0 .. k0 + kn - 1 of the warp's 16 pixels (columns c0 ..
// c0 + 15 of row r, clamped inside the image) into its tile x [16][xs],
// rounded to the grid dtype, zero past nfeat: v1_feature's values, formed
// group by group (lane = pixel + 16 x the parity of the channel or PE
// row it takes), so that no lane divides by C
template <typename T>
__device__ __forceinline__ void v1_features(
    float* x, int xs, int k0, int kn, int nfeat, const T* __restrict__ g0,
    const T* __restrict__ g1, int r, int c0, int n, int nch, int s0, int s1,
    int e, int pe, int tri, float pe_scale, float lod, int lane) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  const int p = lane % 16, half = lane / 16, k1 = k0 + kn;
  const int c = min(c0 + p, n - 1);
  float* xp = x + p * xs - k0;  // feature f of pixel p at xp[f]
  auto put = [&](int f, float v) {
    if (f >= k0 && f < k1) xp[f] = kBf ? bf16_round(v) : v;
  };
  const size_t plane0 = static_cast<size_t>(s0) * s0;
  const size_t plane1 = static_cast<size_t>(s1) * s1;
  // G0: four corners x C, corner-major (a channel's four loads, and two
  // channels', in flight together)
  const int y0 = e < 0 ? (r >> -e) : (r << e);
  const int x0 = e < 0 ? (c >> -e) : (c << e);
  if (k0 < 4 * nch) {
    const T* q = g0 + static_cast<size_t>(y0) * s0 + x0;
#pragma unroll 2
    for (int ch = half; ch < nch; ch += 2) {
      const T* qc = q + ch * plane0;
      const float v0 = to_float(qc[0]), v1 = to_float(qc[1]);
      const float v2 = to_float(qc[s0]), v3 = to_float(qc[s0 + 1]);
      put(ch, v0);
      put(nch + ch, v1);
      put(2 * nch + ch, v2);
      put(3 * nch + ch, v3);
    }
  }
  // G1, then PE rows and columns at G1-resolution coordinates, the LOD
  if (k0 < 5 * nch && k1 > 4 * nch) {
#pragma unroll 2
    for (int ch = half; ch < nch; ch += 2)
      put(4 * nch + ch, g1_value<T>(g1 + ch * plane1, r, c, s1, e));
  }
  const float ur = ldexpf(static_cast<float>(r), e - 1);
  const float uc = ldexpf(static_cast<float>(c), e - 1);
  if (k1 > 5 * nch)
    for (int i = half; i < pe; i += 2) {
      put(5 * nch + i, pe_value(ur, i, pe, tri, pe_scale));
      put(5 * nch + pe + i, pe_value(uc, i, pe, tri, pe_scale));
    }
  if (half == 0) put(nfeat - 1, lod);
  for (int f = max(nfeat, k0) + half; f < k1; f += 2) xp[f] = 0.0f;
}

// The v1 decode on the tensor cores for H = 64 (kOne, h1 in registers)
// and wider multiples of 64 (h1 parked in slots). A block tile is `warps`
// image rows x 16 columns (blocks walk the tiles), warp w taking row w.
// The warp forms its pixels' feature tile, then per 64-unit block jb
// z1 = x W1 + b1 (feature_product over W1's B tiles), the first GELU on
// the accumulators, and K1's tail (mma_tail). With `whole`, W1 (nb B
// tiles of fp rows) and W2 are staged once per block and the feature tile
// holds all fp features; else one 64 x 64 tile takes W1's and W2's tiles
// in turn and the features go by 64-feature chunks, formed again for each
// block jb. bf16 grids: bf16 products (exact) with fp32 sums; fp32:
// 3xTF32.
template <typename T, bool kOne>
__global__ void __launch_bounds__(VT, 1)
decode_v1_mma(const T* __restrict__ g0, const T* __restrict__ g1,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              float* __restrict__ out, int n, int nch, int s0, int s1, int e,
              int pe, int tri, float pe_scale, float lod, int H,
              int whole_w) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 v1_smem[];
  const int nb = kOne ? 1 : H / 64;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int nfeat = 5 * nch + 2 * pe + 1, fp = (nfeat + 15) / 16 * 16;
  const bool whole = whole_w != 0;
  const int cols = whole ? fp : 64, xs = cols + 8;
  const size_t tile_bytes = kBf ? kTileBf16 : kTileTf32;
  const size_t w1_block = 64 * static_cast<size_t>(fp / 2 + 4) * (kBf ? 4 : 16);
  unsigned char* sW1 = reinterpret_cast<unsigned char*>(v1_smem);
  unsigned char* sW2 = whole ? sW1 + nb * w1_block : sW1;
  float* sW3 = reinterpret_cast<float*>(
      whole ? sW2 + nb * nb * tile_bytes : sW1 + tile_bytes);
  float* sb1 = sW3 + 3 * H;
  float* sb2 = sb1 + H;
  float* sb3 = sb2 + H;
  float* sOut = sb3 + 4 + 48 * warp;
  float* x = sb3 + 4 + 48 * warps + warp * 16 * xs;
  float* slot = sb3 + 4 + 48 * warps + warps * 16 * xs +
                warp * nb * (kBf ? 16 : 32) * 32;

  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sW3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  if (threadIdx.x < 3) sb3[threadIdx.x] = b3[threadIdx.x];
  if (whole) {
    for (int jb = 0; jb < nb; ++jb)
      stage_b_tile<kBf>(sW1 + jb * w1_block, w1, H, 0, fp, nfeat, jb * 64);
    for (int kb = 0; kb < nb; ++kb)
      for (int jb = 0; jb < nb; ++jb)
        stage_w2_tile<kBf>(sW2 + (kb * nb + jb) * tile_bytes, w2, H, kb, jb);
  }
  __syncthreads();

  const int bands = (n + warps - 1) / warps, ctiles = (n + 15) / 16;
  const int tiles = bands * ctiles;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = (tile / ctiles) * warps + warp, c0 = (tile % ctiles) * 16;
    // this warp's pixels, stored if row < n and c < n; the others' features
    // are formed clamped inside the image
    const int cnt = row < n ? min(16, n - c0) : 0;
    const int r = min(row, n - 1);
    float h1[8][4];
    for (int jb = 0; jb < nb; ++jb) {
      float d[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[nt][i] = 0.0f;
      for (int k0 = 0; k0 < fp; k0 += cols) {
        const int kn = min(cols, fp - k0);
        if (!whole || jb == 0) {  // the tile's features (once when whole)
          __syncwarp();
          v1_features<T>(x, xs, k0, kn, nfeat, g0, g1, r, c0, n, nch, s0, s1,
                         e, pe, tri, pe_scale, lod, lane);
          __syncwarp();
        }
        const unsigned char* wt = sW1 + jb * w1_block;
        if (!whole) {
          __syncthreads();
          stage_b_tile<kBf>(sW1, w1, H, k0, kn, nfeat, jb * 64);
          __syncthreads();
          wt = sW1;
        }
        feature_product<kBf>(d, x, xs, wt, kn, g, q);
      }
      // h1 = first_act(z1 + b1) on the accumulators
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h1[nt][i] = first_act<kExact, kBf, true>(
              d[nt][i] + sb1[jb * 64 + 8 * nt + 2 * q + (i & 1)]);
      if (!kOne) park_h1<kBf>(slot, jb, lane, h1);
    }
    // layers 2 and 3 (decode_mma.cuh)
    mma_tail<kBf, kExact, kOne>(
        h1, nb, whole, sW2, w2, H, sW3, sb2, sb3, sOut, slot,
        [&] { return out + (static_cast<size_t>(r) * n + c0) * 3; }, cnt, g,
        q, lane);
  }
}

// the tensor-core body: 16 warps a block with W1 and W2 whole, or fewer
// (down to 4); else both streamed through one tile, on as many warps (16,
// 8, 4, 2, 1) as fit; as many blocks as stay resident, each walking tiles
template <typename T, bool kOne>
int launch_mma(const void* g0, const void* g1, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, float* out, int n, int nch,
               int s0, int s1, int hidden, int e, int pe, int tri,
               float pe_scale, float lod, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  const int nb = hidden / 64;
  const int fp = (5 * nch + 2 * pe + 1 + 15) / 16 * 16;
  bool whole = true;
  auto bytes = [&](int w) { return v1_bytes(w, nb, fp, whole, kBf); };
  int warps = fit_warps(VT / 32, 4, bytes);
  if (!warps) {
    whole = false;
    warps = fit_warps(VT / 32, 1, bytes);
  }
  if (!warps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bytes(warps);
  auto kern = decode_v1_mma<T, kOne>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  const long long tiles = static_cast<long long>((n + warps - 1) / warps) *
                          ((n + 15) / 16);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  if (err == cudaSuccess)
    err = resident_grid(kern, 32 * warps, smem, tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(g0), static_cast<const T*>(g1), w1, b1, w2, b2,
      w3, b3, out, n, nch, s0, s1, e, pe, tri, pe_scale, lod, hidden,
      static_cast<int>(whole));
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// past H = 128: a block per WR columns of one output row; the features go
// in chunks of 64 into the wide tile's feature slab, and z1 = x W1 + b1 is
// summed into the z1 tile by 64-unit column blocks (W1 read from device
// memory, thread (c, pg) owning unit c for rows pg + 4 i); then the wide
// tail (decode_common.cuh)
template <typename T>
__global__ void __launch_bounds__(WT)
decode_v1_wide(const T* __restrict__ g0, const T* __restrict__ g1,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ w3, const float* __restrict__ b3,
               float* __restrict__ out, int n, int nch, int s0, int s1,
               int e, int pe, int tri, float pe_scale, float lod, int H) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 wide_smem[];
  const WideSmem sm(reinterpret_cast<float*>(wide_smem), H);
  const int r = blockIdx.y, c0 = blockIdx.x * WR;
  const int cnt = min(WR, n - c0);
  const int nfeat = 5 * nch + 2 * pe + 1;
  const int tid = threadIdx.x, cu = tid % WCB, pg = tid / WCB;
  for (int f0 = 0; f0 < nfeat; f0 += WCB) {
    __syncthreads();
    for (int i = tid; i < WR * WCB; i += WT) {
      const int p = i / WCB, j = i % WCB;
      float v = 0.0f;
      if (p < cnt && f0 + j < nfeat) {
        v = v1_feature<T>(f0 + j, g0, g1, r, c0 + p, nch, s0, s1, e, pe, tri,
                          pe_scale, lod);
        if (kBf16) v = bf16_round(v);
      }
      sm.x[i] = v;
    }
    __syncthreads();
    const int nj = min(WCB, nfeat - f0);
    for (int kb = 0; kb < H / WCB; ++kb) {
      float acc[WR / 4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < nj; ++j) {
        const float w =
            __ldg(w1 + static_cast<size_t>(f0 + j) * H + kb * WCB + cu);
#pragma unroll
        for (int i = 0; i < WR / 4; ++i)
          acc[i] = fmaf(sm.x[(pg + 4 * i) * WCB + j], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < WR / 4; ++i) {
        float* z = sm.z + (pg + 4 * i) * H + kb * WCB + cu;
        *z = (f0 == 0 ? acc[i] : *z + acc[i]) +
             (f0 + WCB >= nfeat ? __ldg(b1 + kb * WCB + cu) : 0.0f);
      }
    }
  }
  __syncthreads();
  wide_tail<kExact, kBf16>(sm, H, w2, b2, w3, b3,
                           out + (static_cast<size_t>(r) * n + c0) * 3, cnt);
}

template <typename T>
int launch_wide(const void* g0, const void* g1, const float* w1,
                const float* b1, const float* w2, const float* b2,
                const float* w3, const float* b3, float* out, int n, int nch,
                int s0, int s1, int hidden, int e, int pe, int tri,
                float pe_scale, float lod, cudaStream_t stream) {
  const size_t smem = sizeof(float) * wide_floats(hidden);
  if (smem > kMaxSmem || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_v1_wide<T>;
  const cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + WR - 1) / WR, n);
  kern<<<grid, WT, smem, stream>>>(
      static_cast<const T*>(g0), static_cast<const T*>(g1), w1, b1, w2, b2,
      w3, b3, out, n, nch, s0, s1, e, pe, tri, pe_scale, lod, hidden);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// the per-pixel bodies by the caller's id (nic_torch/kernels/
// decode_fused.py _BODY_IDS)
enum Body { kCudaCore = 0, kMma = 1, kWide = 2 };

template <int H, int B, typename T>
int launch_h(const void* g0, const void* g1, const float* w1, const float* b1,
             const float* w2, const float* b2, const float* w3,
             const float* b3, float* out, int n, int nch, int s0, int s1,
             int e, int pe, int tri, float pe_scale, float lod, int rows,
             cudaStream_t s) {
  if constexpr (B == kMma)
    return launch_mma<T, H == 64>(g0, g1, w1, b1, w2, b2, w3, b3, out, n, nch,
                                  s0, s1, H, e, pe, tri, pe_scale, lod, s);
  else
    return launch<H, T>(g0, g1, w1, b1, w2, b2, w3, b3, out, n, nch, s0, s1,
                        e, pe, tri, pe_scale, lod, rows, s);
}

}  // namespace

// K3: g0 [C][s0][s0], g1 [C][s1][s1] (fp32, or bf16 with bf16 = 1), w1
// [5C + 2pe + 1][H] fp32 -> out [n][n][3] fp32; body kCudaCore at H = 16,
// kMma at H = 64 and 128, kWide at any multiple of 64 up to 3264
extern "C" int nic_decode_fused_v1(const void* g0, const void* g1,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2,
                                   const void* w3, const void* b3, void* out,
                                   int n, int nch, int s0, int s1, int hidden,
                                   int e, int pe, int tri, float pe_scale,
                                   float lod, int rows, int bf16, int body,
                                   void* stream) {
  if (n <= 0 || nch <= 0 || pe < 0 || rows <= 0 || e < -30 || e > 30 ||
      (n + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fw3 = static_cast<const float*>(w3);
  const auto* fb3 = static_cast<const float*>(b3);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
#define NIC_V1(H, B)                                                         \
  if (hidden == H && body == B)                                              \
    return bf16 ? launch_h<H, B, __nv_bfloat16>(                             \
                      g0, g1, fw1, fb1, fw2, fb2, fw3, fb3, o, n, nch, s0,   \
                      s1, e, pe, tri, pe_scale, lod, rows, s)                \
                : launch_h<H, B, float>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3, \
                                        o, n, nch, s0, s1, e, pe, tri,       \
                                        pe_scale, lod, rows, s)
  NIC_V1(16, kCudaCore);
  NIC_V1(64, kMma);
  NIC_V1(128, kMma);
#undef NIC_V1
  if (body == kWide && hidden > 128 && hidden % WCB == 0) {
    if (bf16)
      return launch_wide<__nv_bfloat16>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3,
                                        o, n, nch, s0, s1, hidden, e, pe, tri,
                                        pe_scale, lod, s);
    return launch_wide<float>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3, o, n, nch,
                              s0, s1, hidden, e, pe, tri, pe_scale, lod, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
