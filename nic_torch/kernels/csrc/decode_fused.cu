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
// Design: one thread per pixel; a block is 128 columns, its threads
// walking `rows` rows (fused_rows_per_block, the JAX block picker). W1 and
// b1 (dynamic shared memory, F x H fp32) and K1's tail weights are staged
// once per block; any F runs: where F x H does not fit in shared memory
// (F > 838 at H = 64), W1 rows are read from device memory through L1.
// Built for H = 16, 64 and 128; the wrapper zero-pads other widths up to
// the next of them (nic_torch/kernels/_widths.py). Past 128, any multiple
// of 64 runs decode_v1_wide: a block per 16 pixels of a row, whose
// features go by 64-feature chunks into shared memory and z1 = x W1 + b1
// into the wide tail's [16][H] tile (decode_common.cuh). The feature row never exists: each feature is formed in
// a register and folded into the H first-layer sums at once, so neither x
// nor the feature matrix reaches device memory (the whole point of v1).
// The grids are read in their [C, S, S] layout through L2 (neighbouring
// threads read neighbouring nodes; the flagship's level 0 is 0.8 MB): the
// channel-last relayout and the VMEM window slicing of the TPU kernel are
// not carried over. The tail is K1's (decode_common.cuh).
//
// What bounds it: 2*(F*H + H*H + 3*H) = 17,920 flop a pixel at F = 73,
// H = 64 (twice K1's, which folds W1 into the grids), on fp32 CUDA cores:
// 75 GFLOP at 2048^2, 1.12 ms at 67 TFLOP/s; the grids it reads are a few
// MB. A tensor-core version would stage 64-pixel feature tiles in shared
// memory and run x . W1 and the tail as warpgroup products.
//
// Entry point: nic_decode_fused_v1 (plain C, loaded with ctypes). It
// launches on the given stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().

#include <type_traits>

#include "decode_common.cuh"

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
  if (f < nch) {
    const T* pl = g1 + static_cast<size_t>(f) * s1 * s1;
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
  f -= nch;
  if (f < pe) return pe_value(ldexpf(static_cast<float>(r), e - 1), f, pe, tri,
                              pe_scale);
  f -= pe;
  if (f < pe) return pe_value(ldexpf(static_cast<float>(c), e - 1), f, pe, tri,
                              pe_scale);
  return lod;
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

}  // namespace

// K3: g0 [C][s0][s0], g1 [C][s1][s1] (fp32, or bf16 with bf16 = 1), w1
// [5C + 2pe + 1][H] fp32 -> out [n][n][3] fp32; H = 16, 64, 128 or a
// multiple of 64 up to 3264 (the wide body)
extern "C" int nic_decode_fused_v1(const void* g0, const void* g1,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2,
                                   const void* w3, const void* b3, void* out,
                                   int n, int nch, int s0, int s1, int hidden,
                                   int e, int pe, int tri, float pe_scale,
                                   float lod, int rows, int bf16,
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
#define NIC_V1(H, T)                                                        \
  return launch<H, T>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3, o, n, nch, s0, \
                      s1, e, pe, tri, pe_scale, lod, rows, s)
  if (hidden == 64 && !bf16) NIC_V1(64, float);
  if (hidden == 64 && bf16) NIC_V1(64, __nv_bfloat16);
  if (hidden == 16 && !bf16) NIC_V1(16, float);
  if (hidden == 16 && bf16) NIC_V1(16, __nv_bfloat16);
  if (hidden == 128 && !bf16) NIC_V1(128, float);
  if (hidden == 128 && bf16) NIC_V1(128, __nv_bfloat16);
#undef NIC_V1
  if (hidden > 128 && hidden % WCB == 0) {
    if (bf16)
      return launch_wide<__nv_bfloat16>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3,
                                        o, n, nch, s0, s1, hidden, e, pe, tri,
                                        pe_scale, lod, s);
    return launch_wide<float>(g0, g1, fw1, fb1, fw2, fb2, fw3, fb3, o, n, nch,
                              s0, s1, hidden, e, pe, tri, pe_scale, lod, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
