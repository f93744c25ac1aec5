// The z1-matmul variant of the 2D folded decode's per-pixel stage, for
// Hopper (sm_90a): K1 (decode_fused_v2.cu) with its z1 build replaced by a
// product with a static matrix, sharing K1's MLP tail (decode_common.cuh).
// It is a source of its own so that it builds in parallel with K1.
//
// Replaces nic/kernels/decode_fused_v2.py `_kernel_z1mm` (:191), the same
// pallas_call (:369) with z1mm=True. Per tile of R image rows it forms
//
//   z1[r, c, :] = sum_j A[r % R][j] * S_j[c, :],
//   S = [P rows t*R/f .. +R/f-1 ; C1v rows t*m .. t*m+m]   (m = R/f1)
//
// with the static [A0 | A1] matrix ([R, K], entries 0, 1-fu, fu; built by
// the wrapper as at :338-345), then K1's tail. For f == 1 A0 is the
// identity and, as in JAX, P is added as it is (K = m + 1 columns, A1
// only). Float planes (fp32, surgical) take the product as fp32 FMAs, a
// thread per pixel column walking the tile's rows. bf16 planes take it on
// the tensor cores: a block owns min(R, 16) rows x (128 / that) columns,
// stages its S rows (zero-padded to K = 16) in shared memory, and each warp
// issues mma.sync m16n8k16 (bf16 in, fp32 out) over the flat (column,
// hidden) axis, writing z1 to shared memory for the per-pixel tail. Past
// H = 128, any multiple of 64 runs decode_z1mm_wide: the product as fp32
// FMAs into the wide tail's [16][H] tile (decode_common.cuh), every plane
// mode.
//
// What bounds it: the tail's work is K1's; the product adds 2*K*H flop a
// pixel (K = 4 at the flagship's mip 0), done densely, zeros included.
//
// Entry point: nic_decode_z1mm (plain C, loaded with ctypes). It launches
// on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError().

#include "decode_common.cuh"

namespace {

using namespace nic_decode;

constexpr int TILE_C = 128;     // threads per block of the fp32 kernel
constexpr int MAX_A = 1024;     // R x K entries of [A0 | A1] (fp32 path)
constexpr int Z_THREADS = 128;  // threads of a tensor-core block

template <int H, int MODE, int G>
__global__ void __launch_bounds__(TILE_C)
decode_z1mm_f32_kernel(const float* __restrict__ pc,
                       const float* __restrict__ c1v,
                       const float* __restrict__ peu,
                       const float* __restrict__ amat,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3,
                       float* __restrict__ out, int ncl, int R, int K,
                       int kp, int m, int add_p) {
  constexpr bool kDotBf16 = MODE != kF32;
  __shared__ TailSmem<H> sm;
  __shared__ float sa[MAX_A];
  stage_tail<H>(sm, w2, b2, w3, b3);
  for (int i = threadIdx.x; i < R * K; i += TILE_C) sa[i] = amat[i];
  __syncthreads();

  const int c = blockIdx.x * TILE_C + threadIdx.x;
  if (c >= ncl) return;
  const int t = blockIdx.y;  // the tile of R rows
  for (int rl = 0; rl < R; ++rl) {
    const int r = t * R + rl;
    float h[H];
NIC_UNROLL_H(H)
    for (int k = 0; k < H; ++k) h[k] = 0.0f;
    for (int j = 0; j < K; ++j) {
      const float a = sa[rl * K + j];
      const float* row =
          j < kp ? pc + (static_cast<size_t>(t * kp + j) * ncl + c) * H
                 : c1v + (static_cast<size_t>(t * m + j - kp) * ncl + c) * H;
NIC_UNROLL_H(H)
      for (int k0 = 0; k0 < H; k0 += 8) {
        float v[8];
        load8(row + k0, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) h[k0 + i] = fmaf(a, v[i], h[k0 + i]);
      }
    }
    const float* prow = pc + (static_cast<size_t>(r) * ncl + c) * H;
    const float* erow = peu + static_cast<size_t>(r) * H;
NIC_UNROLL_H(H)
    for (int k0 = 0; k0 < H; k0 += 8) {
      float p[8], e[8];
      load8(erow + k0, e);
      if (add_p) {
        load8(prow + k0, p);
#pragma unroll
        for (int i = 0; i < 8; ++i) h[k0 + i] += p[i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) h[k0 + i] += e[i];
    }
    mlp_tail<H, G, kDotBf16>(h, sm,
                             out + (static_cast<size_t>(r) * ncl + c) * 3);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D = A (16x16, row) . B (16x8, col), bf16 inputs, fp32 accumulators from 0
__device__ __forceinline__ void mma_bf16_16816(const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1,
                                               float (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// shared-memory layout of the tensor-core block, the host's too
struct Z1Layout {
  int rg, cb, ncols, sstride, zrow;
  __host__ __device__ Z1Layout(int R, int H) {
    rg = R < 16 ? R : 16;           // rows of a block: one m16 tile
    cb = Z_THREADS / rg;            // pixel columns of a block
    ncols = cb * H;                 // flat (column, hidden) axis
    sstride = ncols + 8;            // bf16 per staged S row
    zrow = cb * (H + 4) + 8;        // floats per z1 row (padded pixels)
  }
  __host__ __device__ size_t bytes() const {
    return 16 * static_cast<size_t>(sstride) * 2 +
           static_cast<size_t>(rg) * zrow * 4;
  }
};

template <int H, int G>
__global__ void __launch_bounds__(Z_THREADS)
decode_z1mm_bf16_kernel(const __nv_bfloat16* __restrict__ pc,
                        const __nv_bfloat16* __restrict__ c1v,
                        const __nv_bfloat16* __restrict__ peu,
                        const float* __restrict__ amat,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3,
                        float* __restrict__ out, int ncl, int R, int K,
                        int kp, int m, int add_p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ TailSmem<H> sm;
  const Z1Layout L(R, H);
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(dyn);  // [16][sstride]
  float* sz = reinterpret_cast<float*>(dyn + 16 * L.sstride * 2);
  stage_tail<H>(sm, w2, b2, w3, b3);

  const int c0 = blockIdx.x * L.cb;
  const int row0 = blockIdx.y * L.rg;  // first image row of the block
  const int t = row0 / R;              // its tile
  const int rl0 = row0 - t * R;        // its first row in the tile
  // stage the tile's S rows over this block's columns; zero past K, ncl
  const int vecs = L.ncols / 8;
  for (int i = threadIdx.x; i < 16 * vecs; i += Z_THREADS) {
    const int j = i / vecs, v = i % vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < K && c0 + (v * 8) / H < ncl) {
      const __nv_bfloat16* row =
          j < kp ? pc + static_cast<size_t>(t * kp + j) * ncl * H
                 : c1v + static_cast<size_t>(t * m + j - kp) * ncl * H;
      val = reinterpret_cast<const uint4*>(row +
                                           static_cast<size_t>(c0) * H)[v];
    }
    reinterpret_cast<uint4*>(ss + j * L.sstride)[v] = val;
  }
  // this block's rows of A as the m16n8k16 A fragment (zero-padded)
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  auto aval = [&](int row, int col) -> float {
    return (row < L.rg && col < K) ? amat[(rl0 + row) * K + col] : 0.0f;
  };
  const uint32_t afrag[4] = {
      pack_bf16(aval(g, 2 * q), aval(g, 2 * q + 1)),
      pack_bf16(aval(g + 8, 2 * q), aval(g + 8, 2 * q + 1)),
      pack_bf16(aval(g, 2 * q + 8), aval(g, 2 * q + 9)),
      pack_bf16(aval(g + 8, 2 * q + 8), aval(g + 8, 2 * q + 9))};
  __syncthreads();

  const unsigned short* su = reinterpret_cast<const unsigned short*>(ss);
  for (int nt = threadIdx.x >> 5; nt < L.ncols / 8; nt += Z_THREADS / 32) {
    const int n = nt * 8 + g;
    const uint32_t b0 = su[(2 * q) * L.sstride + n] |
                        (static_cast<uint32_t>(su[(2 * q + 1) * L.sstride + n])
                         << 16);
    const uint32_t b1 = su[(2 * q + 8) * L.sstride + n] |
                        (static_cast<uint32_t>(su[(2 * q + 9) * L.sstride + n])
                         << 16);
    float d[4];
    mma_bf16_16816(afrag, b0, b1, d);
    const int nn = nt * 8 + 2 * q;  // nn and nn + 1: one pixel (H even)
    const int px = nn / H, k = nn % H;
    float* z = sz + g * L.zrow + px * (H + 4) + k;
    z[0] = d[0];
    z[1] = d[1];
    if (L.rg == 16) {
      z[8 * L.zrow] = d[2];
      z[8 * L.zrow + 1] = d[3];
    }
  }
  __syncthreads();

  const int rl = threadIdx.x / L.cb, cl = threadIdx.x % L.cb;
  const int r = row0 + rl, c = c0 + cl;
  if (c >= ncl) return;
  const float* zr = sz + rl * L.zrow + cl * (H + 4);
  const __nv_bfloat16* prow = pc + (static_cast<size_t>(r) * ncl + c) * H;
  const __nv_bfloat16* erow = peu + static_cast<size_t>(r) * H;
  float h[H];
NIC_UNROLL_H(H)
  for (int k0 = 0; k0 < H; k0 += 8) {
    float p[8], e[8];
    load8(zr + k0, h + k0);
    load8(erow + k0, e);
    if (add_p) {
      load8(prow + k0, p);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[k0 + i] += p[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) h[k0 + i] += e[i];
  }
  mlp_tail<H, G, true>(h, sm, out + (static_cast<size_t>(r) * ncl + c) * 3);
}

struct Z1Args {
  const void *pc, *c1v, *peu;
  const float *amat, *w2, *b2, *w3, *b3;
  float* out;
  int nr, ncl, R, K, kp, m, add_p;
  cudaStream_t stream;
};

// past H = 128: a block per WR columns of one image row; z1 = the same
// sum over the tile's S rows (fp32 FMAs, in the fp32 kernel's order) into
// the wide tail's z1 tile (decode_common.cuh)
template <int MODE, int G>
__global__ void __launch_bounds__(WT)
decode_z1mm_wide(const typename Types<MODE>::Plane* __restrict__ pc,
                 const typename Types<MODE>::Plane* __restrict__ c1v,
                 const typename Types<MODE>::Pe* __restrict__ peu,
                 const float* __restrict__ amat,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, int ncl, int H, int R, int K,
                 int kp, int m, int add_p) {
  extern __shared__ float4 wide_smem[];
  const WideSmem sm(reinterpret_cast<float*>(wide_smem), H);
  const int r = blockIdx.y, c0 = blockIdx.x * WR;
  const int t = r / R, rl = r % R;
  const int cnt = min(WR, ncl - c0);
  for (int i = threadIdx.x; i < WR * H; i += WT) {
    const int p = i / H, k = i % H, c = c0 + p;
    float h = 0.0f;
    if (p < cnt) {
      for (int j = 0; j < K; ++j) {
        const auto* row =
            j < kp ? pc + static_cast<size_t>(t * kp + j) * ncl * H
                   : c1v + static_cast<size_t>(t * m + j - kp) * ncl * H;
        h = fmaf(__ldg(amat + rl * K + j),
                 to_float(row[static_cast<size_t>(c) * H + k]), h);
      }
      if (add_p) h += to_float(pc[(static_cast<size_t>(r) * ncl + c) * H + k]);
      h += to_float(peu[static_cast<size_t>(r) * H + k]);
    }
    sm.z[i] = h;
  }
  __syncthreads();
  wide_tail<G, MODE != kF32>(sm, H, w2, b2, w3, b3,
                             out + (static_cast<size_t>(r) * ncl + c0) * 3,
                             cnt);
}

template <int MODE, int G>
cudaError_t launch_z1mm_wide(const Z1Args& a, int hidden) {
  using T = Types<MODE>;
  const size_t smem = sizeof(float) * wide_floats(hidden);
  if (smem > kMaxSmem || a.nr > 65535) return cudaErrorInvalidValue;
  auto kern = decode_z1mm_wide<MODE, G>;
  const cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ncl + WR - 1) / WR, a.nr);
  kern<<<grid, WT, smem, a.stream>>>(
      static_cast<const typename T::Plane*>(a.pc),
      static_cast<const typename T::Plane*>(a.c1v),
      static_cast<const typename T::Pe*>(a.peu), a.amat, a.w2, a.b2, a.w3,
      a.b3, a.out, a.ncl, hidden, a.R, a.K, a.kp, a.m, a.add_p);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

// H = 64 or 128 (built), or kWideH: a runtime width past them (the wide
// body)
constexpr int kWideH = 0;

template <int H, int MODE, int G>
cudaError_t launch_z1mm(const Z1Args& a, int hidden) {
  if constexpr (H == kWideH) {
    return launch_z1mm_wide<MODE, G>(a, hidden);
  } else if constexpr (MODE == kBF16) {
    const Z1Layout L(a.R, H);
    auto kern = decode_z1mm_bf16_kernel<H, G>;
    const cudaError_t err = allow_dynamic_smem(kern, L.bytes());
    if (err != cudaSuccess) return err;
    const dim3 grid((a.ncl + L.cb - 1) / L.cb, a.nr / L.rg);
    kern<<<grid, Z_THREADS, L.bytes(), a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.pc),
        static_cast<const __nv_bfloat16*>(a.c1v),
        static_cast<const __nv_bfloat16*>(a.peu), a.amat, a.w2, a.b2, a.w3,
        a.b3, a.out, a.ncl, a.R, a.K, a.kp, a.m, a.add_p);
    const cudaError_t done = cudaGetLastError();
    if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
    return done;
  } else {
    const dim3 grid((a.ncl + TILE_C - 1) / TILE_C, a.nr / a.R);
    auto kern = decode_z1mm_f32_kernel<H, MODE, G>;
    kern<<<grid, TILE_C, 0, a.stream>>>(
        static_cast<const float*>(a.pc), static_cast<const float*>(a.c1v),
        static_cast<const float*>(a.peu), a.amat, a.w2, a.b2, a.w3, a.b3,
        a.out, a.ncl, a.R, a.K, a.kp, a.m, a.add_p);
    const cudaError_t done = cudaGetLastError();
    if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
    return done;
  }
}

template <int H, int MODE>
int dispatch_z1mm_gelu(int gelu_id, const Z1Args& a, int hidden) {
  switch (gelu_id) {
    case kExact: return launch_z1mm<H, MODE, kExact>(a, hidden);
    case kTanh: return launch_z1mm<H, MODE, kTanh>(a, hidden);
    case kQuick: return launch_z1mm<H, MODE, kQuick>(a, hidden);
    case kPoly: return launch_z1mm<H, MODE, kPoly>(a, hidden);
    case kErfPoly: return launch_z1mm<H, MODE, kErfPoly>(a, hidden);
    case kTanhErf: return launch_z1mm<H, MODE, kTanhErf>(a, hidden);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K2: one nr x ncl image; pc [nr/f][ncl][H], c1v [nr/f1 + 1][ncl][H],
// peu [nr][H], amat [R][K] fp32 (kp of its columns over P rows, the rest
// over C1v rows) -> out [nr][ncl][3]; H = 64 or 128 (a narrower model is
// zero-padded to 64 by the wrapper), or a multiple of 64 up to 3264 (the
// wide body); plane modes fp32, bf16 and surgical
extern "C" int nic_decode_z1mm(const void* pc, const void* c1v,
                               const void* peu, const void* amat,
                               const void* w2, const void* b2,
                               const void* w3, const void* b3, void* out,
                               int nr, int ncl, int hidden, int R, int K,
                               int kp, int m, int add_p, int mode,
                               int gelu_id, void* stream) {
  const bool wide = hidden > 128 && hidden % WCB == 0;
  if ((hidden != 64 && hidden != 128 && !wide) || nr <= 0 || ncl <= 0 ||
      R < 8 ||
      (R & (R - 1)) || nr % R || K <= 0 || kp < 0 || kp > K || R * K > MAX_A ||
      (mode == kBF16 && K > 16) || nr / R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Z1Args a{pc, c1v, peu,
                 static_cast<const float*>(amat),
                 static_cast<const float*>(w2), static_cast<const float*>(b2),
                 static_cast<const float*>(w3), static_cast<const float*>(b3),
                 static_cast<float*>(out), nr, ncl, R, K, kp, m, add_p,
                 static_cast<cudaStream_t>(stream)};
#define NIC_Z1MM(H)                                                      \
  switch (mode) {                                                        \
    case kF32: return dispatch_z1mm_gelu<H, kF32>(gelu_id, a, hidden);   \
    case kBF16: return dispatch_z1mm_gelu<H, kBF16>(gelu_id, a, hidden); \
    case kSurgical:                                                      \
      return dispatch_z1mm_gelu<H, kSurgical>(gelu_id, a, hidden);       \
  }
  if (hidden == 64) { NIC_Z1MM(64) }
  if (hidden == 128) { NIC_Z1MM(128) }
  if (wide) { NIC_Z1MM(kWideH) }
#undef NIC_Z1MM
  return static_cast<int>(cudaErrorInvalidValue);
}

