// The z1-matmul variant of the 2D folded decode's per-pixel stage, for
// Hopper (sm_90a): K1 (decode_fused_v2.cu) with its z1 build replaced by a
// product with a static matrix, on K1's tensor-core tail (decode_mma.cuh).
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
// only).
//
// Two bodies, picked by the caller (`body`, from nic_torch/kernels/
// _widths.py decode_body), which refuses any other pairing:
//
// decode_z1mm_mma (H = 64 and 128; fp32, bf16 and surgical planes) puts
// the product and the tail on the tensor cores. A varies by row, not by
// column, so a warp takes 16 consecutive image rows of one column (a
// window): the product's M is those rows, its N the column's H units and
// its k the few S rows the window reads (its band S'; A' is the matching
// columns of A). At R = 8 a window spans two tiles and A' is
// block-diagonal: each tile's rows against its own S rows (2K band rows
// at JAX's geometry). The m16n8 accumulators of the product are exactly
// the h1 layout of mma_tail (decode_mma.cuh): P (f == 1) and the row PE
// are added there and the first GELU applied, so z1 never leaves the
// registers at H = 64 (past it h1 waits in the warp's slots, as in K1),
// and K1's tail runs on them unchanged. A block of `warps` warps takes a
// tile of 16 rows x `warps` columns, warp w the window of column w; each
// warp copies its window's band rows (runs of H contiguous elements) into
// its own shared memory with 16-byte cp.async ([k][H + 8]), the next
// tile's while it decodes this one, so the loop holds no block barrier.
// Persistent blocks walk the tiles, every warp of a block as many of
// them (mma_tail holds block barriers when W2 is streamed). bf16 planes:
// m16n8k16 bf16 products (A's entries 0, 1 - fu and fu are dyadic and
// exact in bf16 up to f1 = 256; past it, at the one geometry R K <= 1024
// admits there, A is split into two exact bf16 parts), B from shared
// memory by ldmatrix.trans. fp32 and surgical planes: A is exact in tf32, so
// 3xTF32 drops to two m16n8k8 tf32 products, A S_lo + A S_hi (the dropped
// S - S_hi - S_lo is ~2^-22 of a value). The tail takes fp32 dots as
// 3xTF32 (fp32) and bf16 dots (bf16, surgical), as K1's does. A warp's
// rgb lies down a column: the tail leaves it in the warp's staging and
// the warp writes it, 3 floats to each of its 16 image rows.
//
// decode_z1mm_wide (past H = 128, any multiple of 64): the product as
// fp32 FMAs into the wide tail's [16][H] tile (decode_common.cuh), every
// plane mode.
//
// What bounds it: the tail's work is K1's, 2 (H H + 3 H) flop a pixel;
// the product adds 2 K H (K = 4 at the flagship's mip 0: 512 flop against
// the tail's 8,576). At 2048^2, H = 64, fp32 planes, that is 38.1 GFLOP,
// 0.23 ms of 3xTF32 at 495/3 TFLOP/s, against ~0.45 GB of planes, P, C1v
// and PE read once and rgb written once (0.14 ms at 3.35 TB/s).
//
// Entry point: nic_decode_z1mm (plain C, loaded with ctypes). It launches
// on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError().

#include <climits>

#include "decode_mma.cuh"

namespace {

using namespace nic_decode;

constexpr int MAX_A = 1024;  // R x K entries of [A0 | A1]
constexpr int ZT = 256;      // threads of a full decode_z1mm_mma block

// The band of S rows a window of 16 image rows reads. A window lies in
// 16 / seg tiles (2 at R = 8, else 1), its segments; segment s starts at
// row rl0 of its tile (a multiple of seg) and reads P rows rl0 / f ..
// (rl0 + seg - 1) / f and C1v rows rl0 / f1 .. (rl0 + seg - 1) / f1 + 1
// of that tile, np and nc rows. Band row b is row b - s (np + nc) of
// segment s = b >= np + nc: its P rows, then its C1v rows. kpad pads the
// band to the product's k step (16 bf16, 8 tf32). R, f and f1 are powers
// of two: the kernel takes them as shifts (lr, lf, lf1). A's entries are
// multiples of 1 / f1 in [0, 1]: exact in tf32 (11 significant bits) for
// every f1 <= R <= 512 that R K <= 1024 admits, and in bf16 (8) up to
// f1 = 256; at f1 = 512 (R = 512, f = 1, K = 2) 1 - fu takes 9 bits, so
// bf16 planes `split` A into bf16 hi and lo parts, both exact, and take a
// second product.
struct Band {
  int lr, lf, lf1, seg, np, nc, rows, kpad, split;
  __host__ Band(int R, int kp, int m, bool bf16_planes) {
    const int f = kp ? R / kp : 1, f1 = R / m;
    lr = log2i(R);
    lf = log2i(f);
    lf1 = log2i(f1);
    seg = R < 16 ? R : 16;
    np = kp ? (seg - 1) / f + 1 : 0;
    nc = (seg - 1) / f1 + 2;
    rows = 16 / seg * (np + nc);
    const int step = bf16_planes ? 16 : 8;
    kpad = (rows + step - 1) / step * step;
    split = bf16_planes && f1 > 256;
  }
  __host__ __device__ static int log2i(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
  }
};

// A'[i][b] of the window whose first image row is row0: row i of the
// window against band row b (zero outside the row's segment and past the
// band), read from [A0 | A1] [R][K]
__device__ __forceinline__ float band_a(const float* __restrict__ amat,
                                       int row0, int i, int b, int R, int K,
                                       int kp, Band band) {
  const int per = band.np + band.nc;
  const int s = i >= band.seg, j = b - s * per;
  if (j < 0 || j >= per) return 0.0f;
  const int rl = (row0 + i) & (R - 1);
  const int rl0 = (row0 + s * band.seg) & (R - 1);
  const int col = j < band.np ? (rl0 >> band.lf) + j
                              : kp + (rl0 >> band.lf1) + (j - band.np);
  return __ldg(amat + rl * K + col);
}

// the band's S rows of column c of the window at row0 into the warp's
// dst [band.rows][H + 8], by the warp's 16-byte cp.async (a segment past
// the image reads the last tile; its outputs are not stored)
template <typename Plane>
__device__ __forceinline__ void stage_band(Plane* dst,
                                           const Plane* __restrict__ pc,
                                           const Plane* __restrict__ c1v,
                                           int row0, int c, int ncl, int H,
                                           int kp, int m, int ntiles,
                                           Band band, int lane) {
  constexpr int kVec = 16 / sizeof(Plane);  // elements a copy
  const int per_col = H / kVec, lpc = Band::log2i(per_col);
  const int per = band.np + band.nc;
  const Plane* base[2][2];  // [segment][P, C1v]: the segment's first rows
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r0s = row0 + s * band.seg;
    const int t = min(r0s >> band.lr, ntiles - 1);
    const int rl0 = r0s & ((1 << band.lr) - 1);
    base[s][0] = pc + (static_cast<size_t>(t * kp + (rl0 >> band.lf)) * ncl +
                       c) * H;
    base[s][1] = c1v + (static_cast<size_t>(t * m + (rl0 >> band.lf1)) *
                        ncl + c) * H;
  }
  const size_t row = static_cast<size_t>(ncl) * H;  // one plane row
  for (int i = lane; i < band.rows * per_col; i += 32) {
    const int b = i >> lpc, e = (i & (per_col - 1)) * kVec;
    const int s = b >= per, j = b - s * per;
    const Plane* src = j < band.np ? base[s][0] + j * row
                                   : base[s][1] + (j - band.np) * row;
    cp_async16(dst + b * (H + 8) + e, src + e);
  }
}

// four 8 x 8 b16 matrices from shared memory, transposed (ldmatrix
// .trans): lane l gives the address of row l % 8 of matrix l / 8, and lane
// (g, q) receives elements (2 q, g) and (2 q + 1, g) of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// h[nt] = A' S' for units u0 + 8 nt + 2 q + {0, 1} (S' row k at sS + k ss),
// rows g and g + 8 of the window: the m16n8 accumulator layout. bf16
// planes: m16n8k16 bf16 products, B by ldmatrix.trans (A_lo S + A_hi S
// where the band is `split`); fp32 planes: A S_lo + A S_hi in m16n8k8
// tf32 products
template <bool kBfPlanes, typename Plane>
__device__ __forceinline__ void band_product(
    float (&h)[8][4], const Plane* sS, int ss, int u0,
    const float* __restrict__ amat, int row0, int R, int K, int kp,
    Band band, int g, int q, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[nt][e] = 0.0f;
  auto a = [&](int i, int b) {
    return band_a(amat, row0, i, b, R, K, kp, band);
  };
  if constexpr (kBfPlanes) {
    // lane l addresses row l % 8 of k half (l / 8) % 2 of n-tile l / 16
    const Plane* base = sS + ((lane >> 3) & 1) * 8 * ss + (lane & 7) * ss +
                        u0 + 8 * (lane >> 4);
    for (int k0 = 0; k0 < band.kpad; k0 += 16) {
      const int k = k0 + 2 * q;
      // the A fragment's (row, column) pairs, in register order
      const float av[8] = {a(g, k),         a(g, k + 1),
                           a(g + 8, k),     a(g + 8, k + 1),
                           a(g, k + 8),     a(g, k + 9),
                           a(g + 8, k + 8), a(g + 8, k + 9)};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = bf2(av[2 * e], av[2 * e + 1]);
        lo[e] = bf2(av[2 * e] - bf16_round(av[2 * e]),
                    av[2 * e + 1] - bf16_round(av[2 * e + 1]));
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, base + k0 * ss + 8 * nt);
        if (band.split) {
          mma_bf16(h[nt], lo, b[0], b[1]);
          mma_bf16(h[nt + 1], lo, b[2], b[3]);
        }
        mma_bf16(h[nt], hi, b[0], b[1]);
        mma_bf16(h[nt + 1], hi, b[2], b[3]);
      }
    }
  } else {
    for (int k0 = 0; k0 < band.kpad; k0 += 8) {
      const int k = k0 + q;
      const uint32_t af[4] = {tf32_of(a(g, k)), tf32_of(a(g + 8, k)),
                              tf32_of(a(g, k + 4)), tf32_of(a(g + 8, k + 4))};
      const Plane* s0 = sS + k * ss + u0 + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float v0 = s0[8 * nt], v1 = s0[8 * nt + 4 * ss];
        const uint32_t h0 = tf32_of(v0), h1 = tf32_of(v1);
        mma_tf32(h[nt], af, tf32_of(v0 - __uint_as_float(h0)),
                 tf32_of(v1 - __uint_as_float(h1)));
        mma_tf32(h[nt], af, h0, h1);
      }
    }
  }
}

// bytes of a decode_z1mm_mma block of `warps` warps at H = 64 nb: K1's
// (the W2 tiles, all nb^2 with `whole` else one streamed; W3, b2, b3; the
// warps' rgb; past H = 64 their h1 slots) and each warp's two buffers of
// its band, kpad rows of H + 8 plane elements
__host__ inline size_t z1mm_bytes(int warps, int nb, bool whole, bool bf,
                                  size_t plane, int kpad) {
  const size_t tile = bf ? kTileBf16 : kTileTf32;
  return (whole ? nb * nb : 1) * tile + 16 * 64 * static_cast<size_t>(nb) +
         16 +
         static_cast<size_t>(warps) *
             (192 + (nb > 1 ? nb * (bf ? 2048 : 4096) : 0) +
              2 * static_cast<size_t>(kpad) * (64 * nb + 8) * plane);
}

// The product and K1's tail on the tensor cores for H = 64 (kOne, h1 in
// registers) and 128 (h1 parked in slots). Persistent blocks walk tiles
// of 16 image rows x `warps` columns, warp w taking the window of column
// w; each warp copies its band of the next tile while it decodes this
// one (two buffers), with no block barrier, and writes its rgb itself.
template <int MODE, int G, bool kOne>
__global__ void __launch_bounds__(ZT, 2)
decode_z1mm_mma(const typename Types<MODE>::Plane* __restrict__ pc,
                const typename Types<MODE>::Plane* __restrict__ c1v,
                const typename Types<MODE>::Pe* __restrict__ peu,
                const float* __restrict__ amat,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ out, int nr, int ncl, int hidden, int R,
                int K, int kp, int m, int add_p, Band band, int whole_w2) {
  using Plane = typename Types<MODE>::Plane;
  constexpr bool kBf = MODE != kF32;         // bf16 inputs to the tail's dots
  constexpr bool kBfPlanes = MODE == kBF16;  // the product in bf16
  extern __shared__ float4 z1mm_smem[];
  const int H = kOne ? 64 : hidden;
  const int nb = H / 64;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool whole = whole_w2 != 0;
  const size_t tile_bytes = kBf ? kTileBf16 : kTileTf32;
  const int ss = H + 8;                   // elements of a staged band row
  const int buf = band.kpad * ss;         // elements of a band buffer
  unsigned char* sW2 = reinterpret_cast<unsigned char*>(z1mm_smem);
  float* sW3 = reinterpret_cast<float*>(sW2 + (whole ? nb * nb : 1) *
                                                  tile_bytes);
  float* sb2 = sW3 + 3 * H;
  float* sb3 = sb2 + H;
  float* sOut = sb3 + 4 + 48 * warp;
  float* slot = sb3 + 4 + 48 * warps + warp * nb * (kBf ? 16 : 32) * 32;
  Plane* sS = reinterpret_cast<Plane*>(
                  sb3 + 4 + 48 * warps +
                  (kOne ? 0 : warps * nb * (kBf ? 16 : 32) * 32)) +
              warp * 2 * buf;            // this warp's two buffers

  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sW3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb2[i] = b2[i];
  if (threadIdx.x < 3) sb3[threadIdx.x] = b3[threadIdx.x];
  if (whole)
    for (int kb = 0; kb < nb; ++kb)
      for (int jb = 0; jb < nb; ++jb)
        stage_w2_tile<kBf>(sW2 + (kb * nb + jb) * tile_bytes, w2, H, kb, jb);
  // the pad rows of both buffers stay zero: A' is zero there, and the
  // product must not meet what shared memory held before
  for (int i = band.rows * ss + lane; i < buf; i += 32) {
    sS[i] = Plane(0.0f);
    sS[buf + i] = Plane(0.0f);
  }
  __syncthreads();

  const int ctiles = (ncl + warps - 1) / warps;
  const int tiles = (nr + 15) / 16 * ctiles, ntiles = nr >> band.lr;
  auto stage = [&](Plane* dst, int tile) {
    stage_band(dst, pc, c1v, (tile / ctiles) * 16,
               min((tile % ctiles) * warps + warp, ncl - 1), ncl, H, kp, m,
               ntiles, band, lane);
  };
  const int first = blockIdx.x, step = gridDim.x;
  if (first < tiles) stage(sS, first);
  cp_async_commit();
  int it = 0;
  for (int tile = first; tile < tiles; tile += step, ++it) {
    // the next tile's band into the other buffer (read two tiles ago),
    // then wait for this one's
    if (tile + step < tiles) stage(sS + ((it + 1) & 1) * buf, tile + step);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const Plane* cur = sS + (it & 1) * buf;
    const int row0 = (tile / ctiles) * 16;
    const int col = (tile % ctiles) * warps + warp, c = min(col, ncl - 1);
    int rows[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) rows[s] = min(row0 + g + 8 * s, nr - 1);

    // layer 1: z1 = A' S' (+ P) + peu, the first GELU; h1 per 64-unit
    // block in registers (H = 64) or parked in the warp's slots
    float h1[8][4];
    for (int kb = 0; kb < nb; ++kb) {
      band_product<kBfPlanes>(h1, cur, ss, kb * 64, amat, row0, R, K, kp,
                              band, g, q, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int k = kb * 64 + 8 * nt + 2 * q;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float2 z = make_float2(h1[nt][2 * s], h1[nt][2 * s + 1]);
          if (add_p) {
            const float2 p =
                ld2(pc + (static_cast<size_t>(rows[s]) * ncl + c) * H + k);
            z.x += p.x;
            z.y += p.y;
          }
          const float2 e = ld2(peu + static_cast<size_t>(rows[s]) * H + k);
          h1[nt][2 * s] = first_act<G, kBf, true>(z.x + e.x);
          h1[nt][2 * s + 1] = first_act<G, kBf, true>(z.y + e.y);
        }
      }
      if (!kOne) park_h1<kBf>(slot, kb, lane, h1);
    }
    // layers 2 and 3 (decode_mma.cuh); the rgb of the window's 16 rows
    // waits in the warp's staging, then goes down the column
    mma_tail<kBf, G, kOne>(h1, nb, whole, sW2, w2, H, sW3, sb2, sb3, sOut,
                           slot, [&] { return sOut; }, 16, g, q, lane);
    if (col < ncl)
      for (int i = lane; i < 48; i += 32) {
        const int r = row0 + i / 3;
        if (r < nr)
          out[(static_cast<size_t>(r) * ncl + col) * 3 + i % 3] = sOut[i];
      }
    __syncwarp();
  }
  cp_async_wait<0>();
}

struct Z1Args {
  const void *pc, *c1v, *peu;
  const float *amat, *w2, *b2, *w3, *b3;
  float* out;
  int nr, ncl, R, K, kp, m, add_p;
  cudaStream_t stream;
};

// the tensor-core body: 8 warps a block with W2 whole, or fewer (down to
// 4); else W2 streamed tile by tile, on as many warps (8, 4, 2, 1) as fit;
// as many blocks as stay resident (two per SM at H = 64), each walking
// windows
template <int MODE, int G, bool kOne>
cudaError_t launch_mma(const Z1Args& a, int hidden) {
  using T = Types<MODE>;
  constexpr bool kBf = MODE != kF32;
  const int nb = hidden / 64;
  const Band band(a.R, a.kp, a.m, MODE == kBF16);
  bool whole = true;
  auto bytes = [&](int w) {
    return z1mm_bytes(w, nb, whole, kBf, sizeof(typename T::Plane),
                      band.kpad);
  };
  int warps = fit_warps(ZT / 32, 4, bytes);
  if (!warps) {
    whole = false;
    warps = fit_warps(ZT / 32, 1, bytes);
  }
  if (!warps) return cudaErrorInvalidValue;
  const size_t smem = bytes(warps);
  const long long tiles = static_cast<long long>((a.nr + 15) / 16) *
                          ((a.ncl + warps - 1) / warps);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  auto kern = decode_z1mm_mma<MODE, G, kOne>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = resident_grid(kern, 32 * warps, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, 32 * warps, smem, a.stream>>>(
      static_cast<const typename T::Plane*>(a.pc),
      static_cast<const typename T::Plane*>(a.c1v),
      static_cast<const typename T::Pe*>(a.peu), a.amat, a.w2, a.b2, a.w3,
      a.b3, a.out, a.nr, a.ncl, hidden, a.R, a.K, a.kp, a.m, a.add_p, band,
      static_cast<int>(whole));
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return done;
}

// past H = 128: a block per WR columns of one image row; z1 = the sum
// over the tile's S rows (fp32 FMAs) into the wide tail's z1 tile
// (decode_common.cuh)
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

// H = 64 or 128 (the tensor-core body), or kWideH: a runtime width past
// them (the wide body)
constexpr int kWideH = 0;

template <int H, int MODE, int G>
cudaError_t launch_z1mm(const Z1Args& a, int hidden) {
  if constexpr (H == kWideH)
    return launch_z1mm_wide<MODE, G>(a, hidden);
  else
    return launch_mma<MODE, G, H == 64>(a, hidden);
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

// the per-pixel bodies by the caller's id (nic_torch/kernels/
// decode_fused_v2.py _Z1MM_BODY_IDS)
enum Body { kMma = 1, kWide = 2 };

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// K2: one nr x ncl image; pc [nr/f][ncl][H], c1v [nr/f1 + 1][ncl][H],
// peu [nr][H], amat [R][K] fp32, z1_matrix's [A0 | A1] (its kp columns
// over P rows, 0 when P is added as it is, then m + 1 over C1v rows) ->
// out [nr][ncl][3]; body kMma at H = 64 and 128 (a narrower model is
// zero-padded to 64 by the wrapper), kWide at any multiple of 64 up to
// 3264; plane modes fp32, bf16 and surgical
extern "C" int nic_decode_z1mm(const void* pc, const void* c1v,
                               const void* peu, const void* amat,
                               const void* w2, const void* b2,
                               const void* w3, const void* b3, void* out,
                               int nr, int ncl, int hidden, int R, int K,
                               int kp, int m, int add_p, int mode,
                               int gelu_id, int body, void* stream) {
  const bool mma = body == kMma && (hidden == 64 || hidden == 128);
  const bool wide = body == kWide && hidden > 128 && hidden % WCB == 0;
  if ((!mma && !wide) || nr <= 0 || ncl <= 0 || R < 8 || !pow2(R) ||
      nr % R || !pow2(m) || R % m || (kp && (!pow2(kp) || R % kp)) ||
      kp < 0 || K != kp + m + 1 || R * K > MAX_A || (add_p != 0 && add_p != 1))
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
