// The v3 decode's MLP tail, for Hopper (sm_90a): GELU -> W2 -> GELU -> W3
// -> sigmoid over a flat [S^2, H] first-layer accumulator read from device
// memory.
//
// Replaces the Pallas TPU kernel nic/kernels/decode_fused_v3.py `_kernel`
// (:37), launched by `mlp_tail` (pallas_call at :75), K4. The accumulator
// comes from the folded first layer (nic_torch/grids/fastdecode.py
// `first_layer_acc`, PyTorch); this kernel is only the tail: dots on
// w2.dtype inputs with fp32 sums, the A&S erf GELU, fp32 out.
//
// Three bodies, picked by the caller (`body`, from nic_torch/kernels/
// _widths.py decode_body), which refuses any other pairing:
//
// mlp_tail_mma (H = 64 and 128) is K1's tensor-core tail
// (decode_mma.cuh mma_tail) on accumulator rows: a warp takes 16
// consecutive rows, loads them into the m16n8 accumulator layout, applies
// the first GELU there, and runs the shared tail (bf16 m16n8k16 products
// for bf16 dots, 3xTF32 for fp32). The tail is cheap on the tensor cores,
// so the accumulator stream sets the pace: each warp copies its next 16
// rows into shared memory with 16-byte cp.async while it works on the
// current ones (two stages a warp, rows padded to H + 8 elements so the
// fragment loads hit 32 banks); persistent blocks of 8 warps, two per SM,
// walk tiles of 128 rows. W2 is staged once per block as K1 stages it
// (one streamed tile at a time where the whole of it leaves no room for
// four warps: fp32 dots at H = 128). The exact GELU takes its
// exponential and reciprocal from the hardware (gelu's kFast), as K1's
// does.
//
// mlp_tail_kernel (H = 16) keeps the CUDA-core design: a block of 128
// threads covers `block` consecutive pixels (the JAX pipeline block),
// 128 at a time, copying the rows into shared memory with coalesced
// 16-byte loads (rows padded to H + 4 floats), then each thread runs the
// CUDA-core tail of decode_common.cuh on its row.
//
// mlp_tail_wide (past H = 128, any multiple of 64) loads 16 accumulator
// rows into the wide tail's tile (decode_common.cuh). The per-step weight
// tiling of the TPU kernel (Mosaic's advancing-window rule) means nothing
// here and is not carried over.
//
// What bounds it: the tail is 2*(H*H + 3*H) = 8.6 kflop a pixel against
// H*sizeof(acc) + 12 bytes moved: at 2048^2, H = 64, fp32 accumulators
// are 1.07 GB (0.335 ms at 3.35 TB/s) against 36 GFLOP (0.22 ms of 3xTF32
// at 495/3 TFLOP/s; 0.04 ms in bf16), so the bytes bound it; bf16
// accumulators halve them. The v3 decode as a whole pays for writing and
// reading back the accumulator that K1 keeps in registers.
//
// Entry point: nic_mlp_tail (plain C, loaded with ctypes). It launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <type_traits>

#include "decode_mma.cuh"

namespace {

using namespace nic_decode;

constexpr int THREADS = 128;

template <int H, typename TA, bool kDotBf16>
__global__ void __launch_bounds__(THREADS)
mlp_tail_kernel(const TA* __restrict__ acc, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ out,
                long long npix, int block) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* stage = reinterpret_cast<float*>(dyn);  // [THREADS][H + 4]
  __shared__ TailSmem<H> sm;
  stage_tail<H>(sm, w2, b2, w3, b3);

  const long long p0 = static_cast<long long>(blockIdx.x) * block;
  for (int base = 0; base < block; base += THREADS) {
    const long long q0 = p0 + base;
    __syncthreads();  // the tail weights, or the last chunk's reads, done
    for (int i = threadIdx.x; i < THREADS * H / 8; i += THREADS) {
      const int px = i / (H / 8), k8 = (i % (H / 8)) * 8;
      if (base + px < block && q0 + px < npix) {
        float v[8];
        load8(acc + (q0 + px) * H + k8, v);
        float4* s = reinterpret_cast<float4*>(stage + px * (H + 4) + k8);
        s[0] = make_float4(v[0], v[1], v[2], v[3]);
        s[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();
    const long long p = q0 + threadIdx.x;
    if (base + threadIdx.x < block && p < npix) {
      float z[H];
NIC_UNROLL_H(H)
      for (int k0 = 0; k0 < H; k0 += 8)
        load8(stage + threadIdx.x * (H + 4) + k0, z + k0);
      mlp_tail<H, kExact, kDotBf16>(z, sm, out + p * 3);
    }
  }
}

template <int H, typename TA, bool kDotBf16>
int launch(const void* acc, const float* w2, const float* b2, const float* w3,
           const float* b3, float* out, long long npix, int block,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(THREADS) * (H + 4) * 4;
  auto kern = mlp_tail_kernel<H, TA, kDotBf16>;
  const cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (npix + block - 1) / block;
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const TA*>(acc), w2, b2, w3, b3, out, npix, block);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// ---- mlp_tail_mma: the tail on the tensor cores ---------------------------

constexpr int TT = 256;  // threads of a full mlp_tail_mma block: 8 warps

// bytes of an mlp_tail_mma block of `warps` warps at H = 64 nb: the W2
// tiles (all nb^2 with `whole`, else one streamed tile), W3 [H][3], b2 and
// b3, and per warp its output rows, its two stages of 16 accumulator rows
// (H + 8 elements of acc_size bytes) and past H = 64 its h1 slots
__host__ inline size_t tail_bytes(int warps, int nb, bool whole, bool bf,
                                  size_t acc_size) {
  const size_t tile = bf ? kTileBf16 : kTileTf32;
  return (whole ? nb * nb : 1) * tile + 16 * 64 * static_cast<size_t>(nb) +
         16 +
         static_cast<size_t>(warps) *
             (192 + 2 * 16 * (64 * nb + 8) * acc_size +
              (nb > 1 ? nb * (bf ? 2048 : 4096) : 0));
}

// rows row0 .. row0 + 15 of acc [npix][H] into a stage of rows of H + 8
// elements, by the warp's 16-byte asynchronous copies (rows past npix
// repeat the last one; their outputs are not stored)
template <typename TA>
__device__ __forceinline__ void stage_rows(TA* dst,
                                           const TA* __restrict__ acc,
                                           long long row0, long long npix,
                                           int H, int lane) {
  constexpr int kPer = 16 / sizeof(TA);  // elements a copy
  const int cpr = H / kPer;              // copies a row
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr, c = (i - r * cpr) * kPer;
    const long long src = row0 + r < npix ? row0 + r : npix - 1;
    cp_async16(dst + r * (H + 8) + c, acc + src * H + c);
  }
}

// h1 = first_act(acc) of the stage's rows g and g + 8 for units 64 kb +
// 8 nt + 2 q + {0, 1}: the m16n8 accumulator layout
template <typename TA, bool kBf>
__device__ __forceinline__ void stage_h1(float (&h)[8][4], const TA* st,
                                         int H, int kb, int g, int q) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float2 v = lds2(st + (g + 8 * s) * (H + 8) + kb * 64 + 8 * nt +
                            2 * q);
      h[nt][2 * s] = first_act<kExact, kBf, true>(v.x);
      h[nt][2 * s + 1] = first_act<kExact, kBf, true>(v.y);
    }
}

// The tail on the tensor cores for H = 64 (kOne, h1 in registers) and
// wider multiples of 64 (h1 parked in slots): persistent blocks walk tiles
// of 16 x warps accumulator rows, warp w taking rows 16 w .. 16 w + 15;
// each warp copies its rows of the next tile while it decodes the
// current one (cp.async, two stages), builds h1 from the stage, and runs
// mma_tail (decode_mma.cuh). kBf: bf16 dot inputs; else 3xTF32.
template <typename TA, bool kBf, bool kOne>
__global__ void __launch_bounds__(TT, 2)
mlp_tail_mma(const TA* __restrict__ acc, const float* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ w3,
             const float* __restrict__ b3, float* __restrict__ out,
             long long npix, int H, int whole_w2) {
  extern __shared__ float4 tail_smem[];
  const int nb = kOne ? 1 : H / 64;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool whole = whole_w2 != 0;
  const size_t tile_bytes = kBf ? kTileBf16 : kTileTf32;
  unsigned char* sW2 = reinterpret_cast<unsigned char*>(tail_smem);
  float* sW3 = reinterpret_cast<float*>(sW2 + (whole ? nb * nb : 1) *
                                                  tile_bytes);
  float* sb2 = sW3 + 3 * H;
  float* sb3 = sb2 + H;
  float* sOut = sb3 + 4 + 48 * warp;
  TA* stage = reinterpret_cast<TA*>(sb3 + 4 + 48 * warps);
  float* slot = reinterpret_cast<float*>(stage + warps * 2 * 16 * (H + 8)) +
                warp * nb * (kBf ? 16 : 32) * 32;
  stage += warp * 2 * 16 * (H + 8);

  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) sW3[i] = w3[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sb2[i] = b2[i];
  if (threadIdx.x < 3) sb3[threadIdx.x] = b3[threadIdx.x];
  if (whole)
    for (int kb = 0; kb < nb; ++kb)
      for (int jb = 0; jb < nb; ++jb)
        stage_w2_tile<kBf>(sW2 + (kb * nb + jb) * tile_bytes, w2, H, kb, jb);
  __syncthreads();

  const long long rows = 16LL * warps;
  const long long tiles = (npix + rows - 1) / rows;
  long long tile = blockIdx.x;
  if (tile < tiles) stage_rows(stage, acc, tile * rows + 16 * warp, npix, H,
                               lane);
  cp_async_commit();
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    // the next tile's rows into the other stage (read two tiles ago)
    __syncwarp();
    const long long next = tile + gridDim.x;
    if (next < tiles)
      stage_rows(stage + ((it + 1) & 1) * 16 * (H + 8), acc,
                 next * rows + 16 * warp, npix, H, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    const TA* cur = stage + (it & 1) * 16 * (H + 8);
    const long long row0 = tile * rows + 16 * warp;
    const int cnt = row0 < npix ? static_cast<int>(min(16LL, npix - row0))
                                : 0;
    float h1[8][4];
    if (!kOne) {
      for (int kb = 0; kb < nb; ++kb) {
        stage_h1<TA, kBf>(h1, cur, H, kb, g, q);
        park_h1<kBf>(slot, kb, lane, h1);
      }
    } else {
      stage_h1<TA, kBf>(h1, cur, H, 0, g, q);
    }
    mma_tail<kBf, kExact, kOne>(
        h1, nb, whole, sW2, w2, H, sW3, sb2, sb3, sOut, slot,
        [&] { return out + (cnt ? row0 * 3 : 0); }, cnt, g, q, lane);
  }
  cp_async_wait<0>();
}

// the tensor-core body: 8 warps a block with W2 whole, or fewer (down to
// 4); else W2 streamed tile by tile, on as many warps (8, 4, 2, 1) as fit;
// as many blocks as stay resident (two per SM at H = 64), each walking
// tiles
template <typename TA, bool kBf, bool kOne>
int launch_mma(const void* acc, const float* w2, const float* b2,
               const float* w3, const float* b3, float* out, long long npix,
               int hidden, cudaStream_t stream) {
  const int nb = hidden / 64;
  bool whole = true;
  auto bytes = [&](int w) {
    return tail_bytes(w, nb, whole, kBf, sizeof(TA));
  };
  int warps = fit_warps(TT / 32, 4, bytes);
  if (!warps) {
    whole = false;
    warps = fit_warps(TT / 32, 1, bytes);
  }
  if (!warps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bytes(warps);
  auto kern = mlp_tail_mma<TA, kBf, kOne>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = resident_grid(kern, 32 * warps, smem,
                        (npix + 16LL * warps - 1) / (16LL * warps), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const TA*>(acc), w2, b2, w3, b3, out, npix, hidden,
      static_cast<int>(whole));
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// past H = 128: a block per tile of WR pixels, whose accumulator rows it
// loads into the wide tail's z1 tile (decode_common.cuh); the pipeline
// block does not change what is computed and is not used
template <typename TA, bool kDotBf16>
__global__ void __launch_bounds__(WT)
mlp_tail_wide(const TA* __restrict__ acc, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ w3,
              const float* __restrict__ b3, float* __restrict__ out,
              long long npix, int H) {
  extern __shared__ float4 wide_smem[];
  const WideSmem sm(reinterpret_cast<float*>(wide_smem), H);
  const long long q0 = static_cast<long long>(blockIdx.x) * WR;
  const int cnt = static_cast<int>(npix - q0 < WR ? npix - q0 : WR);
  for (int i = threadIdx.x; i < WR * H; i += WT)
    sm.z[i] = i / H < cnt ? to_float(acc[q0 * H + i]) : 0.0f;
  __syncthreads();
  wide_tail<kExact, kDotBf16>(sm, H, w2, b2, w3, b3, out + q0 * 3, cnt);
}

template <typename TA, bool kDotBf16>
int launch_wide(const void* acc, const float* w2, const float* b2,
                const float* w3, const float* b3, float* out, long long npix,
                int hidden, cudaStream_t stream) {
  const size_t smem = sizeof(float) * wide_floats(hidden);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mlp_tail_wide<TA, kDotBf16>;
  const cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (npix + WR - 1) / WR;
  kern<<<static_cast<unsigned>(blocks), WT, smem, stream>>>(
      static_cast<const TA*>(acc), w2, b2, w3, b3, out, npix, hidden);
  const cudaError_t done = cudaGetLastError();
  if (done == cudaSuccess) nic_note_body(reinterpret_cast<const void*>(kern));
  return static_cast<int>(done);
}

// the per-pixel bodies by the caller's id (nic_torch/kernels/
// decode_fused_v3.py _BODY_IDS)
enum Body { kCudaCore = 0, kMma = 1, kWide = 2 };

template <int H, int B, typename TA, bool kBf>
int launch_h(const void* acc, const float* w2, const float* b2,
             const float* w3, const float* b3, float* out, long long npix,
             int block, cudaStream_t s) {
  if constexpr (B == kMma)
    return launch_mma<TA, kBf, H == 64>(acc, w2, b2, w3, b3, out, npix, H, s);
  else
    return launch<H, TA, kBf>(acc, w2, b2, w3, b3, out, npix, block, s);
}

template <typename TA, bool kBf>
int launch_body(int hidden, int body, const void* acc, const float* w2,
                const float* b2, const float* w3, const float* b3, float* out,
                long long npix, int block, cudaStream_t s) {
#define NIC_TAIL(H, B)                                                      \
  if (hidden == H && body == B)                                             \
  return launch_h<H, B, TA, kBf>(acc, w2, b2, w3, b3, out, npix, block, s)
  NIC_TAIL(16, kCudaCore);
  NIC_TAIL(64, kMma);
  NIC_TAIL(128, kMma);
#undef NIC_TAIL
  if (body == kWide && hidden > 128 && hidden % WCB == 0)
    return launch_wide<TA, kBf>(acc, w2, b2, w3, b3, out, npix, hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K4: acc [npix][H] (fp32, or bf16 with acc_bf16 = 1), dots on bf16 inputs
// with dot_bf16 = 1 -> out [npix][3] fp32; body kCudaCore at H = 16, kMma
// at H = 64 and 128, kWide at any multiple of 64 up to 3264
extern "C" int nic_mlp_tail(const void* acc, const void* w2, const void* b2,
                            const void* w3, const void* b3, void* out,
                            long long npix, int hidden, int block,
                            int acc_bf16, int dot_bf16, int body,
                            void* stream) {
  if (npix <= 0 || block <= 0 || (npix + block - 1) / block > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fw3 = static_cast<const float*>(w3);
  const auto* fb3 = static_cast<const float*>(b3);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (acc_bf16 && dot_bf16)
    return launch_body<__nv_bfloat16, true>(hidden, body, acc, fw2, fb2, fw3,
                                            fb3, o, npix, block, s);
  if (acc_bf16)
    return launch_body<__nv_bfloat16, false>(hidden, body, acc, fw2, fb2,
                                             fw3, fb3, o, npix, block, s);
  if (dot_bf16)
    return launch_body<float, true>(hidden, body, acc, fw2, fb2, fw3, fb3, o,
                                    npix, block, s);
  return launch_body<float, false>(hidden, body, acc, fw2, fb2, fw3, fb3, o,
                                   npix, block, s);
}
