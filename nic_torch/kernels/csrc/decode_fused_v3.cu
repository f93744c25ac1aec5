// The v3 decode's MLP tail, for Hopper (sm_90a): GELU -> W2 -> GELU -> W3
// -> sigmoid over a flat [S^2, H] first-layer accumulator read from device
// memory.
//
// Replaces the Pallas TPU kernel nic/kernels/decode_fused_v3.py `_kernel`
// (:37), launched by `mlp_tail` (pallas_call at :75), K4. The accumulator
// comes from the folded first layer (nic_torch/grids/fastdecode.py
// `first_layer_acc`, PyTorch); this kernel is only the tail, K1's
// (decode_common.cuh): dots on w2.dtype inputs with fp32 sums, the A&S erf
// GELU, fp32 out.
//
// Design: a block of 128 threads covers `block` consecutive pixels (the
// JAX pipeline block, 4096 by default), 128 at a time: the block first
// copies the 128 accumulator rows into shared memory with coalesced
// 16-byte loads (rows padded to H + 4 floats, so the per-thread reads
// that follow are free of bank conflicts), then each thread runs the tail
// on its row. The per-step weight tiling of the TPU kernel (Mosaic's
// advancing-window rule) means nothing here and is not carried over. Built
// for H = 16, 64 and 128; past 128, any multiple of 64 runs mlp_tail_wide,
// which loads 16 accumulator rows into the wide tail's tile
// (decode_common.cuh).
//
// What bounds it: the tail is 2*(H*H + 3*H) = 8.6 kflop a pixel on fp32
// CUDA cores against H*sizeof(acc) + 12 bytes moved: at 2048^2, fp32
// accumulators are 1.07 GB (0.335 ms at 3.35 TB/s) against 36 GFLOP
// (0.537 ms at 67 TFLOP/s), so operations bound it; bf16 accumulators
// halve the bytes. The v3 decode as a whole pays for writing and reading
// back the accumulator that K1 keeps in registers.
//
// Entry point: nic_mlp_tail (plain C, loaded with ctypes). It launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <type_traits>

#include "decode_common.cuh"

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

}  // namespace

// K4: acc [npix][H] (fp32, or bf16 with acc_bf16 = 1), dots on bf16 inputs
// with dot_bf16 = 1 -> out [npix][3] fp32; H = 16, 64, 128 or a multiple
// of 64 up to 3264 (the wide tail)
extern "C" int nic_mlp_tail(const void* acc, const void* w2, const void* b2,
                            const void* w3, const void* b3, void* out,
                            long long npix, int hidden, int block,
                            int acc_bf16, int dot_bf16, void* stream) {
  if (npix <= 0 || block <= 0 || (npix + block - 1) / block > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fw3 = static_cast<const float*>(w3);
  const auto* fb3 = static_cast<const float*>(b3);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (hidden > 128) {
    if (hidden % WCB) return static_cast<int>(cudaErrorInvalidValue);
#define NIC_WIDE(TA, D)                                                  \
  if (acc_bf16 == std::is_same<TA, __nv_bfloat16>::value && dot_bf16 == D) \
    return launch_wide<TA, D>(acc, fw2, fb2, fw3, fb3, o, npix, hidden, s)
    NIC_WIDE(float, false);
    NIC_WIDE(float, true);
    NIC_WIDE(__nv_bfloat16, false);
    NIC_WIDE(__nv_bfloat16, true);
#undef NIC_WIDE
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define NIC_TAIL(H, TA, D)                                                 \
  if (hidden == H && acc_bf16 == std::is_same<TA, __nv_bfloat16>::value && \
      dot_bf16 == D)                                                       \
    return launch<H, TA, D>(acc, fw2, fb2, fw3, fb3, o, npix, block, s)
  NIC_TAIL(64, float, false);
  NIC_TAIL(64, float, true);
  NIC_TAIL(64, __nv_bfloat16, false);
  NIC_TAIL(64, __nv_bfloat16, true);
  NIC_TAIL(16, float, false);
  NIC_TAIL(16, float, true);
  NIC_TAIL(16, __nv_bfloat16, false);
  NIC_TAIL(16, __nv_bfloat16, true);
  NIC_TAIL(128, float, false);
  NIC_TAIL(128, float, true);
  NIC_TAIL(128, __nv_bfloat16, false);
  NIC_TAIL(128, __nv_bfloat16, true);
#undef NIC_TAIL
  return static_cast<int>(cudaErrorInvalidValue);
}
