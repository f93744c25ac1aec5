// K13: the hyper-synthesis and sigma -> coding bin of the scale-hyperprior
// codec, for Hopper (sm_90a), in a fixed order of operations.
//
// Replaces no Pallas kernel: JAX computes this stage in XLA
// (nic/train/hyperprior.py:284 `h_s_bins`, over nic/models/hyperprior.py
// HyperSynthesis). It exists because sigma picks the rANS table of every
// y symbol, so the encoder and the decoder must compute the IDENTICAL bin,
// on the card and on the CPU; cuDNN's summation order depends on the
// algorithm it picks and libdevice's expf/logf/tanhf are not the CPU's.
// So every product and sum here is one separately rounded fp32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never contracted into an
// FMA), exp, log and tanh are one explicit routine of such operations, and
// the plain version (nic_torch/kernels/hs_bins.py `hs_bins_plain`) performs
// the same operations in the same order in torch ops: the card and the CPU
// give the same bits.
//
// For z [B][N][h4][w4] (the decoded z-hat as float32), weights in rows
// layout w[co][tap * Cin + ci] (the JAX kernel matrix transposed; taps in
// JAX's order), three launches of one template (hs_layer):
//   1. s1 = gelu(convT(z)),  N -> N, k4 s2 p1: each output phase (ry, rx)
//      sums its 2x2 real taps in JAX's polyphase order
//      (nic/models/matmul_conv.py:190-226: ay, ax ascending, tap
//      (ry + 2 ay, rx + 2 ax), input (u + ry - 1 + ay, v + rx - 1 + ax)),
//      each tap's partial over Cin ascending from 0, the first partial
//      assigned and the others added in that order, then the bias;
//   2. s2 = gelu(convT(s1)), the same;
//   3. v = conv3x3(s2) + b, N -> M, one sum over taps in
//      itertools.product order and Cin ascending, from 0, bias last;
//      sigma = exp(v); bin = ceil((log(sigma) - ln(0.11)) * 63 /
//      ln(64 / 0.11)) clipped to [0, 63] (a NaN to 0).
// gelu is the tanh form: x * (0.5 * (1 + tanh(c * (x + a * x^3)))).
// Out-of-range taps are real operations on zeros (add(t, mul(0, w))), as
// F.pad gives the plain version: skipping them would change signed zeros.
//
// What bounds it: operations. At 512x768 (z 8x12x96 -> sigma 32x48x128)
// the three layers do 0.24 G multiply-adds (layer 3 170 M, layer 2 57 M,
// layer 1 14 M), each a separate multiply and add: 0.48 G instructions at
// half the FMA peak, 33.5 TFLOP/s, is 0.0144 ms; the bytes (z, weights,
// sigma, bins) take under a microsecond.
//
// What held the first design (one thread per output) back: every
// multiply-add loaded x from global memory (a computed, predicated
// address) and its weight from shared memory, so two loads fed one
// multiply and one add and the kernel was bound by load issue, not by the
// FP pipes; each z/s1/s2 value was reused by all output channels and taps
// only through L1/L2, and each weight by one output; and each thread ran
// one 864-deep dependent chain. It took 0.2545 ms at 512x768.
//
// Design (hs_layer, one template for the three layers): a block computes 16
// output channels x a tile of kTR rows x kTW columns (of the output grid, or
// for layers 1-2 of one output phase's grid, whose outputs share that phase's
// 4 taps); a thread computes 4 channels x kTR pixels (one column), 4 kTR
// independent chains (two registers an output in layers 1-2: the tap's partial
// and the sum). The block stages its input window, the tile plus a one-pixel
// halo with zeros outside the image, channels innermost ([pixel][S], S the
// channel count padded to a multiple of 4 with S/4 odd, so a warp's float4
// reads of consecutive pixels hit distinct banks; rows padded to 128 bytes),
// and the weights of one tap for its 16 channels at a time into two buffers:
// each tap's copies (its weights and the window rows it reads first) are
// issued right after the previous tap's barrier and land while that tap
// computes. Thread 0 issues them as tensor copies of the tensor memory
// accelerator onto an mbarrier: one box of 16 weight rows x N a tap, and one
// box a window row of s1/s2 (the copy writes zeros outside the image and past
// Co). Issuing takes 160-500 cycles a tap against ~3,500 of compute in layer 3
// at 512x768 (scripts/torch_k13_probe.py's clock64 timeline); per-lane
// cp.async copies, this design's first staging, took longer to issue than a
// tap to compute, and a bulk copy a weight row still a large share of it. z
// (channels-first) and widths whose rows a box cannot take (N not a multiple
// of 4, N past 252) use 4-byte cp.async. Per tap, the chains run over Cin
// ascending in steps of 4 (then a scalar tail), the next step's float4 reads
// in flight: kTR window reads and four weight reads feed 16 kTR multiply-adds.
// Cin is never chunked outside the tap, so every output's chain keeps its
// order. s1 and s2 are written channels-last with stride S ([B][H][W][S]).
//
// Tiles and grid (launch): kTW = 16 (64 threads); kTR = 4 where that grid
// still gives kFillBlocks (2 an SM) blocks, else kTR = 1: at 512x768 (N = 96,
// M = 128) every layer takes 1-row tiles, grids of 192, 768 and 768 blocks
// with 34.7 KB of shared memory each, all resident at once; 2-row tiles take
// 27% longer there and 4-row ones 43% longer (fewer, longer blocks on a card
// that one wave does not fill), while at 2048^2 the 4-row tiles are fastest,
// 14% ahead of 1-row ones (fewer shared reads a multiply-add;
// scripts/torch_k13_probe.py on an H100 at 700 W). Past N = 668 the 16-column
// tiles no longer fit and kTW = 8 (32 threads); past N = 932 nothing fits and
// the call is refused. The three launches stay: layer 3 reads s2's halo across
// tiles, and a fused 2->3 would recompute it.
//
// Entry point: nic_hs_bins (plain C, loaded with ctypes). It launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// 2^k for k in [-126, 127], exactly
__device__ __forceinline__ float pow2i(int k) {
  return __int_as_float((k + 127) << 23);
}

// exp: k = rint(x log2 e), r = (x - k ln2_hi) - k ln2_lo, e^r = 1 + (r +
// r^2 Q(r)), times 2^(k/2) and 2^(k - k/2) (two exact-scale products, one
// rounding into the subnormals); <= 1 ulp of a float64 reference
__device__ float exp_fixed(float x) {
  float xc = x > 89.0f ? 89.0f : x;
  xc = xc < -104.0f ? -104.0f : xc;
  const float kf = rintf(mul(xc, 1.4426950216293335f));
  const float r = sub(sub(xc, mul(kf, 0.693145751953125f)),
                      mul(kf, 1.428606765330187e-06f));
  float q = 0.000198992871446535f;
  q = add(mul(q, r), 0.0013933652080595493f);
  q = add(mul(q, r), 0.0083332983776927f);
  q = add(mul(q, r), 0.04166646674275398f);
  q = add(mul(q, r), 0.1666666716337204f);
  q = add(mul(q, r), 0.5f);
  const float p = add(1.0f, add(r, mul(mul(r, r), q)));
  const int k = __float2int_rn(kf);
  const int k1 = k >> 1;
  const float out = mul(mul(p, pow2i(k1)), pow2i(k - k1));
  return x != x ? x : out;
}

// log (fdlibm's logf): s = m 2^e, m in (sqrt(2)/2, sqrt(2)], f = m - 1,
// log(1 + f) by f/(2 + f) and a polynomial; subnormals scaled by 2^25
__device__ float log_fixed(float s) {
  const bool tiny = s < 1.1754943508222875e-38f;
  const float sc = tiny ? mul(s, 33554432.0f) : s;
  const int bits = __float_as_int(sc);
  int e = (bits >> 23) - 127 - (tiny ? 25 : 0);
  float m = __int_as_float((bits & 0x7fffff) | 0x3f800000);
  if (m > 1.4142135381698608f) {
    m = mul(m, 0.5f);
    e += 1;
  }
  const float f = sub(m, 1.0f);
  const float sv = __fdiv_rn(f, add(2.0f, f));
  const float z = mul(sv, sv);
  const float w = mul(z, z);
  const float t1 = mul(w, add(0.40000972151756287f, mul(w, 0.24279078841209412f)));
  const float t2 = mul(z, add(0.6666666269302368f, mul(w, 0.2849878668785095f)));
  const float R = add(t2, t1);
  const float hfsq = mul(mul(0.5f, f), f);
  const float dk = static_cast<float>(e);
  float out = sub(mul(dk, 0.6931381225585938f),
                  sub(sub(hfsq, add(mul(sv, add(hfsq, R)),
                                    mul(dk, 9.05800061445916e-06f))),
                      f));
  if (s == 0.0f) out = -__int_as_float(0x7f800000);
  if (s == __int_as_float(0x7f800000)) out = s;
  if (s != s) out = s;
  if (s < 0.0f) out = __int_as_float(0x7fc00000);
  return out;
}

// tanh: |u| < 0.625 by u + u^3 P(u^2), else 1 - 2 / (exp(2|u|) + 1); sign
// restored; <= 1.3 ulp
__device__ float tanh_fixed(float u) {
  const float a = fabsf(u);
  const float s = mul(a, a);
  float P = 0.0022956032771617174f;
  P = add(mul(P, s), -0.00834672525525093f);
  P = add(mul(P, s), 0.02176986075937748f);
  P = add(mul(P, s), -0.05395938828587532f);
  P = add(mul(P, s), 0.13333304226398468f);
  P = add(mul(P, s), -0.3333333432674408f);
  const float small = add(a, mul(a, mul(s, P)));
  const float e = exp_fixed(add(a, a));
  const float big = sub(1.0f, __fdiv_rn(2.0f, add(e, 1.0f)));
  float t = a < 0.625f ? small : big;
  t = u < 0.0f ? -t : t;
  return u != u ? u : t;
}

__device__ __forceinline__ float gelu_fixed(float x) {
  const float x3 = mul(mul(x, x), x);
  const float inner = add(x, mul(0.044714998453855515f, x3));
  const float th = tanh_fixed(mul(0.7978845834732056f, inner));
  return mul(x, mul(0.5f, add(1.0f, th)));
}

constexpr int kTC = 16;  // output channels a block computes, 4 a thread
constexpr size_t kMaxSmem = 232448;  // the shared bytes a block may take
// a layer takes 4-row tiles where they still give 2 blocks an SM of the
// H100's 132 (fewer, larger tiles: fewer shared reads a multiply-add),
// else 1-row tiles (more, shorter blocks for a grid that fills the card
// once at most)
constexpr int kFillBlocks = 2 * 132;

// the staged channel stride: N padded to a multiple of 4 floats (float4
// reads) with stride / 4 odd (consecutive pixels in distinct bank quads)
int chan_stride(int n) {
  const int s = (n + 3) & ~3;
  return (s / 4) % 2 == 0 ? s + 4 : s;
}

// the window (rows padded to 128 bytes), two weight buffers and their two
// mbarriers, for tiles of tr rows x tw columns
size_t smem_bytes(int tw, int tr, int n) {
  const int s = chan_stride(n), rp = ((tw + 2) * s + 31) & ~31;
  return (static_cast<size_t>(tr + 2) * rp + 2 * kTC * s) * sizeof(float) +
         2 * sizeof(unsigned long long);
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; !valid writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the tensor memory accelerator's tiled copies of a box of a tensor map,
// global -> shared (128-byte aligned), completing on an mbarrier; a box's
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_copy_2d(float* dst, const CUtensorMap* map,
                                            int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_copy_4d(float* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the one arrival of a phase, expecting `bytes` of tensor copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Four channels' worth of one tap for a thread's kTR x 4 chains:
// ch[i][j] += x[pixel i][ci + k] * w[channel j][ci + k], k = 0..3 in order.
template <int kTR>
__device__ __forceinline__ void chains4(float (&ch)[kTR][4],
                                        const float4 (&xv)[kTR],
                                        const float4 (&wv)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float xk = k == 0 ? xv[i].x : k == 1 ? xv[i].y
                     : k == 2 ? xv[i].z : xv[i].w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wk = k == 0 ? wv[j].x : k == 1 ? wv[j].y
                       : k == 2 ? wv[j].z : wv[j].w;
        ch[i][j] = add(ch[i][j], mul(xk, wk));
      }
    }
  }
}

template <int kTR>
__device__ __forceinline__ void load4(float4 (&xv)[kTR], float4 (&wv)[4],
                                      const float* xq, const float* wq,
                                      int RP, int wS, int ci) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
    xv[i] = *reinterpret_cast<const float4*>(xq + i * RP + ci);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wv[j] = *reinterpret_cast<const float4*>(wq + j * wS + ci);
}

// One tap of a thread's chains: ch[i][j] += x[pixel i][ci] *
// w[channel j][ci] for ci ascending, four channels at a time with the next
// four's shared-memory reads in flight (two register sets in turn), then
// one at a time. xq is the tap's window pixel of the thread's first row
// (rows RP floats apart), wq its first output channel's weights (channels
// wS apart).
template <int kTR>
__device__ __forceinline__ void tap_chains(float (&ch)[kTR][4],
                                           const float* xq, const float* wq,
                                           int N, int RP, int wS) {
  int ci = 0;
  if (N >= 4) {
    float4 xa[kTR], wa[4], xb[kTR], wb[4];
    load4<kTR>(xa, wa, xq, wq, RP, wS, 0);
    for (; ci + 12 <= N; ci += 8) {
      load4<kTR>(xb, wb, xq, wq, RP, wS, ci + 4);
      chains4(ch, xa, wa);
      load4<kTR>(xa, wa, xq, wq, RP, wS, ci + 8);
      chains4(ch, xb, wb);
    }
    if (ci + 8 <= N) {
      load4<kTR>(xb, wb, xq, wq, RP, wS, ci + 4);
      chains4(ch, xa, wa);
      chains4(ch, xb, wb);
      ci += 8;
    } else {
      chains4(ch, xa, wa);
      ci += 4;
    }
  }
  for (; ci < N; ++ci) {
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float xk = xq[i * RP + ci];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ch[i][j] = add(ch[i][j], mul(xk, wq[j * wS + ci]));
    }
  }
}

// One layer. x is [B][N][H][W] (kInCL false: z) or [B][H][W][S] (kInCL
// true: s1, s2). kConvT: H x W is the input grid, blockIdx.z = b * 4 +
// phase (ry, rx), y = gelu(convT + b) as [B][2H][2W][S] (Co = N); else
// y = sigma and bins as [B][Co][H][W]. w is [Co][taps * N] (16 taps, or
// 9). S is the channel stride of the staged pixels and of s1, s2;
// col_tiles = ceil(W / kTW). With use_maps (N a multiple of 4, S <= 256,
// w and x 16-byte aligned) wmap is w as a [Co][taps * N] tensor (boxes of
// 16 rows x N) and, for kInCL, xmap is x as a [B][H][W][S] tensor (boxes
// of one row of kTW + 2 pixels).
template <int kTW, int kTR, bool kConvT, bool kInCL>
__global__ void __launch_bounds__(4 * kTW)
hs_layer(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ b, float* __restrict__ y,
         int* __restrict__ bins, int N, int H, int W, int Co, int S,
         int col_tiles, int use_maps, const __grid_constant__ CUtensorMap wmap,
         const __grid_constant__ CUtensorMap xmap) {
  constexpr int kThreads = 4 * kTW, kWarps = (kThreads + 31) / 32;
  constexpr int kWinW = kTW + 2;
  constexpr int kTaps = kConvT ? 4 : 9, kRowTaps = kConvT ? 16 : 9;
  // window rows RP floats apart (a multiple of 128 bytes: a tensor copy's
  // destination), two weight buffers of kTC x S, two mbarriers
  const int RP = (kWinW * S + 31) & ~31;
  extern __shared__ __align__(128) float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kTR + 2][RP]
  float* ws = xs + (kTR + 2) * RP;             // [2][kTC][S]
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ws + 2 * kTC * S);
  // a tap's weights arrive packed (channels N apart) by the tensor copy,
  // else S apart
  const int wS = use_maps ? N : S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x / col_tiles * kTR;
  const int c0 = blockIdx.x % col_tiles * kTW;
  const int co0 = blockIdx.y * kTC;
  const int phase = kConvT ? blockIdx.z & 3 : 0;
  const int bi = kConvT ? blockIdx.z >> 2 : blockIdx.z;
  const int ry = phase >> 1, rx = phase & 1;
  const size_t plane = static_cast<size_t>(H) * W;
  // z's batch stride is N planes; s1's and s2's, S channels a pixel
  const float* xb = x + static_cast<size_t>(bi) * (kInCL ? S : N) * plane;

  // Copy group of tap t, into weight buffer t & 1, issued while tap t - 1
  // computes: the tap's weights for the block's channels and window rows
  // lo..hi (of r0 - 1 .. r0 + kTR; columns c0 - 1 .. c0 + kTW), the rows
  // that tap reads first. With the tensor maps thread 0 issues one tensor
  // copy for the weights (rows past Co arrive as zeros) and one a window
  // row of s1/s2 (pixels outside the image arrive as zeros), onto the
  // buffer's mbarrier; else every thread copies 4 bytes at a time by
  // cp.async (zeros outside the image; weight rows past Co left unset:
  // their chains are never stored), as it always does z's
  // (channels-first) pixels.
  auto stage = [&](int t, int lo, int hi) {
    const int buf = t & 1;
    const int q = kConvT ? (ry + 2 * (t >> 1)) * 4 + rx + 2 * (t & 1) : t;
    float* wdst = ws + buf * kTC * S;
    if (use_maps) {
      if (tid == 0) {
        mbar_expect(&bars[buf], (kTC * N + (kInCL ? (hi - lo + 1) * kWinW * S
                                                   : 0)) * 4);
        tma_copy_2d(wdst, &wmap, q * N, co0, &bars[buf]);
        if constexpr (kInCL)
          for (int r = lo; r <= hi; ++r)
            tma_copy_4d(xs + r * RP, &xmap, 0, c0 - 1, r0 - 1 + r, bi,
                        &bars[buf]);
      }
    } else {
      if (tid == 0) mbar_expect(&bars[buf], 0);
      const float* wsrc = w + static_cast<size_t>(co0) * kRowTaps * N + q * N;
      for (int c = warp; c < min(kTC, Co - co0); c += kWarps)
        for (int ci = lane; ci < N; ci += 32)
          cp_async4(wdst + c * S + ci,
                    wsrc + static_cast<size_t>(c) * kRowTaps * N + ci, true);
    }
    if constexpr (kInCL) {
      if (!use_maps) {  // a warp a pixel, its lanes over the channels
        for (int p = lo * kWinW + warp; p < (hi + 1) * kWinW; p += kWarps) {
          const int iy = r0 - 1 + p / kWinW, ix = c0 - 1 + p % kWinW;
          const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
          const float* src =
              xb + (in ? (static_cast<size_t>(iy) * W + ix) * S : 0);
          float* dst = xs + (p / kWinW) * RP + (p % kWinW) * S;
          for (int ci = lane; ci < N; ci += 32)
            cp_async4(dst + ci, src + ci, in);
        }
      }
    } else {  // z, channels-first: 4-byte copies, a lane's pixel fixed
      for (int p = lo * kWinW + lane; p < (hi + 1) * kWinW; p += 32) {
        const int iy = r0 - 1 + p / kWinW, ix = c0 - 1 + p % kWinW;
        const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const float* src =
            xb + (in ? static_cast<size_t>(iy) * W + ix : 0) + warp * plane;
        float* dst = xs + (p / kWinW) * RP + (p % kWinW) * S + warp;
        for (int ci = warp; ci < N;
             ci += kWarps, src += kWarps * plane, dst += kWarps)
          cp_async4(dst, src, in);
      }
    }
  };
  // the window rows tap t reads: dy(t) .. dy(t) + kTR - 1
  auto dy_of = [&](int t) { return kConvT ? ry + (t >> 1) : t / 3; };
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(0, dy_of(0), dy_of(0) + kTR - 1);

  const int cg = tid / kTW, col = tid % kTW;
  float acc[kTR][4];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < kTaps; ++t) {
    cp_async_wait_all();  // tap t's cp.async copies
    mbar_wait(&bars[t & 1], (t >> 1) & 1);  // and its tensor copies
    __syncthreads();  // visible to all; all are done with tap t - 1
    if (t + 1 < kTaps)  // so tap t + 1 may fill its buffer now
      stage(t + 1, dy_of(t) + kTR, dy_of(t + 1) + kTR - 1);
    const int dy = dy_of(t);
    const int dx = kConvT ? rx + (t & 1) : t % 3;
    const float* xq = xs + dy * RP + (col + dx) * S;
    const float* wq = ws + (t & 1) * kTC * S + 4 * cg * wS;
    if constexpr (kConvT) {  // each tap's partial from 0, then into acc
      float part[kTR][4];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
      tap_chains<kTR>(part, xq, wq, N, RP, wS);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = t == 0 ? part[i][j] : add(acc[i][j], part[i][j]);
    } else {  // one chain over every tap
      tap_chains<kTR>(acc, xq, wq, N, RP, wS);
    }
  }

  const int ox = c0 + col;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int oy = r0 + i;
    if (oy >= H || ox >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * cg + j;
      if (co >= Co) continue;
      if constexpr (kConvT) {
        const size_t o =
            ((static_cast<size_t>(bi) * 2 * H + 2 * oy + ry) * 2 * W +
             2 * ox + rx) * S + co;
        y[o] = gelu_fixed(add(acc[i][j], b[co]));
      } else {
        const float s = exp_fixed(add(acc[i][j], b[co]));
        const float vb = mul(sub(log_fixed(s), -2.207274913787842f),
                             9.896079063415527f);
        float bin = ceilf(vb);
        bin = bin < 0.0f ? 0.0f : bin;
        bin = bin > 63.0f ? 63.0f : bin;
        bin = bin != bin ? 0.0f : bin;
        const size_t o = (static_cast<size_t>(bi) * Co + co) * plane +
                         static_cast<size_t>(oy) * W + ox;
        y[o] = s;
        bins[o] = static_cast<int>(bin);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a float32 tensor of `rank` dims (innermost first, strides in bytes of
// dims 1..) with boxes of `box`; zeros outside it
bool encode(CUtensorMap* map, const float* base, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<float*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One layer's launch. Its tile: 16 columns x 4 rows where that grid has
// kFillBlocks blocks and its shared memory fits, else 16 x 1, else (N past
// 668) 8 x 1; none past N = 932. Tensor copies where N is a multiple of 4,
// S <= 256 (a box's 256 elements) and w, x are 16-byte aligned.
template <bool kConvT, bool kInCL>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int* bins, int B, int N, int H, int W, int Co,
                   cudaStream_t st) {
  const int phases = kConvT ? 4 : 1, co_tiles = (Co + kTC - 1) / kTC;
  const long long rows4 = (H + 3) / 4, cols16 = (W + 15) / 16;
  int tw = 16, tr = 1;
  if (rows4 * cols16 * co_tiles * B * phases >= kFillBlocks &&
      smem_bytes(16, 4, N) <= kMaxSmem)
    tr = 4;
  else if (smem_bytes(16, 1, N) > kMaxSmem)
    tw = 8;
  const size_t smem = smem_bytes(tw, tr, N);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int S = chan_stride(N), taps = kConvT ? 16 : 9;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  };
  CUtensorMap wmap = {}, xmap = {};
  const int use_maps = (N & 3) == 0 && S <= 256 && aligned(w) && aligned(x);
  if (use_maps) {
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(taps) * N,
                                 static_cast<cuuint64_t>(Co)};
    const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(taps) * N * 4};
    const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(N), kTC};
    const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(W),
                                 static_cast<cuuint64_t>(H),
                                 static_cast<cuuint64_t>(B)};
    const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(S) * 4,
                                    static_cast<cuuint64_t>(S) * W * 4,
                                    static_cast<cuuint64_t>(S) * W * H * 4};
    const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(S),
                                static_cast<cuuint32_t>(tw + 2), 1, 1};
    if (!encode(&wmap, w, 2, wdims, wstrides, wbox) ||
        (kInCL && !encode(&xmap, x, 4, xdims, xstrides, xbox)))
      return cudaErrorInvalidValue;
  }
  auto kern = tw == 8   ? hs_layer<8, 1, kConvT, kInCL>
              : tr == 4 ? hs_layer<16, 4, kConvT, kInCL>
                        : hs_layer<16, 1, kConvT, kInCL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int col_tiles = (W + tw - 1) / tw;
  const dim3 grid(col_tiles * ((H + tr - 1) / tr), co_tiles, B * phases);
  kern<<<grid, 4 * tw, smem, st>>>(x, w, b, y, bins, N, H, W, Co, S,
                                   col_tiles, use_maps, wmap, xmap);
  return cudaGetLastError();
}

}  // namespace

// z [B][N][h4][w4] -> s1 [B][2 h4][2 w4][S], s2 [B][4 h4][4 w4][S]
// (channels-last scratch from the caller, S = chan_stride(N), 16-byte
// aligned), sigma and bins [B][M][4 h4][4 w4]. Returns the CUDA error of
// the launches (0 on success); cudaErrorInvalidValue where no tile fits
// N's shared memory.
extern "C" int nic_hs_bins(const void* z, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* w3,
                           const void* b3, void* s1, void* s2, void* sigma,
                           void* bins, int B, int N, int M, int h4, int w4,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *zf = static_cast<const float*>(z),
              *w1f = static_cast<const float*>(w1),
              *b1f = static_cast<const float*>(b1),
              *w2f = static_cast<const float*>(w2),
              *b2f = static_cast<const float*>(b2),
              *w3f = static_cast<const float*>(w3),
              *b3f = static_cast<const float*>(b3);
  float *s1f = static_cast<float*>(s1), *s2f = static_cast<float*>(s2),
        *sf = static_cast<float*>(sigma);
  int* bf = static_cast<int*>(bins);
  cudaError_t e = launch<true, false>(zf, w1f, b1f, s1f, nullptr, B, N, h4,
                                      w4, N, st);
  if (e == cudaSuccess)
    e = launch<true, true>(s1f, w2f, b2f, s2f, nullptr, B, N, 2 * h4,
                           2 * w4, N, st);
  if (e == cudaSuccess)
    e = launch<false, true>(s2f, w3f, b3f, sf, bf, B, N, 4 * h4, 4 * w4, M,
                            st);
  return static_cast<int>(e);
}
