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
// JAX's order), three launches:
//   1. s1 = gelu(convT(z)),  N -> N, k4 s2 p1: each output phase (ry, rx)
//      sums its 2x2 real taps in JAX's polyphase order
//      (nic/models/matmul_conv.py:190-226: ay, ax ascending, tap
//      (ry + 2 ay, rx + 2 ax), input (u + ry - 1 + ay, v + rx - 1 + ax)),
//      each tap's partial over Cin ascending from 0, the taps' partials
//      summed in that order, then the bias;
//   2. s2 = gelu(convT(s1)), the same;
//   3. v = conv3x3(s2) + b, N -> M, one sum over taps in
//      itertools.product order and Cin ascending, from 0, bias last;
//      sigma = exp(v); bin = ceil((log(sigma) - ln(0.11)) * 63 /
//      ln(64 / 0.11)) clipped to [0, 63] (a NaN to 0).
// gelu is the tanh form: x * (0.5 * (1 + tanh(c * (x + a * x^3)))).
//
// Design: one thread per output element per layer; a block takes 128
// outputs of one channel and one image and stages that channel's weights
// (16 * Cin or 9 * Cin floats) in shared memory. Out-of-range taps read
// 0. Cost at 512x768 (z 8x12x96, sigma 32x48x128): ~0.24 G multiply-adds,
// bound by operations (~7 us at 67 TFLOP/s); speed is not its purpose.

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

constexpr int kThreads = 128;

// layers 1 and 2: x [B][C][H][W] -> y [B][Co][2H][2W]; w [Co][16 * C]
__global__ void __launch_bounds__(kThreads)
hs_convt_gelu(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ y, int C,
              int H, int W, int Co) {
  extern __shared__ float ws[];
  const int co = blockIdx.y, bi = blockIdx.z;
  for (int i = threadIdx.x; i < 16 * C; i += blockDim.x)
    ws[i] = w[static_cast<size_t>(co) * 16 * C + i];
  __syncthreads();
  const int OW = 2 * W, p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= 2 * H * OW) return;
  const int oy = p / OW, ox = p % OW;
  const int ry = oy & 1, rx = ox & 1, u = oy >> 1, v = ox >> 1;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(bi) * C * plane;
  float acc = 0.0f;
  for (int ay = 0; ay < 2; ++ay) {
    for (int ax = 0; ax < 2; ++ax) {
      const int iy = u + ry - 1 + ay, ix = v + rx - 1 + ax;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* xp = xb + (in ? static_cast<size_t>(iy) * W + ix : 0);
      const float* wq = ws + ((ry + 2 * ay) * 4 + (rx + 2 * ax)) * C;
      float t = 0.0f;
      for (int ci = 0; ci < C; ++ci) {
        const float xv = in ? xp[ci * plane] : 0.0f;
        t = add(t, mul(xv, wq[ci]));
      }
      acc = (ay == 0 && ax == 0) ? t : add(acc, t);
    }
  }
  y[(static_cast<size_t>(bi) * Co + co) * 4 * plane + p] =
      gelu_fixed(add(acc, b[co]));
}

// layer 3: x [B][C][H][W] -> sigma, bins [B][M][H][W]; w [M][9 * C]
__global__ void __launch_bounds__(kThreads)
hs_conv_bins(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ sigma,
             int* __restrict__ bins, int C, int H, int W, int M) {
  extern __shared__ float ws[];
  const int co = blockIdx.y, bi = blockIdx.z;
  for (int i = threadIdx.x; i < 9 * C; i += blockDim.x)
    ws[i] = w[static_cast<size_t>(co) * 9 * C + i];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const int oy = p / W, ox = p % W;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(bi) * C * plane;
  float acc = 0.0f;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int iy = oy - 1 + ky, ix = ox - 1 + kx;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* xp = xb + (in ? static_cast<size_t>(iy) * W + ix : 0);
      const float* wq = ws + (ky * 3 + kx) * C;
      for (int ci = 0; ci < C; ++ci) {
        const float xv = in ? xp[ci * plane] : 0.0f;
        acc = add(acc, mul(xv, wq[ci]));
      }
    }
  }
  const float s = exp_fixed(add(acc, b[co]));
  const float vb = mul(sub(log_fixed(s), -2.207274913787842f),
                       9.896079063415527f);
  float bin = ceilf(vb);
  bin = bin < 0.0f ? 0.0f : bin;
  bin = bin > 63.0f ? 63.0f : bin;
  bin = bin != bin ? 0.0f : bin;
  const size_t o = (static_cast<size_t>(bi) * M + co) * plane + p;
  sigma[o] = s;
  bins[o] = static_cast<int>(bin);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// z [B][N][h4][w4] -> s1 [B][N][2 h4][2 w4], s2 [B][N][4 h4][4 w4] (scratch
// from the caller), sigma and bins [B][M][4 h4][4 w4]. Returns the CUDA
// error of the launches (0 on success).
extern "C" int nic_hs_bins(const void* z, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* w3,
                           const void* b3, void* s1, void* s2, void* sigma,
                           void* bins, int B, int N, int M, int h4, int w4,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_t = 16 * sizeof(float) * N, smem_c = 9 * sizeof(float) * N;
  if (smem_t > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  hs_convt_gelu<<<dim3(blocks(4 * h4 * w4), N, B), kThreads, smem_t, st>>>(
      static_cast<const float*>(z), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(s1), N, h4, w4, N);
  hs_convt_gelu<<<dim3(blocks(16 * h4 * w4), N, B), kThreads, smem_t, st>>>(
      static_cast<const float*>(s1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(s2), N, 2 * h4,
      2 * w4, N);
  hs_conv_bins<<<dim3(blocks(16 * h4 * w4), M, B), kThreads, smem_c, st>>>(
      static_cast<const float*>(s2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(sigma),
      static_cast<int*>(bins), N, 4 * h4, 4 * w4, M);
  return static_cast<int>(cudaGetLastError());
}
