// One ResBlock1 step of the NSF generator's resblock bank, fused:
//
//     y = x + conv_k1(lrelu(conv_kd(lrelu(x)) + b1)) + b2
//
// with leaky-ReLU slope 0.1, zero SAME padding on both convs, f32
// accumulation. The bank (3 kernel sizes x 3 dilations) is nine launches;
// the last step of each bank adds its result into an f32 bank sum, and the
// last bank's last step writes (sum + y) / nbanks.
//
// Replaces: obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot (Pallas, TPU;
// the C=32 and C=64 levels) and obs_rvc_tpu/ops/resblock.py:resblock_bank
// (its im2col form, which the JAX package keeps for C<32; here C=16). Both
// hold one stream's whole [C, L + 64] activation in VMEM. That is 1.8 MB at
// C=64, L=7000 in f32 and does not fit a Hopper block's 227 KB of shared
// memory, so this kernel tiles the time axis across blocks instead.
//
// What bounds it: at the main path's shapes (C=64 at L=7000, C=32 at
// L=14000) the bank does 7.23 and 3.61 GFLOP against ~0.02 GB of
// activation traffic per step, so it is bound by arithmetic: at float32's
// 67 TFLOP/s without tensor cores, 0.11 ms and 0.054 ms. (TF32 tensor cores
// would be faster but round the inputs to 10 mantissa bits, outside the
// float32 contract of the JAX function.)
//
// Design: a block owns a tile of TL output positions and all C channels.
// It loads lrelu(x) over the tile plus a halo of d*(K-1)/2 + (K-1)/2 into
// shared memory, computes the dilated conv over the tile plus the second
// conv's halo into a second shared tile (zeroed outside [0, L), which is the
// second conv's SAME padding), then the second conv and the residual.
// Nothing between the two convs leaves the SM. Each thread computes a 4x4
// register tile (4 positions x 4 output channels), reading activations and
// weights as float4 from shared memory; the weights are staged one tap
// ([C_in][C_out], 16 KB at C=64) at a time, so the 180 KB of a k=11 conv
// never has to fit. The first conv's halo is recomputed by neighbouring
// blocks (up to 18 % extra work at k=11, C=64): simple and correct first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NTHREADS = 256;
constexpr int CC = 4;  // output channels per thread
constexpr int PP = 4;  // positions per thread
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

template <int C>
struct Geo {
  static constexpr int CG = C / CC;         // channel groups
  static constexpr int PG = NTHREADS / CG;  // position groups
  static constexpr int R = PG * PP;         // positions one conv pass covers
};

// Copy one tap's [C][C] f32 weights (16-byte aligned) into shared memory.
template <int C>
__device__ __forceinline__ void stage_tap(float* ws, const float* __restrict__ w) {
  const float4* src = reinterpret_cast<const float4*>(w);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = threadIdx.x; i < C * C / 4; i += NTHREADS) dst[i] = src[i];
}

// acc[p][c] += sum_ci src[(row0 + p) * C + ci] * ws[ci * C + co + c]
template <int C>
__device__ __forceinline__ void tap_fma(float (&acc)[PP][CC], const float* src, const float* ws, int co) {
#pragma unroll 4
  for (int ci = 0; ci < C; ci += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(ws + (ci + j) * C + co);
#pragma unroll
    for (int p = 0; p < PP; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(src + p * C + ci);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[p][0] = fmaf(xs[j], wv[j].x, acc[p][0]);
        acc[p][1] = fmaf(xs[j], wv[j].y, acc[p][1]);
        acc[p][2] = fmaf(xs[j], wv[j].z, acc[p][2]);
        acc[p][3] = fmaf(xs[j], wv[j].w, acc[p][3]);
      }
    }
  }
}

template <int C, int K>
constexpr size_t smem_floats(int d) {
  return (size_t)C * C + (size_t)(Geo<C>::R + K - 1) * C + (size_t)(Geo<C>::R + d * (K - 1)) * C;
}

// mode: 0 out = y; 1 acc = y; 2 acc += y; 3 out = (acc + y) * scale
template <typename T, int C, int K>
__global__ void __launch_bounds__(NTHREADS)
resblock_step_kernel(const T* __restrict__ x, T* __restrict__ out, float* __restrict__ acc,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     int L, int d, int mode, float scale) {
  constexpr int R = Geo<C>::R;
  constexpr int P2 = (K - 1) / 2;
  constexpr int TL = R - 2 * P2;
  constexpr int SR = R + K - 1;
  const int P1 = d * (K - 1) / 2;
  const int XR = R + 2 * P1;

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [C][C], one tap
  float* ss = ws + C * C;                       // [SR][C], conv1 output
  float* xs = ss + SR * C;                      // [XR][C], lrelu(x)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * TL;
  const T* xb = x + (size_t)b * L * C;

  const int g0 = l0 - P2 - P1;
  for (int i = tid; i < XR * C; i += NTHREADS) {
    const int row = i / C, c = i % C;
    const int g = g0 + row;
    xs[i] = (g >= 0 && g < L) ? lrelu(load(xb, (size_t)g * C + c)) : 0.f;
  }
  for (int i = tid; i < (SR - R) * C; i += NTHREADS) ss[R * C + i] = 0.f;

  const int co = (tid % Geo<C>::CG) * CC;
  const int p0 = (tid / Geo<C>::CG) * PP;

  float a[PP][CC];
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int c = 0; c < CC; ++c) a[p][c] = 0.f;

  // conv1 (k=K, dilation d) over positions l0 - P2 + [0, R)
  for (int t = 0; t < K; ++t) {
    __syncthreads();
    stage_tap<C>(ws, w1 + (size_t)t * C * C);
    __syncthreads();
    tap_fma<C>(a, xs + (p0 + t * d) * C, ws, co);
  }
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int g = l0 - P2 + p0 + p;
    const bool inside = g >= 0 && g < L;
    float4 v;
    v.x = inside ? lrelu(a[p][0] + __ldg(b1 + co + 0)) : 0.f;
    v.y = inside ? lrelu(a[p][1] + __ldg(b1 + co + 1)) : 0.f;
    v.z = inside ? lrelu(a[p][2] + __ldg(b1 + co + 2)) : 0.f;
    v.w = inside ? lrelu(a[p][3] + __ldg(b1 + co + 3)) : 0.f;
    *reinterpret_cast<float4*>(ss + (p0 + p) * C + co) = v;
#pragma unroll
    for (int c = 0; c < CC; ++c) a[p][c] = 0.f;
  }

  // conv2 (k=K, dilation 1) over outputs l0 + [0, R), of which [0, TL) are kept
  for (int t = 0; t < K; ++t) {
    __syncthreads();
    stage_tap<C>(ws, w2 + (size_t)t * C * C);
    __syncthreads();
    tap_fma<C>(a, ss + (p0 + t) * C, ws, co);
  }

#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int r = p0 + p;
    const int g = l0 + r;
    if (r >= TL || g >= L) continue;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const size_t idx = ((size_t)b * L + g) * C + co + c;
      const float y = a[p][c] + __ldg(b2 + co + c) + load(xb, (size_t)g * C + co + c);
      switch (mode) {
        case 0: store(out, idx, y); break;
        case 1: acc[idx] = y; break;
        case 2: acc[idx] += y; break;
        default: store(out, idx, (acc[idx] + y) * scale); break;
      }
    }
  }
}

template <typename T, int C, int K>
cudaError_t launch(const void* x, void* out, float* acc, const float* w1, const float* b1,
                   const float* w2, const float* b2, int B, int L, int d, int mode, float scale,
                   cudaStream_t stream) {
  constexpr int TL = Geo<C>::R - (K - 1);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(resblock_step_kernel<T, C, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_floats<C, K>(5) * sizeof(float)));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = smem_floats<C, K>(d) * sizeof(float);
  dim3 grid((L + TL - 1) / TL, B);
  resblock_step_kernel<T, C, K><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), acc, w1, b1, w2, b2, L, d, mode, scale);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_k(int k, const void* x, void* out, float* acc, const float* w1, const float* b1,
                     const float* w2, const float* b2, int B, int L, int d, int mode, float scale,
                     cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, C, 3>(x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    case 7: return launch<T, C, 7>(x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    case 11: return launch<T, C, 11>(x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_c(int C, int k, const void* x, void* out, float* acc, const float* w1,
                     const float* b1, const float* w2, const float* b2, int B, int L, int d, int mode,
                     float scale, cudaStream_t stream) {
  switch (C) {
    case 16: return launch_k<T, 16>(k, x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    case 32: return launch_k<T, 32>(k, x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    case 64: return launch_k<T, 64>(k, x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [B, L, C] in the activation type (dtype 0 float32, 1 bfloat16);
// acc: [B, L, C] float32 bank sum; w1, w2: [k][C_in][C_out] float32;
// b1, b2: [C] float32. Weight pointers must be 16-byte aligned.
extern "C" int rvc_resblock_step(const void* x, void* out, float* acc, const float* w1,
                                 const float* b1, const float* w2, const float* b2, int B, int L,
                                 int C, int k, int d, int mode, int dtype, float scale,
                                 void* stream) {
  if (d < 1 || d > 5 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? launch_c<float>(C, k, x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, s)
          : dtype == 1
                ? launch_c<__nv_bfloat16>(C, k, x, out, acc, w1, b1, w2, b2, B, L, d, mode, scale, s)
                : cudaErrorInvalidValue;
  return (int)e;
}
