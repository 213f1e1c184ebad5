// One ConvBlockRes block of an RMVPE U-Net level, fused:
//
//     y   = relu(conv3x3(relu(conv3x3(x) + b1)) + b2)
//     out = y + (Wsc^T x + bsc   if the block changes channels, else x)
//
// NHWC activations, BatchNorm already folded into the conv weights and
// biases by the caller, zero SAME padding, f32 accumulation. A U-Net level
// is n_blocks launches.
//
// Replaces: obs_rvc_tpu/ops/unet_block.py:conv_block_res_chain (Pallas,
// TPU), which keeps a stream's whole [C, H*W + 2*pad] level activation in
// VMEM (0.5 MB at C=16, 64x128) and runs the level's blocks back to back.
// That does not fit a Hopper block's 227 KB of shared memory, so this kernel
// tiles the spatial grid across blocks, one launch per block of the chain.
//
// What bounds it: the four C<=32 levels of the main path (enc0 1->16 and
// dec4 32->16 at 64x128, enc1 16->32 and dec3 64->32 at 32x64) do 1.25 GFLOP
// together against ~10 MB of activation traffic per step: bound by float32
// arithmetic, 0.019 ms at 67 TFLOP/s without tensor cores.
//
// Design: a block owns an output tile (14x14 pixels at C=16, 6x14 at C=32)
// and all C output channels. It loads the input tile with a 2-pixel halo
// (channels zero-padded to a multiple of 4) into shared memory, computes the
// first conv over the tile plus a 1-pixel halo into a second shared tile
// (zeroed outside the image, the second conv's SAME padding), then the
// second conv, the shortcut from the resident input tile and the residual
// add. The intermediate never leaves the SM. Each thread computes 4
// neighbouring pixels of one row x 4 output channels in registers; weights
// are staged one 3x3 tap ([Cin][C], at most 8 KB) at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NTHREADS = 256;
constexpr int CC = 4;   // output channels per thread
constexpr int PP = 4;   // pixels per thread, along W
constexpr int RW = 16;  // region width: output tile width + 2
constexpr int MAX_CIN = 64;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

template <int C>
struct Geo {
  static constexpr int CG = C / CC;          // channel groups
  static constexpr int PG = NTHREADS / CG;   // pixel groups
  static constexpr int RH = PG / (RW / PP);  // region height: output tile height + 2
  static constexpr int TH = RH - 2;
  static constexpr int TW = RW - 2;
  static constexpr int XP = (RH + 2) * (RW + 2);  // input tile pixels (2-pixel halo)
};

template <int C>
constexpr size_t smem_floats(int cinp) {
  return (size_t)(cinp > C ? cinp : C) * C + (size_t)Geo<C>::XP * cinp + (size_t)Geo<C>::XP * C;
}

// Stage a [cin][C] weight slab into [cinp][C] shared memory, zero rows >= cin.
template <int C>
__device__ __forceinline__ void stage(float* ws, const float* __restrict__ w, int cin, int cinp) {
  for (int i = threadIdx.x; i < cinp * C; i += NTHREADS) {
    const int ci = i / C;
    ws[i] = ci < cin ? __ldg(w + i) : 0.f;
  }
}

// acc[p][c] += sum_ci src[p * stride + ci] * ws[ci * C + co + c]
template <int C>
__device__ __forceinline__ void tap_fma(float (&acc)[PP][CC], const float* src, int stride,
                                        const float* ws, int co, int cinp) {
#pragma unroll 4
  for (int ci = 0; ci < cinp; ci += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(ws + (ci + j) * C + co);
#pragma unroll
    for (int p = 0; p < PP; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(src + p * stride + ci);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[p][0] = fmaf(xa[j], wv[j].x, acc[p][0]);
        acc[p][1] = fmaf(xa[j], wv[j].y, acc[p][1]);
        acc[p][2] = fmaf(xa[j], wv[j].z, acc[p][2]);
        acc[p][3] = fmaf(xa[j], wv[j].w, acc[p][3]);
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
conv_block_res_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ wsc, const float* __restrict__ bsc,
                      int H, int W, int cin, int cinp) {
  using G = Geo<C>;
  constexpr int XW = RW + 2;  // row stride, in pixels, of both shared tiles

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [max(cinp, C)][C], one tap
  float* xs = ws + (cinp > C ? cinp : C) * C;   // [RH+2][RW+2][cinp], input tile
  float* ys = xs + G::XP * cinp;                // [RH+2][RW+2][C], conv1 output

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * G::TH;
  const int w0 = blockIdx.x * G::TW;
  const T* xb = x + (size_t)b * H * W * cin;

  // input tile pixel (a, e) is image pixel (h0 - 2 + a, w0 - 2 + e)
  for (int i = tid; i < G::XP * cinp; i += NTHREADS) {
    const int pix = i / cinp, c = i % cinp;
    const int gh = h0 - 2 + pix / XW, gw = w0 - 2 + pix % XW;
    xs[i] = (c < cin && gh >= 0 && gh < H && gw >= 0 && gw < W)
                ? load(xb, ((size_t)gh * W + gw) * cin + c) : 0.f;
  }
  for (int i = tid; i < G::XP * C; i += NTHREADS) ys[i] = 0.f;

  const int co = (tid % G::CG) * CC;
  const int pg = tid / G::CG;
  const int ri = pg / (RW / PP);        // region row
  const int rj = (pg % (RW / PP)) * PP;  // region column of the first pixel
  // region pixel (ri, rj + p) is image pixel (h0 - 1 + ri, w0 - 1 + rj + p)

  float a[PP][CC];
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int c = 0; c < CC; ++c) a[p][c] = 0.f;

  for (int t = 0; t < 9; ++t) {
    const int dh = t / 3, dw = t % 3;
    __syncthreads();
    stage<C>(ws, w1 + (size_t)t * cin * C, cin, cinp);
    __syncthreads();
    tap_fma<C>(a, xs + ((ri + dh) * XW + rj + dw) * cinp, cinp, ws, co, cinp);
  }
  const int gh = h0 - 1 + ri;
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int gw = w0 - 1 + rj + p;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
    float4 v;
    v.x = inside ? fmaxf(a[p][0] + __ldg(b1 + co + 0), 0.f) : 0.f;
    v.y = inside ? fmaxf(a[p][1] + __ldg(b1 + co + 1), 0.f) : 0.f;
    v.z = inside ? fmaxf(a[p][2] + __ldg(b1 + co + 2), 0.f) : 0.f;
    v.w = inside ? fmaxf(a[p][3] + __ldg(b1 + co + 3), 0.f) : 0.f;
    *reinterpret_cast<float4*>(ys + ((ri + 1) * XW + rj + p + 1) * C + co) = v;
#pragma unroll
    for (int c = 0; c < CC; ++c) a[p][c] = 0.f;
  }

  for (int t = 0; t < 9; ++t) {
    const int dh = t / 3, dw = t % 3;
    __syncthreads();
    stage<C>(ws, w2 + (size_t)t * C * C, C, C);
    __syncthreads();
    tap_fma<C>(a, ys + ((ri + dh) * XW + rj + dw) * C, C, ws, co, C);
  }

  float sc[PP][CC];
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int c = 0; c < CC; ++c) sc[p][c] = 0.f;
  const float* xc = xs + ((ri + 1) * XW + rj + 1) * cinp;  // the region pixels' own input
  if (wsc != nullptr) {
    __syncthreads();
    stage<C>(ws, wsc, cin, cinp);
    __syncthreads();
    tap_fma<C>(sc, xc, cinp, ws, co, cinp);
#pragma unroll
    for (int p = 0; p < PP; ++p)
#pragma unroll
      for (int c = 0; c < CC; ++c) sc[p][c] += __ldg(bsc + co + c);
  } else {
#pragma unroll
    for (int p = 0; p < PP; ++p)
#pragma unroll
      for (int c = 0; c < CC; ++c) sc[p][c] = xc[p * cinp + co + c];
  }

  if (ri < 1 || ri > G::TH || gh >= H) return;
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int rc = rj + p;
    const int gw = w0 - 1 + rc;
    if (rc < 1 || rc > G::TW || gw >= W) continue;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const float y = fmaxf(a[p][c] + __ldg(b2 + co + c), 0.f);
      store(out, (((size_t)b * H + gh) * W + gw) * C + co + c, y + sc[p][c]);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* wsc, const float* bsc, int B, int H, int W, int cin,
                   cudaStream_t stream) {
  using G = Geo<C>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(conv_block_res_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_floats<C>(MAX_CIN) * sizeof(float)));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int cinp = (cin + 3) / 4 * 4;
  dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  conv_block_res_kernel<T, C><<<grid, NTHREADS, smem_floats<C>(cinp) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w1, b1, w2, b2, wsc, bsc, H, W, cin, cinp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(int C, const void* x, void* out, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* wsc, const float* bsc, int B,
                     int H, int W, int cin, cudaStream_t stream) {
  switch (C) {
    case 16: return launch<T, 16>(x, out, w1, b1, w2, b2, wsc, bsc, B, H, W, cin, stream);
    case 32: return launch<T, 32>(x, out, w1, b1, w2, b2, wsc, bsc, B, H, W, cin, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, H, W, cin], out: [B, H, W, C] in the activation type (dtype 0
// float32, 1 bfloat16); w1: [3][3][cin][C], w2: [3][3][C][C], wsc: [cin][C]
// or null for the identity shortcut (cin == C); b1, b2, bsc: [C]; all
// weights float32.
extern "C" int rvc_conv_block_res(const void* x, void* out, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* wsc,
                                  const float* bsc, int B, int H, int W, int cin, int C, int dtype,
                                  void* stream) {
  if (cin < 1 || cin > MAX_CIN || (wsc == nullptr && cin != C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0   ? launch_c<float>(C, x, out, w1, b1, w2, b2, wsc, bsc, B, H, W, cin, s)
                  : dtype == 1 ? launch_c<__nv_bfloat16>(C, x, out, w1, b1, w2, b2, wsc, bsc, B, H, W,
                                                         cin, s)
                               : cudaErrorInvalidValue;
  return (int)e;
}
