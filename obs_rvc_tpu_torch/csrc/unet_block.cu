// One RMVPE U-Net level's chain of ConvBlockRes blocks on the tensor cores:
//
//     y   = relu(conv3x3(relu(conv3x3(x) + b1)) + b2)
//     out = y + (Wsc^T x + bsc   if the block changes channels, else x)
//
// for each block of the level in turn. NHWC activations, BatchNorm already
// folded into the conv weights and biases, zero SAME padding.
//
// Replaces: obs_rvc_tpu/ops/unet_block.py:conv_block_res_chain (Pallas,
// TPU), which keeps a stream's whole [C, H*W + 2*pad] level activation in
// VMEM and runs the level's blocks back to back in one call. Here one C call
// runs the level too: it issues two launches per block (conv1; conv2 with
// the shortcut and the residual add), each conv's output going through L2
// (at most 0.5 MB a level).
//
// What bounds it: the four C<=32 levels of the main path (enc0 1->16 and
// dec4 32->16 at 64x128, enc1 16->32 and dec3 64->32 at 32x64) do 1.25 GFLOP
// together against ~4 MB of activations and weights per step: bound by
// arithmetic. In float32 the kernel runs each product as three TF32 tensor
// core products (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, with hi the
// value rounded to TF32 and lo the rest, float32 accumulation), which keeps
// float32's accuracy; its bound is 495 / 3 = 165 TFLOP/s, 0.0076 ms a step.
// In bfloat16 one bf16 product, with float32 accumulation.
//
// Design: each conv is an implicit GEMM, M = output pixels, N = C, K = 9
// Cin, on mma.sync.m16n8k8. A block owns a tile of 32/C rows x 16 columns
// of output pixels and all C channels: four warps, each one row of 16
// pixels and 8 channels (one n8 tile), so the grid has 256 blocks at the
// 64x128 levels and 128 at the 32x64 ones. At that size a warp's chain of
// dependent K steps sets the time, not the tensor cores' rate, so each
// conv's K is split three ways by the taps' row over three such groups of
// four warps (384 threads), and the sums meet in shared memory. The block
// stages its input tile with a 1-pixel halo into shared memory once (zeros
// outside the image), already split into TF32 hi and lo; a table of K
// offsets turns each k into a tap and a channel, so any Cin (1, 3, 16, 32,
// 64) runs the same loop, each slab's K padded to a multiple of 8 with zero
// weights. Pixel rows are padded to Cin + 4 floats, so a fragment's 8
// pixels x 4 channels hit 32 distinct banks. Weights are packed once per
// weight version on the host (ops/unet_block.py:pack_chain) in the exact
// order of the mma's B fragments, hi and lo side by side; each warp reads
// its fragments straight from L2 with one 16-byte load per lane, eight K
// steps ahead of their use (a ring in registers). No weight passes through
// shared memory: each fragment is used by one warp of the block (two at
// C=16), so staging it would buy little reuse and would cost barriers; the
// ring hides the same latency a cp.async ring in shared memory would.

#include "mma.cuh"

namespace {

constexpr int WARPS = 4;                 // warps of one tap-row group
constexpr int NTHREADS = 3 * WARPS * 32;  // three tap-row groups
constexpr int TW = 16;        // tile width, pixels
constexpr int XW = TW + 2;    // tile width with the halo
constexpr int MAX_CIN = 64;

// shared-memory row stride of a pixel with cin channels, in floats
__host__ __device__ constexpr int pixel_stride(int cin) { return cin % 8 == 0 ? cin + 4 : cin; }
__host__ __device__ constexpr int pad8(int k) { return (k + 7) / 8 * 8; }

// output rows a block's tile spans: each warp of a tap-row group owns one
// row of 16 pixels and one n8 tile
template <int C>
__host__ __device__ constexpr int tile_rows() { return WARPS / (C / 8); }

// shared memory of one launch, in 4-byte words
template <typename T, int C>
constexpr size_t smem_words(int cin, int sc_cin) {
  constexpr int TH = tile_rows<C>();
  return (size_t)pad8(3 * cin) + pad8(sc_cin) + 3 * WARPS * 32 * 4 +
         (size_t)Prec<T>::PLANES * ((TH + 2) * XW * pixel_stride(cin) + TH * TW * pixel_stride(sc_cin));
}

// Stage one activation v at offset o of the planes: TF32 hi and lo in
// float32, the value in bfloat16.
template <typename T>
__device__ __forceinline__ void put(float* hi, float* lo, int o, float v) {
  if constexpr (Prec<T>::PLANES == 2) {
    const float h = __uint_as_float(tf32(v));
    hi[o] = h;
    lo[o] = __uint_as_float(tf32(v - h));
  } else {
    hi[o] = v;
  }
}

// Stage rows x COLS pixels of src (cin channels) whose top-left is image
// pixel (h0, w0) into hi (and lo) planes, zeros outside the image. Each
// thread has BATCH loads in flight before it writes any, so the block waits
// on device memory a few times, not once per element it stages; its
// (pixel, channel) pairs advance by additions, since a division by a
// runtime cin costs a few dozen instructions an element.
template <typename T, int COLS>
__device__ __forceinline__ void stage(float* hi, float* lo, const T* src, int cin, int rows, int h0, int w0,
                                      int H, int W) {
  constexpr int BATCH = 8;
  const int stride = pixel_stride(cin), npix = rows * COLS;
  const int dp = NTHREADS / cin, dc = NTHREADS - dp * cin;
  int p = threadIdx.x / cin, c = threadIdx.x - p * cin;
  while (p < npix) {
    int pu[BATCH], cu[BATCH];
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      pu[u] = p;
      cu[u] = c;
      const int gh = h0 + p / COLS, gw = w0 + p % COLS;
      v[u] = (p < npix && gh >= 0 && gh < H && gw >= 0 && gw < W) ? load(src, ((size_t)gh * W + gw) * cin + c)
                                                                   : 0.f;
      p += dp;
      c += dc;
      if (c >= cin) {
        c -= cin;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (pu[u] >= npix) break;
      put<T>(hi, lo, pu[u] * stride + cu[u], v[u]);
    }
  }
}

// acc += A B over kp/8 K steps: A's rows g and g + 8 start at a0 and a1 in
// the planes, column k at koff[k]; B's fragments for this warp's n8 tile at
// wf, one K step every nt8 * 32 entries. The fragments come from L2 through
// a ring of RING registers, loaded RING K steps before their use, so a K
// step does not wait on an L2 round trip.
template <typename T>
__device__ __forceinline__ void gemm(float (&acc)[4], const float* hi, const float* lo, int a0, int a1,
                                     const int* koff, int kp, const typename Prec<T>::Frag* __restrict__ wf,
                                     int nt8) {
  using Frag = typename Prec<T>::Frag;
  constexpr int RING = 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int step = nt8 * 32, nk = kp / 8;
  Frag ring[RING];
#pragma unroll
  for (int d = 0; d < RING; ++d) ring[d] = d < nk ? __ldg(wf + d * step + lane) : Frag{};
  float small[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < nk; k0 += RING) {
#pragma unroll
    for (int d = 0; d < RING; ++d) {
      const int kb = k0 + d;
      if (kb >= nk) break;
      const Frag b = ring[d];
      if (kb + RING < nk) ring[d] = __ldg(wf + (kb + RING) * step + lane);
      mma_step<T>(acc, small, hi, lo, a0, a1, koff[kb * 8 + a_col<T>(t, 0)], koff[kb * 8 + a_col<T>(t, 1)], b);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += small[i];
}

// One 3x3 conv of the chain, bias and ReLU fused:
//   sc_in == null:               out = relu(conv(in) + bias)
//   sc_in != null, wsc == null:  out = relu(conv(in) + bias) + sc_in          (cin == C)
//   wsc != null:                 out = relu(conv(in) + bias) + Wsc^T sc_in + bsc
// The conv's K is split three ways by the taps' row: warp group s (4 warps)
// sums the taps (s, 0..2), K = 3 cin padded to a multiple of 8, so each
// warp's chain of dependent K steps is a third as long; group 2 also runs
// the 1x1 shortcut. Groups 1 and 2 leave their sums in shared memory and
// group 0 adds them, in that order, and writes the output.
// At C = 16 the 64x128 levels have 256 blocks: registers are capped so that
// two fit on an SM and the grid runs in one wave (80 a thread; the C = 32
// grids have 128 blocks and keep what the compiler chooses).
template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS, C == 16 ? 2 : 1)
conv3x3_kernel(const T* __restrict__ in, int cin, const typename Prec<T>::Frag* __restrict__ wf,
               const float* __restrict__ bias, T* __restrict__ out, const T* __restrict__ sc_in, int sc_cin,
               const typename Prec<T>::Frag* __restrict__ wsc, const float* __restrict__ bsc, int H, int W) {
  constexpr int TH = tile_rows<C>();
  constexpr int NT8 = C / 8;
  extern __shared__ float4 smem4[];
  const int kp = pad8(3 * cin), kps = wsc != nullptr ? pad8(sc_cin) : 0;
  const int stride = pixel_stride(cin), sstride = pixel_stride(sc_cin);
  float4* red = smem4;  // [3][WARPS][32]: groups 1 and 2's conv sums, group 2's shortcut
  int* koff = reinterpret_cast<int*>(red + 3 * WARPS * 32);
  int* koffs = koff + kp;
  float* hi = reinterpret_cast<float*>(koffs + kps);
  float* lo = hi + (TH + 2) * XW * stride;
  float* xhi = hi + Prec<T>::PLANES * (TH + 2) * XW * stride;
  float* xlo = xhi + TH * TW * sstride;

  const int b = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  for (int k = threadIdx.x; k < kp; k += NTHREADS) {  // tap (s, k / cin) of group s, channel k % cin
    const int dw = k / cin, ci = k - dw * cin;
    koff[k] = k < 3 * cin ? dw * stride + ci : 0;
  }
  for (int k = threadIdx.x; k < kps; k += NTHREADS) koffs[k] = k < sc_cin ? k : 0;
  stage<T, XW>(hi, lo, in + (size_t)b * H * W * cin, cin, TH + 2, h0 - 1, w0 - 1, H, W);
  if (wsc != nullptr) stage<T, TW>(xhi, xlo, sc_in + (size_t)b * H * W * sc_cin, sc_cin, TH, h0, w0, H, W);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s = warp / WARPS, w = warp % WARPS, wm = w / NT8, wn = w % NT8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  gemm<T>(acc, hi, lo, ((wm + s) * XW + g) * stride, ((wm + s) * XW + g + 8) * stride, koff, kp,
          wf + (size_t)s * (kp / 8) * NT8 * 32 + wn * 32, NT8);
  if (s > 0) red[((s - 1) * WARPS + w) * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (s == 2 && wsc != nullptr) {
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    gemm<T>(sc, xhi, xlo, (wm * TW + g) * sstride, (wm * TW + g + 8) * sstride, koffs, kps, wsc + wn * 32, NT8);
    red[(2 * WARPS + w) * 32 + lane] = make_float4(sc[0], sc[1], sc[2], sc[3]);
  }
  __syncthreads();

  const int oh = h0 + wm, n = wn * 8 + 2 * t;
  if (s != 0 || oh >= H) return;
  const float4 r1 = red[w * 32 + lane], r2 = red[(WARPS + w) * 32 + lane];
  acc[0] += r1.x + r2.x;
  acc[1] += r1.y + r2.y;
  acc[2] += r1.z + r2.z;
  acc[3] += r1.w + r2.w;
  const float4 rs = red[(2 * WARPS + w) * 32 + lane];
  const float sc[4] = {rs.x, rs.y, rs.z, rs.w};
  const float bb0 = __ldg(bias + n), bb1 = __ldg(bias + n + 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ow = w0 + g + 8 * half;
    if (ow >= W) continue;
    const size_t o = (((size_t)b * H + oh) * W + ow) * C + n;
    float v0 = fmaxf(acc[2 * half] + bb0, 0.f), v1 = fmaxf(acc[2 * half + 1] + bb1, 0.f);
    if (wsc != nullptr) {
      v0 += sc[2 * half] + __ldg(bsc + n);
      v1 += sc[2 * half + 1] + __ldg(bsc + n + 1);
    } else if (sc_in != nullptr) {
      v0 += load(sc_in, o);
      v1 += load(sc_in, o + 1);
    }
    store2(out, o, v0, v1);
  }
}

template <typename T, int C>
cudaError_t conv(const T* in, int cin, const void* wf, const float* bias, T* out, const T* sc_in, int sc_cin,
                 const void* wsc, const float* bsc, int B, int H, int W, cudaStream_t stream) {
  using Frag = typename Prec<T>::Frag;
  constexpr int TH = tile_rows<C>();
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const size_t smem = smem_words<T, C>(cin, wsc != nullptr ? sc_cin : 0) * 4;
  conv3x3_kernel<T, C><<<grid, NTHREADS, smem, stream>>>(in, cin, static_cast<const Frag*>(wf), bias, out, sc_in,
                                                          sc_cin, static_cast<const Frag*>(wsc), bsc, H, W);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t chain(const T* x, T* out, T* scratch, const void* const* params, int n_blocks, int B, int H, int W,
                  int cin, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_words<T, C>(MAX_CIN, MAX_CIN) * 4));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t act = (size_t)B * H * W * C;
  T* y1 = scratch;
  T* ping[2] = {scratch + act, scratch + 2 * act};
  const T* src = x;
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* p = params + 6 * i;
    T* dst = i + 1 == n_blocks ? out : ping[i % 2];
    cudaError_t e = conv<T, C>(src, cin, p[0], static_cast<const float*>(p[1]), y1, nullptr, 0, nullptr,
                               nullptr, B, H, W, stream);
    if (e != cudaSuccess) return e;
    e = conv<T, C>(y1, C, p[2], static_cast<const float*>(p[3]), dst, src, cin, p[4],
                   static_cast<const float*>(p[5]), B, H, W, stream);
    if (e != cudaSuccess) return e;
    src = dst;
    cin = C;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t chain_c(int C, const void* x, void* out, void* scratch, const void* const* params, int n_blocks, int B,
                    int H, int W, int cin, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  T* st = static_cast<T*>(scratch);
  switch (C) {
    case 16: return chain<T, 16>(xt, ot, st, params, n_blocks, B, H, W, cin, s);
    case 32: return chain<T, 32>(xt, ot, st, params, n_blocks, B, H, W, cin, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// A whole level: x [B, H, W, cin] -> out [B, H, W, C] in the activation type
// (dtype 0 float32, 1 bfloat16); scratch: 3 B H W C elements of it. params:
// 6 pointers per block, (W1, b1, W2, b2, Wsc, bsc), the weights packed by
// ops/unet_block.py:pack_chain into mma fragments (float32 hi/lo for dtype
// 0, bf16 for dtype 1), the biases float32, Wsc and bsc null for an
// identity shortcut. Launches two kernels per block on `stream`. Returns a
// CUDA error code (0 on success).
extern "C" int rvc_conv_block_res_chain(const void* x, void* out, void* scratch, const void* const* params,
                                        int n_blocks, int B, int H, int W, int cin, int C, int dtype,
                                        void* stream) {
  if (n_blocks < 1 || B < 1 || H < 1 || W < 1 || cin < 1 || cin > MAX_CIN) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_blocks; ++i)
    if (params[6 * i + 4] == nullptr && (i == 0 ? cin : C) != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0   ? chain_c<float>(C, x, out, scratch, params, n_blocks, B, H, W, cin, s)
                  : dtype == 1 ? chain_c<__nv_bfloat16>(C, x, out, scratch, params, n_blocks, B, H, W, cin, s)
                               : cudaErrorInvalidValue;
  return (int)e;
}
