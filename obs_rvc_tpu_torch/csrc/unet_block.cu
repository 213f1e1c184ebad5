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
// runs the level too: it issues two launches per block (conv1, with the
// 1x1 shortcut where the block has one; conv2 with the residual add), each
// conv's output going through L2.
//
// What bounds it: the four C<=32 levels of the main path (enc0 1->16 and
// dec4 32->16 at 64x128, enc1 16->32 and dec3 64->32 at 32x64) do 1.25 GFLOP
// a stream against ~4 MB of activations and weights: bound by arithmetic.
// In float32 the kernel runs each product as three TF32 tensor core
// products (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, hi the value cut to
// TF32 and lo the rest, float32 accumulation), which keeps float32's
// accuracy; its bound is 495 / 3 = 165 TFLOP/s. In bfloat16 one bf16
// product, with float32 accumulation. A conv at these widths is short work
// (at 8 streams 0.3 GFLOP, 2-4 MB), so what sets its time is latency: the
// launch, a block's loads, its chain of K steps.
//
// Design: each conv is an implicit GEMM, M = output pixels, N = C, K = 9
// Cin, on mma.sync: m16n8k16 in bf16, m16n8k8 in TF32, so a K step is 32
// bytes of one tap's channels either way (Cin padded with zeros to a
// multiple of 16 or 8). A block computes a tile of TH rows x TW columns of
// output pixels and all C channels; each warp owns WM m16 tiles (16 pixels
// of one row each) and all C/8 n8 tiles, so each B fragment feeds WM mma and
// each A fragment C/8 (register blocking, no split K). The wrapper chooses
// (TH, TW, WM) from the batch and the level's size
// (ops/unet_block.py:chain_tiling) and hands it over: 64-pixel tiles of 4
// warps for one stream, 128-pixel tiles of 8 warps from 8 streams, of 4
// warps with two m16 tiles each from 64. A block stages the conv's weights
// into shared memory (cp.async), in the order of the B fragments
// (ops/unet_block.py:pack_chain), so every warp reads them from there, and
// its input tile with a 1-pixel halo in the activation's own dtype, zeros
// outside the image: cp.async for rows of 16-byte multiples, plain stores
// for an odd Cin such as 1. A fragments come by ldmatrix from pixel rows
// padded by 16 bytes, so a fragment's 8 rows hit 32 distinct banks. conv1
// also computes the 1x1 shortcut from the centre of the same tile and
// writes it where conv2's output goes; conv2 adds it (or the block's input)
// in its epilogue, so no launch stages a second tile.
//
// One block a tile, several on an SM, so one block's loads overlap
// another's products; and each conv is launched as a programmatic dependent
// of the one before (cudaLaunchAttributeProgrammaticStreamSerialization,
// griddepcontrol): its blocks start and load their weights while that one
// finishes, and wait for it before they read an activation. Blocks that
// stay resident over several tiles (persistent, the next tile's input
// loading while one computes) measured no faster on the card at 1 to 64
// streams (PERF.md, section 6). mma.sync, not wgmma: wgmma's 64-row tiles and
// swizzled shared-memory operands buy the tensor cores' full rate, and these
// convs run at a few percent of it, held by latency.

#include "mma.cuh"

namespace {

constexpr int MAX_CIN = 64;
constexpr int MAX_WARPS = 8;
constexpr int SMEM_CAP = 232448;  // what a block may use on Hopper
constexpr int FRAG_STEP_BYTES = 32 * 8;  // one K step's B fragments of one n8 tile: 32 lanes x 8 bytes

__host__ __device__ constexpr int cin_pad(int cin, int ks) { return (cin + ks - 1) / ks * ks; }
// a staged pixel's bytes: its channels padded to the K step, and 16 more so
// the 8 rows of an ldmatrix matrix fall in distinct banks
__host__ __device__ constexpr int pixel_bytes(int cinp, int elem) { return cinp * elem + 16; }

// shared memory of one conv launch: the weights (and the shortcut's), the
// input tile with its halo
__host__ size_t conv_smem(int ks, int elem, int C, int cin, bool shortcut, int th, int tw) {
  const int kc = cin_pad(cin, ks) / ks, nt = C / 8;
  const size_t w = (size_t)(shortcut ? 10 : 9) * kc * nt * FRAG_STEP_BYTES;
  return w + (size_t)(th + 2) * (tw + 2) * pixel_bytes(cin_pad(cin, ks), elem);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// acc[j][n] += the taps tap0 .. tap0 + ntaps - 1 of the conv on the staged
// tile buf, for this warp's m16 tiles j (the lane's ldmatrix row at tap
// (0, 0) in arow[j]) and every n8 tile n; w: the taps' B fragments in shared
// memory, kc K steps a tap. The conv runs the nine taps; the shortcut the
// centre tap alone, with its own weights.
template <typename T, int C, int WM>
__device__ __forceinline__ void conv_gemm(float (&acc)[WM][C / 8][4], const unsigned char* buf,
                                          const int (&arow)[WM], const typename Step<T>::Frag* w, int tap0,
                                          int ntaps, int kc, int xw, int pbytes) {
  constexpr int NT = C / 8;
  const int lane = threadIdx.x & 31;
  for (int tp = 0; tp < ntaps; ++tp) {
    const int tap = tap0 + tp;
    mma_tap<T, NT, WM>(acc, buf + ((tap / 3) * xw + tap % 3) * pbytes, arow, w + tp * kc * NT * 32 + lane, kc);
  }
}

// One 3x3 conv of the chain, one TH x TW tile of output pixels a block (its
// warps WM m16 tiles each), bias and ReLU fused:
//   out = relu(conv(in) + bias) (+ res, where res is not null)
// and, where wsc is not null, sc_out = Wsc^T in + bsc at the same pixels
// (the block's 1x1 shortcut, from the centre of the staged tile). res may be
// out itself: each element is read by the thread that then writes it. The
// input rows are 16-byte aligned multiples where vec is set, and go by
// cp.async.
template <typename T, int C, int WM>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
conv3x3_kernel(const T* __restrict__ in, int cin, int vec, const typename Step<T>::Frag* __restrict__ wf,
               const float* __restrict__ bias, const typename Step<T>::Frag* __restrict__ wsc,
               const float* __restrict__ bsc, T* sc_out, const T* res, T* out, int H, int W, int TH, int TW) {
  using Frag = typename Step<T>::Frag;
  constexpr int KS = Step<T>::K, NT = C / 8, ELEM = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cinp = cin_pad(cin, KS), kc = cinp / KS;
  const int nw = 9 * kc * NT * 32, nsc = wsc != nullptr ? kc * NT * 32 : 0;  // fragments
  Frag* wsm = reinterpret_cast<Frag*>(smem);
  Frag* scsm = wsm + nw;
  unsigned char* tile = reinterpret_cast<unsigned char*>(scsm + nsc);
  const int xw = TW + 2, pbytes = pixel_bytes(cinp, ELEM), npix = (TH + 2) * xw;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int tx = blockIdx.x % tiles_w, ty = blockIdx.x / tiles_w % tiles_h, b = blockIdx.x / (tiles_w * tiles_h);

  // the weights
  const int4* w4 = reinterpret_cast<const int4*>(wf);
  int4* s4 = reinterpret_cast<int4*>(wsm);
  for (int i = threadIdx.x; i < nw * (int)sizeof(Frag) / 16; i += blockDim.x) cp_async16(s4 + i, w4 + i, 16);
  w4 = reinterpret_cast<const int4*>(wsc);
  s4 = reinterpret_cast<int4*>(scsm);
  for (int i = threadIdx.x; i < nsc * (int)sizeof(Frag) / 16; i += blockDim.x) cp_async16(s4 + i, w4 + i, 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float bb[NT][2], bs[NT][2];  // the biases of the lane's two channels of each n8 tile
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    bb[n][0] = __ldg(bias + n * 8 + 2 * t);
    bb[n][1] = __ldg(bias + n * 8 + 2 * t + 1);
    bs[n][0] = wsc != nullptr ? __ldg(bsc + n * 8 + 2 * t) : 0.f;
    bs[n][1] = wsc != nullptr ? __ldg(bsc + n * 8 + 2 * t + 1) : 0.f;
  }
  int arow[WM], orow[WM], ocol[WM];
#pragma unroll
  for (int j = 0; j < WM; ++j) {
    const int p = (warp * WM + j) * 16;
    orow[j] = p / TW;
    ocol[j] = p % TW;
    arow[j] = (orow[j] * xw + ocol[j] + (lane & 15)) * pbytes + (lane >> 4) * 16;
  }
  // Launched as a programmatic dependent of the stream's kernel before it (conv()), the launch and the
  // weights' loads above overlap that kernel; everything it writes is read, and everything this one
  // writes is written, after this wait. Then the next conv may launch.
  grid_dependency_wait();
  grid_dependents_launch();

  // the input tile with its halo
  const int h0 = ty * TH - 1, w0 = tx * TW - 1;
  const T* src = in + (size_t)b * H * W * cin;
  if (vec) {
    const int cpp = cinp * ELEM / 16, gcpp = cin * ELEM / 16;  // 16-byte chunks of a pixel: staged, in memory
    for (int i = threadIdx.x; i < npix * cpp; i += blockDim.x) {
      const int p = i / cpp, q = i - p * cpp, r = p / xw;
      const int gh = h0 + r, gw = w0 + p - r * xw;
      const bool inside = q < gcpp && gh >= 0 && gh < H && gw >= 0 && gw < W;
      cp_async16(tile + p * pbytes + q * 16, inside ? src + ((size_t)gh * W + gw) * cin + q * (16 / ELEM) : src,
                 inside ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < npix * cinp; i += blockDim.x) {
      const int p = i / cinp, c = i - p * cinp, r = p / xw;
      const int gh = h0 + r, gw = w0 + p - r * xw;
      const bool inside = c < cin && gh >= 0 && gh < H && gw >= 0 && gw < W;
      reinterpret_cast<T*>(tile + p * pbytes)[c] = inside ? src[((size_t)gh * W + gw) * cin + c] : zero<T>();
    }
  }
  cp_async_commit();

  // the epilogue: dst[pixel, channel] = f(acc + bias) at this warp's pixels inside the image
  auto emit = [&](float(&acc)[WM][NT][4], const float(&bv)[NT][2], T* dst, bool conv) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = bv[n][0], b1 = bv[n][1];
#pragma unroll
      for (int j = 0; j < WM; ++j) {
        const int oh = ty * TH + orow[j];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ow = tx * TW + ocol[j] + g + 8 * half;
          if (oh >= H || ow >= W) continue;
          const size_t o = (((size_t)b * H + oh) * W + ow) * C + n * 8 + 2 * t;
          float v0 = acc[j][n][2 * half] + b0, v1 = acc[j][n][2 * half + 1] + b1;
          if (conv) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            if (res != nullptr) {
              float r0, r1;
              load2(res, o, r0, r1);
              v0 += r0;
              v1 += r1;
            }
          }
          store2(dst, o, v0, v1);
        }
      }
    }
  };
  cp_async_wait<0>();
  __syncthreads();

  float acc[WM][NT][4];
  if (wsc != nullptr) {
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;
    conv_gemm<T, C, WM>(acc, tile, arow, scsm, 4, 1, kc, xw, pbytes);
    emit(acc, bs, sc_out, false);
  }
#pragma unroll
  for (int j = 0; j < WM; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;
  conv_gemm<T, C, WM>(acc, tile, arow, wsm, 0, 9, kc, xw, pbytes);
  emit(acc, bb, out, true);
}

struct Tiling {
  int th, tw, wm;
  int warps() const { return th * tw / (16 * wm); }
};

template <typename T, int C, int WM>
cudaError_t set_smem_cap() {
  static bool done[MAX_DEVICES] = {};
  return smem_cap_once((const void*)conv3x3_kernel<T, C, WM>, done, SMEM_CAP);
}

template <typename T, int C, int WM>
cudaError_t conv(const T* in, int cin, const void* wf, const float* bias, const void* wsc, const float* bsc,
                 T* sc_out, const T* res, T* out, int B, int H, int W, const Tiling& tl, cudaStream_t stream) {
  using Frag = typename Step<T>::Frag;
  const size_t smem = conv_smem(Step<T>::K, sizeof(T), C, cin, wsc != nullptr, tl.th, tl.tw);
  if (smem > (size_t)SMEM_CAP) return cudaErrorInvalidValue;
  const int vec = (cin * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((H + tl.th - 1) / tl.th) * ((W + tl.tw - 1) / tl.tw));
  cfg.blockDim = dim3(tl.warps() * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_kernel<T, C, WM>, in, cin, vec, static_cast<const Frag*>(wf), bias,
                            static_cast<const Frag*>(wsc), bsc, sc_out, res, out, H, W, tl.th, tl.tw);
}

template <typename T, int C, int WM>
cudaError_t chain(const T* x, T* out, T* scratch, const void* const* params, int n_blocks, int B, int H, int W,
                  int cin, const Tiling& tl, cudaStream_t stream) {
  cudaError_t e = set_smem_cap<T, C, WM>();
  if (e != cudaSuccess) return e;
  const size_t act = (size_t)B * H * W * C;
  T* y1 = scratch;
  T* ping[2] = {scratch + act, scratch + 2 * act};
  const T* src = x;
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* p = params + 6 * i;
    T* dst = i + 1 == n_blocks ? out : ping[i % 2];
    const bool sc = p[4] != nullptr;
    e = conv<T, C, WM>(src, cin, p[0], static_cast<const float*>(p[1]), p[4], static_cast<const float*>(p[5]),
                       sc ? dst : nullptr, nullptr, y1, B, H, W, tl, stream);
    if (e != cudaSuccess) return e;
    e = conv<T, C, WM>(y1, C, p[2], static_cast<const float*>(p[3]), nullptr, nullptr, nullptr, sc ? dst : src, dst,
                       B, H, W, tl, stream);
    if (e != cudaSuccess) return e;
    src = dst;
    cin = C;
  }
  return cudaSuccess;
}

// the kernel of (dtype, C, WM) as a pointer, for the occupancy queries
template <typename T>
const void* kernel_of(int C, int wm) {
  switch (C * 10 + wm) {
    case 161: return (const void*)conv3x3_kernel<T, 16, 1>;
    case 162: return (const void*)conv3x3_kernel<T, 16, 2>;
    case 321: return (const void*)conv3x3_kernel<T, 32, 1>;
    case 322: return (const void*)conv3x3_kernel<T, 32, 2>;
    default: return nullptr;
  }
}

template <typename T>
cudaError_t chain_c(int C, const void* x, void* out, void* scratch, const void* const* params, int n_blocks, int B,
                    int H, int W, int cin, const Tiling& tl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  T* st = static_cast<T*>(scratch);
  switch (C * 10 + tl.wm) {
    case 161: return chain<T, 16, 1>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
    case 162: return chain<T, 16, 2>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
    case 321: return chain<T, 32, 1>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
    case 322: return chain<T, 32, 2>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_tiling(const Tiling& tl) {
  return tl.th >= 1 && tl.tw >= 16 && tl.tw % 16 == 0 && (tl.wm == 1 || tl.wm == 2) &&
         (tl.th * tl.tw) % (16 * tl.wm) == 0 && tl.warps() >= 1 && tl.warps() <= MAX_WARPS;
}

// the largest shared memory a launch of the level takes: conv1 (Cin, with the
// shortcut) or conv2 (C)
size_t level_smem(int dtype, int C, int cin, const Tiling& tl) {
  const int ks = dtype == 0 ? 8 : 16, elem = dtype == 0 ? 4 : 2;
  const size_t a = conv_smem(ks, elem, C, cin, true, tl.th, tl.tw), b = conv_smem(ks, elem, C, C, false, tl.th, tl.tw);
  return a > b ? a : b;
}

}  // namespace

// A whole level: x [B, H, W, cin] -> out [B, H, W, C] in the activation type
// (dtype 0 float32, 1 bfloat16); scratch: 3 B H W C elements of it. params:
// 6 pointers per block, (W1, b1, W2, b2, Wsc, bsc), the weights packed by
// ops/unet_block.py:pack_chain into mma fragments (float32 for dtype 0, bf16
// for dtype 1), the biases float32, Wsc and bsc null for an identity
// shortcut. The tiling: th x tw output pixels a block (tw a multiple of 16),
// wm m16 tiles a warp. Launches two kernels per block of the chain on
// `stream`, each a programmatic dependent of the kernel before it, on the
// calling thread's current device, which must be `stream`'s. Returns a CUDA
// error code (0 on success).
extern "C" int rvc_conv_block_res_chain(const void* x, void* out, void* scratch, const void* const* params,
                                        int n_blocks, int B, int H, int W, int cin, int C, int dtype, int th, int tw,
                                        int wm, void* stream) {
  const Tiling tl{th, tw, wm};
  if (n_blocks < 1 || B < 1 || H < 1 || W < 1 || cin < 1 || cin > MAX_CIN || !valid_tiling(tl))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_blocks; ++i)
    if (params[6 * i + 4] == nullptr && (i == 0 ? cin : C) != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0   ? chain_c<float>(C, x, out, scratch, params, n_blocks, B, H, W, cin, tl, s)
                  : dtype == 1 ? chain_c<__nv_bfloat16>(C, x, out, scratch, params, n_blocks, B, H, W, cin, tl, s)
                               : cudaErrorInvalidValue;
  return (int)e;
}

// A level's launch on this card: out = (threads, shared memory bytes of its
// largest launch, registers a thread, blocks an SM holds at that shared
// memory). Returns a CUDA error code.
extern "C" int rvc_chain_launch_info(int C, int dtype, int cin, int th, int tw, int wm, int* out) {
  const Tiling tl{th, tw, wm};
  if ((dtype != 0 && dtype != 1) || cin < 1 || cin > MAX_CIN || !valid_tiling(tl)) return (int)cudaErrorInvalidValue;
  const void* k = dtype == 0 ? kernel_of<float>(C, wm) : kernel_of<__nv_bfloat16>(C, wm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = level_smem(dtype, C, cin, tl);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, tl.warps() * 32, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = tl.warps() * 32;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = blocks;
  return 0;
}
