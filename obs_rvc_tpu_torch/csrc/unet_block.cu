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
// Three kernels. The resident kernel (conv3x3_kernel) takes C in {8, 16, 32}
// and any Cin from 1 to 64 (the decoder's 2C concat included); the wrapper
// runs any other C up to 32 on the next of them, its weights zero-padded
// (ops/unet_block.py). It stages a conv's whole weight in shared memory,
// which past C=32 does not fit: decoder level 0's first conv is 9 x 512 x
// 256 weights, 2.36 MB in bf16 against a block's 227 KB. The two ring
// kernels (ring_conv3x3_kernel, ring_batch_kernel, below) take every level
// past it, C up to 256 and Cin up to 512 (the widest levels any
// pallas_unet_max_ch routes), C padded to a multiple of 32 and Cin to one
// stage's slab: they stream the weights through shared memory and tile C
// across warps and blocks; the batch kernel takes several streams' pixels a
// block, on wgmma in bfloat16.
//
// What bounds the resident kernel: the four C<=32 levels of the main path (enc0 1->16 and
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

#include <type_traits>

namespace {

constexpr int MAX_CIN = 64;  // the resident kernel's
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
    case 81: return (const void*)conv3x3_kernel<T, 8, 1>;
    case 82: return (const void*)conv3x3_kernel<T, 8, 2>;
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
    case 81: return chain<T, 8, 1>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
    case 82: return chain<T, 8, 2>(xt, ot, st, params, n_blocks, B, H, W, cin, tl, s);
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

// ---------------------------------------------------------------------------
// The ring kernels: the levels past the resident kernel (C > 32 or Cin > 64)
// ---------------------------------------------------------------------------
//
// What bounds them: the six wider levels of the full RMVPE (enc2 32->64 and
// dec2 128->64 at 16x32, enc3 64->128 and dec1 256->128 at 8x16, enc4
// 128->256 and dec0 512->256 at 4x8) do 1.90 GFLOP a stream against 26 MB of
// bf16 weights (52 MB in float32): at one stream bound by streaming the
// weights (7.8 us in bf16), from 8 streams by arithmetic (0.123 ms at 64
// streams in bf16). Few pixels, many channels: enc4 and dec0 have 32 output
// pixels a stream. What the card spends past that is the trips through L2:
// a block brings its channel tile's weights into shared memory once for its
// pixels, so a block that serves one stream's 32 pixels re-reads every
// weight once per stream (0.57-0.70 GB through L2 for enc4 or dec0 at 64
// streams against 2.4-3.0 MB of weights).
//
// Design: an implicit GEMM (M = output pixels, N = C, K = 9 Cin), tiled
// three ways:
// - M: a block takes TH x TW output pixels of one stream (ring_conv3x3_kernel,
//   the one-stream kernel), or of each of S streams at the same place in
//   their maps (ring_batch_kernel), so a weight byte brought into shared
//   memory serves S streams' pixels: enc4 and dec0 from 60 streams, whole
//   4 x 8 maps of 2 streams a block. Each stream's tile is staged with
//   its own one-pixel halo, zeros at its own edges (a pixel never reads a
//   neighbouring stream's), and a last tile of fewer than S streams computes
//   only its streams. An m16 tile is 16 consecutive pixels of the block's
//   tile(s), each lane giving ldmatrix its own pixel's address, so one may
//   span rows and streams.
// - N: a block takes NW groups of 32 output channels (blockIdx.y), so a warp
//   keeps WM x 4 n8 tiles of accumulators (16 or 32 floats, twice that with
//   the shortcut's) whatever C is.
// - K: a stage is one slab of 64 bytes of every input pixel's channels (32
//   bf16 or 16 float32: two K steps) over the tile's halos, with its 9 taps'
//   weights for the block's groups (ops/_mma.py:pack_ring packs each group
//   and slab contiguously). Stages stream through a ring of RING_STAGES
//   slots in shared memory, the next stages loading while the warps multiply
//   the current one; the first stages' weights load before the programmatic
//   wait, while the kernel before still runs. On the one-stream kernel KW
//   warps along K share each stage's 9 taps and hand their sums to the
//   first in shared memory, added in a fixed order.
// Where the output tiles are few (one stream's levels) or the convs long,
// the K stages also split across blockIdx.z: each block writes its partial
// sums to a scratch the wrapper allocates, and the last block of a tile to
// arrive (an integer counter, no float atomics) sums the partials in split
// order and runs the epilogue, so the result is the same bit for bit on
// every run.
//
// The one-stream kernel runs mma.sync with B fragments
// packed in their lanes' order, its stages loaded by cp.async, two block
// barriers a stage. The batch kernel loads a group's weights of a stage with
// one bulk asynchronous copy (cp.async.bulk onto the slot's mbarrier, issued
// by one thread) and the halos by cp.async, with one block barrier a stage;
// in bfloat16 it runs wgmma: four warps take a group's m64 x n32 tile
// together, A (the staged pixels, whose 3x3 taps are shifted windows of the
// halos: no layout wgmma reads from shared memory) in registers by ldmatrix
// as for mma.sync, B (the weights) from shared memory in wgmma's K-major
// canonical layout without swizzle (8 x 16-byte core matrices, each 128
// contiguous bytes, so a core matrix's rows fall in distinct banks), as
// ops/_mma.py:pack_ring_wgmma writes it; a stage's products are one wgmma
// group, waited for at the next stage's barrier, so they run while the
// warps wait for that stage's data. In float32 it runs mma.sync as the
// one-stream kernel does. It has one tile, the one the wrapper's rule
// picks: RING_BATCH_M output pixels (S streams' TH x TW) x RING_BATCH_NW
// groups, one warp (in bfloat16 one warpgroup) along K, its
// RING_BATCH_WARPS warps' launch bounds leaving the A fragments of 9 taps
// their registers (wider tiles and more warps along K measured no faster).
// The one-stream kernel stays for tiles of one stream: at one and 8
// streams it measured faster than the batch kernel on the same tiles
// (PERF.md, section 6). The wrapper chooses the kernel, the block shape,
// S, KW and the splits (ops/unet_block.py:chain_tiling).
// conv1 computes the 1x1 shortcut from the centre tap of the same stages;
// conv2 adds the residual in its epilogue, as in the resident kernel. In
// float32 (mma.sync, 3xTF32) its convs sum up to 4608 products an output, so
// both kernels keep two errors of the tensor cores short: the split rounds
// hi and lo to nearest (mma.cuh:tf32_split_rn), and each stage's sums start
// from zero in the tensor cores and are added to the conv's by the CUDA
// cores, since the tensor cores' fp32 accumulator is not rounded to nearest.
// Two launches a block of the chain, each a programmatic dependent of the
// one before.
constexpr int RING_GROUP = 32;                     // output channels of a weight group: one warp's N tile
constexpr int RING_NT = RING_GROUP / 8;            // its n8 tiles
constexpr int SLAB_BYTES = 64;                     // a stage's bytes of each pixel's channels
constexpr int RING_KC = SLAB_BYTES / 32;           // K steps of one tap in a stage
constexpr int RING_STAGES = 3;                     // slots of the ring
constexpr int RING_MAX_WARPS = 16;
constexpr int RING_BATCH_M = 64;                   // the batch kernel's tile: output pixels (S TH TW),
constexpr int RING_BATCH_NW = 2;                   // groups of 32 channels,
constexpr int RING_BATCH_WARPS = RING_BATCH_M / 16 * RING_BATCH_NW;  // and warps: an m16 tile a warp
constexpr int RING_PB = SLAB_BYTES + 16;           // a staged pixel's bytes, padded as pixel_bytes pads
constexpr int TAP_FRAGS = RING_KC * RING_NT * 32;  // B fragments of one tap of one group in a stage
constexpr int TAP_BYTES = TAP_FRAGS * 8;
constexpr int KSTEP_BYTES = TAP_BYTES / RING_KC;   // one K step of a tap: 4 n8 tiles x 2 core matrices (wgmma)
constexpr int RING_CTRL_BYTES = 32;                // after the ring: a slot's mbarrier each, the last-block flag
constexpr int RING_CHUNKS = 4;                     // halo chunks a thread keeps the addresses of (batch kernel)

// one slot of the ring: the block's groups' 9 taps (10 with the shortcut's)
// and the S halo tiles of one slab (S = 1 on the one-stream kernel)
__host__ __device__ constexpr size_t ring_stage_bytes(int nw, bool shortcut, int s, int th, int tw) {
  return (size_t)nw * (shortcut ? 10 : 9) * TAP_BYTES + (size_t)s * (th + 2) * (tw + 2) * RING_PB;
}
__host__ constexpr size_t ring_smem(int nw, bool shortcut, int s, int th, int tw) {
  return RING_STAGES * ring_stage_bytes(nw, shortcut, s, th, tw) + RING_CTRL_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// the one arrival of the barrier's phase, with the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory by the copy engine, counted on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma's descriptor of a K-major B operand without swizzle at shared
// address `addr`: core matrices of 8 rows (n) x 16 bytes (8 k), 128 bytes
// apart along K (the leading byte offset) and 256 along N (the stride byte
// offset), as pack_ring_wgmma lays out each K step of a tap
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}
// ldmatrix_x4 at a shared-memory address
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keeps the compiler from moving the accumulators' reads and writes across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[RING_NT][4]) {
#pragma unroll
  for (int n = 0; n < RING_NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}
// d += A B on the warpgroup's m64 x n32 x k16 tile: A this warp's 16 rows as
// ldmatrix_x4 gives them (mma.sync's A fragment), B at descriptor `desc`;
// d[n][i] is mma.sync's accumulator of n8 tile n
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[RING_NT][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <typename T>
struct RingConv {
  const T* in;        // [B, H, W, cin], cin a multiple of the slab
  const void* w;      // pack_ring'ed [C / 32][cin / slab][9 taps] (pack_ring_wgmma'ed on wgmma)
  const float* bias;  // [C]
  const void* wsc;    // the 1x1 shortcut, pack_ring'ed [C / 32][cin / slab][1 tap], or null
  const float* bsc;
  T* sc_out;          // the shortcut's output where wsc is set
  const T* res;       // added after the ReLU where set (may be out: read and written by one thread)
  T* out;
  float* partial;     // split K: the blocks' partial sums, splits x tiles x BM x BN (x 2 with the shortcut)
  int* counters;      // split K: one a tile, 0 on entry and on exit
  int B, cin, C, H, W, th, tw, s, splits;
  int kw;             // the one-stream kernel's warps along K: each takes 9 / kw of the taps of every stage
  // (B and s: the batch kernel's; the one-stream kernel takes a stream a block)
};

// The one-stream kernel: a stream's TH x TW pixels a block, mma.sync, WM m16 tiles a warp.
template <typename T, int NW, int WM>
__global__ void __launch_bounds__(RING_MAX_WARPS * 32)
ring_conv3x3_kernel(const RingConv<T> a) {
  using Frag = typename Step<T>::Frag;
  constexpr int ELEM = sizeof(T), SLAB = SLAB_BYTES / ELEM, NACC = WM * RING_NT * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool sc = a.wsc != nullptr;
  const int nthreads = blockDim.x, mw = a.th * a.tw / (16 * WM);
  const int nres = mw * NW * 32;  // the threads of the warps that hold the block's sums at the end (wk = 0)
  const int xw = a.tw + 2, npix = (a.th + 2) * xw;
  const int wbytes = NW * (sc ? 10 : 9) * TAP_BYTES;
  const size_t stage = ring_stage_bytes(NW, sc, 1, a.th, a.tw);
  const int tiles_w = (a.W + a.tw - 1) / a.tw, tiles_h = (a.H + a.th - 1) / a.th;
  const int tx = blockIdx.x % tiles_w, ty = blockIdx.x / tiles_w % tiles_h, b = blockIdx.x / (tiles_w * tiles_h);
  const int nst = a.cin / SLAB;  // the conv's K stages, of which this block takes [s0, s0 + ns)
  const int s0 = blockIdx.z * nst / a.splits, ns = (blockIdx.z + 1) * nst / a.splits - s0;
  const int g0 = blockIdx.y * NW;  // the block's first group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the warp's group, its place along M, and along K: its taps [tap0, tap1) of each stage
  const int wn = warp % NW, wmi = warp / NW % mw, wk = warp / (NW * mw);
  const int tap0 = wk * 9 / a.kw, tap1 = (wk + 1) * 9 / a.kw;
  const bool centre = sc && tap0 <= 4 && 4 < tap1;  // the warp that takes the shortcut, from the centre tap

  // stage k's weights (and the shortcut's) into slot k % RING_STAGES
  auto load_weights = [&](int k) {
    unsigned char* slot = smem + (k % RING_STAGES) * stage;
    const int s = s0 + k;
    for (int gl = 0; gl < NW; ++gl) {
      const int4* src = reinterpret_cast<const int4*>(static_cast<const Frag*>(a.w) +
                                                      ((size_t)(g0 + gl) * nst + s) * 9 * TAP_FRAGS);
      int4* dst = reinterpret_cast<int4*>(slot + gl * 9 * TAP_BYTES);
      for (int i = threadIdx.x; i < 9 * TAP_BYTES / 16; i += nthreads) cp_async16(dst + i, src + i, 16);
      if (sc) {
        src = reinterpret_cast<const int4*>(static_cast<const Frag*>(a.wsc) + ((size_t)(g0 + gl) * nst + s) * TAP_FRAGS);
        dst = reinterpret_cast<int4*>(slot + (NW * 9 + gl) * TAP_BYTES);
        for (int i = threadIdx.x; i < TAP_BYTES / 16; i += nthreads) cp_async16(dst + i, src + i, 16);
      }
    }
  };
  // stage k's slab of the input tile with its halo, zeros outside the image
  const int h0 = ty * a.th - 1, w0 = tx * a.tw - 1;
  const T* img = a.in + (size_t)b * a.H * a.W * a.cin;
  auto load_tile = [&](int k) {
    unsigned char* tile = smem + (k % RING_STAGES) * stage + wbytes;
    const int c0 = (s0 + k) * SLAB;
    for (int i = threadIdx.x; i < npix * (SLAB_BYTES / 16); i += nthreads) {
      const int p = i / (SLAB_BYTES / 16), q = i % (SLAB_BYTES / 16), r = p / xw;
      const int gh = h0 + r, gw = w0 + p - r * xw;
      const bool inside = gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
      cp_async16(tile + p * RING_PB + q * 16,
                 inside ? img + ((size_t)gh * a.W + gw) * a.cin + c0 + q * (16 / ELEM) : img, inside ? 16 : 0);
    }
  };

  int arow[WM];  // the lane's ldmatrix address in a staged tile, m16 tile j at tap (0, 0)
#pragma unroll
  for (int j = 0; j < WM; ++j) {
    const int p = (wmi * WM + j) * 16 + (lane & 15), r = p / a.tw;
    arow[j] = (r * xw + p - r * a.tw) * RING_PB + (lane >> 4) * 16;
  }
  // the first stages' weights while the kernel before finishes; then (programmatic dependent launch)
  // everything it writes is read, and everything this one writes is written, after the wait
  for (int k = 0; k < RING_STAGES - 1 && k < ns; ++k) load_weights(k);
  grid_dependency_wait();
  grid_dependents_launch();
  for (int k = 0; k < RING_STAGES - 1; ++k) {
    if (k < ns) load_tile(k);
    cp_async_commit();  // stage k's group (the first also holds the weights above)
  }

  // float32: the tensor cores' sums of a stage are added to tot by the CUDA cores (FADD, rounded to nearest)
  // and acc starts the next stage at zero, so no tensor-core accumulator runs longer than one stage's products
  constexpr bool FLUSH = sizeof(T) == 4;
  float acc[WM][RING_NT][4], accs[WM][RING_NT][4], tot[WM][RING_NT][4];
#pragma unroll
  for (int j = 0; j < WM; ++j)
#pragma unroll
    for (int n = 0; n < RING_NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = accs[j][n][i] = tot[j][n][i] = 0.f;
  for (int k = 0; k < ns; ++k) {
    const int ahead = k + RING_STAGES - 1;  // into the slot stage k - 1 used, which every warp is done with
    if (ahead < ns) {
      load_weights(ahead);
      load_tile(ahead);
    }
    cp_async_commit();
    cp_async_wait<RING_STAGES - 1>();  // stage k's group has landed
    __syncthreads();
    const unsigned char* slot = smem + (k % RING_STAGES) * stage;
    const unsigned char* tile = slot + wbytes;
    const Frag* w = reinterpret_cast<const Frag*>(slot) + wn * 9 * TAP_FRAGS + lane;
    for (int tap = tap0; tap < tap1; ++tap)
      mma_tap<T, RING_NT, WM, true>(acc, tile + ((tap / 3) * xw + tap % 3) * RING_PB, arow, w + tap * TAP_FRAGS,
                                    RING_KC);
    if (centre)
      mma_tap<T, RING_NT, WM, true>(accs, tile + (xw + 1) * RING_PB, arow,
                              reinterpret_cast<const Frag*>(slot + NW * 9 * TAP_BYTES) + wn * TAP_FRAGS + lane,
                              RING_KC);
    if constexpr (FLUSH) {
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tot[j][n][i] += acc[j][n][i];
            acc[j][n][i] = 0.f;
          }
    }
    __syncthreads();
  }
  if constexpr (FLUSH) {
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < RING_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = tot[j][n][i];
  }

  const int nacc = sc ? 2 * NACC : NACC, rt = threadIdx.x - wk * nres;
  if (a.kw > 1) {
    // the warps along K: those of wk > 0 hand their sums over in the ring's memory (free after the loop's last
    // sync), and those of wk = 0 add them in wk order
    float* red = reinterpret_cast<float*>(smem);
    if (wk > 0) {
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (j * RING_NT + n) * 4 + i;
            red[((size_t)(wk - 1) * nacc + e) * nres + rt] = acc[j][n][i];
            if (sc) red[((size_t)(wk - 1) * nacc + NACC + e) * nres + rt] = accs[j][n][i];
          }
    }
    __syncthreads();
    if (wk == 0) {
      for (int w = 1; w < a.kw; ++w)
#pragma unroll
        for (int j = 0; j < WM; ++j)
#pragma unroll
          for (int n = 0; n < RING_NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = (j * RING_NT + n) * 4 + i;
              acc[j][n][i] += red[((size_t)(w - 1) * nacc + e) * nres + rt];
              if (sc) accs[j][n][i] += red[((size_t)(w - 1) * nacc + NACC + e) * nres + rt];
            }
    }
  }

  if (a.splits > 1) {
    // split K: this block's partial sums out, coalesced (element e of every thread together); the tile's last
    // block to arrive sums the splits' in split order
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = a.partial + ((size_t)tile_id * a.splits + blockIdx.z) * nacc * nres + rt;
    if (wk == 0) {
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = (j * RING_NT + n) * 4 + i;
            __stcg(part + (size_t)e * nres, acc[j][n][i]);
            if (sc) __stcg(part + (size_t)(NACC + e) * nres, accs[j][n][i]);
          }
    }
    int* last = reinterpret_cast<int*>(smem + RING_STAGES * stage);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(a.counters + tile_id, 1) == a.splits - 1;
    __syncthreads();
    if (!*last) return;
    if (threadIdx.x == 0) a.counters[tile_id] = 0;  // for the next conv of the level
    if (wk != 0) return;
    __threadfence();
    // split by split, each split's values loaded together before they are added
    const float* base = a.partial + (size_t)tile_id * a.splits * nacc * nres + rt;
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < RING_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = accs[j][n][i] = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float* src = base + (size_t)s * nacc * nres;
      float v[NACC], vs[NACC];
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        v[e] = __ldcg(src + (size_t)e * nres);
        vs[e] = sc ? __ldcg(src + (size_t)(NACC + e) * nres) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[j][n][i] += v[(j * RING_NT + n) * 4 + i];
            accs[j][n][i] += vs[(j * RING_NT + n) * 4 + i];
          }
    }
  }
  if (wk != 0) return;

  // the epilogue at this warp's pixels inside the image: the shortcut, then relu(conv + bias) (+ res)
#pragma unroll
  for (int n = 0; n < RING_NT; ++n) {
    const int c = (g0 + wn) * RING_GROUP + n * 8 + 2 * t;
    const float b0 = __ldg(a.bias + c), b1 = __ldg(a.bias + c + 1);
    const float s0b = sc ? __ldg(a.bsc + c) : 0.f, s1b = sc ? __ldg(a.bsc + c + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wmi * WM + j) * 16 + g + 8 * half, r = p / a.tw;
        const int oh = ty * a.th + r, ow = tx * a.tw + p - r * a.tw;
        if (oh >= a.H || ow >= a.W) continue;
        const size_t o = (((size_t)b * a.H + oh) * a.W + ow) * a.C + c;
        if (sc) store2(a.sc_out, o, accs[j][n][2 * half] + s0b, accs[j][n][2 * half + 1] + s1b);
        float v0 = fmaxf(acc[j][n][2 * half] + b0, 0.f), v1 = fmaxf(acc[j][n][2 * half + 1] + b1, 0.f);
        if (a.res != nullptr) {
          float r0, r1;
          load2(a.res, o, r0, r1);
          v0 += r0;
          v1 += r1;
        }
        store2(a.out, o, v0, v1);
      }
  }
}

// The batch kernel: RING_BATCH_M pixels (S streams' TH x TW) x NW groups a
// block, a warp an m16 tile, one warp along K; bfloat16 on wgmma, float32 on
// mma.sync.
template <typename T, int NW>
__global__ void __launch_bounds__(RING_BATCH_WARPS * 32)
ring_batch_kernel(const RingConv<T> a) {
  constexpr bool WG = sizeof(T) == 2;
  constexpr int WM = 1;
  using Frag = typename Step<T>::Frag;
  constexpr int ELEM = sizeof(T), SLAB = SLAB_BYTES / ELEM, NACC = WM * RING_NT * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool sc = a.wsc != nullptr;
  const int nthreads = blockDim.x, sub = a.th * a.tw, mw = a.s * sub / (16 * WM);
  const int nres = nthreads;  // the threads that hold the block's sums
  const int xw = a.tw + 2, spix = (a.th + 2) * xw, npix = a.s * spix;  // staged pixels: a stream's, the block's
  const int wbytes = NW * (sc ? 10 : 9) * TAP_BYTES;
  const size_t stage = ring_stage_bytes(NW, sc, a.s, a.th, a.tw);
  const int tiles_w = (a.W + a.tw - 1) / a.tw, tiles_h = (a.H + a.th - 1) / a.th;
  const int tx = blockIdx.x % tiles_w, ty = blockIdx.x / tiles_w % tiles_h;
  const int b0 = blockIdx.x / (tiles_w * tiles_h) * a.s;  // the tile's first stream
  const int nst = a.cin / SLAB;  // the conv's K stages, of which this block takes [s0, s0 + ns)
  const int s0 = blockIdx.z * nst / a.splits, ns = (blockIdx.z + 1) * nst / a.splits - s0;
  const int g0 = blockIdx.y * NW;  // the block's first group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the warp's place along M (a warpgroup's four warps are consecutive here) and its group
  const int wmi = warp % mw, wn = warp / mw;
  const uint32_t bars = smem_u32(smem + RING_STAGES * stage);  // a slot's mbarrier each, 8 bytes apart

  // stage k's weights (and the shortcut's) into slot sl: a bulk copy a group's block, by one thread
  auto load_weights = [&](int k, int sl) {
    if (threadIdx.x != 0) return;
    const uint32_t slot = smem_u32(smem + sl * stage), bar = bars + 8 * sl;
    const size_t s = s0 + k;
    mbar_expect(bar, wbytes);
    for (int gl = 0; gl < NW; ++gl) {
      const size_t blk = (size_t)(g0 + gl) * nst + s;
      bulk_copy(slot + gl * 9 * TAP_BYTES, static_cast<const unsigned char*>(a.w) + blk * 9 * TAP_BYTES,
                9 * TAP_BYTES, bar);
      if (sc)
        bulk_copy(slot + (NW * 9 + gl) * TAP_BYTES, static_cast<const unsigned char*>(a.wsc) + blk * TAP_BYTES,
                  TAP_BYTES, bar);
    }
  };
  // the S streams' input tiles, each with its own halo, zeros outside its map and past B: 16-byte chunk i of
  // a stage is pixel i / 4's bytes 16 (i % 4) of the slab. A thread's first RING_CHUNKS chunks keep their
  // addresses, which every stage shares but the slab's offset, in registers: the source in 16-byte units from
  // the first slab (~0 for zeros), the destination in a slot's tile
  const int h0 = ty * a.th - 1, w0 = tx * a.tw - 1, nchunk = npix * (SLAB_BYTES / 16);
  auto chunk = [&](int i, uint32_t& src, uint32_t& dst) {
    const int p = i / (SLAB_BYTES / 16), q = i % (SLAB_BYTES / 16);
    const int sl = p / spix, pp = p - sl * spix, r = pp / xw;
    const int b = b0 + sl, gh = h0 + r, gw = w0 + pp - r * xw;
    const bool inside = b < a.B && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    src = inside ? (uint32_t)((((size_t)b * a.H + gh) * a.W + gw) * a.cin * ELEM / 16 + q) : ~0u;
    dst = p * RING_PB + q * 16;
  };
  uint32_t csrc[RING_CHUNKS], cdst[RING_CHUNKS];
#pragma unroll
  for (int j = 0; j < RING_CHUNKS; ++j) {
    const int i = threadIdx.x + j * nthreads;
    csrc[j] = cdst[j] = ~0u;
    if (i < nchunk) chunk(i, csrc[j], cdst[j]);
  }
  // stage k's slab into slot sl
  auto load_tile = [&](int k, int sl) {
    unsigned char* tile = smem + sl * stage + wbytes;
    const int4* slab = reinterpret_cast<const int4*>(a.in + (size_t)(s0 + k) * SLAB);
    auto copy = [&](uint32_t src, uint32_t dst) {
      cp_async16(tile + dst, src != ~0u ? slab + src : slab, src != ~0u ? 16 : 0);
    };
#pragma unroll
    for (int j = 0; j < RING_CHUNKS; ++j)
      if (cdst[j] != ~0u) copy(csrc[j], cdst[j]);
    for (int i = threadIdx.x + RING_CHUNKS * nthreads; i < nchunk; i += nthreads) {
      uint32_t src, dst;
      chunk(i, src, dst);
      copy(src, dst);
    }
  };

  int arow[WM];  // the lane's ldmatrix address in a staged slab, m16 tile j at tap (0, 0)
#pragma unroll
  for (int j = 0; j < WM; ++j) {
    const int p = (wmi * WM + j) * 16 + (lane & 15), sl = p / sub, q = p - sl * sub, r = q / a.tw;
    arow[j] = (sl * spix + r * xw + q - r * a.tw) * RING_PB + (lane >> 4) * 16;
  }
  // wgmma: the taps' A addresses in a staged slab, and the descriptors of their weights and of the
  // shortcut's as offsets (16-byte units) from the ring's first slot's
  constexpr int TPW = WG ? 9 : 1;
  uint32_t aoff[TPW], dtap[TPW];
#pragma unroll
  for (int tap = 0; tap < TPW; ++tap) {
    aoff[tap] = ((tap / 3) * xw + tap % 3) * RING_PB + arow[0];
    dtap[tap] = (uint32_t)((wn * 9 + tap) * TAP_BYTES) >> 4;
  }
  const uint64_t desc0 = wgmma_desc(smem_u32(smem));
  const uint32_t dsc = (uint32_t)((NW * 9 + wn) * TAP_BYTES) >> 4;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING_STAGES; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first stages' weights while the kernel before finishes; then (programmatic dependent launch)
  // everything it writes is read, and everything this one writes is written, after the wait
  for (int k = 0; k < RING_STAGES - 1 && k < ns; ++k) load_weights(k, k);
  grid_dependency_wait();
  grid_dependents_launch();
  for (int k = 0; k < RING_STAGES - 1; ++k) {
    if (k < ns) load_tile(k, k);
    cp_async_commit();
  }

  // float32: the tensor cores' sums of a stage are added to tot by the CUDA cores (FADD, rounded to nearest)
  // and acc starts the next stage at zero, so no tensor-core accumulator runs longer than one stage's products
  constexpr bool FLUSH = sizeof(T) == 4;
  float acc[WM][RING_NT][4], accs[WM][RING_NT][4], tot[FLUSH ? WM : 1][RING_NT][4];
#pragma unroll
  for (int j = 0; j < WM; ++j)
#pragma unroll
    for (int n = 0; n < RING_NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = accs[j][n][i] = tot[FLUSH ? j : 0][n][i] = 0.f;
  for (int k = 0, sl = 0, parity = 0; k < ns; ++k) {  // stage k in slot sl, its barrier's phase parity
    cp_async_wait<RING_STAGES - 2>();    // stage k's halos have landed
    mbar_wait(bars + 8 * sl, parity);     // and its weights
    if constexpr (WG) wgmma_wait_all();  // stage k - 1's products, which ran while this thread waited
    __syncthreads();
    // every warp is past stage k - 1: its slot takes stage k + RING_STAGES - 1
    const int ahead = k + RING_STAGES - 1, ahead_sl = sl == 0 ? RING_STAGES - 1 : sl - 1;
    if (ahead < ns) {
      load_weights(ahead, ahead_sl);
      load_tile(ahead, ahead_sl);
    }
    cp_async_commit();
    const unsigned char* slot = smem + sl * stage;
    if (++sl == RING_STAGES) {
      sl = 0;
      parity ^= 1;
    }
    const unsigned char* tile = slot + wbytes;
    const unsigned char* wsl = slot + wn * 9 * TAP_BYTES;                 // the warp's group's taps
    const unsigned char* wsc = slot + (NW * 9 + wn) * TAP_BYTES;          // and its shortcut's
    if constexpr (WG) {
      // the 9 taps: every A fragment into registers, then one group of wgmma on them
      uint32_t af[TPW][RING_KC][4];
      const uint32_t tb = smem_u32(tile), dslot = (uint32_t)(slot - smem) >> 4;
#pragma unroll
      for (int tap = 0; tap < TPW; ++tap)
#pragma unroll
        for (int cc = 0; cc < RING_KC; ++cc) ldmatrix_x4_at(af[tap][cc], tb + aoff[tap] + cc * 32);
      fence_acc(acc[0]);
      fence_acc(accs[0]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < TPW; ++tap) {
#pragma unroll
        for (int cc = 0; cc < RING_KC; ++cc)
          wgmma_m64n32k16(acc[0], af[tap][cc], desc0 + dslot + dtap[tap] + cc * (KSTEP_BYTES >> 4));
        if (sc && tap == 4)
#pragma unroll
          for (int cc = 0; cc < RING_KC; ++cc)
            wgmma_m64n32k16(accs[0], af[tap][cc], desc0 + dslot + dsc + cc * (KSTEP_BYTES >> 4));
      }
      wgmma_commit();  // waited for at the next stage, before its slot is refilled and af written again
    } else {
      const Frag* w = reinterpret_cast<const Frag*>(wsl) + lane;
      for (int tap = 0; tap < 9; ++tap)
        mma_tap<T, RING_NT, WM, true>(acc, tile + ((tap / 3) * xw + tap % 3) * RING_PB, arow, w + tap * TAP_FRAGS,
                                      RING_KC);
      if (sc)
        mma_tap<T, RING_NT, WM, true>(accs, tile + (xw + 1) * RING_PB, arow, reinterpret_cast<const Frag*>(wsc) + lane,
                                      RING_KC);
    }
    if constexpr (FLUSH) {
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tot[j][n][i] += acc[j][n][i];
            acc[j][n][i] = 0.f;
          }
    }
  }
  if constexpr (WG) {
    wgmma_wait_all();
    fence_acc(acc[0]);
    fence_acc(accs[0]);
  }
  if constexpr (FLUSH) {
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < RING_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = tot[j][n][i];
  }

  const int nacc = sc ? 2 * NACC : NACC, rt = threadIdx.x;
  if (a.splits > 1) {
    // split K: this block's partial sums out, coalesced (element e of every thread together); the tile's last
    // block to arrive sums the splits' in split order
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = a.partial + ((size_t)tile_id * a.splits + blockIdx.z) * nacc * nres + threadIdx.x;
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < RING_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = (j * RING_NT + n) * 4 + i;
          __stcg(part + (size_t)e * nres, acc[j][n][i]);
          if (sc) __stcg(part + (size_t)(NACC + e) * nres, accs[j][n][i]);
        }
    int* last = reinterpret_cast<int*>(smem + RING_STAGES * stage + 8 * RING_STAGES);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(a.counters + tile_id, 1) == a.splits - 1;
    __syncthreads();
    if (!*last) return;
    if (threadIdx.x == 0) a.counters[tile_id] = 0;  // for the next conv of the level
    __threadfence();
    // split by split, each split's values loaded together before they are added
    const float* base = a.partial + (size_t)tile_id * a.splits * nacc * nres + threadIdx.x;
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < RING_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = accs[j][n][i] = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float* src = base + (size_t)s * nacc * nres;
      float v[NACC], vs[NACC];
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        v[e] = __ldcg(src + (size_t)e * nres);
        vs[e] = sc ? __ldcg(src + (size_t)(NACC + e) * nres) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int n = 0; n < RING_NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[j][n][i] += v[(j * RING_NT + n) * 4 + i];
            accs[j][n][i] += vs[(j * RING_NT + n) * 4 + i];
          }
    }
  }

  // the epilogue at this warp's pixels inside their stream's map: the shortcut, then relu(conv + bias) (+ res)
#pragma unroll
  for (int n = 0; n < RING_NT; ++n) {
    const int c = (g0 + wn) * RING_GROUP + n * 8 + 2 * t;
    const float b0v = __ldg(a.bias + c), b1v = __ldg(a.bias + c + 1);
    const float s0b = sc ? __ldg(a.bsc + c) : 0.f, s1b = sc ? __ldg(a.bsc + c + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wmi * WM + j) * 16 + g + 8 * half, sl = p / sub, q = p - sl * sub, r = q / a.tw;
        const int b = b0 + sl, oh = ty * a.th + r, ow = tx * a.tw + q - r * a.tw;
        if (b >= a.B || oh >= a.H || ow >= a.W) continue;
        const size_t o = (((size_t)b * a.H + oh) * a.W + ow) * a.C + c;
        if (sc) store2(a.sc_out, o, accs[j][n][2 * half] + s0b, accs[j][n][2 * half + 1] + s1b);
        float v0 = fmaxf(acc[j][n][2 * half] + b0v, 0.f), v1 = fmaxf(acc[j][n][2 * half + 1] + b1v, 0.f);
        if (a.res != nullptr) {
          float r0, r1;
          load2(a.res, o, r0, r1);
          v0 += r0;
          v1 += r1;
        }
        store2(a.out, o, v0, v1);
      }
  }
}

struct RingTiling {
  int th, tw, wm, nw, kw, s, wg, split_in, split_c;
  int m() const { return s * th * tw; }
  int mw() const { return m() / (16 * wm); }
  int warps() const { return mw() * nw * kw; }
  // the batch kernel's tiles: several streams a block, or wgmma
  bool batch() const { return s > 1 || wg; }
};

// dtype 0 float32, 1 bfloat16. The batch kernel takes its one tile,
// RING_BATCH_M pixels x RING_BATCH_NW groups, an m16 tile a warp and one warp
// along K, in float32 on mma.sync and in bfloat16 on wgmma; the one-stream
// kernel S = 1 on mma.sync. The ring's memory must also hold the sums the
// warps along K hand over: (kw - 1) x th tw x 32 nw floats, twice that with
// the shortcut
bool valid_ring_tiling(int dtype, const RingTiling& tl) {
  if (tl.batch() && (tl.m() != RING_BATCH_M || tl.nw != RING_BATCH_NW || tl.wm != 1 || tl.kw != 1 ||
                     tl.wg != (dtype == 1)))
    return false;
  return tl.th >= 1 && tl.tw >= 1 && tl.s >= 1 && (tl.wg == 0 || tl.wg == 1) && (tl.wm == 1 || tl.wm == 2) &&
         (tl.nw == 1 || tl.nw == 2) && tl.kw >= 1 && tl.kw <= 9 && tl.m() % (16 * tl.wm) == 0 &&
         tl.warps() >= 1 && tl.warps() <= RING_MAX_WARPS &&
         ring_smem(tl.nw, true, tl.s, tl.th, tl.tw) <= (size_t)SMEM_CAP &&
         (size_t)(tl.kw - 1) * 2 * tl.m() * RING_GROUP * tl.nw * 4 <=
             RING_STAGES * ring_stage_bytes(tl.nw, false, tl.s, tl.th, tl.tw);
}


// an instance of either kernel: the batch kernel (BATCH) at NW, the one-stream kernel at (NW, WM)
template <typename T, int NW, int WM, bool BATCH>
constexpr void (*ring_kernel())(const RingConv<T>) {
  if constexpr (BATCH)
    return ring_batch_kernel<T, NW>;
  else
    return ring_conv3x3_kernel<T, NW, WM>;
}

template <typename T, int NW, int WM, bool BATCH>
cudaError_t ring_conv(const RingConv<T>& a, const RingTiling& tl, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  cudaError_t e = smem_cap_once((const void*)ring_kernel<T, NW, WM, BATCH>(), done, SMEM_CAP);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B + tl.s - 1) / tl.s * ((a.H + tl.th - 1) / tl.th) * ((a.W + tl.tw - 1) / tl.tw),
                     a.C / (RING_GROUP * NW), a.splits);
  cfg.blockDim = dim3(tl.warps() * 32);
  cfg.dynamicSmemBytes = ring_smem(NW, a.wsc != nullptr, tl.s, tl.th, tl.tw);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ring_kernel<T, NW, WM, BATCH>(), a);
}

// the level's blocks in turn, two launches each, as chain() runs them
template <typename T, int NW, int WM, bool BATCH>
cudaError_t ring_chain(const T* x, T* out, T* scratch, float* partial, int* counters, const void* const* params,
                       int n_blocks, int B, int H, int W, int cin, int C, const RingTiling& tl, cudaStream_t stream) {
  const size_t act = (size_t)B * H * W * C;
  T* y1 = scratch;
  T* ping[2] = {scratch + act, scratch + 2 * act};
  const T* src = x;
  for (int i = 0; i < n_blocks; ++i) {
    const void* const* p = params + 6 * i;
    T* dst = i + 1 == n_blocks ? out : ping[i % 2];
    const bool sc = p[4] != nullptr;
    const RingConv<T> c1{src, p[0], static_cast<const float*>(p[1]), p[4], static_cast<const float*>(p[5]),
                         sc ? dst : nullptr, nullptr, y1, partial, counters, B, cin, C, H, W, tl.th, tl.tw, tl.s,
                         i == 0 ? tl.split_in : tl.split_c, tl.kw};
    cudaError_t e = ring_conv<T, NW, WM, BATCH>(c1, tl, stream);
    if (e != cudaSuccess) return e;
    const RingConv<T> c2{y1, p[2], static_cast<const float*>(p[3]), nullptr, nullptr, nullptr, sc ? dst : src, dst,
                         partial, counters, B, C, C, H, W, tl.th, tl.tw, tl.s, tl.split_c, tl.kw};
    e = ring_conv<T, NW, WM, BATCH>(c2, tl, stream);
    if (e != cudaSuccess) return e;
    src = dst;
    cin = C;
  }
  return cudaSuccess;
}

// the instances (dtype, nw, wm, batch): the one-stream kernel at (nw, wm) in both dtypes; the batch kernel
// at its one tile's RING_BATCH_NW
#define RING_INSTANCES(X)                                                                                      \
  X(0, 1, 1, 0) X(0, 1, 2, 0) X(0, 2, 1, 0) X(0, 2, 2, 0) X(1, 1, 1, 0) X(1, 1, 2, 0) X(1, 2, 1, 0) X(1, 2, 2, 0) \
  X(0, RING_BATCH_NW, 1, 1) X(1, RING_BATCH_NW, 1, 1)
#define RING_KEY(dt, nw, wm, batch) ((((dt) * 10 + (nw)) * 10 + (wm)) * 10 + (batch))

int ring_key(int dtype, const RingTiling& tl) { return RING_KEY(dtype, tl.nw, tl.wm, tl.batch() ? 1 : 0); }

const void* ring_kernel_of(int key) {
  switch (key) {
#define X(dt, nw, wm, batch)   \
  case RING_KEY(dt, nw, wm, batch): \
    return (const void*)ring_kernel<std::conditional_t<dt == 0, float, __nv_bfloat16>, nw, wm, batch>();
    RING_INSTANCES(X)
#undef X
    default: return nullptr;
  }
}

cudaError_t ring_chain_c(int key, const void* x, void* out, void* scratch, float* partial, int* counters,
                         const void* const* params, int n_blocks, int B, int H, int W, int cin, int C,
                         const RingTiling& tl, cudaStream_t s) {
  switch (key) {
#define X(dt, nw, wm, batch)                                                                                 \
  case RING_KEY(dt, nw, wm, batch): {                                                                        \
    using T = std::conditional_t<dt == 0, float, __nv_bfloat16>;                                             \
    return ring_chain<T, nw, wm, batch>(static_cast<const T*>(x), static_cast<T*>(out),                      \
                                        static_cast<T*>(scratch), partial, counters, params, n_blocks, B, H, W, \
                                        cin, C, tl, s);                                                     \
  }
    RING_INSTANCES(X)
#undef X
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace

// A whole level: x [B, H, W, cin] -> out [B, H, W, C] in the activation type
// (dtype 0 float32, 1 bfloat16), C in {8, 16, 32}, cin in 1..64; scratch: 3 B H W C elements of it. params:
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


// A whole level on the ring kernel: x [B, H, W, cin] -> out [B, H, W, C] in
// the activation type (dtype 0 float32, 1 bfloat16), cin a multiple of a
// stage's slab (16 float32, 32 bf16), C of 32 nw; scratch: 3 B H W C
// elements of it. params: 6 pointers per block as for
// rvc_conv_block_res_chain, the weights packed by ops/_mma.py:pack_ring
// (pack_ring_wgmma where wg is set). The tiling: s streams' tiles of th x tw
// output pixels a block (s th tw a multiple of 16 wm), wm m16 tiles a warp,
// nw groups of 32 channels a block, kw warps along K (each 9 / kw taps of a
// stage); s 1 with wg 0 runs the one-stream kernel (mma.sync), anything else
// the batch kernel at its one tile (s th tw 64, wm 1, nw 2, kw 1; bfloat16
// on wgmma, wg 1; float32 on mma.sync, wg 0). The K stages of the first
// conv (over cin) split split_in ways across blocks, of every other (over C)
// split_c ways. Where either is past 1, partial holds tiles x max(2
// split_in, split_c) x s th tw x 32 nw floats (tiles: the launch's output
// tiles, pixel tiles x C / (32 nw)) and counters tiles int32 zeros, which
// the call leaves zero. Launches two
// kernels per block of the chain on `stream`, each a programmatic dependent
// of the kernel before it, on the calling thread's current device. Returns
// a CUDA error code.
extern "C" int rvc_conv_block_res_chain_ring(const void* x, void* out, void* scratch, void* partial, void* counters,
                                             const void* const* params, int n_blocks, int B, int H, int W, int cin,
                                             int C, int dtype, int th, int tw, int wm, int nw, int kw, int s, int wg,
                                             int split_in, int split_c, void* stream) {
  const RingTiling tl{th, tw, wm, nw, kw, s, wg, split_in, split_c};
  const int slab = dtype == 0 ? SLAB_BYTES / 4 : SLAB_BYTES / 2;
  if ((dtype != 0 && dtype != 1) || n_blocks < 1 || B < 1 || H < 1 || W < 1 || cin < slab || cin % slab ||
      C < RING_GROUP * nw || !valid_ring_tiling(dtype, tl) || C % (RING_GROUP * nw) || split_in < 1 ||
      split_in > cin / slab || split_c < 1 || split_c > C / slab ||
      ((split_in > 1 || split_c > 1) && (partial == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      (size_t)B * H * W * (cin > C ? cin : C) * (dtype == 0 ? 4 : 2) / 16 >= 0xFFFFFFFFu)  // 32-bit chunk offsets
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_blocks; ++i) {
    if (params[6 * i + 4] == nullptr && (i == 0 ? cin : C) != C) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 6; j += 2)  // the weights go by bulk copies: 16-byte aligned
      if (reinterpret_cast<uintptr_t>(params[6 * i + j]) % 16) return (int)cudaErrorInvalidValue;
  }
  return (int)ring_chain_c(ring_key(dtype, tl), x, out, scratch, static_cast<float*>(partial),
                           static_cast<int*>(counters), params, n_blocks, B, H, W, cin, C, tl,
                           static_cast<cudaStream_t>(stream));
}

// The ring kernel's launch at a tiling on this card: out = (threads, shared
// memory bytes of its largest launch (conv1 with the shortcut), registers a
// thread, blocks an SM holds at that shared memory). Returns a CUDA error
// code.
extern "C" int rvc_chain_ring_launch_info(int dtype, int th, int tw, int wm, int nw, int kw, int s, int wg, int* out) {
  const RingTiling tl{th, tw, wm, nw, kw, s, wg, 1, 1};
  if ((dtype != 0 && dtype != 1) || !valid_ring_tiling(dtype, tl)) return (int)cudaErrorInvalidValue;
  const void* k = ring_kernel_of(ring_key(dtype, tl));
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ring_smem(nw, true, s, th, tw);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, tl.warps() * 32, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = tl.warps() * 32;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = blocks;
  return 0;
}
