// The NSF generator's resblock bank on the tensor cores:
//
//     out = (1 / nbanks) * sum_j ResBlock1_j(x),
//     ResBlock1_j: for each dilation d, x <- x + conv_k,1(lrelu(conv_k,d(lrelu(x)) + b1)) + b2
//
// with leaky-ReLU slope 0.1, zero SAME padding on both convs, [B, L, C]
// activations. One launch is one step (k, d) of one bank; one C call issues
// the bank's nbanks x S launches. A bank's last step adds its result into a
// float32 bank sum, and the last bank's last step writes (sum + y) / nbanks.
//
// Replaces: obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot (Pallas, TPU;
// the C=32 and C=64 levels) and obs_rvc_tpu/ops/resblock.py:resblock_bank
// (its im2col form, which the JAX package keeps for C<32; here C=16). Both
// hold one stream's whole [C, L + 64] activation in VMEM, 1.8 MB at C=64,
// L=7000 in float32, past a Hopper block's 227 KB of shared memory, so this
// kernel tiles the time axis across blocks.
//
// What bounds it: at the main path's shapes (C=64 at L=7000, C=32 at
// L=14000) the bank does 7.23 and 3.61 GFLOP against ~0.02 GB of activations
// and weights per step: bound by arithmetic. In float32 each product runs as
// three TF32 tensor-core products (3xTF32, see mma.cuh); its bound is 495 / 3
// = 165 TFLOP/s, 0.066 ms a step. In bfloat16 one bf16 product with float32
// accumulation.
//
// Design: each conv is an implicit GEMM on mma.sync.m16n8k8, M = positions,
// N = C, K = k taps x C channels, walked one tap's C at a time; tap t shifts
// A's rows by t * d (conv1) or t (conv2). A block owns TL = 64 output
// positions and all C channels: C/8 warps, each one n8 tile over all the
// block's m16 tiles, so every weight fragment is read by one warp of the
// block and no tap needs shared memory for weights or a barrier. The block
// stages lrelu(x) over its tile and both convs' halos (d(k-1)/2 + (k-1)/2
// rows a side) once, in one round of float4 loads, as one plane of floats,
// rows padded to C + 4 floats so the 8 rows of an ldmatrix phase fall on 32
// distinct banks; runs conv1 over the tile plus conv2's halo, TL + k - 1
// rows rounded up to whole m16 tiles (80 at every k), into a second plane,
// zero outside [0, L); then conv2 and the epilogue. Neighbouring blocks
// recompute conv1's halo (12.5 % of the products at TL = 64). In float32 a
// warp loads each A fragment with one ldmatrix and splits it into TF32 hi
// and lo in registers (two instructions a value): staging hi and lo planes
// instead, as the U-Net chain does, read twice the shared memory a product,
// which bound the kernel. Weights are packed once per weight version on the
// host (ops/resblock.py:pack_bank) into the B fragments' order, a [k, C, C]
// weight as k slabs of K = C; each warp reads its fragments straight from L2
// eight K steps ahead of their use (a ring in registers, filled before the
// staging and before conv1's epilogue), as the chain's kernel does. The
// residual and the bank sum are read before conv2, which hides the wait.

#include "mma.cuh"

namespace {

constexpr int TL = 64;      // output positions of a block
constexpr int RING = 8;     // K steps a weight fragment is loaded ahead
constexpr int MAX_DIL = 5;
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// four consecutive activations as floats (16-byte aligned in float32, 8 in bfloat16)
__device__ __forceinline__ float4 load4(const float* p, size_t i) { return __ldg(reinterpret_cast<const float4*>(p + i)); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, size_t i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + i));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows conv1 computes: the tile and conv2's halo, in whole m16 tiles
__host__ __device__ constexpr int conv1_rows(int k) { return (TL + k - 1 + 15) / 16 * 16; }

// shared memory of one launch: the staged input's rows and conv1's
template <int C>
constexpr size_t smem_bytes(int k, int d) {
  return (size_t)(2 * conv1_rows(k) + d * (k - 1)) * (C + 4) * sizeof(float);
}

// acc[m] += A_m B for the MT m16 tiles of a conv's output rows m * 16 + [0, 16):
// tap `tap` reads the plane's rows r + tap * dil, columns of the K step's
// channel slab; B's fragments of this warp's n8 tile start at wf, K * C/8 K
// steps of C/8 n8 tiles each, and come from L2 RING K steps ahead of use
// (the ring filled by ring_fill). Float32 loads each A fragment with one
// ldmatrix and splits it into TF32 hi and lo in registers; bfloat16 reads its
// entries one by one.
// Load a conv's first RING K steps of B fragments (this warp's n8 tile at wf)
// into the ring: the caller issues it before the work that precedes the
// conv, so the loads are in flight during it.
template <typename T, int C, int K>
__device__ __forceinline__ void ring_fill(typename Prec<T>::Frag (&ring)[RING],
                                          const typename Prec<T>::Frag* __restrict__ wf) {
  constexpr int NK = K * (C / 8), STEP = (C / 8) * 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RING; ++i) ring[i] = i < NK ? __ldg(wf + i * STEP + lane) : typename Prec<T>::Frag{};
}

template <typename T, int C, int K, int MT>
__device__ __forceinline__ void conv_gemm(float (&acc)[MT][4], const float* plane, int dil,
                                          const typename Prec<T>::Frag* __restrict__ wf,
                                          typename Prec<T>::Frag (&ring)[RING]) {
  using Frag = typename Prec<T>::Frag;
  constexpr bool F32 = Prec<T>::PLANES == 2;
  constexpr int S = C + 4, KC = C / 8, NK = K * KC, STEP = KC * 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 4;  // the lane's ldmatrix address
  float small[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) small[m][i] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < NK; k0 += RING) {
#pragma unroll
    for (int i = 0; i < RING; ++i) {
      const int kb = k0 + i;
      if (kb >= NK) break;
      const Frag b = ring[i];
      if (kb + RING < NK) ring[i] = __ldg(wf + (kb + RING) * STEP + lane);
      const int a0 = (kb / KC) * dil * S + (kb % KC) * 8;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (F32) {
          uint32_t a[4];
          ldmatrix_x4(a, plane + a0 + (m * 16 + lrow) * S + lcol);
          mma_3xtf32(acc[m], small[m], a, b);
        } else {
          mma_step_bf16(acc[m], plane, a0 + (m * 16 + g) * S, a0 + (m * 16 + g + 8) * S, t, b);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] += small[m][i];
}

// One step of one bank. mode: 0 out = y; 1 acc = y; 2 acc += y; 3 out = (acc + y) * scale
template <typename T, int C, int K>
__global__ void __launch_bounds__(C * 4)
resblock_step_kernel(const T* __restrict__ x, T* __restrict__ out, float* __restrict__ acc,
                     const typename Prec<T>::Frag* __restrict__ w1, const float* __restrict__ b1,
                     const typename Prec<T>::Frag* __restrict__ w2, const float* __restrict__ b2, int L, int d,
                     int mode, float scale) {
  constexpr int NT = C * 4, S = C + 4, P2 = (K - 1) / 2, M1 = conv1_rows(K);
  const int P1 = d * P2, XR = M1 + 2 * P1;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [XR][S]: lrelu(x) at rows l0 - P2 - P1 + r
  float* ys = xs + XR * S;                      // [M1][S]: conv1's output at rows l0 - P2 + r

  const int b = blockIdx.y, l0 = blockIdx.x * TL;
  const T* xb = x + (size_t)b * L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n = warp * 8 + 2 * t;  // the lane's two output channels n, n + 1
  typename Prec<T>::Frag ring[RING];
  ring_fill<T, C, K>(ring, w1 + warp * 32);

  // Stage lrelu(x), zeros outside [0, L), four channels a load. Each thread
  // has all its loads in flight (BATCH covers the tile at the largest
  // dilation) before it writes any, so the block waits on memory once.
  constexpr int C4 = C / 4, BATCH = ((M1 + MAX_DIL * (K - 1)) * C4 + NT - 1) / NT;
  const int g0 = l0 - P2 - P1, n_in = XR * C4;
  for (int i0 = threadIdx.x; i0 < n_in; i0 += BATCH * NT) {
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * NT, gp = g0 + i / C4;
      v[u] = (i < n_in && gp >= 0 && gp < L) ? load4(xb, (size_t)gp * C + (i % C4) * 4)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * NT;
      if (i < n_in)
        *reinterpret_cast<float4*>(xs + (i / C4) * S + (i % C4) * 4) =
            make_float4(lrelu(v[u].x), lrelu(v[u].y), lrelu(v[u].z), lrelu(v[u].w));
    }
  }
  __syncthreads();

  {
    float a[M1 / 16][4] = {};
    conv_gemm<T, C, K, M1 / 16>(a, xs, d, w1 + warp * 32, ring);
    ring_fill<T, C, K>(ring, w2 + warp * 32);
    const float c0 = __ldg(b1 + n), c1 = __ldg(b1 + n + 1);
#pragma unroll
    for (int m = 0; m < M1 / 16; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m * 16 + g + 8 * h, gp = l0 - P2 + r;
        const bool inside = gp >= 0 && gp < L;  // conv2's SAME padding
        *reinterpret_cast<float2*>(ys + r * S + n) =
            inside ? make_float2(lrelu(a[m][2 * h] + c0), lrelu(a[m][2 * h + 1] + c1)) : make_float2(0.f, 0.f);
      }
  }
  // the residual, plus the bank sum where this step adds to it, loaded now
  // so that conv2 hides the wait
  float res[TL / 16][2][2];
#pragma unroll
  for (int m = 0; m < TL / 16; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gp = l0 + m * 16 + g + 8 * h;
      const size_t o = (size_t)gp * C + n;
      res[m][h][0] = res[m][h][1] = 0.f;
      if (gp < L) {
        res[m][h][0] = load(xb, o);
        res[m][h][1] = load(xb, o + 1);
        if (mode >= 2) {
          const float2 p = *reinterpret_cast<const float2*>(acc + (size_t)b * L * C + o);
          res[m][h][0] += p.x;
          res[m][h][1] += p.y;
        }
      }
    }
  __syncthreads();

  float a[TL / 16][4] = {};
  conv_gemm<T, C, K, TL / 16>(a, ys, 1, w2 + warp * 32, ring);
  const float c0 = __ldg(b2 + n), c1 = __ldg(b2 + n + 1);
#pragma unroll
  for (int m = 0; m < TL / 16; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gp = l0 + m * 16 + g + 8 * h;
      if (gp >= L) continue;
      const size_t o = ((size_t)b * L + gp) * C + n;
      // y, plus the bank sum in modes 2 and 3
      const float y0 = a[m][2 * h] + c0 + res[m][h][0], y1 = a[m][2 * h + 1] + c1 + res[m][h][1];
      switch (mode) {
        case 0: store2(out, o, y0, y1); break;
        case 1:
        case 2: *reinterpret_cast<float2*>(acc + o) = make_float2(y0, y1); break;
        default: store2(out, o, y0 * scale, y1 * scale); break;
      }
    }
}

template <typename T, int C, int K>
cudaError_t step(const T* x, T* out, float* acc, const void* const* p, int B, int L, int d, int mode, float scale,
                 cudaStream_t stream) {
  using Frag = typename Prec<T>::Frag;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(resblock_step_kernel<T, C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<C>(K, MAX_DIL));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((L + TL - 1) / TL, B);
  resblock_step_kernel<T, C, K><<<grid, C * 4, smem_bytes<C>(K, d), stream>>>(
      x, out, acc, static_cast<const Frag*>(p[0]), static_cast<const float*>(p[1]), static_cast<const Frag*>(p[2]),
      static_cast<const float*>(p[3]), L, d, mode, scale);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t step_k(int k, const T* x, T* out, float* acc, const void* const* p, int B, int L, int d, int mode,
                   float scale, cudaStream_t s) {
  switch (k) {
    case 3: return step<T, C, 3>(x, out, acc, p, B, L, d, mode, scale, s);
    case 7: return step<T, C, 7>(x, out, acc, p, B, L, d, mode, scale, s);
    case 11: return step<T, C, 11>(x, out, acc, p, B, L, d, mode, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bank's launches in order; a bank's steps pass their output through
// the two tmp buffers, its last step goes to the bank sum (or, in the last
// bank, to out).
template <typename T, int C>
cudaError_t bank(const void* x, void* out, float* acc, void* tmp, const void* const* params, int nbanks, int S,
                 const int* ks, const int* dils, int B, int L, cudaStream_t s) {
  const size_t act = (size_t)B * L * C;
  T* ping[2] = {static_cast<T*>(tmp), static_cast<T*>(tmp) + act};
  const float scale = 1.f / nbanks;
  for (int j = 0; j < nbanks; ++j) {
    const T* src = static_cast<const T*>(x);
    for (int i = 0; i < S; ++i) {
      T* dst = nullptr;
      int mode;
      if (i + 1 < S) {
        dst = ping[i % 2];
        mode = 0;
      } else if (j + 1 == nbanks) {
        dst = static_cast<T*>(out);
        mode = nbanks == 1 ? 0 : 3;
      } else {
        mode = j == 0 ? 1 : 2;
      }
      cudaError_t e = step_k<T, C>(ks[j], src, dst, acc, params + 4 * (j * S + i), B, L, dils[i], mode, scale, s);
      if (e != cudaSuccess) return e;
      src = dst;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t bank_c(int C, const void* x, void* out, float* acc, void* tmp, const void* const* params, int nbanks,
                   int S, const int* ks, const int* dils, int B, int L, cudaStream_t s) {
  switch (C) {
    case 16: return bank<T, 16>(x, out, acc, tmp, params, nbanks, S, ks, dils, B, L, s);
    case 32: return bank<T, 32>(x, out, acc, tmp, params, nbanks, S, ks, dils, B, L, s);
    case 64: return bank<T, 64>(x, out, acc, tmp, params, nbanks, S, ks, dils, B, L, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int C, int K>
cudaError_t info(int d, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, resblock_step_kernel<T, C, K>);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<C>(K, d);
  e = cudaFuncSetAttribute(resblock_step_kernel<T, C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<C>(K, MAX_DIL));
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, resblock_step_kernel<T, C, K>, C * 4, smem);
  out[0] = TL;
  out[1] = C * 4;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = conv1_rows(K);
  return e;
}

template <typename T, int C>
cudaError_t info_k(int k, int d, int* out) {
  switch (k) {
    case 3: return info<T, C, 3>(d, out);
    case 7: return info<T, C, 7>(d, out);
    case 11: return info<T, C, 11>(d, out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t info_c(int C, int k, int d, int* out) {
  switch (C) {
    case 16: return info_k<T, 16>(k, d, out);
    case 32: return info_k<T, 32>(k, d, out);
    case 64: return info_k<T, 64>(k, d, out);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int C, int k, int d, int dtype) {
  return (C == 16 || C == 32 || C == 64) && (k == 3 || k == 7 || k == 11) && d >= 1 && d <= MAX_DIL &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// The whole bank: x, out [B, L, C] in the activation type (dtype 0 float32,
// 1 bfloat16); acc: [B, L, C] float32 bank sum; tmp: 2 B L C elements of the
// activation type. params: 4 pointers per bank and step, bank-major,
// (W1, b1, W2, b2): the weights packed by ops/resblock.py:pack_bank into mma
// fragments (float32 hi/lo for dtype 0, bf16 for dtype 1), the biases
// float32. ks: nbanks kernel sizes in {3, 7, 11}; dils: S dilations in 1..5.
// Launches nbanks * S kernels on `stream`. Returns a CUDA error code (0 on
// success).
extern "C" int rvc_resblock_bank(const void* x, void* out, float* acc, void* tmp, const void* const* params,
                                 int nbanks, int S, const int* ks, const int* dils, int B, int L, int C, int dtype,
                                 void* stream) {
  if (nbanks < 1 || S < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nbanks; ++j)
    for (int i = 0; i < S; ++i)
      if (!valid(C, ks[j], dils[i], dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? bank_c<float>(C, x, out, acc, tmp, params, nbanks, S, ks, dils, B, L, s)
                             : bank_c<__nv_bfloat16>(C, x, out, acc, tmp, params, nbanks, S, ks, dils, B, L, s);
  return (int)e;
}

// One launch's shape, for the timing report: out[0..5] = positions a block
// owns, threads, dynamic shared memory in bytes, blocks an SM holds at once,
// registers a thread, conv1's rows a block computes.
extern "C" int rvc_resblock_launch_info(int C, int k, int d, int dtype, int* out) {
  if (!valid(C, k, d, dtype)) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? info_c<float>(C, k, d, out) : info_c<__nv_bfloat16>(C, k, d, out));
}
