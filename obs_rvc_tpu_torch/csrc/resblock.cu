// The NSF generator's resblock bank on the tensor cores:
//
//     out = (1 / nbanks) * sum_j ResBlock1_j(x),
//     ResBlock1_j: for each dilation d, x <- x + conv_k,1(lrelu(conv_k,d(lrelu(x)) + b1)) + b2
//
// with leaky-ReLU slope 0.1, zero SAME padding on both convs, [B, L, C]
// activations. One C call runs a level: one launch per dilation, each a
// step of every bank. Before the last, a block takes one bank's step over
// its tile and writes that bank's activation; in the last, a block takes
// every bank's step over its tile in turn and sums their outputs in
// registers, in the banks' order, so the sum needs no atomics and the
// output is the same bit for bit from call to call.
//
// Replaces: obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot (Pallas, TPU;
// the C=32 and C=64 levels) and obs_rvc_tpu/ops/resblock.py:resblock_bank
// (its im2col form, which the JAX package keeps for C<32; here C=8 and 16).
// Both hold one stream's whole [C, L + 64] activation in VMEM, 1.8 MB at
// C=64, L=7000 in float32, past a Hopper block's 227 KB of shared memory,
// so this kernel tiles the time axis across blocks.
//
// Widths: built for C in {8, 16, 32, 64}; the wrapper runs any other C up to
// 64 on the next of them, its weights and input zero-padded
// (ops/resblock.py). Any odd k (SAME padding is symmetric only there) and
// any dilation, as far as the plane with conv1's halo, (k - 1) d rows, fits
// beside the weight ring in shared memory; at most MAX_BANKS banks.
//
// What bounds it: at the main path's shapes (C=64 at L=7000, C=32 at
// L=14000) the bank does 7.23 and 3.61 GFLOP a stream against ~2 MB of
// activations: bound by arithmetic (694 GFLOP, 0.70 ms at bf16's 989 TFLOP/s
// at 64 streams). In float32 each product runs as three TF32 products
// (3xTF32, mma.cuh), 165 TFLOP/s at best.
//
// Design: each conv is an implicit GEMM on mma.sync (m16n8k16 in bf16,
// m16n8k8 3xTF32 in float32; mma.cuh's mma_tap), M = positions, N = C, K =
// k taps x C, walked one tap at a time; tap t shifts A's rows by t * d
// (conv1) or t (conv2). A block of W warps computes R = 16 * WM * W rows of
// each conv: each warp WM m16 tiles and every n8 tile of C (register
// blocking), so each A fragment is read from shared memory once a block and
// feeds C/8 products. Conv1 computes the tile and conv2's halo, so a block
// owns TL = R - (kmax - 1) output positions, the same for every bank; the
// wrapper chooses (W, WM) from the positions an SM (ops/resblock.py:
// bank_tiling) and hands them over. The block stages lrelu(x) over its rows
// and conv1's halo ((k - 1) d rows) into a plane of shared memory in the
// activation's dtype (cp.async, then the leaky ReLU in place), rows padded
// by 16 bytes so the 8 rows of an ldmatrix matrix fall in distinct banks;
// conv1 writes lrelu(y1 + b1) over the same plane once every warp is
// through it, zero outside [0, L), and conv2 reads it (one plane, not two,
// holds two blocks an SM in float32 at 128 rows); the residual comes from
// L2 in conv2's epilogue. The weights (packed once per weight version,
// ops/_mma.py:pack_taps) stream through a ring of 2 to 8 slabs of one tap's
// C x C in shared memory by cp.async, all but one taps ahead, across conv1,
// conv2 and the banks, with one barrier a tap; a k=11 conv's whole weight
// (90 KB in bf16 at C=64) would not sit beside the activations twice. The
// wrapper picks the depth with the tile: 8 for one stream, whose few blocks
// an SM wait on the weights' latency from L2, 3 from 8 streams, where more
// blocks an SM hide it.
//
// Launches: each is a programmatic dependent of the one before it
// (cudaLaunchAttributeProgrammaticStreamSerialization, griddepcontrol): its
// blocks start and load their first taps' weights while it finishes. Before
// the last launch a grid holds every bank's blocks, the largest k's first so
// that they start in the first wave. Where the last launch would leave the
// card half idle (a block a tile, each three banks long, fewer than two
// blocks an SM), the wrapper has its blocks take one bank each too and write
// float32, and one more kernel add them in the same order
// (resblock_bank_sum_kernel). mma.sync, not wgmma: a conv's A is a window of
// the staged rows shifted by t * d rows at each tap, which wgmma's swizzled
// 64-row shared-memory operands do not take without restaging it per tap
// (PERF.md has the share of the bound it reaches).

#include "mma.cuh"

namespace {

constexpr int MAX_BANKS = 4;
constexpr int MAX_WARPS = 8;
constexpr int MAX_RING = 8;       // tap slabs of weights in shared memory, at most
constexpr int SMEM_CAP = 232448;  // what a block may use on Hopper
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// the channels a staged row holds: C, or one K step (32 bytes) where C is
// narrower (C=8 in bf16, whose k16 fragment spans 16 channels; the 8 past C
// are staged as zeros and multiply the zero rows pack_taps pads the weights
// with)
__host__ __device__ constexpr int staged_channels(int C, int elem) { return C * elem < 32 ? 32 / elem : C; }
// a staged row's bytes: its channels and 16 more, so the 8 rows of an
// ldmatrix matrix fall in distinct banks
__host__ __device__ constexpr int row_bytes(int C, int elem) { return staged_channels(C, elem) * elem + 16; }

// Shared memory of one launch: the weight ring of `ring` tap slabs (one tap's
// staged_channels x C) and one plane of rows, which holds lrelu(x) over R rows
// and conv1's halo for conv1, then conv1's R rows (and the kmax - 1 rows past
// them that conv2 reads for rows past the tile) for conv2.
constexpr size_t smem_bytes(int C, int elem, int rows, int kmax, int d, int ring) {
  return (size_t)ring * staged_channels(C, elem) * C * elem + (size_t)(rows + (kmax - 1) * d) * row_bytes(C, elem);
}

// wait until at most n (0 <= n <= MAX_RING - 2) of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// One launch: one dilation's step of every bank.
struct Launch {
  const void* x[MAX_BANKS];  // each bank's input [B, L, C]
  void* y[MAX_BANKS];        // each bank's output (launches before the last)
  const void* w1[MAX_BANKS];  // conv1's and conv2's weights, k slabs of one tap's B fragments
  const float* b1[MAX_BANKS];
  const void* w2[MAX_BANKS];
  const float* b2[MAX_BANKS];
  int k[MAX_BANKS];
  int order[MAX_BANKS];  // the banks by descending k: blocks [i B tiles, (i + 1) B tiles) take bank order[i]
  void* out;             // the last launch: the banks' mean
  int nbanks, B, L, d, tl, ring;
  int y32;  // the banks' outputs y are float32 (the last step, when a sum kernel adds them)
  float scale;
};

// In place on the 16 bytes at p: the leaky ReLU, rounded to the dtype.
__device__ __forceinline__ void lrelu16(float* p) {
  float4 v = *reinterpret_cast<float4*>(p);
  *reinterpret_cast<float4*>(p) = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
}
__device__ __forceinline__ void lrelu16(__nv_bfloat16* p) {
  uint4 u = *reinterpret_cast<uint4*>(p);
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    const __nv_bfloat162 r = __floats2bfloat162_rn(lrelu(f.x), lrelu(f.y));
    w[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// A block: the tile of positions [l0, l0 + tl) of stream b, for one bank
// (LAST false: the largest k's blocks first, so they start in the first
// wave) or for each bank in turn (LAST true). W = blockDim.x / 32 warps,
// R = 16 WM W conv rows.
template <typename T, int C, int WM, bool LAST>
__global__ void __launch_bounds__(MAX_WARPS * 32) resblock_bank_kernel(const __grid_constant__ Launch p) {
  using Frag = typename Step<T>::Frag;
  constexpr int ELEM = sizeof(T), CS = staged_channels(C, ELEM);
  constexpr int NT = C / 8, KC = CS / Step<T>::K, PB = row_bytes(C, ELEM);
  constexpr int SLAB = KC * NT * 32;  // fragments of one tap
  constexpr int CHUNKS = CS * ELEM / 16, XCHUNKS = C * ELEM / 16;  // 16-byte chunks of a staged row, of x's row
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x, rows = 16 * WM * (nthreads >> 5);
  Frag* ring = reinterpret_cast<Frag*>(smem);
  const int nring = p.ring;
  // the plane: lrelu(x) for conv1, then lrelu(conv1 + b1) for conv2 (its rows past R hold what
  // lrelu(x) left there, read only for conv2's rows past the tile)
  unsigned char* plane = smem + (size_t)nring * SLAB * sizeof(Frag);

  const int tiles = (p.L + p.tl - 1) / p.tl;
  int q = blockIdx.x, jb = 0;
  if constexpr (!LAST) {
    jb = p.order[q / (p.B * tiles)];
    q %= p.B * tiles;
  }
  const int tile = q % tiles, b = q / tiles, l0 = tile * p.tl;
  const int nb = LAST ? p.nbanks : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // The weights' stream of slabs: bank after bank, conv1's k taps then
  // conv2's; each call loads the next one into a ring slot, as one
  // cp.async group (empty past the end, so the groups keep count).
  int lj = 0, ls = 0;
  auto load_slab = [&](int slot) {
    if (lj < nb) {
      const int j = LAST ? lj : jb, k = p.k[j];
      const Frag* src = static_cast<const Frag*>(ls < k ? p.w1[j] : p.w2[j]) + (size_t)(ls < k ? ls : ls - k) * SLAB;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(ring + slot * SLAB);
      for (int i = threadIdx.x; i < SLAB * (int)sizeof(Frag) / 16; i += nthreads) cp_async16(d4 + i, s4 + i, 16);
      if (++ls == 2 * k) {
        ls = 0;
        ++lj;
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < nring - 1; ++i) load_slab(i);
  // Launched as a programmatic dependent of the stream's kernel before it, the weights' loads above
  // overlap that kernel; every activation it writes is read, and every one this launch writes is
  // written, after this wait. Then the next launch may start.
  grid_dependency_wait();
  grid_dependents_launch();

  int arow[WM];  // the lane's ldmatrix address in a staged plane, tile j's row 0
#pragma unroll
  for (int j = 0; j < WM; ++j) arow[j] = ((warp * WM + j) * 16 + (lane & 15)) * PB + (lane >> 4) * 16;
  float sum[LAST ? WM : 1][NT][4];  // the banks' outputs so far (last launch)
  if constexpr (LAST) {
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[j][n][i] = 0.f;
  }
  int slot = 0;  // the ring slot of the next tap
  // the next tap's slab: it has landed (this thread's copies, then the barrier: everyone's), every
  // warp is done with the slot before it, which takes the slab ring - 1 taps ahead
  auto next_tap = [&]() {
    cp_async_wait_n(nring - 2);
    __syncthreads();
    load_slab(slot == 0 ? nring - 1 : slot - 1);
    const Frag* w = ring + slot * SLAB + lane;
    slot = slot + 1 == nring ? 0 : slot + 1;
    return w;
  };

  for (int jj = 0; jj < nb; ++jj) {
    const int j = LAST ? jj : jb, k = p.k[j], P2 = (k - 1) / 2, d = p.d;
    const T* xb = static_cast<const T*>(p.x[j]) + (size_t)b * p.L * C;

    // Stage lrelu(x) at positions l0 - P2 - P1 + r for the rows r conv1 reads, zeros outside [0, L) and
    // past x's channels:
    // each thread copies its chunks, waits for them and applies the leaky ReLU to them; the first
    // tap's barrier shows them to the block. In the last launch every warp must be through the bank
    // before's conv2 on the plane first.
    if (jj > 0) __syncthreads();
    {
      const int g0 = l0 - P2 - d * P2, n_in = (rows + (k - 1) * d) * CHUNKS;
      for (int i = threadIdx.x; i < n_in; i += nthreads) {
        const int r = i / CHUNKS, c = i - r * CHUNKS, gp = g0 + r;
        const bool inside = c < XCHUNKS && gp >= 0 && gp < p.L;
        cp_async16(plane + r * PB + c * 16, inside ? xb + (size_t)gp * C + c * (16 / ELEM) : xb, inside ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      for (int i = threadIdx.x; i < n_in; i += nthreads) {
        const int r = i / CHUNKS, c = i - r * CHUNKS;
        lrelu16(reinterpret_cast<T*>(plane + r * PB + c * 16));
      }
    }

    float acc[WM][NT][4];
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    for (int tap = 0; tap < k; ++tap) mma_tap<T, NT, WM>(acc, plane + tap * d * PB, arow, next_tap(), KC);

    // conv1's epilogue, once every warp is through conv1 on the plane: row r at position l0 - P2 + r
    // gets lrelu(y1 + b1), zero outside [0, L) (conv2's padding); conv2's first barrier shows it to
    // the block
    __syncthreads();
    const float* b1 = p.b1[j];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float c0 = __ldg(b1 + n * 8 + 2 * t), c1 = __ldg(b1 + n * 8 + 2 * t + 1);
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (warp * WM + m) * 16 + g + 8 * h, gp = l0 - P2 + r;
          const bool inside = gp >= 0 && gp < p.L;
          store2(reinterpret_cast<T*>(plane + r * PB), n * 8 + 2 * t, inside ? lrelu(acc[m][n][2 * h] + c0) : 0.f,
                 inside ? lrelu(acc[m][n][2 * h + 1] + c1) : 0.f);
          acc[m][n][2 * h] = acc[m][n][2 * h + 1] = 0.f;
        }
    }

    for (int tap = 0; tap < k; ++tap) mma_tap<T, NT, WM>(acc, plane + tap * PB, arow, next_tap(), KC);

    // conv2's epilogue: y = x + conv2 + b2 at the tile's positions, to the bank's output or the sum
    const float* b2 = p.b2[j];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float c0 = __ldg(b2 + n * 8 + 2 * t), c1 = __ldg(b2 + n * 8 + 2 * t + 1);
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (warp * WM + m) * 16 + g + 8 * h, gp = l0 + r;
          if (r >= p.tl || gp >= p.L) continue;
          const size_t o = (size_t)gp * C + n * 8 + 2 * t;
          float r0, r1;
          load2(xb, o, r0, r1);
          const float y0 = acc[m][n][2 * h] + c0 + r0, y1 = acc[m][n][2 * h + 1] + c1 + r1;
          if constexpr (LAST) {
            sum[m][n][2 * h] += y0;
            sum[m][n][2 * h + 1] += y1;
          } else if (p.y32) {
            store2(static_cast<float*>(p.y[j]) + (size_t)b * p.L * C, o, y0, y1);
          } else {
            store2(static_cast<T*>(p.y[j]) + (size_t)b * p.L * C, o, y0, y1);
          }
        }
    }
  }

  if constexpr (LAST) {
    T* ob = static_cast<T*>(p.out) + (size_t)b * p.L * C;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (warp * WM + m) * 16 + g + 8 * h, gp = l0 + r;
          if (r < p.tl && gp < p.L)
            store2(ob, (size_t)gp * C + n * 8 + 2 * t, sum[m][n][2 * h] * p.scale, sum[m][n][2 * h + 1] * p.scale);
        }
  }
}

// The banks' mean from their float32 outputs y [nbanks, n]: out = (y_0 + y_1 + ...) * scale, added in the
// banks' order as the last launch adds them, so the two give the same bits. Four elements a thread.
template <typename T>
__global__ void __launch_bounds__(256) resblock_bank_sum_kernel(const float* __restrict__ y, T* __restrict__ out,
                                                                size_t n, int nbanks, float scale) {
  grid_dependency_wait();
  grid_dependents_launch();
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < n; i += (size_t)gridDim.x * blockDim.x * 4) {
    float4 s = *reinterpret_cast<const float4*>(y + i);
    for (int j = 1; j < nbanks; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(y + j * n + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store2(out, i, s.x * scale, s.y * scale);
    store2(out, i + 2, s.z * scale, s.w * scale);
  }
}

// a launch as a programmatic dependent of the stream's kernel before it
cudaLaunchConfig_t pdl_config(cudaLaunchAttribute* attr, int blocks, int threads, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int C, int WM, bool LAST>
cudaError_t launch(const Launch& p, int warps, int blocks, size_t smem, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  const cudaError_t e = smem_cap_once((const void*)resblock_bank_kernel<T, C, WM, LAST>, done, SMEM_CAP);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pdl_config(attr, blocks, warps * 32, smem, stream);
  return cudaLaunchKernelEx(&cfg, resblock_bank_kernel<T, C, WM, LAST>, p);
}

template <typename T, int C, int WM>
cudaError_t launch_last(bool last, const Launch& p, int warps, int blocks, size_t smem, cudaStream_t s) {
  return last ? launch<T, C, WM, true>(p, warps, blocks, smem, s) : launch<T, C, WM, false>(p, warps, blocks, smem, s);
}

template <typename T>
cudaError_t launch_c(int C, int wm, bool last, const Launch& p, int warps, int blocks, size_t smem,
                     cudaStream_t s) {
  switch (C * 10 + wm) {
    case 81: return launch_last<T, 8, 1>(last, p, warps, blocks, smem, s);
    case 82: return launch_last<T, 8, 2>(last, p, warps, blocks, smem, s);
    case 161: return launch_last<T, 16, 1>(last, p, warps, blocks, smem, s);
    case 162: return launch_last<T, 16, 2>(last, p, warps, blocks, smem, s);
    case 321: return launch_last<T, 32, 1>(last, p, warps, blocks, smem, s);
    case 322: return launch_last<T, 32, 2>(last, p, warps, blocks, smem, s);
    case 641: return launch_last<T, 64, 1>(last, p, warps, blocks, smem, s);
    case 642: return launch_last<T, 64, 2>(last, p, warps, blocks, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// the kernel of (dtype, C, WM, last) as a pointer, for the occupancy queries
template <typename T>
const void* kernel_of(int C, int wm, bool last) {
  switch (C * 100 + wm * 10 + (last ? 1 : 0)) {
    case 810: return (const void*)resblock_bank_kernel<T, 8, 1, false>;
    case 811: return (const void*)resblock_bank_kernel<T, 8, 1, true>;
    case 820: return (const void*)resblock_bank_kernel<T, 8, 2, false>;
    case 821: return (const void*)resblock_bank_kernel<T, 8, 2, true>;
    case 1610: return (const void*)resblock_bank_kernel<T, 16, 1, false>;
    case 1611: return (const void*)resblock_bank_kernel<T, 16, 1, true>;
    case 1620: return (const void*)resblock_bank_kernel<T, 16, 2, false>;
    case 1621: return (const void*)resblock_bank_kernel<T, 16, 2, true>;
    case 3210: return (const void*)resblock_bank_kernel<T, 32, 1, false>;
    case 3211: return (const void*)resblock_bank_kernel<T, 32, 1, true>;
    case 3220: return (const void*)resblock_bank_kernel<T, 32, 2, false>;
    case 3221: return (const void*)resblock_bank_kernel<T, 32, 2, true>;
    case 6410: return (const void*)resblock_bank_kernel<T, 64, 1, false>;
    case 6411: return (const void*)resblock_bank_kernel<T, 64, 1, true>;
    case 6420: return (const void*)resblock_bank_kernel<T, 64, 2, false>;
    case 6421: return (const void*)resblock_bank_kernel<T, 64, 2, true>;
    default: return nullptr;
  }
}

bool valid(int C, int dtype, int warps, int wm, int ring, int kmax, int dmax) {
  const int rows = 16 * wm * warps, elem = dtype == 0 ? 4 : 2;
  return (C == 8 || C == 16 || C == 32 || C == 64) && (dtype == 0 || dtype == 1) && (wm == 1 || wm == 2) &&
         warps >= 1 && warps <= MAX_WARPS && ring >= 2 && ring <= MAX_RING && kmax >= 1 && kmax % 2 == 1 &&
         rows > kmax - 1 && dmax >= 1 && smem_bytes(C, elem, rows, kmax, dmax, ring) <= (size_t)SMEM_CAP;
}

}  // namespace

// The whole bank: x, out [B, L, C] in the activation type (dtype 0 float32,
// 1 bfloat16); tmp: 2 nbanks B L C elements of it (none when S is 1); sums:
// nbanks B L C float32, or null. params: 4 pointers per bank and step,
// bank-major, (W1, b1, W2, b2): the weights packed by ops/_mma.py:pack_taps
// into mma fragments (float32 for dtype 0, bf16 for dtype 1), the biases
// float32. ks: nbanks (at most 4) odd kernel sizes; dils: S dilations of at
// least 1, the largest one's plane within shared memory. C in {8, 16, 32,
// 64}. The tiling: warps a block and wm m16 tiles a warp, so
// 16 wm warps conv rows and 16 wm warps - (max k - 1) positions a block; a
// ring of `ring` tap slabs of weights. Launches S kernels on `stream`, each a
// programmatic dependent of the kernel before it; where sums is not null,
// the last step's blocks take one bank each, like the others, and write its
// float32 output to sums, and one more kernel adds them (for a grid too
// small to fill the card with a block a tile), on the calling thread's
// current device, which must be `stream`'s. Returns a CUDA error code (0 on
// success).
extern "C" int rvc_resblock_bank(const void* x, void* out, void* tmp, float* sums, const void* const* params,
                                 int nbanks, int S, const int* ks, const int* dils, int B, int L, int C, int dtype,
                                 int warps, int wm, int ring, void* stream) {
  if (nbanks < 1 || nbanks > MAX_BANKS || S < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  int kmax = 1, dmax = 1;
  for (int j = 0; j < nbanks; ++j) {
    if (ks[j] < 1 || ks[j] % 2 == 0) return (int)cudaErrorInvalidValue;
    kmax = ks[j] > kmax ? ks[j] : kmax;
  }
  for (int i = 0; i < S; ++i) {
    if (dils[i] < 1) return (int)cudaErrorInvalidValue;
    dmax = dils[i] > dmax ? dils[i] : dmax;
  }
  if (!valid(C, dtype, warps, wm, ring, kmax, dmax)) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2, rows = 16 * wm * warps, tl = rows - (kmax - 1), tiles = (L + tl - 1) / tl;
  const size_t n = (size_t)B * L * C, act = n * elem;
  Launch p = {};
  p.nbanks = nbanks;
  p.B = B;
  p.L = L;
  p.tl = tl;
  p.ring = ring;
  p.scale = 1.f / nbanks;
  p.out = out;
  for (int j = 0; j < nbanks; ++j) {  // the largest k first: those blocks take the longest
    int r = 0;
    for (int i = 0; i < nbanks; ++i) r += ks[i] > ks[j] || (ks[i] == ks[j] && i < j);
    p.order[r] = j;
    p.k[j] = ks[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < S; ++i) {
    const bool last = i + 1 == S, fused = last && sums == nullptr;
    p.d = dils[i];
    p.y32 = last;
    for (int j = 0; j < nbanks; ++j) {
      // the bank's activation passes through two buffers of tmp, in turns
      p.x[j] = i == 0 ? x : static_cast<const char*>(tmp) + ((size_t)((i - 1) % 2) * nbanks + j) * act;
      p.y[j] = fused ? nullptr : last ? static_cast<void*>(sums + j * n)
                                      : static_cast<char*>(tmp) + ((size_t)(i % 2) * nbanks + j) * act;
      const void* const* q = params + 4 * (j * S + i);
      p.w1[j] = q[0];
      p.b1[j] = static_cast<const float*>(q[1]);
      p.w2[j] = q[2];
      p.b2[j] = static_cast<const float*>(q[3]);
    }
    const int blocks = (fused ? 1 : nbanks) * B * tiles;
    const size_t smem = smem_bytes(C, elem, rows, kmax, p.d, ring);
    cudaError_t e = dtype == 0 ? launch_c<float>(C, wm, fused, p, warps, blocks, smem, s)
                               : launch_c<__nv_bfloat16>(C, wm, fused, p, warps, blocks, smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (sums != nullptr) {
    const size_t quads = n / 4;
    const int blocks = (int)((quads + 255) / 256 < 4096 ? (quads + 255) / 256 : 4096);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = pdl_config(attr, blocks, 256, 0, s);
    cudaError_t e = dtype == 0
                        ? cudaLaunchKernelEx(&cfg, resblock_bank_sum_kernel<float>, (const float*)sums,
                                             static_cast<float*>(out), n, nbanks, p.scale)
                        : cudaLaunchKernelEx(&cfg, resblock_bank_sum_kernel<__nv_bfloat16>, (const float*)sums,
                                             static_cast<__nv_bfloat16*>(out), n, nbanks, p.scale);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// A level's launches on this card: out = (threads, shared memory bytes at
// dilation d, then for the launches before the last and the last: registers
// a thread, blocks an SM holds at that shared memory). Returns a CUDA error
// code.
extern "C" int rvc_resblock_launch_info(int C, int dtype, int warps, int wm, int ring, int kmax, int d, int* out) {
  if (!valid(C, dtype, warps, wm, ring, kmax, d)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, dtype == 0 ? 4 : 2, 16 * wm * warps, kmax, d, ring);
  out[0] = warps * 32;
  out[1] = (int)smem;
  for (int last = 0; last < 2; ++last) {
    const void* k = dtype == 0 ? kernel_of<float>(C, wm, last) : kernel_of<__nv_bfloat16>(C, wm, last);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, warps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    out[2 + 2 * last] = attr.numRegs;
    out[3 + 2 * last] = blocks;
  }
  return 0;
}
