// CREPE's first two blocks (models/crepe.py) in bfloat16: conv -> ReLU ->
// BatchNorm (eval) -> max-pool 2, each conv an implicit GEMM on wgmma with
// float32 sums.
//
// It replaces no TPU kernel: the JAX package runs CREPE through XLA's
// convolutions. It was added because cuDNN, held deterministic so that a
// step repeats bit for bit (obs_rvc_tpu_torch/device.py), runs conv2 (1024 ->
// 128 channels, kernel 64) on a kernel without the tensor cores: 6.7 ms of a
// 12.3 ms chunk at one stream, 137.4 GFLOP at 2 % of the card's bf16 peak.
//
// What bounds it: operations. At one stream's 64 frames conv2 is a GEMM of M
// = 64 x 128 positions, N = 128 channels, K = 64 taps x 1024 channels: 137.4
// GFLOP, 0.139 ms at 989 TFLOP/s, against 16.8 MB of weights and 2 MB of
// activations (6 us at 3.35 TB/s). conv1 (1 -> 1024 channels, kernel 512,
// stride 4) is M = 64 x 256, N = 1024, K = 512: 17.2 GFLOP, 0.017 ms.
//
// The design. A block is two consumer warpgroups and one producer warp. A
// stage of K is 64 values (4 wgmma K steps of 16); its weights, 64 x 128
// bf16 packed by ops/crepe_conv.py in wgmma's K-major layout without
// swizzle (core matrices of 8 channels x 8 K values, 128 bytes apart along
// K, 256 along N), arrive in a ring of shared-memory slots by one bulk copy
// each (cp.async.bulk onto the slot's mbarrier), issued by the producer.
// Both operands are read by wgmma from shared memory (m64n128k16), A in the
// same K-major layout:
//  - conv2 (taps): the input comes blocked channels-last, [N][Cin / 8][128
//    positions][8 channels], as conv1 writes it. A block takes two frames
//    (a warpgroup each, two m64 tiles of its 128 positions). For each slab
//    of 64 input channels its frames' rows land, 8 bulk copies a frame, in a
//    slab buffer laid out [8 channel chunks][192 padded rows][16 bytes]:
//    rows 0-30 and 159-191 stay zero (the conv's padding of 31 and 32). Tap
//    t's A operand for output rows m..m+63 is then rows m+t..m+t+63 of the
//    same buffer: the descriptor's start moves by 16 bytes a tap, so one
//    staged slab serves all 64 taps. Two slab buffers alternate.
//  - conv1 (frame): a block takes 128 of a frame's 256 output positions and
//    walks every 128 output channels in turn. Its A operand, the stride-4
//    windows of the padded frame, is built once in shared memory as an
//    im2col, [64 chunks of 8 taps][128 rows][16 bytes] (128 KB), from the
//    frame staged beside it.
//
// Split K and the fixed-order reduction. conv2's 64 output tiles (two
// frames each at 64 frames) would leave most of the 132 SMs idle, so the
// wrapper splits K into S parts by slab (S from the frame count: a power of
// two with tiles x S <= SMs; 4 at 64 frames, 1 from 133 frames), each
// block writing its float32 sums to scratch; a second kernel adds the S
// parts in order s = 0, 1, ..., S - 1 and runs the block's epilogue. Each
// sum of the tensor cores runs in the same order on every launch, and no
// atomics are used, so a launch repeats bit for bit and the step stays
// bitwise repeatable. Where S = 1 (and always in conv1) the GEMM kernel runs
// the epilogue itself.
//
// The epilogue, in float32, rounded once: v = sum + bias; ReLU; v * scale +
// shift (BatchNorm folded by the wrapper); the larger of the two rows of
// each pooled pair (the lane four over holds the other row); bf16. conv1
// writes the blocked layout conv2 reads, conv2 the [N][C][L] layout of the
// blocks after it (cuDNN's).

#include "mma.cuh"

namespace {

constexpr int THREADS = 288;        // two consumer warpgroups and one producer warp
constexpr int CONSUMER_WARPS = 8;
constexpr int BN = 128;             // output channels of a wgmma (and of a block at a time)
constexpr int STAGE_K = 64;         // K values of a stage: 4 K steps of 16
constexpr int STAGE_BYTES = STAGE_K * BN * 2;  // 16384
constexpr int KSTEP_BYTES = 16 * BN * 2;       // 4096: [16 n8][2 K halves][8 n][8 k]

// conv1
constexpr int FRAME = 1024, FRAME_PAD = 254, FRAME_TAPS = 512, FRAME_STRIDE = 4;
constexpr int FRAME_BM = 128;                               // output rows of a block: 64 a warpgroup
constexpr int FRAME_STAGES = FRAME_TAPS / STAGE_K;          // 8 a block of 128 output channels
constexpr int SIG_ELEMS = 1536;                             // the padded frame, 254 + 1024 + 254, rounded up
constexpr int FRAME_RING = 4;
constexpr int FRAME_A_BYTES = FRAME_TAPS / 8 * FRAME_BM * 16;  // 131072
constexpr size_t FRAME_SMEM = FRAME_RING * STAGE_BYTES + FRAME_A_BYTES + SIG_ELEMS * 2 + (2 * FRAME_RING + 4) * 8;

// conv2
constexpr int TAPS = 64, TAP_PAD = 31;
constexpr int ROWS = 128;                                  // positions of a frame
constexpr int SLAB = 64;                                   // input channels of a staged slab
constexpr int SLAB_ROWS = 192;                             // 31 + 128 + 32, and one spare
constexpr int CHUNK_BYTES = SLAB_ROWS * 16;                // 3072: one chunk of 8 channels
constexpr int SLAB_BYTES = SLAB / 8 * CHUNK_BYTES;          // 24576 a frame
constexpr int TAP_FRAMES = 2;                              // frames of a block: one a warpgroup
constexpr int TAP_RING = 6;
constexpr size_t TAP_SMEM = TAP_RING * STAGE_BYTES + 2 * TAP_FRAMES * SLAB_BYTES + (2 * TAP_RING + 4) * 8;

struct Params {
  const __nv_bfloat16* x;  // conv1: frames [N][1024]; conv2: [N][cin / 8][128][8]
  const unsigned char* w;  // packed stages of STAGE_BYTES, in the order the blocks walk them
  const float* bias;       // [cout], the conv's bias as the network holds it
  const float* scale;      // [cout], BatchNorm's weight / sqrt(var + eps)
  const float* shift;      // [cout], its bias - mean * scale
  float* partial;          // conv2 split K: [splits][N][128][128]; null where splits = 1
  __nv_bfloat16* out;      // conv1: [N][cout / 8][128][8]; conv2: [N][128][64]
  int N, cin, cout, splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the barrier's phase of this parity has completed (parity 1 of a new barrier: at once)
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma's descriptor of a K-major operand without swizzle at shared address
// `addr` (16-byte aligned): core matrices of 8 rows x 16 bytes, `lbo` bytes
// apart along K, `sbo` along M or N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators' reads and writes across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B on the warpgroup's m64 x n128 x k16 tile, both operands in shared
// memory. d[4 j + i]: n8 tile j, rows g (i = 0, 1) and g + 8 (i = 2, 3) of the
// warp's 16, columns 2t and 2t + 1 (lane 4 g + t), as mma.sync's accumulator.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// the block's epilogue on one sum, in float32 with no fused multiply-add (as
// the plain version computes it): bias, ReLU, the folded BatchNorm
__device__ __forceinline__ float act(float v, float b, float sc, float sh) {
  return __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(v, b), 0.0f), sc), sh);
}

// stage i's ring slot given back once every consumer warp's wgmma on it has
// completed (one arrival a warp), and on conv2 its slab's buffer after the
// slab's last tap
template <bool TAPS_MODE, int RING>
__device__ __forceinline__ void release(int i, int lane, uint32_t empty0, uint32_t aempty0) {
  if (lane == 0) {
    mbar_arrive(empty0 + 8 * (i % RING));
    if (TAPS_MODE && i % TAPS == TAPS - 1) mbar_arrive(aempty0 + 8 * ((i / TAPS) & 1));
  }
}

// The fused epilogue of a warpgroup's MT m64 tiles of frame f, for output
// channels c0 .. c0 + 127: tile mt's rows are rbase + 64 mt + 16 w4 + g (+ 8)
// of the frame's conv rows, pooled in pairs (rbase even)
template <bool TAPS_MODE, int MT>
__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[MT][64], int c0, int f, int rbase, int w4,
                                         int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const float b0 = p.bias[c], b1 = p.bias[c + 1], sc0 = p.scale[c], sc1 = p.scale[c + 1];
      const float sh0 = p.shift[c], sh1 = p.shift[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = act(acc[mt][4 * j + 2 * h], b0, sc0, sh0), v1 = act(acc[mt][4 * j + 2 * h + 1], b1, sc1, sh1);
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));  // the row beside it: lane g ^ 1's
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        if ((g & 1) == 0) {
          const int q = (rbase + 64 * mt + 16 * w4 + g + 8 * h) >> 1;
          if constexpr (TAPS_MODE) {
            __nv_bfloat16* o = p.out + ((size_t)f * p.cout + c) * (ROWS / 2) + q;
            o[0] = __float2bfloat16_rn(v0);
            o[ROWS / 2] = __float2bfloat16_rn(v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(p.out + (((size_t)f * (p.cout / 8) + (c >> 3)) * ROWS + q) * 8 +
                                               (c & 7)) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// One block of the GEMM: conv2 (TAPS_MODE) or conv1. See the note above.
template <bool TAPS_MODE>
__global__ void __launch_bounds__(THREADS, 1) crepe_conv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RING = TAPS_MODE ? TAP_RING : FRAME_RING;
  constexpr int MT = TAPS_MODE ? ROWS / 64 : 1;  // m64 tiles a warpgroup
  constexpr int A_BYTES = TAPS_MODE ? 2 * TAP_FRAMES * SLAB_BYTES : FRAME_A_BYTES + SIG_ELEMS * 2;
  unsigned char* ring = smem;
  unsigned char* abuf = smem + RING * STAGE_BYTES;
  const uint32_t full0 = smem_u32(abuf + A_BYTES);  // full[RING], empty[RING], afull[2], aempty[2]
  const uint32_t empty0 = full0 + 8 * RING, afull0 = empty0 + 8 * RING, aempty0 = afull0 + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // conv2: frames f0, f0 + 1 (nf of them), stages [s0, s0 + nst) of K; conv1: frame f0, rows p0.. of it
  int f0, nf, p0, s0, nst, split = 0;
  if constexpr (TAPS_MODE) {
    split = blockIdx.x % p.splits;
    f0 = blockIdx.x / p.splits * TAP_FRAMES;
    nf = min(TAP_FRAMES, p.N - f0);
    nst = p.cin / SLAB * TAPS / p.splits;
    s0 = split * nst;
    p0 = 0;
  } else {
    f0 = blockIdx.x >> 1;
    nf = 1;
    p0 = (blockIdx.x & 1) * FRAME_BM;
    nst = p.cout / BN * FRAME_STAGES;
    s0 = 0;
  }

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(afull0 + 8 * i, 1);
      mbar_init(aempty0 + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (TAPS_MODE) {
    // the slab buffers' padding rows, zero for good: 31 before a frame's 128 rows, 33 after
    for (int idx = tid; idx < 2 * TAP_FRAMES * 8 * 64; idx += THREADS) {
      const int buf = idx >> 9, c = (idx >> 6) & 7, r = idx & 63;
      const int row = r < TAP_PAD ? r : ROWS + r;
      *reinterpret_cast<uint4*>(abuf + buf * SLAB_BYTES + c * CHUNK_BYTES + row * 16) = make_uint4(0, 0, 0, 0);
    }
  } else {
    // the padded frame, then its stride-4 windows of the block's 128 rows as an im2col
    __nv_bfloat16* sig = reinterpret_cast<__nv_bfloat16*>(abuf + FRAME_A_BYTES);
    const __nv_bfloat16* f = p.x + (size_t)f0 * FRAME;
    for (int i = tid; i < SIG_ELEMS; i += THREADS) {
      const int s = i - FRAME_PAD;
      sig[i] = (s >= 0 && s < FRAME) ? f[s] : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
    for (int idx = tid; idx < FRAME_TAPS / 8 * FRAME_BM; idx += THREADS) {
      const int c = idx / FRAME_BM, r = idx % FRAME_BM;
      const uint2* src = reinterpret_cast<const uint2*>(sig + FRAME_STRIDE * (p0 + r) + 8 * c);
      const uint2 lo = src[0], hi = src[1];
      *reinterpret_cast<uint4*>(abuf + (c * FRAME_BM + r) * 16) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  // the generic proxy's writes to shared memory, seen by wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: one thread issues every copy
    if (lane == 0) {
      for (int i = 0; i < nst; ++i) {
        if constexpr (TAPS_MODE) {
          if (i % TAPS == 0) {  // a new slab: its frames' 64 channels, into the buffer two slabs back used
            const int ls = i / TAPS, a = ls & 1;
            mbar_wait(aempty0 + 8 * a, ((ls >> 1) & 1) ^ 1);
            mbar_expect(afull0 + 8 * a, nf * 8 * ROWS * 16);
            const int slab = (s0 + i) / TAPS;
            for (int f = 0; f < nf; ++f) {
              const unsigned char* src = reinterpret_cast<const unsigned char*>(p.x) +
                                         ((size_t)(f0 + f) * (p.cin / 8) + slab * 8) * ROWS * 16;
              const uint32_t dst = smem_u32(abuf + (a * TAP_FRAMES + f) * SLAB_BYTES + TAP_PAD * 16);
              for (int c = 0; c < 8; ++c)
                bulk_copy(dst + c * CHUNK_BYTES, src + (size_t)c * ROWS * 16, ROWS * 16, afull0 + 8 * a);
            }
          }
        }
        const int slot = i % RING;
        mbar_wait(empty0 + 8 * slot, ((i / RING) & 1) ^ 1);
        mbar_expect(full0 + 8 * slot, STAGE_BYTES);
        bulk_copy(smem_u32(ring + slot * STAGE_BYTES), p.w + (size_t)(s0 + i) * STAGE_BYTES, STAGE_BYTES,
                  full0 + 8 * slot);
      }
    }
    return;
  }

  // the consumers: warpgroup wg, warp w4 in it, lane 4 g + t
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t ring_u = smem_u32(ring), a_u = smem_u32(abuf);
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[mt][k] = 0.0f;

  int pending = -1;
  for (int i = 0; i < nst; ++i) {
    const int slot = i % RING;
    uint32_t abase, lbo;
    if constexpr (TAPS_MODE) {
      const int ls = i / TAPS, tap = i % TAPS;
      if (tap == 0) mbar_wait(afull0 + 8 * (ls & 1), (ls >> 1) & 1);
      abase = a_u + ((ls & 1) * TAP_FRAMES + wg) * SLAB_BYTES + tap * 16;  // tile mt adds 64 rows
      lbo = CHUNK_BYTES;
    } else {
      abase = a_u + (i % FRAME_STAGES) * 8 * FRAME_BM * 16 + 64 * wg * 16;
      lbo = FRAME_BM * 16;
    }
    mbar_wait(full0 + 8 * slot, (i / RING) & 1);
    const uint32_t bbase = ring_u + slot * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STAGE_K / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_m64n128k16(acc[mt], desc(abase + 2 * kk * lbo + mt * 64 * 16, lbo, 128),
                         desc(bbase + kk * KSTEP_BYTES, 128, 256));
    wgmma_commit();
    wgmma_wait<1>();  // the stage before's products have completed: its slot can be refilled
    if (pending >= 0) release<TAPS_MODE, RING>(pending, lane, empty0, aempty0);
    pending = i;
    if constexpr (!TAPS_MODE) {
      if (i % FRAME_STAGES == FRAME_STAGES - 1) {  // a block of 128 output channels done
        wgmma_wait<0>();
        fence_acc(acc[0]);
        release<TAPS_MODE, RING>(pending, lane, empty0, aempty0);
        pending = -1;
        epilogue<false, MT>(p, acc, i / FRAME_STAGES * BN, f0, p0 + 64 * wg, w4, g, t);
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[0][k] = 0.0f;
      }
    }
  }
  if constexpr (TAPS_MODE) {
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (wg >= nf) return;  // an odd frame count's last block: its second warpgroup had no frame
    if (p.partial == nullptr) {
      epilogue<true, MT>(p, acc, 0, f0 + wg, 0, w4, g, t);
      return;
    }
    float* part = p.partial + ((size_t)split * p.N + f0 + wg) * ROWS * BN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * mt + 16 * w4 + g + 8 * h, c = 8 * j + 2 * t;
          *reinterpret_cast<float2*>(part + r * BN + c) = make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
        }
  }
}

// conv2's split parts added in order s = 0 .. splits - 1, then the epilogue:
// a block a frame and 8 pooled positions, a thread an output channel
__global__ void __launch_bounds__(BN) crepe_conv_reduce_kernel(const Params p) {
  const int c = threadIdx.x, n = blockIdx.x, q0 = blockIdx.y * 8;
  const size_t plane = (size_t)p.N * ROWS * BN;
  const float b = p.bias[c], sc = p.scale[c], sh = p.shift[c];
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const size_t at = ((size_t)n * ROWS + 2 * (q0 + k) + e) * BN + c;
      float s = p.partial[at];
      for (int sp = 1; sp < p.splits; ++sp) s = __fadd_rn(s, p.partial[sp * plane + at]);
      v[e] = act(s, b, sc, sh);
    }
    o[k] = __float2bfloat16_rn(fmaxf(v[0], v[1]));
  }
  *reinterpret_cast<uint4*>(p.out + ((size_t)n * BN + c) * (ROWS / 2) + q0) = *reinterpret_cast<const uint4*>(o);
}

bool frame_cap_done[MAX_DEVICES];
bool taps_cap_done[MAX_DEVICES];

}  // namespace

// conv1's block: frames [N][1024] bf16 -> out [N][cout / 8][128][8] bf16; cout a multiple of 128
extern "C" int rvc_crepe_conv_frames(const void* frames, const void* w, const float* bias, const float* scale,
                                     const float* shift, void* out, int N, int cout, void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(frames), static_cast<const unsigned char*>(w), bias, scale,
                 shift, nullptr, static_cast<__nv_bfloat16*>(out), N, 1, cout, 1};
  cudaError_t e = smem_cap_once(reinterpret_cast<const void*>(crepe_conv_kernel<false>), frame_cap_done,
                                (int)FRAME_SMEM);
  if (e != cudaSuccess) return e;
  crepe_conv_kernel<false><<<2 * N, THREADS, FRAME_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// conv2's block: x [N][cin / 8][128][8] bf16 -> out [N][128][64] bf16; cin a multiple of 64 whose slabs
// splits divides; partial [splits][N][128][128] float32 where splits > 1
extern "C" int rvc_crepe_conv_taps(const void* x, const void* w, const float* bias, const float* scale,
                                   const float* shift, float* partial, void* out, int N, int cin, int splits,
                                   void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w), bias, scale, shift,
                 splits > 1 ? partial : nullptr, static_cast<__nv_bfloat16*>(out), N, cin, BN, splits};
  cudaError_t e = smem_cap_once(reinterpret_cast<const void*>(crepe_conv_kernel<true>), taps_cap_done,
                                (int)TAP_SMEM);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  crepe_conv_kernel<true><<<(N + TAP_FRAMES - 1) / TAP_FRAMES * splits, THREADS, TAP_SMEM, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  crepe_conv_reduce_kernel<<<dim3(N, ROWS / 2 / 8), BN, 0, s>>>(p);
  return cudaGetLastError();
}
