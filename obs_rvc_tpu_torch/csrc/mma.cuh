// Tensor-core pieces shared by the port's implicit-GEMM kernels (unet_block.cu,
// resblock.cu): mma.sync with float32 accumulation, bfloat16 operands on
// m16n8k16, float32 operands on m16n8k8 as three TF32 products (3xTF32:
// a_lo b_hi + a_hi b_lo + a_hi b_hi, hi the value cut to TF32 and lo the
// rest), so a K step is 32 bytes of channels in either dtype (Step<T>).
//
// Both kernels stage activations in shared memory in their own dtype, rows
// padded by 16 bytes, and read A fragments with ldmatrix_x4; their weights
// come packed by ops/_mma.py:pack_taps, in the order of the B fragments (per
// K step and n8 tile, 32 lanes of two float32 or four bf16), and are staged
// into shared memory by cp_async16. mma_tap runs one tap's K steps of a
// warp's m16 tiles against every n8 tile; each conv launch is a programmatic
// dependent of the one before (griddepcontrol).
//
// A kernel's dynamic shared-memory cap is an attribute of the device it is
// set on (cudaFuncSetAttribute acts on the calling thread's current device),
// so smem_cap_once keeps a flag per device: the first launch on each card
// sets it there.
//
// The build hashes this header with each source that includes it
// (ops/_cuda.py), so an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_DEVICES = 64;

// `kernel`'s dynamic shared-memory cap set to `cap` on the current device,
// once per device (`done` is the kernel's own flag array); a CUDA error code.
inline cudaError_t smem_cap_once(const void* kernel, bool (&done)[MAX_DEVICES], int cap) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

__device__ __forceinline__ void load2(const float* p, size_t i, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p + i);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, size_t i, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void store2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on one m16 x n8 x k16 bf16 tile: a's four registers as ldmatrix_x4
// gives them (rows g, g + 8 at k 2t, 2t + 1, then at k 2t + 8, 2t + 9), b's
// two (k 2t, 2t + 1 and 2t + 8, 2t + 9 of column g).
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's TF32 hi (a cut: its low 13 bits cleared) and lo = x - hi, exact, whose
// TF32 bits the mma reads (a relative error under 2^-20 of x).
__device__ __forceinline__ void tf32_cut(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// The same split rounded to nearest, as CUTLASS's 3xTF32 makes it: hi = x
// rounded to TF32, lo = x - hi (exact) rounded to TF32, so |lo| <= 2^-11 |x|
// and hi + lo is x within 2^-22 of it. Two conversions for tf32_cut's one
// mask, four times less error: the chain's ring kernel, whose levels sum up
// to 4608 products an output, takes it.
__device__ __forceinline__ void tf32_split_rn(uint32_t x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
  const float rest = __uint_as_float(x) - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// A 16-byte copy from device to shared memory that bypasses the registers;
// src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: wait until the grids this one depends on
// have finished and their writes are visible (at once if it was launched
// without the attribute), and let the stream's next grid launch.
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A's fragment of one m16 x 32-byte step (k8 in TF32, k16 in bf16) from
// shared memory, in one instruction: lane l passes the address of the tile's
// row (l & 7) + 8 ((l >> 3) & 1), byte 16 (l >> 4) (16-byte aligned), and
// gets rows g and g + 8 at columns t and t + 4 (TF32; 2t, 2t + 1 and 2t + 8,
// 2t + 9 in bf16) back in the order mma_tf32 and mma_bf16_k16 take.
// ldmatrix moves 8x8 matrices of 16-bit entries; one of them is 8 rows of 4
// 32-bit entries, so in TF32 each lane's register is one float of the tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// A K step of the mma: the channels it consumes (16 bf16 or 8 TF32, 32 bytes
// either way) and a lane's B fragment: two bf16x2 registers, or the two
// float32 it splits into TF32 hi and lo.
template <typename T>
struct Step;
template <>
struct Step<float> {
  static constexpr int K = 8;
  using Frag = float2;
};
template <>
struct Step<__nv_bfloat16> {
  static constexpr int K = 16;
  using Frag = uint2;
};

// acc += A B for one K step: A's fragment (ldmatrix_x4), B's (Step<T>::Frag)
__device__ __forceinline__ void mma_k(float (&acc)[4], const uint32_t (&a)[4], const uint2& b) {
  mma_bf16_k16(acc, a, b.x, b.y);
}
__device__ __forceinline__ void mma_k(float (&acc)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                      const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(acc, al, bh[0], bh[1]);
  mma_tf32(acc, ah, bl[0], bl[1]);
  mma_tf32(acc, ah, bh[0], bh[1]);
}

// acc[j][n] += one tap of a conv: kc K steps of this warp's WM m16 tiles j
// (the lane's ldmatrix address of tile j's first K step at tb + arow[j]
// bytes) against every n8 tile n of the tap's B fragments wt (in shared
// memory, this lane's of K step 0 and n8 tile 0; kc * NT * 32 fragments a
// tap). Each A fragment feeds NT products, each B fragment WM. Float32
// splits both into TF32 hi and lo as it goes: cut (tf32_cut), or rounded to
// nearest with RN (tf32_split_rn).
template <typename T, int NT, int WM, bool RN = false>
__device__ __forceinline__ void mma_tap(float (&acc)[WM][NT][4], const unsigned char* tb, const int (&arow)[WM],
                                        const typename Step<T>::Frag* wt, int kc) {
  using Frag = typename Step<T>::Frag;
#pragma unroll 2
  for (int cc = 0; cc < kc; ++cc) {
    Frag b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = wt[(cc * NT + n) * 32];
    if constexpr (Step<T>::K == 16) {
#pragma unroll
      for (int j = 0; j < WM; ++j) {
        uint32_t a[4];
        ldmatrix_x4(a, tb + arow[j] + cc * 32);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_k(acc[j][n], a, b[n]);
      }
    } else {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if constexpr (RN) {
          tf32_split_rn(__float_as_uint(b[n].x), bh[n][0], bl[n][0]);
          tf32_split_rn(__float_as_uint(b[n].y), bh[n][1], bl[n][1]);
        } else {
          tf32_cut(__float_as_uint(b[n].x), bh[n][0], bl[n][0]);
          tf32_cut(__float_as_uint(b[n].y), bh[n][1], bl[n][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < WM; ++j) {
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, tb + arow[j] + cc * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (RN)
            tf32_split_rn(a[i], ah[i], al[i]);
          else
            tf32_cut(a[i], ah[i], al[i]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_k(acc[j][n], ah, al, bh[n], bl[n]);
      }
    }
  }
}

}  // namespace
