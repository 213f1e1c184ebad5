// Tensor-core pieces shared by the port's implicit-GEMM kernels (unet_block.cu,
// resblock.cu): mma.sync with float32 accumulation, float32 operands as three
// TF32 products (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, hi the value cut
// or rounded to TF32 and lo the rest), bfloat16 operands as one bf16 product.
//
// The bank (resblock.cu) stages activations in shared memory as float
// planes: float32 as one plane it splits as it loads a fragment
// (ldmatrix_x4, mma_3xtf32), bfloat16 as one plane of the values, rounded to
// bf16 as a fragment is packed (mma_step_bf16, m16n8k8). Its weights come
// packed by ops/_mma.py:pack_weight, in the order of the B fragments: per K
// step and n8 tile, 32 lanes of (hi, hi, lo, lo) float32 or two bf16.
// The chain (unet_block.cu) stages activations in their own dtype and reads
// A fragments with ldmatrix_x4: bf16 on m16n8k16 (mma_bf16_k16), float32 on
// m16n8k8 split as it goes (tf32_cut); cp_async16 stages them.
//
// The build hashes this header with each source that includes it
// (ops/_cuda.py), so an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float load(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) { return __bfloat162float(__ldg(p + i)); }
__device__ __forceinline__ void store2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
struct Prec;
template <>
struct Prec<float> {  // 3xTF32: B fragments (hi0, hi1, lo0, lo1) per lane
  static constexpr int PLANES = 2;
  using Frag = float4;
};
template <>
struct Prec<__nv_bfloat16> {  // one plane of bf16 values kept as floats, B fragment bf16x2 per lane
  static constexpr int PLANES = 1;
  using Frag = uint32_t;
};

// The 3xTF32 product of one K step: A's TF32 hi and lo fragments, B's
// fragment from pack_weight. The two small products go to `small`, so each
// K step adds one product to each of two chains, not three to one.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float (&small)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float4& b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, tf32(b.z), tf32(b.w));
  mma_tf32(acc, ah, bh0, bh1);
}

// The same from A's float32 fragment, split here in two instructions a
// value: hi is a cut to TF32 (its low 13 bits cleared), lo = a - hi exactly
// (|lo| < 2^-10 |a|), passed as it is: the mma reads its TF32 bits, a
// relative error under 2^-20 of a. Rounding both with cvt.rna here made the
// bank kernel slower on the card than staging hi and lo planes. The chain
// splits its A and B fragments the same way (tf32_cut).
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float (&small)[4], const uint32_t (&a)[4],
                                           const float4& b) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = a[i] & 0xFFFFE000u;
    al[i] = __float_as_uint(__uint_as_float(a[i]) - __uint_as_float(ah[i]));
  }
  mma_3xtf32(acc, small, ah, al, b);
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

// One bf16 K step (m16n8k8) of one m16 x n8 tile from a plane of floats:
// the lane's A entries at rows a0 (row g) and a1 (row g + 8), columns 2t and
// 2t + 1, rounded to bf16 as they are packed; its B fragment b.
__device__ __forceinline__ void mma_step_bf16(float (&acc)[4], const float* plane, int a0, int a1, int t,
                                              uint32_t b) {
  mma_bf16(acc, pack_bf16(plane[a0 + 2 * t], plane[a0 + 2 * t + 1]),
           pack_bf16(plane[a1 + 2 * t], plane[a1 + 2 * t + 1]), b);
}

}  // namespace
