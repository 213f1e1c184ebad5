// The RMVPE log-mel frontend, fused: centred reflect-padded framing (1024
// samples, any hop), periodic Hann window, one-sided DFT (513 bins),
// magnitude, mel product and ln(max(., clamp)), in one launch:
//
//     out[m, t] = ln(max(sum_k basis[m, k] * |sum_n x_t[n] w[n] e^{-2 pi i n k / 1024}|, clamp))
//
// Replaces: obs_rvc_tpu/ops/stft_mel.py:log_mel_pallas (Pallas, TPU). That
// kernel frames outside the kernel (Mosaic rejects the unaligned hop-160
// slices) and multiplies the frames against 2 x 1024 x 640 float32 DFT bases
// (5.2 MB) on the MXU.
//
// What bounds it: at the main path's shape (L = 10080 samples, T = 64
// frames) the function needs about 2 MFLOP (a 1024-point real FFT per
// frame and the mel product over the triangles' nonzero entries) and must
// move 0.34 MB of signal, window, basis and output, so it is bound by
// bytes: 0.1 us at 3.35 TB/s. This kernel sums 1024-term DFTs instead,
// 0.134 GFLOP, about 60x the function's operations and 2.0 us at float32's
// 67 TFLOP/s without tensor cores: that is its design's floor, not the
// function's, and an FFT in shared memory is what would close the gap.
// Reading the DFT bases as the Pallas kernel does would add 5.2 MB (1.6 us
// at 3.35 TB/s). Inside the SM, the twiddle reads from shared memory are
// the narrow part: thread
// k reads entry (n k) mod 1024, a stride of n entries across the warp, which
// conflicts on the banks (about 3-way on average over n), and an SM moves
// one 128-byte wavefront of shared memory per clock.
//
// Design: one block per frame. It builds its frame straight from the raw
// signal (doing the reflection itself), so no padded copy or [T, 1024]
// frame matrix is written to device memory, and keeps it windowed in shared
// memory. The DFT bases are never read: a 1024-entry cos table, computed in
// float64 on the host and cast, is staged as (cos, -sin) pairs, -sin at j
// being cos at j + 256, so each twiddle is the same float32 value as the
// basis entry up to the float64 rounding of the angle. Each twiddle read
// serves four bins: with w = e^{-2 pi i n k / 1024},
//
//     bin k: w;  bin 512 - k: (-1)^n conj(w);  bin 256 + k: (-i)^n w;  bin 256 - k: (-i)^n conj(w),
//
// and (-1)^n, (-i)^n are sign flips and re/im swaps fixed by n mod 4. So
// thread k < 128 owns bins {k, 256 - k, 256 + k, 512 - k} (bin 256 once for
// k = 0), two threads per k split the 1024 samples in halves, and one warp
// sums bins 128 and 384 lane by lane. That cuts the twiddle reads to a
// quarter of one per bin. The magnitudes stay in shared memory; one warp
// per mel row then sums the row's nonzero basis entries (the filters are
// triangles) against them, reduces across lanes and writes
// ln(max(., clamp)) into [n_mels, T]. Each lane loads all its entries of
// the row before it uses any: the warp then waits on the memory system once
// per row instead of once per 32 entries, which took the kernel from 39 to
// 24 us at T = 64.

#include <cuda_runtime.h>

namespace {

constexpr int NFFT = 1024;
constexpr int NBINS = NFFT / 2 + 1;
constexpr int NK = 128;                   // bin groups {k, 256-k, 256+k, 512-k}, k < 128
constexpr int NTHREADS = 2 * NK + 32;     // two halves of the samples per group, and a warp for k = 128
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ int reflect(int p, int L) {
  if (L == 1) return 0;
  const int period = 2 * (L - 1);
  int q = p % period;
  if (q < 0) q += period;
  return q < L ? q : period - q;
}

// The four bins' (re, im) sums for one sample x at n = 4m + R with the
// twiddle (c, s) = (cos, -sin) of (n k) mod 1024.
template <int R>
__device__ __forceinline__ void accumulate(float (&a)[8], float x, float2 w) {
  const float xc = x * w.x, xs = x * w.y;
  a[0] += xc;  // bin k
  a[1] += xs;
  if (R == 0) {
    a[2] += xc; a[3] += xs;  // bin 256 + k
    a[4] += xc; a[5] -= xs;  // bin 256 - k
  } else if (R == 1) {
    a[2] += xs; a[3] -= xc;
    a[4] -= xs; a[5] -= xc;
  } else if (R == 2) {
    a[2] -= xc; a[3] -= xs;
    a[4] -= xc; a[5] += xs;
  } else {
    a[2] -= xs; a[3] += xc;
    a[4] += xs; a[5] += xc;
  }
  if (R % 2 == 0) {  // bin 512 - k
    a[6] += xc; a[7] -= xs;
  } else {
    a[6] -= xc; a[7] += xs;
  }
}

__device__ __forceinline__ float modulus(float re, float im) { return sqrtf(re * re + im * im); }

__global__ void __launch_bounds__(NTHREADS)
log_mel_kernel(const float* __restrict__ signal, const float* __restrict__ window,
               const float* __restrict__ cos_table, const float* __restrict__ basis,
               float* __restrict__ out, int L, int T, int hop, int n_mels, float clamp) {
  __shared__ float2 tw[NFFT];                   // (cos, -sin) of 2 pi j / 1024
  __shared__ __align__(16) float xs[NFFT];      // the windowed frame
  __shared__ float part[NK][8];                 // the second half's sums
  __shared__ float mag[NBINS];                  // |X| per bin

  const int t = blockIdx.x;
  for (int j = threadIdx.x; j < NFFT; j += NTHREADS) {
    tw[j] = make_float2(cos_table[j], cos_table[(j + NFFT / 4) & (NFFT - 1)]);
    xs[j] = signal[reflect(t * hop + j - NFFT / 2, L)] * window[j];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (tid < 2 * NK) {
    const int k = tid % NK, n0 = (tid / NK) * (NFFT / 2);
    unsigned idx = (unsigned)(n0 * k) & (NFFT - 1);
#pragma unroll 2
    for (int n = n0; n < n0 + NFFT / 2; n += 4) {
      const float4 x = *reinterpret_cast<const float4*>(xs + n);
      const float2 w0 = tw[idx];
      const float2 w1 = tw[(idx + k) & (NFFT - 1)];
      const float2 w2 = tw[(idx + 2 * k) & (NFFT - 1)];
      const float2 w3 = tw[(idx + 3 * k) & (NFFT - 1)];
      idx = (idx + 4 * k) & (NFFT - 1);
      accumulate<0>(a, x.x, w0);
      accumulate<1>(a, x.y, w1);
      accumulate<2>(a, x.z, w2);
      accumulate<3>(a, x.w, w3);
    }
    if (tid >= NK) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part[k][i] = a[i];
    }
  } else {
    // bins 128 and 384: lane l sums the samples n = l (mod 32)
    const int lane = tid - 2 * NK;
    float r0 = 0.f, i0 = 0.f, r1 = 0.f, i1 = 0.f;
    for (int n = lane; n < NFFT; n += 32) {
      const float2 w = tw[(n * NK) & (NFFT - 1)];
      const float xc = xs[n] * w.x, xsn = xs[n] * w.y;
      r0 += xc;
      i0 += xsn;
      switch (n & 3) {  // bin 384 = 256 + 128: (-i)^n w
        case 0: r1 += xc; i1 += xsn; break;
        case 1: r1 += xsn; i1 -= xc; break;
        case 2: r1 -= xc; i1 -= xsn; break;
        default: r1 -= xsn; i1 += xc; break;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, s);
      i0 += __shfl_xor_sync(0xffffffffu, i0, s);
      r1 += __shfl_xor_sync(0xffffffffu, r1, s);
      i1 += __shfl_xor_sync(0xffffffffu, i1, s);
    }
    if (lane == 0) {
      mag[NK] = modulus(r0, i0);
      mag[2 * NK + NK] = modulus(r1, i1);
    }
  }
  __syncthreads();
  if (tid < NK) {
    const int k = tid;
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += part[k][i];
    mag[k] = modulus(a[0], a[1]);
    mag[2 * NK + k] = modulus(a[2], a[3]);
    if (k > 0) mag[2 * NK - k] = modulus(a[4], a[5]);
    mag[4 * NK - k] = modulus(a[6], a[7]);
  }
  __syncthreads();

  constexpr int PER_LANE = (NBINS + 31) / 32;
  const int lane = tid & 31, warp = tid >> 5;
  for (int m = warp; m < n_mels; m += NWARPS) {
    const float* row = basis + (size_t)m * NBINS;
    float c[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) c[i] = lane + 32 * i < NBINS ? __ldg(row + lane + 32 * i) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (c[i] != 0.f) acc = fmaf(c[i], mag[lane + 32 * i], acc);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) out[(size_t)m * T + t] = logf(fmaxf(acc, clamp));
  }
}

}  // namespace

// signal: [L] float32; window: [1024] float32; cos_table: [1024] float32,
// cos(2 pi j / 1024); basis: [n_mels, 513] float32; out: [n_mels, T] float32
// with T = 1 + L / hop. Returns a CUDA error code (0 on success).
extern "C" int rvc_log_mel(const float* signal, const float* window, const float* cos_table,
                           const float* basis, float* out, int L, int T, int hop, int n_mels,
                           float clamp, void* stream) {
  if (L < 1 || T < 1 || hop < 1 || n_mels < 1 || T != 1 + L / hop) return (int)cudaErrorInvalidValue;
  log_mel_kernel<<<T, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      signal, window, cos_table, basis, out, L, T, hop, n_mels, clamp);
  return (int)cudaGetLastError();
}
