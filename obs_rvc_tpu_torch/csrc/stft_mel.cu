// The RMVPE log-mel frontend, fused: centred reflect-padded framing (1024
// samples, any hop), periodic Hann window, one-sided spectrum (513 bins) by
// a real FFT in shared memory, magnitude, mel product and ln(max(., clamp)),
// in one launch:
//
//     out[m, t] = ln(max(sum_k basis[m, k] * |sum_n x_t[n] w[n] e^{-2 pi i n k / 1024}|, clamp))
//
// Replaces: obs_rvc_tpu/ops/stft_mel.py:log_mel_pallas (Pallas, TPU). That
// kernel frames outside the kernel (Mosaic rejects the unaligned hop-160
// slices) and multiplies the frames against 2 x 1024 x 640 float32 DFT bases
// (5.2 MB) on the MXU.
//
// What bounds it: at the main path's shape (L = 10080 samples, T = 64
// frames) the function needs about 2 MFLOP (a 1024-point real FFT per frame
// and the mel product over the triangles' nonzero entries), 0.03 us at
// float32's 67 TFLOP/s, and must move 82 KB of signal, window, packed basis
// and output, 0.025 us at 3.35 TB/s: bound by operations. At that size a launch and a handful of dependent shared-memory
// round trips per frame are what the kernel pays; the design keeps both few. A batched step's B streams cost
// B times the operations and the signal and output bytes, the basis once, in the same one launch.
//
// Design: a block of 128 threads owns one frame of one stream, so the grid
// is (T, B): blockIdx.x the frame, blockIdx.y the stream, which offsets the
// signal and the output. The window, cos table and packed basis are shared
// by every stream. One launch covers a batched step's B streams. Two or four
// frames a block were measured on an H100 and were slower at both T=64 and
// T=301 (PERF.md): with 64 blocks the SMs are already idle.
//
// 1. The block builds its frame straight from the raw signal (with
//    np.pad's repeated reflection, so T = 1 and signals shorter than the
//    pad work), windows it and packs it as the 512-point complex sequence
//    z[m] = x[2m] + i x[2m+1]. No padded copy or frame matrix reaches device
//    memory.
// 2. A 512-point complex FFT of z, Stockham-ordered (four radix-4 passes and
//    one radix-2 pass, ping-ponging between two shared-memory rows, natural
//    order out, no bit-reversal pass). Rows are padded by one complex every
//    16 against bank conflicts on the strided writes.
// 3. The split step turns Z into the 513 bins of the real frame's spectrum,
//    X[k] = (Z[k] + conj Z[512-k]) / 2 - i e^{-2 pi i k / 1024} (Z[k] - conj Z[512-k]) / 2,
//    and keeps |X[k]| in shared memory.
// 4. The mel product reads the basis in a packed form made once on the host
//    (ops/stft_mel.py:pack_mel_basis): for each row its first bin, and the
//    weights from there to its last nonzero bin. The default basis packs to
//    about 4 KB; it is staged into shared memory once per block. Any basis
//    works: rows are staged in pieces of at most PIECE weights (the host
//    cuts the pieces), so a dense [n_mels, 513] one takes several pieces.
//    One thread per row sums its row's weights against the magnitudes and
//    writes ln(max(., clamp)).
//
// Every twiddle is an entry of a 1024-entry cos table computed in float64 on
// the host and cast (cos at j; -sin at j is cos at j + 256), so each is the
// float32 value of its float64 angle, as the DFT bases' entries are.

#include <cuda_runtime.h>

namespace {

constexpr int NFFT = 1024;
constexpr int NC = NFFT / 2;          // complex points
constexpr int NBINS = NFFT / 2 + 1;
constexpr int GROUP = 128;            // threads per frame
constexpr int ROW = NC + NC / 16;     // a padded row of complex points
constexpr int PIECE = 2048;           // basis weights staged at a time

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ int reflect(int p, int L) {
  if (L == 1) return 0;
  const int period = 2 * (L - 1);
  int q = p % period;
  if (q < 0) q += period;
  return q < L ? q : period - q;
}

// e^{-2 pi i j / 1024}
__device__ __forceinline__ float2 twiddle(const float* c, int j) {
  return make_float2(c[j & (NFFT - 1)], c[(j + NFFT / 4) & (NFFT - 1)]);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// One radix-4 Stockham pass over 512 points: thread j < 128 of the frame
// takes points j + 128 r, twiddles them by the pass's angle, and writes its
// 4-point DFT at (j / NS) * 4 NS + j % NS + r NS.
template <int NS>
__device__ __forceinline__ void radix4(const float2* src, float2* dst, const float* c, int j) {
  constexpr int STEP = NFFT / (4 * NS);
  const int k = j % NS;
  float2 v0 = src[pad(j)], v1 = src[pad(j + 128)], v2 = src[pad(j + 256)], v3 = src[pad(j + 384)];
  if (NS > 1) {
    v1 = cmul(v1, twiddle(c, k * STEP));
    v2 = cmul(v2, twiddle(c, 2 * k * STEP));
    v3 = cmul(v3, twiddle(c, 3 * k * STEP));
  }
  const float2 a0 = add(v0, v2), a1 = sub(v0, v2), a2 = add(v1, v3);
  const float2 d = sub(v1, v3);
  const float2 a3 = make_float2(d.y, -d.x);  // -i (v1 - v3)
  const int o = (j / NS) * 4 * NS + k;
  dst[pad(o)] = add(a0, a2);
  dst[pad(o + NS)] = add(a1, a3);
  dst[pad(o + 2 * NS)] = sub(a0, a2);
  dst[pad(o + 3 * NS)] = sub(a1, a3);
}

// The last pass, radix 2 with NS = 256: points j and j + 256.
__device__ __forceinline__ void radix2(const float2* src, float2* dst, const float* c, int j) {
  const float2 v0 = src[pad(j)], v1 = cmul(src[pad(j + 256)], twiddle(c, 2 * j));
  dst[pad(j)] = add(v0, v1);
  dst[pad(j + 256)] = sub(v0, v1);
}

__global__ void __launch_bounds__(GROUP)
log_mel_kernel(const float* __restrict__ signal, const float* __restrict__ window,
               const float* __restrict__ cos_table, const int* __restrict__ row_start,
               const int* __restrict__ row_off, const float* __restrict__ weights,
               const int* __restrict__ pieces, int n_pieces, float* __restrict__ out, int L, int stride,
               int T, int hop, int n_mels, float clamp) {
  __shared__ float ctab[NFFT];
  __shared__ float2 b0[ROW], b1[ROW];
  __shared__ float wsm[PIECE];

  const int j = threadIdx.x, t = blockIdx.x;
  signal += (size_t)blockIdx.y * stride;
  out += (size_t)blockIdx.y * n_mels * T;

  for (int i = j; i < NFFT; i += GROUP) ctab[i] = cos_table[i];
  for (int m = j; m < NC; m += GROUP) {
    const int p = t * hop + 2 * m - NFFT / 2;
    b0[pad(m)] = make_float2(__ldg(signal + reflect(p, L)) * __ldg(window + 2 * m),
                             __ldg(signal + reflect(p + 1, L)) * __ldg(window + 2 * m + 1));
  }
  int w0 = __ldg(row_off + __ldg(pieces));
  for (int i = j, n = __ldg(row_off + __ldg(pieces + 1)) - w0; i < n; i += GROUP) wsm[i] = __ldg(weights + w0 + i);
  __syncthreads();

  radix4<1>(b0, b1, ctab, j);
  __syncthreads();
  radix4<4>(b1, b0, ctab, j);
  __syncthreads();
  radix4<16>(b0, b1, ctab, j);
  __syncthreads();
  radix4<64>(b1, b0, ctab, j);
  __syncthreads();
  radix2(b0, b1, ctab, j);
  radix2(b0, b1, ctab, j + GROUP);
  __syncthreads();

  // the split step: Z (in b1) -> |X| (in b0, as floats)
  float* mag = reinterpret_cast<float*>(b0);
  for (int k = j; k < NBINS; k += GROUP) {
    const float2 zk = b1[pad(k & (NC - 1))], zc = b1[pad((NC - k) & (NC - 1))];
    const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));  // (Z[k] + conj Z[512-k]) / 2
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));  // (Z[k] - conj Z[512-k]) / 2i
    const float2 x = add(e, cmul(twiddle(ctab, k), o));
    mag[k] = sqrtf(x.x * x.x + x.y * x.y);
  }
  __syncthreads();

  for (int p = 0; p < n_pieces; ++p) {
    const int r0 = __ldg(pieces + p), r1 = __ldg(pieces + p + 1);
    if (p > 0) {
      __syncthreads();
      w0 = __ldg(row_off + r0);
      for (int i = j, n = __ldg(row_off + r1) - w0; i < n; i += GROUP) wsm[i] = __ldg(weights + w0 + i);
      __syncthreads();
    }
    for (int m = r0 + j; m < r1; m += GROUP) {
      const float* fm = mag + __ldg(row_start + m);
      const int o0 = __ldg(row_off + m), n = __ldg(row_off + m + 1) - o0;
      const float* wr = wsm + (o0 - w0);
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = fmaf(wr[i], fm[i], acc);
      out[(size_t)m * T + t] = logf(fmaxf(acc, clamp));
    }
  }
}

}  // namespace

// signal: B streams of L float32 samples, row b at signal + b * stride (the
// step's windows are the tails of its 16 kHz rings); window: [1024] float32; cos_table: [1024] float32,
// cos(2 pi j / 1024); the packed basis (ops/stft_mel.py:pack_mel_basis):
// row_start [n_mels] int32, the first bin of each row's weights; row_off
// [n_mels + 1] int32, where each row's weights start in `weights`; weights
// float32; pieces [n_pieces + 1] int32, the rows that start each piece of at
// most 2048 weights, then n_mels. out: [B, n_mels, T] float32 with
// T = 1 + L / hop. Returns a CUDA error code (0 on success).
extern "C" int rvc_log_mel(const float* signal, const float* window, const float* cos_table,
                           const int* row_start, const int* row_off, const float* weights, const int* pieces,
                           int n_pieces, float* out, int B, int L, int stride, int T, int hop, int n_mels,
                           float clamp, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || stride < L || T < 1 || hop < 1 || n_mels < 1 || n_pieces < 1 ||
      T != 1 + L / hop)
    return (int)cudaErrorInvalidValue;
  log_mel_kernel<<<dim3(T, B), GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      signal, window, cos_table, row_start, row_off, weights, pieces, n_pieces, out, L, stride, T, hop, n_mels,
      clamp);
  return (int)cudaGetLastError();
}
